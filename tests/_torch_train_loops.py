"""Training loops for ``tests/test_torch_trainer.py``: a worker process
imports them by name (a nested function cannot travel). Ports of the loops
of ``tests/test_train.py``; they import torch, numpy and ray_tpu_torch."""

import os

import numpy as np
import torch

from ray_tpu_torch import collective, train
from ray_tpu_torch.train import Checkpoint


def dp_train_loop(config):
    """Tiny linear-regression DP training: gradients averaged through the
    collective group, a checkpoint every 5 steps."""
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()

    rng = np.random.RandomState(42 + rank)  # different data per worker
    true_w = np.arange(1, 5, dtype=np.float64)
    X = torch.tensor(rng.randn(64, 4))
    y = X @ torch.tensor(true_w)

    w = torch.zeros(4, dtype=torch.float64)
    start = train.get_checkpoint()
    start_step = 0
    if start is not None:
        state = start.to_dict()
        w = torch.tensor(state["w"])
        start_step = state["step"]

    def loss_fn(w):
        return torch.mean((X @ w - y) ** 2)

    lr = config["lr"]
    for step in range(start_step, config["steps"]):
        w = w.detach().requires_grad_(True)
        loss_fn(w).backward()
        g = w.grad.numpy()
        # DDP: average gradients across workers through the collective
        g = collective.allreduce(g, group_name=ctx.collective_group) / world
        w = w.detach() - lr * torch.tensor(g)
        if step % 5 == 4 or step == config["steps"] - 1:
            ckpt = Checkpoint.from_dict({"w": w.numpy(), "step": step + 1})
            train.report({"loss": float(loss_fn(w)), "step": step}, checkpoint=ckpt)
    return float(loss_fn(w))


def answer_loop(config):
    train.report({"answer": config["x"] * 2})
    return None


def flaky_loop(config):
    """Rank 1 dies once at step 3 (a hard exit); the restarted group
    resumes from the latest checkpoint. The ranks step together (a barrier
    a step, as a data-parallel step's all-reduce would make them), so rank
    0 cannot finish alone before the crash."""
    ctx = train.get_context()
    start = train.get_checkpoint()
    step0 = start.to_dict()["step"] if start else 0
    for step in range(step0, 6):
        collective.barrier(group_name=ctx.collective_group)
        if step == 3 and ctx.get_world_rank() == 1 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)  # hard crash, not an exception
        ckpt = Checkpoint.from_dict({"step": step + 1})
        train.report({"step": step, "start": step0}, checkpoint=ckpt)
    return "done"


def always_fails(config):
    raise RuntimeError("nope")


def actor_loop(config):
    """Reports whether it runs inside an actor of the port's runtime."""
    import ray_tpu_torch

    actor_id = ray_tpu_torch.get_runtime_context().get_actor_id()
    train.report({"in_actor": actor_id is not None, "pid": os.getpid(),
                  "device": str(train.get_device())})


def group_loop(config):
    """Sums rank + 1 over the attempt's collective group; reports the sum
    and the group's name."""
    ctx = train.get_context()
    total = collective.allreduce(np.array(ctx.get_world_rank() + 1.0), ctx.collective_group)
    train.report({"sum": float(total), "group": ctx.collective_group})


def split_linear_loop(config):
    """``tests/test_data.py``'s streaming_split loop in torch: each rank
    pulls its DataIterator (``config["splits"][rank]``, a shard of one
    stream) in batches of 16 and takes a gradient step on each, gradients
    averaged through the collective group; reports the rows it saw, the
    loss on the whole set and the seconds the group's rendezvous took."""
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    it = config["splits"][rank]
    w = torch.zeros(4)
    rows = 0
    for batch in it.iter_batches(batch_size=16):
        x, y = torch.from_numpy(batch["x"]), torch.from_numpy(batch["y"])
        w = w.detach().requires_grad_(True)
        torch.mean((x @ w - y) ** 2).backward()
        g = collective.allreduce(w.grad.numpy(), group_name=ctx.collective_group) / world
        w = w.detach() - 0.1 * torch.from_numpy(g)
        rows += len(batch["x"])
    x_full, y_full = (torch.from_numpy(a) for a in config["eval"])
    group = collective.get_group_handle(ctx.collective_group)
    train.report({"rows": rows, "loss": float(torch.mean((x_full @ w - y_full) ** 2)),
                  "rendezvous_s": group.rendezvous_s})


def loss_over_lr_loop(config):
    """``tests/test_tune.py``'s Tune-over-Train loop: a loss of 100 / lr."""
    train.report({"loss": 100.0 / config["lr"]})


def tiny_llama_loop(config):
    """``config["steps"]`` AdamW steps (lr ``config["lr"]``) of
    ``LlamaConfig.tiny()`` on the CPU, weights and one batch drawn from
    ``config["seed"]``; reports every loss, then the last as ``loss``."""
    from ray_tpu_torch.models.llama import AdamW, LlamaConfig, llama_init, make_train_step

    cfg = LlamaConfig.tiny()
    g = torch.Generator().manual_seed(config["seed"])
    params = llama_init(g, cfg, "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 33), generator=g)}
    opt = AdamW(config["lr"])
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    losses = []
    for _ in range(config["steps"]):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    train.report({"losses": losses, "loss": losses[-1]})
