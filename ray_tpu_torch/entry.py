"""Port entry points: the flagship Llama forward on one card, and the
multi-process dryrun.

Counterpart of ``__graft_entry__.py``: ``entry()`` has the same
configuration and ``[2, 256]`` tokens, returning ``(fn, example_args)`` on
the device; ``dryrun_multichip(n)`` runs one AdamW step of every
parallelism configuration of ``__graft_entry__.dryrun_multichip`` over n
ranks, its trainer arm, and its sharded-object-plane arm on the port's
runtime.
"""
from __future__ import annotations

import math
import shutil
import tempfile

import numpy as np
import torch

from ray_tpu_torch.models.llama import (
    AdamW,
    LlamaConfig,
    llama_forward,
    llama_init,
    llama_loss,
    llama_pp_init,
    llama_pp_loss,
    make_train_step,
)
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.parallel.sharding import PartitionRules, shard_pytree
from ray_tpu_torch.utils.device import resolve_device


def entry(device=None):
    """Forward step on the flagship Llama model, single card.

    Returns (fn, example_args): fn(params, tokens) -> logits."""
    device = resolve_device(device)
    cfg = LlamaConfig(
        vocab_size=2048,
        d_model=512,
        n_layers=4,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1408,
        max_seq_len=512,
        dtype="bfloat16",
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = llama_init(generator, cfg, device)
    tokens = torch.zeros((2, 256), dtype=torch.int64, device=device)

    @torch.inference_mode()
    def fn(params, tokens):
        logits, _ = llama_forward(params, tokens, cfg, attn_impl="auto")
        return logits

    return fn, (params, tokens)


_BASE = dict(vocab_size=512, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, max_seq_len=128,
             dtype="float32")


def _spmd_config(n: int) -> MeshSpec:
    """Configuration A's mesh over ``n`` ranks (``__graft_entry__``'s)."""
    if n % 4 == 0:
        return MeshSpec(dp=n // 4, tp=2, sp=2)
    if n % 2 == 0:
        return MeshSpec(dp=n // 2, tp=2)
    return MeshSpec(dp=n)


def _finite(label: str, loss) -> float:
    loss = float(loss)
    if not math.isfinite(loss):
        raise AssertionError(f"{label}: loss is {loss}")
    return loss


def _dryrun_loop(config):
    """One rank of the dryrun: one AdamW step of each configuration, every
    rank passing the same seeded params and batch; each reported."""
    from ray_tpu_torch import train

    device = train.get_device()
    n = train.get_context().get_world_size()

    def seeded(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def tokens(B, T, cfg):
        return torch.randint(0, cfg.vocab_size, (B, T + 1), generator=seeded(1), device=device)

    def run_sharded(label, spec, cfg):
        mesh = spec.build(device)
        # params ZeRO/Megatron-placed by the rules table, as the JAX dryrun's
        params = shard_pytree(llama_init(seeded(0), cfg, device), PartitionRules.llama(), mesh)
        opt = AdamW(1e-3)
        state = opt.init(params)
        batch = {"tokens": tokens(2 * spec.dp * spec.fsdp * spec.ep, 32 * spec.sp, cfg)}
        _, _, loss = make_train_step(cfg, opt, mesh=mesh)(params, state, batch)
        train.report({"label": label, "mesh": spec.axes, "loss": _finite(label, loss)})

    def run_pipelined(label, spec, tp_axis):
        mesh = spec.build(device)
        cfg = LlamaConfig(n_layers=4, **_BASE)
        params = llama_pp_init(seeded(0), cfg, spec.pp, device)
        opt = AdamW(1e-3)
        state = opt.init(params)
        n_micro = 2
        batch = {"tokens": tokens(2 * spec.dp * n_micro, 32, cfg)}
        loss = llama_pp_loss(params, batch, cfg, mesh, n_microbatches=n_micro, tp_axis=tp_axis)
        loss.backward()
        opt.update(state)
        train.report({"label": label, "mesh": spec.axes, "loss": _finite(label, loss)})

    # A: dp x tp x sp (ring attention on the sp axis)
    run_sharded("dp·tp·sp", _spmd_config(n), LlamaConfig(n_layers=2, **_BASE))
    if n % 8 == 0:
        # B: dp x fsdp x ep with MoE layers (experts on ep, params on fsdp)
        run_sharded("dp·fsdp·ep(moe)", MeshSpec(dp=n // 4, fsdp=2, ep=2),
                    LlamaConfig(n_layers=2, n_experts=2, moe_every=2, **_BASE))
        # C: dp x pp, GPipe, microbatched, batch on dp
        run_pipelined("dp·pp gpipe", MeshSpec(dp=n // 2, pp=2), None)
        # D: dp x tp x pp, Megatron inside each GPipe stage
        run_pipelined("dp·tp·pp megatron-gpipe", MeshSpec(dp=n // 4, tp=2, pp=2), "tp")


def _trainer_loop(config):
    """Per-worker body of the trainer arm: a dp·tp Llama gradient over the
    workers' mesh, then the loss and a gradient slice all-reduced through
    the collective group (numpy in, numpy out)."""
    from ray_tpu_torch import collective, train

    ctx = train.get_context()
    device = train.get_device()
    world = ctx.get_world_size()
    spec = MeshSpec.infer(world, tp=2 if config["n_devices"] % 2 == 0 else 1)
    mesh = spec.build(device)
    cfg = LlamaConfig(n_layers=2, **_BASE)
    params = shard_pytree(llama_init(torch.Generator(device=device).manual_seed(0), cfg, device),
                          PartitionRules.llama(), mesh)
    leaves = AdamW(1e-3).init(params).param_groups[0]["params"]
    toks = torch.randint(0, cfg.vocab_size, (2 * spec.dp, 33),
                         generator=torch.Generator(device=device).manual_seed(1), device=device)
    loss = llama_loss(params, {"tokens": toks}, cfg, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    avg = collective.allreduce(np.asarray(float(loss), np.float32),
                               group_name=ctx.collective_group) / world
    g0 = grads[0].detach().float().cpu().numpy().ravel()[:16].copy()
    collective.allreduce(g0, group_name=ctx.collective_group)
    train.report({"loss": float(avg), "mesh": spec.axes})
    return float(avg)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One AdamW step of each parallelism configuration over ``n_devices``
    ranks, each a process of a ``TorchTrainer`` (NCCL ranks on as many
    cards; gloo ranks with ``device="cpu"``), printing JAX's ``dryrun[...]
    OK`` lines:

      A. dp x tp x sp   — tensor + ring-attention sequence parallel
      B. dp x fsdp x ep — ZeRO param sharding + MoE expert parallel
      C. dp x pp        — GPipe pipeline (microbatched)
      D. dp x tp x pp   — Megatron tensor parallelism inside GPipe stages

    (B-D where ``n_devices % 8 == 0``), then the trainer arm: a 2-worker
    ``TorchTrainer`` whose workers take a dp·tp gradient over their mesh
    and all-reduce the loss and a gradient slice through ``collective``
    (gloo; on one card both workers share it, at dp=2), then the sharded
    object plane's arm (``_dryrun_sharded``)."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    dev = resolve_device(device)
    use_gpu = dev.type == "cuda"
    if use_gpu and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} NCCL ranks need {n_devices} cards; "
                           f"{torch.cuda.device_count()} visible")
    storage = tempfile.mkdtemp(prefix="rt_dryrun_")
    try:
        result = TorchTrainer(
            _dryrun_loop, train_loop_config={"n_devices": n_devices},
            scaling_config=ScalingConfig(num_workers=n_devices, use_gpu=use_gpu),
            run_config=RunConfig(name="dryrun", storage_path=storage)).fit()
        if result.error is not None:
            raise result.error
        for m in result.metrics_history:
            if m["world_rank"] == 0:
                print(f"dryrun[{m['label']}] OK: mesh={m['mesh']} loss={m['loss']:.4f}",
                      flush=True)
        share = 0.5 if use_gpu and torch.cuda.device_count() < 2 else 1.0
        result = TorchTrainer(
            _trainer_loop, train_loop_config={"n_devices": min(n_devices, 4)},
            scaling_config=ScalingConfig(num_workers=2, use_gpu=use_gpu,
                                         resources_per_worker={"GPU": share} if use_gpu
                                         else None,
                                         collective_backend="gloo"),
            run_config=RunConfig(name="dryrun_trainer", storage_path=storage)).fit()
        if result.error is not None:
            raise result.error
        loss = _finite("trainer dryrun", result.metrics["loss"])
        print(f"dryrun[torchtrainer 2-worker dp·tp] OK: mesh={result.metrics['mesh']} "
              f"loss={loss:.4f}", flush=True)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    _dryrun_sharded(n_devices, dev)
    print(f"dryrun_multichip OK: devices={n_devices}, all configs finite", flush=True)


def _dryrun_sharded(n_devices: int, device) -> None:
    """Sharded-object-plane arm: a dp·tp-sharded batch on ``device`` goes
    through put_sharded -> ``@remote(in_specs=..., out_specs=...)`` shard
    wave (with a (dp, tp) -> (dp,) reshard on the spec mismatch) ->
    reshard to (None, tp) -> get_sharded, checked against the same
    arithmetic on the whole tensor; prints the driver-vs-array byte
    counts. Shard tasks lease the card when ``device`` is one."""
    import ray_tpu_torch
    from ray_tpu_torch.core import api
    from ray_tpu_torch.sharded import P, stats

    owns_cluster = not api.is_initialized()
    if owns_cluster:
        ray_tpu_torch.init(num_cpus=8)
    try:
        n = min(n_devices, 8)
        spec = MeshSpec(dp=max(1, n // 2), tp=2 if n % 2 == 0 else 1)
        arr = torch.randn(spec.dp * 4, 64, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
        sref = ray_tpu_torch.put_sharded(arr, mesh=spec, spec=("dp", "tp"))

        @ray_tpu_torch.remote(in_specs=P("dp"), out_specs=P("dp"), device=device,
                              num_gpus=1 if device.type == "cuda" else 0)
        def scale(x):
            return x * 2.0

        out = scale.remote(sref)
        got = ray_tpu_torch.get_sharded(out, mesh=spec, device=device)
        assert torch.equal(got, arr * 2.0), "sharded wave mismatch"
        back = ray_tpu_torch.reshard(out, (None, "tp"), mesh=spec, device=device)
        got2 = ray_tpu_torch.get_sharded(back, mesh=spec, device=device)
        assert torch.equal(got2, arr * 2.0), "reshard mismatch"
        s = stats()
        print(f"dryrun[sharded-object-plane] OK: shards={out.num_shards()}"
              f" driver_bytes={s['driver_bytes']} array_bytes={s['array_bytes']}",
              flush=True)
    finally:
        if owns_cluster:
            ray_tpu_torch.shutdown()
