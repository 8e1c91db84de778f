"""PPO learner and learner group member.

Counterpart of ``ray_tpu/rllib/learner.py`` (ref:
rllib/core/learner/learner.py:107 grads :170, learner_group.py:100 update
:234). The update runs GAE on the host, then clipped-surrogate PPO over
minibatch epochs with ``torch.optim.Adam`` on the learner's device. PPO
runs each learner as an actor of the port's runtime, as JAX does. With
``world_size > 1`` the learners meet in a ``ray_tpu_torch.collective``
group (through the runtime's GCS KV, or the config's ``init_method``) and
average params and Adam moments after every update.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.core import (Adam, apply, params_to_numpy, policy_init, policy_logits,
                                     seeded, value_fn)
from ray_tpu_torch.utils.device import resolve_device


def compute_gae(rollout: dict, gamma: float, lam: float) -> dict:
    """Flatten [T, N] rollouts into GAE advantages + returns (numpy; runs
    once per batch on host — the heavy math stays in the update)."""
    rewards, values, dones = rollout["rewards"], rollout["values"], rollout["dones"]
    T, N = rewards.shape
    adv = np.zeros((T, N), dtype=np.float32)
    last_adv = np.zeros(N, dtype=np.float32)
    next_value = rollout["last_value"]
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_adv = delta + gamma * lam * nonterminal * last_adv
        adv[t] = last_adv
        next_value = values[t]
    returns = adv + values
    flat = lambda a: a.reshape(-1, *a.shape[2:])  # noqa: E731
    return {
        "obs": flat(rollout["obs"]).astype(np.float32),
        "actions": flat(rollout["actions"]).astype(np.int32),
        "logp_old": flat(rollout["logp"]).astype(np.float32),
        "advantages": flat(adv).astype(np.float32),
        "returns": flat(returns).astype(np.float32),
    }


def to_tensors(batch: dict, device) -> dict:
    """Host arrays to tensors on ``device``: integer arrays (actions) as
    int64 indices, the rest float32. Always copies: a rollout read from
    the object store is a read-only view of its shm arena."""
    return {k: torch.tensor(np.asarray(v), device=device).long()
            if np.issubdtype(np.asarray(v).dtype, np.integer)
            else torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in batch.items()}


def entropy(logp_all):
    return -(logp_all.exp() * logp_all).sum(-1).mean()


def make_ppo_update(clip: float, vf_coeff: float, entropy_coeff: float,
                    lr: float, epochs: int, minibatches: int):
    """(update, optimizer): ``optimizer.init(module)`` gives the Adam
    state and ``update(module, opt, batch, generator)`` runs ``epochs``
    passes of ``minibatches`` steps over a permutation drawn from
    ``generator`` per epoch, in place, and returns the mean loss as a
    0-dim tensor (ref: ppo.py training_step :388 + torch_learner grads)."""

    def loss_fn(module, mb):
        logp_all = F.log_softmax(policy_logits(module, mb["obs"]), dim=-1)
        logp = logp_all.gather(-1, mb["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - mb["logp_old"])
        adv = mb["advantages"]
        # jnp.std: the population std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
        vf = ((value_fn(module, mb["obs"]) - mb["returns"]) ** 2).mean()
        return pg + vf_coeff * vf - entropy_coeff * entropy(logp_all)

    def update(module, opt, batch: dict, generator: torch.Generator):
        n = batch["obs"].shape[0]
        mb_size = n // minibatches
        total = torch.zeros((), device=batch["obs"].device)
        for _ in range(epochs):
            perm = torch.randperm(n, generator=generator, device=generator.device)
            perm = perm.to(batch["obs"].device)
            for i in range(minibatches):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                loss = loss_fn(module, {k: v[idx] for k, v in batch.items()})
                apply(opt, loss)
                total += loss.detach()
        return total / (epochs * minibatches)

    return update, Adam(lr)


class Learner:
    """One PPO learner replica (ref: learner.py:107). With world_size > 1,
    replicas sync after each local update by averaging params and Adam's
    moments (``exp_avg``, ``exp_avg_sq``) over the group. Adam's ``step``
    is never averaged: it is a float tensor in ``torch.optim`` where
    optax's count is an integer that JAX's float filter leaves local, and a
    rank with an empty shard keeps its own count."""

    def __init__(self, rank: int, world_size: int, config: dict,
                 group_name: str | None = None):
        self.rank = rank
        self.world_size = world_size
        self.config = config
        self.group_name = group_name or "rl_learners"
        self.device = resolve_device(config.get("device"))
        if world_size > 1:
            from ray_tpu_torch import collective

            collective.init_collective_group(
                world_size, rank, backend=config.get("collective_backend", "gloo"),
                group_name=self.group_name, init_method=config.get("init_method"))
        self.module = policy_init(seeded(config.get("seed", 0), "cpu"), config["obs_dim"],
                                  config["n_actions"], config.get("hidden", 64), self.device)
        self._update, optimizer = make_ppo_update(
            clip=config.get("clip", 0.2),
            vf_coeff=config.get("vf_coeff", 0.5),
            entropy_coeff=config.get("entropy_coeff", 0.01),
            lr=config.get("lr", 3e-4),
            epochs=config.get("epochs", 4),
            minibatches=config.get("minibatches", 4),
        )
        self.opt = optimizer.init(self.module)
        self._step = 0
        # learner ConnectorV2 pipeline (ref: the learner connector stage):
        # applied to the host-side train batch after GAE, before the copy
        # to the device
        lc = config.get("learner_connector")
        from ray_tpu_torch.rllib.connectors import ConnectorCtx, ConnectorV2

        self.learner_pipe = (
            lc if isinstance(lc, ConnectorV2) or lc is None else lc())
        self._learner_ctx = ConnectorCtx(phase="learner")

    def get_weights(self):
        return self.module

    def get_host_weights(self) -> dict:
        """The policy as a host numpy tree (JAX's layout), what the
        runners' ``set_weights`` takes: it leaves the card here, once."""
        return params_to_numpy(self.module)

    def get_state(self) -> dict:
        """This learner's process and device, and host numpy copies of
        every parameter and its Adam state (``param/<name>``,
        ``exp_avg/<name>``, ``exp_avg_sq/<name>``, ``step/<name>``)."""
        tensors = {}
        for name, p in self.module.named_parameters():
            st = self.opt.state[p]
            for key, t in (("param", p), ("exp_avg", st["exp_avg"]),
                           ("exp_avg_sq", st["exp_avg_sq"]), ("step", st["step"])):
                tensors[f"{key}/{name}"] = t.detach().cpu().numpy().copy()
        return {"pid": os.getpid(), "device": str(self.device), "tensors": tensors}

    def update(self, rollouts: list[dict]) -> dict:
        """One training step over this learner's share of rollouts. A rank
        with an empty shard still participates in the sync (every rank must
        enter the collective or the group deadlocks)."""
        loss = 0.0
        samples = 0
        if rollouts:
            batches = [
                compute_gae(r, self.config.get("gamma", 0.99),
                            self.config.get("lam", 0.95))
                for r in rollouts
            ]
            batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
            if self.learner_pipe is not None:
                batch = self.learner_pipe(batch, self._learner_ctx)
            batch = to_tensors(batch, self.device)
            self._step += 1
            generator = seeded(self.config.get("seed", 0) * 7919 + self._step, self.device)
            loss = float(self._update(self.module, self.opt, batch, generator))
            samples = int(batch["obs"].shape[0])
        if self.world_size > 1:
            self._sync()
        return {"loss": loss, "samples": samples}

    def _sync(self):
        """Average params and Adam moments over the group in one
        all-reduce of their concatenation."""
        from ray_tpu_torch import collective

        tensors = []
        for p in self.module.parameters():
            state = self.opt.state[p]
            tensors += [p.data, state["exp_avg"], state["exp_avg_sq"]]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        flat = collective.allreduce(flat, group_name=self.group_name) / self.world_size
        with torch.no_grad():
            for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
                t.copy_(part.view_as(t))
