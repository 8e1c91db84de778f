"""IMPALA: sampling with stale policies and V-trace off-policy correction.

Counterpart of ``ray_tpu/rllib/impala.py`` (ref:
rllib/algorithms/impala/impala.py + the V-trace math of
impala/vtrace_*.py, Espeholt et al. 2018). The learner corrects for policy
lag with truncated importance weights (rho/c bars), and weights reach the
runners only every ``broadcast_interval`` consumed batches, so runner
policies are deliberately stale in between.

As in JAX, a sample request stands in flight on every runner actor; the
learner (in the driver's process, on its device) consumes whichever
finishes first (``ray_tpu_torch.wait``), relaunches that runner at once
with the policy it holds, and broadcasts weights fire-and-forget.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib.core import (Adam, apply, params_to_numpy, policy_init, policy_logits,
                                     seeded, value_fn)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import entropy, to_tensors
from ray_tpu_torch.rllib.ppo import (AlgorithmConfig, make_runners, runner_metrics, spaces,
                                     stop_actors)
from ray_tpu_torch.utils.device import resolve_device


def vtrace_returns(behavior_logp, target_logp, rewards, values, last_value,
                   dones, *, gamma: float, rho_bar: float = 1.0,
                   c_bar: float = 1.0):
    """V-trace targets + policy-gradient advantages over [T, N] tensors,
    by a reverse loop over T (JAX's ``lax.scan(..., reverse=True)``)."""
    rho = torch.clamp(torch.exp(target_logp - behavior_logp), max=rho_bar)
    c = torch.clamp(rho, max=c_bar)
    not_done = 1.0 - dones.float()
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rho * (rewards + gamma * not_done * next_values - values)
    acc = torch.zeros_like(last_value)
    vs_minus_v = [None] * deltas.shape[0]
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * not_done[t] * c[t] * acc
        vs_minus_v[t] = acc
    vs = values + torch.stack(vs_minus_v)
    next_vs = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = rho * (rewards + gamma * not_done * next_vs - values)
    return vs, pg_adv


def vtrace_terms(module, batch, gamma, rho_bar, c_bar):
    """(log-softmax of the logits, target logp, values, V-trace targets,
    advantages) of a [T, N] batch; the V-trace outputs carry no gradient
    (JAX's ``stop_gradient``)."""
    logp_all = F.log_softmax(policy_logits(module, batch["obs"]), dim=-1)
    target_logp = logp_all.gather(-1, batch["actions"][..., None])[..., 0]
    values = value_fn(module, batch["obs"])
    with torch.no_grad():
        vs, pg_adv = vtrace_returns(
            batch["logp"], target_logp, batch["rewards"], values,
            value_fn(module, batch["last_obs"]), batch["dones"],
            gamma=gamma, rho_bar=rho_bar, c_bar=c_bar)
    return logp_all, target_logp, values, vs, pg_adv


def make_impala_update(lr: float, gamma: float, vf_coeff: float,
                       entropy_coeff: float, rho_bar: float, c_bar: float):
    """(update, optimizer): ``update(module, opt, batch)`` takes one step in
    place and returns the loss as a 0-dim tensor."""

    def update(module, opt, batch):
        logp_all, target_logp, values, vs, pg_adv = vtrace_terms(
            module, batch, gamma, rho_bar, c_bar)
        pi_loss = -(target_logp * pg_adv).mean()
        vf_loss = 0.5 * ((values - vs) ** 2).mean()
        loss = pi_loss + vf_coeff * vf_loss - entropy_coeff * entropy(logp_all)
        apply(opt, loss)
        return loss.detach()

    return update, Adam(lr)


class IMPALAConfig(AlgorithmConfig):
    """Builder-style config (ref: impala.py IMPALAConfig)."""

    def __init__(self):
        self.env_name: str | None = None
        self.env_config: dict = {}
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_fragment_length = 64
        self.lr = 5e-4
        self.gamma = 0.99
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.rho_bar = 1.0
        self.c_bar = 1.0
        #: consumed batches between weight broadcasts (staleness window)
        self.broadcast_interval = 1
        #: batches consumed per train() call
        self.batches_per_iter = 4
        self.hidden = 64
        self.seed = 0
        self.device = None

    def training(self, *, lr=None, gamma=None, vf_coeff=None,
                 entropy_coeff=None, rho_bar=None, c_bar=None,
                 broadcast_interval=None, batches_per_iter=None, hidden=None):
        return self._set(lr=lr, gamma=gamma, vf_coeff=vf_coeff,
                         entropy_coeff=entropy_coeff, rho_bar=rho_bar, c_bar=c_bar,
                         broadcast_interval=broadcast_interval,
                         batches_per_iter=batches_per_iter, hidden=hidden)

    def _build_update(self):
        """(update_fn, optimizer) — subclass hook (APPO swaps the loss)."""
        return make_impala_update(
            self.lr, self.gamma, self.vf_coeff, self.entropy_coeff,
            self.rho_bar, self.c_bar)

    def build(self) -> "IMPALA":
        if self.env_name is None:
            raise ValueError("IMPALAConfig.environment(...) is required")
        return IMPALA(self)


class IMPALA:
    """Async driver (ref: impala.py training_step): a sample request is
    ALWAYS in flight on every runner; the learner consumes whichever
    finishes first and only rebroadcasts weights every
    broadcast_interval batches."""

    def __init__(self, config: IMPALAConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.runners = make_runners(EnvRunner, config)
        obs_dim, n_actions = spaces(self.runners)
        self.module = policy_init(seeded(config.seed, "cpu"), obs_dim, n_actions,
                                  config.hidden, self.device)
        self._update, optimizer = config._build_update()
        self.opt = optimizer.init(self.module)
        self._iteration = 0
        self._consumed = 0
        weights = params_to_numpy(self.module)
        ray_tpu_torch.get([r.set_weights.remote(weights) for r in self.runners], timeout=120)
        # launch the standing sample requests (the async part)
        self._inflight = {r.sample.remote(config.rollout_fragment_length): r
                          for r in self.runners}

    def train(self) -> dict:
        t0 = time.monotonic()
        c = self.config
        losses = []
        for _ in range(c.batches_per_iter):
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1, timeout=600)
            ref = ready[0]
            runner = self._inflight.pop(ref)
            rollout = ray_tpu_torch.get(ref, timeout=60)
            # relaunch IMMEDIATELY with the runner's current (stale-ok)
            # policy: sampling never waits for the learner
            self._inflight[runner.sample.remote(c.rollout_fragment_length)] = runner
            batch = to_tensors({k: rollout[k] for k in (
                "obs", "actions", "logp", "rewards", "dones", "last_obs")}, self.device)
            losses.append(self._update(self.module, self.opt, batch))
            self._consumed += 1
            if self._consumed % c.broadcast_interval == 0:
                # fire-and-forget broadcast: staleness is by design
                # (V-trace corrects the off-policy drift), so a lost
                # update is repaired by the next broadcast
                weights = params_to_numpy(self.module)
                for r in self.runners:
                    r.set_weights.remote(weights)  # raylint: disable=RT003
        ret_mean, episodes = runner_metrics(self.runners)
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": ret_mean,
            "episodes_this_iter": episodes,
            "loss": float(torch.stack(losses).mean()) if losses else float("nan"),
            "batches_consumed": self._consumed,
            "time_this_iter_s": time.monotonic() - t0,
        }

    def get_weights(self):
        return self.module

    def stop(self):
        stop_actors(self.runners)
