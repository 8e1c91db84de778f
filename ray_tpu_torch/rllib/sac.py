"""SAC (discrete): twin soft Q critics + entropy-temperature autotuning.

Counterpart of ``ray_tpu/rllib/sac.py`` (ref: rllib/algorithms/sac/sac.py
+ sac_torch_learner.py twin-Q / alpha losses), in the discrete-action form
(Christodoulou 2019): expectations over the action simplex replace the
reparameterized sample.

Losses per batch (s, a, r, s', d):
  y      = r + gamma (1-d) E_{a'~pi}[ min(Q1t,Q2t)(s',a') - alpha log pi ]
  L_Q    = MSE(Q1(s,a), y) + MSE(Q2(s,a), y)
  L_pi   = E_s E_{a~pi}[ alpha log pi(a|s) - min(Q1,Q2)(s,a) ]
  L_alpha= E_s E_{a~pi}[ -log_alpha (log pi(a|s) + target_entropy) ]

Each of JAX's ``stop_gradient``s is a ``.detach()`` (or ``no_grad``) at the
same place.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib.core import Adam, RLModule, apply, mlp_init, params_to_numpy, seeded
from ray_tpu_torch.rllib.dqn import TransitionRunner
from ray_tpu_torch.rllib.learner import to_tensors
from ray_tpu_torch.rllib.ppo import (AlgorithmConfig, make_runners, runner_metrics, spaces,
                                     stop_actors)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.utils.device import resolve_device


def sac_init(generator: torch.Generator, obs_dim: int, n_actions: int, hidden: int = 64,
             initial_alpha: float = 1.0, device=None) -> RLModule:
    sizes = [obs_dim, hidden, hidden, n_actions]
    return RLModule({"pi": mlp_init(generator, sizes), "q1": mlp_init(generator, sizes),
                     "q2": mlp_init(generator, sizes)},
                    log_alpha=float(np.log(initial_alpha))).to(resolve_device(device))


def critic_target(module: RLModule) -> RLModule:
    """The target critics: copies of ``q1`` and ``q2``."""
    return RLModule({"q1": copy.deepcopy(module["q1"]),
                     "q2": copy.deepcopy(module["q2"])}).requires_grad_(False)


def polyak(target: RLModule, module: RLModule, tau: float) -> None:
    """target <- (1 - tau) target + tau online, on the critics only."""
    with torch.no_grad():
        for name in ("q1", "q2"):
            for t, s in zip(target[name].parameters(), module[name].parameters()):
                t.copy_((1 - tau) * t + tau * s)


def soft_losses(module, target, batch, gamma: float, target_entropy: float):
    """(Q1(s,a), Q2(s,a), y, the policy loss, the temperature loss, the
    Q heads on s): the terms SAC and CQL share."""
    logp = F.log_softmax(module["pi"](batch["obs"]), dim=-1)
    q1, q2 = module["q1"](batch["obs"]), module["q2"](batch["obs"])
    alpha = module.log_alpha.exp().detach()
    a = batch["actions"][:, None]
    with torch.no_grad():
        # critic target under the CURRENT policy at s'
        logp_n = F.log_softmax(module["pi"](batch["next_obs"]), dim=-1)
        q_t = torch.minimum(target["q1"](batch["next_obs"]), target["q2"](batch["next_obs"]))
        soft_v = (logp_n.exp() * (q_t - alpha * logp_n)).sum(-1)
        y = batch["rewards"] + gamma * (1.0 - batch["dones"]) * soft_v
    q1_a = q1.gather(-1, a)[:, 0]
    q2_a = q2.gather(-1, a)[:, 0]
    # actor: expectation over the simplex, critics frozen
    pi = logp.exp()
    q_min = torch.minimum(q1, q2).detach()
    pi_loss = (pi * (alpha * logp - q_min)).sum(-1).mean()
    # temperature: push policy entropy toward target_entropy
    ent_err = ((pi * logp).sum(-1) + target_entropy).detach()
    alpha_loss = (-module.log_alpha * ent_err).mean()
    return q1_a, q2_a, y, pi_loss, alpha_loss, q1, q2


def make_sac_update(lr: float, gamma: float, tau: float, target_entropy: float):
    """(update, optimizer): ``update(module, target, opt, batch)`` takes one
    step in place, Polyak-averages the target critics, and returns (loss,
    q_loss, alpha) as tensors; alpha is the temperature the step used."""

    def update(module, target, opt, batch):
        q1_a, q2_a, y, pi_loss, alpha_loss, _, _ = soft_losses(
            module, target, batch, gamma, target_entropy)
        alpha = module.log_alpha.exp().detach()
        q_loss = ((q1_a - y) ** 2).mean() + ((q2_a - y) ** 2).mean()
        loss = q_loss + pi_loss + alpha_loss
        apply(opt, loss)
        polyak(target, module, tau)
        return loss.detach(), q_loss.detach(), alpha

    return update, Adam(lr)


class SACEnvRunner(TransitionRunner):
    """Stochastic-policy sampling into flat replay transitions (same
    autoreset handling as the DQN runner)."""

    def _actions(self, rng):
        with torch.no_grad():
            probs = torch.softmax(self.module["pi"](self._to_device(self.obs)), dim=-1)
            action = torch.multinomial(probs, 1, generator=self._generator)[:, 0]
        return action.cpu().numpy()


class SACConfig(AlgorithmConfig):
    """Builder-style config (ref: sac.py SACConfig)."""

    def __init__(self):
        self.env_name: str | None = None
        self.env_config: dict = {}
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_fragment_length = 64
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.01
        #: None -> 0.98 * log(n_actions) (the discrete-SAC convention)
        self.target_entropy: float | None = None
        #: starting temperature (the autotuner moves it from here)
        self.initial_alpha = 1.0
        self.buffer_capacity = 100_000
        self.batch_size = 256
        self.learning_starts = 500
        self.train_batches_per_iter = 16
        self.hidden = 64
        self.seed = 0
        self.device = None

    def training(self, *, lr=None, gamma=None, tau=None, target_entropy=None,
                 initial_alpha=None, buffer_capacity=None, batch_size=None,
                 learning_starts=None, train_batches_per_iter=None,
                 hidden=None):
        return self._set(lr=lr, gamma=gamma, tau=tau, target_entropy=target_entropy,
                         initial_alpha=initial_alpha, buffer_capacity=buffer_capacity,
                         batch_size=batch_size, learning_starts=learning_starts,
                         train_batches_per_iter=train_batches_per_iter, hidden=hidden)

    def build(self) -> "SAC":
        if self.env_name is None:
            raise ValueError("SACConfig.environment(...) is required")
        return SAC(self)


class SAC:
    """Off-policy driver (ref: sac.py training_step): stochastic-policy
    sampling on the runner actors -> replay -> twin-critic soft updates
    with autotuned temperature -> weight broadcast."""

    def __init__(self, config: SACConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.runners = make_runners(SACEnvRunner, config)
        obs_dim, n_actions = spaces(self.runners)
        self.module = sac_init(seeded(config.seed, "cpu"), obs_dim, n_actions, config.hidden,
                               initial_alpha=config.initial_alpha, device=self.device)
        self.target_module = critic_target(self.module)
        tgt_h = (config.target_entropy if config.target_entropy is not None
                 else 0.98 * float(np.log(n_actions)))
        self._update, optimizer = make_sac_update(config.lr, config.gamma, config.tau, tgt_h)
        self.opt = optimizer.init(self.module)
        self.buffer = ReplayBuffer(config.buffer_capacity, seed=config.seed)
        self._iteration = 0
        self._updates = 0
        self._sync_weights()

    def _sync_weights(self):
        weights = params_to_numpy(self.module)
        ray_tpu_torch.get([r.set_weights.remote(weights) for r in self.runners], timeout=120)

    def train(self) -> dict:
        t0 = time.monotonic()
        c = self.config
        rollouts = ray_tpu_torch.get(
            [r.sample.remote(c.rollout_fragment_length) for r in self.runners], timeout=600)
        for ro in rollouts:
            self.buffer.add_batch(ro)
        losses, alphas = [], []
        if len(self.buffer) >= c.learning_starts:
            for _ in range(c.train_batches_per_iter):
                batch = self.buffer.sample(c.batch_size)
                tb = to_tensors({k: v for k, v in batch.items() if k != "indices"},
                                self.device)
                loss, _q_loss, alpha = self._update(self.module, self.target_module,
                                                    self.opt, tb)
                losses.append(loss)
                alphas.append(alpha)
                self._updates += 1
        self._sync_weights()
        ret_mean, episodes = runner_metrics(self.runners)
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": ret_mean,
            "episodes_this_iter": episodes,
            "loss": float(torch.stack(losses).mean()) if losses else float("nan"),
            "alpha": float(torch.stack(alphas).mean()) if alphas else float("nan"),
            "buffer_size": len(self.buffer),
            "num_updates": self._updates,
            "time_this_iter_s": time.monotonic() - t0,
        }

    def get_weights(self):
        return self.module

    def stop(self):
        stop_actors(self.runners)
