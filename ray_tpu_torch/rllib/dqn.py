"""DQN: off-policy Q-learning over a replay buffer.

Counterpart of ``ray_tpu/rllib/dqn.py`` (ref: rllib/algorithms/dqn/dqn.py
+ dqn_rainbow_learner.py): double-DQN targets, Huber loss, target-network
syncs, epsilon-greedy env runners, uniform or prioritized replay. The
update is one step over a sampled batch and returns per-sample |TD| for
priority updates. Runners are objects in the driver's process; the target
network is a copy of the online one, never the same tensors.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.core import Adam, RLModule, apply, mlp_init, seeded
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import to_tensors
from ray_tpu_torch.rllib.ppo import RUNTIME_ONLY, AlgorithmConfig, merged_metrics
from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.utils.device import resolve_device


def q_init(generator: torch.Generator, obs_dim: int, n_actions: int, hidden: int = 64,
           device=None) -> RLModule:
    return RLModule({"q": mlp_init(generator, [obs_dim, hidden, hidden, n_actions])}).to(
        resolve_device(device))


def q_values(module: RLModule, obs):
    return module["q"](obs)


def make_dqn_update(lr: float, gamma: float):
    """(update, optimizer): ``update(module, target, opt, batch)`` takes one
    double-DQN step in place (the online net picks the next action, the
    target net evaluates it; Huber loss, delta 1, with importance weights)
    and returns (loss, per-sample |TD|) as tensors."""

    def update(module, target, opt, batch):
        q = q_values(module, batch["obs"])
        qa = q.gather(-1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            next_a = q_values(module, batch["next_obs"]).argmax(-1)
            next_qa = q_values(target, batch["next_obs"]).gather(-1, next_a[:, None])[:, 0]
            y = batch["rewards"] + gamma * (1.0 - batch["dones"]) * next_qa
        loss = (batch["weights"] * F.huber_loss(qa, y, reduction="none", delta=1.0)).mean()
        apply(opt, loss)
        return loss.detach(), (qa - y).abs().detach()

    return update, Adam(lr)


class TransitionRunner(EnvRunner):
    """Sampling into flat replay transitions (ref:
    single_agent_env_runner.py under an off-policy algorithm); subclasses
    pick the actions (``_actions``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # NEXT_STEP autoreset: the step after an env is done ignores its
        # action and spans two episodes; it must not enter replay
        self._prev_done = np.zeros(self.num_envs, dtype=bool)

    def _actions(self, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def sample(self, num_steps: int) -> dict:
        if self.module is None:
            raise RuntimeError("set_weights before sample")
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        rng = np.random.default_rng(self.seed * 1_000_003 + self._rng_counter)
        for _ in range(num_steps):
            self._rng_counter += 1
            action = self._actions(rng)
            next_obs, reward, term, trunc, _ = self.envs.step(action)
            # bootstrap through time-limit truncation (only a true terminal
            # zeroes the target). Envs that finished LAST step are doing
            # their autoreset step now: record nothing for them.
            keep = ~self._prev_done
            if keep.any():
                obs_l.append(self.obs[keep])
                act_l.append(action[keep])
                rew_l.append(np.asarray(reward, dtype=np.float32)[keep])
                next_l.append(next_obs[keep])
                done_l.append(np.asarray(term, dtype=np.float32)[keep])
            done = np.logical_or(term, trunc)
            self._ep_returns += np.where(keep, reward, 0.0)
            for i, d in enumerate(done):
                if d and keep[i]:
                    self.completed_returns.append(float(self._ep_returns[i]))
                    self._ep_returns[i] = 0.0
            self._prev_done = done & keep
            self.obs = next_obs
        return {
            "obs": np.concatenate(obs_l).astype(np.float32),
            "actions": np.concatenate(act_l).astype(np.int32),
            "rewards": np.concatenate(rew_l),
            "next_obs": np.concatenate(next_l).astype(np.float32),
            "dones": np.concatenate(done_l),
        }


class DQNEnvRunner(TransitionRunner):
    """Epsilon-greedy sampling. The exploration draws come from numpy with
    JAX's seed formula, so with equal weights both packages give the same
    transitions."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.epsilon = 1.0

    def set_epsilon(self, eps: float) -> bool:
        self.epsilon = float(eps)
        return True

    def _actions(self, rng):
        with torch.no_grad():
            greedy = q_values(self.module, self._to_device(self.obs)).argmax(-1)
        greedy = greedy.cpu().numpy()
        explore = rng.random(self.num_envs) < self.epsilon
        random_a = rng.integers(0, int(self.envs.single_action_space.n), size=self.num_envs)
        return np.where(explore, random_a, greedy)


class DQNConfig(AlgorithmConfig):
    """Builder-style config (ref: dqn.py DQNConfig)."""

    def __init__(self):
        self.env_name: str | None = None
        self.env_config: dict = {}
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_fragment_length = 64
        self.lr = 1e-3
        self.gamma = 0.99
        self.hidden = 64
        self.buffer_capacity = 50_000
        self.prioritized = False
        self.batch_size = 64
        self.train_batches_per_iter = 32
        self.target_update_freq = 200  # in update steps
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_iters = 15
        self.learning_starts = 500  # min buffer size before updates
        self.seed = 0
        self.device = None

    def training(self, *, lr=None, gamma=None, hidden=None,
                 buffer_capacity=None, prioritized=None, batch_size=None,
                 train_batches_per_iter=None, target_update_freq=None,
                 epsilon_decay_iters=None, learning_starts=None):
        return self._set(lr=lr, gamma=gamma, hidden=hidden, buffer_capacity=buffer_capacity,
                         prioritized=prioritized, batch_size=batch_size,
                         train_batches_per_iter=train_batches_per_iter,
                         target_update_freq=target_update_freq,
                         epsilon_decay_iters=epsilon_decay_iters,
                         learning_starts=learning_starts)

    def build(self) -> "DQN":
        if self.env_name is None:
            raise ValueError("DQNConfig.environment(...) is required")
        return DQN(self)


class DQN:
    """Off-policy driver (ref: dqn.py DQN.training_step): epsilon-greedy
    sampling -> replay buffer -> double-DQN updates -> periodic target sync
    -> weight copy to the runners."""

    def __init__(self, config: DQNConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.runners = [
            DQNEnvRunner(config.env_name, config.num_envs_per_runner,
                         seed=config.seed + 1000 * i, env_config=config.env_config,
                         device=self.device)
            for i in range(config.num_env_runners)
        ]
        obs_dim, n_actions = self.runners[0].obs_and_action_space()
        self.module = q_init(seeded(config.seed, "cpu"), obs_dim, n_actions, config.hidden,
                             self.device)
        self.target_module = copy.deepcopy(self.module)
        self._update, optimizer = make_dqn_update(config.lr, config.gamma)
        self.opt = optimizer.init(self.module)
        buf_cls = PrioritizedReplayBuffer if config.prioritized else ReplayBuffer
        self.buffer = buf_cls(config.buffer_capacity, seed=config.seed)
        self._updates = 0
        self._iteration = 0
        self._sync_weights()

    def _sync_weights(self):
        for r in self.runners:
            r.set_weights(self.module)

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._iteration / max(1, c.epsilon_decay_iters))
        return c.epsilon_start + frac * (c.epsilon_end - c.epsilon_start)

    def train(self) -> dict:
        t0 = time.monotonic()
        c = self.config
        eps = self._epsilon()
        for r in self.runners:
            r.set_epsilon(eps)
        for r in self.runners:
            self.buffer.add_batch(r.sample(c.rollout_fragment_length))
        losses = []
        if len(self.buffer) >= c.learning_starts:
            for _ in range(c.train_batches_per_iter):
                batch = self.buffer.sample(c.batch_size)
                tb = to_tensors({k: v for k, v in batch.items() if k != "indices"},
                                self.device)
                loss, td = self._update(self.module, self.target_module, self.opt, tb)
                self.buffer.update_priorities(batch["indices"], td.cpu().numpy())
                losses.append(loss)
                self._updates += 1
                if self._updates % c.target_update_freq == 0:
                    self.target_module.load_state_dict(self.module.state_dict())
        self._sync_weights()
        ret_mean, episodes = merged_metrics([r.episode_metrics() for r in self.runners])
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": ret_mean,
            "episodes_this_iter": episodes,
            "loss": float(torch.stack(losses).mean()) if losses else float("nan"),
            "epsilon": eps,
            "buffer_size": len(self.buffer),
            "num_updates": self._updates,
            "time_this_iter_s": time.monotonic() - t0,
        }

    def get_weights(self):
        return self.module

    def stop(self):
        pass

    @classmethod
    def as_trainable(cls, config: "DQNConfig", stop_iters: int = 10):
        """The Tune adapter."""
        raise NotImplementedError(f"as_trainable {RUNTIME_ONLY}")
