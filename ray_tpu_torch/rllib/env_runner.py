"""EnvRunner: samples episodes with the current policy.

Counterpart of ``ray_tpu/rllib/env_runner.py`` (ref:
rllib/env/single_agent_env_runner.py:68 sample :149, env_runner_group.py:71
sync_weights :570). The vector env steps on the host (``envs.py``); the
policy lives on the runner's device, the card unless ``device="cpu"``.
The algorithms run their runners as actors of the port's runtime, as JAX
does (``num_cpus=0.5``, no card: they sample on the host CPU), and pass
them weights by value as host numpy trees. ``set_weights``
copies the values into the runner's own module, so a learner's in-place
optimizer step never reaches a runner before the next ``set_weights``.
"""
from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from ray_tpu_torch.rllib import envs
from ray_tpu_torch.rllib.connectors import ConnectorCtx
from ray_tpu_torch.rllib.core import (RLModule, params_from_numpy, params_to_numpy,
                                      sample_action, seeded, value_fn)
from ray_tpu_torch.utils.device import resolve_device


def copy_module(weights, device) -> RLModule:
    """A copy of ``weights`` (an ``RLModule`` or a JAX-layout numpy tree) on
    ``device`` that shares no storage with it."""
    if isinstance(weights, RLModule):
        return copy.deepcopy(weights).to(device).requires_grad_(False)
    return params_from_numpy(weights, device).requires_grad_(False)


def load_weights(module: RLModule | None, weights, device) -> RLModule:
    """``module`` with ``weights``' values copied in (a fresh copy when
    ``module`` is None)."""
    if module is None:
        return copy_module(weights, device)
    if not isinstance(weights, RLModule):
        weights = params_from_numpy(weights, device)
    with torch.no_grad():
        for dst, src in zip(module.state_dict().values(), weights.state_dict().values()):
            dst.copy_(src)
    return module


class EnvRunner:
    def __init__(self, env_name: str, num_envs: int = 1, seed: int = 0,
                 env_config: dict | None = None, env_to_module=None,
                 module_to_env=None, device=None, num_threads: int | None = None):
        self.device = resolve_device(device)
        if num_threads is not None:
            # a runner actor's process is its own: its intra-op threads
            # match its CPU lease, where one thread a core would spin
            # against the other runners' (tiny policies, one step at a time)
            torch.set_num_threads(num_threads)
        self.envs = envs.make_vec(env_name, num_envs, env_config)
        self.num_envs = num_envs
        self.seed = seed
        self._rng_counter = 0
        self._generator = seeded(seed, self.device)
        self.module: RLModule | None = None
        self.obs, _ = self.envs.reset(seed=seed)
        self._ep_returns = np.zeros(num_envs)
        self.completed_returns: list[float] = []
        # ConnectorV2 pipelines (ref: env_to_module_connector /
        # module_to_env_connector on the reference env runner); the module
        # AND the returned rollout see connector-processed observations,
        # so the learner trains on exactly what the policy acted on
        self.env_to_module = env_to_module
        self.module_to_env = module_to_env
        self._e2m_ctx = ConnectorCtx(phase="env_to_module", num_envs=num_envs)
        self._m2e_ctx = ConnectorCtx(phase="module_to_env", num_envs=num_envs)
        self._sample_s = 0.0  # seconds in sample() since the last runner_stats()
        self._samples = 0

    def _module_obs(self, obs):
        if self.env_to_module is None:
            return np.asarray(obs)
        return self.env_to_module(obs, self._e2m_ctx)

    def _to_device(self, obs):
        return torch.as_tensor(np.asarray(obs, np.float32), device=self.device)

    def set_weights(self, weights) -> bool:
        """Copy ``weights`` (an ``RLModule`` or a JAX-layout tree) into this
        runner's own module."""
        self.module = load_weights(self.module, weights, self.device)
        return True

    def get_weights(self) -> dict:
        """The runner's policy as a host numpy tree (JAX's layout)."""
        return params_to_numpy(self.module)

    def runner_stats(self) -> dict:
        """This runner's process and device, and the seconds its
        ``sample`` calls took since the last call (then reset)."""
        stats = {"pid": os.getpid(), "device": str(self.device),
                 "sample_s": self._sample_s, "samples": self._samples}
        self._sample_s, self._samples = 0.0, 0
        return stats

    # -- connector state sync (ref: EnvRunnerGroup merging env-to-module
    # connector states each iteration, then re-broadcasting) -------------
    def get_connector_state(self) -> dict:
        if self.env_to_module is None:
            return {}
        return self.env_to_module.get_state()

    def set_connector_state(self, state: dict) -> bool:
        if self.env_to_module is not None and state:
            self.env_to_module.set_state(state)
        return True

    def sample(self, num_steps: int) -> dict:
        """Collect num_steps per env (``_sample``), timed for
        ``runner_stats``."""
        t0 = time.perf_counter()
        out = self._sample(num_steps)
        self._sample_s += time.perf_counter() - t0
        self._samples += 1
        return out

    def _sample(self, num_steps: int) -> dict:
        """Flat rollout arrays with bootstrap values for GAE (computed
        learner-side)."""
        if self.module is None:
            raise RuntimeError("set_weights before sample")
        obs_l, act_l, logp_l, val_l, rew_l, done_l = [], [], [], [], [], []
        for _ in range(num_steps):
            self._rng_counter += 1
            mobs = self._module_obs(self.obs)
            action, logp, value = sample_action(self.module, self._to_device(mobs),
                                                self._generator)
            action = action.to(torch.int32).cpu().numpy()
            # the env gets the connector-processed (e.g. clipped) action,
            # but the rollout stores the SAMPLED one — logp corresponds to
            # the sample, and a clipped action under the sampled logp
            # would bias PPO importance ratios (ref: RLlib trains on the
            # unclipped action, sends the clipped one to the env)
            env_action = action
            if self.module_to_env is not None:
                env_action = np.asarray(self.module_to_env(action, self._m2e_ctx))
            next_obs, reward, term, trunc, _ = self.envs.step(env_action)
            done = np.logical_or(term, trunc)
            obs_l.append(mobs)
            act_l.append(action)
            logp_l.append(logp)
            val_l.append(value)
            rew_l.append(np.asarray(reward, dtype=np.float32))
            done_l.append(done)
            self._ep_returns += reward
            for i, d in enumerate(done):
                if d:
                    self.completed_returns.append(float(self._ep_returns[i]))
                    self._ep_returns[i] = 0.0
            self.obs = next_obs
        # bootstrap under the SAME observation transform the policy saw
        last_mobs = self._module_obs(self.obs)
        with torch.no_grad():
            last_value = value_fn(self.module, self._to_device(last_mobs))
        # the logps and values stay on the device until one copy here
        logp, values, last_value = (t.float().cpu().numpy() for t in (
            torch.stack(logp_l), torch.stack(val_l), last_value))
        return {
            "obs": np.stack(obs_l),          # [T, N, obs_dim]
            "actions": np.stack(act_l),      # [T, N]
            "logp": logp,
            "values": values,
            "rewards": np.stack(rew_l),
            "dones": np.stack(done_l),
            "last_value": last_value,        # [N]
            # bootstrap OBS so off-policy learners (V-trace) can evaluate
            # it under the CURRENT policy rather than the behavior one
            "last_obs": np.asarray(last_mobs),
        }

    def episode_metrics(self) -> dict:
        rets = self.completed_returns
        self.completed_returns = []
        if not rets:
            return {"episodes": 0}
        return {
            "episodes": len(rets),
            "episode_return_mean": float(np.mean(rets)),
            "episode_return_max": float(np.max(rets)),
        }

    def obs_and_action_space(self) -> tuple[int, int]:
        return (
            int(np.prod(self.envs.single_observation_space.shape)),
            int(self.envs.single_action_space.n),
        )
