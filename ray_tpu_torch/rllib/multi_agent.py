"""Multi-agent environments and env runners.

Counterpart of ``ray_tpu/rllib/multi_agent.py`` (ref:
rllib/env/multi_agent_env.py MultiAgentEnv,
rllib/env/multi_agent_env_runner.py MultiAgentEnvRunner): an env steps a
DICT of per-agent actions and returns per-agent observations/rewards; the
runner maps agents onto policies (policy_mapping_fn) and returns one
PPO-format rollout per POLICY, so per-policy learners consume them with
the single-agent update. The policies live on the runner's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.core import sample_action, seeded, value_fn
from ray_tpu_torch.rllib.env_runner import load_weights
from ray_tpu_torch.utils.device import resolve_device


class MultiAgentEnv:
    """Dict-keyed env API (ref: multi_agent_env.py). Subclasses define:

    - ``agents``: list of agent ids
    - ``reset(seed) -> obs_dict``
    - ``step(action_dict) -> (obs, rewards, terminateds, truncateds, infos)``
      where each is a per-agent dict and terminateds may carry "__all__".
    - ``observation_space_shape(agent_id)``, ``n_actions(agent_id)``
    """

    agents: list = []

    def reset(self, seed=None):
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError

    def observation_space_shape(self, agent_id) -> tuple:
        raise NotImplementedError

    def n_actions(self, agent_id) -> int:
        raise NotImplementedError


class MultiAgentEnvRunner:
    """Samples a MultiAgentEnv with per-policy networks (ref:
    multi_agent_env_runner.py: sample() returns per-policy batches).

    env_maker: () -> MultiAgentEnv
    policy_mapping_fn: agent_id -> policy_id (default: shared policy)
    """

    def __init__(self, env_maker, policy_mapping_fn=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.env = env_maker()
        self.map_fn = policy_mapping_fn or (lambda aid: "default")
        self.seed = seed
        self._generator = seeded(seed, self.device)
        self._episode_counter = 0
        self.policies: dict = {}  # policy_id -> the runner's own module
        self.obs = self.env.reset(seed=seed)
        self._dead: set = set()  # agents terminated before "__all__"
        self._ep_returns = {a: 0.0 for a in self.env.agents}
        self.completed_returns: dict = {a: [] for a in self.env.agents}

    def policy_ids(self) -> list:
        return sorted({self.map_fn(a) for a in self.env.agents})

    def spaces(self) -> dict:
        """policy_id -> (obs_dim, n_actions); shared policies must have
        homogeneous spaces (checked here, loudly)."""
        out: dict = {}
        for a in self.env.agents:
            pid = self.map_fn(a)
            dims = (int(np.prod(self.env.observation_space_shape(a))),
                    int(self.env.n_actions(a)))
            if pid in out and out[pid] != dims:
                raise ValueError(
                    f"policy {pid!r} maps agents with different spaces: "
                    f"{out[pid]} vs {dims} (agent {a!r})")
            out[pid] = dims
        return out

    def set_weights(self, weights: dict) -> bool:
        """weights: policy_id -> an ``RLModule`` or a JAX-layout tree,
        copied into this runner's own modules."""
        for pid, w in weights.items():
            self.policies[pid] = load_weights(self.policies.get(pid), w, self.device)
        return True

    def sample(self, num_steps: int) -> dict:
        """Collect num_steps env steps; returns policy_id -> rollout in the
        single-agent PPO format ([T, N=#agents-of-policy, ...]).

        Per step, agents are batched BY POLICY into one sample_action call.
        Agents that terminate before "__all__" stop acting; their remaining
        rows are masked (done=True, reward 0), so GAE never bootstraps
        across a dead agent's gap."""
        agents = list(self.env.agents)
        by_policy: dict = {}
        for a in agents:
            by_policy.setdefault(self.map_fn(a), []).append(a)
        per_agent: dict = {a: {"obs": [], "actions": [], "logp": [],
                               "values": [], "rewards": [], "dones": []}
                           for a in agents}
        dead = self._dead  # persists across sample() calls mid-episode
        zero_obs = {a: np.zeros(self.env.observation_space_shape(a),
                                np.float32) for a in agents}
        for _ in range(num_steps):
            actions, logps, values = {}, {}, {}
            for pid, members in by_policy.items():
                live = [a for a in members if a not in dead]
                if not live:
                    continue
                ob = torch.as_tensor(np.stack(
                    [np.asarray(self.obs[a], np.float32) for a in live]), device=self.device)
                act, logp, val = sample_action(self.policies[pid], ob, self._generator)
                # one device-to-host copy of the three: the env steps on
                # the host, so every step's actions must reach it
                act, logp, val = torch.stack([act.float(), logp, val]).cpu().numpy()  # raylint: disable=RT017
                for j, a in enumerate(live):
                    actions[a] = int(act[j])
                    logps[a] = float(logp[j])
                    values[a] = float(val[j])
            next_obs, rewards, terms, truncs, _ = self.env.step(actions)
            done_all = terms.get("__all__", False) or truncs.get("__all__", False)
            for a in agents:
                st = per_agent[a]
                if a in dead:
                    # padding row: zero reward, done — inert under GAE
                    st["obs"].append(st["obs"][-1] if st["obs"]
                                     else zero_obs[a])
                    st["actions"].append(0)
                    st["logp"].append(0.0)
                    st["values"].append(0.0)
                    st["rewards"].append(0.0)
                    st["dones"].append(True)
                    continue
                d = bool(terms.get(a, False) or truncs.get(a, False) or done_all)
                st["obs"].append(np.asarray(self.obs[a], np.float32))
                st["actions"].append(actions[a])
                st["logp"].append(logps[a])
                st["values"].append(values[a])
                st["rewards"].append(float(rewards.get(a, 0.0)))
                st["dones"].append(d)
                self._ep_returns[a] += float(rewards.get(a, 0.0))
                if d:
                    self.completed_returns[a].append(self._ep_returns[a])
                    self._ep_returns[a] = 0.0
                if d and not done_all:
                    dead.add(a)
            if done_all:
                # deterministically seeded mid-run resets (a reset with no
                # seed would draw from the OS)
                self._episode_counter += 1
                try:
                    self.obs = self.env.reset(
                        seed=self.seed * 1_000_003 + self._episode_counter)
                except TypeError:  # env whose reset() takes no seed
                    self.obs = self.env.reset()
                dead.clear()
            else:
                # envs may omit finished agents from their obs dicts
                self.obs = {a: next_obs.get(a, zero_obs[a]) for a in agents}

        # bootstrap values for GAE from the CURRENT obs (zero for dead
        # agents — their last recorded row is done=True anyway)
        out: dict = {}
        for pid, members in by_policy.items():
            stacked = {
                k: np.stack(
                    [np.asarray(per_agent[a][k]) for a in members], axis=1)
                for k in ("obs", "actions", "logp", "values", "rewards",
                          "dones")
            }
            last_obs = torch.as_tensor(np.stack(
                [np.asarray(self.obs[a], np.float32) for a in members]), device=self.device)
            with torch.no_grad():
                last_val = value_fn(self.policies[pid], last_obs).cpu().numpy()
            alive_mask = np.array([a not in dead for a in members])
            stacked["last_value"] = np.where(alive_mask, last_val, 0.0).astype(
                np.float32)
            stacked["actions"] = stacked["actions"].astype(np.int32)
            stacked["rewards"] = stacked["rewards"].astype(np.float32)
            stacked["logp"] = stacked["logp"].astype(np.float32)
            stacked["values"] = stacked["values"].astype(np.float32)
            out[pid] = stacked
        return out

    def episode_metrics(self) -> dict:
        out = {}
        for a, rets in self.completed_returns.items():
            if rets:
                out[str(a)] = {"episodes": len(rets),
                               "episode_return_mean": float(np.mean(rets))}
            self.completed_returns[a] = []
        return out
