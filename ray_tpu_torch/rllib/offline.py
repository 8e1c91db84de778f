"""Offline RL: experience IO + Behavior Cloning + discrete CQL.

Counterpart of ``ray_tpu/rllib/offline.py`` (ref:
rllib/offline/offline_data.py + json_reader.py sample-batch JSON files;
rllib/algorithms/bc/bc.py; rllib/algorithms/cql/cql.py). Experiences are
JSONL fragments ({obs, actions, rewards, dones, next_obs} per line, the
SampleBatch shape). As in JAX, ``OfflineData`` reads the file shards as
tasks of the runtime (starting a default one unless the process is
attached to one), gathers them in order, and serves seeded minibatches.
The learners run in the driver's process, on the config's device:

  - BC:  supervised cross-entropy of the policy on logged actions.
  - CQL (discrete): SAC's twin soft critics + a conservative penalty
    ``logsumexp(Q) - Q(a_logged)`` that pushes down Q on actions the
    behavior policy never took (Kumar et al. 2020).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib import envs
from ray_tpu_torch.rllib.core import Adam, apply, policy_init, policy_logits, seeded
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import to_tensors
from ray_tpu_torch.rllib.ppo import AlgorithmConfig
from ray_tpu_torch.rllib.sac import critic_target, polyak, sac_init, soft_losses
from ray_tpu_torch.utils.device import resolve_device


# ------------------------------------------------------------------------ IO
def write_rollouts(path: str, fragments: list[dict]) -> int:
    """Append sample fragments as JSONL (ref: offline json_writer.py).
    Each fragment: dict of array-likes keyed obs/actions/rewards/dones
    (+ optionally next_obs). Returns rows written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = 0
    with open(path, "a") as f:
        for frag in fragments:
            row = {k: np.asarray(v).tolist() for k, v in frag.items()}
            f.write(json.dumps(row) + "\n")
            n += len(row.get("actions", ()))
    return n


def collect_rollouts(env_name: str, path: str, *, num_steps: int = 1000,
                     num_envs: int = 2, seed: int = 0, policy_params=None,
                     hidden: int = 64, env_config: dict | None = None,
                     device=None) -> int:
    """Roll a (random or given) policy in an env and log the experience —
    the `rllib train ... --output` role. ``policy_params``: an ``RLModule``
    or a JAX-layout tree. Returns transitions written."""
    runner = EnvRunner(env_name, num_envs=num_envs, seed=seed,
                       env_config=env_config, device=device)
    obs_dim, n_actions = runner.obs_and_action_space()
    params = policy_params if policy_params is not None else policy_init(
        seeded(seed, "cpu"), obs_dim, n_actions, hidden, runner.device)
    runner.set_weights(params)
    frags = []
    steps = 0
    while steps < num_steps:
        take = min(128, num_steps - steps)
        ro = runner.sample(take)
        T, N = ro["actions"].shape
        # flatten [T, N] to transitions; next_obs via the shifted obs rows
        next_obs = np.concatenate(
            [ro["obs"][1:], np.repeat(ro["last_obs"][None], 1, 0)], axis=0)
        frags.append({
            "obs": ro["obs"].reshape(T * N, -1),
            "actions": ro["actions"].reshape(-1),
            "rewards": ro["rewards"].reshape(-1),
            "dones": ro["dones"].reshape(-1).astype(np.float32),
            "next_obs": next_obs.reshape(T * N, -1),
        })
        steps += take
    return write_rollouts(path, frags)


def read_shard(path: str) -> dict:
    """One JSONL file as columns."""
    cols: dict[str, list] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            for k, v in row.items():
                cols.setdefault(k, []).append(np.asarray(v))
    return {k: np.concatenate(v) for k, v in cols.items()} if cols else {}


_read_shard = ray_tpu_torch.remote(read_shard)


class OfflineData:
    """Reader over one or more JSONL experience files (ref:
    offline_data.py OfflineData): file shards load as parallel tasks,
    transitions concatenate into one in-memory table served as seeded
    minibatches."""

    def __init__(self, paths: str | list[str], *, seed: int = 0):
        if isinstance(paths, str):
            paths = [paths]
        expanded: list[str] = []
        for p in paths:
            if os.path.isdir(p):
                expanded.extend(
                    os.path.join(p, f) for f in sorted(os.listdir(p))
                    if f.endswith((".json", ".jsonl")))
            else:
                expanded.append(p)
        if not expanded:
            raise ValueError(f"no offline data under {paths!r}")
        shards = ray_tpu_torch.get([_read_shard.remote(p) for p in expanded], timeout=600)
        shards = [s for s in shards if s]
        self.table = {
            k: np.concatenate([s[k] for s in shards]) for k in shards[0]
        }
        self.n = len(self.table["actions"])
        self._rng = np.random.default_rng(seed)

    def minibatch(self, size: int) -> dict:
        idx = self._rng.integers(0, self.n, size=min(size, self.n))
        return {k: v[idx] for k, v in self.table.items()}


class OfflineConfig(AlgorithmConfig):
    """An ``AlgorithmConfig`` that reads logged experience (as RLlib's
    BC and CQL configs are algorithm configs)."""

    def offline_data(self, paths):
        self.paths = paths
        return self


# ------------------------------------------------------------------------ BC
def make_bc_update(lr: float):
    """(update, optimizer): ``update(module, opt, batch)`` takes one
    cross-entropy step in place and returns the loss as a 0-dim tensor."""

    def update(module, opt, batch):
        logp = F.log_softmax(policy_logits(module, batch["obs"]), dim=-1)
        loss = -logp.gather(-1, batch["actions"][:, None])[:, 0].mean()
        apply(opt, loss)
        return loss.detach()

    return update, Adam(lr)


class BCConfig(OfflineConfig):
    """Builder config (ref: bc.py BCConfig)."""

    def __init__(self):
        self.paths: list[str] | str | None = None
        self.lr = 1e-3
        self.batch_size = 256
        self.updates_per_iter = 64
        self.hidden = 64
        self.seed = 0
        self.obs_dim: int | None = None
        self.n_actions: int | None = None
        self.device = None

    def training(self, *, lr=None, batch_size=None, updates_per_iter=None,
                 hidden=None):
        return self._set(lr=lr, batch_size=batch_size, updates_per_iter=updates_per_iter,
                         hidden=hidden)

    def build(self) -> "BC":
        if self.paths is None:
            raise ValueError("BCConfig.offline_data(...) is required")
        return BC(self)


class BC:
    """Behavior cloning learner (ref: bc.py)."""

    def __init__(self, config: BCConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.data = OfflineData(config.paths, seed=config.seed)
        obs_dim = config.obs_dim or self.data.table["obs"].shape[-1]
        n_actions = config.n_actions or int(
            self.data.table["actions"].max()) + 1
        self.module = policy_init(seeded(config.seed, "cpu"), obs_dim, n_actions,
                                  config.hidden, self.device)
        self._update, optimizer = make_bc_update(config.lr)
        self.opt = optimizer.init(self.module)
        self._iteration = 0

    def train(self) -> dict:
        t0 = time.monotonic()
        losses = []
        for _ in range(self.config.updates_per_iter):
            mb = self.data.minibatch(self.config.batch_size)
            batch = to_tensors({"obs": mb["obs"], "actions": mb["actions"]}, self.device)
            losses.append(self._update(self.module, self.opt, batch))
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "loss": float(torch.stack(losses).mean()),
            "num_transitions": self.data.n,
            "time_this_iter_s": time.monotonic() - t0,
        }

    def get_weights(self):
        return self.module

    @torch.no_grad()
    def evaluate(self, num_episodes: int = 4, env_name: str | None = None,
                 env_config: dict | None = None) -> dict:
        """Greedy rollouts of the cloned policy (ref: bc evaluation)."""
        env = envs.make(env_name, **(env_config or {}))
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=1000 + ep)
            total, done = 0.0, False
            while not done:
                obs_t = torch.as_tensor(np.asarray(obs, np.float32)[None], device=self.device)
                a = int(policy_logits(self.module, obs_t).argmax())
                obs, r, term, trunc, _ = env.step(a)
                total += float(r)
                done = term or trunc
            returns.append(total)
        return {"episode_return_mean": float(np.mean(returns)),
                "episodes": num_episodes}

    def stop(self):
        pass


# ----------------------------------------------------------------------- CQL
def make_cql_update(lr: float, gamma: float, tau: float,
                    target_entropy: float, cql_alpha: float):
    """Discrete CQL = discrete SAC + conservative penalty
    ``E[logsumexp Q - Q(a_logged)]`` on both critics (ref: cql.py /
    cql_learner). ``update(module, target, opt, batch)`` takes one step in
    place, Polyak-averages the target critics, and returns (loss, bellman,
    cql penalty) as tensors."""

    def update(module, target, opt, batch):
        q1_a, q2_a, y, pi_loss, alpha_loss, q1, q2 = soft_losses(
            module, target, batch, gamma, target_entropy)
        bellman = ((q1_a - y) ** 2).mean() + ((q2_a - y) ** 2).mean()
        # conservative term: penalize Q mass off the logged actions
        cql = ((torch.logsumexp(q1, dim=-1) - q1_a).mean()
               + (torch.logsumexp(q2, dim=-1) - q2_a).mean())
        loss = bellman + cql_alpha * cql + pi_loss + alpha_loss
        apply(opt, loss)
        polyak(target, module, tau)
        return loss.detach(), bellman.detach(), cql.detach()

    return update, Adam(lr)


class CQLConfig(OfflineConfig):
    """Builder config (ref: cql.py CQLConfig)."""

    def __init__(self):
        self.paths = None
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005
        self.cql_alpha = 1.0
        self.n_actions: int | None = None
        self.batch_size = 256
        self.updates_per_iter = 64
        self.hidden = 64
        self.seed = 0
        self.target_entropy: float | None = None
        self.device = None

    def training(self, *, lr=None, gamma=None, tau=None, cql_alpha=None,
                 batch_size=None, updates_per_iter=None, hidden=None,
                 target_entropy=None, n_actions=None):
        return self._set(lr=lr, gamma=gamma, tau=tau, cql_alpha=cql_alpha,
                         n_actions=n_actions, batch_size=batch_size,
                         updates_per_iter=updates_per_iter, hidden=hidden,
                         target_entropy=target_entropy)

    def build(self) -> "CQL":
        if self.paths is None:
            raise ValueError("CQLConfig.offline_data(...) is required")
        return CQL(self)


class CQL:
    """Offline discrete-CQL learner over logged transitions."""

    def __init__(self, config: CQLConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.data = OfflineData(config.paths, seed=config.seed)
        obs_dim = self.data.table["obs"].shape[-1]
        # a narrow behavior policy may never take the last action(s):
        # allow the action-space size to be given explicitly
        n_actions = config.n_actions or int(
            self.data.table["actions"].max()) + 1
        self.module = sac_init(seeded(config.seed, "cpu"), obs_dim, n_actions,
                               config.hidden, device=self.device)
        self.target_module = critic_target(self.module)
        tgt_ent = config.target_entropy
        if tgt_ent is None:
            tgt_ent = 0.98 * float(np.log(n_actions))
        self._update, optimizer = make_cql_update(
            config.lr, config.gamma, config.tau, tgt_ent, config.cql_alpha)
        self.opt = optimizer.init(self.module)
        self._iteration = 0

    def train(self) -> dict:
        t0 = time.monotonic()
        losses, cqls = [], []
        for _ in range(self.config.updates_per_iter):
            mb = self.data.minibatch(self.config.batch_size)
            batch = to_tensors({k: mb[k] for k in (
                "obs", "actions", "rewards", "dones", "next_obs")}, self.device)
            loss, _bellman, cql = self._update(self.module, self.target_module,
                                               self.opt, batch)
            losses.append(loss)
            cqls.append(cql)
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "loss": float(torch.stack(losses).mean()),
            "cql_penalty": float(torch.stack(cqls).mean()),
            "num_transitions": self.data.n,
            "time_this_iter_s": time.monotonic() - t0,
        }

    def get_weights(self):
        return self.module

    def stop(self):
        pass
