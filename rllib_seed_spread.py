#!/usr/bin/env python3
"""The RL drivers' learning bars over seeds, on the CPU.

    python3 rllib_seed_spread.py                 # the port, seeds 0 1 2
    python3 rllib_seed_spread.py --package jax   # the JAX package's drivers
    python3 rllib_seed_spread.py --seeds 0 3 --only ppo sac

Runs each algorithm at its learning test's settings (``tests/test_rllib.py``
and ``tests/test_torch_rllib_learn.py``) with ``config.seed`` set to each
seed, and prints one JSON line per (algorithm, seed): the first finite and
the best mean return per iteration (or the test's own readings) and
whether the test's bar was met. ``--package port`` (the default) runs
``ray_tpu_torch.rllib`` in process on the CPU; ``--package jax`` runs
``ray_tpu.rllib`` on its actor runtime (``ray_tpu.init``). The multi-agent,
BC and CQL cases run the port only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ON_POLICY = dict(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=64)


def configs(rl, device_kw):
    """name -> (config factory, iterations, bar(first, best))."""
    def at(cfg):
        return cfg.resources(**device_kw) if device_kw else cfg

    above = lambda first, best: best > max(60.0, 1.5 * first)  # noqa: E731
    return {
        "ppo": (lambda: at(rl.PPOConfig().environment("CartPole-v1").env_runners(
            num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=128)
            .training(lr=1e-3, minibatches=4, epochs=4, hidden=64)), 8, above),
        "dqn": (lambda: at(rl.DQNConfig().environment("CartPole-v1").env_runners(
            num_env_runners=1, num_envs_per_env_runner=8, rollout_fragment_length=128)
            .training(lr=2e-3, batch_size=128, train_batches_per_iter=64,
                      target_update_freq=100, epsilon_decay_iters=6, learning_starts=500,
                      prioritized=True, hidden=64)), 14, lambda first, best: best > 60.0),
        "impala": (lambda: at(rl.IMPALAConfig().environment("CartPole-v1").env_runners(
            **ON_POLICY).training(lr=1e-3, batches_per_iter=8, entropy_coeff=0.01)), 10, above),
        "appo": (lambda: at(rl.APPOConfig().environment("CartPole-v1").env_runners(
            **ON_POLICY).training(clip=0.3, lr=1e-3, batches_per_iter=8,
                                  entropy_coeff=0.01)), 10, above),
        "sac": (lambda: at(rl.SACConfig().environment("CartPole-v1").env_runners(**ON_POLICY)
                           .training(lr=2e-3, batch_size=128, learning_starts=400,
                                     train_batches_per_iter=24, tau=0.02,
                                     target_entropy=0.25, initial_alpha=0.3)), 12, above),
    }


def run_driver(make, iters, bar, seed) -> dict:
    cfg = make()
    cfg.seed = seed
    algo = cfg.build()
    returns = []
    try:
        for _ in range(iters):
            returns.append(algo.train()["episode_return_mean"])
    finally:
        algo.stop()
    finite = [r for r in returns if not np.isnan(r)]
    first, best = (finite[0], max(finite)) if finite else (None, 0.0)
    return {"first": first, "best": best, "passed": first is not None and bar(first, best),
            "returns": returns}


def multi_agent(seed) -> dict:
    """test_multi_agent_env_runner_learns_per_policy with runner seeds
    10*seed + i and init/update generators from ``seed``."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_rllib_learn import TwoAgentTag

    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import core

    runners = [rllib.MultiAgentEnvRunner(TwoAgentTag, policy_mapping_fn=lambda aid: aid,
                                         seed=10 * seed + i, device="cpu") for i in range(2)]
    spaces = runners[0].spaces()
    params = {pid: core.policy_init(core.seeded(10 * seed + i, "cpu"), *spaces[pid],
                                    hidden=32, device="cpu")
              for i, pid in enumerate(sorted(spaces))}
    update, opt = rllib.make_ppo_update(clip=0.2, vf_coeff=0.5, entropy_coeff=0.01, lr=5e-3,
                                        epochs=4, minibatches=2)
    states = {pid: opt.init(p) for pid, p in params.items()}
    first, last = {}, {}
    for it in range(12):
        for r in runners:
            r.set_weights(params)
        rollouts = [r.sample(64) for r in runners]
        for pid in params:
            batches = [rllib.compute_gae(ro[pid], 0.99, 0.95) for ro in rollouts]
            batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
            update(params[pid], states[pid], rllib.learner.to_tensors(batch, "cpu"),
                   core.seeded(100 * seed + it, "cpu"))
        metrics = [r.episode_metrics() for r in runners]
        for a in ("a", "b"):
            vals = [m[a]["episode_return_mean"] for m in metrics if a in m]
            if vals:
                first.setdefault(a, float(np.mean(vals)))
                last[a] = float(np.mean(vals))
    return {"first": first, "last": last,
            "passed": all(last[a] > max(first[a] + 2.0, 12.0) for a in ("a", "b"))}


def bc(seed) -> dict:
    """test_offline_roundtrip_and_bc_clones_expert with the expert drawn
    from 7 + seed and rollouts from ``seed``."""
    import torch

    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import core

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rollouts.jsonl")
        expert = core.policy_init(core.seeded(7 + seed, "cpu"), 4, 2, hidden=32, device="cpu")
        rllib.collect_rollouts("CartPole-v1", path, num_steps=384, num_envs=2, seed=seed,
                               policy_params=expert, hidden=32, device="cpu")
        data = rllib.OfflineData(path)
        cfg = rllib.BCConfig().offline_data(path).training(
            lr=3e-3, batch_size=128, updates_per_iter=80, hidden=32).resources(device="cpu")
        cfg.seed = seed
        algo = cfg.build()
        for _ in range(4):
            loss = algo.train()["loss"]
        obs = torch.as_tensor(data.table["obs"][:256], dtype=torch.float32)
        with torch.no_grad():
            agree = float((core.policy_logits(expert, obs).argmax(-1)
                           == core.policy_logits(algo.module, obs).argmax(-1)).float().mean())
    return {"loss": loss, "agreement": agree, "passed": loss < 0.6 and agree > 0.8}


def cql(seed) -> dict:
    """test_cql_penalty_suppresses_unlogged_actions with data from ``seed``."""
    import torch

    from ray_tpu_torch import rllib

    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(512, 4)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "d.jsonl")
        rllib.write_rollouts(path, [{
            "obs": obs, "actions": np.zeros(512, np.int64), "rewards": np.ones(512, np.float32),
            "dones": np.zeros(512, np.float32),
            "next_obs": rng.normal(size=(512, 4)).astype(np.float32)}])
        cfg = rllib.CQLConfig().offline_data(path).training(
            lr=3e-3, cql_alpha=5.0, batch_size=128, updates_per_iter=60, hidden=32,
            n_actions=2).resources(device="cpu")
        cfg.seed = seed
        algo = cfg.build()
        for _ in range(3):
            penalty = algo.train()["cql_penalty"]
    with torch.no_grad():
        q1 = algo.module["q1"](torch.as_tensor(obs[:128])).numpy()
    prefer = float((q1[:, 0] > q1[:, 1]).mean())
    return {"cql_penalty": penalty, "prefers_logged": prefer,
            "passed": penalty < 0.35 and prefer > 0.9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--only", nargs="+")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.package == "jax":
        import ray_tpu
        from ray_tpu import rllib as rl

        ray_tpu.init(num_cpus=8)
        cases = configs(rl, {})
    else:
        import torch

        from ray_tpu_torch import rllib as rl

        torch.set_num_threads(1)
        cases = configs(rl, {"device": "cpu"})
        cases.update({"multi_agent": multi_agent, "bc": bc, "cql": cql})
    for name, case in cases.items():
        if args.only and name not in args.only:
            continue
        for seed in args.seeds:
            t0 = time.perf_counter()
            out = run_driver(*case, seed) if isinstance(case, tuple) else case(seed)
            print(json.dumps({"package": args.package, "algo": name, "seed": seed, **out,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
