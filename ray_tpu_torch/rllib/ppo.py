"""PPO algorithm: config builder + training driver.

Counterpart of ``ray_tpu/rllib/ppo.py`` (ref:
rllib/algorithms/algorithm.py:207 step :986 training_step :2004,
algorithm_config.py builder, ppo/ppo.py:362). One train() iteration:
parallel env-runner sampling -> learner-group update -> weight sync, with
episode metrics aggregated across runners. As in JAX, runners and
learners are actors of the port's runtime (``build`` starts a default
runtime unless the process is attached to one): runners lease half a CPU
and no card, so they sample on the host CPU; learners lease a CPU and, on
the card (the default; ``.resources(device="cpu")`` for the CPU),
``1/num_learners`` of it, and with ``num_learners > 1`` meet in a gloo
group through the runtime's GCS KV.
"""
from __future__ import annotations

import copy
import time
import uuid

import ray_tpu_torch
from ray_tpu_torch.rllib.connectors import ConnectorV2
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.utils.device import resolve_device

class AlgorithmConfig:
    """What every algorithm's builder shares: the env, the runners, the
    device (``.resources``), and ``_set`` for the ``training`` methods."""

    def environment(self, env: str, env_config: dict | None = None):
        self.env_name = env
        self.env_config = dict(env_config or {})
        return self

    def env_runners(self, num_env_runners=None, num_envs_per_env_runner=None,
                    rollout_fragment_length=None):
        return self._set(num_env_runners=num_env_runners,
                         num_envs_per_runner=num_envs_per_env_runner,
                         rollout_fragment_length=rollout_fragment_length)

    def resources(self, device=None):
        """Where the runners' policies and the learner run (``None``: the
        card, through ``resolve_device``)."""
        self.device = device
        return self

    def _set(self, **values):
        for name, val in values.items():
            if val is not None:
                setattr(self, name, val)
        return self


class PPOConfig(AlgorithmConfig):
    """Builder-style config (ref: algorithm_config.py)."""

    def __init__(self):
        self.env_name: str | None = None
        self.env_config: dict = {}
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_fragment_length = 128
        self.num_learners = 1
        self.lr = 3e-4
        self.gamma = 0.99
        self.lam = 0.95
        self.clip = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.epochs = 4
        self.minibatches = 4
        self.hidden = 64
        self.seed = 0
        self.collective_backend = "gloo"
        self.device = None
        # ConnectorV2 hooks (ref: algorithm_config
        # env_to_module_connector / module_to_env_connector /
        # learner connector): a zero-arg factory OR a pipeline instance
        self.env_to_module_connector = None
        self.module_to_env_connector = None
        self.learner_connector = None

    def env_runners(self, num_env_runners: int | None = None,
                    num_envs_per_env_runner: int | None = None,
                    rollout_fragment_length: int | None = None,
                    env_to_module_connector=None,
                    module_to_env_connector=None) -> "PPOConfig":
        super().env_runners(num_env_runners, num_envs_per_env_runner,
                            rollout_fragment_length)
        return self._set(env_to_module_connector=env_to_module_connector,
                         module_to_env_connector=module_to_env_connector)

    def learners(self, num_learners: int | None = None) -> "PPOConfig":
        return self._set(num_learners=num_learners)

    def training(self, *, lr=None, gamma=None, lam=None, clip=None,
                 vf_coeff=None, entropy_coeff=None, epochs=None,
                 minibatches=None, hidden=None) -> "PPOConfig":
        return self._set(lr=lr, gamma=gamma, lam=lam, clip=clip, vf_coeff=vf_coeff,
                         entropy_coeff=entropy_coeff, epochs=epochs,
                         minibatches=minibatches, hidden=hidden)

    def build(self) -> "PPO":
        if self.env_name is None:
            raise ValueError("PPOConfig.environment(...) is required")
        return PPO(self)


def build_pipe(factory_or_pipe):
    """A connector pipeline from a config hook: a zero-arg factory is
    called; a pipeline INSTANCE (also callable) is copied, so each runner
    holds its own state, as each of JAX's actors gets its own pickled copy."""
    if factory_or_pipe is None:
        return None
    if isinstance(factory_or_pipe, ConnectorV2):
        return copy.deepcopy(factory_or_pipe)
    return factory_or_pipe()


def merged_metrics(metrics_list: list[dict]) -> tuple[float, int]:
    """(mean of the runners' mean returns, episodes) over the runners'
    ``episode_metrics``."""
    means = [m["episode_return_mean"] for m in metrics_list if "episode_return_mean" in m]
    return (sum(means) / len(means) if means else float("nan"),
            sum(m.get("episodes", 0) for m in metrics_list))


# ------------------------------------------- what every driver shares
def make_runners(runner_cls, config, extra=None) -> list:
    """``config.num_env_runners`` runner actors of ``runner_cls`` (JAX's
    ``num_cpus=0.5`` and no card: each samples on the host CPU, on one
    intra-op thread), runner ``i`` seeded ``config.seed + 1000 * i``;
    ``extra()`` gives each its own further keyword arguments."""
    cls = ray_tpu_torch.remote(runner_cls).options(num_cpus=0.5)
    return [cls.remote(config.env_name, config.num_envs_per_runner,
                       seed=config.seed + 1000 * i, env_config=config.env_config,
                       device="cpu", num_threads=1, **(extra() if extra else {}))
            for i in range(config.num_env_runners)]


def spaces(runners) -> tuple[int, int]:
    """(obs_dim, n_actions) of the runners' env."""
    return tuple(ray_tpu_torch.get(runners[0].obs_and_action_space.remote(), timeout=120))


def runner_metrics(runners) -> tuple[float, int]:
    """``merged_metrics`` of the runners' ``episode_metrics``."""
    return merged_metrics(ray_tpu_torch.get([r.episode_metrics.remote() for r in runners],
                                            timeout=120))


def stop_actors(actors) -> None:
    for a in actors:
        try:
            ray_tpu_torch.kill(a)
        except Exception:  # raylint: disable=RT012 — teardown: actor may already be dead
            pass


class PPO:
    """(ref: algorithms/algorithm.py Algorithm)."""

    def __init__(self, config: PPOConfig):
        # no card: raise before any actor (or a default runtime) starts
        device = resolve_device(config.device)
        self.config = config
        e2m = config.env_to_module_connector
        m2e = config.module_to_env_connector
        self.runners = make_runners(EnvRunner, config, lambda: {
            "env_to_module": build_pipe(e2m), "module_to_env": build_pipe(m2e)})
        self._has_connectors = e2m is not None
        # merge_states needs a pipeline of the same shape; build it once
        self._connector_proto = build_pipe(e2m)
        obs_dim, n_actions = spaces(self.runners)
        learner_cfg = {
            "obs_dim": obs_dim,
            "n_actions": n_actions,
            "hidden": config.hidden,
            "lr": config.lr,
            "gamma": config.gamma,
            "lam": config.lam,
            "clip": config.clip,
            "vf_coeff": config.vf_coeff,
            "entropy_coeff": config.entropy_coeff,
            "epochs": config.epochs,
            "minibatches": config.minibatches,
            "seed": config.seed,
            "collective_backend": config.collective_backend,
            "learner_connector": config.learner_connector,
            "device": config.device,
        }
        n = config.num_learners
        LearnerCls = ray_tpu_torch.remote(Learner).options(
            num_cpus=1.0, max_concurrency=2,
            num_gpus=1.0 / n if device.type == "cuda" else 0)
        group = f"rl_learners_{uuid.uuid4().hex[:12]}"  # one group per algorithm
        self.learners = [LearnerCls.remote(rank, n, learner_cfg, group) for rank in range(n)]
        self._iteration = 0
        self._sync_weights()

    def _sync_weights(self):
        """Learner 0's weights to every runner by value, as in JAX: the
        driver fetches the host tree first (the learner's returned ref,
        passed on as the runners' argument, waits in the runtime: ROADMAP
        Queue 3, 5)."""
        weights = ray_tpu_torch.get(self.learners[0].get_host_weights.remote(), timeout=300)
        ray_tpu_torch.get([r.set_weights.remote(weights) for r in self.runners], timeout=120)

    def train(self) -> dict:
        """One iteration (ref: Algorithm.step :986): sample in parallel,
        shard rollouts across learners, update, sync."""
        t0 = time.monotonic()
        frag = self.config.rollout_fragment_length
        rollouts = ray_tpu_torch.get([r.sample.remote(frag) for r in self.runners],
                                     timeout=600)
        n_learn = len(self.learners)
        # every learner participates (empty shards still join the sync)
        results = ray_tpu_torch.get(
            [ln.update.remote(rollouts[i::n_learn]) for i, ln in enumerate(self.learners)],
            timeout=600)
        results = [r for r in results if r["samples"] > 0]
        self._sync_weights()
        if self._has_connectors and len(self.runners) > 1:
            self._sync_connector_states()
        ret_mean, episodes = runner_metrics(self.runners)
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": ret_mean,
            "episodes_this_iter": episodes,
            "loss": sum(r["loss"] for r in results) / len(results),
            "num_env_steps_sampled": frag
            * self.config.num_envs_per_runner
            * self.config.num_env_runners,
            "time_this_iter_s": time.monotonic() - t0,
        }

    def _sync_connector_states(self):
        """Merge env-to-module connector states (running obs statistics)
        across runners and re-broadcast, so every runner normalizes with
        the fleet-wide statistics (ref: EnvRunnerGroup connector-state
        aggregation)."""
        states = ray_tpu_torch.get([r.get_connector_state.remote() for r in self.runners],
                                   timeout=120)
        merged = self._connector_proto.merge_states([s for s in states if s])
        if merged:
            ray_tpu_torch.get([r.set_connector_state.remote(merged) for r in self.runners],
                              timeout=120)

    def get_weights(self):
        """Learner 0's ``RLModule``, on this process's card (or the CPU)."""
        return ray_tpu_torch.get(self.learners[0].get_weights.remote(), timeout=120)

    def stop(self):
        stop_actors(self.runners + self.learners)

    @classmethod
    def as_trainable(cls, config: PPOConfig, stop_iters: int = 10):
        """The Tune adapter (ref: Algorithm is-a Trainable): each trial
        builds the algorithm from ``config`` (with the trial's ``lr``) and
        reports ``stop_iters`` train() results. The trial's actor holds no
        card: PPO's learners are actors leasing theirs."""
        return rl_trainable(config, stop_iters)


def rl_trainable(config, stop_iters: int):
    """A trainable that builds ``config`` (its ``lr`` from the trial's
    config) and reports ``stop_iters`` train() results, stopping the
    algorithm's actors at the end (JAX's ``as_trainable`` body)."""

    def trainable(tune_config: dict):
        from ray_tpu_torch import tune

        cfg = config
        if "lr" in tune_config:
            cfg = cfg.training(lr=tune_config["lr"])
        algo = cfg.build()
        try:
            for _ in range(stop_iters):
                tune.report(algo.train())
        finally:
            algo.stop()

    return trainable
