"""PPO algorithm: config builder + training driver.

Counterpart of ``ray_tpu/rllib/ppo.py`` (ref:
rllib/algorithms/algorithm.py:207 step :986 training_step :2004,
algorithm_config.py builder, ppo/ppo.py:362). One train() iteration:
env-runner sampling -> learner update -> weight sync, with episode metrics
aggregated across runners. JAX's runners and learners are actors of its
runtime; here they are objects in the driver's process, sampled one after
another, on the config's device (the card unless ``.resources(device=
"cpu")``). Several learners and the Tune adapter need that runtime and are
refused.
"""
from __future__ import annotations

import copy
import time

from ray_tpu_torch.rllib.connectors import ConnectorV2
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import Learner

RUNTIME_ONLY = ("needs the actor runtime of the JAX package (remote learners "
                "joined in a collective group, or Tune), which the port does not copy")


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


class PPO:
    """(ref: algorithms/algorithm.py Algorithm)."""

    def __init__(self, config: PPOConfig):
        if config.num_learners > 1:
            raise ValueError(f"num_learners={config.num_learners} {RUNTIME_ONLY}; the port "
                             "runs one learner in process (use Learner directly for a "
                             "multi-process group)")
        self.config = config
        e2m = config.env_to_module_connector
        m2e = config.module_to_env_connector
        self.runners = [
            EnvRunner(
                config.env_name, config.num_envs_per_runner,
                seed=config.seed + 1000 * i, env_config=config.env_config,
                env_to_module=build_pipe(e2m), module_to_env=build_pipe(m2e),
                device=config.device,
            )
            for i in range(config.num_env_runners)
        ]
        self._has_connectors = e2m is not None
        # merge_states needs a pipeline of the same shape; build it once
        self._connector_proto = build_pipe(e2m)
        obs_dim, n_actions = self.runners[0].obs_and_action_space()
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
        self.learners = [Learner(0, 1, learner_cfg)]
        self._iteration = 0
        self._sync_weights()

    def _sync_weights(self):
        weights = self.learners[0].get_weights()
        for r in self.runners:
            r.set_weights(weights)

    def train(self) -> dict:
        """One iteration (ref: Algorithm.step :986): sample, update, sync."""
        t0 = time.monotonic()
        frag = self.config.rollout_fragment_length
        rollouts = [r.sample(frag) for r in self.runners]
        result = self.learners[0].update(rollouts)
        self._sync_weights()
        if self._has_connectors and len(self.runners) > 1:
            self._sync_connector_states()
        ret_mean, episodes = merged_metrics([r.episode_metrics() for r in self.runners])
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": ret_mean,
            "episodes_this_iter": episodes,
            "loss": result["loss"],
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
        states = [r.get_connector_state() for r in self.runners]
        merged = self._connector_proto.merge_states([s for s in states if s])
        if merged:
            for r in self.runners:
                r.set_connector_state(merged)

    def get_weights(self):
        return self.learners[0].get_weights()

    def stop(self):
        pass

    @classmethod
    def as_trainable(cls, config: PPOConfig, stop_iters: int = 10):
        """The Tune adapter (ref: Algorithm is-a Trainable)."""
        raise NotImplementedError(f"as_trainable {RUNTIME_ONLY}")
