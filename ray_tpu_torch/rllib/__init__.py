"""ray_tpu_torch.rllib — reinforcement learning on PyTorch, in process.

Counterpart of ``ray_tpu/rllib`` (RLlib's new API stack, ref: rllib/),
with the same modules and public names:
- core: policy, value and Q networks as ``nn.Module``s (rl_module.py role),
  and ``params_from_numpy``/``params_to_numpy`` for JAX's weight trees
- envs: the port's own CartPole-v1 and synchronous vector env
- env_runner: vector-env sampling (single_agent_env_runner.py:68)
- learner: PPO updates + learner group member (learner_group.py:100)
- ppo: PPOConfig builder + Algorithm driver (algorithms/ppo/ppo.py:362)
- dqn: off-policy double-DQN over replay buffers (algorithms/dqn/)
- impala: V-trace correction of stale runner policies (algorithms/impala/)
- sac: discrete twin-critic soft actor-critic with autotuned temperature
  (algorithms/sac/)
- replay_buffer: uniform + prioritized rings (utils/replay_buffers/)
- multi_agent: MultiAgentEnv + MultiAgentEnvRunner (env/multi_agent_*)
- appo: IMPALA sampling + clipped surrogate (algorithms/appo/)
- offline: experience JSONL IO + BC + discrete CQL (rllib/offline/,
  algorithms/bc/, algorithms/cql/)
- connectors: ConnectorV2 pipelines between env, module, and learner

Runners and learners are objects in the driver's process (JAX's are actors
of its runtime), and run their networks on the card unless a config's
``.resources(device="cpu")`` says otherwise:

    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2)
            .build())
    for _ in range(10):
        print(algo.train()["episode_return_mean"])
"""
from ray_tpu_torch.rllib.appo import APPO, APPOConfig, make_appo_update
from ray_tpu_torch.rllib.connectors import (CastObservations, ClipActions,
                                            ConnectorCtx, ConnectorPipelineV2,
                                            ConnectorV2, FlattenObservations,
                                            LambdaConnector, NormalizeAdvantages,
                                            NormalizeObservations,
                                            default_env_to_module,
                                            default_learner_pipeline,
                                            default_module_to_env)
from ray_tpu_torch.rllib.core import (params_from_numpy, params_to_numpy, policy_init,
                                      policy_logits, sample_action, value_fn)
from ray_tpu_torch.rllib.dqn import (DQN, DQNConfig, DQNEnvRunner, make_dqn_update, q_init,
                                     q_values)
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, make_impala_update, vtrace_returns
from ray_tpu_torch.rllib.learner import Learner, compute_gae, make_ppo_update
from ray_tpu_torch.rllib.multi_agent import MultiAgentEnv, MultiAgentEnvRunner
from ray_tpu_torch.rllib.offline import (BC, CQL, BCConfig, CQLConfig, OfflineData,
                                         collect_rollouts, write_rollouts)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACEnvRunner, make_sac_update, sac_init

__all__ = [
    "APPO",
    "APPOConfig",
    "CastObservations",
    "ClipActions",
    "ConnectorCtx",
    "ConnectorPipelineV2",
    "ConnectorV2",
    "FlattenObservations",
    "LambdaConnector",
    "NormalizeAdvantages",
    "NormalizeObservations",
    "default_env_to_module",
    "default_learner_pipeline",
    "default_module_to_env",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "OfflineData",
    "collect_rollouts",
    "write_rollouts",
    "DQN",
    "DQNConfig",
    "DQNEnvRunner",
    "EnvRunner",
    "IMPALA",
    "IMPALAConfig",
    "Learner",
    "MultiAgentEnv",
    "MultiAgentEnvRunner",
    "PPO",
    "PPOConfig",
    "PrioritizedReplayBuffer",
    "SAC",
    "SACConfig",
    "SACEnvRunner",
    "ReplayBuffer",
    "compute_gae",
    "make_dqn_update",
    "make_impala_update",
    "make_ppo_update",
    "make_sac_update",
    "sac_init",
    "vtrace_returns",
    "params_from_numpy",
    "params_to_numpy",
    "policy_init",
    "policy_logits",
    "q_init",
    "q_values",
    "sample_action",
    "value_fn",
]
