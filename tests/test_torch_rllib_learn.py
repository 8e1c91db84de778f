"""The port's in-process RL drivers learn, on the CPU, at the JAX tests'
settings, seeds and bars (``tests/test_rllib.py``): PPO, DQN, IMPALA,
APPO and SAC on the port's CartPole-v1, the two-agent runner, BC and CQL.
The random streams are the port's own (``torch.Generator``), so the
trajectories differ from JAX's; the bars are the same.
"""
import numpy as np
import pytest
import torch

from ray_tpu_torch import rllib
from ray_tpu_torch.rllib import core


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the default of one
    thread a core spins idle threads that starve the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def curve(algo, iters: int) -> tuple[float, float]:
    """(first finite mean return, best) over ``iters`` train() calls."""
    first, best = None, 0.0
    for _ in range(iters):
        ret = algo.train()["episode_return_mean"]
        if not np.isnan(ret):
            first = ret if first is None else first
            best = max(best, ret)
    assert first is not None
    return first, best


def test_ppo_learns_cartpole():
    algo = (rllib.PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=128)
            .training(lr=1e-3, minibatches=4, epochs=4, hidden=64)
            .resources(device="cpu").build())
    first, best = curve(algo, 8)
    assert best > max(60.0, first * 1.5), (first, best)
    assert all(p.device.type == "cpu" for p in algo.get_weights().parameters())


def test_dqn_learns_cartpole():
    algo = (rllib.DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                         rollout_fragment_length=128)
            .training(lr=2e-3, batch_size=128, train_batches_per_iter=64,
                      target_update_freq=100, epsilon_decay_iters=6,
                      learning_starts=500, prioritized=True, hidden=64)
            .resources(device="cpu").build())
    _, best = curve(algo, 14)
    assert best > 60.0, f"DQN failed to beat random: best={best}"
    # the target net is a copy, synced every 100 updates, not the online net
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(algo.module.parameters(), algo.target_module.parameters()))


@pytest.mark.parametrize("config", [
    lambda: rllib.IMPALAConfig().training(lr=1e-3, batches_per_iter=8, entropy_coeff=0.01),
    lambda: rllib.APPOConfig().training(clip=0.3, lr=1e-3, batches_per_iter=8,
                                        entropy_coeff=0.01)], ids=["impala", "appo"])
def test_vtrace_algorithms_learn_cartpole(config):
    algo = (config().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .resources(device="cpu").build())
    first, best = curve(algo, 10)
    assert best > max(60.0, first * 1.5), (first, best)
    assert algo.train()["batches_consumed"] == 11 * 8


def test_impala_runners_keep_stale_weights_between_broadcasts():
    """With broadcast_interval=3 a runner acts on the weights of the last
    broadcast while the learner steps."""
    algo = (rllib.IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=8)
            .training(batches_per_iter=2, broadcast_interval=3, hidden=16)
            .resources(device="cpu").build())
    def runner_w():
        return core.params_to_numpy(algo.runners[1].module)["pi"][0]["w"]

    start = runner_w()
    algo.train()  # updates 1-2: no broadcast
    np.testing.assert_array_equal(runner_w(), start)
    algo.train()  # update 3 broadcasts, update 4 steps past it
    assert not np.array_equal(runner_w(), start)
    assert not np.array_equal(runner_w(), core.params_to_numpy(algo.module)["pi"][0]["w"])


def test_sac_learns_cartpole():
    algo = (rllib.SACConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(lr=2e-3, batch_size=128, learning_starts=400,
                      train_batches_per_iter=24, tau=0.02,
                      target_entropy=0.25, initial_alpha=0.3)
            .resources(device="cpu").build())
    first, best = curve(algo, 12)
    assert best > max(60.0, first * 1.5), (first, best)


def test_ppo_with_connector_pipeline():
    """PPO with a stateful env-to-module pipeline and state sync across 2
    runners: every runner ends on the merged base state."""
    algo = (rllib.PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=32,
                         env_to_module_connector=rllib.ConnectorPipelineV2(
                             rllib.NormalizeObservations()))
            .training(epochs=1, minibatches=2, hidden=16)
            .resources(device="cpu").build())
    assert algo.runners[0].env_to_module is not algo.runners[1].env_to_module
    algo.train()
    r2 = algo.train()
    assert r2["training_iteration"] == 2 and np.isfinite(r2["loss"])
    states = [r.get_connector_state() for r in algo.runners]
    assert all("base" in s["0:NormalizeObservations"] for s in states)
    assert states[0]["0:NormalizeObservations"]["base"]["count"] == 2 * 2 * 2 * 33


class TwoAgentTag(rllib.MultiAgentEnv):
    """JAX's test env: each agent sees [own_state, other_state] and is
    rewarded for matching (agent a) / mismatching (agent b)."""

    agents = ["a", "b"]

    def __init__(self):
        self._state = None
        self._t = 0

    def reset(self, seed=None):
        rng = np.random.default_rng(seed)
        self._state = rng.integers(0, 2, size=2).astype(np.float32)
        self._t = 0
        return self._obs()

    def _obs(self):
        s = self._state
        return {"a": np.array([s[0], s[1]], np.float32),
                "b": np.array([s[1], s[0]], np.float32)}

    def step(self, action_dict):
        self._t += 1
        a, b = action_dict["a"], action_dict["b"]
        rew = {"a": 1.0 if a == int(self._state[1]) else 0.0,
               "b": 1.0 if b != int(self._state[0]) else 0.0}
        self._state = np.array([a, b], np.float32)
        terms = {"a": False, "b": False, "__all__": self._t >= 16}
        return self._obs(), rew, terms, {"__all__": False}, {}

    def observation_space_shape(self, agent_id):
        return (2,)

    def n_actions(self, agent_id):
        return 2


def test_multi_agent_env_runner_learns_per_policy():
    """Two runners, one policy per agent, per-policy PPO updates: both
    agents' returns improve (their optimal policies differ)."""
    runners = [rllib.MultiAgentEnvRunner(TwoAgentTag, policy_mapping_fn=lambda aid: aid,
                                         seed=i, device="cpu") for i in range(2)]
    spaces = runners[0].spaces()
    assert set(spaces) == {"a", "b"}
    params = {pid: core.policy_init(core.seeded(i, "cpu"), *spaces[pid], hidden=32,
                                    device="cpu")
              for i, pid in enumerate(sorted(spaces))}
    update, opt = rllib.make_ppo_update(clip=0.2, vf_coeff=0.5, entropy_coeff=0.01,
                                        lr=5e-3, epochs=4, minibatches=2)
    opt_states = {pid: opt.init(p) for pid, p in params.items()}
    first, last = {}, {}
    for it in range(12):
        for r in runners:
            r.set_weights(params)
        rollouts = [r.sample(64) for r in runners]
        for pid in params:
            batches = [rllib.compute_gae(ro[pid], 0.99, 0.95) for ro in rollouts]
            batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
            update(params[pid], opt_states[pid], rllib.learner.to_tensors(batch, "cpu"),
                   core.seeded(it, "cpu"))
        metrics = [r.episode_metrics() for r in runners]
        for agent in ("a", "b"):
            vals = [m[agent]["episode_return_mean"] for m in metrics if agent in m]
            if vals:
                first.setdefault(agent, float(np.mean(vals)))
                last[agent] = float(np.mean(vals))
    for agent in ("a", "b"):
        assert last[agent] > max(first[agent] + 2.0, 12.0), (agent, first[agent], last[agent])


def test_offline_roundtrip_and_bc_clones_expert(tmp_path):
    path = str(tmp_path / "exp" / "rollouts.jsonl")
    expert = core.policy_init(core.seeded(7, "cpu"), 4, 2, hidden=32, device="cpu")
    n = rllib.collect_rollouts("CartPole-v1", path, num_steps=384, num_envs=2, seed=0,
                               policy_params=expert, hidden=32, device="cpu")
    assert n >= 384
    data = rllib.OfflineData(path)
    assert data.n == n and set(data.table) >= {"obs", "actions", "rewards", "dones",
                                               "next_obs"}
    algo = (rllib.BCConfig().offline_data(path)
            .training(lr=3e-3, batch_size=128, updates_per_iter=80, hidden=32)
            .resources(device="cpu").build())
    for _ in range(4):
        result = algo.train()
    assert result["loss"] < 0.6, result
    obs = torch.as_tensor(data.table["obs"][:256], dtype=torch.float32)
    with torch.no_grad():
        expert_a = core.policy_logits(expert, obs).argmax(-1)
        clone_a = core.policy_logits(algo.get_weights(), obs).argmax(-1)
    agree = float((expert_a == clone_a).float().mean())
    assert agree > 0.8, f"BC clone agrees only {agree:.0%}"
    ev = algo.evaluate(num_episodes=2, env_name="CartPole-v1")
    assert ev["episodes"] == 2 and ev["episode_return_mean"] >= 8.0


def test_cql_penalty_suppresses_unlogged_actions(tmp_path):
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(512, 4)).astype(np.float32)
    rllib.write_rollouts(str(tmp_path / "d.jsonl"), [{
        "obs": obs, "actions": np.zeros(512, np.int64),
        "rewards": np.ones(512, np.float32), "dones": np.zeros(512, np.float32),
        "next_obs": rng.normal(size=(512, 4)).astype(np.float32)}])
    algo = (rllib.CQLConfig().offline_data(str(tmp_path / "d.jsonl"))
            .training(lr=3e-3, cql_alpha=5.0, batch_size=128, updates_per_iter=60,
                      hidden=32, n_actions=2)
            .resources(device="cpu").build())
    for _ in range(3):
        result = algo.train()
    assert result["cql_penalty"] < 0.35, result
    with torch.no_grad():
        q1 = algo.get_weights()["q1"](torch.as_tensor(obs[:128])).numpy()
    assert float((q1[:, 0] > q1[:, 1]).mean()) > 0.9
