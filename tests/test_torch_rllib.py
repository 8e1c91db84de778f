"""The port's RL stack (``ray_tpu_torch.rllib``) against the JAX package's
``ray_tpu.rllib``, on the CPU, in process.

Random streams differ between the packages (``jax.random`` against a
``torch.Generator``), so parity is held on the deterministic parts: GAE,
V-trace and every update from carried weights on one seeded batch (loss and
every updated leaf within 1e-5), ``sample_action``'s math on given actions,
the numpy replay buffers, ``OfflineData`` and connectors (exact), and DQN's
runner, whose exploration is numpy in both.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import appo as jappo
from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib import core as jcore
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import env_runner as jrunner
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import learner as jlearner
from ray_tpu.rllib import offline as joffline
from ray_tpu.rllib import replay_buffer as jbuf
from ray_tpu.rllib import sac as jsac
from ray_tpu_torch import rllib
from ray_tpu_torch.rllib import (appo, connectors, core, dqn, impala, learner, offline,
                                 replay_buffer, sac)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the default of one
    thread a core spins idle threads that starve the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
OBS, ACT, HID = 4, 2, 16


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def carried(tree):
    """The port's module holding a JAX tree's values, on the CPU."""
    return core.params_from_numpy(np_tree(tree), "cpu")


def assert_leaves_close(module, jtree, tol=TOL):
    got = jax.tree_util.tree_leaves_with_path(core.params_to_numpy(module))
    want = dict(jax.tree_util.tree_leaves_with_path(np_tree(jtree)))
    assert len(got) == len(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf, want[path], rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def tensors(batch):
    return learner.to_tensors(batch, "cpu")


def jarrays(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- modules
def test_exports_match_jax():
    """Every public name of ray_tpu.rllib, plus the two weight carriers."""
    import ray_tpu.rllib as jrllib

    assert set(rllib.__all__) - set(jrllib.__all__) == {"params_from_numpy",
                                                         "params_to_numpy"}
    assert set(jrllib.__all__) <= set(rllib.__all__)
    assert all(hasattr(rllib, n) for n in rllib.__all__)


@pytest.mark.parametrize("init", ["policy", "q", "sac"])
def test_params_round_trip_and_forward_match_jax(init):
    key = jax.random.PRNGKey(3)
    jtree = {"policy": lambda: jcore.policy_init(key, OBS, ACT, HID),
             "q": lambda: jdqn.q_init(key, OBS, ACT, HID),
             "sac": lambda: jsac.sac_init(key, OBS, ACT, HID, initial_alpha=0.3)}[init]()
    module = carried(jtree)
    assert_leaves_close(module, jtree, tol=0)
    obs = np.random.default_rng(0).normal(size=(8, OBS)).astype(np.float32)
    for head in module.heads:
        assert_close(module[head](torch.as_tensor(obs)).detach(),
                     jcore.mlp_apply(jtree[head], jnp.asarray(obs)))


def test_init_is_he_normal_with_zero_biases():
    g = core.seeded(0, "cpu")
    module = core.policy_init(g, 64, 3, hidden=256, device="cpu")
    w = module["pi"].layers[0].weight.detach().numpy()
    np.testing.assert_allclose(w.std(), np.sqrt(2.0 / 64), rtol=0.05)
    assert all(float(lin.bias.detach().abs().max()) == 0.0
               for head in module.heads.values() for lin in head.layers)
    assert module["vf"].layers[-1].weight.shape == (1, 256)


def test_sample_action_math_matches_jax():
    """logp and value of given actions, and sample_action's logp and value
    of the actions it draws, equal JAX's math on the same actions."""
    jtree = jcore.policy_init(jax.random.PRNGKey(1), OBS, 3, HID)
    module = carried(jtree)
    obs = np.random.default_rng(1).normal(size=(32, OBS)).astype(np.float32)
    jlogits = jcore.policy_logits(jtree, jnp.asarray(obs))
    jlogp_all = np.asarray(jax.nn.log_softmax(jlogits))
    jvalue = np.asarray(jcore.value_fn(jtree, jnp.asarray(obs)))
    actions = np.arange(32) % 3
    logp, value = core.action_logp_value(module, torch.as_tensor(obs),
                                         torch.as_tensor(actions))
    assert_close(logp.detach(), jlogp_all[np.arange(32), actions])
    assert_close(value.detach(), jvalue)
    action, logp, value = core.sample_action(module, torch.as_tensor(obs),
                                             core.seeded(0, "cpu"))
    a = action.numpy()
    assert a.shape == (32,) and set(a) <= {0, 1, 2}
    assert_close(logp, jlogp_all[np.arange(32), a])
    assert_close(value, jvalue)


# ---------------------------------------------------------------- returns
def _rollout(T=12, N=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(T, N, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACT, size=(T, N)).astype(np.int32),
        "logp": np.log(rng.uniform(0.2, 0.8, size=(T, N))).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": rng.random((T, N)) < 0.15,
        "last_value": rng.normal(size=N).astype(np.float32),
        "last_obs": rng.normal(size=(N, OBS)).astype(np.float32),
    }


def test_compute_gae_exact():
    ro = _rollout()
    got, want = learner.compute_gae(ro, 0.99, 0.95), jlearner.compute_gae(ro, 0.99, 0.95)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (0.8, 0.5)])
def test_vtrace_returns_match_jax(rho_bar, c_bar):
    ro = _rollout(seed=1)
    target = ro["logp"] + np.random.default_rng(2).normal(0, 0.3, ro["logp"].shape).astype(
        np.float32)
    args = (ro["logp"], target, ro["rewards"], ro["values"], ro["last_value"], ro["dones"])
    vs, adv = impala.vtrace_returns(*(torch.as_tensor(a) for a in args), gamma=0.9,
                                    rho_bar=rho_bar, c_bar=c_bar)
    jvs, jadv = jimpala.vtrace_returns(*(jnp.asarray(a) for a in args), gamma=0.9,
                                       rho_bar=rho_bar, c_bar=c_bar)
    assert_close(vs, jvs, 1e-6)
    assert_close(adv, jadv, 1e-6)


# ---------------------------------------------------------------- updates
def _ppo_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACT, n).astype(np.int32),
            "logp_old": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "returns": rng.normal(size=n).astype(np.float32)}


def test_ppo_update_matches_jax():
    """minibatches=1, where the loss does not depend on the permutation;
    two epochs, so the second step sees the first's Adam state."""
    hyper = dict(clip=0.2, vf_coeff=0.5, entropy_coeff=0.01, lr=1e-3, epochs=2,
                 minibatches=1)
    jtree = jcore.policy_init(jax.random.PRNGKey(0), OBS, ACT, HID)
    module = carried(jtree)
    batch = _ppo_batch()
    jupdate, jopt = jlearner.make_ppo_update(**hyper)
    jparams, _, jloss = jupdate(jtree, jopt.init(jtree), jarrays(batch), jax.random.PRNGKey(0))
    update, opt = learner.make_ppo_update(**hyper)
    loss = update(module, opt.init(module), tensors(batch), core.seeded(0, "cpu"))
    assert_close(loss, jloss)
    assert_leaves_close(module, jparams)


def test_ppo_update_moves_toward_advantaged_actions():
    """JAX's test_ppo_update_improves_objective, on the port."""
    update, opt = learner.make_ppo_update(clip=0.2, vf_coeff=0.5, entropy_coeff=0.0,
                                          lr=1e-2, epochs=4, minibatches=2)
    module = core.policy_init(core.seeded(0, "cpu"), OBS, ACT, HID, "cpu")
    state = opt.init(module)
    n = 64
    obs = torch.as_tensor(np.random.RandomState(0).randn(n, OBS), dtype=torch.float32)
    actions = torch.arange(n) % 2
    batch = {"obs": obs, "actions": actions, "logp_old": torch.full((n,), np.log(0.5)),
             "advantages": torch.where(actions == 0, 1.0, -1.0), "returns": torch.ones(n)}
    p0 = float(torch.softmax(core.policy_logits(module, obs), -1)[:, 0].mean().detach())
    for i in range(5):
        update(module, state, batch, core.seeded(i, "cpu"))
    p1 = float(torch.softmax(core.policy_logits(module, obs), -1)[:, 0].mean().detach())
    assert p1 > p0 + 0.1, (p0, p1)


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_vtrace_updates_match_jax(algo):
    hyper = dict(lr=1e-3, gamma=0.99, vf_coeff=0.5, entropy_coeff=0.01, rho_bar=1.0,
                 c_bar=1.0)
    if algo == "impala":
        jupdate, jopt = jimpala.make_impala_update(**hyper)
        update, opt = impala.make_impala_update(**hyper)
    else:
        jupdate, jopt = jappo.make_appo_update(**hyper, clip=0.3)
        update, opt = appo.make_appo_update(**hyper, clip=0.3)
    jtree = jcore.policy_init(jax.random.PRNGKey(2), OBS, ACT, HID)
    module = carried(jtree)
    ro = _rollout(T=16, N=4, seed=3)
    batch = {k: ro[k] for k in ("obs", "actions", "logp", "rewards", "dones", "last_obs")}
    jparams, _, jloss = jupdate(jtree, jopt.init(jtree), jarrays(batch))
    loss = update(module, opt.init(module), tensors(batch))
    assert_close(loss, jloss)
    assert_leaves_close(module, jparams)


def _transitions(n=64, seed=4):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACT, n).astype(np.int32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, OBS)).astype(np.float32),
            "dones": (rng.random(n) < 0.2).astype(np.float32),
            "weights": rng.uniform(0.2, 1.0, n).astype(np.float32)}


def test_dqn_update_matches_jax():
    jtree = jdqn.q_init(jax.random.PRNGKey(0), OBS, ACT, HID)
    jtarget = jdqn.q_init(jax.random.PRNGKey(1), OBS, ACT, HID)
    module, target = carried(jtree), carried(jtarget)
    batch = _transitions()
    # rewards of magnitude > 1 reach Huber's linear part
    batch["rewards"] = batch["rewards"] * 3
    jupdate, jopt = jdqn.make_dqn_update(lr=1e-3, gamma=0.9)
    jparams, _, jloss, jtd = jupdate(jtree, jtarget, jopt.init(jtree), jarrays(batch))
    update, opt = dqn.make_dqn_update(lr=1e-3, gamma=0.9)
    loss, td = update(module, target, opt.init(module), tensors(batch))
    assert_close(loss, jloss)
    assert_close(td, jtd)
    assert float(np.abs(np.asarray(jtd)).max()) > 1.0
    assert_leaves_close(module, jparams)
    assert_leaves_close(target, jtarget, tol=0)


def test_dqn_update_moves_q_toward_targets():
    """JAX's test_dqn_update_moves_q_toward_targets, on the port."""
    module = dqn.q_init(core.seeded(0, "cpu"), 3, 2, 16, "cpu")
    target = rllib.env_runner.copy_module(module, "cpu")
    update, opt = dqn.make_dqn_update(lr=1e-2, gamma=0.0)
    state = opt.init(module)
    obs = torch.as_tensor(np.random.RandomState(0).randn(32, 3), dtype=torch.float32)
    batch = {"obs": obs, "actions": torch.zeros(32, dtype=torch.long),
             "rewards": torch.full((32,), 5.0), "next_obs": obs, "dones": torch.ones(32),
             "weights": torch.ones(32)}
    for _ in range(60):
        update(module, target, state, batch)
    q = dqn.q_values(module, obs)[:, 0].detach()
    assert float((q - 5.0).abs().mean()) < 1.0


def test_sac_update_matches_jax():
    jtree = jsac.sac_init(jax.random.PRNGKey(0), OBS, ACT, HID, initial_alpha=0.5)
    other = jsac.sac_init(jax.random.PRNGKey(1), OBS, ACT, HID)
    jtarget = {"q1": other["q1"], "q2": other["q2"]}
    module, target = carried(jtree), carried(jtarget)
    batch = _transitions(seed=5)
    del batch["weights"]
    jupdate, jopt = jsac.make_sac_update(1e-3, 0.99, 0.05, target_entropy=0.5)
    jparams, jtgt, _, jloss, jq, jalpha = jupdate(jtree, jtarget, jopt.init(jtree),
                                                  jarrays(batch))
    update, opt = sac.make_sac_update(1e-3, 0.99, 0.05, target_entropy=0.5)
    loss, q_loss, alpha = update(module, target, opt.init(module), tensors(batch))
    for got, want in ((loss, jloss), (q_loss, jq), (alpha, jalpha)):
        assert_close(got, want)
    assert_leaves_close(module, jparams)
    assert_leaves_close(target, jtgt)


def test_sac_update_moves_critics_and_temperature():
    """JAX's test_sac_update_moves_critics_and_temperature, on the port."""
    module = sac.sac_init(core.seeded(0, "cpu"), 4, 2, hidden=32, device="cpu")
    target = sac.critic_target(module)
    update, opt = sac.make_sac_update(3e-3, 0.99, 0.05, target_entropy=0.5)
    state = opt.init(module)
    batch = _transitions(seed=0)
    batch["dones"][:] = 0
    batch = tensors(batch)
    alpha0 = float(module.log_alpha.detach().exp())
    losses = []
    for _ in range(50):
        _, q_loss, alpha = update(module, target, state, batch)
        losses.append(float(q_loss))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert float(alpha) != alpha0


def test_bc_update_matches_jax():
    jtree = jcore.policy_init(jax.random.PRNGKey(4), OBS, ACT, HID)
    module = carried(jtree)
    batch = {k: v for k, v in _transitions(seed=6).items() if k in ("obs", "actions")}
    jupdate, jopt = joffline.make_bc_update(1e-3)
    jparams, _, jloss = jupdate(jtree, jopt.init(jtree), jarrays(batch))
    update, opt = offline.make_bc_update(1e-3)
    loss = update(module, opt.init(module), tensors(batch))
    assert_close(loss, jloss)
    assert_leaves_close(module, jparams)


def test_cql_update_matches_jax():
    jtree = jsac.sac_init(jax.random.PRNGKey(5), OBS, ACT, HID)
    jtarget = {"q1": jtree["q1"], "q2": jtree["q2"]}
    module, target = carried(jtree), carried(jtarget)
    batch = _transitions(seed=7)
    del batch["weights"]
    args = (1e-3, 0.99, 0.01, 0.6, 2.0)
    jupdate, jopt = joffline.make_cql_update(*args)
    jparams, jtgt, _, jloss, jbell, jcql = jupdate(jtree, jtarget, jopt.init(jtree),
                                                   jarrays(batch))
    update, opt = offline.make_cql_update(*args)
    loss, bellman, cql = update(module, target, opt.init(module), tensors(batch))
    for got, want in ((loss, jloss), (bellman, jbell), (cql, jcql)):
        assert_close(got, want)
    assert_leaves_close(module, jparams)
    assert_leaves_close(target, jtgt)


def test_adam_state_exists_before_the_first_step():
    """optax's init gives zero moments and a zero count; so does Adam.init,
    so a learner that never steps can still average its moments."""
    module = core.policy_init(core.seeded(0, "cpu"), OBS, ACT, HID, "cpu")
    opt = core.Adam(1e-3).init(module)
    for p in module.parameters():
        st = opt.state[p]
        assert float(st["step"]) == 0.0 and st["step"].dtype == torch.float32
        assert st["exp_avg"].shape == p.shape and float(st["exp_avg_sq"].abs().sum()) == 0.0


# ------------------------------------------------------- buffers and data
@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffers_sample_jax_indices(prioritized):
    make = ((lambda m: m.PrioritizedReplayBuffer(16, alpha=0.7, beta=0.5, seed=3))
            if prioritized else (lambda m: m.ReplayBuffer(16, seed=3)))
    ours, theirs = make(replay_buffer), make(jbuf)
    rng = np.random.default_rng(0)
    for step in range(5):
        batch = {"obs": rng.normal(size=(6, 3)).astype(np.float32),
                 "actions": rng.integers(0, 2, 6).astype(np.int32)}
        ours.add_batch(batch)
        theirs.add_batch(batch)
        a, b = ours.sample(9), theirs.sample(9)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        prios = rng.uniform(0.1, 3.0, 9)
        ours.update_priorities(a["indices"], prios)
        theirs.update_priorities(b["indices"], prios)
    assert len(ours) == len(theirs) == 16


def test_offline_data_matches_jax(tmp_path, monkeypatch):
    """Shards read in process give JAX's table, and minibatches draw JAX's
    rows from the same seed (JAX's shard tasks run inline here)."""
    rng = np.random.default_rng(0)
    for i in range(3):
        offline.write_rollouts(str(tmp_path / f"part{i}.jsonl"), [{
            "obs": rng.normal(size=(10 + i, OBS)), "actions": rng.integers(0, 2, 10 + i),
            "rewards": rng.normal(size=10 + i), "dones": np.zeros(10 + i),
            "next_obs": rng.normal(size=(10 + i, OBS))}])
    monkeypatch.setattr(joffline, "_read_shard",
                        types.SimpleNamespace(remote=joffline._read_shard.__wrapped__))
    monkeypatch.setattr(joffline.ray_tpu, "get", lambda refs, timeout=None: refs)
    ours, theirs = offline.OfflineData(str(tmp_path), seed=4), joffline.OfflineData(
        str(tmp_path), seed=4)
    assert ours.n == theirs.n == 33
    for k in theirs.table:
        np.testing.assert_array_equal(ours.table[k], theirs.table[k])
    for _ in range(3):
        a, b = ours.minibatch(16), theirs.minibatch(16)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- connectors
def test_connector_pipeline_matches_jax():
    """The surgery of JAX's test_connector_pipeline_surgery on both
    packages' pipelines, then the defaults, exact."""
    def build(m):
        pipe = m.ConnectorPipelineV2(m.FlattenObservations(), m.CastObservations())
        pipe.insert_after("FlattenObservations",
                          m.LambdaConnector(lambda b, ctx: b * 2, name="Double"))
        pipe.insert_before("Double", m.LambdaConnector(lambda b, ctx: b + 1, name="Inc"))
        pipe.append(m.LambdaConnector(lambda b, ctx: b, name="Tail"))
        pipe.prepend(m.ClipActions(-1.5, 1.5))
        return pipe

    ours, theirs = build(connectors), build(jconn)
    assert [c.name for c in ours] == [c.name for c in theirs] == [
        "ClipActions", "FlattenObservations", "Inc", "Double", "CastObservations", "Tail"]
    x = np.random.default_rng(0).normal(size=(3, 2, 4))
    got, want = ours(x, connectors.ConnectorCtx()), theirs(x, jconn.ConnectorCtx())
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    ours.remove("Double")
    theirs.remove("Double")
    np.testing.assert_array_equal(ours(x, connectors.ConnectorCtx()),
                                  theirs(x, jconn.ConnectorCtx()))
    with pytest.raises(ValueError):
        ours.remove("Double")
    batch = {"advantages": np.random.default_rng(1).normal(3, 2, 50).astype(np.float32)}
    for name in ("default_env_to_module", "default_module_to_env", "default_learner_pipeline"):
        got, want = getattr(connectors, name)(), getattr(jconn, name)()
        assert [c.name for c in got] == [c.name for c in want]
    np.testing.assert_array_equal(
        connectors.default_learner_pipeline()(batch, connectors.ConnectorCtx())["advantages"],
        jconn.default_learner_pipeline()(batch, jconn.ConnectorCtx())["advantages"])


def test_normalize_observations_merge_matches_jax():
    """Two runners' states, their merge, the broadcast and a second round,
    in both packages, exact."""
    rng = np.random.RandomState(0)
    data = [rng.normal(3.0, 2.0, size=(40, 4)), rng.normal(-1.0, 0.5, size=(24, 4)),
            rng.normal(0.0, 1.0, size=(8, 4))]

    def run(m):
        ctx = m.ConnectorCtx()
        a, b = m.NormalizeObservations(), m.NormalizeObservations()
        a(data[0], ctx)
        b(data[1], ctx)
        merged = m.NormalizeObservations.merge_states([a.get_state(), b.get_state()])
        a.set_state(merged)
        b.set_state(merged)
        out = a(data[2], ctx)
        again = m.NormalizeObservations.merge_states([a.get_state(), b.get_state()])
        return merged, out, again

    for got, want in zip(run(connectors), run(jconn)):
        if isinstance(want, dict):
            assert want["base"]["count"] == got["base"]["count"]
            for k in ("mean", "m2"):
                np.testing.assert_array_equal(got["base"][k], want["base"][k])
        else:
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- runners
def test_dqn_runner_gives_jax_transitions():
    """With carried weights and the same seed, DQN's runner gives JAX's
    transitions for two fragments (exploration is numpy in both; the
    greedy actions are the carried net's)."""
    jtree = jdqn.q_init(jax.random.PRNGKey(0), OBS, ACT, HID)
    ours = dqn.DQNEnvRunner("CartPole-v1", 3, seed=5, device="cpu")
    theirs = jdqn.DQNEnvRunner("CartPole-v1", 3, seed=5)
    ours.set_weights(np_tree(jtree))
    theirs.set_weights(jtree)
    for eps in (0.5, 0.2):
        ours.set_epsilon(eps)
        theirs.set_epsilon(eps)
        got, want = ours.sample(40), theirs.sample(40)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ours.episode_metrics() == theirs.episode_metrics()


def test_runner_policy_is_a_copy_until_weights_are_sent():
    """A learner's in-place Adam step must not reach a runner before
    set_weights: the runner's policy is its own copy."""
    cfg = {"obs_dim": OBS, "n_actions": ACT, "hidden": HID, "device": "cpu",
           "minibatches": 1, "epochs": 1, "lr": 1e-2}
    ln = learner.Learner(0, 1, cfg)
    runner = rllib.EnvRunner("CartPole-v1", 2, seed=0, device="cpu")
    runner.set_weights(ln.get_weights())
    before = core.params_to_numpy(runner.module)
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(runner.module.parameters(), ln.module.parameters()))
    ln.update([runner.sample(16)])
    after = core.params_to_numpy(runner.module)
    jax.tree.map(np.testing.assert_array_equal, after, before)
    moved = core.params_to_numpy(ln.module)
    assert not np.array_equal(moved["pi"][0]["w"], before["pi"][0]["w"])
    runner.set_weights(ln.get_weights())
    jax.tree.map(np.testing.assert_array_equal, core.params_to_numpy(runner.module), moved)


def test_env_runner_rollout_layout_and_connectors():
    """JAX's test_env_runner_with_connectors on the port, and the rollout's
    keys, shapes and dtypes equal JAX's runner's."""
    jtree = jcore.policy_init(jax.random.PRNGKey(0), OBS, ACT, HID)
    theirs = jrunner.EnvRunner("CartPole-v1", num_envs=2, seed=3)
    theirs.set_weights(jtree)
    want = theirs.sample(6)
    runner = rllib.EnvRunner("CartPole-v1", num_envs=2, seed=3, device="cpu",
                             env_to_module=connectors.ConnectorPipelineV2(
                                 connectors.NormalizeObservations()))
    runner.set_weights(np_tree(jtree))
    got = runner.sample(20)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape[1:] == want[k].shape[1:], k
    assert got["obs"].shape == (20, 2, OBS)
    assert np.isfinite(got["obs"]).all() and np.abs(got["obs"]).max() <= 10.0
    state = runner.get_connector_state()
    assert state and "0:NormalizeObservations" in state
    assert runner.set_connector_state(state)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA every rllib entry point raises; none carries on on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    builds = [
        lambda: rllib.PPOConfig().environment("CartPole-v1").build(),
        lambda: rllib.DQNConfig().environment("CartPole-v1").build(),
        lambda: rllib.IMPALAConfig().environment("CartPole-v1").build(),
        lambda: rllib.APPOConfig().environment("CartPole-v1").build(),
        lambda: rllib.SACConfig().environment("CartPole-v1").build(),
        lambda: rllib.EnvRunner("CartPole-v1"),
        lambda: rllib.Learner(0, 1, {"obs_dim": 4, "n_actions": 2}),
        lambda: rllib.MultiAgentEnvRunner(lambda: None),
        lambda: core.policy_init(core.seeded(0, "cpu"), 4, 2),
        lambda: core.params_from_numpy(np_tree(jcore.policy_init(jax.random.PRNGKey(0), 4, 2))),
        lambda: rllib.collect_rollouts("CartPole-v1", "unused.jsonl"),
    ]
    for build in builds:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_runtime_only_paths_refuse():
    cfg = rllib.PPOConfig().environment("CartPole-v1").learners(num_learners=2)
    with pytest.raises(ValueError, match="actor runtime"):
        cfg.resources(device="cpu").build()
    for algo in (rllib.PPO, rllib.DQN):
        with pytest.raises(NotImplementedError, match="actor runtime"):
            algo.as_trainable(cfg)
