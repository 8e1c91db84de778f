"""The port's training path against the JAX package's, on the CPU in float32.

Weights are the JAX init carried across with ``params_from_numpy``; tokens
come from a numpy seed. Gradients of ``llama_loss`` atol 1e-5 per leaf (two
float32 layers, sums in another order); the flash path runs the JAX Pallas
kernels in interpret mode and the port's custom ops with their plain
versions. One AdamW step against one optax step, and three
``make_train_step`` steps against JAX's: losses within 1e-5, parameters
within 1e-4."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 13.2 s, no module set-up (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=120)


HYPER = dict(learning_rate=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=1e-2)


@pytest.fixture(scope="module")
def jparams():
    return jllama.llama_init(jax.random.PRNGKey(0), jllama.LlamaConfig.tiny())


def _tparams(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    return tllama.params_from_numpy(tree, tllama.LlamaConfig.tiny(), device="cpu")


def _tokens(seed, B=2, T=33):
    return np.random.default_rng(seed).integers(0, 256, size=(B, T)).astype(np.int32)


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_grads_match_jax_grad(jparams, impl, remat):
    jcfg = jllama.LlamaConfig.tiny(remat=remat)
    tcfg = tllama.LlamaConfig.tiny(remat=remat)
    toks = _tokens(0)
    want = jax.jit(jax.grad(jllama.llama_loss), static_argnames=("cfg", "attn_impl"))(
        jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, attn_impl=impl)
    params = _tparams(jparams)
    leaves = list(tllama._leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss = tllama.llama_loss(params, {"tokens": torch.tensor(toks)}, tcfg, attn_impl=impl)
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(leaves)
    for path, g in flat:
        got = _leaf(params, path).grad
        np.testing.assert_allclose(got.numpy(), np.asarray(g), atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_runs_flash_forward_once_per_layer(jparams, monkeypatch):
    calls = []
    plain = fa.flash_attention_plain

    def counting(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    # the custom op's CPU implementation calls the module's plain version
    monkeypatch.setattr(fa, "flash_attention_plain", counting)
    cfg = tllama.LlamaConfig.tiny(remat=True)
    params = _tparams(jparams)
    leaves = list(tllama._leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss = tllama.llama_loss(params, {"tokens": torch.tensor(_tokens(1))}, cfg,
                             attn_impl="flash")
    loss.backward()
    assert len(calls) == cfg.n_layers
    assert all(t.grad is not None for t in leaves)


def test_policy_without_the_flash_op_runs_the_forward_twice(jparams, monkeypatch):
    # what saving the flash op buys: dropped from the policy, the recompute
    # in the backward pass runs the O(T^2) forward a second time per layer
    remat = importlib.import_module("ray_tpu_torch.ops.remat")
    calls = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    monkeypatch.setattr(remat, "FLASH_FWD_OP", None)
    cfg = tllama.LlamaConfig.tiny(remat=True)
    params = _tparams(jparams)
    for t in tllama._leaves(params):
        t.requires_grad_(True)
    tllama.llama_loss(params, {"tokens": torch.tensor(_tokens(1))}, cfg,
                      attn_impl="flash").backward()
    assert len(calls) == 2 * cfg.n_layers


def test_adamw_step_matches_optax():
    rng = np.random.default_rng(2)
    p0, g = rng.standard_normal((2, 5, 7)).astype(np.float32)
    opt = optax.adamw(**HYPER)
    jp = {"w": jnp.asarray(p0)}
    updates, _ = opt.update({"w": jnp.asarray(g)}, opt.init(jp), jp)
    want = optax.apply_updates(jp, updates)["w"]
    tp = {"w": torch.tensor(p0)}
    tadam = tllama.AdamW(**HYPER)
    state = tadam.init(tp)
    tp["w"].grad = torch.tensor(g)
    tadam.update(state)
    np.testing.assert_allclose(tp["w"].detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert tp["w"].grad is None


def test_make_train_step_follows_jax(jparams):
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig.tiny()
    batch = _tokens(3)
    jopt = optax.adamw(**HYPER)
    jstep = jllama.make_train_step(jcfg, jopt, donate=False)
    jp, jstate = jparams, jopt.init(jparams)
    topt = tllama.AdamW(**HYPER)
    tp = _tparams(jparams)
    tstate = topt.init(tp)
    tstep = tllama.make_train_step(tcfg, topt)
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, {"tokens": jnp.asarray(batch)})
        tp2, tstate, tloss = tstep(tp, tstate, {"tokens": torch.tensor(batch)})
        assert tp2 is tp  # updated in place
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5, rtol=0)
    for path, w in jax.tree_util.tree_flatten_with_path(jp)[0]:
        np.testing.assert_allclose(_leaf(tp, path).detach().numpy(), np.asarray(w),
                                   atol=1e-4, rtol=0, err_msg=jax.tree_util.keystr(path))


def test_make_train_step_mesh_and_moe_raise():
    """make_train_step takes MoE configs: three steps follow JAX's (the aux
    loss and the float32 promotion included). And a mesh over the axes
    that used to raise now runs: a pp axis in llama_forward is replicated
    compute, as under JAX's jit (logits equal JAX's, and a step on that mesh
    follows the unsharded one); tp needs heads and d_ff that split, and
    names the config when they do not."""
    import types

    from ray_tpu_torch.parallel.mesh import AXIS_ORDER

    jcfg = jllama.LlamaConfig.tiny(n_experts=4)
    tcfg = tllama.LlamaConfig.tiny(n_experts=4)
    jparams = jllama.llama_init(jax.random.PRNGKey(1), jcfg)
    batch = _tokens(5)
    jopt = optax.adamw(**HYPER)
    jstep = jllama.make_train_step(jcfg, jopt, donate=False)
    jp, jstate = jparams, jopt.init(jparams)
    topt = tllama.AdamW(**HYPER)
    tp = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tstate = topt.init(tp)
    tstep = tllama.make_train_step(tcfg, topt)
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, {"tokens": jnp.asarray(batch)})
        tp, tstate, tloss = tstep(tp, tstate, {"tokens": torch.tensor(batch)})
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5, rtol=0)
    for path, w in jax.tree_util.tree_flatten_with_path(jp)[0]:
        np.testing.assert_allclose(_leaf(tp, path).detach().numpy(), np.asarray(w),
                                   atol=1e-4, rtol=0, err_msg=jax.tree_util.keystr(path))

    # a pp axis of 2 (one process: pp issues no collective in llama_forward)
    pp2 = types.SimpleNamespace(mesh_dim_names=AXIS_ORDER, shape=(1, 1, 2, 1, 1, 1))
    want, want_aux = jllama.llama_forward(jparams, jnp.asarray(batch[:, :-1]), jcfg)
    fresh = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    with torch.no_grad():
        got, aux = tllama.llama_forward(fresh, torch.tensor(batch[:, :-1]), tcfg, mesh=pp2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)
    ref = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    ropt = tllama.AdamW(**HYPER)
    _, _, ref_loss = tllama.make_train_step(tcfg, ropt)(ref, ropt.init(ref),
                                                        {"tokens": torch.tensor(batch)})
    popt = tllama.AdamW(**HYPER)
    _, _, pp_loss = tllama.make_train_step(tcfg, popt, mesh=pp2)(
        fresh, popt.init(fresh), {"tokens": torch.tensor(batch)})
    np.testing.assert_allclose(float(pp_loss), float(ref_loss), rtol=1e-6)
    for a, b in zip(tllama._leaves(fresh), tllama._leaves(ref)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6, rtol=0)

    tp4 = types.SimpleNamespace(mesh_dim_names=AXIS_ORDER, shape=(1, 1, 1, 4, 1, 1))
    with pytest.raises(ValueError, match="n_kv_heads % 4"):
        tllama.make_train_step(tcfg, tllama.AdamW(1e-3), mesh=tp4)
