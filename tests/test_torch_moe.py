"""The port's MoE (Switch-style top-1 experts) against the JAX package's, on the CPU.

Inputs come from a numpy seed; model weights are the JAX init carried across
with ``params_from_numpy``. float32 bounds: routing (dispatch, combine, aux)
1e-6, ``moe_ffn`` out 1e-5, aux 1e-6 and gradients 1e-4, Llama logits 1e-4
and gradients 1e-5 per leaf (as ``test_torch_train.py``). At bf16 only the
dtypes are compared, layer by layer: near-ties in the bf16 softmax may route
a token differently in the two packages."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import moe as jmoe
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import moe as tmoe

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


@pytest.mark.parametrize("capacity", [2, 5, 16])
def test_top1_gating_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    logits, w = _f32(rng, 16, 4), _f32(rng, 16, 4, capacity)

    def jloss(lg):
        _, combine, aux = jmoe.top1_gating(lg, 4, capacity)
        return (combine * w).sum() + aux

    want = jmoe.top1_gating(jnp.asarray(logits), 4, capacity)
    want_grad = jax.grad(jloss)(jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    got = tmoe.top1_gating(lg, 4, capacity)
    for name, g, j in zip(("dispatch", "combine", "aux"), got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(j), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert not got[0].requires_grad  # dispatch carries no gradient
    ((got[1] * torch.tensor(w)).sum() + got[2]).backward()
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad), atol=1e-6, rtol=0)


def test_top1_gating_capacity_drops_tokens_as_jax():
    # tests/test_parallel.py's case: every token to expert 0, capacity 2
    logits = np.stack([np.array([10.0, 0.0], np.float32)] * 6)
    jd, jc, ja = jmoe.top1_gating(jnp.asarray(logits), 2, capacity=2)
    td, tc, ta = tmoe.top1_gating(torch.tensor(logits), 2, capacity=2)
    assert float(td.sum()) == 2.0  # only capacity survives
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=0)


def test_top1_gating_breaks_ties_to_the_first_expert():
    logits = np.zeros((3, 4), np.float32)
    td, _, _ = tmoe.top1_gating(torch.tensor(logits), 4, capacity=3)
    jd, _, _ = jmoe.top1_gating(jnp.asarray(logits), 4, capacity=3)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert float(td[:, 0].sum()) == 3.0


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_ffn_and_grads_match_jax(capacity_factor):
    rng = np.random.default_rng(7)
    B, T, D, E, F = 2, 8, 16, 4, 32
    args = [_f32(rng, B, T, D), _f32(rng, D, E, scale=0.1), _f32(rng, E, D, F, scale=0.1),
            _f32(rng, E, F, D, scale=0.1)]
    w = _f32(rng, B, T, D)

    def jloss(*a):
        out, aux = jmoe.moe_ffn(*a, capacity_factor=capacity_factor)
        return (out * w).sum() + aux

    jout, jaux = jmoe.moe_ffn(*map(jnp.asarray, args), capacity_factor=capacity_factor)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out, aux = tmoe.moe_ffn(*targs, capacity_factor=capacity_factor)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=1e-6, rtol=0)
    ((out * torch.tensor(w)).sum() + aux).backward()
    for t, g in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-4, rtol=0)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_ffn_local_over_batch_rows_matches_jax(capacity_factor):
    # the Llama block's call: B rows of T tokens queue in (row, position)
    # order, each earlier row counted once, at the capacity of all B*T
    rng = np.random.default_rng(9)
    B, T, D, E, F = 3, 8, 16, 4, 32
    args = [_f32(rng, B, T, D), _f32(rng, D, E, scale=0.3), _f32(rng, E, D, F, scale=0.1),
            _f32(rng, E, F, D, scale=0.1)]
    jout, jaux = jmoe.moe_ffn(*map(jnp.asarray, args), capacity_factor=capacity_factor)
    out, aux = tmoe.moe_ffn_local(*map(torch.tensor, args),
                                  capacity=max(1, int(capacity_factor * B * T / E)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)


def test_moe_ffn_promotes_bf16_tokens_to_float32():
    rng = np.random.default_rng(8)
    args = [_f32(rng, 1, 8, 16), _f32(rng, 16, 4, scale=0.1), _f32(rng, 4, 16, 32, scale=0.1),
            _f32(rng, 4, 32, 16, scale=0.1)]
    jout, jaux = jmoe.moe_ffn(*(jnp.asarray(a, jnp.bfloat16) for a in args))
    out, aux = tmoe.moe_ffn(*(torch.tensor(a).bfloat16() for a in args))
    assert str(out.dtype).split(".")[-1] == str(jout.dtype) == "float32"
    assert str(aux.dtype).split(".")[-1] == str(jaux.dtype) == "float32"


@pytest.fixture(scope="module")
def moe_models():
    jcfg = jllama.LlamaConfig.tiny(n_experts=4)
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(n_experts=4)
    return jcfg, jparams, tree, tcfg


def _tokens(seed, B=2, T=33):
    return np.random.default_rng(seed).integers(0, 256, size=(B, T)).astype(np.int32)


def test_switch8_config_is_llama3_8b_with_eight_experts():
    want = dataclasses.replace(jllama.LlamaConfig.llama3_8b(), n_experts=8)
    got = tllama.LlamaConfig.llama3_8b_switch8()
    assert {f: getattr(want, f) for f in want.__dataclass_fields__} == \
           {f: getattr(got, f) for f in got.__dataclass_fields__}
    assert (got.moe_every, got.capacity_factor) == (2, 1.25)


def test_init_draws_the_moe_subtree(moe_models):
    _, _, tree, tcfg = moe_models
    params = tllama.llama_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(list(tllama._leaves(params)))
    for path, arr in flat:
        assert tuple(_leaf(params, path).shape) == arr.shape, jax.tree_util.keystr(path)
    up = params["layers_1"]["moe"]["w_up"]["kernel"]
    assert abs(float(up.std()) - 0.02) < 2e-3
    assert "moe" not in params["layers_0"] and "w_gate" not in params["layers_1"]
    with pytest.raises(ValueError, match="layers_1"):
        tllama.params_from_numpy(tree, tllama.LlamaConfig.tiny(), device="cpu")


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_moe_forward_and_loss_match_jax(moe_models, impl):
    jcfg, jparams, tree, tcfg = moe_models
    params = tllama.params_from_numpy(tree, tcfg, device="cpu")
    toks = _tokens(1)
    want, jaux = jax.jit(jllama.llama_forward, static_argnames=("cfg", "attn_impl"))(
        jparams, jnp.asarray(toks[:, :-1]), cfg=jcfg, attn_impl=impl)
    got, aux = tllama.llama_forward(params, torch.tensor(toks[:, :-1]), tcfg, attn_impl=impl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    jl = jax.jit(jllama.llama_loss, static_argnames=("cfg", "attn_impl"))(
        jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg, attn_impl=impl)
    tl = tllama.llama_loss(params, {"tokens": torch.tensor(toks)}, tcfg, attn_impl=impl)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)


@pytest.mark.parametrize("remat", [True, False])
def test_moe_grads_match_jax_grad(moe_models, remat):
    _, jparams, tree, _ = moe_models
    jcfg = jllama.LlamaConfig.tiny(n_experts=4, remat=remat)
    tcfg = tllama.LlamaConfig.tiny(n_experts=4, remat=remat)
    toks = _tokens(2)
    want = jax.jit(jax.grad(jllama.llama_loss), static_argnames=("cfg",))(
        jparams, {"tokens": jnp.asarray(toks)}, cfg=jcfg)
    params = tllama.params_from_numpy(tree, tcfg, device="cpu")
    for t in tllama._leaves(params):
        t.requires_grad_(True)
    tllama.llama_loss(params, {"tokens": torch.tensor(toks)}, tcfg).backward()
    for path, g in jax.tree_util.tree_flatten_with_path(want)[0]:
        np.testing.assert_allclose(_leaf(params, path).grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_bf16_moe_dtypes_follow_jax_layer_by_layer():
    """bf16 until the first MoE layer, float32 from its output on (its float32
    dispatch promotes the residual stream), as in JAX."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(n_experts=4), n_layers=4,
                               dtype="bfloat16", remat=False)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(n_experts=4), n_layers=4,
                               dtype="bfloat16", remat=False)
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    toks = _tokens(3, T=16)
    jcos, jsin = jllama.rope_freqs(jcfg.head_dim, jcfg.max_seq_len, jcfg.rope_theta)
    tcos, tsin = tllama.rope_freqs(tcfg.head_dim, tcfg.max_seq_len, tcfg.rope_theta)
    jx = jparams["tok"]["embedding"][jnp.asarray(toks)]
    tx = params["tok"]["embedding"][torch.tensor(toks).long()]
    jdt, tdt = [], []
    for i in range(jcfg.n_layers):
        jx, _ = jllama._block(jparams[f"layers_{i}"], jx, jcos, jsin, jcfg, None, "plain", None)
        tx, _ = tllama._block(params[f"layers_{i}"], tx, tcos, tsin, tcfg, "plain")
        jdt.append(str(jx.dtype))
        tdt.append(str(tx.dtype).split(".")[-1])
    assert tdt == jdt == ["bfloat16", "float32", "float32", "float32"]
    jlogits, jaux = jllama.llama_forward(jparams, jnp.asarray(toks), jcfg, attn_impl="plain")
    logits, aux = tllama.llama_forward(params, torch.tensor(toks), tcfg, attn_impl="plain")
    assert str(logits.dtype).split(".")[-1] == str(jlogits.dtype) == "float32"
    assert str(aux.dtype).split(".")[-1] == str(jaux.dtype) == "float32"


def test_moe_remat_runs_flash_forward_once_per_layer(moe_models, monkeypatch):
    # the MoE FFN is recomputed in the backward; the flash forward is saved
    calls = []
    plain = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    _, _, tree, tcfg = moe_models
    params = tllama.params_from_numpy(tree, tcfg, device="cpu")
    for t in tllama._leaves(params):
        t.requires_grad_(True)
    tllama.llama_loss(params, {"tokens": torch.tensor(_tokens(4))}, tcfg,
                      attn_impl="flash").backward()
    assert len(calls) == tcfg.n_layers
    assert all(t.grad is not None for t in tllama._leaves(params))
