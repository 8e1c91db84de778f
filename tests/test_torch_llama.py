"""The port's Llama forward against the JAX package's, on the CPU in float32.

The weights are the JAX init carried across with ``params_from_numpy``;
the tokens come from a numpy seed. Logits atol 1e-4 (two float32 layers
of matmuls summed in another order)."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 7.3 s, module set-up 5.8 s (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=60)


ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny()
    return jcfg, jparams, tree, tcfg, tllama.params_from_numpy(tree, tcfg, device="cpu")


# jitted: the first eager call of a JAX forward costs seconds of op compiles
_jforward = jax.jit(jllama.llama_forward, static_argnames=("cfg", "attn_impl"))
_jloss = jax.jit(jllama.llama_loss, static_argnames=("cfg",))


def _tokens(seed, B=2, T=64, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T)).astype(np.int32)


def test_config_mirrors_jax():
    for name in ("tiny", "llama2_7b", "llama3_8b"):
        j, t = getattr(jllama.LlamaConfig, name)(), getattr(tllama.LlamaConfig, name)()
        assert {f: getattr(j, f) for f in j.__dataclass_fields__} == \
               {f: getattr(t, f) for f in t.__dataclass_fields__}
        assert j.head_dim == t.head_dim


def test_params_from_numpy_round_trip(models):
    _, _, tree, cfg, params = models
    flat_np = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_np) == 3 + 9 * cfg.n_layers
    for path, arr in flat_np:
        node = params
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.float32 and tuple(node.shape) == arr.shape
        np.testing.assert_array_equal(node.numpy(), arr)
    # kernels stay [d_in, d_out]
    assert tuple(params["layers_0"]["wk"]["kernel"].shape) == (
        cfg.d_model, cfg.n_kv_heads * cfg.head_dim)
    with pytest.raises(ValueError, match="keys"):
        tllama.params_from_numpy({"tok": tree["tok"]}, cfg, device="cpu")


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_logits_match_jax(models, impl):
    jcfg, jparams, _, tcfg, params = models
    toks = _tokens(0)
    want, _ = _jforward(jparams, jax.numpy.asarray(toks), cfg=jcfg, attn_impl=impl)
    got, aux = tllama.llama_forward(params, torch.tensor(toks), tcfg, attn_impl=impl)
    assert aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_loss_matches_jax(models):
    jcfg, jparams, _, tcfg, params = models
    toks = _tokens(1, T=33)
    want = _jloss(jparams, {"tokens": jax.numpy.asarray(toks)}, cfg=jcfg)
    got = tllama.llama_loss(params, {"tokens": torch.tensor(toks)}, tcfg)
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=0)


def test_init_scales_and_layout():
    cfg = tllama.LlamaConfig.tiny()
    g = torch.Generator().manual_seed(0)
    params = tllama.llama_init(g, cfg, "cpu")
    assert set(params) == {"tok", "norm", "lm_head", "layers_0", "layers_1"}
    wq = params["layers_0"]["wq"]["kernel"]
    assert tuple(wq.shape) == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert abs(float(wq.std()) - (2.0 / (2 * cfg.d_model)) ** 0.5) < 0.02
    again = tllama.llama_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert torch.equal(again["lm_head"]["kernel"], params["lm_head"]["kernel"])


def test_moe_and_mesh_raise():
    """MoE layers port: the init draws JAX's layout and the forward follows
    JAX's. A mesh over the axes that used to raise runs (the multi-rank
    cases are in tests/test_torch_parallel.py): a pp axis is replicated
    compute, with JAX's logits. What raises: tp over heads that do not
    split (ValueError naming the config), and the engine given MoE params
    (its decode body, like JAX's, reads dense FFN weights)."""
    import types

    from ray_tpu_torch.llm.engine import ContinuousBatchingEngine
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER

    jcfg = jllama.LlamaConfig.tiny(n_experts=2)
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    cfg = tllama.LlamaConfig.tiny(n_experts=2)
    drawn = tllama.llama_init(torch.Generator().manual_seed(0), cfg, "cpu")
    for path, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = drawn
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == arr.shape, jax.tree_util.keystr(path)
    params = tllama.params_from_numpy(tree, cfg, device="cpu")
    toks = _tokens(4, T=32)
    want, jaux = _jforward(jparams, jax.numpy.asarray(toks), cfg=jcfg, attn_impl="plain")
    got, aux = tllama.llama_forward(params, torch.tensor(toks), cfg, attn_impl="plain")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    pp2 = types.SimpleNamespace(mesh_dim_names=AXIS_ORDER, shape=(1, 1, 2, 1, 1, 1))
    got, aux = tllama.llama_forward(params, torch.tensor(toks), cfg, attn_impl="plain",
                                    mesh=pp2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    tp4 = types.SimpleNamespace(mesh_dim_names=AXIS_ORDER, shape=(1, 1, 1, 4, 1, 1))
    with pytest.raises(ValueError, match="n_kv_heads % 4 == 0"):
        tllama.llama_forward(params, torch.tensor(toks), cfg, mesh=tp4)
    with pytest.raises(NotImplementedError, match="dense"):
        ContinuousBatchingEngine(params, cfg)


def test_entry_runs_on_cpu():
    from ray_tpu_torch.entry import entry

    fn, (params, tokens) = entry(device="cpu")
    assert tuple(tokens.shape) == (2, 256)
    logits = fn(params, tokens)
    assert tuple(logits.shape) == (2, 256, 2048)
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
