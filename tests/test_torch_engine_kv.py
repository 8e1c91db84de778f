"""The port's int8 KV pools and page adoption against the JAX package, on
the CPU: ``_kv_write``/``_kv_read``, the int8 engine, ``scatter_pages``,
``submit_prefilled`` and ``paged_prefill_suffix``. Weights are the JAX tiny
init carried across; float32 unless a case says otherwise."""

import asyncio

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.llm import ContinuousBatchingEngine as JEngine
from ray_tpu.llm import engine as jeng
from ray_tpu.llm import generate as jgenerate
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import ContinuousBatchingEngine
from ray_tpu_torch.llm import engine as teng
from ray_tpu_torch.models import llama as tllama

PS = 8
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17],
           list(range(30, 50)), [21, 22]]
MAX_NEW = 10


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, jparams, tcfg, params


@pytest.fixture(scope="module")
def ref(models):
    jcfg, jparams, _, _ = models
    return jgenerate(jparams, jcfg, PROMPTS, max_new_tokens=MAX_NEW, temperature=0.0)


def _serve(eng, calls):
    async def go():
        await eng.start()
        try:
            return await asyncio.gather(*[eng.generate(p, **kw) for p, kw in calls])
        finally:
            await eng.stop()

    return asyncio.run(go())


# ------------------------------------------------------------- quantizer
def _kv_case(name):
    """(val [PS, KV, hd] numpy, its dtype name) for one quantizer case."""
    rng = np.random.default_rng(0)
    val = rng.normal(0, 0.7, size=(PS, 2, 16)).astype(np.float32)
    if name == "clip_bf16":
        # max|val| = 1.328125: bf16(m / 127) puts m / s at 127.5 -> 128
        val = np.clip(val, -1.0, 1.0)
        val[:, :, 3] = 1.328125
        return val, "bfloat16"
    return val, name


@pytest.mark.parametrize("case", ["float32", "bfloat16", "clip_bf16"])
def test_kv_write_read_matches_jax(case):
    """float32: the same int8 codes and scales as JAX; bf16 (scale and
    quotient in bf16): within one code; a bf16 quotient at 128 clips."""
    val, dt = _kv_case(case)
    L, P, KV, hd = 1, 4, val.shape[1], val.shape[2]
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    jpool = {"q": jnp.zeros((L, P, PS, KV, hd), jnp.int8),
             "s": jnp.zeros((L, P, PS, KV), jnp.float32)}
    jval = jnp.asarray(val).astype(jdt)
    jpool = jeng._kv_write(jpool, 0, jnp.full((PS,), 2, jnp.int32),
                           jnp.arange(PS, dtype=jnp.int32), jval)
    tpool = {"q": torch.zeros((L, P, PS, KV, hd), dtype=torch.int8),
             "s": torch.zeros((L, P, PS, KV), dtype=torch.float32)}
    tval = torch.tensor(np.asarray(jval.astype(jnp.float32))).to(tdt)
    teng._kv_write(tpool, 0, torch.full((PS,), 2), torch.arange(PS), tval)

    jq, tq = np.asarray(jpool["q"]).astype(np.int32), tpool["q"].numpy().astype(np.int32)
    js, ts = np.asarray(jpool["s"]), tpool["s"].numpy()
    if case == "float32":
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ts, js)
    else:
        assert np.abs(tq - jq).max() <= 1
        np.testing.assert_allclose(ts, js, rtol=2 ** -8)
    if case == "clip_bf16":
        assert tq.max() == 127 and jq.max() == 127  # no wrap to -128
        s = tval.abs().amax(-1) / 127.0
        assert bool((torch.round(tval / s[..., None]) >= 128).any())  # it did reach 128

    jread = jeng._kv_read(jpool, 0, jnp.asarray([[2]], jnp.int32), 1, 1, PS, KV, hd, jdt)
    tread = teng._kv_read(tpool, 0, torch.tensor([[2]]), tdt)
    assert tread.dtype == tdt
    got, want = tread.float().numpy(), np.asarray(jread.astype(jnp.float32))
    if case == "float32":
        np.testing.assert_array_equal(got, want)
    else:  # one code of the bf16 scale, plus bf16 rounding of the product
        assert np.abs(got - want).max() <= 1.5 * np.abs(want).max() / 127


def test_int8_roundtrip_bound():
    """The per-(token, kv-head) quantizer loses < 1% of max|val| (the JAX
    package's contract, tests/test_llm.py)."""
    val, _ = _kv_case("float32")
    pool = {"q": torch.zeros((1, 4, PS, 2, 16), dtype=torch.int8),
            "s": torch.zeros((1, 4, PS, 2), dtype=torch.float32)}
    v = torch.tensor(val)
    teng._kv_write(pool, 0, torch.full((PS,), 2), torch.arange(PS), v)
    got = teng._kv_read(pool, 0, torch.tensor([[2]]), torch.float32)[0]
    assert float(((got - v).abs() / v.abs().max()).max()) < 0.01


# ------------------------------------------------------------ int8 engine
@pytest.fixture(scope="module")
def jax_int8(models):
    """The JAX int8 engine's greedy tokens, planned and reactive loops."""
    jcfg, jparams, _, _ = models
    out = {}
    for loop, eos in (("planned", None), ("reactive", 10 ** 6)):
        eng = JEngine(jparams, jcfg, max_batch=4, page_size=PS, n_pages=64,
                      max_seq_len=64, kv_dtype="int8", eos_id=eos)
        out[loop] = _serve(eng, [(p, {"max_tokens": MAX_NEW}) for p in PROMPTS])
    return out


@pytest.mark.parametrize("loop,eos", [("planned", None), ("reactive", 10 ** 6)])
def test_int8_engine_matches_jax_int8_engine(models, jax_int8, loop, eos):
    _, _, cfg, params = models
    eng = ContinuousBatchingEngine(params, cfg, max_batch=4, page_size=PS,
                                   n_pages=64, max_seq_len=64, kv_dtype="int8",
                                   eos_id=eos)
    outs = _serve(eng, [(p, {"max_tokens": MAX_NEW}) for p in PROMPTS])
    assert outs == jax_int8[loop]
    assert eng.kpool["q"].dtype == torch.int8 and eng.kpool["s"].dtype == torch.float32


# ---------------------------------------------------------- scatter_pages
def _pool(cfg, kv_dtype, rng):
    """A pool of 6 pages of random numpy values: an array, or a {"q", "s"}
    dict for int8."""
    shape = (cfg.n_layers, 6, PS, cfg.n_kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        return {"q": rng.integers(-127, 128, shape).astype(np.int8),
                "s": rng.random(shape[:-1]).astype(np.float32)}
    return rng.normal(size=shape).astype(np.float32)


def _to_jax(pool):
    return ({k: jnp.asarray(v) for k, v in pool.items()} if isinstance(pool, dict)
            else jnp.asarray(pool))


def _to_torch(pool):
    return ({k: torch.tensor(v) for k, v in pool.items()} if isinstance(pool, dict)
            else torch.tensor(pool))


def _np(pool):
    return ({k: np.asarray(v) for k, v in pool.items()} if isinstance(pool, dict)
            else np.asarray(pool))


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_scatter_pages_matches_jax(models, kv_dtype, source):
    _, _, cfg, _ = models
    rng = np.random.default_rng(1)
    pool, stack = _pool(cfg, kv_dtype, rng), _pool(cfg, kv_dtype, rng)
    stack = ({k: v[:, :2] for k, v in stack.items()} if kv_dtype == "int8"
             else stack[:, :2])
    want = _np(jeng.scatter_pages(_to_jax(pool), [4, 1], _to_jax(stack)))
    tpool = _to_torch(pool)
    got = teng.scatter_pages(tpool, [4, 1], stack if source == "numpy" else _to_torch(stack))
    assert got is tpool  # written in place and returned
    for key in (("q", "s") if kv_dtype == "int8" else (None,)):
        g = got[key] if key else got
        w = want[key] if key else want
        np.testing.assert_array_equal(g.numpy(), w)


def test_scatter_pages_casts_a_jax_bf16_stack(models):
    """A bf16 JAX stack (numpy's ml_dtypes bfloat16) lands bit for bit in a
    bf16 pool and is cast into a float32 one."""
    _, _, cfg, _ = models
    stack = np.random.default_rng(2).normal(
        size=(cfg.n_layers, 1, PS, cfg.n_kv_heads, cfg.head_dim)).astype(ml_dtypes.bfloat16)
    pool16 = torch.zeros((cfg.n_layers, 3, PS, cfg.n_kv_heads, cfg.head_dim),
                         dtype=torch.bfloat16)
    pool32 = pool16.float()
    teng.scatter_pages(pool16, [2], stack)
    teng.scatter_pages(pool32, np.asarray([2]), stack)
    want = stack.astype(np.float32)
    np.testing.assert_array_equal(pool16[:, 2:].float().numpy(), want)
    np.testing.assert_array_equal(pool32[:, 2:].numpy(), want)
    assert not pool32[:, :2].any()


# ------------------------------------------------------- submit_prefilled
def _jax_prefill(models, prompt, kv_dtype=None, n_pages=16):
    """JAX paged_prefill_batch of one prompt into pages 1..n: (k_stack,
    v_stack, first token, the JAX pools)."""
    jcfg, jparams, _, _ = models
    kpool, vpool = jeng.make_kv_pools(jcfg, PS, n_pages, kv_dtype)
    n = -(-len(prompt) // PS)
    toks = np.zeros((1, n * PS), np.int32)
    toks[0, :len(prompt)] = prompt
    pages = np.arange(1, n + 1, dtype=np.int32)[None]
    first, kpool, vpool = jeng.paged_prefill_batch(
        jparams, None, jnp.zeros(1, jnp.int32), jnp.asarray(toks), jnp.asarray(pages),
        kpool, vpool, jnp.asarray([len(prompt)], jnp.int32), jnp.zeros(1, jnp.float32),
        jax.random.PRNGKey(0), jcfg)
    idx = jnp.arange(1, n + 1)
    if isinstance(kpool, dict):
        k_stack = {key: np.asarray(v[:, idx]) for key, v in kpool.items()}
        v_stack = {key: np.asarray(v[:, idx]) for key, v in vpool.items()}
    else:
        k_stack, v_stack = np.asarray(kpool[:, idx]), np.asarray(vpool[:, idx])
    return k_stack, v_stack, int(first[0]), (kpool, vpool)


@pytest.mark.parametrize("loop,eos", [("planned", None), ("reactive", 10 ** 6)])
def test_submit_prefilled_matches_jax_generate(models, ref, monkeypatch, loop, eos):
    """Pages prefilled by JAX, adopted by the port: no prefill runs, and
    the continuation equals JAX generate's."""
    _, _, cfg, params = models
    calls, real = [], teng.paged_prefill_batch
    monkeypatch.setattr(teng, "paged_prefill_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=PS,
                                   n_pages=64, max_seq_len=64, eos_id=eos)
    rids = []

    async def go():
        await eng.start()
        for p in PROMPTS[:3]:
            k_stack, v_stack, first, _ = _jax_prefill(models, p)
            src = (k_stack, v_stack) if p is PROMPTS[1] else (torch.tensor(k_stack),
                                                              torch.tensor(v_stack))
            rids.append(eng.submit_prefilled(p, *src, first, max_tokens=MAX_NEW))
        outs = []
        for rid in rids:
            outs.append([t async for t in eng.stream(rid)])
        await eng.stop()
        return outs

    outs = asyncio.run(go())
    assert outs == ref[:3]
    assert not calls
    assert len(eng.free_pages) == 63  # every adopted page went back


def test_submit_prefilled_needs_every_prompt_page(models):
    _, _, cfg, params = models
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=PS,
                                   n_pages=64, max_seq_len=64)
    k_stack, v_stack, first, _ = _jax_prefill(models, PROMPTS[3])  # 20 tokens: 3 pages
    with pytest.raises(ValueError, match="cover 2 pages.*needs 3"):
        eng.submit_prefilled(PROMPTS[3], k_stack[:, :2], v_stack[:, :2], first)
    # stacks of another pool's form or page shape fail here, not in the loop
    k8, v8, _, _ = _jax_prefill(models, PROMPTS[3], "int8")
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit_prefilled(PROMPTS[3], k8, v8, first)
    with pytest.raises(ValueError, match="does not fit"):
        eng.submit_prefilled(PROMPTS[3], k_stack[..., :4], v_stack[..., :4], first)
    assert not eng.waiting


def test_submit_prefilled_int8_matches_jax_int8_engine(models, jax_int8):
    """int8 stacks ({"q", "s"} dicts) from a JAX int8 prefill, adopted by
    the port's int8 engine: the tokens equal the JAX int8 engine's."""
    _, _, cfg, params = models
    eng = ContinuousBatchingEngine(params, cfg, max_batch=4, page_size=PS,
                                   n_pages=64, max_seq_len=64, kv_dtype="int8")

    async def go():
        await eng.start()
        rids = []
        for p in PROMPTS:
            k_stack, v_stack, first, _ = _jax_prefill(models, p, "int8")
            rids.append(eng.submit_prefilled(p, k_stack, v_stack, first,
                                             max_tokens=MAX_NEW))
        outs = [[t async for t in eng.stream(rid)] for rid in rids]
        await eng.stop()
        return outs

    assert asyncio.run(go()) == jax_int8["planned"]


# --------------------------------------------------- paged_prefill_suffix
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_prefill_suffix_matches_jax(models, kv_dtype):
    """Suffix prefill over a page-aligned prefix already in the pool, on
    the same pools in both packages: the same first tokens, the same pool
    rows. The suffix bucket's padded tail reaches past the table's W pages
    (JAX drops those writes; the port sends them to the junk page 0)."""
    jcfg, jparams, cfg, params = models
    prompts = [list(range(40, 61)), [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]]
    prefix = [16, 8]  # page-aligned: 2 pages and 1 page
    Ts, W = 16, 3     # prefix 16 + 16 > 3 * 8: the tail passes the table
    _, _, _, (jk, jv) = _jax_prefill(models, prompts[0][:16], kv_dtype)
    # the second prompt's prefix page into page 5
    _, _, _, (jk2, jv2) = _jax_prefill(models, prompts[1][:8], kv_dtype)
    jk = jeng.scatter_pages(jk, [5], _take(jk2, [1]))
    jv = jeng.scatter_pages(jv, [5], _take(jv2, [1]))
    pages = np.asarray([[1, 2, 7], [5, 8, 0]], np.int32)
    toks = np.zeros((2, Ts), np.int32)
    lens = []
    for j, (p, n) in enumerate(zip(prompts, prefix)):
        toks[j, :len(p) - n] = p[n:]
        lens.append(len(p) - n)
    tk, tv = _to_torch(_np(jk)), _to_torch(_np(jv))
    jfirst, jk, jv = jeng.paged_prefill_suffix(
        jparams, None, jnp.zeros(2, jnp.int32), jnp.asarray(toks), jnp.asarray(pages),
        jk, jv, jnp.asarray(prefix, jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.zeros(2, jnp.float32), jax.random.PRNGKey(0), jcfg)
    tfirst = teng.paged_prefill_suffix(
        params, None, torch.zeros(2, dtype=torch.long), torch.tensor(toks).long(),
        torch.tensor(pages).long(), tk, tv, torch.tensor(prefix), torch.tensor(lens),
        torch.zeros(2), None, cfg)
    assert tfirst.tolist() == np.asarray(jfirst).tolist()
    # and both equal the full prefill's first token (exact for float pools)
    full = [_jax_prefill(models, p, kv_dtype)[2] for p in prompts]
    if kv_dtype is None:
        assert tfirst.tolist() == full
    real = [1, 2, 5, 7, 8]  # every page but the junk page
    for a, b in ((tk, jk), (tv, jv)):
        if kv_dtype == "int8":  # dequantized, within one code of the scale
            for i in range(cfg.n_layers):
                ga = teng._kv_read(a, i, torch.tensor([real]), torch.float32).numpy()
                gb = np.asarray(jeng._kv_read(b, i, jnp.asarray([real]), 1, len(real), PS,
                                              cfg.n_kv_heads, cfg.head_dim, jnp.float32))
                np.testing.assert_allclose(ga, gb, atol=1.01 * np.abs(gb).max() / 127)
        else:
            np.testing.assert_allclose(a[:, real].numpy(), np.asarray(b[:, np.asarray(real)]),
                                       rtol=1e-5, atol=1e-5)


def _take(pool, idx):
    idx = jnp.asarray(idx)
    if isinstance(pool, dict):
        return {k: v[:, idx] for k, v in pool.items()}
    return pool[:, idx]
