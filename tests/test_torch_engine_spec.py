"""The port's speculative decoding against the JAX package, on the CPU:
the n-gram drafter, the fused verify block, the speculative engine (its
greedy tokens, counters and KV rollback), mixed waves, the spec_drafter
hook, and slots that speculate past the end of their table. Weights are
the JAX init of the JAX spec tests' config, carried across; float32."""

import asyncio

import jax
import jax.numpy as jnp
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

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 30.1 s, module set-up 20.8 s (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=180, test_s=180)


PS = 8
CFG = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
           d_ff=256, max_seq_len=512, dtype="float32")


def _repetitive_prompt(n, seed=0):
    """A short repeated motif: the n-gram drafter proposes what the target
    picks (tests/test_spec_decode.py's prompt shape)."""
    rng = np.random.default_rng(seed)
    pat = list(map(int, rng.integers(1, 512, 6)))
    return (pat * (n // len(pat) + 1))[:n]


# test_spec_greedy_token_identical's jobs: (prompt, max_tokens)
JOBS = [(_repetitive_prompt(30), 16),
        (list(map(int, np.random.default_rng(1).integers(1, 512, 19))), 12),
        (_repetitive_prompt(20, seed=2), 10)]


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**CFG)
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig(**CFG)
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, jparams, tcfg, params


def _generate(models, prompts, n):
    jcfg, jparams, _, _ = models
    return jgenerate(jparams, jcfg, prompts, max_new_tokens=n, temperature=0.0)


@pytest.fixture(scope="module")
def ref(models):
    """JAX generate's greedy tokens for JOBS, and one JAX spec-engine run:
    its tokens and its spec_stats."""
    jcfg, jparams, _, _ = models
    full = _generate(models, [p for p, _ in JOBS], max(n for _, n in JOBS))
    eng = JEngine(jparams, jcfg, max_batch=4, page_size=PS, n_pages=128,
                  max_seq_len=256, spec_enable=True, spec_k=4)
    spec = _run(eng, [(p, {"max_tokens": n}) for p, n in JOBS])
    return {"generate": [r[:n] for r, (_, n) in zip(full, JOBS)],
            "jax_spec": spec, "jax_stats": eng.spec_stats()}


@pytest.fixture(scope="module")
def port_spec(models):
    """One run of the port's spec engine over JOBS: (tokens, spec_stats)."""
    _, _, cfg, params = models
    eng = _engine(cfg, params, spec_enable=True, spec_k=4)
    outs = _run(eng, [(p, {"max_tokens": n}) for p, n in JOBS])
    return outs, eng.spec_stats()


def _engine(cfg, params, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", PS)
    kw.setdefault("n_pages", 128)
    kw.setdefault("max_seq_len", 256)
    return ContinuousBatchingEngine(params, cfg, **kw)


def _run(eng, calls):
    async def go():
        await eng.start()
        try:
            return await asyncio.gather(*[eng.generate(list(p), **kw) for p, kw in calls])
        finally:
            await eng.stop()

    return asyncio.run(go())


# ------------------------------------------------------------ the drafter
def _history(case, m):
    """(hist [B, H], pos [B]) of one seeded drafter case."""
    rng = np.random.default_rng({"planted": 0, "short": 1, "no_match": 2, "near": 3}[case])
    B, H = 4, 48
    hist = rng.integers(0, 512, (B, H))
    if case == "planted":
        # the trailing m-gram also occurs earlier, followed by >= k tokens
        pos = np.asarray([20, 33, 40, 47])
        for b, (p, at) in enumerate(zip(pos, (5, 9, 2, 30))):
            hist[b, at:at + m] = hist[b, p - m + 1:p + 1]
    elif case == "short":
        pos = np.asarray([0, m - 1, 0, m - 1])  # pos < m: no pattern yet
    elif case == "no_match":
        hist = np.arange(B * H).reshape(B, H) % 512  # no token repeats in a row
        pos = np.asarray([10, 20, 30, 47])
    else:  # "near": the only earlier match ends 1-3 tokens before pos
        pos = np.asarray([12, 25, 30, 47])
        for b, (p, gap) in enumerate(zip(pos, (1, 2, 3, 2))):
            # the last gap + m tokens repeat with period gap
            for t in range(p - m + 1, p + 1):
                hist[b, t] = hist[b, t - gap]
    return hist, pos


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("case", ["planted", "short", "no_match", "near"])
def test_ngram_propose_matches_jax(case, m):
    k = 4
    hist, pos = _history(case, m)
    jd, jl = jeng._ngram_propose(jnp.asarray(hist, jnp.int32), jnp.asarray(pos, jnp.int32),
                                 k, m)
    td, tl = teng._ngram_propose(torch.tensor(hist), torch.tensor(pos), k, m)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    if case in ("short", "no_match"):
        assert not tl.any()
    elif case == "near":  # fewer than k followers: dl is capped by the gap
        assert tl.tolist() == [1, 2, 3, 2]
    else:
        assert (tl == k).all()


def test_paged_decode_spec_matches_jax(models):
    """Three fused speculative steps on the same prefilled pools and
    histories: the same candidates, emission counts, proposals, carry and
    history as JAX's block, and the same pool rows."""
    jcfg, jparams, cfg, params = models
    prompts = [_repetitive_prompt(21), _repetitive_prompt(13, seed=4)]
    B, MAXP, k, S = 2, 8, 4, 3
    kpool, vpool = jeng.make_kv_pools(jcfg, PS, 24, None)
    pt = np.zeros((B, MAXP), np.int32)
    hist = np.zeros((B, MAXP * PS), np.int32)
    first = []
    for b, p in enumerate(prompts):
        pt[b] = np.arange(1 + b * MAXP, 1 + (b + 1) * MAXP)
        n = -(-len(p) // PS)
        toks = np.zeros((1, n * PS), np.int32)
        toks[0, :len(p)] = p
        f, kpool, vpool = jeng.paged_prefill_batch(
            jparams, None, jnp.zeros(1, jnp.int32), jnp.asarray(toks),
            jnp.asarray(pt[b:b + 1, :n]), kpool, vpool, jnp.asarray([len(p)], jnp.int32),
            jnp.zeros(1, jnp.float32), jax.random.PRNGKey(0), jcfg)
        first.append(int(f[0]))
        hist[b, :len(p)] = p
        hist[b, len(p)] = first[-1]
    lens = np.asarray([len(p) for p in prompts])
    tk, tv = torch.tensor(np.asarray(kpool)), torch.tensor(np.asarray(vpool))
    ones = np.ones(B, bool)
    want = jeng.paged_decode_spec(
        jparams, None, jnp.zeros(B, jnp.int32), jnp.asarray(first, jnp.int32),
        jnp.asarray(lens, jnp.int32), jnp.asarray(hist), jnp.asarray(pt), kpool, vpool,
        jnp.asarray(ones), jnp.asarray(ones), jnp.zeros(B, jnp.float32),
        jax.random.PRNGKey(0), jcfg, S, k, 2)
    got = teng.paged_decode_spec(
        params, None, torch.zeros(B, dtype=torch.long), torch.tensor(first),
        torch.tensor(lens), torch.tensor(hist).long(), torch.tensor(pt).long(), tk, tv,
        torch.tensor(ones), torch.tensor(ones), torch.zeros(B), None, cfg, S, k, 2)
    for g, w in zip(got, want[:6]):  # toks, n_emit, n_prop, tok, pos, hist
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(want[1].sum()) > S * B  # some drafts were accepted
    for t, w in ((tk, want[6]), (tv, want[7])):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the engine
def test_spec_greedy_token_identical(ref, port_spec):
    """The speculative engine emits exactly JAX generate's greedy tokens
    (and the JAX spec engine's)."""
    outs, stats = port_spec
    assert outs == ref["generate"] == ref["jax_spec"]
    assert stats["spec_steps"] > 0 and stats["spec_accepted"] > 0


def test_spec_stats_match_jax_spec_engine(ref, port_spec):
    _, stats = port_spec
    want = ref["jax_stats"]
    for key in ("spec_steps", "spec_proposed", "spec_accepted", "spec_accept_rate"):
        assert stats[key] == want[key], key
    assert stats["blocks"] == [tuple(int(x) for x in b) for b in want["blocks"]]


def test_spec_kv_rollback_equivalent_pool(models):
    """After a speculative run every pool position a consumed token wrote
    (prompt + all but the last emitted token) equals a never-speculated
    run's: rejected drafts left no trace. The free lists are equal."""
    _, _, cfg, params = models
    prompt, mt = _repetitive_prompt(19), 12
    e_plain = _engine(cfg, params)
    e_spec = _engine(cfg, params, spec_enable=True, spec_k=4)
    assert _run(e_plain, [(prompt, {"max_tokens": mt})]) == \
        _run(e_spec, [(prompt, {"max_tokens": mt})]) == \
        [_generate(models, [prompt], mt)[0]]
    assert e_spec.spec_accepted > 0
    n_cover = -(-(len(prompt) + mt) // PS)
    n_pos = len(prompt) + mt - 1
    for a, b in ((e_plain.kpool, e_spec.kpool), (e_plain.vpool, e_spec.vpool)):
        a = a[:, 1:n_cover + 1].flatten(1, 2)[:, :n_pos]
        b = b[:, 1:n_cover + 1].flatten(1, 2)[:, :n_pos]
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-5)
    assert sorted(e_spec.free_pages) == sorted(e_plain.free_pages)
    assert not e_spec.page_tables.any() and not e_plain.page_tables.any()


def test_mixed_spec_sampled_optout_wave(models):
    """One wave of a speculative row, a sampled row (decodes plain) and an
    opt-out row: the spec and opt-out rows agree with JAX generate."""
    _, _, cfg, params = models
    prompt = _repetitive_prompt(30)

    async def go():
        eng = _engine(cfg, params, spec_enable=True, spec_k=4)
        await eng.start()
        rids = {"spec": eng.submit(prompt, max_tokens=12),
                "samp": eng.submit(list(prompt), max_tokens=9, temperature=0.9),
                "plain": eng.submit(list(prompt), max_tokens=12, spec=False)}
        outs = {name: [t async for t in eng.stream(rid)] for name, rid in rids.items()}
        stats = eng.spec_stats()
        await eng.stop()
        return outs, stats

    outs, stats = asyncio.run(go())
    want = _generate(models, [prompt], 12)[0]
    assert outs["spec"] == outs["plain"] == want
    assert len(outs["samp"]) == 9 and all(0 <= t < cfg.vocab_size for t in outs["samp"])
    assert stats["spec_proposed"] > 0 and stats["spec_accepted"] > 0


@pytest.mark.parametrize("drafter", ["oracle", "wrong"])
def test_spec_drafter_hook(models, ref, drafter):
    """A host drafter that proposes the target's own continuation is
    accepted in full; one that proposes (token + 1) % vocab never is.
    Either way the tokens equal JAX generate's."""
    _, _, cfg, params = models
    seqs = [list(p) + r for (p, _), r in zip(JOBS, ref["generate"])]

    def propose(context, pos, k):
        seq = next(s for s in seqs if s[:pos + 1] == list(context))
        got = seq[pos + 1:pos + 1 + k]
        return got if drafter == "oracle" else [(t + 1) % cfg.vocab_size for t in got]

    eng = _engine(cfg, params, spec_enable=True, spec_k=4, spec_drafter=propose)
    outs = _run(eng, [(p, {"max_tokens": n}) for p, n in JOBS])
    assert outs == ref["generate"]
    st = eng.spec_stats()
    assert st["spec_proposed"] > 0
    if drafter == "oracle":
        assert st["spec_accepted"] == st["spec_proposed"]
        assert st["spec_steps"] < sum(n for _, n in JOBS) // 2
    else:
        assert st["spec_accepted"] == 0


def test_spec_past_max_seq_len_and_history(models):
    """Slots that fill their whole table (prompt + max_tokens == max_seq_len
    == H) verify windows that run past the last page and write history past
    H: no fault, and the tokens equal JAX generate's and the JAX spec
    engine's."""
    jcfg, jparams, cfg, params = models
    calls = [(_repetitive_prompt(22), {"max_tokens": 10}),
             (_repetitive_prompt(27, seed=5), {"max_tokens": 5})]
    kw = dict(max_batch=2, page_size=PS, n_pages=16, max_seq_len=32,
              spec_enable=True, spec_k=4)
    eng = ContinuousBatchingEngine(params, cfg, **kw)
    got = _run(eng, calls)
    assert eng.hist.shape[1] == 32
    want = [_generate(models, [p], kw_["max_tokens"])[0] for p, kw_ in calls]
    assert got == want == _run(JEngine(jparams, jcfg, **kw), calls)
    assert eng.spec_accepted > 0


def test_tokens_in_flight_with_spec(models):
    _, _, cfg, params = models

    async def go():
        eng = _engine(cfg, params, spec_enable=True)
        await eng.start()
        rid = eng.submit(_repetitive_prompt(16), max_tokens=8)
        hr0 = eng.headroom()
        out = [t async for t in eng.stream(rid)]
        hr1 = eng.headroom()
        await eng.stop()
        return hr0, hr1, out

    hr0, hr1, out = asyncio.run(go())
    assert hr0["tokens_in_flight"] == 8  # owed while the request ran
    assert hr1["tokens_in_flight"] == 0 and len(out) == 8


def test_bf16_spec_equals_plain_in_both_packages():
    """bf16 at the spec tests' width (vocab 512, d_model 128, 2 layers, 4
    heads, page size 8), four requests of 32 greedy tokens: JAX's spec
    engine gives JAX's plain engine's tokens, and the port's spec engine
    the port's plain engine's. The two packages' bf16 tokens may part at
    greedy near-ties (one bf16 step of a logit), so each is held to its own
    plain engine."""
    cfg16 = dict(CFG, dtype="bfloat16")
    jcfg = jllama.LlamaConfig(**cfg16)
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig(**cfg16)
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    rng = np.random.default_rng(3)
    calls = [(p, {"max_tokens": 32}) for p in (
        _repetitive_prompt(30), list(map(int, rng.integers(1, 512, 19))),
        _repetitive_prompt(20, seed=2), list(map(int, rng.integers(1, 512, 12))))]
    kw = dict(max_batch=4, page_size=PS, n_pages=128, max_seq_len=256)
    jplain = _run(JEngine(jparams, jcfg, **kw), calls)
    jeng_spec = JEngine(jparams, jcfg, spec_enable=True, spec_k=4, **kw)
    jspec = _run(jeng_spec, calls)
    tplain = _run(_engine(tcfg, params), calls)
    teng_spec = _engine(tcfg, params, spec_enable=True, spec_k=4)
    tspec = _run(teng_spec, calls)
    assert all(len(o) == 32 for o in jplain + tplain)
    assert jspec == jplain
    assert tspec == tplain
    assert teng_spec.spec_stats()["spec_proposed"] > 0
    assert jeng_spec.spec_stats()["spec_proposed"] > 0
