"""The port's disaggregated serving pieces, driven in process, against the
JAX package on the CPU: ``prefix_hint`` and ``PrefixCache`` (run on both
packages' caches with the same fake manifests), ``ship_pages``/
``adopt_pages`` round trips through the shm arena for native, bf16 and int8
pools, ``export_pages``, and the ``PrefillWorker`` -> manifest ->
``DecodeWorker`` path against JAX's aggregated engine. Weights are the JAX
tiny init carried across; float32. The KV-page plane seals pages into the
port's runtime's arena, so every test that ships pages takes the
module-scoped ``rt`` fixture (``ray_tpu_torch.init`` with a small arena);
the cache and hint tests need none. Each async case runs under a 60 s
limit.
"""

import asyncio
import dataclasses
import os
import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

from ray_tpu.llm import ContinuousBatchingEngine as JEngine
from ray_tpu.llm.disagg import kv_plane as jkv
from ray_tpu.llm.disagg import prefix_cache as jpc
from ray_tpu.models import llama as jllama
from ray_tpu_torch import config
from ray_tpu_torch.core.ref import ObjectRef
from ray_tpu_torch.llm import ContinuousBatchingEngine
from ray_tpu_torch.llm import engine as teng
from ray_tpu_torch.llm.disagg import (
    DecodeWorker,
    KVShipError,
    PrefillWorker,
    PrefixCache,
    adopt_pages,
    prefix_hint,
    ship_pages,
)
from ray_tpu_torch.llm.disagg import kv_plane as tkv
from ray_tpu_torch.llm.disagg import telemetry
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.exceptions import BackPressureError

PS = 8
PROMPT = list(range(1, 20))  # 19 tokens: 2 full pages + a ragged tail
PROMPTS = [PROMPT, [7, 8, 9], list(range(40, 66)), [21, 22, 23, 24, 25, 26, 27, 28]]
MAX_NEW = 8

# slowest case a few seconds alone; the runtime's start and shutdown ~1 s
_module_limit, _test_limit = time_limits(module_s=60, test_s=60)


@pytest.fixture(scope="module")
def rt():
    """The port's runtime, whose shm arena the KV-page plane seals into."""
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers inherit it
    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    ray_tpu_torch.init(num_cpus=4, object_store_memory=64 << 20)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)
    if saved is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = saved


def _fetch(ref) -> np.ndarray:
    """A sealed page component's bytes, as a writable host array."""
    assert isinstance(ref, ObjectRef)
    return np.array(ray_tpu_torch.get(ref))


def run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, timeout=60)

    return asyncio.run(bounded())


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, jparams, tcfg, params


def _engine_kw():
    return dict(max_batch=2, page_size=PS, n_pages=64, max_seq_len=128)


@pytest.fixture(scope="module")
def aggregated(models):
    """JAX's aggregated engine's greedy tokens for PROMPTS."""
    jcfg, jparams, _, _ = models

    async def go():
        eng = JEngine(jparams, jcfg, **_engine_kw())
        await eng.start()
        try:
            return await asyncio.gather(*[eng.generate(p, max_tokens=MAX_NEW)
                                          for p in PROMPTS])
        finally:
            await eng.stop()

    return run(go())


# --------------------------------------------------------------- prefix hint
@pytest.mark.parametrize("toks,ps,n", [
    (list(range(1, 40)), 16, 1), (list(range(1, 40)), 16, 2),
    (list(range(1, 16)), 16, 1), ([7] + list(range(1, 40)), 8, 3), ([], 8, 1)])
def test_prefix_hint_matches_jax(toks, ps, n):
    assert prefix_hint(toks, page_size=ps, n_pages=n) == \
        jpc.prefix_hint(toks, page_size=ps, n_pages=n)


def test_prefix_hint_stability():
    toks = list(range(1, 40))
    h = prefix_hint(toks, page_size=16, n_pages=1)
    assert h and h == prefix_hint(toks[:16] + [999], page_size=16, n_pages=1)
    assert h != prefix_hint([7] + toks[1:], page_size=16, n_pages=1)
    assert prefix_hint(toks[:15], page_size=16) == ""


# -------------------------------------------------------------- prefix cache
# Each case drives one package's cache through the JAX tests' script
# (tests/test_disagg.py:123-181) and returns what it observed; the test
# runs it on both packages and requires the same observations.
PKGS = {"jax": (jpc.PrefixCache, jkv.KVPageEntry, jkv.KVPageManifest),
        "port": (PrefixCache, tkv.KVPageEntry, tkv.KVPageManifest)}


def _fake(pkg, tokens, nbytes_per_page=100):
    _, entry, manifest = PKGS[pkg]
    return manifest(token_ids=tuple(tokens), page_size=PS, kv_dtype="native",
                    pages=[entry(refs={}, nbytes=nbytes_per_page)
                           for _ in range(len(tokens) // PS)])


def _n(m):
    return None if m is None else (m.n_pages, m.token_ids)


def case_hit_partial_miss(pkg):
    c = PKGS[pkg][0](PS, capacity_bytes=1 << 20)
    base = list(range(100, 100 + 3 * PS))
    obs = [c.insert(_fake(pkg, base))]
    m = c.lookup(base)
    obs.append(_n(m))
    c.release(m)
    m2 = c.lookup(base[:2 * PS] + [7] * PS)
    obs.append(_n(m2))
    c.release(m2)
    obs.append(_n(c.lookup([9] * (3 * PS))))
    m3 = c.lookup(base, max_tokens=len(base) - 1)
    obs.append(_n(m3))
    c.release(m3)
    s = c.stats()
    assert obs[1][0] == 3 and obs[2][0] == 2 and obs[3] is None and obs[4][0] == 2
    assert s["hits"] == 3 and s["misses"] == 1 and 0 < s["hit_rate"] < 1
    return obs, s


def case_lru_prefers_leaves(pkg):
    c = PKGS[pkg][0](PS, capacity_bytes=350)  # 3 pages of 100 fit, 4 don't
    a = list(range(0, 2 * PS))
    c.insert(_fake(pkg, a + list(range(500, 500 + PS))))
    c.insert(_fake(pkg, a + list(range(600, 600 + PS))))
    s = c.stats()
    assert s["evictions"] == 1 and s["pages"] == 3
    obs = [_n(c.lookup(a + list(range(600, 600 + PS)))),
           _n(c.lookup(a + list(range(500, 500 + PS))))]
    assert obs[0][0] == 3 and obs[1][0] == 2  # the LRU leaf went, not the interior
    return obs, c.stats()


def case_pins(pkg):
    c = PKGS[pkg][0](PS, capacity_bytes=1 << 20)
    toks = list(range(0, 2 * PS))
    c.insert(_fake(pkg, toks))
    pinned = c.lookup(toks)
    c.capacity_bytes = 0
    c.insert(_fake(pkg, [9] * PS))  # the sweep evicts only the unpinned page
    again = c.lookup(toks, max_tokens=len(toks))
    obs = [_n(again), c.stats()["pinned"]]
    assert obs[0][0] == 2
    c.release(pinned)
    c.release(pinned)  # idempotent
    c.release(None)
    c.release(again)
    c.insert(_fake(pkg, [11] * PS))
    obs.append(c.stats()["bytes"])
    assert obs[-1] <= 300
    return obs, c.stats()


def case_invalidate(pkg):
    c = PKGS[pkg][0](PS, capacity_bytes=1 << 20)
    toks = list(range(0, 2 * PS))
    c.insert(_fake(pkg, toks))
    pinned = c.lookup(toks)
    obs = [c.invalidate(toks)]  # pinned: survives
    c.release(pinned)
    obs += [c.invalidate(toks), _n(c.lookup(toks))]
    assert obs == [0, 2, None]
    return obs, c.stats()


@pytest.mark.parametrize("case", [case_hit_partial_miss, case_lru_prefers_leaves,
                                  case_pins, case_invalidate])
def test_prefix_cache_matches_jax(case):
    jobs, jstats = case("jax")
    tobs, tstats = case("port")
    assert tobs == jobs
    assert tstats == jstats
    assert tstats["spill"] is False and tstats["spills"] == 0


# ----------------------------------------------------------- ship and adopt
def _filled_pools(kv_dtype, n_pages=8):
    cfg = tllama.LlamaConfig.tiny()
    kpool, vpool = teng.make_kv_pools(cfg, PS, n_pages, kv_dtype, "cpu")
    g = torch.Generator().manual_seed(0)
    for pool in (kpool, vpool):
        for t in (pool.values() if isinstance(pool, dict) else [pool]):
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g))
            else:
                t.copy_(torch.randn(t.shape, generator=g))
    return kpool, vpool


def _parts(pool):
    return pool if isinstance(pool, dict) else {"": pool}


@pytest.mark.parametrize("kv_dtype", ["native", "bf16", "int8"])
def test_ship_adopt_round_trip(rt, kv_dtype):
    """Each shipped page is sealed in the arena as one ref per component,
    whose bytes equal its pool row bit for bit (bf16 as uint16 bits);
    adopted stacks equal the pool's rows and scatter into a fresh pool
    exactly; the ledger counts the pages and bytes, the manifests' RPC
    bytes apart."""
    telemetry._reset_for_tests()
    kpool, vpool = _filled_pools(None if kv_dtype == "native" else kv_dtype)
    rows = [5, 2, 7]
    m = ship_pages(kpool, vpool, rows, list(range(1, 20)), page_size=PS,
                   kv_dtype=kv_dtype)
    assert (m.n_pages, m.n_tokens, m.full_pages(), m.kv_dtype) == (3, 19, 2, kv_dtype)
    want_keys = ["k", "v"] if kv_dtype != "int8" else ["k.q", "k.s", "v.q", "v.s"]
    node = rt.get_core().node_id.binary()
    for i, r in enumerate(rows):
        page = m.pages[i]
        assert sorted(page.refs) == want_keys and page.node == node
        arrs = {key: _fetch(ref) for key, ref in page.refs.items()}
        for side, pool in (("k", kpool), ("v", vpool)):
            for name, t in _parts(pool).items():
                arr = arrs[side if not name else f"{side}.{name}"]
                assert arr.dtype == (np.uint16 if t.dtype == torch.bfloat16
                                     else t.numpy().dtype)
                assert torch.equal(tkv._from_host(arr), t[:, r])
        assert page.nbytes == sum(a.nbytes for a in arrs.values())
    k_stack, v_stack = adopt_pages(m.prefix(2), m.prefix(3).prefix(3))
    idx = torch.tensor(rows[:2] + rows)
    fresh_k, fresh_v = _filled_pools(None if kv_dtype == "native" else kv_dtype)
    for pool, stack, fresh in ((kpool, k_stack, fresh_k), (vpool, v_stack, fresh_v)):
        for name, t in _parts(pool).items():
            s = stack[name] if name else stack
            assert s.dtype == t.dtype and torch.equal(s, t[:, idx])
        teng.scatter_pages(fresh, [1, 3, 4, 6, 0], stack)
        for name, t in _parts(pool).items():
            assert torch.equal(_parts(fresh)[name][:, [1, 3, 4, 6]], t[:, idx[:4]])
    c = telemetry.counters()
    assert c["pages_shipped"] == 3 and c["pages_adopted"] == 5 and c["adoptions"] == 1
    assert c["kv_array_bytes"] == m.nbytes + m.prefix(2).nbytes + m.nbytes
    assert c["kv_driver_bytes"] == tkv.manifest_nbytes(m) * 2 + tkv.manifest_nbytes(m.prefix(2))
    assert (c["ship_bytes"], c["adopt_bytes"]) == (m.nbytes, m.prefix(2).nbytes + m.nbytes)
    assert len(telemetry.stage_window(telemetry.KV_SHIP)) == 2
    telemetry.reset_counters()
    assert telemetry.counters()["pages_shipped"] == 0


def test_adopt_refuses_a_bad_manifest(rt):
    kpool, vpool = _filled_pools(None)
    m = ship_pages(kpool, vpool, [1, 2], list(range(16)), page_size=PS)
    del m.pages[1].refs["v"]
    with pytest.raises(KVShipError):
        adopt_pages(m)
    with pytest.raises(ValueError, match="empty"):
        adopt_pages(m.prefix(0))


# ------------------------------------------------------ disagg vs aggregated
def _disagg(params, cfg, prompts, *, via_cache=False, **pf_kw):
    """PrefillWorker -> manifest -> DecodeWorker.decode_adopted for every
    prompt, concurrently. With via_cache each prompt's full pages come
    from an aggregated engine's export_pages through the prefix cache and
    only the suffix is prefilled."""

    async def go():
        pf = PrefillWorker(cfg, params, page_size=PS, n_pages=64, **pf_kw)
        dw = DecodeWorker(cfg, params, **_engine_kw())
        cache = PrefixCache(PS)

        async def one(prompt):
            if not via_cache:
                m, first = await pf.prefill(prompt)
                return await dw.decode_adopted(prompt, m, None, first,
                                               max_tokens=MAX_NEW)
            pre = cache.lookup(prompt, max_tokens=len(prompt) - 1)
            try:
                sm, first = await pf.prefill(prompt[pre.n_tokens:], prefix=pre)
                return await dw.decode_adopted(prompt, pre, sm, first,
                                               max_tokens=MAX_NEW)
            finally:
                cache.release(pre)

        try:
            if via_cache:
                for p in prompts:
                    cache.insert(await _export(params, cfg, p))
            return await asyncio.gather(*[one(p) for p in prompts]), pf, dw
        finally:
            await dw.stop()

    return run(go())


async def _export(params, cfg, prompt, kv_dtype=None):
    """(manifest from export_pages of a live request) of ``prompt``."""
    eng = ContinuousBatchingEngine(params, cfg, eos_id=cfg.vocab_size,
                                   kv_dtype=kv_dtype, **_engine_kw())
    await eng.start()
    try:
        rid = eng.submit(prompt, max_tokens=MAX_NEW)
        m = None
        async for _ in eng.stream_blocks(rid):
            if m is None:
                m = eng.export_pages(rid)
        return m
    finally:
        await eng.stop()


def test_disagg_equals_aggregated(rt, models, aggregated):
    """Both legs, the full prefill and the cached prefix plus a suffix
    prefill, give JAX's aggregated engine's greedy tokens; the staging
    pool gets every page back."""
    _, _, cfg, params = models
    telemetry._reset_for_tests()
    got, pf, dw = _disagg(params, cfg, PROMPTS)
    assert got == aggregated
    assert len(pf.free_pages) == 63 and dw.engine_stats()["free_pages"] == 63
    c = telemetry.counters()
    assert c["prefills"] == len(PROMPTS) and c["adoptions"] == len(PROMPTS)
    assert len(telemetry.stage_window(telemetry.DECODE_QUEUE)) == len(PROMPTS)
    cached = [p for p in PROMPTS if len(p) > PS]  # a full page to cache
    got, pf, _ = _disagg(params, cfg, cached, via_cache=True)
    assert got == [a for p, a in zip(PROMPTS, aggregated) if len(p) > PS]
    assert len(pf.free_pages) == 63
    assert telemetry.counters()["suffix_prefills"] == len(cached)


def test_prefill_wave_coalesces(rt, models, monkeypatch):
    """Four concurrent prefills share one padded wave: one
    paged_prefill_batch dispatch, identical first tokens."""
    _, _, cfg, params = models
    calls = []
    real = teng.paged_prefill_batch
    monkeypatch.setattr(teng, "paged_prefill_batch",
                        lambda *a, **kw: calls.append(a[3].shape) or real(*a, **kw))

    async def go():
        pf = PrefillWorker(cfg, params, page_size=PS, n_pages=64, wave_wait_s=0.05)
        outs = await asyncio.gather(*(pf.prefill(list(range(1, 1 + PS * 2)))
                                      for _ in range(4)))
        return pf.waves, outs, pf

    waves, outs, pf = run(go())
    assert waves == 1 and calls == [(4, 2 * PS)]
    assert len({first for _, first in outs}) == 1
    assert all(m.n_pages == 2 for m, _ in outs) and len(pf.free_pages) == 63


def test_failed_dispatch_frees_staging_rows(rt, models, monkeypatch):
    """A wave whose prefill raises fails its callers and leaks no staging
    row; the next wave runs."""
    _, _, cfg, params = models

    def boom(*a, **kw):
        raise RuntimeError("injected")

    async def go():
        pf = PrefillWorker(cfg, params, page_size=PS, n_pages=64)
        with monkeypatch.context() as mp:
            mp.setattr(teng, "paged_prefill_batch", boom)
            res = await asyncio.gather(pf.prefill(PROMPT), pf.prefill([1, 2]),
                                       return_exceptions=True)
        free = len(pf.free_pages)
        m, _ = await pf.prefill(PROMPT)
        return res, free, m, pf

    res, free, m, pf = run(go())
    assert all(isinstance(r, RuntimeError) for r in res)
    assert free == 63 and m.n_pages == 3 and len(pf.free_pages) == 63


def test_export_pages_then_adopt_continues_the_source(rt, models, aggregated):
    """A live request's exported pages, adopted by a DecodeWorker with its
    first token, continue with the source's greedy tokens; export_pages
    raises KeyError for a request that holds no slot."""
    _, _, cfg, params = models

    async def go():
        m = await _export(params, cfg, PROMPT)
        dw = DecodeWorker(cfg, params, **_engine_kw())
        try:
            out = await dw.decode_adopted(PROMPT, m, None, aggregated[0][0],
                                          max_tokens=MAX_NEW)
            blocks = [b async for b in dw.decode_adopted_stream(
                PROMPT, m, None, aggregated[0][0], max_tokens=MAX_NEW)]
        finally:
            await dw.stop()
        return m, out, blocks

    m, out, blocks = run(go())
    assert (m.n_pages, m.n_tokens) == (3, len(PROMPT))
    assert out == aggregated[0]
    assert sum(blocks, []) == aggregated[0]
    eng = ContinuousBatchingEngine(params, cfg, **_engine_kw())
    with pytest.raises(KeyError):
        eng.export_pages(1)
    rid = eng.submit(PROMPT, max_tokens=2)  # queued, not yet admitted
    with pytest.raises(KeyError):
        eng.export_pages(rid)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_export_pages_of_quantized_pools_round_trip(rt, models, kv_dtype):
    """An int8 or bf16 engine exports its pool rows exactly, and a decode
    worker with the same kv_dtype adopts them."""
    _, _, cfg, params = models

    async def go():
        eng = ContinuousBatchingEngine(params, cfg, kv_dtype=kv_dtype,
                                       eos_id=cfg.vocab_size, **_engine_kw())
        await eng.start()
        try:
            rid = eng.submit(PROMPT, max_tokens=MAX_NEW)
            m, rows, out = None, None, []
            async for blk in eng.stream_blocks(rid):
                if m is None:
                    m = eng.export_pages(rid)
                    rows = eng.page_tables[eng._reqs[rid].slot, :3].tolist()
                    snap = {n: t[:, rows].clone() for n, t in _parts(eng.kpool).items()}
                out.extend(blk)
        finally:
            await eng.stop()
        dw = DecodeWorker(cfg, params, kv_dtype=kv_dtype, **_engine_kw())
        try:
            got = await dw.decode_adopted(PROMPT, m, None, out[0], max_tokens=MAX_NEW)
        finally:
            await dw.stop()
        return m, snap, out, got

    m, snap, out, got = run(go())
    assert m.kv_dtype == kv_dtype
    for name, t in snap.items():
        key = "k" if not name else f"k.{name}"
        for i in range(3):
            assert torch.equal(tkv._from_host(_fetch(m.pages[i].refs[key])), t[:, i])
    assert got == out


# ------------------------------------------------------------- backpressure
class _FullEngine:
    waiting = [None] * 3

    def submit_prefilled(self, *a, **kw):
        raise teng.EngineFull("queue at capacity")

    async def start(self):
        pass

    def cancel(self, rid):
        pass


def test_decode_worker_backpressure_and_bad_prompt(rt, models):
    """EngineFull -> BackPressureError(retry_after_s=0.05 (1 + waiting)) on
    both decode paths; an empty prompt stays a ValueError."""
    _, _, cfg, params = models
    kpool, vpool = teng.make_kv_pools(cfg, PS, 4, None, "cpu")
    m = ship_pages(kpool, vpool, [1, 2, 3], PROMPT, page_size=PS)
    dw = DecodeWorker.__new__(DecodeWorker)
    dw.engine, dw._stream_rids = _FullEngine(), {}

    async def drain(agen):
        return [x async for x in agen]

    with pytest.raises(BackPressureError) as ei:
        run(dw.decode_adopted(PROMPT, m, None, 1))
    assert ei.value.retry_after_s == pytest.approx(0.2)
    with pytest.raises(BackPressureError):
        run(drain(dw.decode_adopted_stream(PROMPT, m, None, 1)))

    real = DecodeWorker(cfg, params, **_engine_kw())

    async def go():
        try:
            await real.decode_adopted([], m, None, 1)
        finally:
            await real.stop()

    with pytest.raises(ValueError, match="empty prompt"):
        run(go())
    pf = PrefillWorker(cfg, params, page_size=PS, n_pages=8)
    for bad in ([], [cfg.vocab_size]):
        with pytest.raises(ValueError):
            run(pf.prefill(bad))
    with pytest.raises(ValueError, match="staging pages"):
        run(pf.prefill(list(range(60))))


def test_decode_stream_cancel_frees_the_slot(rt, models):
    """cancel_decode by key (or closing the stream) cancels the adopted
    request: its slot and pages come back before the budget is decoded."""
    _, _, cfg, params = models
    kpool, vpool = teng.make_kv_pools(cfg, PS, 4, None, "cpu")
    m = ship_pages(kpool, vpool, [1, 2, 3], PROMPT, page_size=PS)

    async def go():
        dw = DecodeWorker(cfg, params, eos_id=cfg.vocab_size, **_engine_kw())
        try:
            agen = dw.decode_adopted_stream(PROMPT, m, None, 5, max_tokens=90,
                                            cancel_key="r1")
            first = await agen.__anext__()
            assert dw.cancel_decode("r1") and not dw.cancel_decode("nope")
            rest = [b async for b in agen]
            t0 = time.monotonic()
            while dw.engine_stats()["free_pages"] != 63 and time.monotonic() - t0 < 30:
                await asyncio.sleep(0.01)
            return first, rest, dw.engine_stats(), dw.headroom()
        finally:
            await dw.stop()

    first, rest, stats, head = run(go())
    assert first[0] == 5
    assert len(first) + sum(len(b) for b in rest) < 90
    assert stats["free_pages"] == 63 and head["free_slots"] == 2


def test_decode_block_chaos_point_and_lost_pages(rt, models, monkeypatch):
    """The llm.decode_block chaos point fires once per streamed block (an
    injected error ends the stream typed), and pages whose sealed bytes
    are gone reach the caller as KVShipError, the scheduler's re-prefill
    signal."""
    from ray_tpu_torch.core.ref import ObjectLostError
    from ray_tpu_torch.devtools import chaos
    from ray_tpu_torch.llm.disagg import pools

    _, _, cfg, params = models
    kpool, vpool = teng.make_kv_pools(cfg, PS, 4, None, "cpu")
    m = ship_pages(kpool, vpool, [1, 2, 3], PROMPT, page_size=PS)

    def lost(*a, **kw):
        raise ObjectLostError("sealed copy gone")

    async def go():
        dw = DecodeWorker(cfg, params, **_engine_kw())
        try:
            ctrl = chaos.enable(chaos.ChaosPlan(seed=0, rules=[chaos.ChaosRule(
                point="llm.decode_block", action="error", after=1)]))
            got = []
            try:
                with pytest.raises(chaos.ChaosError):
                    async for blk in dw.decode_adopted_stream(PROMPT, m, None, 5,
                                                              max_tokens=MAX_NEW):
                        got.append(blk)
            finally:
                chaos.disable()
            with monkeypatch.context() as mp:
                mp.setattr(pools, "adopt_pages", lost)
                with pytest.raises(KVShipError, match="lost"):
                    await dw.decode_adopted(PROMPT, m, None, 5, max_tokens=MAX_NEW)
            return got, ctrl.signature()
        finally:
            await dw.stop()

    got, sig = run(go())
    assert len(got) == 1 and got[0][0] == 5
    assert [(point, action) for _, point, _, action in sig] == [("llm.decode_block", "error")]
