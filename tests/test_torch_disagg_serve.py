"""The port's ``DisaggLLMServer`` and ``build_disagg_deployment`` on its own
runtime and serve, on the CPU, held to the JAX package's disagg tests.

One module-scoped ``ray_tpu_torch.init`` with a small shm arena; pool
workers run as actors with ``device="cpu"``. Against JAX, on the same
inputs (tiny weights carried with ``params_from_numpy``, float32):

- greedy tokens through ``serve.run`` equal JAX's aggregated engine's,
  with the prefix cache missed and hit (``tests/test_disagg.py``'s
  ``test_disagg_matches_aggregated``);
- ``_pick_decode``, ``_worker_free_pages``, ``__serve_load__`` and the
  refusal before any prefill agree with JAX's scheduler on the same
  ledgers and signals (no runtime needed on either side);
- ``prefix_hint`` and cache lookups after spill and restore agree with
  JAX's cache on the same inserts.

The port's own behaviour, on the criteria of JAX's tests: spilled pages
restore byte-identical, pinned pages never spill, a manifest's refs survive
pickling to another actor, an adoption does not wait for its actor's busy
loop, a ref is awaited from a foreign loop, the stage windows reach the GCS
latency feed, the stream equals ``__call__`` and a cancel frees the decode
slot, a steal across two replicas of one share group costs no duplicate
prefill, pool workers lease and name their share of the card, and the
checked-in decode-kill plan completes every request.
"""

import asyncio
import dataclasses
import itertools
import json
import os
import pickle
import subprocess
import sys
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
from ray_tpu.llm.disagg import scheduler as jsched
from ray_tpu.models import llama as jllama
from ray_tpu.serve.exceptions import BackPressureError as JBackPressureError
from ray_tpu_torch import config, serve
from ray_tpu_torch.core import tiering
from ray_tpu_torch.llm import engine as teng
from ray_tpu_torch.llm.disagg import (
    DisaggLLMServer,
    PrefixCache,
    adopt_pages,
    build_disagg_deployment,
    prefix_hint,
    ship_pages,
    telemetry,
)
from ray_tpu_torch.llm.disagg import kv_plane as tkv
from ray_tpu_torch.llm.disagg import scheduler as tsched
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.serve.exceptions import BackPressureError

HERE = os.path.dirname(os.path.abspath(__file__))
KILL_PLAN = os.path.join(HERE, "plans", "llm_decode_kill.json")
PS = 8
MAX_NEW = 8
# two prompt sets with no first page in common: one per leg of the parity test
PROMPTS = {"full": [list(range(1, 20)), [7, 8, 9], list(range(40, 66))],
           "cached": [list(range(100, 119)), list(range(130, 147)),
                      [21, 22, 23, 24, 25, 26, 27, 28, 29]]}

# slowest case ~11 s alone (the decode-kill plan's subprocess, bounded by a
# 60 s timeout of its own); the module's set-up (JAX's tiny init, the
# runtime, the deployment's replica and pool workers) ~13 s
_module_limit, _test_limit = time_limits(module_s=90, test_s=75)


@pytest.fixture(scope="module")
def rt():
    torch.set_num_threads(1)
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers inherit it
    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    # one "card" as a resource only: pool workers can lease shares of it
    ray_tpu_torch.init(num_cpus=16, num_gpus=1, object_store_memory=128 << 20)
    yield ray_tpu_torch
    serve.shutdown()
    ray_tpu_torch.shutdown()
    config.set_config(cfg)
    if saved is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = saved


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, jparams, tcfg, params


def _server_kw(**kw):
    return dict(max_batch=2, page_size=PS, n_pages=64, max_seq_len=128,
                device="cpu", **kw)


@pytest.fixture(scope="module")
def handle(rt, models):
    """One serve.run deployment of the port's disagg stack on the carried
    tiny weights: a replica, one prefill and two decode workers."""
    _, _, cfg, params = models
    app = build_disagg_deployment(cfg, params=params, n_prefill=1, n_decode=2,
                                  **_server_kw())
    serve.run(app, name="disagg")
    yield serve.get_deployment_handle("DisaggLLMServer", "disagg")
    serve.delete("disagg")


def _jax_aggregated(jcfg, jparams, prompts, max_tokens):
    """JAX's aggregated continuous-batching engine, in process."""
    async def go():
        eng = JEngine(jparams, jcfg, max_batch=2, page_size=PS, n_pages=64,
                      max_seq_len=128)
        await eng.start()
        try:
            return await asyncio.gather(*[eng.generate(p, max_tokens=max_tokens)
                                          for p in prompts])
        finally:
            await eng.stop()

    return asyncio.run(go())


# ------------------------------------------------- greedy parity with JAX
@pytest.mark.parametrize("leg", ["full", "cached"])
def test_disagg_serve_greedy_matches_jax_aggregated(rt, models, handle, leg):
    """Through serve.run: the full-prefill leg (a cache miss) and the
    cached-prefix leg (the same prompts again: their full pages come from
    the cache and only the suffix is prefilled) give JAX's aggregated
    engine's greedy tokens."""
    jcfg, jparams, _, _ = models
    prompts = PROMPTS[leg]
    want = _jax_aggregated(jcfg, jparams, prompts, MAX_NEW)

    def ask():
        return rt.get([handle.remote({"prompt_tokens": p, "max_tokens": MAX_NEW})
                       for p in prompts], timeout=120)

    res = ask()
    assert all(r["usage"]["cached_prefix_tokens"] == 0 for r in res), res
    if leg == "cached":
        res = ask()
        assert [r["usage"]["cached_prefix_tokens"] for r in res] == \
            [(len(p) - 1) // PS * PS for p in prompts]
    assert [r["completion_tokens"] for r in res] == want
    st = rt.get(handle.stats.remote(), timeout=60)
    assert st["duplicate_prefills"] == 0 and st["backpressured"] == 0
    assert st["kv_plane"]["kv_array_bytes"] > 10 * st["kv_plane"]["kv_driver_bytes"]


# ------------------------------------------- admission and routing vs JAX
def _bare(cls, pkg_cache, *, est_pages, est_tokens, signals, capacity=7,
          max_tokens=4):
    """A scheduler built by ``__new__`` on the given ledgers (JAX's
    test_scheduler_backpressure_before_prefill template)."""
    s = cls.__new__(cls)
    s.PS = PS
    s.default_max_tokens = max_tokens
    s.max_attempts = 2
    s.decode_pool = [object() for _ in est_pages]
    s._capacity = capacity
    s._est_pages = list(est_pages)
    s._est_tokens = list(est_tokens)
    s._signals = [_signal(*x) if x else None for x in signals]
    s._foreign = {}
    s._share_group = None
    s._sig_task = None
    s._last_req_ts = 0.0
    s.signal_refresh_s = 0.2
    s._pool_tmpls = {}
    s._dw_rr = itertools.count()
    s.backpressured = 0
    s.requests = 0
    s.cache = pkg_cache(PS)
    s.prefills = []

    async def no_prefill(*a, **kw):  # admission must refuse before this
        s.prefills.append(a)
        raise AssertionError("prefill ran")

    s._prefill = no_prefill
    return s


def _signal(tif, free, est_t, est_p, age=0.0):
    return {"tokens_in_flight": tif, "free_pages": free, "est_at_tokens": est_t,
            "est_at_pages": est_p, "ts": time.monotonic() - age}


# (tokens_in_flight, free_pages, est_at_tokens, est_at_pages, age in s) per
# worker, or None: a signal older than 2 s is stale to both schedulers
LEDGERS = {
    "no_signals": dict(est_pages=[2, 5, 1], est_tokens=[30, 4, 9],
                       signals=[None, None, None]),
    "fresh_signals": dict(est_pages=[3, 1, 4], est_tokens=[12, 40, 5],
                          signals=[(2, 6, 10, 3, 0.0), (50, 3, 40, 0, 0.0),
                                   (0, 7, 0, 0, 0.0)]),
    "stale_signal": dict(est_pages=[1, 1], est_tokens=[8, 8],
                         signals=[(0, 6, 0, 0, 5.0), (20, 6, 8, 1, 0.0)]),
    "nearly_full": dict(est_pages=[6, 7], est_tokens=[0, 0], signals=[None, None]),
}


@pytest.mark.parametrize("ledger", sorted(LEDGERS))
def test_admission_and_routing_match_jax(ledger):
    """On the same ledgers and signals the port's and JAX's schedulers pick
    the same decode workers (over page needs, exclusions and round-robin
    starts), see the same free pages and report the same serve load; a
    request the pools cannot seat is refused with BackPressureError by
    both, before any prefill."""
    kw = LEDGERS[ledger]
    t = _bare(tsched.DisaggLLMServer, PrefixCache, **kw)
    j = _bare(jsched.DisaggLLMServer, jpc.PrefixCache, **kw)
    n = len(kw["est_pages"])
    assert [t._worker_free_pages(i) for i in range(n)] == \
        [j._worker_free_pages(i) for i in range(n)]
    assert [t._worker_load(i) for i in range(n)] == [j._worker_load(i) for i in range(n)]
    assert t.__serve_load__() == j.__serve_load__()
    picks = []
    for need in range(0, 9):
        for excl in ({}, {0}, {1}, set(range(n))):
            a, b = t._pick_decode(need, set(excl)), j._pick_decode(need, set(excl))
            assert a == b, (need, excl)
            picks.append(a)
    if ledger != "nearly_full":
        assert any(p is not None for p in picks)
    big = {"prompt_tokens": list(range(40)), "max_tokens": 16}  # 7 pages
    for s, exc in ((t, BackPressureError), (j, JBackPressureError)):
        with pytest.raises(exc) as ei:
            asyncio.run(s(dict(big)))
        assert ei.value.retry_after_s > 0
        assert s.backpressured == 1 and s.prefills == [] and s.requests == 1


# ------------------------------------------------ pool workers' cards
@pytest.mark.parametrize("n,share,visible,want", [
    (3, 1 / 3, ["0"], [["0"], ["0"], ["0"]]),
    (4, 0.5, ["2", "5"], [["2"], ["2"], ["5"], ["5"]]),
    (3, 0.25, None, [["0"], ["0"], ["0"]]),
    (2, 1.0, ["0", "1"], [None, None]),
    (3, 0.5, ["0"], RuntimeError),
])
def test_share_cards_name_one_card_each(monkeypatch, n, share, visible, want):
    """Pool workers that lease a share of a card are told which card to
    set (packed in order onto the visible cards, as many to a card as the
    share allows); whole cards are pinned by the lease; too few cards
    raise."""
    from ray_tpu_torch.accelerators import GPUAcceleratorManager

    monkeypatch.setattr(GPUAcceleratorManager,
                        "get_current_process_visible_accelerator_ids",
                        staticmethod(lambda: visible))
    monkeypatch.setattr(GPUAcceleratorManager, "get_current_node_num_accelerators",
                        staticmethod(lambda: 1))
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="cards"):
            tsched._share_cards(n, share)
    else:
        assert tsched._share_cards(n, share) == want


def test_pool_resources_lease_a_share_of_the_card(rt, models):
    """pool_resources={"GPU": share} leases that share of the card for each
    pool worker while the replica's pools live, and gives it back at
    shutdown."""
    _, _, cfg, params = models

    async def go():
        s = DisaggLLMServer(cfg, params, n_prefill=1, n_decode=2,
                            pool_resources={"GPU": 0.25}, **_server_kw())
        try:
            out = await s({"prompt_tokens": list(range(1, 12)), "max_tokens": 3})
            return out, rt.available_resources().get("GPU", 0.0)
        finally:
            await s.shutdown()

    out, held = asyncio.run(go())
    assert len(out["completion_tokens"]) == 3
    assert held == pytest.approx(0.25)  # three workers hold 0.75 of the one card
    deadline = time.monotonic() + 20
    while rt.available_resources().get("GPU", 0.0) < 1.0 and time.monotonic() < deadline:
        time.sleep(0.2)
    assert rt.available_resources().get("GPU", 0.0) == pytest.approx(1.0)


# --------------------------------------------- prefix cache spill vs JAX
def _fake(entry_cls, manifest_cls, tokens):
    return manifest_cls(token_ids=tuple(tokens), page_size=PS, kv_dtype="native",
                        pages=[entry_cls(refs={}, nbytes=100)
                               for _ in range(len(tokens) // PS)])


def _spill_script(cache_cls, entry_cls, manifest_cls):
    """test_tiering.py's spilled-radix-hit sequence on fake pages: inserts,
    a shm hit, spill_all, tier-1 hits, a capacity squeeze, invalidation."""
    c = cache_cls(PS, capacity_bytes=1 << 20, spill=True, spill_cold_after_s=0.0)
    shared = list(range(1, 1 + 2 * PS))
    prompts = [shared + [50 + i] * PS + [9] for i in range(3)] + [list(range(200, 203))]
    obs = [prefix_hint(p, page_size=PS, n_pages=2) for p in prompts]
    for p in prompts:
        obs.append(c.insert(_fake(entry_cls, manifest_cls, p)))

    def look(p):
        m = c.lookup(p, max_tokens=len(p) - 1)
        obs.append(None if m is None else (m.n_pages, m.token_ids,
                                           [e.tier for e in m.pages]))
        c.release(m)

    for p in prompts:
        look(p)
    obs.append(c.spill_all())
    obs.append(c.stats())
    for p in prompts:
        look(p)  # tier-1 hits: the pages come back to the tier-0 ledger
    c.capacity_bytes = 250  # pressure: the LRU frontier spills again
    c.insert(_fake(entry_cls, manifest_cls, list(range(300, 300 + 2 * PS))))
    obs.append(c.stats())
    obs.append(c.invalidate(prompts[0]))
    look(prompts[0])
    obs.append(c.stats())
    return obs


def test_prefix_hint_and_spilled_lookups_match_jax():
    """prefix_hint and every lookup, tier leg and stats reading along the
    same inserts, spill_all, tier-1 hits and squeeze agree with JAX's
    cache (both standalone: the tier legs are accounting marks)."""
    jobs = _spill_script(jpc.PrefixCache, jkv.KVPageEntry, jkv.KVPageManifest)
    tobs = _spill_script(PrefixCache, tkv.KVPageEntry, tkv.KVPageManifest)
    assert tobs == jobs
    st = tobs[-1]
    assert st["spill"] and st["spills"] > 0 and st["tier1_hits"] > 0


# ------------------------------------------------------- the arena leg
def _filled_pools(kv_dtype, n_pages=8, seed=0):
    kpool, vpool = teng.make_kv_pools(tllama.LlamaConfig.tiny(), PS, n_pages,
                                      kv_dtype, "cpu")
    g = torch.Generator().manual_seed(seed)
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
def test_kv_page_spill_restore_byte_identical(rt, kv_dtype):
    """Pages spilled to tier-1 restore byte-identical through adopt_pages:
    the staging tracker stamps every entry's tier leg on spill, the
    batched adopt promotes it back and the ledger counts the restore."""
    core = rt.get_core()
    kpool, vpool = _filled_pools(None if kv_dtype == "native" else kv_dtype, seed=7)
    m = ship_pages(kpool, vpool, [3, 5], list(range(1, 2 * PS + 1)), page_size=PS,
                   kv_dtype=kv_dtype)
    oids = [ref.id for p in m.pages for ref in p.refs.values()]
    res = core.spill_objects(oids)
    assert res and all(v["ok"] for v in res.values()), res
    assert all(p.tier == tiering.TIER_DISK and p.spill_path for p in m.pages)
    assert not any(core.store.contains(o) for o in oids)
    before = telemetry.counters()
    k_stack, v_stack = adopt_pages(m)
    for pool, stack in ((kpool, k_stack), (vpool, v_stack)):
        for name, t in _parts(pool).items():
            assert torch.equal((stack[name] if name else stack), t[:, [3, 5]])
    assert all(p.tier == tiering.TIER_SHM for p in m.pages)
    after = telemetry.counters()
    assert after["pages_restored"] > before["pages_restored"]
    assert after["kv_disk_bytes"] > before["kv_disk_bytes"]


def test_pinned_pages_never_spill(rt):
    """A pinned path is invisible to the spill provider and survives
    spill_all; released, the frontier recedes leaf-upward and the bytes
    leave the arena, restorable on read."""
    core = rt.get_core()
    page = np.arange(2048, dtype=np.float32)
    pages = [tkv.KVPageEntry(refs={"k": core.put_value(page.copy(), prefer_shm=True),
                                   "v": core.put_value(page.copy(), prefer_shm=True)},
                             nbytes=2 * page.nbytes) for _ in range(2)]
    toks = list(range(0, 2 * PS))
    m = tkv.KVPageManifest(token_ids=tuple(toks), page_size=PS, kv_dtype="native",
                           pages=pages)
    c = PrefixCache(PS, capacity_bytes=1 << 30, spill=True, spill_cold_after_s=0.0)
    c.insert(m)
    pinned = c.lookup(toks)
    time.sleep(0.05)
    assert c._spill_candidates(1 << 30, 0.0) == []
    assert c.spill_all() == 0
    assert all(p.tier == tiering.TIER_SHM for p in m.pages)
    c.release(pinned)
    assert len(c._spill_candidates(1 << 30, 0.0)) == 2  # the leaf's k and v
    assert c.spill_all() == 2
    assert all(p.tier == tiering.TIER_DISK for p in m.pages)
    assert not core.store.contains(m.pages[0].refs["k"].id)
    np.testing.assert_array_equal(rt.get(m.pages[0].refs["k"]), page)


def test_manifest_refs_survive_pickling_to_another_actor(rt):
    """A pickled manifest carries its refs on the borrower protocol: after
    the shipping side drops its copy, a local unpickle reads the bytes and
    another actor adopts the manifest into the same stacks."""
    class Adopter:
        def adopt(self, m):
            from ray_tpu_torch.llm.disagg import adopt_pages

            return adopt_pages(m)

    kpool, vpool = _filled_pools("bf16", seed=3)
    m = ship_pages(kpool, vpool, [2, 6], list(range(1, 2 * PS + 1)), page_size=PS,
                   kv_dtype="bf16")
    actor = rt.remote(Adopter).remote()
    k, v = rt.get(actor.adopt.remote(m), timeout=60)
    m2 = pickle.loads(pickle.dumps(m))
    assert m2.n_pages == 2 and m2.pages[0].nbytes > 0
    raw = rt.get(m2.pages[1].refs["k"])
    assert raw.dtype == np.uint16  # bf16 sealed as its bit pattern
    assert torch.equal(tkv._from_host(np.array(raw)), kpool[:, 6])
    assert torch.equal(k, kpool[:, [2, 6]]) and torch.equal(v, vpool[:, [2, 6]])
    rt.kill(actor)


def test_adoption_does_not_wait_for_a_busy_actor_loop(rt):
    """A decode worker adopts on a pool thread while its loop dispatches
    decode blocks: pages sealed on this node are read without a hop onto
    that loop, so an adoption finishes while the loop is held in 0.3 s
    slices (a borrowed ref's api.get there took seconds)."""

    class Busy:
        async def hold(self, secs):
            t_end = time.monotonic() + secs
            while time.monotonic() < t_end:
                time.sleep(0.3)  # holds the loop, as a decode block's dispatch does
                await asyncio.sleep(0)

        async def adopt(self, m):
            from ray_tpu_torch.llm.disagg import adopt_pages

            def go():
                t0 = time.perf_counter()
                k, _ = adopt_pages(m)
                return time.perf_counter() - t0, k

            return await asyncio.get_running_loop().run_in_executor(None, go)

    kpool, vpool = _filled_pools(None, n_pages=16, seed=5)
    m = ship_pages(kpool, vpool, list(range(1, 13)), list(range(12 * PS)),
                   page_size=PS)
    actor = rt.remote(Busy).options(max_concurrency=4).remote()
    rt.get(actor.adopt.remote(m), timeout=60)  # the worker's imports, warm
    held = actor.hold.remote(4.0)
    time.sleep(0.5)
    secs, k = rt.get(actor.adopt.remote(m), timeout=60)
    assert torch.equal(k, kpool[:, 1:13])
    assert secs < 1.0, secs
    rt.get(held, timeout=60)
    rt.kill(actor)


def test_await_ref_from_a_foreign_loop(rt):
    """Awaiting an actor call's ref from an asyncio loop that is not the
    core loop (a scheduler run by the driver, as the steal test does)
    bridges to the core loop (test_disagg.py's
    test_await_ref_from_driver_loop)."""

    class Echo:
        async def hi(self, x):
            return x + 1

    a = rt.remote(Echo).options(max_concurrency=4).remote()

    async def main():
        one = await a.hi.remote(1)
        many = await asyncio.gather(*(a.hi.remote(i) for i in range(4)))
        return one, many

    assert asyncio.run(main()) == (2, [1, 2, 3, 4])
    rt.kill(a)


def _llm_windows(core):
    """Every process's published ``<worker>.llm`` latency window."""
    keys = core._run_sync(core.gcs.call("kv_keys", {"ns": "latency", "prefix": ""}),
                          timeout=30)
    keys = [k for k in keys or () if k.endswith(".llm")]
    blobs = core._run_sync(core.gcs.call("kv_multi_get", {"ns": "latency", "keys": keys}),
                           timeout=30) if keys else {}
    stages: dict = {}
    for blob in (blobs or {}).values():
        for name, vals in pickle.loads(blob)["stages"].items():
            stages.setdefault(name, []).extend(vals)
    return stages


def test_stage_telemetry_reaches_the_latency_feed(rt, models):
    """A disagg request fills prefill_queue, kv_ship, decode_queue, ttft and
    tpot, each in the process that runs its leg, and every process
    publishes its window to the GCS latency namespace; the recorder
    names the serving stages, and a confirmed publish parks the source."""
    from ray_tpu_torch.utils import recorder

    for sid, name in ((recorder.PREFILL_QUEUE, "prefill_queue"),
                      (recorder.KV_SHIP, "kv_ship"),
                      (recorder.DECODE_QUEUE, "decode_queue")):
        assert recorder.STAGE_NAMES[sid] == name
    _, _, cfg, params = models

    core = rt.get_core()
    want = {"prefill_queue", "kv_ship", "decode_queue", "ttft", "tpot"}

    async def go():
        s = DisaggLLMServer(cfg, params, n_prefill=1, n_decode=1, **_server_kw())
        try:
            out = await s({"prompt_tokens": list(range(1, 20)), "max_tokens": 6})
            # the pool workers publish on their own 1 s flush: read the
            # feed while they live
            deadline, stages = time.monotonic() + 20, {}
            while time.monotonic() < deadline:
                stages = await asyncio.to_thread(_llm_windows, core)
                if want <= {k for k, v in stages.items() if v}:
                    break
                await asyncio.sleep(0.5)
            return out, stages
        finally:
            await s.shutdown()

    out, stages = asyncio.run(go())
    assert len(out["completion_tokens"]) == 6
    assert telemetry.stage_window(telemetry.TTFT) and telemetry.stage_window(telemetry.TPOT)
    assert want <= {k for k, v in stages.items() if v}, sorted(stages)
    snap = telemetry.snapshot_if_fresh()
    if snap is not None:
        assert "ttft" in snap["stages"]
        telemetry.mark_published()
        assert telemetry.snapshot_if_fresh() is None


# ---------------------------------------------------------------- stream
def test_stream_equals_call_and_cancel_frees_the_slot(rt, handle):
    """stream()'s deltas concatenate to __call__'s tokens (through the
    prefix cache), and a client cancel frees the decode slot: tokens in
    flight drain to zero with no duplicate prefill."""
    prompt = list(range(60, 79))
    req = {"prompt_tokens": prompt, "max_tokens": 12}
    ref = rt.get(handle.remote(dict(req)), timeout=120)["completion_tokens"]
    assert len(ref) == 12
    deltas = list(handle.stream.stream_chunks(dict(req)))
    toks = [t for d in deltas for t in d["tokens"]]
    assert deltas[-1].get("done") is True and toks == ref
    assert deltas[-1]["usage"]["cached_prefix_tokens"] > 0
    s = handle.stream.stream_chunks({"prompt_tokens": prompt, "max_tokens": 100})
    assert next(s)["tokens"]
    s.close()
    deadline, st = time.monotonic() + 30, None
    while time.monotonic() < deadline:
        st = rt.get(handle.stats.remote(), timeout=60)
        sigs = [x for x in st["decode_signals"] if x]
        if sigs and all(x["tokens_in_flight"] == 0 for x in sigs):
            break
        time.sleep(0.3)
    else:
        pytest.fail(f"decode never drained: {st}")
    assert st["duplicate_prefills"] == 0, st


# -------------------------------------------------- cross-replica steal
def test_cross_replica_steal_zero_duplicate_prefill(rt, models):
    """A saturated replica's queued request migrates to an idle sibling's
    decode worker through the share group's GCS registry, re-adopting the
    same manifest: no errors, no duplicate prefill
    (test_spec_decode.py's test_cross_replica_steal_zero_duplicate_prefill)."""
    _, _, cfg, params = models
    rng = np.random.default_rng(3)

    async def go():
        kw = dict(n_prefill=1, n_decode=1, page_size=PS, max_seq_len=128,
                  decode_share_group="t-steal", signal_refresh_s=0.05, device="cpu")
        a = DisaggLLMServer(cfg, params, max_batch=2, n_pages=17, **kw)
        b = DisaggLLMServer(cfg, params, max_batch=4, n_pages=64, **kw)
        try:
            # one request each warms both registries, then they discover
            await b({"prompt_tokens": list(range(1, 9)), "max_tokens": 4})
            await a({"prompt_tokens": list(range(1, 9)), "max_tokens": 4})
            await asyncio.sleep(0.5)
            reqs = [list(map(int, rng.integers(1, 256, 8))) + [j] for j in range(12)]
            outs = await asyncio.gather(
                *(a({"prompt_tokens": r, "max_tokens": 6}) for r in reqs),
                return_exceptions=True)
            return outs, await a.stats(), await b.stats()
        finally:
            await a.shutdown()
            await b.shutdown()

    outs, sa, sb = asyncio.run(go())
    errs = [o for o in outs if isinstance(o, Exception)]
    assert not errs, errs
    assert sa["stolen"] > 0 and sa["stolen_tokens"] > 0, sa
    assert sa["duplicate_prefills"] == 0 and sb["duplicate_prefills"] == 0
    assert all(len(o["completion_tokens"]) == 6 for o in outs)


# ------------------------------------------------- seeded decode-kill plan
_CHAOS_CHILD = r"""
import asyncio, json
import ray_tpu_torch
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.llm.disagg.scheduler import DisaggLLMServer

cfg = LlamaConfig(vocab_size=512, d_model=128, n_heads=4, n_layers=2,
                  n_kv_heads=4, d_ff=256, max_seq_len=512, dtype="float32")
SHARED = list(range(1, 17))  # two full pages at page_size 8

async def main():
    s = DisaggLLMServer(cfg, n_prefill=1, n_decode=2, max_batch=4,
                        page_size=8, n_pages=64, max_seq_len=128, device="cpu")
    ok = err = 0
    for wave in range(3):
        reqs = [SHARED + [100 + wave, 200 + j] for j in range(4)]
        res = await asyncio.gather(
            *(s({"prompt_tokens": r, "max_tokens": 6}) for r in reqs),
            return_exceptions=True)
        for r in res:
            if isinstance(r, Exception):
                err += 1
                print("ERR", type(r).__name__, r, flush=True)
            else:
                ok += 1
    st = await s.stats()
    await s.shutdown()
    print("RES=" + json.dumps({
        "ok": ok, "err": err,
        "duplicate_prefills": st["duplicate_prefills"],
        "decode_retries": st["decode_retries"],
        "hit_rate": st["prefix_cache"]["hit_rate"],
        "kv_driver_bytes": st["kv_plane"]["kv_driver_bytes"],
        "kv_array_bytes": st["kv_plane"]["kv_array_bytes"]}), flush=True)

ray_tpu_torch.init(num_cpus=8, object_store_memory=64 << 20)
asyncio.run(main())
ray_tpu_torch.shutdown()
"""


def test_decode_kill_plan_completes_every_request(tmp_path):
    """The checked-in seeded plan (tests/plans/llm_decode_kill.json, as it
    is) SIGKILLs a decode worker mid-adoption and drops one manifest's
    pages; every request still completes, with bounded duplicate prefill
    work, the cache carrying most requests, and pages moved off the RPC
    plane (test_disagg.py's test_decode_kill_plan_completes_every_request)."""
    from ray_tpu_torch.devtools.chaos.cli import read_events

    log_dir = str(tmp_path / "chaos")
    env = {**os.environ, "RT_CHAOS_ENABLED": "1", "RT_CHAOS_PLAN": KILL_PLAN,
           "RT_CHAOS_LOG_DIR": log_dir, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(HERE),
                                          os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", _CHAOS_CHILD], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RES=")][0]
    res = json.loads(line[4:])
    assert res["ok"] == 12 and res["err"] == 0, res
    assert res["duplicate_prefills"] <= 2, res
    assert res["hit_rate"] > 0.5, res
    assert res["kv_array_bytes"] > 50 * res["kv_driver_bytes"], res
    events = read_events(log_dir)
    kills = [e for e in events if e["action"] == "kill" and e["point"] == "llm.kv_ship"]
    assert kills and kills[0]["ctx"]["role"] == "decode", events
