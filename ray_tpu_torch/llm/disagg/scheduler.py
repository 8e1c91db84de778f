"""DisaggLLMServer: the deployment that composes the planes.

Counterpart of ``ray_tpu/llm/disagg/scheduler.py``, on the port's serve and
runtime. One serve replica of this class fronts TWO actor pools (its private
prefill and decode workers) plus a replica-local :class:`PrefixCache`:

    request -> [admission: decode page headroom]
            -> [prefix cache lookup (pinned)]
            -> prefill pool   (full prompt, or suffix over cached pages)
            -> KV-page plane  (manifest: metadata through RPC, pages via shm)
            -> decode pool    (adopt + continuous-batching ring)
            -> [cache insert of the new full pages] -> response

Admission control is page-headroom based: the scheduler tracks an
optimistic in-flight page estimate per decode worker and refuses — with
the serve layer's typed :class:`BackPressureError`, carrying
``retry_after_s`` — before any prefill work is spent on a request the
decode pool cannot seat. ``EngineFull`` therefore never reaches a
caller: the serve router treats the refusal as never-dispatched and
retries/hedges to another replica.

Fault story (the decode-death window ``tests/plans/llm_decode_kill.json``
exercises): a decode worker dying mid-request surfaces as an
ActorError-class failure. The prompt's KV pages live in the PREFILL
workers' shm arenas — they survive the death — so recovery is manifest
RE-ADOPTION on another decode worker, zero duplicate prefill FLOPs.
Only when the pages themselves are gone (KVShipError / ObjectLostError:
injected loss, arena eviction on a dead node) does the scheduler
re-prefill, counting it in ``duplicate_prefills`` so tests can bound the
wasted work.

The pools run on the card: each pool worker is an actor that leases a
share of a card (``pool_resources``, see :func:`build_disagg_deployment`)
and draws its weights there unless given them.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import math
import pickle
import time
import uuid

from ray_tpu_torch.core.ref import (
    ActorError,
    ObjectLostError,
    WorkerCrashedError,
)
from ray_tpu_torch.llm.disagg import telemetry
from ray_tpu_torch.llm.disagg.kv_plane import KVPageManifest, KVShipError
from ray_tpu_torch.llm.disagg.pools import DecodeWorker, PrefillWorker
from ray_tpu_torch.llm.disagg.prefix_cache import PrefixCache

log = logging.getLogger(__name__)

#: GCS kv namespace of the cross-replica decode registry
#: (``decode_share_group``): each DisaggLLMServer replica publishes its
#: decode workers' handles + live signals under
#: ``<group>/<replica-uuid>`` so siblings can steal onto idle rings
_SHARE_NS = "llm_decode"
#: a sibling record older than this is a dead replica, not a target
_SHARE_TTL_S = 5.0


def _share_cards(n: int, share: float) -> list:
    """The card each of ``n`` pool workers leasing ``share`` of a card
    sets for itself (a share pins none in the runtime's lease), packed in
    order onto the cards this process sees, as TorchTrainer's shares are;
    ``None`` each for whole cards, which the lease pins."""
    from ray_tpu_torch.accelerators import GPUAcceleratorManager

    if not 0 < share < 1:
        return [None] * n
    visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
    if visible is None:
        visible = [str(i) for i in range(
            GPUAcceleratorManager.get_current_node_num_accelerators())]
    need = math.ceil(n * share - 1e-9)
    if need > len(visible):
        raise RuntimeError(f"{n} pool workers of GPU={share} need {need} "
                           f"cards; {len(visible)} visible")
    return [[visible[int(i * share + 1e-9)]] for i in range(n)]


def _is_worker_death(e: BaseException) -> bool:
    from ray_tpu_torch.utils import rpc

    return isinstance(e, (ActorError, WorkerCrashedError,
                          rpc.ConnectionLost))


class DisaggLLMServer:
    """Deployment class; bind with a model config + params source (the
    LLMEngineServer surface, served disaggregated).

    ``device`` is where the pool workers build (None: the card, which
    raises in a worker without a CUDA device; CPU tests pass "cpu").
    ``pool_resources`` places each pool worker: a ``"GPU"`` key leases
    that share of a card for it, as ``num_gpus`` does for an actor, and
    the worker sees its card as ``cuda:0`` through
    ``CUDA_VISIBLE_DEVICES`` (the lease pins a whole card; for a share,
    the scheduler names the card, packing its workers onto the visible
    cards in order, and the worker sets it before CUDA's first call). On
    the card without a ``"GPU"`` key, the workers of one replica split
    one card evenly (``1 / (n_prefill + n_decode)`` each).
    """

    #: the pool actors' classes (a subclass may add methods to them)
    prefill_worker_cls = PrefillWorker
    decode_worker_cls = DecodeWorker

    def __init__(self, model_config, params=None, params_fn=None, *,
                 n_prefill: int = 2, n_decode: int = 2,
                 max_batch: int = 8, page_size: int = 16,
                 n_pages: int = 256, max_seq_len: int = 512,
                 eos_id: int | None = None, kv_dtype: str | None = None,
                 lora_adapters: dict | None = None, lora_rank: int = 8,
                 default_max_tokens: int = 32,
                 prefix_cache_bytes: int = 64 << 20,
                 prefill_n_pages: int | None = None,
                 max_wave: int = 8, wave_wait_s: float = 0.004,
                 max_attempts: int = 3, decode_max_restarts: int = 2,
                 pool_resources: dict | None = None,
                 spec_enable: bool = False, spec_k: int = 4,
                 spec_ngram: int = 2, spec_drafter=None,
                 decode_share_group: str | None = None,
                 signal_refresh_s: float = 0.2, device=None):
        import torch

        import ray_tpu_torch

        self.PS = page_size
        self.n_pages = n_pages
        self.default_max_tokens = default_max_tokens
        self.max_attempts = max_attempts
        from ray_tpu_torch.config import get_config
        _cfg = get_config()
        # tiering opt-in rides config (RT_PREFIX_CACHE_SPILL et al): the
        # replica's cache spills cold pages to the raylet's tier-1
        # instead of dropping them, so a refill-after-evict costs one
        # disk read instead of a duplicate prefill
        self.cache = PrefixCache(page_size,
                                 capacity_bytes=prefix_cache_bytes,
                                 kv_dtype=kv_dtype or "native",
                                 spill=bool(_cfg.prefix_cache_spill),
                                 tier1_capacity_bytes=int(
                                     _cfg.prefix_cache_tier1_bytes),
                                 spill_cold_after_s=float(
                                     _cfg.spill_cold_after_s))
        on_card = device is None or torch.device(device).type == "cuda"
        model_kw = dict(kv_dtype=kv_dtype, lora_adapters=lora_adapters,
                        lora_rank=lora_rank,
                        device="cuda" if device is None else device)
        # prefill pool: async actors with enough concurrency for calls to
        # coalesce into padded waves; staging pools freed per wave
        # pool placement (e.g. {"bee": 0.25} / host resources): pin the
        # pool workers beside their replica so pool hops ride the
        # same-node shm rings and KV adoption stays zero-copy; on the card
        # each worker leases its share of one
        res = dict(pool_resources or {})
        if on_card:
            res.setdefault("GPU", 1.0 / (n_prefill + n_decode))
        pool_opts = {"resources": res} if res else {}
        cards = (_share_cards(n_prefill + n_decode, float(res.get("GPU", 0)))
                 if on_card else [None] * (n_prefill + n_decode))
        pf_cls = ray_tpu_torch.remote(self.prefill_worker_cls).options(
            max_concurrency=max(16, 4 * max_wave), **pool_opts)
        self.prefill_pool = [
            pf_cls.remote(model_config, params, params_fn,
                          page_size=page_size,
                          n_pages=prefill_n_pages or n_pages,
                          max_wave=max_wave, wave_wait_s=wave_wait_s,
                          seed=i, gpu_ids=cards[i], **model_kw)
            for i in range(n_prefill)]
        # decode pool: restartable (a killed worker rejoins the rotation;
        # in-flight requests re-adopt elsewhere meanwhile)
        dw_cls = ray_tpu_torch.remote(self.decode_worker_cls).options(
            max_concurrency=max(16, 2 * max_batch),
            max_restarts=decode_max_restarts, **pool_opts)
        self.decode_pool = [
            dw_cls.remote(model_config, params, params_fn,
                          max_batch=max_batch, page_size=page_size,
                          n_pages=n_pages, max_seq_len=max_seq_len,
                          eos_id=eos_id, spec_enable=spec_enable,
                          spec_k=spec_k, spec_ngram=spec_ngram,
                          spec_drafter=spec_drafter,
                          gpu_ids=cards[n_prefill + i], **model_kw)
            for i in range(n_decode)]
        # optimistic in-flight page estimate per decode worker — the
        # admission-control floor (refreshed implicitly: reservations
        # are returned in the same finally that awaited the decode) —
        # plus a tokens-in-flight ledger and the decode workers' LIVE
        # signals (tokens_in_flight/free_pages probed by _signal_loop):
        # admission ranks workers by decode tokens still owed, not by
        # request counts
        self._est_pages = [0] * n_decode
        self._est_tokens = [0] * n_decode
        self._signals: list[dict | None] = [None] * n_decode
        self._capacity = n_pages - 1  # page 0 is the junk page
        self._pf_rr = itertools.count()
        self._dw_rr = itertools.count()
        # frozen per-(pool actor, method) fast-lane templates (_pool_call)
        self._pool_tmpls: dict = {}
        # cross-replica decode batching (decode_share_group): sibling
        # replicas' decode workers, flattened as key -> {handle, signal}
        self._share_group = decode_share_group
        self.signal_refresh_s = float(signal_refresh_s)
        self._uuid = uuid.uuid4().hex[:12]
        self._foreign: dict[str, dict] = {}
        self._sig_task = None
        self._last_req_ts = 0.0
        self.duplicate_prefills = 0
        self.decode_retries = 0
        self.backpressured = 0
        self.requests = 0
        self.decode_tokens = [0] * n_decode  # per-ring traffic proof
        self.stolen = 0          # requests decoded on a sibling replica
        self.stolen_tokens = 0

    # ------------------------------------------------------------ routing
    def _worker_load(self, i: int) -> int:
        """Decode tokens still owed by worker ``i``: the live probed
        tokens_in_flight plus our own picks the probe hasn't seen yet
        (the router's inflight-at-probe subtraction, run against the
        token ledger instead of request counts)."""
        sig = self._signals[i]
        if sig is not None and time.monotonic() - sig["ts"] < 2.0:
            unseen = max(0, self._est_tokens[i] - sig["est_at_tokens"])
            return sig["tokens_in_flight"] + unseen
        return self._est_tokens[i]

    def _worker_free_pages(self, i: int) -> int:
        """Free-page headroom for worker ``i``: the optimistic ledger,
        tightened by the live signal when fresh (a shared ring — steal
        traffic from sibling replicas — burns pages our ledger never
        saw)."""
        free = self._capacity - self._est_pages[i]
        sig = self._signals[i]
        if sig is not None and time.monotonic() - sig["ts"] < 2.0:
            unseen = max(0, self._est_pages[i] - sig["est_at_pages"])
            free = min(free, sig["free_pages"] - unseen)
        return free

    def _pick_decode(self, n_need: int, exclude: set[int]) -> int | None:
        """Signal-first pick: among workers with page headroom, take the
        one owing the FEWEST decode tokens (tokens-in-flight + page
        headroom are the admission signals — a ring full of nearly-done
        requests outranks a shallow queue of long generations, which
        request counts get backwards); round-robin start for tie
        spread. None = no pool-wide headroom (backpressure)."""
        start = next(self._dw_rr) % len(self.decode_pool)
        best, best_load = None, None
        for off in range(len(self.decode_pool)):
            i = (start + off) % len(self.decode_pool)
            if i in exclude:
                continue
            if self._worker_free_pages(i) < n_need:
                continue
            load = self._worker_load(i)
            if best_load is None or load < best_load:
                best, best_load = i, load
        return best

    def _pick_foreign(self, n_need: int,
                      exclude: set[str]) -> tuple[str, object] | None:
        """Idlest sibling-replica decode worker with page headroom (the
        work-stealing leg): returns (key, actor handle) or None. The
        signals come from the sibling's own probe loop via the GCS
        registry — stale entries age out at discovery."""
        best = best_load = None
        for key, ent in self._foreign.items():
            if key in exclude:
                continue
            sig = ent.get("signal") or {}
            if sig.get("free_pages", 0) < n_need:
                continue
            load = sig.get("tokens_in_flight", 0)
            if best_load is None or load < best_load:
                best, best_load = (key, ent["handle"]), load
        return best

    # ---------------------------------------------------- decode signals
    def _ensure_signal_loop(self):
        """Lazy-start the probe loop (and retire it after 3s idle — the
        router's probe-pause idiom); restarted by the next request. A
        replica in a share group never retires it: its record in the
        registry is how siblings find its decode workers, and an idle
        replica is exactly the one they should steal onto (retired, its
        record would expire after ``_SHARE_TTL_S`` and the steal would
        turn into backpressure)."""
        self._last_req_ts = time.monotonic()
        if self._sig_task is None or self._sig_task.done():
            self._sig_task = asyncio.get_running_loop().create_task(
                self._signal_loop())

    async def _signal_loop(self):
        try:
            while (self._share_group
                   or time.monotonic() - self._last_req_ts < 3.0):
                for i, w in enumerate(self.decode_pool):
                    # snapshot the ledgers BEFORE the probe: anything we
                    # admit while the probe is in flight is "unseen"
                    est_t, est_p = self._est_tokens[i], self._est_pages[i]
                    try:
                        # bounded: a probe hung on a killed worker's
                        # half-broken lane must not wedge the loop (the
                        # respawned worker needs the NEXT probe)
                        hr = await asyncio.wait_for(
                            self._pool_call(w, "headroom", (), {}), 2.0)
                    except Exception:
                        continue  # dead/restarting worker: keep stale
                    self._signals[i] = {
                        "tokens_in_flight": int(
                            hr.get("tokens_in_flight", 0)),
                        "free_pages": int(hr.get("free_pages", 0)),
                        "est_at_tokens": est_t, "est_at_pages": est_p,
                        "ts": time.monotonic()}
                await self._share_sync()
                await asyncio.sleep(self.signal_refresh_s)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.debug("decode signal loop died", exc_info=True)

    async def _gcs(self, method: str, payload: dict):
        from ray_tpu_torch.core import api as _api

        core = _api.get_core()
        try:
            on_core = asyncio.get_running_loop() is core.loop
        except RuntimeError:
            on_core = False
        if on_core:
            return await core.gcs.call(method, payload)
        return await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
            core.gcs.call(method, payload), core.loop))

    async def _share_sync(self):
        """Publish our decode workers' handles + live signals to the
        share-group registry and refresh the sibling view. Handles
        pickle through the GCS kv like any actor arg; a steal then rides
        ``_pool_call`` (shm ring same-node, node tunnel cross-node)
        unchanged."""
        if not self._share_group:
            return
        try:
            rec = {"handles": list(self.decode_pool),
                   "signals": [self._signals[i] or {}
                               for i in range(len(self.decode_pool))],
                   "ts": time.time()}
            me = f"{self._share_group}/{self._uuid}"
            await self._gcs("kv_put", {"ns": _SHARE_NS, "key": me,
                                       "value": pickle.dumps(rec)})
            keys = await self._gcs("kv_keys", {
                "ns": _SHARE_NS, "prefix": f"{self._share_group}/"})
            keys = [k for k in (keys or []) if k != me]
            foreign: dict[str, dict] = {}
            if keys:
                blobs = await self._gcs("kv_multi_get",
                                        {"ns": _SHARE_NS, "keys": keys})
                for k, blob in (blobs or {}).items():
                    try:
                        sib = pickle.loads(blob)
                    except Exception:
                        continue
                    if time.time() - sib.get("ts", 0) > _SHARE_TTL_S:
                        continue
                    for j, h in enumerate(sib.get("handles", ())):
                        foreign[f"{k}#{j}"] = {
                            "handle": h,
                            "signal": (sib.get("signals") or [{}] * (j + 1)
                                       )[j] or {}}
            self._foreign = foreign
        except Exception:
            log.debug("decode share-group sync failed", exc_info=True)

    def __serve_load__(self) -> float:
        """The serve router's user-load probe hook: this replica's
        decode tokens-in-flight in request-equivalents, so the router's
        pow-2 choice (and handle-side admission) sees decode-plane
        pressure instead of raw request counts."""
        total = sum(self._worker_load(i)
                    for i in range(len(self.decode_pool)))
        return total / max(1, self.default_max_tokens)

    async def _pool_call(self, handle, method: str, args: tuple,
                         kwargs: dict):
        """Pool hop on the LOOP-side actor fast lane — the serve
        router's mechanism (``fast_actor_submit_loop``) composed inward
        (ROADMAP items 2/4): same-node pool workers ride the shm rings,
        cross-node ones the node tunnel, with per-call RPC fallback for
        anything the lane cannot carry. A broken lane surfaces as
        ``ConnectionLost``, which :func:`_is_worker_death` already
        classifies — the scheduler's own re-adopt/re-prefill retry owns
        replay, and both legs are idempotent by construction (re-prefill
        recomputes, re-adopt re-reads sealed pages). Sampled trace
        context rides the record's wire leg either way."""
        from ray_tpu_torch.core import api as _api
        from ray_tpu_torch.core.core_client import FastLaneDeclined

        core = _api.get_core()
        try:
            on_core = asyncio.get_running_loop() is core.loop
        except RuntimeError:
            on_core = False
        if on_core and getattr(core.cfg, "fastpath_enabled", False):
            key = (handle.actor_id, method)
            tmpl = self._pool_tmpls.get(key)
            if tmpl is None:
                tmpl = self._pool_tmpls[key] = core.actor_call_template(
                    handle.actor_id, method, 1, None)
            out = core.fast_actor_submit_loop(handle.actor_id, method,
                                              args, kwargs, tmpl)
            if out is not None:
                try:
                    return await core.fast_actor_await(out[0], out[1])
                except FastLaneDeclined:
                    pass  # stale method table: RPC below, lane survives
        return await getattr(handle, method).remote(*args, **kwargs)

    async def _pool_stream(self, handle, method, args, kwargs):
        """Streaming twin of :meth:`_pool_call`: yields the pool worker
        generator's items. Fast path = ONE "G"-chunked stream on the
        worker's ring/tunnel lane (``fast_actor_submit_stream``) — token
        deltas hop scheduler<-decode with no per-item ObjectRef; fallback
        = the per-item ObjectRef plane. A NEED_SLOW decline provably
        precedes execution, so the fallback re-dispatch never duplicates
        decode work."""
        from ray_tpu_torch.core import api as _api
        from ray_tpu_torch.core.core_client import FastLaneDeclined

        core = _api.get_core()
        try:
            on_core = asyncio.get_running_loop() is core.loop
        except RuntimeError:
            on_core = False
        if on_core and getattr(core.cfg, "fastpath_enabled", False):
            out = core.fast_actor_submit_stream(handle.actor_id, method,
                                                args, kwargs)
            if out is not None:
                agen = core.fast_actor_stream(out[0], out[1])
                try:
                    try:
                        async for item in agen:
                            yield item
                        return
                    except FastLaneDeclined:
                        pass  # stale method table: RPC below, nothing ran
                finally:
                    await agen.aclose()
        gen = getattr(handle, method).options(
            num_returns="streaming").remote(*args, **kwargs)
        try:
            async for ref in gen:
                (item,) = await core.get_async([ref])
                yield item
        finally:
            aclose = getattr(gen, "aclose", None)
            if aclose is not None:
                await aclose()

    def _backpressure(self, n_need: int):
        from ray_tpu_torch.serve.exceptions import BackPressureError

        self.backpressured += 1
        total_free = sum(self._capacity - e for e in self._est_pages)
        # drain estimate: decode frees pages as resident requests finish;
        # scale the hint by how oversubscribed the pools are
        raise BackPressureError(
            f"decode pools out of KV page headroom ({n_need} pages "
            f"needed, {total_free} free across {len(self.decode_pool)} "
            f"workers)",
            retry_after_s=min(2.0, 0.05 * max(1, n_need)),
        )

    # ------------------------------------------------------------ serving
    async def __call__(self, request: dict) -> dict:
        """{prompt_tokens, max_tokens?, temperature?, model?} ->
        {completion_tokens, usage} — the LLMEngineServer protocol."""
        toks = [int(t) for t in request["prompt_tokens"]]
        if not toks:
            raise ValueError("empty prompt")
        mt = int(request.get("max_tokens", self.default_max_tokens))
        temp = float(request.get("temperature", 0.0))
        adapter = request.get("model")
        t_arr = time.perf_counter_ns()
        self.requests += 1
        self._ensure_signal_loop()
        n_need = -(-(len(toks) + mt) // self.PS)
        if n_need > self._capacity:
            raise ValueError(
                f"request needs {n_need} KV pages but decode pools hold "
                f"{self._capacity}")
        excluded: set[int] = set()
        f_excluded: set[str] = set()
        prefix_m = None   # pinned cache manifest (release on every exit)
        manifest = extra = first = None
        t_first = None
        last_err = None
        try:
            for attempt in range(self.max_attempts + 1):
                widx = self._pick_decode(n_need, excluded)
                fkey = fhandle = None
                if widx is None:
                    # no local headroom: a queued-but-unadmitted request
                    # migrates to an idle SIBLING replica's decode ring
                    # (decode_share_group) — the same manifest re-adopts
                    # there, so the steal costs zero duplicate prefill
                    # FLOPs and rides _pool_call's fast lanes unchanged
                    picked = self._pick_foreign(n_need, f_excluded)
                    if picked is not None:
                        fkey, fhandle = picked
                if widx is None and fhandle is None and excluded:
                    # every worker burned by THIS request: let it retry
                    # anywhere (a restarted worker may be back) rather
                    # than dead-ending with headroom elsewhere
                    excluded.clear()
                    widx = self._pick_decode(n_need, excluded)
                if widx is None and fhandle is None:
                    self._backpressure(n_need)
                # reserve at PICK time, not after the prefill: concurrent
                # requests admitting against a zero estimate would all
                # pass and spend prefill work the decode pools cannot
                # seat — the exact waste admission control exists to stop
                if widx is not None:
                    self._est_pages[widx] += n_need
                    self._est_tokens[widx] += mt
                try:
                    if manifest is None:
                        try:
                            (manifest, extra, first,
                             prefix_m) = await self._prefill(
                                toks, temp, adapter)
                        except Exception as e:  # noqa: BLE001 — prefill leg
                            last_err = e
                            if isinstance(e, (KVShipError,
                                              ObjectLostError)):
                                # cached prefix pages vanished mid-adopt:
                                # drop the cached path, full re-prefill
                                self.cache.invalidate(toks)
                                prefix_m = None
                                continue
                            if _is_worker_death(e):
                                # a PREFILL actor died — retry the
                                # prefill; the decode pick stays valid
                                continue
                            raise
                        if attempt:
                            self.duplicate_prefills += 1
                            telemetry.count(duplicate_prefills=1)
                        if t_first is None:
                            t_first = time.perf_counter_ns()
                            telemetry.record(telemetry.TTFT,
                                             t_first - t_arr)
                    with telemetry.traced("disagg::decode"):
                        target = (self.decode_pool[widx]
                                  if widx is not None else fhandle)
                        out = await self._pool_call(
                            target, "decode_adopted",
                            (toks, manifest, extra, first),
                            dict(max_tokens=mt, temperature=temp,
                                 adapter=adapter))
                    if widx is not None:
                        self.decode_tokens[widx] += len(out)
                    else:
                        self.stolen += 1
                        self.stolen_tokens += len(out)
                    return self._finish(toks, out, manifest, extra,
                                        prefix_m, t_arr, t_first,
                                        widx if widx is not None
                                        else f"steal:{fkey}", attempt)
                except Exception as e:  # noqa: BLE001 — decode leg
                    last_err = e
                    if isinstance(e, (KVShipError, ObjectLostError)):
                        # the pages themselves are gone: drop the cached
                        # path and re-prefill (the bounded-duplicate leg)
                        self.cache.release(prefix_m)
                        self.cache.invalidate(toks)
                        prefix_m = manifest = extra = first = None
                        continue
                    if _is_worker_death(e):
                        # decode worker died holding the request; the
                        # pages survive in the prefill arenas — re-adopt
                        # the SAME manifest elsewhere
                        if widx is not None:
                            excluded.add(widx)
                        else:
                            f_excluded.add(fkey)
                            self._foreign.pop(fkey, None)
                        self.decode_retries += 1
                        continue
                    from ray_tpu_torch.serve.exceptions import BackPressureError

                    if isinstance(e, BackPressureError):
                        # headroom estimate was stale for this worker
                        if widx is not None:
                            excluded.add(widx)
                        else:
                            f_excluded.add(fkey)
                        continue
                    raise
                finally:
                    if widx is not None:
                        self._est_pages[widx] -= n_need
                        self._est_tokens[widx] -= mt
            raise last_err
        finally:
            self.cache.release(prefix_m)

    async def stream(self, request: dict):
        """Streaming disagg completion: ``{"tokens": [...]}`` deltas —
        one per fused decode block, hopping decode ring -> scheduler ->
        replica as "G" chunk records — then a terminal delta carrying
        ``usage``. Concatenated tokens are identical to ``__call__``'s
        ``completion_tokens``.

        Fault contract: initial routing (prefill + decode admission)
        reuses the bounded retry/steal machinery unchanged; once a delta
        has been consumed the stream is NEVER replayed — a decode-worker
        death mid-stream surfaces as a typed
        :class:`~ray_tpu_torch.serve.streaming.StreamBrokenError`. Abandoning
        the stream (client disconnect) cancels the decode — the slot and
        KV pages free at the next block boundary — with zero duplicate
        prefills spent."""
        from ray_tpu_torch.serve.exceptions import BackPressureError
        from ray_tpu_torch.serve.streaming import StreamBrokenError

        toks = [int(t) for t in request["prompt_tokens"]]
        if not toks:
            raise ValueError("empty prompt")
        mt = int(request.get("max_tokens", self.default_max_tokens))
        temp = float(request.get("temperature", 0.0))
        adapter = request.get("model")
        t_arr = time.perf_counter_ns()
        self.requests += 1
        self._ensure_signal_loop()
        n_need = -(-(len(toks) + mt) // self.PS)
        if n_need > self._capacity:
            raise ValueError(
                f"request needs {n_need} KV pages but decode pools hold "
                f"{self._capacity}")
        cancel_key = f"{self._uuid}:{self.requests}"
        excluded: set[int] = set()
        f_excluded: set[str] = set()
        prefix_m = None
        manifest = extra = first = None
        t_first = None
        last_err = None
        target = None
        completed = False
        n_out = 0
        try:
            for attempt in range(self.max_attempts + 1):
                widx = self._pick_decode(n_need, excluded)
                fkey = fhandle = None
                if widx is None:
                    picked = self._pick_foreign(n_need, f_excluded)
                    if picked is not None:
                        fkey, fhandle = picked
                if widx is None and fhandle is None and excluded:
                    excluded.clear()
                    widx = self._pick_decode(n_need, excluded)
                if widx is None and fhandle is None:
                    self._backpressure(n_need)
                if widx is not None:
                    self._est_pages[widx] += n_need
                    self._est_tokens[widx] += mt
                try:
                    if manifest is None:
                        try:
                            (manifest, extra, first,
                             prefix_m) = await self._prefill(
                                toks, temp, adapter)
                        except Exception as e:  # noqa: BLE001 — prefill leg
                            last_err = e
                            if isinstance(e, (KVShipError,
                                              ObjectLostError)):
                                self.cache.invalidate(toks)
                                prefix_m = None
                                continue
                            if _is_worker_death(e):
                                continue
                            raise
                        if attempt:
                            self.duplicate_prefills += 1
                            telemetry.count(duplicate_prefills=1)
                        if t_first is None:
                            t_first = time.perf_counter_ns()
                            telemetry.record(telemetry.TTFT,
                                             t_first - t_arr)
                    target = (self.decode_pool[widx]
                              if widx is not None else fhandle)
                    with telemetry.traced("disagg::decode"):
                        async for blk in self._pool_stream(
                                target, "decode_adopted_stream",
                                (toks, manifest, extra, first),
                                dict(max_tokens=mt, temperature=temp,
                                     adapter=adapter,
                                     cancel_key=cancel_key)):
                            n_out += len(blk)
                            yield {"tokens": blk}
                    t_done = time.perf_counter_ns()
                    if n_out > 1:
                        telemetry.record(telemetry.TPOT,
                                         (t_done - t_first) // (n_out - 1))
                    if widx is not None:
                        self.decode_tokens[widx] += n_out
                    else:
                        self.stolen += 1
                        self.stolen_tokens += n_out
                    pages = list(manifest.pages) + (
                        list(extra.pages) if extra else [])
                    if pages and len(toks) >= self.PS:
                        self.cache.insert(KVPageManifest(
                            token_ids=tuple(toks), page_size=self.PS,
                            kv_dtype=self.cache.kv_dtype, pages=pages))
                    completed = True
                    yield {
                        "tokens": [],
                        "done": True,
                        "usage": {
                            "prompt_tokens": len(toks),
                            "completion_tokens": n_out,
                            "cached_prefix_tokens": (prefix_m.n_tokens
                                                     if prefix_m else 0),
                            "latency_s": (t_done - t_arr) / 1e9,
                            "ttft_s": (t_first - t_arr) / 1e9,
                            "decode_worker": (widx if widx is not None
                                              else f"steal:{fkey}"),
                            "attempts": attempt + 1,
                        },
                    }
                    return
                except Exception as e:  # noqa: BLE001 — decode leg
                    if n_out:
                        # consumed deltas are never replayed: surface the
                        # break typed, with how far the stream got
                        if _is_worker_death(e):
                            raise StreamBrokenError(
                                f"decode stream broke after {n_out} "
                                f"token(s): {e}",
                                chunks_consumed=n_out) from e
                        raise
                    last_err = e
                    if isinstance(e, (KVShipError, ObjectLostError)):
                        self.cache.release(prefix_m)
                        self.cache.invalidate(toks)
                        prefix_m = manifest = extra = first = None
                        continue
                    if _is_worker_death(e):
                        if widx is not None:
                            excluded.add(widx)
                        else:
                            f_excluded.add(fkey)
                            self._foreign.pop(fkey, None)
                        self.decode_retries += 1
                        continue
                    if isinstance(e, BackPressureError):
                        if widx is not None:
                            excluded.add(widx)
                        else:
                            f_excluded.add(fkey)
                        continue
                    raise
                finally:
                    if widx is not None:
                        self._est_pages[widx] -= n_need
                        self._est_tokens[widx] -= mt
            raise last_err
        finally:
            self.cache.release(prefix_m)
            if not completed and target is not None:
                # abandoned/broken mid-flight: free the decode slot NOW.
                # The ring plane's abandon already closed the worker's
                # generator; this reaches streams on the RPC fallback.
                try:
                    target.cancel_decode.remote(cancel_key)  # raylint: disable=RT003 -- best-effort cancel: the stream's remainder is discarded either way
                except Exception:  # raylint: disable=RT012 -- the worker may be gone; its stream died with it
                    pass

    async def _prefill(self, toks, temp, adapter):
        """Cache-aware prefill: longest cached page prefix rides the
        suffix path; a miss runs the full prompt. Returns
        (manifest, extra, first_token, pinned_prefix)."""
        # cap the prefix below the prompt length: the prefill must see
        # >= 1 suffix token to produce the first-token logits
        prefix_m = self.cache.lookup(toks, max_tokens=len(toks) - 1)
        pf = self.prefill_pool[next(self._pf_rr) % len(self.prefill_pool)]
        try:
            with telemetry.traced("disagg::prefill"):
                if prefix_m is not None:
                    sm, first = await self._pool_call(
                        pf, "prefill", (toks[prefix_m.n_tokens:],),
                        dict(temperature=temp, adapter=adapter,
                             prefix=prefix_m))
                    return prefix_m, sm, first, prefix_m
                m, first = await self._pool_call(
                    pf, "prefill", (toks,),
                    dict(temperature=temp, adapter=adapter))
                return m, None, first, None
        except BaseException:
            self.cache.release(prefix_m)
            raise

    def _finish(self, toks, out, manifest, extra, prefix_m, t_arr,
                t_first, widx, attempt) -> dict:
        t_done = time.perf_counter_ns()
        if len(out) > 1:
            telemetry.record(telemetry.TPOT,
                             (t_done - t_first) // (len(out) - 1))
        # cache the request's full pages for the NEXT request sharing the
        # prefix (existing nodes are shared, new suffix pages extend them)
        pages = list(manifest.pages) + (list(extra.pages) if extra else [])
        if pages and len(toks) >= self.PS:
            self.cache.insert(KVPageManifest(
                token_ids=tuple(toks), page_size=self.PS,
                kv_dtype=self.cache.kv_dtype, pages=pages))
        return {
            "completion_tokens": out,
            "usage": {
                "prompt_tokens": len(toks),
                "completion_tokens": len(out),
                "cached_prefix_tokens": (prefix_m.n_tokens
                                         if prefix_m else 0),
                "latency_s": (t_done - t_arr) / 1e9,
                "ttft_s": (t_first - t_arr) / 1e9,
                "decode_worker": widx,
                "attempts": attempt + 1,
            },
        }

    # ---------------------------------------------------------- telemetry
    async def stats(self) -> dict:
        """Scheduler + cache + pool-wide KV-plane counters (the byte
        ledger summed across every worker process)."""
        # monitoring counts as interest in fresh decode signals: keep the
        # probe loop alive so ``decode_signals`` tracks live workers (a
        # respawned worker replaces its dead predecessor's stale entry)
        self._ensure_signal_loop()
        refs = [w.disagg_counters.remote()
                for w in (*self.prefill_pool, *self.decode_pool)]
        vals = await asyncio.gather(*refs, return_exceptions=True)
        ledger: dict[str, int] = {}
        for v in vals:
            if isinstance(v, dict):
                for k, n in v.items():
                    ledger[k] = ledger.get(k, 0) + int(n)
        for k, n in telemetry.counters().items():  # scheduler-local leg
            ledger[k] = ledger.get(k, 0) + int(n)
        return {
            "requests": self.requests,
            "duplicate_prefills": self.duplicate_prefills,
            "decode_retries": self.decode_retries,
            "backpressured": self.backpressured,
            "est_pages": list(self._est_pages),
            "est_tokens": list(self._est_tokens),
            "decode_tokens": list(self.decode_tokens),
            "decode_signals": [dict(s) if s else None
                               for s in self._signals],
            "stolen": self.stolen,
            "stolen_tokens": self.stolen_tokens,
            "foreign_workers": sorted(self._foreign),
            "prefix_cache": self.cache.stats(),
            "kv_plane": ledger,
        }

    def stage_windows(self) -> dict:
        """This replica's bounded TTFT/TPOT stage windows (ns values) —
        the serve-driven bench reads its percentiles through the
        deployment because the windows live in the replica process."""
        return {"ttft": telemetry.stage_window(telemetry.TTFT),
                "tpot": telemetry.stage_window(telemetry.TPOT)}

    async def shutdown(self):
        if self._sig_task is not None:
            self._sig_task.cancel()
            self._sig_task = None
        if self._share_group:
            try:
                await self._gcs("kv_del", {
                    "ns": _SHARE_NS,
                    "key": f"{self._share_group}/{self._uuid}"})
            except Exception:
                log.debug("share-group deregister failed", exc_info=True)
        refs = [w.stop.remote() for w in self.decode_pool]
        await asyncio.gather(*refs, return_exceptions=True)
        # release the pool leases NOW: explicit kills instead of waiting
        # for handle GC (shutdown is the one place we know no more calls
        # are coming), so a replaced/redeployed replica's fresh pools
        # never contend with the old pools' still-leased CPUs
        for w in (*self.prefill_pool, *self.decode_pool):
            try:
                await self._gcs("kill_actor", {
                    "actor_id": w.actor_id, "no_restart": True})
            except Exception:
                log.debug("pool actor kill failed", exc_info=True)


def build_disagg_deployment(model_config, *, params=None, params_fn=None,
                            num_replicas: int = 1, num_gpus: float = 0.0,
                            name: str = "DisaggLLMServer",
                            max_ongoing_requests: int = 64,
                            ray_actor_options: dict | None = None, **kw):
    """Bound serve application around the disaggregated stack. Route
    with ``handle.options(routing_hint=prefix_hint(tokens)).remote(...)``
    so requests sharing a cacheable prefix land on the replica already
    holding its pages. ``num_gpus`` is the REPLICA's card share (the
    scheduler runs no model: 0 by default). ``ray_actor_options`` (e.g.
    ``{"resources": {"host-a": 1}}``) pins the replica; pair it with
    ``pool_resources`` so its prefill/decode pools land beside it.

    How a pool worker gets the card: it is an actor of its own that
    leases ``pool_resources["GPU"]`` of a card (by default each of a
    replica's ``n_prefill + n_decode`` workers leases an even share of
    one), sees that card as ``cuda:0`` through ``CUDA_VISIBLE_DEVICES``
    (pinned by the lease for whole cards, named by the scheduler and set
    by the worker for shares), and draws its own seed-0 weights there
    unless ``params`` are given
    (weights by value are copied into the caller's arena and out again
    for every worker, so give them only at small sizes). ``device="cpu"`` in ``kw`` builds the pools on the CPU and
    leases no card."""
    from ray_tpu_torch import serve

    opts: dict = dict(ray_actor_options or {})
    if num_gpus:
        opts["num_gpus"] = num_gpus
    dep = serve.deployment(
        DisaggLLMServer,
        name=name,
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=opts,
    )
    return dep.bind(model_config, params, params_fn, **kw)
