"""Per-process runtime core shared by drivers and workers.

Equivalent of the reference CoreWorker (ref: src/ray/core_worker/
core_worker.h:166): owns the in-process memory store for inline objects
(memory_store.h:45), the shm-store client for large ones
(plasma_store_provider.h:93), lease-cached task submission
(normal_task_submitter.cc — leases amortized per scheduling key),
dependency resolution that inlines ready small args
(dependency_resolver.cc), direct actor-task submission with per-caller
ordering (actor_task_submitter.h:75), task retries + result tracking
(task_manager.h:175), and the owner side of object resolution: every
process serves ``get_object``/``wait_object`` for objects it owns.

All async code runs on one event loop: the driver hosts it on a background
thread (utils.rpc.EventLoopThread); workers run it as their main loop.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import inspect
import os
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any

try:
    import cloudpickle
except ImportError:  # pragma: no cover
    import pickle as cloudpickle

import pickle
import threading as _threading

from ray_tpu_torch.config import get_config
from ray_tpu_torch.core import object_store
from ray_tpu_torch.core.object_store import SharedObjectStore
from ray_tpu_torch.core.ref import (
    ActorError,
    ActorHandle,
    ConfigurationError,
    GetTimeoutError,
    ObjectLostError,
    ObjectRef,
    ObjectRefGenerator,
    SchedulingError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.utils import aio, metrics, recorder, rpc, serialization
from ray_tpu_torch.utils.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID

log = logging.getLogger(__name__)

_NCPU = max(1, os.cpu_count() or 1)

ALIVE = "ALIVE"
DEAD = "DEAD"


class _RecoveryNeeded(Exception):
    """Internal pump signal: a connection died while this dispatch was
    suspended; the spec must wait for the replay to be requeued first."""


@dataclass
class _MemEntry:
    value: Any = None
    packed: bytes | None = None
    error: Exception | None = None
    ready: asyncio.Event = field(default_factory=asyncio.Event)
    in_shm: bool = False  # large result living in some node's shm store
    # promise refs only: a thread-waitable twin of `ready`, so a caller
    # thread blocked in get() resolves without a loop round trip (the
    # serve router resolves one promise per request — see
    # promise_prepass)
    t_ready: Any = None


@dataclass
class _GenState:
    """Owner-side state for one streaming task (ref: task_manager.cc
    ObjectRefStream): items arrive via rpc_generator_item pushes."""

    items: list = field(default_factory=list)
    event: asyncio.Event = field(default_factory=asyncio.Event)
    done: bool = False
    error: Exception | None = None


@dataclass
class _LeasedWorker:
    lease_id: int
    address: tuple[str, int]
    worker_id: str
    raylet_address: tuple[str, int]
    conn: rpc.Connection | None = None
    busy: bool = False
    idle_since: float = field(default_factory=time.monotonic)
    gpu_ids: list | None = None  # card ids the lease granted
    fast_lane: object | None = None  # shm-ring lane (core/fastpath.py)
    queued: int = 0  # committed batch depth (demand accounting)


@dataclass
class _SchedulingKeyState:
    """Per (func, resources) lease pool (ref: SchedulingKey in
    normal_task_submitter.h — leases are cached and reused)."""

    pending: asyncio.Queue = field(default_factory=asyncio.Queue)
    workers: list[_LeasedWorker] = field(default_factory=list)
    lease_requests_inflight: int = 0
    inflight_tasks: int = 0
    strategy: dict | None = None  # wire form of the scheduling strategy
    affinity_addr: tuple | None = None  # cached node-affinity raylet addr
    # EWMA of observed per-task seconds: long tasks dispatch chunk=1 so
    # backlog stays visible to lease growth / spillback / the autoscaler
    avg_task_s: float = 0.0
    # monotonic ts since fast-lane backlog has been continuously high;
    # only PERSISTENT backlog grows leases (a micro-task burst drains in
    # milliseconds — spawning workers for it would eat the CPU it needs)
    fast_backlog_since: float = 0.0
    # persistent-lease-failure breaker: repeated identical errors over real
    # time with zero live workers fail the pending queue (see _request_lease)
    lease_failures: int = 0
    lease_failure_sig: str | None = None
    lease_failure_since: float = 0.0


class _TaskEventBuffer:
    """Batches task lifecycle events and flushes them (with a metrics
    snapshot) to the GCS on an interval (ref: task_event_buffer.h:225 —
    same drop-oldest bound, fire-and-forget flush)."""

    MAX_BUFFER = 10_000

    def __init__(self, core: "CoreClient"):
        self.core = core
        self.events: list[dict] = []

    def emit(self, **ev):
        ev.setdefault("ts", time.time())
        if len(self.events) >= self.MAX_BUFFER:
            del self.events[0]  # drop-oldest: keep the newest (terminal) states
        self.events.append(ev)

    async def _flush_loop(self):
        interval = self.core.cfg.task_events_report_interval_s
        while not self.core._closed:
            await asyncio.sleep(interval)
            await self.flush()

    async def flush(self):
        if self.core.gcs is None or self.core.gcs._closed:
            return
        try:
            if self.events:
                batch, self.events = self.events, []
                await self.core.gcs.notify("report_task_events", {"events": batch})
            # flight-recorder drain rides the same timer: native ring/
            # store gauges + sampled stage histograms are folded into the
            # metrics snapshot below, the latency window is published
            # beside it (all the expensive work happens HERE, 1/s — the
            # task hot path only ever appends to the recorder ring)
            self.core._publish_recorder_metrics()
            # metrics publish is independent of task activity (a put-only
            # process still reports its counters)
            await self.core.gcs.call(
                "kv_put",
                {"ns": "metrics", "key": self.core.worker_id.hex(),
                 "value": pickle.dumps(metrics.registry().snapshot())},
            )
            lat = self.core._latency_snapshot()
            if lat is not None:
                await self.core.gcs.call(
                    "kv_put",
                    {"ns": "latency", "key": self.core.worker_id.hex(),
                     "value": pickle.dumps(lat)},
                )
                # only after the put landed: a transient GCS error must
                # not permanently skip republishing this window
                self.core._lat_published = lat["count"]
            # registered extra windows (sharded plane stages, ...): each
            # source returns a {stages} snapshot or None when it has
            # nothing new since its last CONFIRMED publish
            for suffix, (fn, confirm) in list(
                    self.core._latency_sources.items()):
                snap = fn()
                if snap is not None:
                    await self.core.gcs.call(
                        "kv_put",
                        {"ns": "latency",
                         "key": f"{self.core.worker_id.hex()}.{suffix}",
                         "value": pickle.dumps(snap)},
                    )
                    if confirm is not None:
                        confirm()
        except Exception:
            # transient GCS error: this window republishes next flush
            log.debug("latency window publish failed", exc_info=True)


def _strategy_key(strategy: dict | None):
    """Hashable token for the scheduling-strategy part of a lease key
    (leases are cached per strategy: a SPREAD lease pool must not be
    reused for a node-pinned task)."""
    if not strategy:
        return None
    t = strategy["type"]
    if t == "spread":
        return ("spread",)
    if t == "node_affinity":
        return ("na", strategy["node_id"], bool(strategy.get("soft")))
    if t == "node_label":
        freeze = lambda d: tuple(sorted(
            (k, tuple(sorted(v))) for k, v in d.items()))
        return ("nl", freeze(strategy.get("hard", {})),
                freeze(strategy.get("soft", {})))
    return (t,)


def _handle_options(spec: dict) -> dict:
    """Driver-side method metadata carried on creation handles (num_returns
    from @method annotations; worker-side group routing uses the spec)."""
    return {"method_num_returns": spec.get("method_num_returns") or {}}


def _expire_future(fut) -> None:
    """fast_actor_await's timeout timer: cancel the waiter, marked so
    the await can tell a timeout from a genuine caller cancellation."""
    if not fut.done():
        fut._rt_expired = True
        fut.cancel()


class FastLaneDeclined(Exception):
    """The worker NEED_SLOWed an untracked fast actor call (stale
    method-eligibility table): the call never executed; the caller
    re-dispatches it over the RPC plane."""


class _FastStreamSink:
    """Loop-confined reorder buffer for one fast-lane stream (2.3 "G"
    records). Chunks may arrive out of order — a single chunk can spill
    over RPC while later chunks keep landing on the ring — so the sink
    buffers by per-stream chunk index and releases in order. The
    terminal reply (ordinary "A"-plane record carrying
    ``pack_stream_fin(nchunks)``) is held until every chunk below
    ``nchunks`` has been released, which restores the worker's emit
    order without any per-chunk seq from the lane counter.

    All mutation happens on the owner loop (pushes arrive via the
    ``_fast_wake_q`` drain), so no lock. ``dead`` flips when the
    consumer abandons the stream; pushes after that only free orphaned
    shm seals."""

    __slots__ = ("task_id", "lane", "q", "expect", "pending",
                 "fin", "fin_n", "dead")

    def __init__(self, task_id, lane):
        self.task_id = task_id
        self.lane = lane
        self.q: asyncio.Queue = asyncio.Queue()
        self.expect = 0          # next chunk index to release
        self.pending: dict = {}  # out-of-order chunks by index
        self.fin = None          # held terminal (status, payload)
        self.fin_n = None        # chunk count the terminal promised
        self.dead = False

    def push(self, status, payload) -> None:
        from ray_tpu_torch.core import fastpath

        if status in (fastpath.CHUNK, fastpath.CHUNK_SHM):
            seq, body = payload
            if seq < self.expect or seq in self.pending:
                return  # duplicate delivery (spill-RPC timeout re-send)
            self.pending[seq] = (status, body)
            while self.expect in self.pending:
                st, b = self.pending.pop(self.expect)
                self.q.put_nowait(("chunk", st, b, self.expect))
                self.expect += 1
            self._maybe_fin()
            return
        # terminal: OK carries pack_stream_fin(nchunks) and must wait
        # for the tail chunks; ERR / NEED_SLOW / None (lane broke) end
        # the stream immediately — consumed chunks are never replayed
        if status == fastpath.OK:
            self.fin = (status, payload)
            self.fin_n = fastpath.unpack_stream_fin(payload)
            if self.fin_n is None:  # malformed fin: fail the stream
                self.fin = None
                self.q.put_nowait(("fin", None, None, None))
                return
            self._maybe_fin()
        else:
            self.q.put_nowait(("fin", status, payload, None))

    def _maybe_fin(self) -> None:
        if self.fin is not None and self.expect >= self.fin_n:
            status, payload = self.fin
            self.fin = None
            self.q.put_nowait(("fin", status, payload, None))


class ActorCallTemplate:
    """Frozen per-(handle, method) submission state — the actor-call
    analogue of api.SubmitTemplate (ref: actor_task_submitter.h:75 cached
    per-handle submission state). Everything `.remote()` used to re-derive
    per call — the packed method-key bytes, the options-eligibility
    verdict (num_returns/concurrency-group/tracing), and the lane binding
    — is resolved ONCE at the first call of an ActorMethod (which PR 2
    already made a cached per-handle object).

    Invalidation: ``lane`` is re-looked-up whenever the bound lane is
    broken or retired (worker death, reattach after restart), and dropped
    when no live lane exists — the RPC path, which stays the source of
    truth, then serves the call. ``.options()`` forks build a new
    ActorMethod and therefore a new template. Never serialized
    (ActorMethod.__getstate__ strips it)."""

    __slots__ = ("core", "actor_id", "method", "mkey", "opts_ok", "lane")


class CoreClient:
    def __init__(self, loop: asyncio.AbstractEventLoop | None = None,
                 client_mode: bool = False):
        from ray_tpu_torch.core import fastpath

        self.cfg = get_config()
        # the largest ring record: the cap also guards the pop buffer, as a
        # record the consumer can never pop would wedge the ring (see
        # rt_ring_pop_batch's kTooBig)
        self._ring_record_cap = min(self.cfg.fastpath_record_max,
                                    fastpath.POP_BUF_BYTES - 64)
        self.client_mode = client_mode  # remote driver: no local shm arena
        self.loop = loop or asyncio.get_event_loop()
        self.worker_id = WorkerID.generate()
        self.job_id: JobID | None = None

        self.gcs: rpc.Connection | None = None
        self.raylet: rpc.Connection | None = None
        self.raylet_address: tuple[str, int] | None = None
        self.node_id: NodeID | None = None
        self.store: SharedObjectStore | None = None
        self.server = rpc.make_server("127.0.0.1", 0)
        self.server.add_routes(self)
        self.address: tuple[str, int] | None = None

        self._store_exec = None  # lazy: see _store_executor()
        self.memory_store: dict[ObjectID, _MemEntry] = {}
        self.sched_keys: dict[tuple, _SchedulingKeyState] = {}
        self._func_cache: dict[bytes, Any] = {}
        self._registered_funcs: set[bytes] = set()
        self._actor_info: dict[ActorID, dict] = {}
        self._actor_conns: dict[ActorID, rpc.Connection] = {}
        self._actor_conn_locks: dict[ActorID, asyncio.Lock] = {}
        self._actor_queues: dict[ActorID, list] = {}
        self._actor_pump_running: set[ActorID] = set()
        # per-actor in-flight specs in send (seq) order, for FIFO replay on
        # reconnect (ref: actor_task_submitter sequence replay)
        self._actor_inflight: dict[ActorID, dict] = {}
        # dead connections awaiting pump-owned recovery, per actor
        self._actor_recover_pending: dict[ActorID, set] = {}
        self._conn_seq: dict[rpc.Connection, int] = {}
        self._subscribed_actors: set[ActorID] = set()
        # actor-death fan-out: callbacks fired (on the loop thread) when a
        # subscribed actor's pubsub view flips to DEAD — the serve router
        # and controller evict/replace replicas in ~one raylet reap tick
        # instead of waiting out a health-check period
        self._actor_death_listeners: list = []
        # a restartable actor's constructor-arg pins, dropped at its DEAD
        # push (_pin_until_dead)
        self._ctor_pins: dict[ActorID, list] = {}
        # owner-local actor-handle refcounting (lease-starvation fix):
        # unnamed actors created by THIS driver are auto-killed once the
        # last local handle drops and their submitted work drains, so
        # their CPU leases return to the pool instead of squatting until
        # driver exit (two sequentially created 4-actor pools used to
        # exhaust an 8-CPU node). Named/detached actors and any actor
        # whose handle was ever serialized are exempt — a shipped handle
        # may outlive every local one.
        self._actor_handle_counts: dict[ActorID, int] = {}
        self._actor_no_autokill: set[ActorID] = set()
        # placement-group state pushes ("pgs" channel, subscribed lazily
        # on the first ready()/wait): pg_id hex -> latest view, plus
        # waiter events so ready() observes PENDING→CREATED and
        # RESCHEDULING→CREATED transitions push-driven instead of polling
        self._pg_info: dict[str, dict] = {}
        self._pg_waiters: dict[str, list[asyncio.Event]] = {}
        self._pg_subscribed = False
        self._task_counter = 0
        self._cancelled_tasks: set[TaskID] = set()
        self._task_worker: dict[TaskID, tuple] = {}  # task -> (conn, worker)
        self._gen_states: dict[TaskID, _GenState] = {}
        # distributed refcounting state (ref: reference_count.h:72)
        self._local_refs: dict[ObjectID, int] = {}      # owner-side handles
        self._borrowers: dict[ObjectID, set] = {}       # owner-side registry
        self._borrow_seen: set[ObjectID] = set()        # ≥1 borrow ever landed
        self._shipped_expect: set[ObjectID] = set()     # payload-shipped refs
        self._borrowed_counts: dict[ObjectID, int] = {} # borrower-side handles
        self._shipped_at: dict[ObjectID, float] = {}
        self._owner_conns: dict[tuple, rpc.Connection] = {}
        self._owner_conn_locks: dict[tuple, asyncio.Lock] = {}
        # Completion-time location cache (ref: SURVEY §1 L0/L2 —
        # owner-resident object metadata): oid -> set of holder node ids,
        # primed by completion records / location registrations so
        # steady-state get() never consults the GCS object directory.
        # Invalidated on holder death via the "nodes" pubsub channel; the
        # directory stays the source of truth (pull falls back to it on a
        # stale hint).
        self._obj_locations: dict[ObjectID, set] = {}
        # lineage for reconstruction (ref: task_manager.h:182 lineage pinning)
        self._lineage: dict[TaskID, dict] = {}
        self._lineage_live: dict[TaskID, set] = {}  # return oids still live
        self._reconstructions: dict[ObjectID, int] = {}
        # refs pinned while their task is in flight (args must outlive
        # dispatch; ref: dependency resolver holding arg refs)
        self._inflight_pins: dict[TaskID, list] = {}
        self._ship_collect: list | None = None  # set during arg serialization
        self.sealed_args = 0  # by-value args sealed into the arena (_resolve_args)
        # counts are bumped off-loop too. Reentrant: a garbage-collection
        # pass can run inside a section and drop an ActorHandle (or an
        # ObjectRef on the loop thread), whose __del__ takes this lock again
        # on the same thread
        self._rc_lock = _threading.RLock()
        self._xq: list = []  # thread->loop submission queue (see _call_on_loop)
        self._xq_armed = False
        self._xq_linger = False
        self._xq_lazy: list = []       # deleted-ref notices (5ms timer lane)
        self._xq_lazy_armed = False
        self._xq_lock = _threading.Lock()
        self._closed = False
        self.default_runtime_env: dict | None = None  # packaged descriptor
        self._bg = aio.TaskGroup()
        self.task_events = _TaskEventBuffer(self)
        # ---- native fast path (shm task rings; see core/fastpath.py) ----
        # _fast_cv guards every map below plus each lane's inflight dict;
        # reader threads notify it once per reply batch so blocking get()s
        # resolve without touching the event loop.
        self._fast_cv = _threading.Condition()
        self._fast_lanes: list = []
        self._fast_done: dict[ObjectID, tuple] = {}   # oid -> (status, payload)
        self._fast_oid_lane: dict[ObjectID, object] = {}
        self._fast_migrate_q: list = []
        self._fast_migrate_armed = False
        self._fast_ineligible_funcs: set[bytes] = set()
        self._fast_ring_seq = 0
        self._fast_last_submit = 0  # burst detector, perf_counter_ns
        self._fast_demand_kick = 0.0  # rate-limits backlog->pump kicks
        self._fast_actor_lanes: dict[ActorID, object] = {}
        # Coalesced ring flush (see FastLane.txbuf): the flusher thread is
        # the backstop that pushes a burst's buffered tail when no
        # get()/threshold flush does; started lazily on first deferral.
        self._fast_flush_cv = _threading.Condition()
        self._fast_flush_dirty = False
        self._fast_flusher_thread: _threading.Thread | None = None
        self._fast_tx_flushes = 0   # batch pushes (stats: bench.py)
        self._fast_tx_records = 0   # records those pushes carried
        self._fast_spilled_results = 0  # completions that arrived via RPC spill
        # flight recorder (utils/recorder.py): the hot paths read this
        # cached flag (an attribute load) instead of calling
        # recorder.enabled() per task; the flush timer refreshes it
        self._rec_enabled = recorder.enabled()
        # wire-level tracing (utils/tracing.py): cached flag for the same
        # reason as _rec_enabled — the unsampled fast path pays ONE
        # attribute load + branch. _trace_pending maps a sampled in-flight
        # call's return oid to its submit-span info so reply-apply can
        # stamp the wire-level call span (bounded: sampled traffic only).
        self._trace_on = bool(self.cfg.tracing_enabled)
        self._trace_pending: dict[ObjectID, tuple] = {}
        self._rec_published = -1  # stats.n at the last metrics publish
        self._lat_published = -1  # stats.n at the last latency kv_put
        # actor-call stage window: actor fast-lane replies store their raw
        # (t0, t_rx, tid, stamp) samples here instead of the task window,
        # published beside it (ns="latency" key "<worker>.actor", stages
        # prefixed actor_*) so list_task_latency shows the actor-call
        # stage breakdown the ROADMAP item asked for
        self._actor_stats = recorder.StageStats(self.cfg.recorder_events_cap)
        self._actor_rec_published = 0   # astats.n at last metrics publish
        self._actor_lat_published = -1  # astats.n at last CONFIRMED kv_put
        self._actor_lat_pending = -1
        # extra latency windows published beside the recorder's on the
        # flush timer (ns="latency", key "<worker>.<suffix>") — the
        # sharded plane registers its shard_seal/shard_fetch/reshard
        # stage window here; list_task_latency merges every key
        self._latency_sources: dict[str, Any] = {}
        # loop-resident fast-lane waiters (the serve data plane's router
        # hop): oid -> asyncio.Future resolved DIRECTLY from the reply
        # thread with (status, payload) — skipping the migrate queue's
        # 2ms linger, which is pure added latency for a coroutine that is
        # already parked on the loop. Guarded by _fast_cv; (None, None)
        # means "the lane broke mid-flight". Resolutions ride _fast_wake_q
        # behind ONE armed drain callback with a burst linger (the
        # _drain_xq shape): a self-pipe write per reply batch measured
        # ~140µs of loop time under the syscall-intercepting sandbox —
        # at serve QPS that one wake per request was the single largest
        # loop cost.
        self._fast_loop_waiters: dict[ObjectID, asyncio.Future] = {}
        self._fast_wake_q: list = []
        self._fast_wake_armed = False
        # streaming fast lane (2.3): oid -> _FastStreamSink for live
        # streams (guarded by _fast_cv like the waiters); tombstones of
        # abandoned-but-unfinished streams so late CHUNK_SHM records
        # free their seals instead of leaking (FIFO-capped — a stream's
        # tombstone clears for good when its terminal lands)
        self._fast_stream_sinks: dict[ObjectID, Any] = {}
        self._fast_stream_dead: dict[ObjectID, Any] = {}
        # ---- cross-node node tunnels (core/tunnel.py) ----
        # TunnelClient created lazily on first remote lane; tunnel actor
        # lanes register in _fast_actor_lanes beside ring lanes and reuse
        # the whole FastLane submit/reply/recovery machinery.
        self._tunnels = None
        # revival registry: actors that ever held a tunnel lane -> their
        # node raylet address; the health loop re-attaches after a
        # tunnel break once the redial lands (dropped on actor DEAD)
        self._tunnel_actor_seen: dict[ActorID, tuple] = {}
        # descriptor pins: task_id -> ObjectRefs minted for oversized
        # tunnel args, held until the call's reply (or break) lands so
        # the sealed shm copies can't be freed mid-pull
        self._tunnel_pins: dict[TaskID, list] = {}

    # ----------------------------------------------------------- bootstrap
    async def connect(self, gcs_address: tuple[str, int], raylet_address: tuple[str, int]):
        self.address = await self.server.start()
        self.gcs_address = tuple(gcs_address)  # dialable, unlike loopback peername
        self.gcs = await rpc.connect(*gcs_address, timeout=self.cfg.rpc_connect_timeout_s)
        self.gcs.on_message = self._on_push
        self.raylet = await rpc.connect(*raylet_address, timeout=self.cfg.rpc_connect_timeout_s)
        self.raylet_address = raylet_address
        info = await self.raylet.call("register_client", {})
        self.node_id = info["node_id"]
        if self.client_mode:
            self.store = None
        else:
            try:
                self.store = SharedObjectStore(info["store_name"])
            except Exception:
                # Remote driver (Ray-Client role, ref: util/client/): the
                # raylet's shm arena is on another machine. Objects this
                # driver owns live in its memory store and are owner-served
                # over RPC; shm-resident results are fetched through the
                # raylet's chunked transfer RPCs instead of mapped.
                self.store = None
        self.job_id = await self.gcs.call("register_job", {})
        # holder-death signal for the location cache (dedicated channel:
        # "nodes" also carries per-heartbeat resource gossip this client
        # has no use for)
        try:
            await self.gcs.call("subscribe", {"channel": "node_removed"})
        except (rpc.RpcError, OSError):
            pass  # cache misses fall back to the directory anyway
        self._bg.spawn(self.task_events._flush_loop(), self.loop)
        if self.cfg.fastpath_enabled and self.store is not None:
            self._bg.spawn(self._fast_health_loop(), self.loop)
        self.add_latency_source("actor", self._actor_latency_snapshot,
                                self._actor_latency_confirm)
        # arena owners registered before the runtime came up (tiering's
        # cooperative-spill providers) get their raylet hookup now
        from ray_tpu_torch.core import tiering

        tiering.attach_core(self)

    # -------------------------------------------------------------- pubsub
    def _on_push(self, msg):
        if msg.get("m") != "pubsub":
            return
        channel = msg["p"]["channel"]
        message = msg["p"]["message"]
        if channel.startswith("actor:"):
            actor_id = ActorID.from_hex(channel.split(":", 1)[1])
            self._actor_info[actor_id] = message
            if isinstance(message, dict) and message.get("state") == DEAD:
                self._tunnel_actor_seen.pop(actor_id, None)
                self._ctor_pins.pop(actor_id, None)
                for cb in list(self._actor_death_listeners):
                    try:
                        cb(actor_id, message)
                    except Exception:
                        log.debug("actor death listener failed", exc_info=True)
        elif channel == "pgs" and isinstance(message, dict):
            pg_hex = message.get("pg_id")
            if pg_hex:
                waiters = self._pg_waiters.pop(pg_hex, None)
                if waiters:
                    # retained only while a waiter is parked (it consumes
                    # the view): no per-PG residue for the ones this
                    # driver never waits on
                    self._pg_info[pg_hex] = message
                    for evt in waiters:
                        evt.set()
        elif channel == "node_removed" and isinstance(message, dict):
            # holder died: drop it from every cached location so the next
            # get falls back to the GCS directory (source of truth)
            node_id = message.get("node_id")
            nb = node_id.binary() if hasattr(node_id, "binary") else node_id
            for oid in [o for o, holders in self._obj_locations.items()
                        if nb in holders]:
                holders = self._obj_locations[oid]
                holders.discard(nb)
                if not holders:
                    del self._obj_locations[oid]

    # ---------------------------------------------------- placement groups
    def wait_placement_group_ready(self, pg_id, timeout: float = 30.0) -> bool:
        """Block until the PG is CREATED (every bundle committed). The
        wait observes the full PG state machine: PENDING and RESCHEDULING
        keep waiting — creation or a node-death repair is in flight on
        the GCS — while REMOVED (or the timeout) returns False.
        Push-driven via the "pgs" pubsub channel, with a polling backstop
        for lost pushes (e.g. a GCS restart dropping the subscription)."""
        return self._run_sync(self._wait_pg_ready(pg_id, timeout))

    def get_placement_group_state(self, pg_id) -> dict | None:
        """Latest GCS view of one PG (state, bundle_nodes, reschedule
        cause/count); None for an unknown id."""
        return self._run_sync(
            self.gcs.call("get_placement_group", {"pg_id": pg_id}))

    async def _wait_pg_ready(self, pg_id, timeout: float) -> bool:
        if not self._pg_subscribed:
            self._pg_subscribed = True
            try:
                await self.gcs.call("subscribe", {"channel": "pgs"})
            except (rpc.RpcError, OSError):
                self._pg_subscribed = False  # degrade to pure polling
        deadline = time.monotonic() + timeout
        pg_hex = pg_id.hex()
        view = None  # pushed "pgs" state consumed after each wake
        while True:
            if view is None:
                view = await self.gcs.call(
                    "get_placement_group", {"pg_id": pg_id})
            if view is None or view["state"] == "REMOVED":
                return False
            if view["state"] == "CREATED":
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            evt = asyncio.Event()
            self._pg_waiters.setdefault(pg_hex, []).append(evt)
            try:
                await asyncio.wait_for(evt.wait(), min(remaining, 0.5))
            except asyncio.TimeoutError:
                pass  # backstop: re-poll (a GCS restart can drop pushes)
            finally:
                waiters = self._pg_waiters.get(pg_hex)
                if waiters and evt in waiters:
                    waiters.remove(evt)
                if not waiters:
                    self._pg_waiters.pop(pg_hex, None)
            # consume the pushed view; None falls back to the poll above
            view = self._pg_info.pop(pg_hex, None)

    # ----------------------------------------------------------- ownership
    # Distributed reference counting (ref: reference_count.h:72): the owner
    # frees an object's memory entry AND its shm copies (local + remote
    # holders) only when its own handles are gone, no borrower is
    # registered, and no shipment of the ref is recently in flight.

    BORROW_GRACE_S = 3.0  # covers serialize->deserialize windows
    # A shipped ref whose recipient has NEVER registered a borrow gets a
    # much longer leash: the borrow notify is an async coroutine on the
    # recipient's loop and under load (concurrent jit compiles, reply
    # bursts) it can land SECONDS late — freeing at +3s turned cached
    # disagg KV pages into "unknown to owner" for every later adopter.
    # Once any borrower registers, lifetime is governed by the borrower
    # set; this timeout only reclaims shipments whose recipient died.
    SHIP_NO_BORROW_GRACE_S = 60.0

    def note_ref_shipped(self, oid: ObjectID, ref=None,
                         expect_borrow: bool = False):
        """``expect_borrow``: the ref was pickled INSIDE a payload and will
        rehydrate as an ObjectRef at the recipient (borrow registration
        coming); spec-path arg shipments dep-resolve to values and never
        borrow, so they keep the short grace."""
        self._shipped_at[oid] = time.monotonic()
        if expect_borrow:
            self._shipped_expect.add(oid)
        col = self._ship_collect
        if col is not None and ref is not None:
            col.append(ref)  # pin the live handle for the flight

    def on_owned_ref_created(self, oid: ObjectID):
        with self._rc_lock:
            self._local_refs[oid] = self._local_refs.get(oid, 0) + 1

    def on_owned_ref_deleted(self, oid: ObjectID):
        if self._closed:
            return
        try:
            # rides the coalesced thread->loop queue: dropping a batch of
            # refs (every `get([...])` return) must not pay one self-pipe
            # write syscall per ref
            self._call_on_loop(oid)
        except RuntimeError:
            pass

    def _on_owned_ref_deleted_on_loop(self, oid: ObjectID):
        with self._rc_lock:
            n = self._local_refs.get(oid, 1) - 1
            if n > 0:
                self._local_refs[oid] = n
                return
            self._local_refs.pop(oid, None)
        # fast path: un-borrowed, un-shipped, non-shm objects free inline —
        # no coroutine spawn on the put/drop hot path
        if not self._borrowers.get(oid) and oid not in self._shipped_at:
            entry = self.memory_store.get(oid)
            if entry is None or not entry.in_shm:
                self.memory_store.pop(oid, None)
                self._release_lineage_for(oid)
                return
        self._bg.spawn(self._maybe_free_object(oid), self.loop)

    def _release_lineage_for(self, oid: ObjectID):
        tid = oid.task_id()
        live = self._lineage_live.get(tid)
        if live is not None:
            live.discard(oid)
            if not live:
                self._lineage.pop(tid, None)
                self._lineage_live.pop(tid, None)
                # nothing can reconstruct this task anymore — safe to forget
                # its cancellation mark (bounds _cancelled_tasks growth)
                self._cancelled_tasks.discard(tid)

    async def _maybe_free_object(self, oid: ObjectID):
        while not self._closed:
            if self._local_refs.get(oid, 0) > 0:
                return  # resurrected (e.g. deserialized again on the owner)
            if self._borrowers.get(oid):
                return  # an unborrow will re-trigger the free check
            shipped = self._shipped_at.get(oid)
            if shipped is not None:
                # payload-shipped ref whose borrower has NEVER registered:
                # the recipient's borrow notify may still be queued behind
                # a loaded loop — hold the object for the long leash,
                # re-checking so a landed borrow parks the free immediately
                grace = (self.SHIP_NO_BORROW_GRACE_S
                         if (oid in self._shipped_expect
                             and oid not in self._borrow_seen)
                         else self.BORROW_GRACE_S)
                wait = grace - (time.monotonic() - shipped)
                if wait > 0:  # a borrow registration may still be in flight
                    await asyncio.sleep(min(wait, 1.0))
                    continue
            break
        if self._closed:
            return
        self._shipped_at.pop(oid, None)
        self._borrowers.pop(oid, None)
        self._borrow_seen.discard(oid)
        self._shipped_expect.discard(oid)
        self._obj_locations.pop(oid, None)
        entry = self.memory_store.pop(oid, None)
        # lineage pins its task's arg refs only while some return is live
        self._release_lineage_for(oid)
        if entry is not None and entry.in_shm:
            await self._free_shm_everywhere(oid)

    async def _free_shm_everywhere(self, oid: ObjectID):
        """Delete the sealed copies on every holder node and drop the
        directory entry (the owner-driven release the reference does via
        LocalObjectManager free batches)."""
        try:
            blob = await self.gcs.call("kv_get", {"ns": "obj_loc", "key": oid.hex()})
            holders = pickle.loads(blob) if blob else set()
            if not holders and self.node_id is not None:
                # a put followed by an immediate last-ref drop can race
                # its own _register_location kv_put: the directory reads
                # empty and the sealed local copy would leak forever.
                # The owner's node is always a candidate holder — include
                # it so the local delete lands regardless.
                holders = {self.node_id.binary()}
            await self.gcs.call("kv_del", {"ns": "obj_loc", "key": oid.hex()})
            nodes = {tuple(n["address"]): n["node_id"].binary() if hasattr(n["node_id"], "binary") else n["node_id"]
                     for n in await self.gcs.call("get_cluster", {})}
            for addr, node_bin in nodes.items():
                if node_bin in holders:
                    try:
                        conn = (self.raylet if addr == tuple(self.raylet_address)
                                else await rpc.connect(*addr, timeout=2))
                        try:
                            await conn.call("delete_object", {"object_id": oid.binary()})
                        finally:
                            if conn is not self.raylet:
                                await conn.close()
                    except (rpc.RpcError, OSError):
                        pass  # holder already gone: nothing left to delete
        except Exception:
            log.debug("free() fanout failed", exc_info=True)

    # ------------------------------------------------------- borrower side
    def on_borrowed_ref_created(self, oid: ObjectID, owner_address):
        with self._rc_lock:
            n = self._borrowed_counts.get(oid, 0)
            self._borrowed_counts[oid] = n + 1
        if n == 0:
            self._call_on_loop(self._send_borrow(oid, tuple(owner_address), True))

    def on_borrowed_ref_deleted(self, oid: ObjectID, owner_address):
        if self._closed:
            return
        try:
            self.loop.call_soon_threadsafe(
                self._on_borrowed_deleted_on_loop, oid, owner_address
            )
        except RuntimeError:
            pass

    def _on_borrowed_deleted_on_loop(self, oid: ObjectID, owner_address):
        with self._rc_lock:
            n = self._borrowed_counts.get(oid, 1) - 1
            if n > 0:
                self._borrowed_counts[oid] = n
                return
            self._borrowed_counts.pop(oid, None)
        self._bg.spawn(self._send_borrow(oid, tuple(owner_address), False), self.loop)

    async def _send_borrow(self, oid: ObjectID, owner_address, borrow: bool):
        """Borrow/unborrow travel on one cached connection per owner, with
        connect+send under a per-owner lock so they arrive in order."""
        if not borrow:
            # if we recently re-shipped this borrowed ref to a third
            # process, hold our registration until its borrow can land
            shipped = self._shipped_at.pop(oid, None)
            if shipped is not None:
                wait = self.BORROW_GRACE_S - (time.monotonic() - shipped)
                if wait > 0:
                    await asyncio.sleep(wait)
        lock = self._owner_conn_locks.setdefault(owner_address, asyncio.Lock())
        try:
            async with lock:
                conn = self._owner_conns.get(owner_address)
                if conn is None or conn._closed:
                    conn = await rpc.connect(*owner_address, timeout=5)
                    self._owner_conns[owner_address] = conn
                await conn.notify(
                    "borrow_object" if borrow else "unborrow_object",
                    {"object_id": oid.binary(), "borrower": self.worker_id.hex()},
                )
        except (rpc.RpcError, OSError):
            pass  # owner died: its ref counts died with it

    # --------------------------------------------------------- owner RPCs
    async def rpc_borrow_object(self, conn, p):
        oid = ObjectID(p["object_id"])
        if oid not in self.memory_store:
            # the object is already gone (freed, or never ours): tracking
            # this borrower would create a zombie entry no free path ever
            # clears — the borrower's get surfaces the loss itself
            return False
        self._borrowers.setdefault(oid, set()).add(p["borrower"])
        self._borrow_seen.add(oid)
        return True

    async def rpc_unborrow_object(self, conn, p):
        oid = ObjectID(p["object_id"])
        holders = self._borrowers.get(oid)
        if holders is not None:
            holders.discard(p["borrower"])
            if not holders and self._local_refs.get(oid, 0) == 0:
                self._bg.spawn(self._maybe_free_object(oid), self.loop)
        return True

    # ----------------------------------------- cooperative tiering routes
    async def rpc_arena_spill_candidates(self, conn, p):
        """The raylet asks this process's registered arena owners (prefix
        cache, shard plane, staging trackers — core/tiering.py) for cold
        REFERENCED objects it may trade to tier-1."""
        from ray_tpu_torch.core import tiering

        return tiering.collect_candidates(
            int(p.get("need", 0)),
            float(p.get("cold_after_s", self.cfg.spill_cold_after_s)))

    async def rpc_arena_spilled(self, conn, p):
        """The raylet reports candidates it actually spilled; owners stamp
        their manifest entries' (tier, path) legs."""
        from ray_tpu_torch.core import tiering

        tiering.notify_spilled(p.get("spilled") or [])
        return True

    def register_spill_provider(self) -> None:
        """Tell the local raylet this process serves arena-owner spill
        candidates at our RPC address (idempotent raylet-side)."""
        if self.raylet is None or self.address is None:
            return
        coro = self.raylet.call("register_spill_provider",
                                {"address": list(self.address)})
        if _in_loop(self.loop):
            self._bg.spawn(coro, self.loop)
        else:
            self._run_sync(coro, timeout=10)

    def spill_objects(self, oids, timeout: float = 60.0) -> dict:
        """Explicitly spill specific sealed objects through the local
        raylet (the prefix cache's spill-not-drop eviction). Landed
        spills are fanned out to the tiering sinks (manifest tier-leg
        stamping) in BOTH modes; the returned {oid hex: {"ok", "path"}}
        map is empty when called on the event loop (the spill is spawned
        there, result delivered via the sinks) or on failure."""
        if self.raylet is None:
            return {}
        raw_ids = [o.binary() if hasattr(o, "binary") else o for o in oids]
        payload = {"object_ids": raw_ids}
        by_hex = {b.hex(): b for b in raw_ids}

        def deliver(res: dict):
            from ray_tpu_torch.core import tiering

            tiering.notify_spilled(
                [{"object_id": by_hex[h], "path": v.get("path", "")}
                 for h, v in (res or {}).items()
                 if h in by_hex and v.get("ok")])

        async def _spill_and_deliver():
            try:
                res = await self.raylet.call("spill_objects", payload)
            except Exception:
                log.debug("spill_objects request failed", exc_info=True)
                return {}
            deliver(res)
            return res or {}

        try:
            if _in_loop(self.loop):
                self._bg.spawn(_spill_and_deliver(), self.loop)
                return {}
            return self._run_sync(_spill_and_deliver(), timeout=timeout)
        except Exception:
            log.debug("spill_objects request failed", exc_info=True)
            return {}

    def _new_owned_ref(self, oid: ObjectID) -> ObjectRef:
        self.on_owned_ref_created(oid)
        return ObjectRef(oid, self.address, _core=self)

    # -------------------------------------------------- death subscriptions
    def add_actor_death_listener(self, cb) -> None:
        """Register ``cb(actor_id, info)`` to fire (loop thread) when any
        actor this client follows transitions to DEAD. Callbacks must be
        light and non-blocking — they run inline in the pubsub push."""
        if cb not in self._actor_death_listeners:
            self._actor_death_listeners.append(cb)

    def remove_actor_death_listener(self, cb) -> None:
        try:
            self._actor_death_listeners.remove(cb)
        except ValueError:
            pass  # already removed (idempotent teardown)

    def add_latency_source(self, suffix: str, fn, confirm=None) -> None:
        """Register an extra latency window beside the flight recorder's:
        ``fn()`` returns a ``{stages: {name: [ns, ...]}}`` snapshot (or
        None when idle) and is published on the task-event flush timer
        under ns="latency" key ``<worker>.<suffix>`` —
        ``state.list_task_latency()`` merges every key in the namespace,
        so the extra stages surface with zero new API. ``confirm`` (if
        given) fires only after the kv_put LANDED, so a transient GCS
        error republishes the window next flush (the same invariant
        ``_lat_published`` keeps for the recorder's own window)."""
        self._latency_sources[suffix] = (fn, confirm)

    # -------------------------------------------------------- promise refs
    def create_promise_ref(self):
        """An owned ObjectRef whose value arrives later: returns
        ``(ref, resolve)`` where ``resolve(value=..., error=...)`` (loop
        thread only) fulfills it. The serve router's retry loop rides
        this — the caller holds ONE ordinary ref while attempts replay
        behind it; ``get``/``wait``/``await`` all work unchanged."""
        oid = ObjectID.from_random()
        entry = _MemEntry()
        entry.t_ready = _threading.Event()
        self.memory_store[oid] = entry
        ref = self._new_owned_ref(oid)

        def resolve(value=None, error: Exception | None = None):
            if error is not None:
                entry.error = error
            else:
                entry.value = value
            entry.ready.set()
            entry.t_ready.set()  # caller-thread getters (promise_prepass)

        return ref, resolve

    def promise_prepass(self, refs, timeout: float | None) -> dict:
        """Blocking wait (user thread) for promise refs: resolves them
        straight off the threading.Event twin their resolve() sets — no
        loop round trip for the get half of a serve request. Refs that
        are not promise-backed (or time out) are left for the normal get
        path. Returns {oid: ("V", value) | ("e", exc)}."""
        out: dict = {}
        deadline = None if timeout is None else time.monotonic() + timeout
        for ref in refs:
            entry = self.memory_store.get(ref.id)
            evt = getattr(entry, "t_ready", None)
            if entry is None or evt is None:
                continue
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not evt.wait(remaining):
                continue  # timed out: the slow path owns the error
            if entry.error is not None:
                out[ref.id] = ("e", entry.error)
            else:
                out[ref.id] = ("V", entry.value)
        return out

    # ----------------------------------------------------------------- put
    def put_value(self, value: Any, prefer_shm: bool = False) -> ObjectRef:
        """Store an owned object. ``prefer_shm`` forces the shm path even
        under the inline threshold (the sharded plane's shard seals: a
        shard must be arena-resident so consumers on this node read it
        zero-copy and remote nodes can pull it without an owner hop)."""
        meta, buffers = serialization.dumps_with_buffers(value)
        size = serialization.total_size(meta, buffers)
        if (size > self.cfg.max_inline_object_size
                or prefer_shm) and self.store is not None:
            self._maybe_request_spill(size)
            return self._seal_owned(meta, buffers, size)
        # client mode has no local shm: every owned object is memory-
        # store resident and owner-served (borrowers fetch over RPC)
        metrics.objects_put.inc()
        metrics.object_bytes_put.inc(size)
        oid = ObjectID.from_random()
        entry = _MemEntry()
        entry.packed = _pack_bytes(meta, buffers, size)
        self.memory_store[oid] = entry
        entry.ready.set()
        return self._new_owned_ref(oid)

    def _seal_owned(self, meta: bytes, buffers: list, size: int) -> ObjectRef:
        """The arena half of ``put_value``: seal a value that
        ``serialization.dumps_with_buffers`` took apart into the local
        arena, as an object of ours. Raises as ``store.create`` does when
        the arena cannot hold it; the caller has asked for a spill."""
        metrics.objects_put.inc()
        metrics.object_bytes_put.inc(size)
        oid = ObjectID.from_random()
        buf = self.store.create(oid, size)
        serialization.pack_into(meta, buffers, buf)
        self.store.seal(oid)
        entry = _MemEntry()
        entry.in_shm = True
        self.memory_store[oid] = entry
        entry.ready.set()
        self._call_on_loop(self._register_location(oid))
        return self._new_owned_ref(oid)

    def spill_pressure(self, size: int) -> bool:
        """True when creating `size` more bytes would cross the spill
        threshold (shared by driver puts and worker result stores)."""
        if self.store is None or self.cfg.object_spilling_threshold <= 0:
            return False
        cap = max(1, self.store.capacity)
        return (self.store.bytes_in_use + size
                > self.cfg.object_spilling_threshold * cap)

    def _maybe_request_spill(self, size: int):
        """Pressured put: ask the raylet to spill before creating, so the
        arena frees by spill (bytes preserved on disk) instead of LRU
        eviction (bytes destroyed; a later get pays lineage re-execution).
        Ref: local_object_manager.h:42 spill-under-pressure.

        Best-effort for callers ON the event loop (async actor methods):
        the RPC is spawned rather than awaited there — the raylet's
        200ms monitor backstops the window."""
        if not self.spill_pressure(size):
            return
        if _in_loop(self.loop):
            self._bg.spawn(self._spill_for(size), self.loop)
            return
        try:
            self._run_sync(self._spill_for(size), timeout=60)
        except Exception:
            log.debug("spill_now request failed", exc_info=True)

    async def _spill_for(self, size: int) -> None:
        """Ask the raylet to spill room for ``size`` more bytes, when the
        arena is under pressure (the loop's side of _maybe_request_spill:
        a large task argument's seal awaits it)."""
        if not self.spill_pressure(size):
            return
        try:
            await self.raylet.call("spill_now", {"need": size})
        except Exception:
            # advisory: create() still retries under arena pressure
            log.debug("spill_now request failed", exc_info=True)

    async def _register_location(self, oid: ObjectID, holder: bytes | None = None):
        """Write the object's holder set to the GCS directory. ``holder``
        names the sealing node when it is NOT ours (tunnel completions:
        the record's shm descriptor carries the executing node)."""
        hb = holder or self.node_id.binary()
        holders = {hb}
        self._obj_locations.setdefault(oid, set()).add(hb)
        await self.gcs.call(
            "kv_put", {"ns": "obj_loc", "key": oid.hex(), "value": pickle.dumps(holders)}
        )

    async def _pull_via_raylet(self, oid: ObjectID) -> bool:
        """pull_object through the local raylet, passing the cached holder
        set as a hint so the steady-state pull skips the GCS directory
        lookup; a failed hinted pull drops the (stale) cache entry — the
        raylet already fell back to the directory inside the call."""
        payload = {"object_id": oid.binary()}
        hint = self._obj_locations.get(oid)
        if hint:
            payload["holders_hint"] = sorted(hint)
        ok = await self.raylet.call("pull_object", payload)
        if hint:
            if ok:
                # the one holder we now KNOW is our own node (the pull
                # landed locally); stale entries — e.g. a dead node the
                # raylet fell back past — drop in the same move
                self._obj_locations[oid] = {self.node_id.binary()}
            else:
                self._obj_locations.pop(oid, None)
        return ok

    async def pull_objects_batch(self, hints: dict, sizes: dict | None = None,
                                 timeout_s: float | None = None) -> dict:
        """Batched multi-object pull through the local raylet (protocol
        2.0 ``pull_objects``): ONE round trip fetches a whole
        arg/KV-manifest set into the local store, with per-object holder
        hints (location cache + caller knowledge) and exactly one GCS
        ``kv_multi_get`` raylet-side for the unhinted miss-set.
        ``hints``: {ObjectID: holder-node-id set (may be empty)}.
        ``sizes`` (optional {ObjectID: nbytes}) feeds the raylet's
        byte-budget pull admission; ``timeout_s`` (optional) is the
        admission deadline — items shed at it come back under the
        ``"_bp"`` key ({oid hex: retry_after_s}) and tier-1 restores
        under ``"_restored"``, both left in the returned map for callers
        that care. Returns {oid hex: bool} plus those side-channel keys;
        failures fall back to the per-object pull paths of the callers.
        Best effort — never raises."""
        items = []
        for oid, hint in hints.items():
            if self.store is not None and self.store.contains(oid):
                continue
            merged = set(b for b in (hint or ()) if b)
            merged |= self._obj_locations.get(oid, set())
            item = {"object_id": oid.binary(),
                    "holders_hint": sorted(merged) or None}
            if sizes and sizes.get(oid):
                item["nbytes"] = int(sizes[oid])
            items.append(item)
        if not items or self.raylet is None:
            return {}
        payload: dict = {"objects": items}
        if timeout_s is not None:
            payload["timeout_s"] = float(timeout_s)
        try:
            res = await self.raylet.call("pull_objects", payload)
        except Exception:
            log.debug("batched pull failed", exc_info=True)
            return {}
        for oid in hints:
            if (res or {}).get(oid.hex()):
                # the holder we now KNOW is our own node
                self._obj_locations[oid] = {self.node_id.binary()}
        return res or {}

    # ----------------------------------------------------------------- get
    async def get_async(self, refs: list[ObjectRef], timeout: float | None = None):
        refs = list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout
        if len(refs) <= 1:
            return [await self._get_one(ref, deadline) for ref in refs]
        # inline sweep: ready non-shm entries resolve without spawning a
        # task per ref (the common get([...]) over completed results)
        out: list = [None] * len(refs)
        pending: list[int] = []
        for i, ref in enumerate(refs):
            entry = self.memory_store.get(ref.id)
            if (entry is not None and entry.ready.is_set()
                    and entry.error is None and not entry.in_shm):
                if entry.packed is not None:
                    out[i] = serialization.unpack(entry.packed)
                else:
                    out[i] = entry.value
            else:
                pending.append(i)
        if not pending:
            return out
        # batched location priming: one kv_multi_get covers every shm ref
        # whose holder set is unknown, instead of one directory RPC per
        # ref inside the pulls below
        await self._prime_locations([refs[i] for i in pending])
        # batched pull: every ready shm ref that is not local yet rides
        # ONE pull_objects round trip (a cross-node KV-manifest set or
        # multi-arg fetch lands in one RTT); _get_one then reads the
        # local copies zero-copy, and misses keep their per-ref fallback
        if self.store is not None:
            need_pull = {}
            for i in pending:
                oid = refs[i].id
                entry = self.memory_store.get(oid)
                if (entry is not None and entry.ready.is_set()
                        and entry.in_shm and oid not in need_pull
                        and not self.store.contains(oid)):
                    need_pull[oid] = self._obj_locations.get(oid, set())
            if len(need_pull) >= 2:
                await self.pull_objects_batch(need_pull)
        results = await asyncio.gather(
            *(self._get_one(refs[i], deadline) for i in pending),
            return_exceptions=True)
        for i, r in zip(pending, results):
            if isinstance(r, BaseException):
                raise r  # first error in ref order, like the serial path
            out[i] = r
        return out

    async def _prime_locations(self, refs: list[ObjectRef]):
        """Coalesce location misses for ready shm-resident refs into ONE
        GCS kv_multi_get (ref: owner-resident metadata — the slow path
        paid one obj_loc kv_get per ref)."""
        need = []
        seen = set()
        for ref in refs:
            oid = ref.id
            if oid in seen or oid in self._obj_locations:
                continue
            entry = self.memory_store.get(oid)
            if (entry is not None and entry.ready.is_set() and entry.in_shm
                    and (self.store is None or not self.store.contains(oid))):
                seen.add(oid)
                need.append(oid)
        if len(need) < 2:
            return
        try:
            blobs = await self.gcs.call(
                "kv_multi_get", {"ns": "obj_loc",
                                 "keys": [o.hex() for o in need]})
        except Exception:
            return  # per-ref pulls fall back to the directory themselves
        for oid in need:
            blob = (blobs or {}).get(oid.hex())
            if blob:
                try:
                    self._obj_locations[oid] = set(pickle.loads(blob))
                except (pickle.UnpicklingError, TypeError, EOFError):
                    pass  # torn directory blob: treated as a cache miss

    async def _get_one(self, ref: ObjectRef, deadline: float | None):
        oid = ref.id
        pull_fails = 0
        while True:
            # timeout=0 is a non-blocking fetch: ready values are returned,
            # the timeout only fires where we would otherwise block
            # (ref: ray worker.get timeout semantics, worker.py:2757)
            remaining = None if deadline is None else deadline - time.monotonic()
            expired = remaining is not None and remaining <= 0
            entry = self.memory_store.get(oid)
            if entry is not None and entry.ready.is_set():
                if entry.error is not None:
                    raise entry.error
                if not entry.in_shm:
                    if entry.packed is not None:
                        return serialization.unpack(entry.packed)
                    return entry.value
                # owned shm result — may live on the executing node's store
                # (spillback): fall through to the shm/pull path below
            if self.store is None:
                # remote driver: no local arena. Owned memory-store entries
                # returned above; anything shm-resident (task results,
                # borrowed large objects) is materialized over the raylet
                # connection via the chunked transfer RPCs.
                if entry is not None and not entry.ready.is_set():
                    if expired:
                        raise GetTimeoutError(f"get timed out on {ref}")
                    await _wait_event(entry.ready, remaining)
                    continue
                if entry is not None or ref.owner_address is None or \
                        tuple(ref.owner_address) == self.address:
                    data = await self._fetch_via_raylet(oid)
                    if data is not None:
                        return serialization.unpack(data)
                    if expired:
                        raise GetTimeoutError(f"get timed out on {ref}")
                    pull_fails += 1
                    if pull_fails >= 5:
                        if await self._try_reconstruct(oid):
                            pull_fails = 0
                            continue
                        raise ObjectLostError(f"{ref}: no reachable copy")
                    await asyncio.sleep(0.05)
                    continue
                # borrowed: ask the owner (inline reply or shm indirection)
                if expired:
                    raise GetTimeoutError(f"get timed out on {ref}")
                try:
                    reply = await self._owner_call(
                        ref, "get_object", {"object_id": oid.binary()}, remaining
                    )
                except asyncio.TimeoutError:
                    raise GetTimeoutError(f"get timed out on {ref}") from None
                if reply.get("error") is not None:
                    raise reply["error"]
                if reply.get("inline") is not None:
                    return serialization.unpack(reply["inline"])
                data = await self._fetch_via_raylet(oid)
                if data is not None:
                    return serialization.unpack(data)
                if expired:
                    raise GetTimeoutError(f"get timed out on {ref}")
                pull_fails += 1
                if pull_fails >= 15:
                    raise ObjectLostError(f"{ref}: no reachable copy")
                await asyncio.sleep(0.05)
                continue
            if self.store.contains(oid):
                try:
                    # dedicated executor: the loop's default pool is shared
                    # with arbitrary user run_in_executor(None, ...) work —
                    # actor code commonly parks blocking api.get calls
                    # there, and once those occupy every default thread the
                    # store read that would unblock them queues behind them
                    # forever (executor self-deadlock at ~6 concurrent gets)
                    return await self.loop.run_in_executor(
                        self._store_executor(), self.store.get, oid, 10_000)
                except object_store.ObjectEvictedError:
                    # Local copy was LRU-evicted under memory pressure between
                    # contains() and get(): re-pull from another holder (the
                    # raylet consults the GCS directory); no holder → lost,
                    # unless lineage can re-execute the producing task.
                    ok = await self._pull_via_raylet(oid)
                    if expired:
                        raise GetTimeoutError(f"get timed out on {ref}") from None
                    if not ok:
                        if await self._try_reconstruct(oid):
                            continue
                        raise ObjectLostError(
                            f"{ref} was evicted and no other copy exists"
                        ) from None
                    continue
            if entry is not None:
                if entry.ready.is_set():  # owned, in_shm, not local: pull it
                    ok = await self._pull_via_raylet(oid)
                    if expired:
                        # pull issued (or refused) but the value is still not
                        # local and the deadline passed: raise rather than
                        # spinning pull RPCs forever on a stalled transfer
                        raise GetTimeoutError(f"get timed out on {ref}")
                    if not ok:
                        pull_fails = pull_fails + 1
                        # distinguish "not there yet" from "gone": a local
                        # eviction tombstone or repeated no-holder pulls
                        # mean the object is lost -> lineage re-execution
                        if self.store.is_evicted(oid) or pull_fails >= 5:
                            if await self._try_reconstruct(oid):
                                pull_fails = 0
                                continue
                            raise ObjectLostError(
                                f"{ref} was evicted and no other copy exists"
                            )
                        await asyncio.sleep(0.05)
                    continue
                # owned, pending task result
                if expired:
                    raise GetTimeoutError(f"get timed out on {ref}")
                await _wait_event(entry.ready, remaining)
                continue
            # borrowed ref: ask the owner
            if expired:
                raise GetTimeoutError(f"get timed out on {ref}")
            if ref.owner_address is None or tuple(ref.owner_address) == self.address:
                await asyncio.sleep(0.01)
                continue
            try:
                reply = await self._owner_call(
                    ref, "get_object", {"object_id": oid.binary()}, remaining
                )
            except asyncio.TimeoutError:
                raise GetTimeoutError(f"get timed out on {ref}") from None
            if reply.get("error") is not None:
                raise reply["error"]
            if reply.get("inline") is not None:
                return serialization.unpack(reply["inline"])
            # large object: pull into local shm through our raylet
            ok = await self._pull_via_raylet(oid)
            if not ok:
                pull_fails += 1
                if pull_fails in (5, 15, 30):  # escalate: owner re-executes
                    try:
                        await self._owner_call(
                            ref, "recover_object", {"object_id": oid.binary()}, 10
                        )
                    except Exception:
                        log.debug("recover_object escalation failed",
                                  exc_info=True)
                if pull_fails >= 45:
                    # the owner keeps claiming shm residency but no holder
                    # can produce the bytes and recovery changed nothing —
                    # without a deadline this loop would spin forever on a
                    # stale owner entry; surface the loss instead
                    raise ObjectLostError(f"{ref}: no reachable copy")
                await asyncio.sleep(0.05)
                continue

    async def _fetch_via_raylet(self, oid: ObjectID) -> bytes | None:
        """Client mode: materialize a shm-resident object through the raylet
        connection (pull to the raylet's arena if needed, then stream it
        with the chunked transfer RPCs — the remote-driver read path)."""
        obj = {"object_id": oid.binary()}
        try:
            ok = await self._pull_via_raylet(oid)
            if not ok:
                return None
            meta = await self.raylet.call("fetch_object_meta", obj)
            if meta is None:
                return None
            size = meta["size"]
            chunk = self.cfg.object_transfer_chunk_size
            offsets = list(range(0, size, chunk))
            parts: list = [None] * len(offsets)
            window = asyncio.Semaphore(4)  # pipeline: hide per-chunk RTT

            async def fetch(i: int, off: int):
                async with window:
                    data = await self.raylet.call(
                        "fetch_object_chunk",
                        {"object_id": oid.binary(), "offset": off,
                         "length": min(chunk, size - off)},
                    )
                    if data is None:  # holder lost mid-stream: abort the rest
                        raise LookupError("chunk gone")
                    parts[i] = data

            tasks = [asyncio.ensure_future(fetch(i, off))
                     for i, off in enumerate(offsets)]
            try:
                await asyncio.gather(*tasks)
            except LookupError:
                # gather doesn't cancel siblings: stop the queued fetches so
                # a multi-GB failure doesn't keep streaming dead chunks
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                return None
            finally:
                try:
                    await self.raylet.call("fetch_object_done", obj)
                except (rpc.RpcError, OSError):
                    pass  # raylet gone: the pin dies with it
            return b"".join(parts)
        except rpc.ConnectionLost:
            return None

    async def _owner_call(self, ref: ObjectRef, method: str, payload: dict,
                          timeout: float | None):
        conn = await rpc.connect(*ref.owner_address, timeout=self.cfg.rpc_connect_timeout_s)
        try:
            return await conn.call(method, payload, timeout=timeout)
        finally:
            await conn.close()

    # ---------------------------------------------------------------- wait
    async def wait_async(self, refs, num_returns, timeout, fetch_local=True):
        """Event-driven wait: owned refs await their memory-store event,
        borrowed refs park one long 'wait_object' call at the owner
        (owner-push readiness) — no per-tick probe RPCs (ref: ray.wait
        via WaitManager, memory-store wakeups)."""
        refs = list(refs)
        deadline = None if timeout is None else time.monotonic() + timeout

        # fast path: resolve already-ready refs synchronously — the common
        # wait() call sees mostly-complete refs and must not pay a watcher
        # task per ref
        ready_idx_fast: set[int] = set()
        for i, ref in enumerate(refs):
            if len(ready_idx_fast) >= num_returns:
                break
            entry = self.memory_store.get(ref.id)
            if entry is not None and entry.ready.is_set():
                ready_idx_fast.add(i)
            elif entry is None and self.store is not None \
                    and self.store.contains(ref.id):
                ready_idx_fast.add(i)
        if len(ready_idx_fast) >= num_returns:
            ready = [r for i, r in enumerate(refs) if i in ready_idx_fast]
            pending = [r for i, r in enumerate(refs) if i not in ready_idx_fast]
            return ready, pending

        async def one_ready(ref) -> bool:
            entry = self.memory_store.get(ref.id)
            if entry is not None:
                await entry.ready.wait()
                return True
            if self.store is not None and self.store.contains(ref.id):
                return True
            if not ref.owner_address or tuple(ref.owner_address) == self.address:
                # unknown local object: appears when its entry is created
                while self.store is None or not self.store.contains(ref.id):
                    entry = self.memory_store.get(ref.id)
                    if entry is not None:
                        await entry.ready.wait()
                        return True
                    await asyncio.sleep(0.05)
                return True
            park_fails = 0
            while True:  # borrowed: park at the owner
                try:
                    r = await self._owner_call(
                        ref, "wait_object",
                        {"object_id": ref.id.binary(), "timeout": 30.0}, 40.0,
                    )
                    park_fails = 0
                except Exception:
                    # capped exponential backoff: an owner mid-restart gets
                    # room to come back instead of a fixed-rate hammer
                    park_fails += 1
                    await asyncio.sleep(min(2.0, 0.25 * (2 ** park_fails))
                                        * (0.5 + random.random()))
                    continue
                if r.get("ready"):
                    if fetch_local and r.get("error") is None:
                        # start moving the payload to this node (ref:
                        # ray.wait fetch_local semantics)
                        self._bg.spawn(
                            self._pull_via_raylet(ref.id), self.loop)
                    return True
                if not r.get("known"):
                    await asyncio.sleep(0.2)  # not created yet (or freed)

        tasks = {
            asyncio.ensure_future(one_ready(ref)): i for i, ref in enumerate(refs)
        }
        ready_idx: set[int] = set()
        try:
            while len(ready_idx) < num_returns and tasks:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                done, _ = await asyncio.wait(
                    tasks, timeout=remaining, return_when=asyncio.FIRST_COMPLETED
                )
                if not done:
                    break  # timed out
                for t in done:
                    idx = tasks.pop(t)
                    if (len(ready_idx) < num_returns and not t.cancelled()
                            and t.exception() is None and t.result()):
                        ready_idx.add(idx)  # extras stay pending (wait contract)
        finally:
            for t in tasks:
                t.cancel()
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
        ready = [r for i, r in enumerate(refs) if i in ready_idx]
        pending = [r for i, r in enumerate(refs) if i not in ready_idx]
        return ready, pending

    # -------------------------------------------- owner-side object service
    async def rpc_get_object(self, conn, p):
        oid = ObjectID(p["object_id"])
        entry = self.memory_store.get(oid)
        if entry is None:
            if self.store is not None and self.store.contains(oid):
                return {"shm": True}
            return {"error": TaskError(f"object {oid} unknown to owner (freed?)")}
        await entry.ready.wait()
        if entry.error is not None:
            return {"error": entry.error}
        if entry.in_shm:
            return {"shm": True}
        if entry.packed is not None:
            return {"inline": entry.packed}
        meta, buffers = serialization.dumps_with_buffers(entry.value)
        return {"inline": _pack_bytes(meta, buffers, serialization.total_size(meta, buffers))}

    async def _try_reconstruct(self, oid: ObjectID) -> bool:
        """Re-execute the producing task to regenerate a lost object
        (ref: object_recovery_manager.h:43 — lineage-based recovery;
        deterministic task assumption, bounded attempts)."""
        task_id = oid.task_id()
        if task_id in self._cancelled_tasks:
            return False
        stash = self._lineage.get(task_id)
        if stash is None:
            return False
        n = self._reconstructions.get(oid, 0)
        if n >= 3:
            return False
        self._reconstructions[oid] = n + 1
        num_returns = stash["num_returns"]
        for i in range(num_returns):
            roid = ObjectID.for_task_return(task_id, i)
            self.memory_store[roid] = _MemEntry()  # fresh pending entries
        self.task_events.emit(task_id=task_id.hex(), name=stash.get("name", "task"),
                              state="PENDING_ARGS_AVAIL", reconstruction=n + 1)
        fresh = {**stash, "max_retries": self.cfg.default_max_task_retries}
        await self._submit_async(fresh)
        return True

    async def rpc_recover_object(self, conn, p):
        """Borrower-requested recovery of a lost owned object."""
        return await self._try_reconstruct(ObjectID(p["object_id"]))

    async def rpc_probe_object(self, conn, p):
        oid = ObjectID(p["object_id"])
        entry = self.memory_store.get(oid)
        if entry is not None:
            return entry.ready.is_set()
        return self.store is not None and self.store.contains(oid)

    async def rpc_wait_object(self, conn, p):
        """Owner-push readiness: the call parks here until the object is
        ready (or a timeout passes), replacing borrower-side probe polling
        (ref: WaitManager + owner memory-store wakeups)."""
        oid = ObjectID(p["object_id"])
        timeout = p.get("timeout", 60.0)
        entry = self.memory_store.get(oid)
        if entry is None:
            if self.store is not None and self.store.contains(oid):
                return {"ready": True}
            return {"ready": False, "known": False}
        deadline = time.monotonic() + timeout
        while not entry.ready.is_set():
            if conn._closed:  # requester gone: don't park for the full timeout
                return {"ready": False, "known": True}
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {"ready": False, "known": True}
            try:
                await asyncio.wait_for(entry.ready.wait(), min(1.0, remaining))
            except asyncio.TimeoutError:
                continue
        if entry.error is not None:
            return {"ready": True, "error": entry.error}
        return {"ready": True}

    # ------------------------------------------- native fast path (shm rings)
    # The steady-state submit->execute->reply loop of the reference's C++
    # NormalTaskSubmitter (normal_task_submitter.cc:28, core_worker.cc:2500)
    # realized over native SPSC shm rings: see core/fastpath.py for the
    # design. Everything here degrades to the ordinary RPC path.

    async def _fast_attach(self, key, state, w: _LeasedWorker):
        """Create a ring pair and hand it to a freshly leased same-node
        worker. Failure is silent: the lane simply never exists."""
        from ray_tpu_torch.core import fastpath

        self._fast_ring_seq += 1
        # once per worker LEASE (lane attach), not per record; the pid
        # must be read live for fork-safe shm naming (a cached pid
        # would collide post-fork)
        name = f"rtt_fp_{os.getpid()}_{self._fast_ring_seq}"  # raylint: disable=RT021 -- per-lease
        try:
            ring = fastpath.RingPair.create(name, self.cfg.fastpath_ring_bytes)
        except Exception:
            return
        try:
            ok = await w.conn.call(
                "attach_fast_ring",
                {"name": name, "owner": list(self.address),
                 "gpu_ids": w.gpu_ids}, timeout=10)
        except Exception:
            ok = False
        if not ok or w not in state.workers:
            ring.close_pair()
            return
        # both ends have it mapped: drop the name now, so a process that is
        # killed (workers are terminated, never shut down) leaks no
        # /dev/shm entry; the mapping lives until close_pair
        ring.unlink()
        lane = fastpath.FastLane(ring, w, key)
        t = _threading.Thread(target=self._fast_reader, args=(lane,),
                              name="rt-fastread", daemon=True)
        lane.reader = t
        w.fast_lane = lane
        self._fast_lanes.append(lane)
        t.start()

    def _try_fast_submit(self, fn, args, kwargs, resources,
                         max_retries=None):
        """User-thread fast submit. Returns an ObjectRef, or None to take
        the RPC path. Must never raise."""
        func_id = getattr(fn, "__rt_func_id__", None)
        if (func_id is None
                or not getattr(fn, "__rt_fast_ok__", False)
                or func_id not in self._registered_funcs):
            return None
        key = (func_id, tuple(sorted(resources.items())), None, -1, None,
               None)
        return self._fast_submit_keyed(fn, func_id, key, resources,
                                       args, kwargs,
                                       max_retries=max_retries)

    def _fast_submit_keyed(self, fn, func_id, key, resources, args, kwargs,
                           max_retries=None):
        """Shared fast-submit tail: the template path enters here directly
        with its precomputed scheduling key (skipping the per-call getattr
        probes and resources sort that _try_fast_submit re-derives)."""
        from ray_tpu_torch.core import fastpath

        if func_id in self._fast_ineligible_funcs:
            return None
        for a in args:
            if isinstance(a, ObjectRef):
                return None  # top-level refs are value-resolved on the loop
        if kwargs:
            for a in kwargs.values():
                if isinstance(a, ObjectRef):
                    return None
        if self._outgrows_ring(args, kwargs):
            return None
        state = self.sched_keys.get(key)
        if state is None:
            return None
        lanes = [w.fast_lane for w in list(state.workers)
                 if w.fast_lane is not None and not w.fast_lane.broken]
        if not lanes:
            return None
        # Burst traffic (tasks in flight, or back-to-back submits) rides
        # any lane: the ring amortizes thread wakes over the pipeline.
        # The coalescing window (defer) is wider: even a slow-moving
        # burst (per-call cost inflated by neighbor load) should buffer —
        # deferral is safe because it additionally requires in-ring work
        # the worker is already chewing on (see _fast_register_and_push).
        # ns clock: the SAME read serves burst detection AND the flight
        # recorder's submit stamp (no float math, no second clock call)
        now_ns = time.perf_counter_ns()
        gap_ns = now_ns - self._fast_last_submit
        burst = gap_ns < 200_000
        self._fast_last_submit = now_ns
        lone = False
        if not burst and not any(ln.inflight for ln in lanes):
            # Completion fast lane: a lone submit-then-block call rides
            # the ring too — the blocking get() steals the reply-ring
            # consumer (fast_prepass), so the round trip is two futex
            # wakes instead of an RPC frame + event-loop hop on each
            # side. Only onto a worker with no RPC batch committed: if
            # every leased worker is mid-batch, the RPC path's
            # free-worker routing wins.
            lanes = [ln for ln in lanes if not ln.worker.busy]
            if not lanes:
                return None
            lone = True
        cap = self.cfg.fastpath_inflight_max
        n = len(lanes)
        # lone submit/get loops stick to one lane: its worker pump stays
        # hot (spin-paired, no futex sleep) and the blocking get's steal
        # loop stays single-lane; round-robin is for pipelined bursts
        start = 0 if lone else self._task_counter % n
        lane = None
        for i in range(n):
            cand = lanes[(start + i) % n]
            if len(cand.inflight) < cap:
                lane = cand
                break
        if lane is None:
            return None
        self._task_counter += 1
        task_id = TaskID.generate()
        tid = task_id.binary()
        # flight-recorder stamp: perf_counter_ns is the same
        # CLOCK_MONOTONIC the worker pops against, so pop - t0 IS the
        # submit-ring hop
        t0 = now_ns if self._rec_enabled else 0
        # wire-level tracing (2.1): one branch when off/unsampled, a
        # 25-byte leg + submit point span when sampled
        trace = (self._trace_submit_leg(
            task_id, getattr(fn, "__name__", "task"), "ring")
            if self._trace_on else b"")
        try:
            rec = fastpath.pack_task(tid, func_id, args, kwargs, t0, trace)
        except Exception:
            self._trace_pending.pop(ObjectID.for_task_return(task_id, 0),
                                    None)
            return None  # plain pickle can't carry it: cloudpickle path
        if len(rec) > self._ring_record_cap:
            self._trace_pending.pop(ObjectID.for_task_return(task_id, 0),
                                    None)
            return None  # big args belong in the object store
        ref = self._fast_register_and_push(
            lane, task_id, rec,
            (fn, args, kwargs, resources, max_retries),
            defer=gap_ns < 2_000_000, t0=t0)
        if ref is None:
            self._trace_pending.pop(ObjectID.for_task_return(task_id, 0),
                                    None)
            return None
        lane.worker.idle_since = time.monotonic()  # keep the lease warm
        metrics.tasks_submitted.inc()
        # Demand signaling: tasks queued beyond one-per-worker must still
        # surface as lease demand (raylet _lease_waiters feeds the
        # autoscaler and spillback) even though they ride the rings — but
        # only once the backlog PERSISTS (see fast_backlog_since, kept in
        # seconds: _maybe_spawn_lease/_report_demand compare it against
        # time.monotonic(), the same clock as perf_counter on Linux).
        if len(lane.inflight) > 1:
            now_s = now_ns * 1e-9
            if state.fast_backlog_since == 0.0:
                state.fast_backlog_since = now_s
            elif (now_s - state.fast_backlog_since > 0.5
                    and now_s - self._fast_demand_kick > 0.25):
                self._fast_demand_kick = now_s
                self._call_on_loop(self._pump(key, state))
        else:
            state.fast_backlog_since = 0.0
        return ref

    def _fast_register_and_push(self, lane, task_id: TaskID, rec: bytes,
                                light, defer: bool = False, t0: int = 0,
                                track: bool = True):
        """Shared submit tail for task and actor lanes: register the
        in-flight entry under the cv, create the pending memory-store
        entry, then push — coalesced: the framed record lands in the
        lane's txbuf and rides one native batch push per burst instead of
        one ring lock + consumer wake per record. The record pushes
        immediately unless ``defer`` (burst detected) AND the worker
        already has in-ring work to chew on; a deferred tail is flushed
        by the threshold caps, the next blocking get() (fast_prepass), or
        the flusher thread's linger timer. On a closed ring undo — unless
        a concurrent break-lane already snapshotted our entry and
        resubmitted it over RPC, in which case the ref is handed out
        as-is (no duplicate call).

        ``track=False`` (the serve router's untracked calls): no
        memory-store entry and no ObjectRef — the return value is True
        on success, None for the RPC fallback; completion/break state
        reaches the caller through its registered loop waiter
        instead."""
        from ray_tpu_torch.core import fastpath

        oid = ObjectID.for_task_return(task_id, 0)
        with self._fast_cv:
            if lane.broken or lane.retired:
                return None  # lost the race with a lane retire/break
            lane.inflight[task_id] = light
            # the oid entry carries the recorder's submit stamp too: one
            # dict op serves routing AND telemetry (t0 is 0 when the
            # recorder is off)
            self._fast_oid_lane[oid] = (lane, t0)
        if track:
            self.memory_store[oid] = _MemEntry()
        cfg = self.cfg
        kick = False
        undo = False
        framed = fastpath.frame_one(rec)
        maxrec = lane.flush_max_records or cfg.fastpath_flush_max_records
        maxbytes = lane.flush_max_bytes or cfg.fastpath_flush_max_bytes
        with lane.txlock:
            lane.txbuf.append(framed)
            lane.txbytes += len(framed)
            if (defer and maxrec > 1
                    and len(lane.inflight) > len(lane.txbuf)
                    and len(lane.txbuf) < maxrec
                    and lane.txbytes < maxbytes):
                status = 0
                kick = len(lane.txbuf) == 1  # arm the linger backstop
            else:
                status = self._fast_flush_locked(lane, timeout_ms=0)
                if (status == 0 and lane.txbuf
                        and lane.txbuf[-1] is framed):
                    # ring full and OUR record didn't make it in: keep the
                    # pre-coalescing spill semantics — undo and route this
                    # task over RPC (other workers stay usable) instead of
                    # parking it behind one saturated lane. Earlier
                    # deferred leftovers stay for the flusher.
                    lane.txbuf.pop()
                    lane.txbytes -= len(framed)
                    undo = True
                kick = bool(lane.txbuf)  # leftovers: flusher finishes
        if kick:
            self._fast_flush_kick()
        if status < 0 or undo:  # closed/unusable/full: undo, use RPC path
            if status < 0 and status != fastpath._ST_CLOSED:
                self._fast_break_lane(lane)  # kTooBig/sys: nobody else will
            with self._fast_cv:
                owned = lane.inflight.pop(task_id, None) is not None
                self._fast_oid_lane.pop(oid, None)
            if not owned:
                # a concurrent break-lane snapshotted the entry: tracked
                # tasks were resubmitted over RPC (the ref resolves);
                # untracked ones had their waiter woken with the broken
                # sentinel — either way the call is someone else's now
                return self._new_owned_ref(oid) if track else True
            if not track:
                return None
            self.memory_store.pop(oid, None)
            return None
        return self._new_owned_ref(oid) if track else True

    def _fast_flush_locked(self, lane, timeout_ms: int = 0) -> int:
        """Push the lane's buffered records (caller holds lane.txlock) in
        ONE native batch. Returns 0 when the buffer advanced or the
        remainder may stay buffered (ring momentarily full — the flusher
        retries); a negative ring status when the ring is closed/unusable
        (buffer dropped: every buffered task is registered in
        lane.inflight, and the break-lane path owns their recovery)."""
        from ray_tpu_torch.core import fastpath

        if not lane.txbuf:
            return 0
        framed = (lane.txbuf[0] if len(lane.txbuf) == 1
                  else b"".join(lane.txbuf))
        pushed = lane.ring.push_batch(fastpath.SUB, framed, timeout_ms)
        if pushed < 0:
            lane.txbuf.clear()
            lane.txbytes = 0
            return pushed
        if pushed >= len(framed):
            self._fast_tx_flushes += 1
            self._fast_tx_records += len(lane.txbuf)
            rec_r = recorder.get_recorder() if self._rec_enabled else None
            if rec_r is not None:  # one event per FLUSH, not per task
                rec_r.record(b"", recorder.RING_PUSH,
                             a0=len(lane.txbuf), a1=pushed)
            lane.txbuf.clear()
            lane.txbytes = 0
            return 0
        if pushed:
            off = consumed = 0
            for fr in lane.txbuf:
                off += len(fr)
                if off > pushed:
                    break
                consumed += 1
            self._fast_tx_flushes += 1
            self._fast_tx_records += consumed
            rec_r = recorder.get_recorder() if self._rec_enabled else None
            if rec_r is not None:
                rec_r.record(b"", recorder.RING_PUSH,
                             a0=consumed, a1=pushed)
            del lane.txbuf[:consumed]
            lane.txbytes -= pushed
        return 0

    def _fast_flush_lane(self, lane, timeout_ms: int = 0) -> int:
        with lane.txlock:
            status = self._fast_flush_locked(lane, timeout_ms)
            leftover = bool(lane.txbuf)
        if status < 0:
            from ray_tpu_torch.core import fastpath

            if status != fastpath._ST_CLOSED:
                self._fast_break_lane(lane)
        elif leftover:
            self._fast_flush_kick()  # ring full: the flusher retries
        return status

    def _fast_flush_kick(self):
        if self._fast_flusher_thread is None:
            self._ensure_fast_flusher()
        with self._fast_flush_cv:
            self._fast_flush_dirty = True
            self._fast_flush_cv.notify()

    def _ensure_fast_flusher(self):
        with self._fast_flush_cv:
            if self._fast_flusher_thread is not None:
                return
            t = _threading.Thread(target=self._fast_flusher,
                                  name="rt-fastflush", daemon=True)
            self._fast_flusher_thread = t
        t.start()

    def _fast_flusher(self):
        """Backstop flusher: bounds how long a burst's buffered tail can
        sit when no threshold or blocking get() flushes it (wait(), pure
        fire-and-forget). One wake per buffering episode, not per record."""
        linger = max(0.0, self.cfg.fastpath_flush_linger_us / 1e6)
        while not self._closed:
            with self._fast_flush_cv:
                while not self._fast_flush_dirty and not self._closed:
                    self._fast_flush_cv.wait(0.5)
                self._fast_flush_dirty = False
            if self._closed:
                return
            if linger:
                time.sleep(linger)  # let the burst tail accumulate
            again = False
            for lane in list(self._fast_lanes):
                if lane.txbytes and not lane.broken:
                    self._fast_flush_lane(lane, timeout_ms=20)
                    if lane.txbytes:
                        again = True
            if again:
                with self._fast_flush_cv:
                    self._fast_flush_dirty = True

    def fast_flush_stats(self) -> dict:
        """Coalescing counters for bench.py: batch pushes and the records
        they carried (avg_batch == 1.0 means no coalescing happened)."""
        flushes, records = self._fast_tx_flushes, self._fast_tx_records
        return {
            "flushes": flushes,
            "records": records,
            "avg_batch": (records / flushes) if flushes else 0.0,
        }

    def native_stats(self) -> dict:
        """Zero-copy view of the native transport counters: per-direction
        ring stats summed over live lanes (both sides of each ring share
        one shm stats block, so this covers the workers' halves too) and
        the local arena's store stats."""
        out: dict = {"ring": {}, "store": None}
        for which, label in ((0, "sub"), (1, "rep")):
            agg: dict[str, int] = {}
            for lane in list(self._fast_lanes):
                st = lane.ring.stats(which)
                if st:
                    for k, v in st.items():
                        if k == "peak_used":
                            # a SUM of per-lane peaks is an occupancy
                            # that never existed; the ring-sizing signal
                            # is the worst single lane
                            agg[k] = max(agg.get(k, 0), v)
                        else:
                            agg[k] = agg.get(k, 0) + v
            out["ring"][label] = agg
        if self.store is not None and not self.client_mode:
            try:
                out["store"] = self.store.stats()
            except object_store.ObjectStoreError:
                pass  # arena torn down mid-flush: skip this sample
        return out

    def _publish_recorder_metrics(self) -> None:
        """Flush-timer hook: fold the flight recorder's window and the
        native shm counters into the metrics registry (gauges + sampled
        stage histograms). Runs 1/s off the hot path; every aggregation
        here is bounded (capped windows, bulk bisect feed) so the flush
        can never grow past ~1ms and tax the A/B's CPU counter."""
        self._rec_enabled = recorder.enabled()  # refresh the hot-path gate
        # arena watermark gauges (tiering registry): live/peak/capacity
        # bytes per registered arena, sampled here so the rollup plane
        # gets watermark history on every flush. Bounded: one provider
        # call per arena, a handful of arenas per process.
        from ray_tpu_torch.core import tiering as _tiering

        for aname, ast in _tiering.sample_arenas().items():
            metrics.arena_bytes.set(ast["bytes"], tags={"arena": aname})
            metrics.arena_peak_bytes.set(ast["peak"], tags={"arena": aname})
            if ast["capacity"]:
                metrics.arena_capacity_bytes.set(
                    ast["capacity"], tags={"arena": aname})
        # native ring/store gauges first, UNGATED: the shm counters move
        # with puts/gets/ring traffic even when no new task sample landed
        ns = self.native_stats()
        for label, agg in ns["ring"].items():
            for k, v in agg.items():
                metrics.fastpath_ring.set(v, tags={"which": label, "stat": k})
        if ns["store"]:
            for k, v in ns["store"].items():
                metrics.object_store_stat.set(v, tags={"stat": k})
        astats = self._actor_stats if self._rec_enabled else None
        if (astats is not None and astats.n
                and astats.n != self._actor_rec_published):
            # actor-call stage families, same bounded feed as tasks below
            # (stage tags prefixed actor_*)
            self._actor_rec_published = astats.n
            fresh = astats.new_since_flush()
            if fresh:
                for i, name in enumerate(recorder.LATENCY_STAGES):
                    metrics.task_stage_seconds.observe_many(
                        [s[i] / 1e9 for s in fresh],
                        tags={"stage": f"actor_{name}"})
            win = astats.window(512)
            for i, name in enumerate(recorder.LATENCY_STAGES):
                vals = sorted(s[i] for s in win)
                for q, qn in ((0.5, "p50"), (0.99, "p99")):
                    metrics.task_stage_us.set(
                        recorder.percentile(vals, q) / 1e3,
                        tags={"stage": f"actor_{name}", "q": qn})
        stats = recorder.get_stats() if self._rec_enabled else None
        if stats is None or stats.n == 0 or stats.n == self._rec_published:
            return  # recorder off / idle: stage aggregation has no new work
        # write the drained tasks' SAMPLE slots into the recorder ring
        # now (bounded to the newest 64 per flush): the hot path only
        # stored raw tuples, and timeline/event expansion reads these
        rec_r = recorder.get_recorder()
        prev = max(self._rec_published, 0)
        if rec_r is not None and stats.n > prev:
            for raw in stats.raw_window(min(stats.n - prev, 64)):
                ring_ns, deser_ns, exec_ns, reply_ns, total = \
                    recorder.decode_sample(raw)
                rec_r.record_sample(raw[2], raw[1], ring_ns, deser_ns,
                                    exec_ns, reply_ns, total)
        self._rec_published = stats.n
        metrics.recorder_samples.set(stats.n)
        # histogram feed is bounded per flush (newest samples win): under
        # full load this is deliberate sampling, not a per-task tax
        fresh = stats.new_since_flush()
        if fresh:
            for i, name in enumerate(recorder.LATENCY_STAGES):
                metrics.task_stage_seconds.observe_many(
                    [s[i] / 1e9 for s in fresh], tags={"stage": name})
        win = stats.window(512)
        for i, name in enumerate(recorder.LATENCY_STAGES):
            vals = sorted(s[i] for s in win)
            for q, qn in ((0.5, "p50"), (0.99, "p99")):
                metrics.task_stage_us.set(
                    recorder.percentile(vals, q) / 1e3,
                    tags={"stage": name, "q": qn})

    def _latency_snapshot(self) -> dict | None:
        """Publishable per-stage latency window (GCS ns="latency"):
        stage duration lists for list_task_latency percentiles plus the
        newest raw samples (wall-anchored) for timeline enrichment.
        Skipped while idle — the flush marks ``_lat_published`` after a
        successful kv_put, so an idle driver doesn't decode/pickle/ship
        a byte-identical ~40KB window every second forever."""
        stats = recorder.get_stats() if recorder.enabled() else None
        rec_r = recorder.get_recorder() if stats is not None else None
        if rec_r is None or stats.n == self._lat_published:
            return None
        snap = stats.snapshot(rec_r.anchor_wall, rec_r.anchor_perf)
        if snap is None:
            return None
        samples = []
        for raw in stats.raw_window(256):
            ring_ns, deser_ns, exec_ns, reply_ns, _total = \
                recorder.decode_sample(raw)
            samples.append((raw[2].hex(), rec_r.wall_ns(raw[1]), ring_ns,
                            deser_ns, exec_ns, reply_ns))
        snap["samples"] = samples
        snap["worker_id"] = self.worker_id.hex()
        return snap

    def _actor_latency_snapshot(self) -> dict | None:
        """Latency-source hook (flush timer): the actor-call stage window
        as actor_*-prefixed stage lists, skipped while idle. Publish is
        confirmed by _actor_latency_confirm only after the kv_put LANDS,
        so a transient GCS error republishes the window next flush."""
        stats = self._actor_stats
        if stats is None or stats.n == 0 or stats.n == self._actor_lat_published:
            return None
        win = stats.window(1024)
        if not win:
            return None
        self._actor_lat_pending = stats.n
        return {"count": stats.n,
                "stages": {f"actor_{name}": [s[i] for s in win]
                           for i, name in enumerate(recorder.LATENCY_STAGES)}}

    def _actor_latency_confirm(self) -> None:
        self._actor_lat_published = self._actor_lat_pending

    async def _fast_actor_attach(self, actor_id: ActorID, conn):
        """Ring lane to a same-node actor's worker: actor calls then skip
        the loop + socket entirely, with the ring's SPSC order AS the
        per-caller FIFO (ref: actor_task_submitter.h:75 ordered sends)."""
        from types import SimpleNamespace

        from ray_tpu_torch.core import fastpath

        if self.cfg.tunnel_force:
            return  # bench/test: the tunnel lane owns even local actors
        existing = self._fast_actor_lanes.get(actor_id)
        if existing is not None:
            if not existing.broken and existing.worker.conn is conn:
                return  # live lane on this very connection
            # stale lane from a previous (dead) connection: break it now
            # rather than waiting for the health sweep — otherwise the
            # reconnected actor would silently stay on the RPC path
            self._fast_break_lane(existing)
        info = self._actor_info.get(actor_id)
        if info is None or info.get("node_id") != self.node_id:
            return
        self._fast_ring_seq += 1
        name = f"rtt_fp_{os.getpid()}_a{self._fast_ring_seq}"
        try:
            ring = fastpath.RingPair.create(name, self.cfg.fastpath_ring_bytes)
        except Exception:
            return
        try:
            ok = await conn.call(
                "attach_fast_ring",
                {"name": name, "kind": "actor",
                 "owner": list(self.address)}, timeout=10)
        except Exception:
            ok = False
        methods = None
        if isinstance(ok, dict):  # 1.8 reply: method eligibility table
            methods = ok.get("methods")
            ok = ok.get("ok")
        if not ok or self._actor_conns.get(actor_id) is not conn:
            ring.close_pair()
            return
        ring.unlink()  # both ends have it mapped (see _fast_attach)
        lane = fastpath.FastLane(
            ring,
            SimpleNamespace(conn=conn, fast_lane=None, idle_since=0.0,
                            queued=0),
            ("actor", actor_id))
        lane.methods = methods
        lane.drain_evt = asyncio.Event()  # created ON the loop (waiters too)
        t = _threading.Thread(target=self._fast_reader, args=(lane,),
                              name="rt-fastread-actor", daemon=True)
        lane.reader = t
        self._fast_actor_lanes[actor_id] = lane
        self._fast_lanes.append(lane)
        t.start()

    # ------------------------------------- cross-node tunnels (core/tunnel.py)
    def _tunnel_ok(self) -> bool:
        return (self.cfg.node_tunnel and self.cfg.fastpath_enabled
                and not self.client_mode and not self._closed)

    def _tunnel_client(self):
        if self._tunnels is None:
            from ray_tpu_torch.core import tunnel as _tunnel

            self._tunnels = _tunnel.TunnelClient(self)
        return self._tunnels

    def tunnel_stats(self) -> dict:
        """Tunnel coalescing counters (bench.py tunnel arm, tests);
        zeros when no tunnel was ever dialed."""
        if self._tunnels is None:
            return {"tunnels": 0, "lanes": 0, "tx_frames": 0,
                    "tx_records": 0, "rx_frames": 0, "rx_records": 0,
                    "avg_batch": 0.0}
        return self._tunnels.stats()

    async def _tunnel_actor_attach(self, actor_id: ActorID, conn):
        """Tunnel lane to a REMOTE actor's worker (the cross-node twin
        of _fast_actor_attach): actor calls then ride coalesced
        ring-format frames over the node tunnel instead of per-call
        pickled RPC specs. Failure is silent — the RPC path serves the
        actor and the health loop retries the bind."""
        from types import SimpleNamespace

        from ray_tpu_torch.core import fastpath

        existing = self._fast_actor_lanes.get(actor_id)
        if existing is not None:
            if not existing.broken:
                # live — or RETIRED but still draining: force-breaking a
                # draining lane would resubmit records the worker is
                # still executing (double execution); the drain path
                # closes it and pops the map entry, after which the
                # health sweep lands back here for a fresh bind
                return
            self._fast_break_lane(existing)  # idempotent map cleanup
        info = self._actor_info.get(actor_id)
        if info is None or info.get("state") != ALIVE:
            return
        same = info.get("node_id") == self.node_id
        if same and not self.cfg.tunnel_force:
            return  # same-node: the shm ring lane owns this actor
        if same:
            addr = tuple(self.raylet_address)
        else:
            nid = info.get("node_id")
            nid_hex = nid.hex() if hasattr(nid, "hex") else str(nid)
            addr = await self._node_address(nid_hex)
            if addr is None:
                return
        try:
            bound = await self._tunnel_client().bind_lane(
                tuple(addr), kind="actor", actor_id=actor_id.hex())
        except Exception:
            log.debug("tunnel actor bind failed", exc_info=True)
            return
        if bound is None:
            return
        tun, lane_id, ring, methods = bound
        if (self._actor_conns.get(actor_id) is not conn
                or self._fast_actor_lanes.get(actor_id) is not None):
            ring.close_pair()
            return
        lane = fastpath.FastLane(
            ring,
            SimpleNamespace(conn=conn, fast_lane=None, idle_since=0.0,
                            queued=0),
            ("actor", actor_id))
        lane.methods = methods
        lane.drain_evt = asyncio.Event()
        # widened coalescing: one tunnel frame amortizes over far more
        # records than one ring wake — let bursts pack deeper
        lane.flush_max_records = self.cfg.fastpath_flush_max_records * 8
        lane.flush_max_bytes = self.cfg.fastpath_flush_max_bytes * 8
        tun.register(lane_id, lane, ring)
        self._fast_actor_lanes[actor_id] = lane
        self._fast_lanes.append(lane)
        self._tunnel_actor_seen[actor_id] = tuple(addr)

    async def _tunnel_task_attach(self, key, state, w: _LeasedWorker):
        """Tunnel lane to a remotely leased task worker (the cross-node
        twin of _fast_attach): eligible submits then ride "Q"/"R"
        records over the node tunnel, coalesced by the same txbuf
        machinery the shm lanes use."""
        from ray_tpu_torch.core import fastpath

        try:
            bound = await self._tunnel_client().bind_lane(
                tuple(w.raylet_address), kind="task",
                worker_id=w.worker_id)
        except Exception:
            log.debug("tunnel task bind failed", exc_info=True)
            return
        if bound is None:
            return
        tun, lane_id, ring, _ = bound
        if w not in state.workers or w.fast_lane is not None:
            ring.close_pair()
            return
        lane = fastpath.FastLane(ring, w, key)
        lane.flush_max_records = self.cfg.fastpath_flush_max_records * 8
        lane.flush_max_bytes = self.cfg.fastpath_flush_max_bytes * 8
        tun.register(lane_id, lane, ring)
        w.fast_lane = lane
        self._fast_lanes.append(lane)

    def _outgrows_ring(self, args, kwargs) -> bool:
        """True when one top-level argument alone is larger than a ring
        record may be: the call takes the RPC path, which seals it into
        the arena, without pickling it for the ring first."""
        cap = self._ring_record_cap
        for a in (*args, *kwargs.values()) if kwargs else args:
            n = getattr(a, "nbytes", None)
            if type(n) is int and n > cap:
                return True
        return False

    def _tunnel_shrink_args(self, args, kwargs):
        """Descriptor conversion for an oversized tunnel record: every
        big top-level value (bytes / buffer-backed array) seals into the
        LOCAL shm arena and its slot ships a (node, oid, nbytes)
        TunnelArgRef instead — the receiver adopts the set via one
        batched pull. Returns (args, kwargs, pin refs) or None when
        nothing here is shrinkable (the call takes the RPC path, which
        ships payloads through the object plane anyway)."""
        from ray_tpu_torch.core import fastpath

        cap = self.cfg.tunnel_inline_max
        pins: list = []

        def conv(v):
            n = getattr(v, "nbytes", None)
            if n is None and isinstance(v, (bytes, bytearray, memoryview)):
                n = len(v)
            if not isinstance(n, int) or n <= cap:
                return v
            try:
                ref = self.put_value(v, prefer_shm=True)
            except Exception:
                return v
            pins.append(ref)
            return fastpath.TunnelArgRef(
                ref.id.binary(), tuple(self.address),
                self.node_id.binary(), int(n))

        args2 = tuple(conv(a) for a in args)
        kwargs2 = ({k: conv(v) for k, v in kwargs.items()}
                   if kwargs else kwargs)
        if not pins:
            return None
        return args2, kwargs2, pins

    def actor_call_template(self, actor_id: ActorID, method: str,
                            num_returns, concurrency_group) -> ActorCallTemplate:
        """Build the frozen per-(handle, method) submission template
        (cached on the ActorMethod by ref.ActorMethod.remote)."""
        t = ActorCallTemplate()
        t.core = self
        t.actor_id = actor_id
        t.method = method
        t.mkey = b"am:" + method.encode()
        t.opts_ok = num_returns == 1 and concurrency_group is None
        t.lane = None
        return t

    def fast_actor_lane_stats(self, actor_id: ActorID) -> dict | None:
        """Seq/out-of-order accounting of an actor's ring lane (tests,
        bench): None when no lane is attached."""
        lane = self._fast_actor_lanes.get(actor_id)
        if lane is None:
            return None
        return {"next_seq": lane.next_seq, "done_seq": lane.done_seq,
                "ooo_replies": lane.ooo_replies, "broken": lane.broken,
                "retired": lane.retired, "inflight": len(lane.inflight)}

    def _fast_resolve_ref_args(self, args, kwargs):
        """Top-level ObjectRef arguments: resolve the locally-ready ones
        inline on the caller thread (the completion lane's
        get_local_prepass — ready memory-store entries and sealed local
        shm objects, zero event-loop round trip) so the call stays on the
        ring. Returns (args, kwargs, ok); ok=False when any ref is still
        pending/remote/errored — THAT call takes the RPC path (which owns
        dependency blocking and error surfacing), the lane stays live."""
        refs = [a for a in args if isinstance(a, ObjectRef)]
        if kwargs:
            refs.extend(v for v in kwargs.values()
                        if isinstance(v, ObjectRef))
        if not refs:
            return args, kwargs, True
        hits = self.get_local_prepass(refs)
        for r in refs:
            hit = hits.get(r.id)
            if hit is None or hit[0] != "V":
                return args, kwargs, False
        args = tuple(hits[a.id][1] if isinstance(a, ObjectRef) else a
                     for a in args)
        if kwargs:
            kwargs = {k: hits[v.id][1] if isinstance(v, ObjectRef) else v
                      for k, v in kwargs.items()}
        return args, kwargs, True

    def _try_fast_actor_submit(self, actor_id: ActorID, method: str,
                               args, kwargs, tmpl=None):
        """User-thread fast actor call; None -> RPC path for THIS call
        only (per-call downgrade — the lane survives). FIFO across the
        mixed stream: a slow-path call drains the lane's in-flight
        records before dispatching (_prepare_actor_task), and while RPC
        calls are queued/in-flight this gate keeps new calls off the ring
        so ring and socket traffic can never reorder a caller's calls."""
        from ray_tpu_torch.core import fastpath

        # Loop-resident callers (the serve router, async actor methods
        # making nested calls) stay on the RPC path: its reply applies
        # directly ON the loop, while a ring completion detours through
        # the sweeper thread + migrate queue — two extra handoffs that
        # measured a ~40% serve_qps hit on a 2-vCPU box. The ring wins
        # for user threads, where the blocking get() steals the reply
        # consumer; a loop caller can never block-steal.
        if _threading.get_ident() == getattr(self.loop, "_thread_id", None):
            return None
        lane = tmpl.lane if tmpl is not None else None
        if lane is None or lane.broken or lane.retired:
            lane = self._fast_actor_lanes.get(actor_id)
            if lane is None or lane.broken or lane.retired:
                if tmpl is not None:
                    tmpl.lane = None
                return None
            if tmpl is not None:
                tmpl.lane = lane  # rebind on (re)attach
        # worker-shipped eligibility: generator methods and names the
        # worker never heard of go RPC per call, without a ring round trip
        mt = lane.methods
        if mt is not None:
            v = mt.get(method)
            if v is None or v[0] == "gen":
                return None
        # per-caller FIFO: never overtake queued/in-flight RPC calls
        if self._actor_queues.get(actor_id) or self._actor_inflight.get(
                actor_id):
            return None
        tunnel = getattr(lane.ring, "tunnel", False)
        if not tunnel and self._outgrows_ring(args, kwargs):
            return None
        has_ref = any(isinstance(a, ObjectRef) for a in args)
        if not has_ref and kwargs:
            has_ref = any(isinstance(v, ObjectRef) for v in kwargs.values())
        if has_ref:
            args, kwargs, ok = self._fast_resolve_ref_args(args, kwargs)
            if not ok:
                return None  # pending/remote ref: RPC path for this call
        task_id = TaskID.generate_actor()
        tid = task_id.binary()
        now_ns = time.perf_counter_ns()
        t0 = now_ns if self._rec_enabled else 0
        mkey = tmpl.mkey if tmpl is not None else b"am:" + method.encode()
        # seq label rides the record (protocol 1.8): lock-free draw — a
        # racing retire is caught by _fast_register_and_push under the cv
        seq = next(lane.seq_counter)
        lane.next_seq = seq + 1  # advisory mirror (stats/tests)
        light = ("actor", actor_id, method, args, kwargs)
        pins = None
        trace = (self._trace_submit_leg(
            task_id, method, "tunnel" if tunnel else "ring")
            if self._trace_on else b"")
        try:
            rec = fastpath.pack_actor_task(tid, mkey, args, kwargs, t0,
                                           seq, trace)
        except Exception:
            self._trace_pending.pop(ObjectID.for_task_return(task_id, 0),
                                    None)
            return None  # unpicklable args: RPC path for this call
        if len(rec) > self.cfg.tunnel_inline_max and tunnel:
            # oversized args do NOT ride the tunnel: seal them locally
            # and ship (node, oid, nbytes) descriptors; the worker
            # adopts the set via one batched pull. light keeps the
            # ORIGINAL args so break-lane recovery replays faithfully.
            shrunk = self._tunnel_shrink_args(args, kwargs)
            if shrunk is not None:
                s_args, s_kwargs, pins = shrunk
                try:
                    rec = fastpath.pack_actor_task(
                        tid, mkey, s_args, s_kwargs, t0, seq, trace)
                except Exception:
                    self._trace_pending.pop(
                        ObjectID.for_task_return(task_id, 0), None)
                    return None
        if len(rec) > self._ring_record_cap:
            self._trace_pending.pop(ObjectID.for_task_return(task_id, 0),
                                    None)
            return None  # big args belong in the object store
        gap_ns = now_ns - self._fast_last_submit
        self._fast_last_submit = now_ns
        if pins:
            self._tunnel_pins[task_id] = pins
        ref = self._fast_register_and_push(
            lane, task_id, rec, light,
            defer=gap_ns < 2_000_000, t0=t0)
        if ref is None:
            self._tunnel_pins.pop(task_id, None)
            self._trace_pending.pop(ObjectID.for_task_return(task_id, 0),
                                    None)
        else:
            metrics.actor_calls.inc()
        return ref

    def fast_actor_submit_loop(self, actor_id: ActorID, method: str,
                               args, kwargs, tmpl=None):
        """LOOP-thread fast actor submit — the serve data plane's router
        hop. The thread-path fast lane (_try_fast_actor_submit) refuses
        loop-resident callers because its reply detours through the
        migrate queue's 2ms linger; this variant registers an
        asyncio.Future the reply thread resolves DIRECTLY (one
        call_soon_threadsafe per reply batch), so a router coroutine
        gets (status, payload) the moment the completion record pops.

        UNTRACKED, by design: no ObjectRef, no memory-store entry, no
        task events, no migrate-queue bookkeeping, and — unlike every
        other fast path — no automatic RPC resubmission on a broken
        lane. The serve router OWNS the request lifecycle: its promise
        ref is the caller-visible handle, and its retry_on idempotency
        gate decides whether a maybe-executed request may replay (core
        at-least-once resubmission would re-execute non-idempotent
        requests behind the router's back). A lane break therefore
        surfaces as ConnectionLost from :meth:`fast_actor_await` — the
        same exception the RPC plane raises for a died-mid-request
        replica. Inline results skip the whole owned-object plane; only
        shm-sealed results (> fastpath_inline_result_max) mint a ref at
        await time to ride the normal read/free path.

        Unordered, also by design (every serve request is an
        independent logical call): no FIFO gate against queued RPC
        traffic in either direction.

        Returns ``(task_id, future)`` or None — None means THIS call
        takes the RPC path (per-call fallback, the lane stays live): no
        live lane, ineligible method, pending/remote ref args, or an
        oversized record. Sampled trace context rides the record's wire
        leg (2.1), so these calls are no longer trace-invisible. Decode
        the future with :meth:`fast_actor_await`."""
        from ray_tpu_torch.core import fastpath

        lane = tmpl.lane if tmpl is not None else None
        if lane is None or lane.broken or lane.retired:
            lane = self._fast_actor_lanes.get(actor_id)
            if lane is None or lane.broken or lane.retired:
                if tmpl is not None:
                    tmpl.lane = None
                return None
            if tmpl is not None:
                tmpl.lane = lane  # rebind on (re)attach
        mt = lane.methods
        if mt is not None:
            v = mt.get(method)
            if v is None or v[0] == "gen":
                return None
        has_ref = any(isinstance(a, ObjectRef) for a in args)
        if not has_ref and kwargs:
            has_ref = any(isinstance(v, ObjectRef) for v in kwargs.values())
        if has_ref:
            args, kwargs, ok = self._fast_resolve_ref_args(args, kwargs)
            if not ok:
                return None  # pending/remote ref: RPC path for this call
        tunnel = getattr(lane.ring, "tunnel", False)
        if not tunnel and self._outgrows_ring(args, kwargs):
            return None
        task_id = TaskID.generate_actor()
        tid = task_id.binary()
        now_ns = time.perf_counter_ns()
        t0 = now_ns if self._rec_enabled else 0
        mkey = tmpl.mkey if tmpl is not None else b"am:" + method.encode()
        seq = next(lane.seq_counter)
        lane.next_seq = seq + 1
        pins = None
        trace = (self._trace_submit_leg(
            task_id, method, "tunnel" if tunnel else "ring")
            if self._trace_on else b"")
        try:
            rec = fastpath.pack_actor_task(tid, mkey, args, kwargs, t0,
                                           seq, trace)
        except Exception:
            self._trace_pending.pop(ObjectID.for_task_return(task_id, 0),
                                    None)
            return None  # unpicklable args: RPC path for this call
        if len(rec) > self.cfg.tunnel_inline_max and tunnel:
            # cross-node serve payload above the inline cap: descriptor
            # shipping (see _try_fast_actor_submit)
            shrunk = self._tunnel_shrink_args(args, kwargs)
            if shrunk is not None:
                s_args, s_kwargs, pins = shrunk
                try:
                    rec = fastpath.pack_actor_task(
                        tid, mkey, s_args, s_kwargs, t0, seq, trace)
                except Exception:
                    self._trace_pending.pop(
                        ObjectID.for_task_return(task_id, 0), None)
                    return None
        if len(rec) > self._ring_record_cap:
            self._trace_pending.pop(ObjectID.for_task_return(task_id, 0),
                                    None)
            return None  # big args belong in the object store
        if pins:
            self._tunnel_pins[task_id] = pins
        oid = ObjectID.for_task_return(task_id, 0)
        fut = self.loop.create_future()
        with self._fast_cv:
            self._fast_loop_waiters[oid] = fut
        self._fast_last_submit = now_ns
        # never defer: the caller's coroutine parks on the reply — a
        # buffered submit tail would trade its latency for nothing
        ok = self._fast_register_and_push(
            lane, task_id, rec, ("serve", actor_id, method),
            defer=False, t0=t0, track=False)
        if ok is None:
            with self._fast_cv:
                self._fast_loop_waiters.pop(oid, None)
            self._tunnel_pins.pop(task_id, None)
            self._trace_pending.pop(oid, None)
            return None
        metrics.actor_calls.inc()
        return task_id, fut

    async def fast_actor_await(self, task_id: TaskID, fut, timeout=None):
        """Decode a fast_actor_submit_loop reply: returns the call's
        value or raises its (typed) exception. Raises

        - :class:`FastLaneDeclined` when the worker NEED_SLOWed the
          record (stale method table) — the call never executed, the
          caller re-dispatches it over RPC;
        - ``rpc.ConnectionLost`` when the lane broke mid-flight — the
          replica may have executed the request, so the caller's own
          idempotency policy decides about a replay (exactly the
          died-mid-request contract of the RPC plane);
        - ``GetTimeoutError`` when ``timeout`` elapses first (the
          in-flight call keeps running; its late reply resolves the
          abandoned future, which nobody awaits)."""
        from ray_tpu_torch.core import fastpath
        from ray_tpu_torch.core.ref import GetTimeoutError

        deadline = None if timeout is None else time.monotonic() + timeout
        if timeout is None:
            status, payload = await fut
        else:
            # manual timer instead of asyncio.wait_for: this await is on
            # EVERY fast serve request, and wait_for's wrapper future +
            # timeout machinery measured real loop time at serve QPS
            timer = self.loop.call_later(timeout, _expire_future, fut)
            try:
                status, payload = await fut
            except asyncio.CancelledError:
                if getattr(fut, "_rt_expired", False):
                    raise GetTimeoutError(
                        "timed out waiting for fast-lane actor reply"
                    ) from None
                raise  # genuine cancellation (hedge loser): propagate
            finally:
                timer.cancel()
        if status == fastpath.OK:
            return serialization.unpack(payload)
        if status == fastpath.ERR:
            try:
                err = pickle.loads(payload)
            except Exception as e:
                err = TaskError(f"task failed: {e!r}")
            raise err
        if status == fastpath.OK_SHM:
            # large result sealed in the node arena: mint the ref NOW so
            # the read and the eventual free ride the normal owned-object
            # path (the reply processor created the entry + bookkeeping
            # for exactly this case)
            oid = ObjectID.for_task_return(task_id, 0)
            ref = self._new_owned_ref(oid)
            if self.store is not None:
                hit = self.store.try_get(oid)
                if hit is not None:
                    return hit[0]
            # REMAINING budget only: the future wait above already spent
            # part of the timeout, and re-spending it whole would let a
            # slow arena read overshoot the caller's deadline ~2x
            (value,) = await self.get_async(
                [ref], None if deadline is None
                else max(0.05, deadline - time.monotonic()))
            return value
        if status == fastpath.NEED_SLOW:
            raise FastLaneDeclined()
        raise rpc.ConnectionLost("fast lane broke mid-request")

    # -------------------------------------------------- streaming fast lane
    def fast_actor_submit_stream(self, actor_id: ActorID, method: str,
                                 args, kwargs, tmpl=None):
        """LOOP-thread fast STREAM submit (2.3): the generator analogue
        of :meth:`fast_actor_submit_loop`. The record goes out with a
        ``gm:`` method key, the worker drives the generator and flushes
        one "G" chunk record per yielded item (token deltas per fused
        decode block in the LLM case), and the stream's terminal is an
        ordinary reply on the lane's seq machinery. No per-item
        ObjectRef, memory-store entry, or task event — a chunk is two
        ring stores and one queue put end to end; only oversized items
        seal into the node arena and ride a CHUNK_SHM descriptor.

        Same untracked contract as the unary loop submit: no automatic
        replay on a broken lane (the serve router owns the request
        lifecycle), and RPC fallback is only valid while nothing has
        been consumed — a NEED_SLOW terminal means the worker declined
        before executing, so the per-item ObjectRef generator plane may
        re-dispatch safely.

        Returns ``(task_id, sink)`` for :meth:`fast_actor_stream`, or
        None — this call takes the per-item RPC generator path (no live
        lane, non-generator method, pending/remote ref args, oversized
        record)."""
        from ray_tpu_torch.core import fastpath

        lane = tmpl.lane if tmpl is not None else None
        if lane is None or lane.broken or lane.retired:
            lane = self._fast_actor_lanes.get(actor_id)
            if lane is None or lane.broken or lane.retired:
                if tmpl is not None:
                    tmpl.lane = None
                return None
            if tmpl is not None:
                tmpl.lane = lane
        mt = lane.methods
        if mt is not None:
            v = mt.get(method)
            if v is None or v[0] != "gen":
                return None  # not a generator method on this worker
        has_ref = any(isinstance(a, ObjectRef) for a in args)
        if not has_ref and kwargs:
            has_ref = any(isinstance(v, ObjectRef) for v in kwargs.values())
        if has_ref:
            args, kwargs, ok = self._fast_resolve_ref_args(args, kwargs)
            if not ok:
                return None
        task_id = TaskID.generate_actor()
        tid = task_id.binary()
        now_ns = time.perf_counter_ns()
        t0 = now_ns if self._rec_enabled else 0
        mkey = b"gm:" + method.encode()
        seq = next(lane.seq_counter)
        lane.next_seq = seq + 1
        pins = None
        tunnel = getattr(lane.ring, "tunnel", False)
        trace = (self._trace_submit_leg(
            task_id, method, "tunnel" if tunnel else "ring")
            if self._trace_on else b"")
        oid = ObjectID.for_task_return(task_id, 0)
        try:
            rec = fastpath.pack_actor_task(tid, mkey, args, kwargs, t0,
                                           seq, trace)
        except Exception:
            self._trace_pending.pop(oid, None)
            return None  # unpicklable args: RPC generator path
        if len(rec) > self.cfg.tunnel_inline_max and tunnel:
            shrunk = self._tunnel_shrink_args(args, kwargs)
            if shrunk is not None:
                s_args, s_kwargs, pins = shrunk
                try:
                    rec = fastpath.pack_actor_task(
                        tid, mkey, s_args, s_kwargs, t0, seq, trace)
                except Exception:
                    self._trace_pending.pop(oid, None)
                    return None
        if len(rec) > self._ring_record_cap:
            self._trace_pending.pop(oid, None)
            return None
        if pins:
            self._tunnel_pins[task_id] = pins
        sink = _FastStreamSink(task_id, lane)
        with self._fast_cv:
            self._fast_stream_sinks[oid] = sink
        self._fast_last_submit = now_ns
        ok = self._fast_register_and_push(
            lane, task_id, rec, ("serve", actor_id, method),
            defer=False, t0=t0, track=False)
        if ok is None:
            with self._fast_cv:
                self._fast_stream_sinks.pop(oid, None)
            self._tunnel_pins.pop(task_id, None)
            self._trace_pending.pop(oid, None)
            return None
        metrics.actor_calls.inc()
        return task_id, sink

    async def fast_actor_stream(self, task_id: TaskID, sink, timeout=None):
        """Consume a fast-lane stream: async-iterates the call's yielded
        items in the worker's emit order. ``timeout`` bounds the WHOLE
        stream (first chunk through terminal), raising GetTimeoutError.
        A clean exhaustion returns after the terminal; a remote error
        raises the stream's typed exception; a NEED_SLOW terminal raises
        :class:`FastLaneDeclined` (nothing executed — safe to
        re-dispatch over the per-item RPC generator plane); a lane break
        raises ``rpc.ConnectionLost`` — chunks already consumed are
        never replayed. Early exit (``aclose`` / ``break`` /
        GeneratorExit) abandons the stream: the worker is told to stop
        pumping and late shm chunks free instead of leaking."""
        from ray_tpu_torch.core import fastpath

        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                if deadline is None:
                    kind, status, payload, cseq = await sink.q.get()
                else:
                    try:
                        kind, status, payload, cseq = await asyncio.wait_for(
                            sink.q.get(),
                            max(0.0, deadline - time.monotonic()))
                    except asyncio.TimeoutError:
                        raise GetTimeoutError(
                            "timed out waiting for stream chunk") from None
                if kind == "chunk":
                    if status == fastpath.CHUNK:
                        yield serialization.unpack(payload)
                    else:  # CHUNK_SHM: sealed under return index seq+1
                        ref = self._fast_adopt_chunk_seal(
                            ObjectID.for_task_return(task_id, cseq + 1),
                            payload)
                        (value,) = await self.get_async(
                            [ref], None if deadline is None
                            else max(0.05, deadline - time.monotonic()))
                        yield value
                    continue
                if status == fastpath.OK:
                    return
                if status == fastpath.ERR:
                    try:
                        err = pickle.loads(payload)
                    except Exception as e:
                        err = TaskError(f"stream failed: {e!r}")
                    raise err
                if status == fastpath.NEED_SLOW:
                    raise FastLaneDeclined()
                raise rpc.ConnectionLost("fast lane broke mid-stream")
        finally:
            self.fast_stream_abandon(task_id, sink)

    def fast_stream_abandon(self, task_id: TaskID, sink) -> None:
        """Loop-side, idempotent stream teardown — runs on clean
        exhaustion AND on mid-stream disconnect. Unhooks the sink,
        tombstones a still-live stream so late chunks free their seals
        instead of leaking, frees everything queued-but-unconsumed, and
        best-effort tells a ring lane's worker to stop pumping
        (``stream_abandon`` RPC). Tunnel streams have no worker
        connection here — the serve layer cancels via
        ``cancel_request``, and a closed sink stops the pump on its
        next push anyway."""
        from ray_tpu_torch.core import fastpath

        if sink.dead:
            return
        sink.dead = True
        oid = ObjectID.for_task_return(task_id, 0)
        live = False
        with self._fast_cv:
            if self._fast_stream_sinks.pop(oid, None) is not None:
                live = True
                self._fast_stream_dead[oid] = sink
                while len(self._fast_stream_dead) > 512:
                    self._fast_stream_dead.pop(
                        next(iter(self._fast_stream_dead)))
        # adopt-and-drop every unconsumed shm chunk (reorder buffer +
        # delivery queue) so the arena copies free now
        for cseq, (st, body) in list(sink.pending.items()):
            if st == fastpath.CHUNK_SHM:
                self._fast_adopt_chunk_seal(
                    ObjectID.for_task_return(task_id, cseq + 1), body)
        sink.pending.clear()
        sink.fin = None
        while not sink.q.empty():
            kind, st, body, cseq = sink.q.get_nowait()
            if kind == "chunk" and st == fastpath.CHUNK_SHM:
                self._fast_adopt_chunk_seal(
                    ObjectID.for_task_return(task_id, cseq + 1), body)
        if live:
            w = getattr(sink.lane, "worker", None)
            conn = getattr(w, "conn", None) if w is not None else None
            if conn is not None and not conn._closed:
                async def _notify():
                    try:
                        await conn.call("stream_abandon",
                                        {"task_ids": [task_id.binary()]})
                    except (rpc.ConnectionLost, OSError):
                        # best-effort: a dying worker's pump also stops
                        # on the closed ring / dead sink
                        pass
                self._bg.spawn(_notify(), self.loop)

    def _fast_adopt_chunk_seal(self, oid: ObjectID, payload: bytes):
        """Adopt a CHUNK_SHM seal into the owned-object plane at consume
        time: create the entry + location hint the migrate drain makes
        for an OK_SHM reply (chunks skip the migrate queue — no
        per-chunk task events by design) and mint the ref whose read and
        eventual drop ride the normal owned path. Dropping the returned
        ref immediately frees an orphaned seal."""
        from ray_tpu_torch.core import fastpath

        ent = self.memory_store.get(oid)
        if ent is None:
            ent = _MemEntry()
            self.memory_store[oid] = ent
        if not ent.ready.is_set():
            ent.in_shm = True
            size, holder = fastpath.unpack_shm_desc(payload)
            holder = holder or self.node_id.binary()
            self._obj_locations.setdefault(oid, set()).add(holder)
            ent.ready.set()
        return self._new_owned_ref(oid)

    def _queue_loop_wakes(self, items) -> None:
        """Thread-safe: queue router-future resolutions and arm the loop
        drain at most once — while reply traffic flows the drain lingers
        armed (call_soon re-pass), so reply threads stop paying the
        self-pipe write per batch. From the loop itself the arm is a
        plain call_soon — call_soon_threadsafe writes the self-pipe even
        from the owning thread."""
        with self._fast_cv:
            self._fast_wake_q.extend(items)
            arm = not self._fast_wake_armed
            if arm:
                self._fast_wake_armed = True
        if arm:
            try:
                if _in_loop(self.loop):
                    self.loop.call_soon(self._drain_loop_wakes)
                else:
                    self.loop.call_soon_threadsafe(self._drain_loop_wakes)
            except RuntimeError:
                pass  # loop gone (shutdown)

    def _drain_loop_wakes(self):
        """Loop-side: resolve router futures with their raw reply
        tuples. A done future means the caller timed out and went away —
        its reply is dropped, except a shm-sealed result, whose entry is
        adopted-and-dropped so the arena copy frees instead of leaking
        (nobody else will ever mint its ref)."""
        from ray_tpu_torch.core import fastpath

        with self._fast_cv:
            batch = self._fast_wake_q
            self._fast_wake_q = []
            if not batch:
                self._fast_wake_armed = False
                return
        for fut, status, payload, oid in batch:
            if type(fut) is _FastStreamSink:
                if not fut.dead:
                    fut.push(status, payload)
                elif status == fastpath.CHUNK_SHM:
                    # chunk for an abandoned stream: adopt-and-drop the
                    # orphaned seal so the arena copy frees
                    cseq, body = payload
                    self._fast_adopt_chunk_seal(
                        ObjectID.for_task_return(fut.task_id, cseq + 1),
                        body)
            elif not fut.done():
                fut.set_result((status, payload))
            elif status == fastpath.OK_SHM:
                self._new_owned_ref(oid)  # dropped at once: frees the seal
        # burst linger: stay armed one more tick while traffic flows
        self.loop.call_soon(self._drain_loop_wakes)

    def _fast_resubmit(self, task_id: TaskID, light, lost: bool = True) -> None:
        """Loop-side: re-route a fast-path call through the RPC path.
        ``lost=True`` (break-lane recovery: the worker died and may have
        executed the task) charges one retry from the user's budget and
        honors at-most-once — a max_retries=0 task FAILS rather than
        re-executing its side effects. ``lost=False`` (NEED_SLOW
        migration: the worker declined without executing) keeps the full
        budget."""
        tp = self._trace_pending.pop(
            ObjectID.for_task_return(task_id, 0), None)
        if tp is not None:
            # the fast leg never completed: materialize its submit span
            # now so the RPC replay's exec span has its parent, and keep
            # the call in the SAME trace (one logical call, one trace)
            self._trace_emit_submit_point(task_id, tp)
        if light[0] == "actor":
            _, actor_id, method, args, kwargs = light
            spec = {
                "task_id": task_id,
                "actor_id": actor_id,
                "method": method,
                "args": list(args),
                "kwargs": dict(kwargs),
                "num_returns": 1,
                "owner_address": self.address,
                "seq": None,
                "concurrency_group": None,
            }
            if tp is not None:  # sampled call: the RPC replay keeps the
                # trace (same parent submit span — one logical call)
                spec["trace_ctx"] = {"trace_id": tp[0],
                                     "parent_span_id": tp[2]}
            self._actor_queues.setdefault(actor_id, []).append(spec)
            self._bg.spawn(self._ensure_actor_pump(actor_id), self.loop)
        else:
            budget = light[4]
            if budget is None:
                budget = self.cfg.default_max_task_retries
            if lost:
                if budget <= 0:
                    # at-most-once: the user forbade re-execution and the
                    # worker may already have run the task's side effects
                    self._complete_task_error(
                        self._fast_light_to_spec(task_id, light, 0),
                        WorkerCrashedError())
                    return
                budget -= 1
            spec = self._fast_light_to_spec(task_id, light, budget)
            if tp is not None:
                spec["trace_ctx"] = {"trace_id": tp[0],
                                     "parent_span_id": tp[2]}
            self._bg.spawn(self._submit_async(spec), self.loop)

    def _fast_reader(self, lane):
        """Per-lane sweeper thread: drain the reply ring whenever no
        blocking get() has claimed consumption (fast_prepass steals the
        consumer role — one thread hop fewer per result — and the sweeper
        parks while that streak lasts)."""
        from ray_tpu_torch.core import fastpath

        ring = lane.ring
        while not (self._closed or lane.broken):
            if time.monotonic() - lane.user_wants < 0.5:
                lane.resume_evt.wait(0.5)  # a get() streak owns the ring
                lane.resume_evt.clear()
                continue
            with lane.rx_lock:
                recs = ring.pop_batch(fastpath.REP, timeout_ms=200)
            if recs is None:
                break  # closed and drained
            if recs:
                self._fast_process_replies(lane, recs)
        self._fast_break_lane(lane)
        with lane.rx_lock:  # no stealing get() mid-pop
            ring.close_pair()  # the sweeper owns the unmap (single closer)

    def _fast_process_replies(self, lane, recs):
        """Record a batch of reply records (any thread): resolve blocking
        gets via the cv, queue loop-side bookkeeping. This is the
        DRIVER_APPLY point of the flight recorder: a stamped reply plus
        the submit-time t0 yields the full per-task stage sample (both
        ring hops, deserialize, exec) at the cost of one ring store and
        one recorder slot per task."""
        from ray_tpu_torch.core import fastpath

        t_rx = time.perf_counter_ns()
        stats = recorder.get_stats() if self._rec_enabled else None
        # StageStats.add inlined below (ring/cap hoisted per batch): the
        # method-call frame alone is ~8% of the recorder's whole per-task
        # budget on slow interpreters (bench.py recorder_overhead_us)
        if stats is not None:
            sring, scap = stats.ring, stats.cap
        astats = self._actor_stats
        batch = []
        drained = False
        wake = None  # loop-waiter resolutions (serve fast-lane router)
        retire_serve = None  # lane whose method table went stale
        tspans = None  # sampled completions: wire-level call spans
        with self._fast_cv:
            for rec in recs:
                if rec[:1] == b"G":
                    # 2.3 stream chunk probe. A chunk never pops
                    # inflight / oid-lane / pins — the stream's terminal
                    # (an ordinary reply on the lane's seq machinery)
                    # owns all of that. Routing demands a full 16-byte
                    # task-id match against a registered sink, so a
                    # genuine reply whose tid happens to start with
                    # 0x47 ('G') falls through to the reply parse.
                    g = fastpath.unpack_chunk(rec)
                    if g is not None:
                        coid = ObjectID.for_task_return(TaskID(g[0]), 0)
                        sink = (self._fast_stream_sinks.get(coid)
                                or self._fast_stream_dead.get(coid))
                        if sink is not None:
                            if wake is None:
                                wake = []
                            # payload slot = (chunk_seq, body); the sink
                            # reorders on the loop side
                            wake.append((sink, g[1], (g[3], g[2]), coid))
                            continue
                    try:
                        tid_b, status, payload, stamp, seq, trc = \
                            fastpath.unpack_reply(rec)
                    except Exception:
                        # an ownerless chunk (late duplicate after the
                        # terminal cleared the stream) that does not
                        # parse as a reply: drop it, never kill the
                        # whole batch
                        continue
                else:
                    tid_b, status, payload, stamp, seq, trc = \
                        fastpath.unpack_reply(rec)
                task_id = TaskID(tid_b)
                light = lane.inflight.pop(task_id, None)
                if self._tunnel_pins:
                    # descriptor pins (oversized tunnel args): the reply
                    # landed, the receiver's pull is over — release the
                    # sealed copies
                    self._tunnel_pins.pop(task_id, None)
                oid = ObjectID.for_task_return(task_id, 0)
                ent = self._fast_oid_lane.pop(oid, None)
                if self._trace_pending and (
                        trc or (status == fastpath.NEED_SLOW
                                and light is not None
                                and light[0] == "serve")):
                    # sampled call: stamp the wire-level call span after
                    # the cv drops (span emit is just a dict append, but
                    # the cv guards hotter state than telemetry deserves).
                    # Serve NEED_SLOWs pop too — their RPC re-dispatch
                    # mints a fresh submit span, so the pending entry is
                    # dead (tracked NEED_SLOWs keep theirs for
                    # _fast_resubmit's trace_ctx handoff).
                    tp = self._trace_pending.pop(oid, None)
                    if (tp is not None and trc
                            and status != fastpath.NEED_SLOW):
                        if tspans is None:
                            tspans = []
                        tspans.append((oid, stamp, tp))
                if self._fast_loop_waiters:
                    fut = self._fast_loop_waiters.pop(oid, None)
                    if fut is not None:
                        if wake is None:
                            wake = []
                        wake.append((fut, status, payload, oid))
                if self._fast_stream_sinks or self._fast_stream_dead:
                    # stream terminal: deliver fin to a live sink (held
                    # there until the chunk tail drains); an abandoned
                    # stream's tombstone clears for good — nothing after
                    # the terminal will ever reference its seals
                    sink = self._fast_stream_sinks.pop(oid, None)
                    if sink is not None:
                        if wake is None:
                            wake = []
                        wake.append((sink, status, payload, oid))
                    else:
                        self._fast_stream_dead.pop(oid, None)
                if seq is not None and light is not None:
                    # out-of-order completion accounting (async actors
                    # reply as each method finishes): seq below the high
                    # water is evidence the lane completed out of order
                    if seq < lane.done_seq:
                        lane.ooo_replies += 1
                    elif seq > lane.done_seq:
                        lane.done_seq = seq
                if light is None:
                    # untracked completion: a duplicate delivery (the
                    # spill RPC's timeout path may re-send records whose
                    # first copy DID land) or a task the break-lane /
                    # cancel recovery already owns — both are no-ops here
                    # (at-least-once delivery, exactly-once application)
                    entry = self.memory_store.get(oid)
                    if entry is None or entry.ready.is_set():
                        continue
                if (stamp is not None and ent is not None and ent[1]
                        and status != fastpath.NEED_SLOW):
                    # ONE raw tuple store per task — stamp decoding,
                    # percentile math and shm SAMPLE slots all happen on
                    # the flush timer over bounded windows, never here.
                    # Actor calls land in their own window so the stage
                    # breakdown surfaces as actor_* rows beside the task
                    # rows in state.list_task_latency().
                    if task_id.is_actor_task():
                        if astats is not None:
                            astats.ring[astats.n % astats.cap] = (
                                ent[1], t_rx, tid_b, stamp)
                            astats.n += 1
                    elif stats is not None:
                        sring[stats.n % scap] = (ent[1], t_rx, tid_b, stamp)
                        stats.n += 1
                if light is not None and light[0] == "serve":
                    # untracked serve call: the waiter resolution above
                    # IS the completion — no entry, no events, no
                    # migrate bookkeeping. Only a shm-sealed result
                    # needs the owned-object plane (entry created here,
                    # ref minted by fast_actor_await); a NEED_SLOW means
                    # the worker's method table went stale — retire the
                    # lane (outside the cv) exactly like the tracked
                    # path would, the waiters re-dispatch over RPC.
                    if status == fastpath.NEED_SLOW:
                        retire_serve = lane
                    elif status == fastpath.OK_SHM:
                        if oid not in self.memory_store:
                            self.memory_store[oid] = _MemEntry()
                        self._fast_done[oid] = (status, payload)
                        batch.append((task_id, oid, status, payload, light))
                    continue
                if status != fastpath.NEED_SLOW:
                    self._fast_done[oid] = (status, payload)
                batch.append((task_id, oid, status, payload, light))
            if (not lane.inflight and lane.drain_waiters
                    and lane.drain_evt is not None):
                # wake RPC-fallback calls parked on the drain barrier —
                # gated on drain_waiters so the pure-ring round trip
                # never pays this loop self-pipe wake
                drained = True
            self._fast_migrate_q.extend(batch)
            arm = not self._fast_migrate_armed
            if arm:
                self._fast_migrate_armed = True
            self._fast_cv.notify_all()
        if wake:
            self._queue_loop_wakes(wake)
        if tspans is not None:
            self._trace_apply_replies(tspans)
        if retire_serve is not None:
            self._fast_retire_actor_lane(retire_serve)
        if drained:
            try:
                self.loop.call_soon_threadsafe(lane.drain_evt.set)
            except RuntimeError:
                pass  # loop gone (shutdown)
        if arm:
            try:
                self.loop.call_soon_threadsafe(self._drain_fast_migrations)
            except RuntimeError:
                pass  # loop gone (shutdown)

    async def rpc_fast_result(self, conn, p):
        """Result-ring spill receiver: completion records the worker could
        not push into a full result ring arrive here over RPC (the slow
        road backs the fast lane in both directions). Records whose task
        is no longer tracked on a lane (break-lane recovery or cancel got
        there first) are dropped — the RPC resubmission owns them."""
        from ray_tpu_torch.core import fastpath

        by_lane: dict[int, tuple] = {}
        with self._fast_cv:
            for rec in p["records"]:
                if rec[:1] == b"G":
                    # spilled stream chunk: route on the sink's lane
                    # (chunks are untracked — no _fast_oid_lane entry
                    # pops for them, the terminal owns that)
                    g = fastpath.unpack_chunk(rec)
                    if g is not None:
                        soid = ObjectID.for_task_return(TaskID(g[0]), 0)
                        sink = (self._fast_stream_sinks.get(soid)
                                or self._fast_stream_dead.get(soid))
                        if sink is not None:
                            lane = sink.lane
                            by_lane.setdefault(
                                id(lane), (lane, []))[1].append(rec)
                            continue
                    try:
                        tid_b = fastpath.unpack_reply(rec)[0]
                    except Exception:
                        continue  # ownerless chunk: drop
                else:
                    tid_b = fastpath.unpack_reply(rec)[0]
                oid = ObjectID.for_task_return(TaskID(tid_b), 0)
                ent = self._fast_oid_lane.get(oid)
                if ent is not None:
                    lane = ent[0]
                    by_lane.setdefault(id(lane), (lane, []))[1].append(rec)
        for lane, recs in by_lane.values():
            self._fast_spilled_results += len(recs)
            self._fast_process_replies(lane, recs)
        return True

    def _drain_fast_migrations(self):
        """Loop-side completion: fill memory-store entries, emit events,
        resubmit NEED_SLOW tasks via the RPC path.

        Lingers on a 2ms timer while reply traffic flows (stays armed, so
        reply processors never pay a self-pipe wake per batch — on a
        one-core host that wake lands between the caller and the worker);
        disarms after one empty pass."""
        from ray_tpu_torch.core import fastpath

        with self._fast_cv:
            batch = self._fast_migrate_q
            self._fast_migrate_q = []
            if not batch:
                self._fast_migrate_armed = False
                return
            # armed stays True while this pass runs; the tail decides
            # between timer-linger (blocking-call traffic) and disarm
            # (burst traffic) — see below
        lanes_to_check = set()
        result_bytes: dict = {}
        for task_id, oid, status, payload, light in batch:
            if status == fastpath.NEED_SLOW:
                if light is not None:
                    if light[0] == "actor":
                        # worker-side NEED_SLOW: a method the shipped
                        # eligibility table didn't cover (dynamically
                        # added / stale table). The worker NEED_SLOWed
                        # the whole in-flight tail in ring order, so
                        # retiring here keeps FIFO; driver-visible
                        # ineligibility (ref args, generators, option
                        # overrides) never reaches this path — those
                        # fall back per CALL and the lane lives on
                        lane = self._fast_actor_lanes.get(light[1])
                        if lane is not None:
                            self._fast_retire_actor_lane(lane)
                    else:
                        self._fast_ineligible_funcs.add(
                            getattr(light[0], "__rt_func_id__", b""))
                    # NEED_SLOW is a migration, not a loss: the worker
                    # declined without executing, so the full budget rides
                    self._fast_resubmit(task_id, light, lost=False)
                continue
            entry = self.memory_store.get(oid)
            if light is None:
                name = "task"
                if entry is None or entry.ready.is_set():
                    # duplicate delivery that slipped past the intake
                    # guard (first copy drained in between): the value,
                    # events and metrics were all applied already
                    continue
            elif light[0] in ("actor", "serve"):
                name = light[2]
            else:
                name = getattr(light[0], "__name__", "task")
            if entry is not None and not entry.ready.is_set():
                if status == fastpath.OK:
                    entry.packed = payload
                elif status == fastpath.OK_SHM:
                    entry.in_shm = True
                    # the completion record IS the location registration
                    # for the cache (the GCS directory write below stays
                    # the source of truth): shm-ring lanes are same-node,
                    # tunnel lanes carry the sealing node in the shm
                    # descriptor (pack_shm_desc); its size payload feeds
                    # the task event below
                    size, holder = fastpath.unpack_shm_desc(payload)
                    result_bytes[oid] = size
                    holder = holder or self.node_id.binary()
                    self._obj_locations.setdefault(oid, set()).add(holder)
                    if light is not None and light[0] not in ("actor",
                                                              "serve"):
                        # shm results can be evicted: keep real lineage
                        # (actor calls have no reconstruction, as in the
                        # reference — actor state is not replayable). The
                        # task COMPLETED, so reconstruction gets the full
                        # user budget back
                        budget = light[4]
                        if budget is None:
                            budget = self.cfg.default_max_task_retries
                        self._lineage[task_id] = self._fast_light_to_spec(
                            task_id, light, budget)
                        self._lineage_live[task_id] = {oid}
                    self._bg.spawn(self._register_location(oid, holder),
                                   self.loop)
                else:  # ERR
                    try:
                        entry.error = pickle.loads(payload)
                    except Exception as e:  # unpicklable error payload
                        entry.error = TaskError(f"task failed: {e!r}")
                entry.ready.set()
            self._cancelled_tasks.discard(task_id)
            outcome = "failed" if status == fastpath.ERR else "ok"
            metrics.tasks_finished.inc(tags={"outcome": outcome})
            ev = dict(task_id=task_id.hex(), name=name,
                      state="FAILED" if status == fastpath.ERR
                      else "FINISHED")
            size = result_bytes.get(oid)
            if size:
                ev["result_bytes"] = size  # shm-sealed result size
            self.task_events.emit(**ev)
            with self._fast_cv:
                self._fast_done.pop(oid, None)
        # a RETIRED actor lane whose in-flight records have all drained is
        # finished forever (permanent RPC downgrade): close its ring so
        # the worker's executor-resident pump cycle stops — otherwise it
        # would keep taking 5ms slices of the actor thread ahead of every
        # RPC-path call for the actor's lifetime
        for lane in list(self._fast_lanes):
            if (lane.retired and not lane.broken and not lane.inflight
                    and lane.key and lane.key[0] == "actor"):
                self._fast_break_lane(lane)
        # a drained lane's lease must still be returnable when idle; arm at
        # most one idle-return watcher per lane drain-down
        drained = False
        for lane in [ln for ln in self._fast_lanes if not ln.inflight]:
            state = self.sched_keys.get(lane.key)
            if state is None:
                continue
            drained = True
            state.fast_backlog_since = 0.0  # drained: demand pressure gone
            if not lane.return_armed and lane.worker in state.workers:
                lane.return_armed = True
                self._bg.spawn(
                    self._fast_idle_return(lane, state), self.loop)
        if drained:
            self._report_demand()  # clear any stale nonzero raylet report
        # Adaptive linger. Blocking-call traffic (submit/get/submit/get —
        # one reply per pass) lingers on a sleepy 2ms timer: staying
        # armed means the reply processor never pays a self-pipe wake,
        # which on a one-core host lands on the critical path between
        # caller and worker (~25% of the sync-call round trip). Burst
        # traffic (pipelined gets, many replies per pass) disarms
        # instead: there the wake amortizes over the whole batch and the
        # 2ms pacing throttles the pipeline.
        if len(batch) < 8:
            self.loop.call_later(0.002, self._drain_fast_migrations)
        else:
            with self._fast_cv:
                refilled = bool(self._fast_migrate_q)
                if not refilled:
                    self._fast_migrate_armed = False
            if refilled:  # stay armed; immediate re-pass, no recursion
                self.loop.call_soon(self._drain_fast_migrations)

    async def _fast_idle_return(self, lane, state):
        try:
            await self._maybe_return_lease(lane.key, state, lane.worker)
        finally:
            lane.return_armed = False

    def _fast_light_to_spec(self, task_id: TaskID, light,
                            budget: int) -> dict:
        """Expand a fast-path lineage tuple into a full RPC task spec
        (reusing the already-issued task id: its refs are in user hands).
        ``budget`` is the remaining retry allowance — _fast_resubmit
        resolves it from the tuple's user max_retries, charging one loss
        only when a worker actually died (chaos kill schedules exposed
        the earlier config-default reset)."""
        fn, args, kwargs, resources, _max_retries = light
        return {
            "task_id": task_id,
            "name": getattr(fn, "__name__", "task"),
            "func_id": fn.__rt_func_id__,
            "language": "python",
            "func_name": None,
            "args": list(args),
            "kwargs": dict(kwargs),
            "num_returns": 1,
            "resources": dict(resources),
            "owner_address": self.address,
            "max_retries": max(0, budget),
            "placement_group": None,
            "bundle_index": -1,
            "scheduling_node": None,
            "runtime_env": self.default_runtime_env,
        }

    def _fast_retire_actor_lane(self, lane) -> None:
        """Permanent RPC downgrade of an actor lane. Since 1.8 only a
        worker-side NEED_SLOW (method missing from the shipped
        eligibility table) lands here — driver-visible ineligibility
        falls back per call. When nothing is in flight the ring closes
        right away so the worker's executor-resident pump cycle stops;
        otherwise the drain path closes it once the last reply lands."""
        lane.retired = True
        with self._fast_cv:
            drained = not lane.inflight and not lane.broken
        if drained:
            self._fast_break_lane(lane)

    def _fast_try_retire_lane(self, lane) -> bool:
        """Idle-lease-return teardown: atomically stop new fast submits
        and confirm nothing is in flight. A worker being retired is ALIVE
        — its pump drains the ring before exiting — so the break-lane
        resubmission path must never fire here (a task both drained and
        resubmitted would execute twice). Returns False (lane stays live)
        if a racing submit got in between the idle check and the break."""
        with self._fast_cv:
            if not lane.broken:
                if lane.inflight:
                    return False
                lane.broken = True
        self._fast_break_lane(lane)  # leftovers empty by construction
        return True

    def _fast_break_lane(self, lane):
        """Thread-safe: stop routing to this lane and resubmit whatever is
        in flight through the RPC path (worker death / lease return)."""
        wake = []
        with self._fast_cv:
            if lane.broken:
                leftovers = {}
            else:
                lane.broken = True
                leftovers = dict(lane.inflight)
                lane.inflight.clear()
                for task_id, light in leftovers.items():
                    oid = ObjectID.for_task_return(task_id, 0)
                    self._fast_oid_lane.pop(oid, None)
                    if self._tunnel_pins:
                        self._tunnel_pins.pop(task_id, None)
                    if self._trace_pending and light[0] == "serve":
                        # untracked serve call dying with the lane: its
                        # ::call span will never stamp (the router's RPC
                        # replay mints a fresh submit span); tracked
                        # entries stay for _fast_resubmit's ctx handoff
                        self._trace_pending.pop(oid, None)
                    fut = self._fast_loop_waiters.pop(oid, None)
                    if fut is not None:
                        # broken mid-flight: fast_actor_await raises
                        # ConnectionLost, the router's policy owns replay
                        wake.append((fut, None, None, oid))
                    if self._fast_stream_sinks:
                        sink = self._fast_stream_sinks.pop(oid, None)
                        if sink is not None:
                            # stream dying with the lane: the broken
                            # sentinel ends iteration with
                            # ConnectionLost — chunks already consumed
                            # are never replayed
                            wake.append((sink, None, None, oid))
            self._fast_cv.notify_all()
        if wake:
            self._queue_loop_wakes(wake)
        if lane.drain_evt is not None and lane.drain_waiters:
            try:  # nothing is in flight on a broken lane: wake drain waiters
                self.loop.call_soon_threadsafe(lane.drain_evt.set)
            except RuntimeError:
                pass  # loop gone (shutdown)
        with lane.txlock:
            # buffered records were in the inflight snapshot above (or in
            # an earlier break's): the RPC resubmission owns them now
            lane.txbuf.clear()
            lane.txbytes = 0
        if lane.worker is not None and lane.worker.fast_lane is lane:
            lane.worker.fast_lane = None
        if lane.key and lane.key[0] == "actor":
            if self._fast_actor_lanes.get(lane.key[1]) is lane:
                self._fast_actor_lanes.pop(lane.key[1], None)
        if lane in self._fast_lanes:
            try:
                self._fast_lanes.remove(lane)
            except ValueError:
                pass
        lane.ring.close(0)
        lane.ring.close(1)
        if leftovers and not self._closed:
            def resub():
                for task_id, light in leftovers.items():
                    if task_id in self._cancelled_tasks:
                        continue  # entries already failed by cancel_task
                    if light[0] == "serve":
                        # untracked: the broken-sentinel wake above told
                        # the router, whose retry_on gate owns replay —
                        # core resubmission would re-execute
                        # non-idempotent requests behind its back
                        continue
                    self._fast_resubmit(task_id, light)
            try:
                self.loop.call_soon_threadsafe(resub)
            except RuntimeError:
                pass

    async def _fast_health_loop(self):
        """Worker death with an empty loop (nobody mid-RPC to notice):
        sweep lanes whose worker connection died and recover their
        tasks. Doubles as the tunnel-lane revival driver: actors that
        lost their tunnel lane (tunnel break, raylet restart) re-bind
        here once the redial lands — until then their calls ride the
        per-call RPC fallback."""
        while not self._closed:
            await asyncio.sleep(2.0)
            for lane in list(self._fast_lanes):
                if lane.broken:
                    continue
                w = lane.worker
                if w.conn is None or w.conn._closed or lane.ring.is_closed(1):
                    self._fast_break_lane(lane)
            if self._tunnel_ok() and self._tunnel_actor_seen:
                for actor_id in list(self._tunnel_actor_seen):
                    if actor_id in self._fast_actor_lanes:
                        continue
                    conn = self._actor_conns.get(actor_id)
                    if conn is None or conn._closed:
                        continue  # next RPC dial re-attaches anyway
                    self._bg.spawn(
                        self._tunnel_actor_attach(actor_id, conn),
                        self.loop)

    def fast_prepass(self, refs, timeout: float | None) -> dict:
        """Blocking wait (user thread) for fast-path refs, resolved straight
        from the reply stream. Returns {oid: ("v", packed) | ("e", exc)};
        refs it does not resolve (slow, shm, timed out) are left for the
        normal get path."""
        if not self._fast_oid_lane and not self._fast_done:
            return {}
        from ray_tpu_torch.core import fastpath

        # about to block on results: push any coalesced submit tail now
        # rather than waiting out the flusher's linger
        for lane in list(self._fast_lanes):
            if lane.txbytes and not lane.broken:
                self._fast_flush_lane(lane, timeout_ms=20)
        deadline = None if timeout is None else time.monotonic() + timeout
        resolved: dict = {}
        while True:
            steal_lane = None
            with self._fast_cv:
                pending = set()
                lanes = set()
                for r in refs:
                    oid = r.id
                    if oid in resolved:
                        continue
                    hit = self._fast_done.get(oid)
                    if hit is not None:
                        resolved[oid] = hit
                        continue
                    ent = self._fast_oid_lane.get(oid)
                    if ent is None:
                        continue  # migrated/broken/cancelled: loop path owns it
                    entry = self.memory_store.get(oid)
                    if entry is not None and entry.ready.is_set():
                        continue  # completed via the loop
                    pending.add(oid)
                    lanes.add(ent[0])
                if not pending:
                    break
                if len(lanes) == 1:
                    steal_lane = next(iter(lanes))
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                break
            # Single-lane wait: become the reply-ring consumer ourselves —
            # the result then costs one thread wake (worker pump -> us)
            # instead of three (pump -> sweeper -> cv -> us). Tunnel
            # lanes have no ring to steal (replies arrive on the loop):
            # they take the cv wait below, woken per reply batch.
            if (steal_lane is not None and not steal_lane.broken
                    and not getattr(steal_lane.ring, "tunnel", False)):
                steal_lane.user_wants = time.monotonic()
                if steal_lane.rx_lock.acquire(blocking=False):
                    try:
                        pop_ms = int(1000 * min(0.2, remaining or 0.2))
                        recs = steal_lane.ring.pop_batch(
                            fastpath.REP, max(1, pop_ms))
                    finally:
                        steal_lane.rx_lock.release()
                    if recs is None:
                        self._fast_break_lane(steal_lane)
                    elif recs:
                        self._fast_process_replies(steal_lane, recs)
                    continue
            # sweeper-consumed (or multi-lane) wait; bounded because
            # loop-side completions (cancel, slow takeover) don't notify
            with self._fast_cv:
                again = any(oid in self._fast_done for oid in pending)
                if not again:
                    self._fast_cv.wait(
                        0.05 if remaining is None else min(0.05, remaining))
        out = {}
        for oid, (status, payload) in resolved.items():
            from ray_tpu_torch.core import fastpath
            if status == fastpath.OK:
                out[oid] = ("v", payload)
            elif status == fastpath.ERR:
                try:
                    out[oid] = ("e", pickle.loads(payload))
                except Exception as e:
                    out[oid] = ("e", TaskError(f"task failed: {e!r}"))
            elif status == fastpath.OK_SHM and self.store is not None:
                # the worker sealed the result into the local arena before
                # replying: read it zero-copy right here on the caller
                # thread instead of waiting out the loop migration
                hit = self.store.try_get(oid)
                if hit is not None:
                    out[oid] = ("V", hit[0])
                # else evicted/racing: the normal path pulls/rebuilds
        return out

    def get_local_prepass(self, refs) -> dict:
        """Caller-thread get: resolve refs whose values are already local —
        ready memory-store entries unpack in place, sealed local shm
        objects read zero-copy through the arena mapping — WITHOUT the
        event-loop round trip the async path pays per call. Never blocks;
        anything unresolved (pending, remote, evicted) is left for
        get_async, which stays the source of truth. Returns
        {oid: ("V", value) | ("e", exc)}."""
        out: dict = {}
        store = self.store
        for ref in refs:
            oid = ref.id
            if oid in out:
                continue
            entry = self.memory_store.get(oid)
            if entry is None or not entry.ready.is_set():
                continue
            if entry.error is not None:
                out[oid] = ("e", entry.error)
                continue
            if not entry.in_shm:
                try:
                    if entry.packed is not None:
                        out[oid] = ("V", serialization.unpack(entry.packed))
                    else:
                        out[oid] = ("V", entry.value)
                except Exception:
                    continue  # let the slow path surface the failure
                continue
            if store is not None:
                hit = store.try_get(oid)
                if hit is not None:
                    out[oid] = ("V", hit[0])
                # absent/pending/evicted: the async pull path owns it
        return out

    def fast_wait_prepass(self, refs, num_returns: int,
                          timeout: float | None):
        """Caller-thread wait. Ready refs (memory-store entries, local shm
        objects, fast-lane completions) are counted without touching the
        event loop; when the shortfall consists ENTIRELY of fast-lane
        in-flight refs, block on the reply-stream condition variable —
        completions wake it directly — instead of parking watcher tasks on
        the loop. Returns (ready, pending) in ref order, or None when some
        pending ref needs the loop path (borrowed refs, RPC-path tasks:
        wait_async owns those blocking semantics)."""
        if _in_loop(self.loop):
            return None  # loop thread: _run_sync's guard owns the error
        refs = list(refs)
        # wait never runs the get prepass: push any coalesced submit tail
        # now rather than waiting out the flusher's linger
        for lane in list(self._fast_lanes):
            if lane.txbytes and not lane.broken:
                self._fast_flush_lane(lane, timeout_ms=20)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ready_idx: set[int] = set()
            shortfall_fast = True
            for i, ref in enumerate(refs):
                if len(ready_idx) >= num_returns:
                    break
                entry = self.memory_store.get(ref.id)
                if entry is not None and entry.ready.is_set():
                    ready_idx.add(i)
                elif entry is None and self.store is not None \
                        and self.store.contains(ref.id):
                    ready_idx.add(i)
                # lock-free membership probes (GIL-atomic): taking
                # _fast_cv per ref would cost O(n) lock round-trips per
                # scan against the reply threads; a racy miss just makes
                # this round conservative — the next round (or the loop
                # path) resolves it
                elif ref.id in self._fast_done:
                    ready_idx.add(i)
                elif ref.id not in self._fast_oid_lane:
                    shortfall_fast = False
            if len(ready_idx) >= num_returns:
                ready = [r for i, r in enumerate(refs) if i in ready_idx]
                pending = [r for i, r in enumerate(refs)
                           if i not in ready_idx]
                return ready, pending
            if not shortfall_fast:
                return None  # loop path owns the blocking wait
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                ready = [r for i, r in enumerate(refs) if i in ready_idx]
                pending = [r for i, r in enumerate(refs)
                           if i not in ready_idx]
                return ready, pending
            with self._fast_cv:
                self._fast_cv.wait(
                    0.05 if remaining is None else min(0.05, remaining))

    # ------------------------------------------------------ task submission
    def _register_function(self, fn) -> bytes:
        """Export the function blob to the GCS function table once
        (ref: remote_function.py pickled-function export). Registration is
        fire-and-forget: executors retry the table fetch briefly, so a task
        can never race ahead of its own function blob for long."""
        cached = getattr(fn, "__rt_func_id__", None)
        if cached is not None and cached in self._registered_funcs:
            return cached
        blob = serialization.ship_dumps(fn)
        func_id = hashlib.sha1(blob).digest()
        if func_id not in self._registered_funcs:
            self._call_on_loop(
                self.gcs.call(
                    "kv_put",
                    {"ns": "funcs", "key": func_id.hex(), "value": blob, "overwrite": False},
                )
            )
            self._registered_funcs.add(func_id)
        try:
            fn.__rt_func_id__ = func_id
            # plain sync callables qualify for the shm-ring fast path;
            # generators/coroutines need the RPC streaming machinery
            fn.__rt_fast_ok__ = not (
                inspect.iscoroutinefunction(fn)
                or inspect.isgeneratorfunction(fn)
                or inspect.isasyncgenfunction(fn))
        except (AttributeError, TypeError):
            pass
        return func_id

    def submit_template(self, tmpl, fn, args, kwargs):
        """Flat steady-state submit: everything a .remote() call used to
        re-derive per call (resources dict, normalized strategy, placement
        target, scheduling key, function registration) comes precomputed
        in the frozen SubmitTemplate (core/api.py). Fast-eligible calls go
        straight into the ring with the template's key; everything else —
        and every fast miss — falls through to submit_task, which stays
        the single source of truth for slow-path semantics and builds a
        spec byte-identical to a direct submit_task call."""
        if tmpl.fast_ok:
            ref = self._fast_submit_keyed(fn, tmpl.func_id, tmpl.sched_key,
                                          tmpl.resources, args, kwargs,
                                          max_retries=tmpl.max_retries)
            if ref is not None:
                return ref
        return self.submit_task(
            fn, args, kwargs,
            num_returns=tmpl.num_returns,
            resources=dict(tmpl.resources),
            max_retries=tmpl.max_retries,
            placement_group=tmpl.placement_group,
            bundle_index=tmpl.bundle_index,
            scheduling_node=tmpl.scheduling_node,
            scheduling_strategy=tmpl.scheduling_strategy,
            name=tmpl.name,
            runtime_env=tmpl.runtime_env,
            _fast_tried=True,
        )

    def submit_task(self, fn, args, kwargs, *, num_returns=1, resources=None,
                    max_retries=None, placement_group=None, bundle_index=-1,
                    scheduling_node=None, scheduling_strategy=None, name=None,
                    runtime_env=None,
                    _fast_tried=False) -> list[ObjectRef] | ObjectRef:
        """Synchronous entry (driver thread) or loop-thread entry (nested).

        ``fn`` is a Python callable, or ("cpp", func_name) for cross-language
        submission to a C++ worker (ref: cpp/ worker API; function resolved
        from the binary's RT_REMOTE registry by name). ``_fast_tried``
        (internal, set by submit_template) records that the ring fast path
        was already attempted this call, so the burst detector isn't
        double-counted; it never affects the built task spec."""
        language = "python"
        func_name = None
        if isinstance(fn, tuple) and len(fn) == 2 and fn[0] == "cpp":
            language, func_name = "cpp", fn[1]
            if kwargs:
                raise TypeError("C++ tasks take positional arguments only")
            func_id = b"cpp:" + func_name.encode()
        else:
            if (not _fast_tried and num_returns == 1
                    and placement_group is None
                    and scheduling_node is None and runtime_env is None
                    and scheduling_strategy is None
                    and name is None):
                ref = self._try_fast_submit(
                    fn, args, kwargs, dict(resources or {"CPU": 1.0}),
                    max_retries=max_retries)
                if ref is not None:
                    return ref
            func_id = self._register_function(fn)
        self._task_counter += 1
        task_id = TaskID.generate()
        resources = dict(resources or {"CPU": 1.0})
        spec = {
            "task_id": task_id,
            "name": name or func_name or getattr(fn, "__name__", "task"),
            "func_id": func_id,
            "language": language,
            "func_name": func_name,
            "args": args,
            "kwargs": kwargs,
            "num_returns": num_returns,
            "resources": resources,
            "owner_address": self.address,
            "max_retries": self.cfg.default_max_task_retries if max_retries is None else max_retries,
            "placement_group": placement_group,
            "bundle_index": bundle_index,
            "scheduling_node": scheduling_node,
            "scheduling_strategy": scheduling_strategy,
            "runtime_env": self._resolve_runtime_env(runtime_env),
        }
        metrics.tasks_submitted.inc()
        self.task_events.emit(task_id=task_id.hex(), name=spec["name"],
                              state="PENDING_ARGS_AVAIL")
        if self.cfg.tracing_enabled:
            self._emit_submit_span(spec, spec["name"])
        if num_returns == "streaming":
            self._gen_states[task_id] = _GenState()
            self._call_on_loop(self._submit_async(spec))
            return ObjectRefGenerator(task_id, self)
        # lineage stash BEFORE _submit_async mutates args in place: the
        # original arg refs are pinned so lost returns can re-execute
        # (ref: task_manager.h:182, object_recovery_manager.h:43)
        self._lineage[task_id] = {
            **spec, "args": tuple(args), "kwargs": dict(kwargs),
        }
        self._lineage_live[task_id] = {
            ObjectID.for_task_return(task_id, i) for i in range(num_returns)
        }
        if len(self._lineage) > 10_000:
            old = next(iter(self._lineage))
            self._lineage.pop(old)
            self._lineage_live.pop(old, None)
        refs = []
        for i in range(num_returns):
            roid = ObjectID.for_task_return(task_id, i)
            self.memory_store[roid] = _MemEntry()
            refs.append(self._new_owned_ref(roid))
        self._call_on_loop(self._submit_async(spec))
        return refs[0] if num_returns == 1 else refs

    def _emit_submit_span(self, spec: dict, name: str) -> None:
        """Record a point span for the .remote() call and inject its id as
        the parent for the executing side's child span (ref:
        tracing_helper.py:36-60 span-context injection into task specs).
        Head-sampled: an unsampled root gets no span and no trace_ctx."""
        from ray_tpu_torch.utils import tracing

        parent = tracing.submit_context()
        if parent is None:
            return  # unsampled request: ship nothing, record nothing
        tid_hex = spec["task_id"].hex()
        submit_id = tracing.emit_point(
            f"{name}.remote", parent,
            lambda s: self.task_events.emit(
                task_id=tid_hex, name=s["name"], state="SPAN", span=s),
            stage="wire", transport="rpc")
        spec["trace_ctx"] = {"trace_id": parent["trace_id"],
                             "parent_span_id": submit_id}

    def _trace_submit_leg(self, task_id: TaskID, name: str,
                          transport: str) -> bytes:
        """Wire trace leg for one fast-lane submit (b"" = unsampled:
        the caller ships nothing). Sampled: mints the submit and call
        span ids, registers them keyed by the return oid, and returns
        the packed 25-byte context whose span_id is the CALL span — so
        the worker's exec span nests INSIDE the wire-level call span
        (the call span's self-time is then pure transport, never
        double-billing exec). NOTHING is emitted yet: both spans land
        at reply-apply, so a declined submit (RPC fallback) leaves no
        orphan markers and the fallback's own spans are the record."""
        from ray_tpu_torch.utils import tracing

        # the head-sampling gate itself: returns None (no alloc
        # downstream) for unsampled requests, and a sampled submit
        # minting its trace leg IS the product
        ctx = tracing.submit_context()  # raylint: disable=RT023 -- sampling gate
        if ctx is None:
            return b""
        submit_id = tracing._gen_span_id()
        call_id = tracing._gen_span_id()
        pending = self._trace_pending
        if len(pending) > 4096:  # replies that never came (broken lanes)
            pending.pop(next(iter(pending)), None)
        oid = ObjectID.for_task_return(task_id, 0)
        pending[oid] = (ctx["trace_id"], ctx.get("parent_span_id"),
                        submit_id, call_id, name, time.time(), transport)
        return tracing.pack_ctx(ctx["trace_id"], call_id, True)

    def _trace_emit_submit_point(self, task_id: TaskID, tp) -> None:
        """Materialize the deferred submit point span (reply-apply, or
        an RPC resubmission that inherits the pending context)."""
        trace_id, parent0, submit_id, _, name, t_submit, transport = tp
        self.task_events.emit(
            task_id=task_id.hex(), name=f"{name}.remote", state="SPAN",
            span={
                "trace_id": trace_id, "span_id": submit_id,
                "parent_span_id": parent0, "name": f"{name}.remote",
                "start_ts": t_submit, "end_ts": t_submit,
                "stage": "wire", "transport": transport,
            })

    def _trace_apply_replies(self, tspans: list) -> None:
        """Reply-apply leg of wire tracing: for each sampled completion,
        materialize the submit point span and the ``<name>::call`` wire
        span (submit wall -> apply wall, span id PRE-MINTED at submit —
        the worker's ::run span is its child) with the stage stamp as
        attributes — the queue-vs-exec-vs-wire truth TraceCriticalPath
        consumes."""
        from ray_tpu_torch.core import fastpath

        now = time.time()
        for oid, stamp, tp in tspans:
            trace_id, _, submit_id, call_id, name, t_submit, transport = tp
            task_id = oid.task_id()
            self._trace_emit_submit_point(task_id, tp)
            span = {
                "trace_id": trace_id,
                "span_id": call_id,
                "parent_span_id": submit_id,
                "name": f"{name}::call",
                "start_ts": t_submit, "end_ts": now,
                "stage": "wire", "transport": transport,
            }
            if stamp is not None:
                ring_ns, deser_ns, exec_ns = fastpath.unpack_stamp(stamp)
                span["ring_us"] = ring_ns / 1e3
                span["deser_us"] = deser_ns / 1e3
                span["exec_us"] = exec_ns / 1e3
            self.task_events.emit(
                task_id=task_id.hex(), name=span["name"],
                state="SPAN", span=span)

    def _call_on_loop(self, coro):
        """Run a coroutine (or apply a deleted-ref notice, passed as a bare
        ObjectID) on the loop thread, coalescing cross-thread wakeups.

        Two lanes: coroutines are latency-sensitive (an RPC-path sync
        call's submission rides here) and arm the drain immediately;
        deleted-ref notices are pure bookkeeping and ride a lazy 5ms
        timer, so a blocking-call loop (submit/get/submit/get...) never
        pays a loop wakeup per iteration just to decrement a refcount —
        on a one-core host every extra loop wake lands on the critical
        path between the caller and the worker."""
        if _in_loop(self.loop):
            if type(coro) is ObjectID:
                self._on_owned_ref_deleted_on_loop(coro)
            else:
                self._bg.spawn(coro, self.loop)
            return
        if type(coro) is ObjectID:
            with self._xq_lock:
                self._xq_lazy.append(coro)
                if self._xq_armed or self._xq_lazy_armed:
                    return  # an armed drain will sweep the lazy queue too
                self._xq_lazy_armed = True
            self.loop.call_soon_threadsafe(self._arm_lazy_xq)
            return
        # Coalesced thread->loop handoff: call_soon_threadsafe writes the
        # loop's self-pipe (a syscall) per call, so a burst of .remote()
        # submissions from the user thread pays one wakeup per task. Queue
        # instead and arm a single drain callback per burst.
        with self._xq_lock:
            self._xq.append(coro)
            arm = not self._xq_armed
            if arm:
                self._xq_armed = True
        if arm:
            self.loop.call_soon_threadsafe(self._drain_xq)

    def _arm_lazy_xq(self):
        self.loop.call_later(0.005, self._drain_xq)

    def _drain_xq(self):
        with self._xq_lock:
            lazy = self._xq_lazy
            self._xq_lazy = []
            if not self._xq and not lazy:
                # Linger one extra loop tick before disarming: during a
                # submission burst the producer refills between ticks, and
                # staying armed means it never pays the self-pipe wakeup.
                if self._xq_linger:
                    self._xq_linger = False
                    self.loop.call_soon(self._drain_xq)
                else:
                    self._xq_armed = False
                    self._xq_lazy_armed = False
                return
            batch = self._xq
            self._xq = []
            self._xq_linger = bool(batch)
        for oid in lazy:
            self._on_owned_ref_deleted_on_loop(oid)
        for coro in batch:
            if type(coro) is ObjectID:
                self._on_owned_ref_deleted_on_loop(coro)
            else:
                self._bg.spawn(coro, self.loop)
        if batch:
            # burst linger: immediate re-pass while coroutine traffic flows
            with self._xq_lock:
                self._xq_armed = True
                self._xq_lazy_armed = False
            self.loop.call_soon(self._drain_xq)
        else:
            # lazy-only traffic: stay armed on a sleepy timer instead of
            # busy-ticking the loop against the critical path
            with self._xq_lock:
                self._xq_lazy_armed = True
                self._xq_armed = False
            self.loop.call_later(0.005, self._drain_xq)

    async def _submit_async(self, spec: dict):
        try:
            pins: list = []
            spec["args"] = await self._resolve_args(spec["args"], pins)
            spec["kwargs"] = dict(
                zip(spec["kwargs"].keys(),
                    await self._resolve_args(list(spec["kwargs"].values()), pins))
            )
            if pins:
                self._inflight_pins[spec["task_id"]] = pins
        except Exception as e:
            self._complete_task_error(spec, e)
            return
        key = (
            spec["func_id"],
            tuple(sorted(spec["resources"].items())),
            spec.get("placement_group") and spec["placement_group"].hex(),
            spec.get("bundle_index"),
            spec.get("scheduling_node"),
            _strategy_key(spec.get("scheduling_strategy")),
        )
        state = self.sched_keys.setdefault(key, _SchedulingKeyState())
        state.strategy = spec.get("scheduling_strategy")
        state.inflight_tasks += 1
        await state.pending.put(spec)
        await self._pump(key, state)

    async def _resolve_args(self, args, pins: list, seal: bool = True):
        """Dependency resolution (ref: dependency_resolver.cc): owned inline
        args become values; everything else ships as a ref descriptor the
        executor fetches. A plain value above ``max_inline_object_size``
        is sealed into the local arena as an object of ours, as ``put``
        would store it, and ships as a ref too (ref: the submitter's
        promotion of args above max_direct_call_object_size to plasma);
        with no local store (client mode), or ``seal`` False (a detached
        actor's constructor: it outlives us, and our objects with us), it
        stays inline, as ``put``'s objects do. ``pins`` collects every ObjectRef the args carry
        (top-level, nested inside packed values, and the sealed values'
        own) so the caller can keep them alive until the task completes
        — without this the owner could free an object while its ref is in
        flight to a slow-starting worker."""
        out = []
        for a in args:
            if isinstance(a, ObjectRef):
                pins.append(a)
                entry = self.memory_store.get(a.id)
                if entry is not None:
                    await entry.ready.wait()
                    if entry.error is not None:
                        raise entry.error
                    if not entry.in_shm:
                        packed = entry.packed
                        if packed is None:
                            meta, bufs = serialization.dumps_with_buffers(entry.value)
                            packed = _pack_bytes(meta, bufs, serialization.total_size(meta, bufs))
                        out.append(("v", packed))
                        continue
                self.note_ref_shipped(a.id)
                out.append(("r", a.id.binary(), a.owner_address))
            else:
                # pack through our serializer (cloudpickle fallback, torch/numpy
                # out-of-band) — the raw rpc frame uses plain pickle which
                # would choke on closures/tensors. No awaits between
                # setting and clearing _ship_collect: single loop thread.
                self._ship_collect = pins
                try:
                    meta, bufs = serialization.dumps_with_buffers(a)
                finally:
                    self._ship_collect = None
                size = serialization.total_size(meta, bufs)
                if (not seal or self.store is None
                        or size <= self.cfg.max_inline_object_size):
                    out.append(("v", serialization.pack_parts(meta, bufs)))
                    continue
                await self._spill_for(size)
                ref = self._seal_owned(meta, bufs, size)
                pins.append(ref)
                self.sealed_args += 1
                self.note_ref_shipped(ref.id)
                out.append(("r", ref.id.binary(), ref.owner_address))
        return out

    async def _pump(self, key, state: _SchedulingKeyState):
        """Dispatch pending tasks onto free leased workers; grow leases."""
        # hand tasks to free workers — a deep backlog rides one rpc frame
        # per worker turn (push_task_multi) instead of one frame per task.
        # The backlog is split across ALL free workers first (chunk), so a
        # small burst doesn't pile onto one worker and serialize.
        # a worker whose fast lane has tasks in flight is not free: its pump
        # thread is executing ring work, and an RPC batch on top would run
        # two tasks concurrently on a one-CPU lease
        # Prefer workers whose fast lane is quiet — an RPC batch on top of
        # in-flight ring work would run two tasks at once on a one-CPU
        # lease. Preference, not exclusion: when every lane is busy it is
        # still better to dispatch (brief oversubscription) than to starve
        # the batch and trigger a worker spawn that eats the only CPU.
        free = [w for w in state.workers if not w.busy]
        quiet = [w for w in free
                 if not (w.fast_lane is not None and w.fast_lane.inflight)]
        if quiet:
            free = quiet
        if free and not state.pending.empty():
            # chunk the backlog over free workers PLUS the leases we could
            # still grow into: a batch is committed to its worker, so
            # handing one worker everything would leave nothing for workers
            # a lease request is about to deliver (and then churn
            # spawn/idle/return on them)
            headroom = max(
                0,
                min(self.cfg.max_lease_parallelism, _NCPU)
                - len(state.workers),
            )
            targets = len(free) + headroom
            chunk = max(1, min(self.cfg.push_batch_size,
                               -(-state.pending.qsize() // targets)))
            if state.avg_task_s > 0.05:
                # long tasks: committing a deep batch to one worker would
                # serialize them and hide the backlog from lease growth,
                # spillback and the autoscaler — dispatch one at a time
                chunk = 1
            if (state.strategy or {}).get("type") == "spread":
                # SPREAD's whole point is one lease per node slice —
                # a deep batch on one worker would serialize the spread
                chunk = 1
            for w in free:
                if state.pending.empty():
                    break
                specs = [state.pending.get_nowait()]
                while len(specs) < chunk and not state.pending.empty():
                    specs.append(state.pending.get_nowait())
                w.busy = True
                self._bg.spawn(
                    self._run_on_worker(key, state, w, specs), self.loop)
        # grow leases in PARALLEL with backlog depth (ref:
        # normal_task_submitter pipelined RequestWorkerLease): a deep burst
        # must not pay one sequential worker-spawn per task. Bounded by
        # host cores — concurrent python worker spawns are CPU-hungry and
        # over-forking on small machines slows everything down.
        spawn_cap = _NCPU
        # demand = work still in the queue (the chunking above deliberately
        # leaves backlog in pending when lease headroom exists, so this
        # signal stays live for deep bursts — and goes quiet for small
        # bursts fully committed to live workers, avoiding spawn churn),
        # plus ring-queued fast tasks beyond one-per-worker — but only
        # once that backlog persisted (micro-bursts drain in milliseconds
        # and must not trigger worker spawns that eat their CPU)
        fast_backlog = 0
        if (state.fast_backlog_since
                and time.monotonic() - state.fast_backlog_since > 0.5):
            fast_backlog = sum(
                max(0, len(w.fast_lane.inflight) - 1)
                for w in state.workers if w.fast_lane is not None)
        want = min(
            state.pending.qsize() + fast_backlog
            - state.lease_requests_inflight,
            self.cfg.max_lease_parallelism - state.lease_requests_inflight,
            spawn_cap - state.lease_requests_inflight,
        )
        for _ in range(max(0, want)):
            state.lease_requests_inflight += 1
            self._bg.spawn(self._request_lease(key, state), self.loop)
        self._report_demand()

    def _report_demand(self):
        """Tell our raylet how much work is queued that no live lease or
        in-flight lease request will absorb, so unsatisfiable backlog is
        visible to the autoscaler even when this driver stops requesting
        leases (ref: autoscaler v2 resource-demand reporting). Coalesced
        and only sent on change."""
        now = time.monotonic()
        total = 0
        for state in self.sched_keys.values():
            backlog = state.pending.qsize()
            durable = (state.fast_backlog_since
                       and now - state.fast_backlog_since > 0.5)
            for w in state.workers:
                if w.fast_lane is not None and durable:
                    backlog += max(0, len(w.fast_lane.inflight) - 1)
                backlog += max(0, w.queued - 1)  # committed beyond executing
            total += max(0, backlog - state.lease_requests_inflight)
        if total == getattr(self, "_last_demand_report", 0):
            return
        self._last_demand_report = total
        if self.raylet is not None and not self.raylet._closed:
            self._bg.spawn(
                self.raylet.call("report_demand", {"count": total}),
                self.loop)

    async def _request_lease(self, key, state: _SchedulingKeyState):
        try:
            resources = dict(key[1])
            pg_hex = key[2]
            payload = {
                "resources": resources,
                "pg_id": None,
                "bundle_index": key[3],
                # cpp func_ids are b"cpp:<name>"; the raylet pools and
                # spawns workers per language (ref: worker_pool.h:231)
                "language": "cpp" if key[0].startswith(b"cpp:") else "python",
            }
            if pg_hex:
                from ray_tpu_torch.utils.ids import PlacementGroupID

                payload["pg_id"] = PlacementGroupID.from_hex(pg_hex)
            raylet_addr = self.raylet_address
            target_node = key[4]
            strategy = state.strategy
            if strategy is not None:
                if strategy["type"] == "node_affinity":
                    # resolved address cached per scheduling key (stable
                    # while the node lives); cleared on lease failure so
                    # a died-and-replaced node re-resolves
                    addr = state.affinity_addr
                    if addr is None:
                        addr = await self._node_address(strategy["node_id"])
                        state.affinity_addr = addr
                    if addr is not None:
                        raylet_addr = tuple(addr)
                        if not strategy.get("soft"):
                            payload["no_spill"] = True
                    elif not strategy.get("soft"):
                        raise SchedulingError(
                            f"node {strategy['node_id']} required by "
                            "NodeAffinitySchedulingStrategy(soft=False) is "
                            "not alive")
                    # soft + node gone: fall back to the default policy
                else:
                    payload["strategy"] = strategy
            if target_node is not None:
                payload["no_spill"] = True
                raylet_addr = tuple(target_node)
            for _ in range(16):  # follow spillback chain
                conn = (
                    self.raylet
                    if tuple(raylet_addr) == tuple(self.raylet_address)
                    else await rpc.connect(*raylet_addr)
                )
                try:
                    # persistent conn → raylet may reap the lease if we die
                    payload["owner_bound"] = conn is self.raylet
                    reply = await conn.call("lease_worker", payload)
                finally:
                    if conn is not self.raylet:
                        await conn.close()
                if reply.get("infeasible"):
                    raise SchedulingError(
                        reply.get("error") or "no node satisfies the "
                        "task's scheduling strategy")
                if reply.get("drop_strategy"):
                    # strategy already satisfied by the redirect target
                    # (e.g. SPREAD chose it): it should grant locally
                    payload.pop("strategy", None)
                if reply.get("granted"):
                    w = _LeasedWorker(
                        lease_id=reply["lease_id"],
                        address=tuple(reply["worker_address"]),
                        worker_id=reply["worker_id"],
                        raylet_address=tuple(raylet_addr),
                        gpu_ids=reply.get("gpu_ids"),
                    )
                    w.conn = await rpc.connect(*w.address)
                    state.workers.append(w)
                    state.lease_failures = 0
                    state.lease_failure_sig = None
                    if (self.cfg.fastpath_enabled
                            and self.store is not None
                            and payload["language"] == "python"
                            and pg_hex is None):
                        same = (tuple(raylet_addr)
                                == tuple(self.raylet_address))
                        if same and not self.cfg.tunnel_force:
                            self._bg.spawn(
                                self._fast_attach(key, state, w), self.loop)
                        elif self._tunnel_ok():
                            # spilled-back / affinity lease on another
                            # node: "Q"/"R" records ride the node tunnel
                            self._bg.spawn(
                                self._tunnel_task_attach(key, state, w),
                                self.loop)
                    # arm the idle-return timer NOW: a lease granted after
                    # the backlog drained may never run a task, and the
                    # post-task timer alone would leak it (and its CPUs)
                    self._bg.spawn(self._maybe_return_lease(key, state, w), self.loop)
                    break
                raylet_addr = tuple(reply["spill_to"])
        except Exception as e:
            # A lease that keeps failing the SAME way with no workers to
            # show for it is a configuration problem (e.g. cpp task but no
            # RT_CPP_WORKER binary): fail the pending tasks instead of
            # spinning spawn->raise->pump forever. Guarded against one
            # transient hiccup failing several PARALLEL requests at once:
            # the error text must repeat, the failures must span real time
            # (> 2s, i.e. distinct attempts), and no lease may be live.
            now = time.monotonic()
            state.affinity_addr = None  # re-resolve after any failure
            # type-only signature: messages embed per-attempt detail
            # (ports, pids, paths) that must not defeat the breaker
            sig = type(e).__name__
            if sig != state.lease_failure_sig:
                state.lease_failure_sig = sig
                state.lease_failures = 1
                state.lease_failure_since = now
            else:
                state.lease_failures += 1
            # ConfigurationError is definitively non-transient (no worker
            # binary etc.): break immediately. Anything else — including
            # worker-start timeouts on a loaded box — gets a high threshold
            # and real elapsed time before we fail the pending tasks.
            is_config = isinstance(e, ConfigurationError)
            persistent = not state.workers and (
                is_config
                or (
                    state.lease_failures >= 10
                    and now - state.lease_failure_since > 15.0
                )
            )
            if persistent:
                err = e if isinstance(e, Exception) else TaskError(str(e))
                while not state.pending.empty():
                    spec = state.pending.get_nowait()
                    self._complete_task_error(spec, err)
                    state.inflight_tasks -= 1
                state.lease_failures = 0
                state.lease_failure_sig = None
            else:
                traceback.print_exc()
                # backoff so repeated transient failures (slow spawns) don't
                # hot-spin the pump → lease → raise loop
                await asyncio.sleep(min(0.2 * state.lease_failures, 2.0))
        finally:
            state.lease_requests_inflight -= 1
            await self._pump(key, state)

    async def _node_address(self, node_hex: str):
        """Resolve a node id (hex) to its raylet address via the GCS
        cluster view; None if the node is unknown or dead. GCS RPC
        failures propagate — a transient GCS hiccup must retry through
        the lease backoff path, not masquerade as a dead node and
        permanently fail hard-affinity tasks."""
        view = await self.gcs.call("get_cluster", {})
        for n in view:
            nid = n.get("node_id")
            nid_hex = nid.hex() if hasattr(nid, "hex") else str(nid)
            if nid_hex == node_hex and n.get("alive", True):
                return n.get("address")
        return None

    async def _run_on_worker(self, key, state, w: _LeasedWorker, specs: list):
        todo = []
        for spec in specs:
            if spec["task_id"] in self._cancelled_tasks:
                self._complete_task_error(
                    spec, TaskCancelledError(str(spec["task_id"])))
                state.inflight_tasks -= 1
            else:
                todo.append(spec)
        if not todo:
            w.busy = False
            w.idle_since = time.monotonic()
            await self._pump(key, state)
            self._bg.spawn(self._maybe_return_lease(key, state, w), self.loop)
            return
        for spec in todo:
            self.task_events.emit(task_id=spec["task_id"].hex(),
                                  name=spec["name"],
                                  state="SUBMITTED_TO_WORKER",
                                  worker_id=w.worker_id)
            self._task_worker[spec["task_id"]] = (
                w.raylet_address, w.worker_id, w.conn)
            if w.gpu_ids:
                spec["gpu_ids"] = w.gpu_ids
        done: list = []
        w.queued = len(todo)  # committed depth: demand accounting
        t_dispatch = time.monotonic()
        try:
            if len(todo) == 1 or key[0].startswith(b"cpp:"):
                # C++ workers speak the single-push protocol only (their
                # reader drops notification frames): pipeline sequentially
                for spec in todo:
                    done.append(
                        (spec, await w.conn.call("push_task", {"spec": spec})))
                    w.queued -= 1
            else:
                # one frame out, one reply per task back as each finishes
                futs = w.conn.call_scatter(
                    "push_task_multi", [{"spec": s} for s in todo])
                for idx, (spec, fut) in enumerate(zip(todo, futs)):
                    try:
                        done.append((spec, await fut))
                        w.queued -= 1
                    except rpc.ConnectionLost:
                        # later batch-mates may have RESOLVED before the
                        # connection died (replies arrive out of order):
                        # harvest those results, and consume the failed
                        # siblings' exceptions so asyncio doesn't log
                        # "exception was never retrieved" per task
                        lost = []
                        for s2, f2 in zip(todo[idx:], futs[idx:]):
                            if f2.done() and f2.exception() is None:
                                done.append((s2, f2.result()))
                            else:
                                if not f2.done():
                                    f2.cancel()
                                lost.append(s2)
                        # apply what completed, retry only the rest
                        for s2, reply in done:
                            self._task_worker.pop(s2["task_id"], None)
                            self._apply_task_reply(s2, reply)
                            state.inflight_tasks -= 1
                        for s2 in lost:
                            await self._on_worker_lost(key, state, w, s2)
                        return
        except rpc.ConnectionLost:
            # apply whatever completed before the drop (sequential path),
            # retry only the rest
            for s2, reply in done:
                self._task_worker.pop(s2["task_id"], None)
                self._apply_task_reply(s2, reply)
                state.inflight_tasks -= 1
            finished = {id(s) for s, _ in done}
            for spec in todo:
                if id(spec) not in finished:
                    await self._on_worker_lost(key, state, w, spec)
            return
        except Exception as e:
            # e.g. an unpicklable task spec: fail the tasks, free the worker
            for s2, reply in done:
                self._task_worker.pop(s2["task_id"], None)
                self._apply_task_reply(s2, reply)
                state.inflight_tasks -= 1
            finished = {id(s) for s, _ in done}
            for spec in todo:
                if id(spec) in finished:
                    continue
                self._task_worker.pop(spec["task_id"], None)
                self._complete_task_error(spec, e)
                state.inflight_tasks -= 1
            w.queued = 0
            w.busy = False
            w.idle_since = time.monotonic()
            await self._pump(key, state)
            self._bg.spawn(self._maybe_return_lease(key, state, w), self.loop)
            return
        for spec, reply in done:
            self._task_worker.pop(spec["task_id"], None)
            self._apply_task_reply(spec, reply)
            state.inflight_tasks -= 1
        w.queued = 0
        if done:
            per_task = (time.monotonic() - t_dispatch) / len(done)
            state.avg_task_s = (0.7 * state.avg_task_s + 0.3 * per_task
                                if state.avg_task_s else per_task)
        w.busy = False
        w.idle_since = time.monotonic()
        await self._pump(key, state)
        self._bg.spawn(self._maybe_return_lease(key, state, w), self.loop)

    def _apply_task_reply(self, spec, reply):
        task_id = spec["task_id"]
        self._inflight_pins.pop(task_id, None)
        self._cancelled_tasks.discard(task_id)
        name = spec.get("name") or spec.get("method", "task")
        if reply.get("error") is not None:
            metrics.tasks_finished.inc(tags={"outcome": "failed"})
            self.task_events.emit(task_id=task_id.hex(), name=name, state="FAILED",
                                  error=str(reply["error"])[:200])
            self._complete_task_error(spec, reply["error"])
            return
        metrics.tasks_finished.inc(tags={"outcome": "ok"})
        self.task_events.emit(task_id=task_id.hex(), name=name, state="FINISHED")
        for i, result in enumerate(reply["results"]):
            oid = ObjectID.for_task_return(task_id, i)
            entry = self.memory_store.get(oid)
            if entry is None:
                continue
            if result.get("inline") is not None:
                entry.packed = result["inline"]
            else:
                entry.in_shm = True
                # completion-time location priming: the reply names the
                # sealing node, so get() goes straight to the pull with a
                # holder hint — zero directory round-trips in steady state
                node = result.get("node")
                if node is not None:
                    self._obj_locations.setdefault(oid, set()).add(node)
            entry.ready.set()

    def _complete_task_error(self, spec, error):
        self._inflight_pins.pop(spec["task_id"], None)
        if not isinstance(error, TaskCancelledError):
            self._cancelled_tasks.discard(spec["task_id"])
        if not isinstance(error, Exception):
            error = TaskError(str(error))
        if spec["num_returns"] == "streaming":
            state = self._gen_states.get(spec["task_id"])
            if state is not None and not state.done:
                state.error = error
                state.done = True
                state.event.set()
            return
        for i in range(spec["num_returns"]):
            oid = ObjectID.for_task_return(spec["task_id"], i)
            entry = self.memory_store.get(oid)
            if entry is not None:
                entry.error = error
                entry.ready.set()

    # -------------------------------------------------- streaming generators
    async def rpc_generator_item(self, conn, p):
        """Executor reports one yielded item (ref: core_worker.proto:498
        ReportGeneratorItemReturns); the awaited ack is the backpressure
        (generator_waiter.h role: producer can't run far ahead)."""
        task_id = p["task_id"]
        state = self._gen_states.get(task_id)
        if state is None:
            return {"ok": False, "cancelled": True}  # consumer gone: stop
        if p.get("item") is not None:
            item = p["item"]
            oid = ObjectID.for_task_return(task_id, p["index"])
            entry = _MemEntry()
            if item.get("inline") is not None:
                entry.packed = item["inline"]
            else:
                entry.in_shm = True
                node = item.get("node")
                if node is not None:
                    self._obj_locations.setdefault(oid, set()).add(node)
            entry.ready.set()
            self.memory_store[oid] = entry
            state.items.append(self._new_owned_ref(oid))
        if p.get("done"):
            state.done = True
            if p.get("error") is not None:
                state.error = p["error"]
        state.event.set()
        return {"ok": True}

    async def gen_next(self, task_id: TaskID, timeout: float | None = None):
        """Next item ref, or None when the stream ends (async side)."""
        state = self._gen_states.get(task_id)
        if state is None:
            return None
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            if state.items:
                return state.items.pop(0)
            if state.error is not None:
                err = state.error
                raise err if isinstance(err, Exception) else TaskError(str(err))
            if state.done:
                return None
            state.event.clear()
            try:
                remain = (deadline - time.monotonic()) if deadline else None
                if remain is not None and remain <= 0:
                    raise GetTimeoutError(f"generator {task_id} timed out")
                await asyncio.wait_for(state.event.wait(), remain)
            except asyncio.TimeoutError:
                raise GetTimeoutError(f"generator {task_id} timed out") from None

    def gen_next_sync(self, task_id: TaskID, timeout: float | None = None):
        return self._run_sync(self.gen_next(task_id, timeout))

    def gen_completed(self, task_id: TaskID) -> bool:
        state = self._gen_states.get(task_id)
        return state is None or (state.done and not state.items)

    def gen_release(self, task_id: TaskID):
        self._gen_states.pop(task_id, None)

    async def _on_worker_lost(self, key, state, w, spec):
        """Retry on worker death (ref: task_manager.h retries). Streaming
        tasks don't replay: already-consumed items can't be un-delivered,
        so the stream fails fast instead."""
        if w in state.workers:
            state.workers.remove(w)
        if w.fast_lane is not None:
            self._fast_break_lane(w.fast_lane)
        self._task_worker.pop(spec["task_id"], None)
        if spec["task_id"] in self._cancelled_tasks:
            self._complete_task_error(
                spec, TaskCancelledError(str(spec["task_id"]))
            )
            state.inflight_tasks -= 1
            await self._pump(key, state)
            return
        if spec["num_returns"] == "streaming":
            self._complete_task_error(spec, WorkerCrashedError())
            state.inflight_tasks -= 1
            await self._pump(key, state)
            return
        spec["max_retries"] = spec.get("max_retries", 0) - 1
        if spec["max_retries"] >= 0:
            await state.pending.put(spec)
        else:
            self._complete_task_error(spec, WorkerCrashedError())
            state.inflight_tasks -= 1
        await self._pump(key, state)

    async def _maybe_return_lease(self, key, state: _SchedulingKeyState, w: _LeasedWorker):
        await asyncio.sleep(self.cfg.worker_lease_timeout_s)
        if w.busy or w not in state.workers:
            return
        if w.fast_lane is not None and w.fast_lane.inflight:
            return  # fast tasks in flight; their drain re-arms the watcher
        if time.monotonic() - w.idle_since < self.cfg.worker_lease_timeout_s * 0.9:
            return
        if w.fast_lane is not None and not self._fast_try_retire_lane(
                w.fast_lane):
            return  # a submit raced the idle check: lane is live again
        state.workers.remove(w)
        try:
            if w.conn is not None:
                await w.conn.close()
            conn = (
                self.raylet
                if tuple(w.raylet_address) == tuple(self.raylet_address)
                else await rpc.connect(*w.raylet_address)
            )
            try:
                await conn.call("return_lease", {"lease_id": w.lease_id})
            finally:
                if conn is not self.raylet:
                    await conn.close()
        except (rpc.RpcError, OSError):
            pass  # raylet died: the lease is already gone with it

    # ------------------------------------------------------------- actors
    def _resolve_runtime_env(self, env):
        """Per-call envs with raw paths get packaged (and uploaded,
        synchronously — the task must not race its own package to the
        worker); already-packaged descriptors and the init() default pass
        through."""
        if env is None:
            return self.default_runtime_env
        import re as _re

        def is_digest(v):
            return isinstance(v, str) and _re.fullmatch(r"[0-9a-f]{40}", v)

        wd = env.get("working_dir")
        mods = env.get("py_modules", ())
        # a non-digest entry must be a real directory: catch typos at
        # submission, not as a cryptic package-missing error on the worker
        for entry in ([wd] if wd else []) + list(mods):
            if not is_digest(entry) and not os.path.isdir(entry):
                raise ValueError(
                    f"runtime_env path {entry!r} is not a directory"
                )
        from ray_tpu_torch import runtime_env as _renv

        needs_packaging = (
            (wd and os.path.isdir(wd))
            or any(os.path.isdir(p) for p in mods)
            # plugin fields (pip/uv/...) normalize driver-side: the worker
            # only ever sees packaged descriptors
            or any(env.get(name) is not None
                   and not (isinstance(env[name], dict)
                            and "digest" in env[name])
                   for name in _renv._PLUGINS)
        )
        if not needs_packaging:
            return env
        if _in_loop(self.loop):
            raise RuntimeError(
                "per-call runtime_env with directory paths cannot be "
                "packaged from the event-loop thread; package it at "
                "init(runtime_env=...) instead"
            )
        from ray_tpu_torch.runtime_env import package_runtime_env

        def kv_put(key, blob):
            self._run_sync(self.gcs.call(
                "kv_put",
                {"ns": "runtime_env_packages", "key": key, "value": blob,
                 "overwrite": False},
            ))

        return package_runtime_env(env, kv_put)

    def _build_actor_spec(self, cls, args, kwargs, *, num_cpus=1.0, resources=None,
                          name=None, max_restarts=0, max_concurrency=1,
                          placement_group=None, bundle_index=-1,
                          get_if_exists=False, lifetime=None,
                          runtime_env=None, concurrency_groups=None,
                          scheduling_strategy=None) -> dict:
        res = dict(resources or {})
        res.setdefault("CPU", num_cpus)
        # per-method concurrency groups (ref: concurrency_group_manager.cc):
        # methods annotated with @ray_tpu_torch.method(concurrency_group=...) map
        # onto named executor pools sized by `concurrency_groups`
        method_groups = {}
        method_num_returns = {}
        for mname in dir(cls):  # dir() walks the MRO: inherited methods count
            m = getattr(cls, mname, None)
            opts = getattr(m, "__rt_method_opts__", None)
            if not callable(m) or not opts:
                continue
            if opts.get("concurrency_group"):
                method_groups[mname] = opts["concurrency_group"]
            if opts.get("num_returns"):
                method_num_returns[mname] = opts["num_returns"]
        declared = set(concurrency_groups or {})
        undeclared = set(method_groups.values()) - declared
        if undeclared:
            raise ValueError(
                f"methods reference undeclared concurrency groups "
                f"{sorted(undeclared)}; declare them in "
                f"@remote(concurrency_groups={{...}})"
            )
        return {
            "runtime_env": self._resolve_runtime_env(runtime_env),
            "actor_id": ActorID.generate(),
            "name": name,
            "class_blob": serialization.ship_dumps(cls),
            "args": args,
            "kwargs": kwargs,
            "resources": res,
            "max_restarts": max_restarts,
            "max_concurrency": max_concurrency,
            "concurrency_groups": dict(concurrency_groups or {}),
            "method_groups": method_groups,
            "method_num_returns": method_num_returns,
            "placement_group": placement_group,
            "bundle_index": bundle_index,
            "owner_address": self.address,
            "get_if_exists": get_if_exists,
            "lifetime": lifetime,
            "scheduling_strategy": scheduling_strategy,
        }

    async def _register_actor(self, spec: dict) -> dict:
        # the refs among the constructor's args stay pinned until the actor
        # is created or dead: its worker fetches them only once it has
        # started, which under load outlasts the ship grace. An actor that
        # may restart holds them until it is dead: the GCS gives every
        # incarnation the same spec, refs and sealed args included
        pins: list = []
        seal = spec.get("lifetime") != "detached"
        spec["args"] = await self._resolve_args(spec["args"], pins, seal)
        spec["kwargs"] = dict(
            zip(
                spec["kwargs"].keys(),
                await self._resolve_args(list(spec["kwargs"].values()), pins, seal),
            )
        )
        view = await self.gcs.call("register_actor", {"spec": spec})
        self._actor_info[view["actor_id"]] = view
        if pins and spec.get("max_restarts"):
            self._bg.spawn(self._pin_until_dead(view["actor_id"], pins), self.loop)
        elif pins:
            self._bg.spawn(self._pin_until_created(view["actor_id"], pins), self.loop)
        return view

    async def _pin_until_dead(self, actor_id: ActorID, pins: list) -> None:
        """Hold ``pins`` (a restartable actor's creation args' refs) until
        the actor's DEAD push (``_on_push``) or our shutdown drops them."""
        self._ctor_pins[actor_id] = pins
        if actor_id not in self._subscribed_actors:
            self._subscribed_actors.add(actor_id)
            try:
                await self.gcs.call(
                    "subscribe", {"channel": f"actor:{actor_id.hex()}"})
            except (rpc.RpcError, OSError):
                self._subscribed_actors.discard(actor_id)
        try:  # dead before the subscription took: no push will come
            info = await self._refresh_actor(actor_id)
        except (rpc.RpcError, OSError):
            return
        if info is None or info.get("state") == DEAD:
            self._ctor_pins.pop(actor_id, None)

    async def _pin_until_created(self, actor_id: ActorID, pins: list) -> None:
        """Hold ``pins`` (the creation args' refs) until the GCS reports
        the actor ALIVE or DEAD, at most the worker start timeout."""
        deadline = time.monotonic() + self.cfg.worker_start_timeout_s
        while not self._closed and time.monotonic() < deadline:
            try:
                info = await self._refresh_actor(actor_id)
            except (rpc.RpcError, OSError):
                info = {}
            if info is None or info.get("state") in (ALIVE, DEAD):
                return
            await asyncio.sleep(0.1)

    def _seed_autokill(self, spec: dict) -> None:
        """Enroll a to-be-created actor in handle refcounting BEFORE its
        first handle exists (ActorHandle.__init__ only counts enrolled
        ids). Named and detached actors are reachable/alive beyond the
        creating handle, so they never enroll."""
        if spec["name"] is None and spec.get("lifetime") != "detached":
            with self._rc_lock:
                self._actor_handle_counts.setdefault(spec["actor_id"], 0)

    def note_actor_handle_created(self, actor_id: ActorID) -> bool:
        """ActorHandle.__init__ hook: count an owner-local handle.
        Returns whether this handle participates in autokill accounting
        (enrolled unnamed actors only; lookups of named/foreign actors
        return False)."""
        with self._rc_lock:
            if self._closed or actor_id not in self._actor_handle_counts:
                return False
            self._actor_handle_counts[actor_id] += 1
            return True

    def note_actor_handle_shipped(self, actor_id: ActorID) -> None:
        """ActorHandle.__reduce__ hook: a serialized handle may be alive
        anywhere — permanently exempt the actor from autokill."""
        with self._rc_lock:
            self._actor_no_autokill.add(actor_id)

    def note_actor_handle_dropped(self, actor_id: ActorID) -> None:
        """ActorHandle.__del__ hook: when the LAST owner-local handle of
        an enrolled actor drops, schedule a drain-gated kill so the
        actor's lease flows back to the raylet."""
        with self._rc_lock:
            n = self._actor_handle_counts.get(actor_id)
            if n is None:
                return
            self._actor_handle_counts[actor_id] = n = n - 1
            if (n > 0 or self._closed
                    or actor_id in self._actor_no_autokill):
                return
        try:
            asyncio.run_coroutine_threadsafe(
                self._autokill_actor(actor_id), self.loop)
        except RuntimeError:
            # loop already closed (interpreter exit): the GCS owner-death
            # reap returns the lease instead
            pass

    async def _autokill_actor(self, actor_id: ActorID) -> None:
        """Kill an unreferenced unnamed actor once its submitted work
        drains (queued RPC specs, in-flight RPC calls, fast-lane ring
        traffic) — never yanks a worker out from under a live call. The
        wait is bounded: a wedged actor is left to the normal death
        paths rather than pinning this coroutine forever."""
        deadline = self.loop.time() + 30.0
        while self.loop.time() < deadline:
            lane = self._fast_actor_lanes.get(actor_id)
            if (not self._actor_queues.get(actor_id)
                    and not self._actor_inflight.get(actor_id)
                    and not (lane is not None and lane.inflight)):
                break
            await asyncio.sleep(0.05)
        with self._rc_lock:
            if (self._closed
                    or self._actor_handle_counts.get(actor_id, 0) > 0
                    or actor_id in self._actor_no_autokill):
                return
            self._actor_handle_counts.pop(actor_id, None)
        try:
            await self.gcs.call("kill_actor", {"actor_id": actor_id,
                                               "no_restart": True})
        except Exception:
            log.debug("autokill of actor %s failed", actor_id.hex(),
                      exc_info=True)

    def create_actor(self, cls, args, kwargs, **opts) -> ActorHandle:
        spec = self._build_actor_spec(cls, args, kwargs, **opts)
        self._seed_autokill(spec)
        if _in_loop(self.loop):
            # Called from the event loop (e.g. an async actor creating other
            # actors): can't block. The actor_id is chosen client-side, so
            # the handle is valid immediately; registration completes in the
            # background and callers wait for ALIVE via _actor_connection.
            if spec["get_if_exists"]:
                raise RuntimeError(
                    "get_if_exists=True requires the registration reply and "
                    "cannot be used from the event-loop thread; await "
                    "create_actor_async instead"
                )
            self._bg.spawn(self._register_actor(spec), self.loop)
            return ActorHandle(spec["actor_id"], core=self,
                               options=_handle_options(spec))
        view = self._run_sync(self._register_actor(spec))
        return ActorHandle(view["actor_id"], core=self,
                           options=_handle_options(spec))

    async def create_actor_async(self, cls, args, kwargs, **opts) -> ActorHandle:
        """Event-loop-safe actor creation (supports get_if_exists)."""
        spec = self._build_actor_spec(cls, args, kwargs, **opts)
        self._seed_autokill(spec)
        view = await self._register_actor(spec)
        return ActorHandle(view["actor_id"], core=self,
                           options=_handle_options(spec))

    async def get_actor_by_name_async(self, name: str) -> ActorHandle | None:
        info = await self.gcs.call("get_actor", {"name": name})
        if info is None or info.get("state") == DEAD:
            return None
        self._actor_info[info["actor_id"]] = info
        return ActorHandle(info["actor_id"], core=self,
                           options=_handle_options(info))

    def submit_actor_task(self, handle: ActorHandle, method: str, args, kwargs,
                          num_returns=1,
                          concurrency_group: str | None = None,
                          _tmpl: ActorCallTemplate | None = None,
                          unordered: bool = False
                          ) -> ObjectRef | list[ObjectRef]:
        """Submission order is fixed here (sync, caller thread); a per-actor
        pump coroutine then resolves deps, assigns per-connection sequence
        numbers and pipelines pushes — the reference's ActorTaskSubmitter
        shape (ref: actor_task_submitter.h:75, ordered sends + out-of-order
        replies). ``_tmpl`` (set by ref.ActorMethod.remote) carries the
        frozen per-(handle, method) submission state so the fast try skips
        every per-call re-derivation."""
        if _tmpl is not None:
            if _tmpl.opts_ok:
                ref = self._try_fast_actor_submit(handle.actor_id, method,
                                                  args, kwargs, _tmpl)
                if ref is not None:
                    return ref
        elif (num_returns == 1 and concurrency_group is None
                and not self.cfg.tracing_enabled):
            ref = self._try_fast_actor_submit(handle.actor_id, method,
                                              args, kwargs)
            if ref is not None:
                return ref
        task_id = TaskID.generate_actor()
        actor_id = handle.actor_id
        metrics.actor_calls.inc()
        self.task_events.emit(task_id=task_id.hex(), name=method,
                              state="PENDING_ARGS_AVAIL", actor_id=actor_id.hex())
        streaming = num_returns == "streaming"
        refs = []
        if streaming:
            self._gen_states[task_id] = _GenState()
        else:
            for i in range(num_returns):
                roid = ObjectID.for_task_return(task_id, i)
                self.memory_store[roid] = _MemEntry()
                refs.append(self._new_owned_ref(roid))
        spec = {
            "task_id": task_id,
            "actor_id": actor_id,
            "method": method,
            "args": args,
            "kwargs": kwargs,
            "num_returns": num_returns,
            "owner_address": self.address,
            "seq": None,
            "concurrency_group": concurrency_group,
        }
        if unordered:
            # independent logical call (serve router fallback): skips the
            # fast->RPC drain barrier in _prepare_actor_task, so it never
            # parks behind the lane's in-flight ring traffic
            spec["unordered"] = True
        if self.cfg.tracing_enabled:
            self._emit_submit_span(spec, method)
        q = self._actor_queues.setdefault(actor_id, [])
        q.append(spec)
        self._call_on_loop(self._ensure_actor_pump(actor_id))
        if streaming:
            return ObjectRefGenerator(task_id, self)
        return refs[0] if num_returns == 1 else refs

    async def _ensure_actor_pump(self, actor_id: ActorID):
        """Single pump per actor owns BOTH dispatch and reconnect recovery,
        so replayed in-flight specs always precede anything newer — no
        separate recovery task can race the send order."""
        if actor_id in self._actor_pump_running:
            return
        self._actor_pump_running.add(actor_id)
        try:
            q = self._actor_queues.setdefault(actor_id, [])
            while True:
                dead = self._actor_recover_pending.get(actor_id)
                if dead:
                    conn = next(iter(dead))
                    dead.discard(conn)
                    await self._recover_actor_conn(actor_id, conn)
                    continue  # replay was prepended; loop re-checks
                if not q:
                    return
                # collect a same-connection batch: each spec keeps its own
                # seq + reply future (scatter push), so FIFO and per-call
                # completion are unchanged — only the frames coalesce
                batch: list = []
                bconn = None
                recover = False
                while q and len(batch) < self.cfg.push_batch_size:
                    spec = q[0]
                    try:
                        conn = await self._prepare_actor_task(spec)
                    except _RecoveryNeeded:
                        recover = True
                        break  # spec stays queued; replay goes out first
                    except Exception as e:
                        q.pop(0)
                        self._complete_task_error(spec, e)
                        continue
                    q.pop(0)
                    if bconn is not None and conn is not bconn:
                        # connection changed mid-collect (reconnect): flush
                        # what we have, start a new batch on the new conn
                        self._send_actor_batch(bconn, batch)
                        batch = []
                    bconn = conn
                    batch.append(spec)
                if batch:
                    self._send_actor_batch(bconn, batch)
                if recover:
                    continue
        finally:
            self._actor_pump_running.discard(actor_id)

    async def _prepare_actor_task(self, spec):
        """Resolve deps, pick the connection, assign the per-connection
        sequence number and register the spec for reconnect replay. Raises
        _RecoveryNeeded (before any seq is taken) when a replay must go out
        first."""
        if not spec.get("_resolved"):  # replayed specs are already done
            pins: list = []
            spec["args"] = await self._resolve_args(spec["args"], pins)
            spec["kwargs"] = dict(
                zip(spec["kwargs"].keys(),
                    await self._resolve_args(list(spec["kwargs"].values()), pins))
            )
            spec["_resolved"] = True
            if pins:
                self._inflight_pins[spec["task_id"]] = pins
        # per-caller FIFO across the fast->RPC per-call fallback: ring
        # records already in flight must complete before any RPC call
        # dispatches. Event-driven: the reply thread sets drain_evt when
        # the lane's inflight map empties (and break-lane does too), with
        # a bounded re-check instead of the old 1ms constant-sleep poll
        # (the RT013 shape).
        lane = self._fast_actor_lanes.get(spec["actor_id"])
        if spec.get("unordered"):
            lane = None  # independent call: no FIFO barrier against the ring
        if lane is not None and lane.inflight and not lane.broken:
            evt = lane.drain_evt
            lane.drain_waiters += 1  # reply threads signal only when > 0
            try:
                while lane.inflight and not lane.broken:
                    if evt is None:  # no event (not expected): bounded poll
                        await asyncio.sleep(0.01)
                        continue
                    evt.clear()
                    if not lane.inflight or lane.broken:
                        break  # emptied between the check and the clear
                    try:
                        await asyncio.wait_for(evt.wait(), timeout=0.25)
                    except asyncio.TimeoutError:
                        pass  # defensive re-check; the set may have raced
            finally:
                lane.drain_waiters -= 1
        conn = await self._actor_connection(spec["actor_id"])
        if self._actor_recover_pending.get(spec["actor_id"]):
            # a connection died while this dispatch was suspended: the
            # replay must go out first — hand the spec back to the pump
            raise _RecoveryNeeded()
        seq = self._conn_seq.get(conn, 0)
        self._conn_seq[conn] = seq + 1
        spec["seq"] = seq
        self._actor_inflight.setdefault(spec["actor_id"], {})[spec["task_id"]] = spec
        return conn

    def _send_actor_batch(self, conn, specs: list):
        # pipelined: don't await replies here, keep the pump moving
        if len(specs) == 1:
            self._bg.spawn(self._await_actor_reply(conn, specs[0]), self.loop)
            return
        futs = conn.call_scatter(
            "push_actor_task_multi", [{"spec": s} for s in specs])
        for spec, fut in zip(specs, futs):
            self._bg.spawn(self._await_actor_reply(conn, spec, fut), self.loop)

    async def _await_actor_reply(self, conn, spec, fut=None):
        try:
            if fut is None:
                reply = await conn.call("push_actor_task", {"spec": spec})
            else:
                reply = await fut
            self._actor_inflight.get(spec["actor_id"], {}).pop(spec["task_id"], None)
            self._apply_task_reply(spec, reply)
        except rpc.ConnectionLost:
            # mark the conn for pump-owned recovery and wake the pump; the
            # spec stays in _actor_inflight for the replay
            aid = spec["actor_id"]
            self._actor_recover_pending.setdefault(aid, set()).add(conn)
            self._bg.spawn(self._ensure_actor_pump(aid), self.loop)
        except Exception as e:
            self._actor_inflight.get(spec["actor_id"], {}).pop(spec["task_id"], None)
            self._complete_task_error(spec, e)

    async def _recover_actor_conn(self, actor_id: ActorID, conn):
        """Runs INSIDE the actor's pump: requeue the dead connection's
        in-flight specs at the queue head in original send order, so FIFO
        holds across the reconnect (ref: actor_task_submitter sequence
        replay). Execution is at-least-once across reconnects, same as
        worker-crash retries. Any failure here fails the replayed specs —
        they are never silently dropped."""
        if self._actor_conns.get(actor_id) is conn:
            self._actor_conns.pop(actor_id, None)
        self._conn_seq.pop(conn, None)
        inflight = self._actor_inflight.get(actor_id, {})
        replay = list(inflight.values())  # dict preserves send order
        inflight.clear()
        if not replay:
            return
        info = None
        for i in range(3):  # ride out a transient GCS blip
            try:
                info = await self._refresh_actor(actor_id)
                break
            except Exception:
                # exponential backoff: a GCS mid-failover gets room to
                # come back instead of three probes in 600ms (RT013)
                await asyncio.sleep(0.1 * (1 << i) * (0.5 + random.random()))
        alive = info and info.get("state") in (
            ALIVE, "RESTARTING", "PENDING_CREATION"
        )
        requeue = []
        for spec in replay:
            if spec["num_returns"] == "streaming":
                # never replay a generator: already-consumed items would
                # duplicate into the live stream
                self._complete_task_error(
                    spec, ActorError("actor connection lost mid-stream")
                )
            elif alive:
                spec["seq"] = None  # fresh seq on the new connection
                requeue.append(spec)
            else:
                cause = (info or {}).get("death_cause") or "actor connection lost"
                self._complete_task_error(spec, ActorError(cause))
        if requeue:
            q = self._actor_queues.setdefault(actor_id, [])
            q[:0] = requeue  # ahead of anything not yet sent

    async def _actor_connection(self, actor_id: ActorID) -> rpc.Connection:
        lock = self._actor_conn_locks.setdefault(actor_id, asyncio.Lock())
        async with lock:
            return await self._actor_connection_locked(actor_id)

    async def _actor_connection_locked(self, actor_id: ActorID) -> rpc.Connection:
        conn = self._actor_conns.get(actor_id)
        if conn is not None and not conn._closed:
            return conn
        info = self._actor_info.get(actor_id)
        deadline = time.monotonic() + self.cfg.worker_start_timeout_s
        stale_hits = 0
        while True:
            while True:
                if info is not None:
                    if info.get("state") == DEAD:
                        raise ActorError(info.get("death_cause") or "actor is dead")
                    if info.get("state") == ALIVE and info.get("address"):
                        break
                if time.monotonic() > deadline:
                    raise ActorError(f"actor {actor_id} not available in time")
                if actor_id not in self._subscribed_actors:
                    self._subscribed_actors.add(actor_id)
                    await self.gcs.call("subscribe", {"channel": f"actor:{actor_id.hex()}"})
                info = await self._refresh_actor(actor_id)
                if not (info and info.get("state") == ALIVE and info.get("address")):
                    await asyncio.sleep(0.05)
                    info = self._actor_info.get(actor_id)
            try:
                conn = await rpc.connect(*info["address"], timeout=1.0)
                break
            except rpc.ConnectionLost:
                # GCS can briefly advertise ALIVE at the old address after a
                # hard crash (reaper period lag); treat as stale and keep
                # waiting for the restarted actor to publish a reachable
                # address.
                if time.monotonic() > deadline:
                    raise ActorError(f"actor {actor_id} not reachable in time")
                # backoff: the restarted actor needs GCS registration +
                # bind time, and every caller of this actor retries here
                stale_hits += 1
                await asyncio.sleep(min(1.0, 0.1 * (2 ** (stale_hits - 1)))
                                    * (0.5 + random.random()))
                self._actor_info.pop(actor_id, None)
                info = None
        self._actor_conns[actor_id] = conn
        if actor_id not in self._subscribed_actors:
            # death subscription for every actor we talk to: the wait loop
            # above only subscribes when the first info lookup missed, but
            # fast eviction (actor-death listeners) needs the DEAD push
            # even for actors that resolved ALIVE immediately
            self._subscribed_actors.add(actor_id)
            try:
                await self.gcs.call(
                    "subscribe", {"channel": f"actor:{actor_id.hex()}"})
            except (rpc.RpcError, OSError):
                self._subscribed_actors.discard(actor_id)  # retry next connect
        if self.cfg.fastpath_enabled and self.store is not None:
            self._bg.spawn(self._fast_actor_attach(actor_id, conn), self.loop)
            if self._tunnel_ok():
                # remote actor (or tunnel_force): bind a tunnel lane —
                # the attach itself checks node identity and no-ops for
                # same-node actors, whose shm ring lane wins
                self._bg.spawn(self._tunnel_actor_attach(actor_id, conn),
                               self.loop)
        return conn

    async def _refresh_actor(self, actor_id: ActorID):
        info = await self.gcs.call("get_actor", {"actor_id": actor_id})
        if info is not None:
            self._actor_info[actor_id] = info
        return info

    def cancel_task(self, ref: ObjectRef, force: bool = False):
        """Cancel a task (ref: ray.cancel, core_worker CancelTask):
        best-effort — the caller's pending refs fail with
        TaskCancelledError immediately (even if the task is dependency-
        blocked), a queued task never dispatches, and with force=True an
        executing task's worker is killed."""
        task_id = ref.id.task_id()
        if task_id.is_actor_task():
            # matches the documented contract (api.cancel): actor tasks run
            # to completion; half-cancelling the caller's ref would discard
            # a result whose side effects still happen.
            raise ValueError("actor tasks cannot be cancelled")
        self._cancelled_tasks.add(task_id)
        self._run_sync(self._cancel_async(task_id, force))

    def _fail_task_returns_cancelled(self, task_id: TaskID):
        i = 0
        while True:  # returns are dense indices; stop at the first miss
            oid = ObjectID.for_task_return(task_id, i)
            entry = self.memory_store.get(oid)
            if entry is None:
                break
            if entry.error is None and not entry.ready.is_set():
                entry.error = TaskCancelledError(str(task_id))
                entry.ready.set()
            i += 1

    async def _cancel_async(self, task_id: TaskID, force: bool):
        # the caller must not hang on a dep-blocked or in-flight task:
        # fail its return entries now (best-effort semantics — a task that
        # still completes keeps its stored result, but gets raise the
        # cancellation)
        self._fail_task_returns_cancelled(task_id)
        # drain it from any pending queue
        for state in self.sched_keys.values():
            kept = []
            while not state.pending.empty():
                spec = state.pending.get_nowait()
                if spec["task_id"] == task_id:
                    self._complete_task_error(
                        spec, TaskCancelledError(str(task_id))
                    )
                    state.inflight_tasks -= 1
                else:
                    kept.append(spec)
            for spec in kept:
                await state.pending.put(spec)
        if force:
            loc = self._task_worker.get(task_id)
            if loc is not None:
                raylet_addr, worker_id, wconn = loc
                # Ask the worker itself to die only if it is STILL running
                # this task — the identity check happens inside the worker
                # process, so a task that completed and a reused worker can
                # never be killed by a stale cancel.
                try:
                    killed = await wconn.call(
                        "cancel_if_current", {"task_id": task_id}, timeout=5)
                    if killed or self._task_worker.get(task_id) != loc:
                        return
                    # worker said "not mine" but the task is still mapped
                    # here: the push may be racing startup — retry once
                    # before escalating to a raylet kill
                    await asyncio.sleep(0.1)
                    killed = await wconn.call(
                        "cancel_if_current", {"task_id": task_id}, timeout=5)
                    if killed or self._task_worker.get(task_id) != loc:
                        return
                except Exception:
                    # worker loop unresponsive/conn dead: raylet fallback
                    log.debug("worker-side cancel failed", exc_info=True)
                # Fallback (worker wedged): kill via raylet, but only if the
                # task is still mapped to that same worker.
                if self._task_worker.get(task_id) != loc:
                    return
                try:
                    conn = (self.raylet
                            if tuple(raylet_addr) == tuple(self.raylet_address)
                            else await rpc.connect(*raylet_addr, timeout=5))
                    try:
                        if self._task_worker.get(task_id) == loc:
                            await conn.call("kill_worker", {"worker_id": worker_id})
                    finally:
                        if conn is not self.raylet:
                            await conn.close()
                except Exception:
                    log.debug("raylet-side cancel kill failed", exc_info=True)

    def kill_actor(self, actor_id: ActorID, no_restart=True):
        self._run_sync(self.gcs.call("kill_actor", {"actor_id": actor_id,
                                                    "no_restart": no_restart}))

    def get_actor_by_name(self, name: str) -> ActorHandle | None:
        info = self._run_sync(self.gcs.call("get_actor", {"name": name}))
        if info is None or info.get("state") == DEAD:
            return None
        self._actor_info[info["actor_id"]] = info
        return ActorHandle(info["actor_id"], core=self,
                           options=_handle_options(info))

    # ------------------------------------------------------ compiled DAGs
    def start_dag_loop(self, handle: ActorHandle, schedule: dict):
        """Kick off an actor's compiled-DAG loop; the RPC reply arrives when
        the loop exits at teardown (ref: compiled_dag_node.py actor loops).
        Returns a concurrent.futures.Future with the loop's summary."""

        async def go():
            conn = await self._actor_connection(handle.actor_id)
            reply = await conn.call("start_dag_loop", {"schedule": schedule},
                                    timeout=None)
            if isinstance(reply, dict) and reply.get("error") is not None:
                raise reply["error"]
            return reply.get("result") if isinstance(reply, dict) else reply

        return asyncio.run_coroutine_threadsafe(go(), self.loop)

    def wait_dag_loop(self, fut, timeout: float | None = None):
        return fut.result(timeout)

    # ------------------------------------------------------------ helpers
    def _store_executor(self):
        """Small private pool for blocking shm-store reads issued FROM the
        core loop. Never the loop's default executor: user code blocks
        api.get calls on that shared pool, and a store read queued behind
        a full set of blocked gets deadlocks the process."""
        ex = self._store_exec
        if ex is None:
            from concurrent.futures import ThreadPoolExecutor

            ex = self._store_exec = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="rt-store-get")
        return ex

    def _run_sync(self, coro, timeout=None):
        if _in_loop(self.loop):
            raise RuntimeError("sync call from loop thread")
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    async def close(self):
        await self.task_events.flush()
        self._closed = True
        if self._store_exec is not None:
            self._store_exec.shutdown(wait=False)
            self._store_exec = None
        with self._fast_flush_cv:  # release the flusher backstop thread
            self._fast_flush_cv.notify_all()
        for lane in list(self._fast_lanes):
            # wake pump+sweeper (the sweeper owns the unmap); unlink the
            # name NOW so daemon threads killed at exit can't leak /dev/shm
            lane.broken = True
            lane.resume_evt.set()
            lane.ring.close(0)
            lane.ring.close(1)
            lane.ring.unlink()
        await self._bg.cancel_all()
        if self._tunnels is not None:
            try:
                await self._tunnels.close()
            except Exception:
                log.debug("tunnel close failed", exc_info=True)
        # return all leases
        for key, state in self.sched_keys.items():
            for w in state.workers:
                try:
                    if w.conn:
                        await w.conn.close()
                    conn = await rpc.connect(*w.raylet_address, timeout=2)
                    await conn.call("return_lease", {"lease_id": w.lease_id})
                    await conn.close()
                except (rpc.RpcError, OSError):
                    pass  # node already down: nothing to return
        for conn in self._actor_conns.values():
            await conn.close()
        for conn in self._owner_conns.values():
            try:
                await conn.close()
            except (rpc.RpcError, OSError):
                pass  # already dead: close is best-effort
        await self.server.stop()
        if self.gcs:
            await self.gcs.close()
        if self.raylet:
            await self.raylet.close()
        if self.store:
            self.store.close()


def _pack_bytes(meta, buffers, size) -> bytes:
    out = bytearray(size)
    serialization.pack_into(meta, buffers, memoryview(out))
    return bytes(out)


def _in_loop(loop) -> bool:
    try:
        return asyncio.get_running_loop() is loop
    except RuntimeError:
        return False


async def _wait_event(event: asyncio.Event, timeout: float | None):
    if timeout is None:
        await event.wait()
    else:
        try:
            await asyncio.wait_for(event.wait(), timeout)
        except asyncio.TimeoutError:
            pass
