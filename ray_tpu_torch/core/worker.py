"""Worker process: executes tasks and hosts actors.

Equivalent of the reference's worker side: task receiver + execution
callback (ref: src/ray/core_worker/transport/task_receiver.h:50,
python/ray/_raylet.pyx:1731 execute_task, worker.py:955 main_loop).

Threading model: the asyncio loop owns all sockets and stays responsive
(serving owner-object requests, accepting new pushes) while user code runs
on executor threads — sync tasks/actors on a single-thread executor
(per-caller FIFO preserved: one connection per caller x in-order dispatch x
one execution thread), async actors directly on the loop, actors with
max_concurrency > 1 on a wider pool (ref: concurrency groups,
concurrency_group_manager.cc).

Executing a task also runs a full CoreClient, so tasks can submit nested
tasks, put objects, and get borrowed refs — same as the reference where
every worker embeds a CoreWorker.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import logging
import os
import sys
import time
import traceback

try:
    import cloudpickle
except ImportError:  # pragma: no cover
    import pickle as cloudpickle

from ray_tpu_torch.config import get_config
from ray_tpu_torch.core.core_client import CoreClient, _pack_bytes
from ray_tpu_torch.core.ref import ObjectRef, TaskError
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.utils import metrics, rpc, serialization
from ray_tpu_torch.utils.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID

log = logging.getLogger(__name__)

_current_worker = None  # set by Worker.start(): runtime_context introspection
_profiler = None  # RT_WORKER_PROFILE_DIR cProfile, dumped on exit_worker


class Worker:
    def __init__(self):
        self.cfg = get_config()
        self.worker_id = WorkerID.from_hex(os.environ["RT_WORKER_ID"])
        self.raylet_address = (
            os.environ["RT_RAYLET_HOST"],
            int(os.environ["RT_RAYLET_PORT"]),
        )
        self.gcs_address = (os.environ["RT_GCS_HOST"], int(os.environ["RT_GCS_PORT"]))
        self.node_id = NodeID.from_hex(os.environ["RT_NODE_ID"])
        self.core: CoreClient | None = None
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rt-exec"
        )
        self._func_cache: dict[bytes, object] = {}
        # actor state (a worker hosts at most one actor, like the reference)
        self.actor_instance = None
        self.actor_id: ActorID | None = None
        # keyed by the live Connection object (cleaned on disconnect): an
        # id()-keyed map could collide after CPython address reuse
        self._seq_gates: dict[object, dict] = {}
        self._exit_requested = False
        # normal-task ids currently executing, for exact-identity force
        # cancellation (cancel_if_current) — never holds actor task ids
        self._current_tasks: set = set()
        # actor concurrency groups (populated by rpc_create_actor)
        self._method_groups: dict = {}
        self._group_execs: dict = {}
        self._group_sems: dict = {}
        # fast-path rings attached by drivers (see core/fastpath.py)
        self._fast_rings: list = []
        # node-tunnel lanes attached through the raylet (core/tunnel.py):
        # lane id -> state dict; records arrive as rpc_tunnel_records
        # frames and replies coalesce back per loop tick
        self._tunnel_lanes: dict[int, dict] = {}
        self._tunnel_tasks: set = set()  # strong holds on dispatched execs
        # cached connections to drivers for result-ring spill (rpc_fast_result)
        self._spill_conns: dict[tuple, object] = {}
        # one-task-per-worker guard for NORMAL tasks: ring-pump inline
        # execution and RPC-path executor runs must never run two tasks
        # at once on this one-CPU lease (the driver's quiet-lane worker
        # preference is best-effort, not an exclusion). Uncontended in
        # the pure-ring and pure-RPC steady states.
        import threading as _threading

        self._exec_mutex = _threading.Lock()
        # actor-lane W_TASK sampling counter (see _fast_actor_exec_batch)
        self._rec_wt_n = 0
        # wire tracing (utils/tracing.py): cached like the driver's
        # _trace_on — gates the per-record UNSAMPLED suppression (head
        # sampling is per request: an untraced record under tracing-on
        # means the submitter decided unsampled, so nested .remote()
        # calls from its user code must not re-draw a fresh root)
        self._trace_on = bool(self.cfg.tracing_enabled)

    async def start(self):
        # No device set-up here: the worker imports torch only when a task
        # needs it, after _apply_accel_env has set CUDA_VISIBLE_DEVICES.
        # Flight recorder: shm-file-backed under the session tree so the
        # raylet can dump our last-N stage events into the death report
        # after a SIGKILL (no RT_SESSION -> manually spawned: stay
        # anonymous/in-memory).
        from ray_tpu_torch.utils import recorder as _recorder

        if self.cfg.recorder_enabled:
            session = os.environ.get("RT_SESSION")
            _recorder.init_process_recorder(
                _recorder.worker_recorder_path(
                    self.cfg.temp_dir, session, self.worker_id.hex())
                if session else None)
        # register on the CANONICAL module: under `python -m` this file
        # also exists as `__main__`, and runtime_context imports
        # ray_tpu_torch.core.worker — the two must agree
        import ray_tpu_torch.core.worker as _canonical

        _canonical._current_worker = self
        self.core = CoreClient(loop=asyncio.get_running_loop())
        # adopt the raylet-assigned identity: runtime_context.worker_id and
        # the raylet's spawn bookkeeping (log files, chip grants, kills)
        # must name the same worker
        self.core.worker_id = self.worker_id
        # the worker's own server doubles as the task receiver
        self.core.server.add_routes(self)
        self.core.server.on_disconnect = lambda conn: self._seq_gates.pop(conn, None)
        await self.core.connect(self.gcs_address, self.raylet_address)
        # user code in tasks (ray_tpu_torch.get/put/remote, actor handles) must hit
        # THIS core, not bootstrap a fresh cluster (ref: worker.py global_worker)
        from ray_tpu_torch.core import api

        api._core = self.core
        raylet = self.core.raylet
        await raylet.call(
            "worker_ready",
            {"worker_id": self.worker_id.hex(), "address": self.core.address, "pid": os.getpid()},
        )
        # if the raylet connection drops, the node is gone: exit
        asyncio.get_running_loop().create_task(self._watch_raylet())

    async def _watch_raylet(self):
        while True:
            await asyncio.sleep(1.0)
            if self.core.raylet._closed:
                os._exit(0)

    # ------------------------------------------------------------ execution
    def _apply_accel_env(self, gpu_ids):
        """Apply the lease's card assignment (CUDA_VISIBLE_DEVICES) before
        any user code can initialize CUDA (ref: worker-side accelerator env
        setup, _private/worker.py set_visible_accelerator_ids path). The
        assignment rides in on the first task/actor push or ring attach —
        pinned workers are single-assignment (the raylet terminates them at
        lease return), so first-write wins."""
        if not gpu_ids or getattr(self, "_accel_env_applied", False):
            return
        self._accel_env_applied = True
        from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

        GPUAcceleratorManager.set_current_process_visible_accelerator_ids(gpu_ids)

    async def _apply_runtime_env(self, desc):
        """Materialize the task's runtime env before user code runs (ref:
        runtime_env agent role; packages come from the GCS KV). Workers are
        single-env: the first successfully applied env wins for the process
        lifetime (the reference starts dedicated workers per env); a
        failed application is retried by the next task."""
        if not desc:
            return
        if not hasattr(self, "_runtime_env_lock"):
            self._runtime_env_lock = asyncio.Lock()
        async with self._runtime_env_lock:  # concurrent tasks gate here
            if getattr(self, "_runtime_env_applied", False):
                return
            import os as _os
            import tempfile as _tempfile

            from ray_tpu_torch.runtime_env import apply_runtime_env

            cache = _os.path.join(_tempfile.gettempdir(), "ray_tpu_torch", "runtime_envs")
            blobs = {}
            digests = ([] if not desc.get("working_dir") else [desc["working_dir"]])
            digests += list(desc.get("py_modules", []))
            from ray_tpu_torch.runtime_env import plugin_blob_keys

            for d in digests:
                # node-local content-addressed cache first: warm workers on
                # this node skip the package transfer entirely
                if _os.path.exists(_os.path.join(cache, d + ".done")):
                    continue
                blobs[d] = await self.core.gcs.call(
                    "kv_get", {"ns": "runtime_env_packages", "key": d}
                )
            for key in plugin_blob_keys(desc):
                blobs[key] = await self.core.gcs.call(
                    "kv_get", {"ns": "runtime_env_packages", "key": key}
                )
            # off-loop: plugin applies can run pip installs for minutes,
            # and the loop must keep answering pushes and health checks
            await asyncio.get_running_loop().run_in_executor(
                None, apply_runtime_env, desc, lambda k: blobs.get(k))
            self._runtime_env_applied = True  # only after success
            # nested submissions from this worker inherit the env
            self.core.default_runtime_env = desc

    async def _load_function(self, func_id: bytes):
        fn = self._func_cache.get(func_id)
        if fn is not None:
            return fn
        for _ in range(100):  # registration is async on the owner: retry briefly
            blob = await self.core.gcs.call("kv_get", {"ns": "funcs", "key": func_id.hex()})
            if blob is not None:
                fn = cloudpickle.loads(blob)
                self._func_cache[func_id] = fn
                return fn
            await asyncio.sleep(0.05)
        raise TaskError(f"function {func_id.hex()} never appeared in the GCS table")

    async def _fetch_args(self, packed_args):
        out = []
        ref_slots: list[int] = []
        refs: list[ObjectRef] = []
        for a in packed_args:
            tag = a[0]
            if tag == "p":  # plain value
                out.append(a[1])
            elif tag == "v":  # inlined serialized value
                out.append(serialization.unpack(a[1]))
            elif tag == "r":  # ref descriptor: fetch (batched below)
                oid = ObjectID(a[1])
                ref_slots.append(len(out))
                refs.append(ObjectRef(oid, tuple(a[2]) if a[2] else None))
                out.append(None)
            else:
                raise TaskError(f"bad arg tag {tag!r}")
        if refs:
            # one batched get over every ref arg: location priming and
            # the raylet pull coalesce across the whole set (one
            # pull_objects round trip for a multi-arg fetch) instead of
            # one directory lookup + pull RPC per argument
            vals = await self.core.get_async(refs, None)
            for slot, v in zip(ref_slots, vals):
                out[slot] = v
        return out

    async def _store_results(self, task_id, num_returns, values) -> list[dict]:
        if num_returns == 1:
            values = (values,)
        elif num_returns == 0:
            values = ()
        else:
            values = tuple(values)
            if len(values) != num_returns:
                raise TaskError(
                    f"task declared num_returns={num_returns} but returned {len(values)}"
                )
        results = []
        for v in values:
            if inspect.isgenerator(v) or inspect.isasyncgen(v):
                raise TaskError(
                    "task returned a generator; declare it with "
                    "num_returns='streaming' to stream its items"
                )
        for i, v in enumerate(values):
            oid = ObjectID.for_task_return(task_id, i)
            meta, buffers = serialization.dumps_with_buffers(v)
            size = serialization.total_size(meta, buffers)
            if size <= self.cfg.max_inline_object_size:
                results.append({"inline": _pack_bytes(meta, buffers, size)})
            else:
                await self._store_shm_object(oid, meta, buffers)
                # (node, size) primes the owner's location cache at
                # completion time: steady-state get() skips the GCS
                # object-directory lookup entirely
                results.append({"shm": True, "size": size,
                                "node": self.node_id.binary()})
        return results

    async def rpc_cancel_if_current(self, conn, p):
        """Die iff the named task is still executing here. The check runs in
        this process, so a stale force-cancel can never kill a worker that
        finished the task and was reused (ref: CancelTask force_kill)."""
        if p["task_id"] in self._current_tasks:
            loop = asyncio.get_running_loop()
            loop.call_soon(os._exit, 1)  # reply first, then die
            return True
        return False

    # ------------------------------------------------ fast path (shm rings)
    async def rpc_attach_fast_ring(self, conn, p):
        """Driver attaches a shm task ring (see core/fastpath.py). The pump
        thread lives until the ring closes (driver teardown or our exit).
        kind="actor" rings carry actor method calls: the SPSC order IS the
        caller's FIFO *dispatch* order. Sync methods on a strictly serial
        actor execute inline on the pump (zero thread handoffs); async
        methods, threaded actors (max_concurrency > 1) and concurrency-
        group methods are DISPATCHED in ring order to the event loop /
        the right pool and reply as each finishes — out-of-order
        completions, matched driver-side by the per-call seq (1.8).

        The reply ships the actor's init-time method eligibility table so
        the driver routes generator/unknown methods to the RPC path per
        call without a ring round trip."""
        import threading

        from ray_tpu_torch.core import fastpath

        # a task lane's records carry no spec: the lease's cards come here
        self._apply_accel_env(p.get("gpu_ids"))
        ring = fastpath.RingPair.open(p["name"])
        # the driver's server address: spill target for completion records
        # the result ring cannot absorb (see _fast_spill_replies)
        ring._owner_addr = tuple(p["owner"]) if p.get("owner") else None
        self._fast_rings.append(ring)
        loop = asyncio.get_running_loop()
        if p.get("kind") == "actor":
            table = getattr(self, "_actor_method_table", None)
            # Dispatch-only lanes: whenever two of this actor's methods
            # could legitimately block on each other across threads
            # (thread pool, loop-resident async methods, group pools),
            # inline pump execution could deadlock a rendezvous — every
            # record is dispatched instead, the pump never executes user
            # code. A pure-sync serial actor keeps the zero-handoff
            # inline pump (the measured 1_1_actor_calls_sync win).
            dispatch_only = (
                getattr(self, "_actor_max_concurrency", 1) > 1
                or bool(self._group_execs)
                or any(v[0] == "async" for v in (table or {}).values()))
            # Two-mode pump (inline lanes). HOT: a self-resubmitting job
            # on the actor's single executor thread
            # (_fast_actor_pump_cycle) — ring records execute inline with
            # ZERO thread handoffs (each cross-thread wake costs 60-200us
            # on this class of host, which was most of the sync-call
            # round trip), RPC-path jobs interleave between cycles.
            # PARKED: after ~100ms of silence the cycle chain exits and a
            # dedicated thread blocks on the ring with long timeouts, so
            # an idle actor costs nothing on the executor; the first
            # batch of a new busy period runs via one executor handoff,
            # then the chain goes hot again. Dispatch-only lanes skip the
            # hot chain entirely: the park thread pops and dispatches.
            state = {"downgraded": False, "idle": 0,
                     "parked": threading.Event(),
                     "dispatch_only": dispatch_only}
            t = threading.Thread(
                target=self._fast_actor_park, args=(ring, state),
                name="rt-fastpark", daemon=True)
            t.start()
            return {"ok": True, "methods": table}
        t = threading.Thread(
            target=self._fast_pump, args=(ring, loop),
            name="rt-fastpump", daemon=True)
        t.start()
        return True

    def _fast_push_replies(self, ring, replies) -> int:
        """Deliver completion records with the submit lane's partial-push /
        RPC-spill semantics, mirrored in the opposite direction: push as
        many whole records as currently fit in one native batch call,
        retry the remainder briefly, and once the result ring has stayed
        full past the spill deadline hand the undelivered records to the
        driver over RPC (rpc_fast_result) — a stalled driver must not
        wedge the pump (and with it task execution) behind a full ring.
        Chunked at ~512KB so one frame can never exceed the ring capacity
        or the driver's fixed pop buffer. Returns 0 once every record is
        delivered (ring or spill), or a negative ring status when the
        ring is closed/unusable (the driver's break-lane recovery owns
        whatever did not land)."""
        from ray_tpu_torch.core import fastpath

        spill_s = max(1, self.cfg.fastpath_reply_spill_ms) / 1000.0
        idx = 0
        n = len(replies)
        while idx < n:
            chunk_end = idx
            chunk_bytes = 0
            while chunk_end < n and (chunk_end == idx
                                     or chunk_bytes + len(replies[chunk_end])
                                     <= 512 * 1024):
                chunk_bytes += len(replies[chunk_end])
                chunk_end += 1
            framed = fastpath.frame(replies[idx:chunk_end])
            off = 0
            deadline = time.monotonic() + spill_s
            while off < len(framed):
                took = ring.push_batch(
                    fastpath.REP, framed[off:] if off else framed,
                    timeout_ms=20)
                if took < 0:
                    return took
                off += took
                if off < len(framed) and time.monotonic() >= deadline:
                    # whole records already in the ring stay there; spill
                    # everything after the consumed prefix
                    consumed = idx
                    acc = 0
                    for r in replies[idx:chunk_end]:
                        acc += (4 + len(r) + 7) & ~7
                        if acc > off:
                            break
                        consumed += 1
                    return self._fast_spill_replies(ring, replies[consumed:])
            idx = chunk_end
        return 0

    def _fast_spill_replies(self, ring, recs) -> int:
        """Result-ring-full spill: ship undelivered completion records to
        the driver over the RPC path (the slow road stays the backstop in
        BOTH directions). Falls back to a blocking ring push when no
        spill address is known or the driver is unreachable — in the
        latter case the driver is gone and its break-lane recovery (or
        teardown) owns the records."""
        from ray_tpu_torch.core import fastpath

        owner = getattr(ring, "_owner_addr", None)
        if owner is not None:
            try:
                fut = asyncio.run_coroutine_threadsafe(
                    self._send_spilled_results(owner, list(recs)),
                    self.core.loop)
                fut.result(30)  # raylint: disable=RT020 -- ring-full spill backstop: the pump MUST backpressure here
                return 0
            except Exception:
                # ambiguous failure (e.g. timeout with the RPC still in
                # flight): the ring re-push below may duplicate records —
                # safe, the driver applies completions exactly once
                log.debug("result spill over RPC failed", exc_info=True)
        # blocking fallback, chunked so one frame can never exceed the
        # ring capacity (kTooBig would tear down the whole lane)
        chunk: list = []
        chunk_bytes = 0
        for rec in recs:
            if chunk and chunk_bytes + len(rec) > 512 * 1024:
                status = ring.push_raw(fastpath.REP, fastpath.frame(chunk))
                if status != 0:
                    return status
                chunk, chunk_bytes = [], 0
            chunk.append(rec)
            chunk_bytes += len(rec)
        if chunk:
            return ring.push_raw(fastpath.REP, fastpath.frame(chunk))
        return 0

    async def _send_spilled_results(self, owner: tuple, recs: list):
        conn = self._spill_conns.get(owner)
        if conn is None or conn._closed:
            conn = await rpc.connect(*owner, timeout=10)
            self._spill_conns[owner] = conn
        await conn.call("fast_result", {"records": recs}, timeout=20)

    # hot-mode tuning: 5ms pop slices, ~20 empty slices (~100ms) to park
    _PUMP_HOT_POP_MS = 5
    _PUMP_IDLE_CYCLES = 20

    def _fast_actor_park(self, ring, state: dict):
        """Parked-mode keeper thread: blocks on the ring with LONG
        timeouts (costless while idle), and on traffic executes the first
        batch via the executor (one handoff) then hands consumption to
        the executor-resident hot cycle until it idles out again."""
        from ray_tpu_torch.core import fastpath

        try:
            while not self._exit_requested:
                recs = ring.pop_batch(fastpath.SUB, timeout_ms=1000)
                if recs is None:
                    self._fast_pump_close(ring)
                    return
                if not recs:
                    continue
                if state.get("dispatch_only"):
                    # async/threaded/grouped actor: this thread pops and
                    # dispatches in ring order, never executes user code
                    # (replies stream back as each dispatched call ends)
                    if not self._fast_actor_exec_batch(ring, state, recs):
                        self._fast_pump_close(ring)
                        return
                    continue
                state["idle"] = 0
                state["parked"].clear()
                try:
                    self.executor.submit(
                        self._fast_actor_pump_batch, ring, state, recs)
                except RuntimeError:  # executor shut down
                    self._fast_pump_close(ring)
                    return
                # the hot chain owns the ring until it parks again
                while not (state["parked"].wait(1.0)
                           or self._exit_requested):
                    pass
                if state.get("closed"):
                    return
        except BaseException:
            self._fast_pump_close(ring)
            raise

    def _fast_actor_pump_batch(self, ring, state: dict, recs):
        """First batch of a busy period (on the executor thread), then
        chain into the hot cycle. Any escape hatch closes the ring and
        wakes the keeper — an exception parked in the unchecked executor
        Future would otherwise leave the keeper waiting forever while the
        driver blocks on replies that never come."""
        try:
            if self._fast_actor_exec_batch(ring, state, recs):
                self._fast_actor_pump_cycle(ring, state)
                return
        except BaseException:  # noqa: BLE001 — never leave the ring open
            self._fast_pump_close(ring)
            state["closed"] = True
            state["parked"].set()
            raise
        self._fast_pump_close(ring)  # reply push failed: ring is done
        state["closed"] = True
        state["parked"].set()

    @staticmethod
    def _classify_method(m) -> str:
        """One fast-lane verdict for a callable: sync | async | gen."""
        if inspect.isgeneratorfunction(m) or inspect.isasyncgenfunction(m):
            return "gen"
        if inspect.iscoroutinefunction(m):
            return "async"
        return "sync"

    def _actor_fast_verdict(self, mname: str):
        """(verdict, group) for one method — init-time table hit in the
        steady state (satellite: no per-record getattr + inspect.is*);
        dynamically-added callables classify once on first sight and are
        cached. None = not callable here (NEED_SLOW: the RPC path owns
        the error surface)."""
        table = getattr(self, "_actor_method_table", None)
        if table is None:
            table = self._actor_method_table = {}
        v = table.get(mname)
        if v is not None:
            return v
        inst = self.actor_instance
        m = getattr(inst, mname, None) if inst is not None else None
        if not callable(m):
            return None
        v = table[mname] = (self._classify_method(m),
                            self._method_groups.get(mname))
        return v

    def _build_actor_method_table(self, cls) -> dict:
        """Precompute every public method's fast-lane verdict ONCE at
        actor init: name -> (sync|async|gen, concurrency_group). Walks
        the CLASS (dir covers the MRO) so property getters never fire;
        instance-assigned callables classify lazily via
        _actor_fast_verdict. Shipped to the driver in the
        attach_fast_ring reply (protocol 1.8) so ineligible methods are
        routed to the RPC path per call without a ring round trip."""
        table: dict = {}
        for name in dir(cls):
            if name.startswith("_"):
                continue
            m = getattr(cls, name, None)
            if not callable(m):
                continue
            table[name] = (self._classify_method(m),
                           self._method_groups.get(name))
        return table

    def _fast_actor_exec_batch(self, ring, state: dict, recs) -> bool:
        """One batch of actor ring records, in ring (= per-caller FIFO)
        order; False = ring done. Sync methods on an inline lane execute
        right here (zero handoffs); async / grouped / threaded-actor
        methods are handed to the event loop IN ORDER and reply as each
        finishes — dispatch stays the FIFO invariant, completion does
        not (the reply's seq lets the driver match them out of order)."""
        from ray_tpu_torch.core import fastpath
        from ray_tpu_torch.utils import recorder as _rec

        inline_max = self.cfg.fastpath_inline_result_max
        inst = self.actor_instance
        rec_r = _rec.get_recorder()
        loop = self.core.loop
        t_prev = t_pop = time.perf_counter_ns()
        if rec_r is not None:
            rec_r.record(b"", _rec.WORKER_POP, t_pop, a0=len(recs))
        replies = []
        dispatch_items = []
        for rec in recs:
            tid, mkey, args, kwargs, t_sub, seq, trc = \
                fastpath.unpack_actor_task(rec)
            stream = mkey[:3] == b"gm:"  # stream-called generator (2.3)
            mname = mkey[3:].decode()  # b"am:<method>" / b"gm:<method>"
            verdict = None if state["downgraded"] or inst is None \
                else self._actor_fast_verdict(mname)
            if verdict is None or (verdict[0] == "gen") is not stream:
                # Sticky for the in-flight tail: replies stream back in
                # ring order from here, the driver requeues them over RPC
                # in FIFO order and retires the lane. Reaching this means
                # the driver's copy of the eligibility table missed the
                # method (added after attach) — the ordinary tables keep
                # generators off the ring entirely (and stream submits
                # ON it: a "gm:" record whose method is no longer a
                # generator downgrades the same way).
                state["downgraded"] = True
                replies.append(fastpath.pack_reply(
                    tid, fastpath.NEED_SLOW, b"", seq=seq))
                t_prev = time.perf_counter_ns()  # skipped record: don't
                # bill its handling to the next record's deserialize
                continue
            if stream:
                # generator drive always lives on the loop: chunks flush
                # through _fast_reply_one as the method yields, beside
                # any async batch-mates (per-stream chunk seq keeps the
                # driver's ordering; lane FIFO only covers dispatch)
                dispatch_items.append((tid, mname, "gen", verdict[1],
                                       args, kwargs, t_sub, t_pop, seq,
                                       trc))
                t_prev = time.perf_counter_ns()
                continue
            kind, group = verdict
            if (kind == "async" or group
                    or state.get("dispatch_only")):
                # out-of-order completion lane: collected in ring order,
                # handed to the loop in ONE wake per batch below; each
                # coroutine replies when its call ends
                dispatch_items.append((tid, mname, kind, group, args,
                                       kwargs, t_sub, t_pop, seq, trc))
                t_prev = time.perf_counter_ns()
                continue
            t_x0 = time.perf_counter_ns()
            try:
                if chaos.ENABLED:
                    chaos.point("worker.exec", name=mname, fast=1)
                m = getattr(inst, mname)
                if self._trace_on:  # sampled: exec span; else suppress
                    with self._fast_exec_span(trc, tid, mname, "ring"):
                        ok, val = True, m(*args, **kwargs)
                else:
                    ok, val = True, m(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — reply on
                ok, val = False, e
            t_x1 = time.perf_counter_ns()
            ring_ns = t_pop - t_sub if t_sub else 0
            deser_ns = t_x0 - t_prev
            exec_ns = t_x1 - t_x0
            t_prev = t_x1
            replies.append(self._fast_pack_result(
                tid, ok, val, inline_max,
                fastpath.pack_stamp(ring_ns, deser_ns, exec_ns)
                if t_sub else b"", seq=seq, trace=trc))
            if rec_r is not None:
                # same 1-in-16 W_TASK sampling as the normal pump (the
                # counter lives on self: batches don't reset it)
                self._rec_wt_n += 1
                if not (self._rec_wt_n & 15):
                    rec_r.record_wtask(
                        tid, t_x1, min(max(ring_ns, 0), 0xFFFFFFFF),
                        min(deser_ns, 0xFFFFFFFF), exec_ns)
        if dispatch_items:
            # ONE self-pipe wake for the whole batch (a wake per record
            # measured as the difference between parity and a 2x win on
            # pipelined async bursts); create_task order inside the
            # callback preserves ring order = dispatch FIFO
            try:
                loop.call_soon_threadsafe(
                    self._fast_dispatch_records, ring, dispatch_items)
            except RuntimeError:
                return False  # loop gone (worker exit): ring is done
        if not replies:
            return True  # pure-dispatch batch: nothing to push from here
        ok_push = self._fast_push_replies(ring, replies) == 0
        if rec_r is not None:
            rec_r.record(b"", _rec.COMPLETION_PUSH, a0=len(replies))
        return ok_push

    def _fast_dispatch_records(self, ring, items):
        """Loop-side fan-out of one dispatched batch, in ring order. The
        tasks are strongly held until done — the loop only keeps weak
        refs, and a GC'd pending task would eat its reply and wedge the
        driver's inflight accounting."""
        loop = asyncio.get_running_loop()
        pending = getattr(self, "_fast_dispatch_pending", None)
        if pending is None:
            pending = self._fast_dispatch_pending = set()
        for it in items:
            t = loop.create_task(self._fast_exec_dispatched(ring, *it))
            pending.add(t)
            t.add_done_callback(pending.discard)

    async def _fast_exec_dispatched(self, ring, tid, mname, kind, group,
                                    args, kwargs, t_sub, t_pop, seq,
                                    trc=b"", transport="ring"):
        """Loop-side execution of one dispatched actor ring record: async
        methods run on the loop (group semaphore honored), sync methods
        of threaded/grouped actors on the right pool — exactly where the
        RPC path runs them — then the reply pushes as THIS call
        finishes, out of order with its batch-mates."""
        from ray_tpu_torch.core import fastpath

        if kind == "gen":  # stream-called generator ("gm:" record, 2.3)
            await self._fast_exec_stream(ring, tid, mname, group, args,
                                         kwargs, t_sub, t_pop, seq, trc,
                                         transport)
            return
        inst = self.actor_instance
        span = (self._fast_exec_span(trc, tid, mname, transport)
                if self._trace_on else None)
        t_x0 = time.perf_counter_ns()
        try:
            if chaos.ENABLED:
                chaos.point("worker.exec", name=mname, fast=1)
            m = getattr(inst, mname)
            if group and group not in self._group_execs:
                # loud, exactly like the RPC path (rpc_push_actor_task):
                # silently running on the default pool would lose the
                # isolation the group asked for
                raise TaskError(
                    f"concurrency group {group!r} not declared on this "
                    f"actor (declared: {sorted(self._group_execs)})")
            if span is not None:
                span.__enter__()  # CM protocol inline: the exit must
                # run before the reply packs, exceptions included
            if kind == "async":
                sem = self._group_sems.get(group) if group else None
                if sem is not None:
                    async with sem:  # group-bounded async slots
                        val = await m(*args, **kwargs)
                else:
                    val = await m(*args, **kwargs)
            else:
                executor = (self._group_execs[group] if group
                            else self.executor)
                if span is not None:
                    # run_in_executor does NOT copy contextvars (unlike
                    # asyncio.to_thread): carry the span context — or
                    # the UNSAMPLED suppression — into the pool thread
                    # so nested .remote() calls from a threaded/grouped
                    # sync method chain (or stay suppressed) correctly
                    import contextvars as _cv

                    cctx = _cv.copy_context()
                    val = await asyncio.get_running_loop().run_in_executor(
                        executor, lambda: cctx.run(m, *args, **kwargs))
                else:
                    val = await asyncio.get_running_loop().run_in_executor(
                        executor, lambda: m(*args, **kwargs))
            ok = True
            if span is not None:
                span.__exit__(None, None, None)
        except BaseException as e:  # noqa: BLE001 — reply on
            ok, val = False, e
            if span is not None and span._token is not None:
                span.__exit__(type(e), e, None)
        t_x1 = time.perf_counter_ns()
        if t_sub:
            # the dispatch hop (pump -> loop/pool) rides the deserialize
            # stage; exec covers the await, so concurrent async calls
            # overlap inside it — per-call wall, not CPU
            stamp = fastpath.pack_stamp(
                t_pop - t_sub, max(0, t_x0 - t_pop), t_x1 - t_x0)
        else:
            stamp = b""
        rep = self._fast_pack_result(
            tid, ok, val, self.cfg.fastpath_inline_result_max, stamp,
            seq=seq, node=getattr(ring, "_desc_node", None), trace=trc)
        await self._fast_reply_one(ring, rep)

    async def _fast_reply_one(self, ring, rec: bytes) -> bool:
        """Completion push for one out-of-order reply, loop-side (the
        ring mutex makes the pump thread + loop concurrent producers
        safe). Mirrors _fast_push_replies' semantics without blocking
        the loop: non-blocking pushes with short async backoffs, then
        the RPC spill once the result ring has stayed full past the
        spill deadline. Returns False when the ring is CLOSED (the
        driver broke the lane — its recovery owns whatever did not
        land); stream pumps use that to stop flushing chunks to a
        consumer that is gone."""
        from ray_tpu_torch.core import fastpath

        framed = fastpath.frame_one(rec)
        loop = asyncio.get_running_loop()
        deadline = (loop.time()
                    + max(1, self.cfg.fastpath_reply_spill_ms) / 1000.0)
        while True:
            took = ring.push_batch(fastpath.REP, framed, 0)
            if took < 0:
                return False  # ring closed (driver recovery owns it)
            if took >= len(framed):
                return True  # delivered
            if loop.time() >= deadline:
                owner = getattr(ring, "_owner_addr", None)
                if owner is not None:
                    try:
                        await self._send_spilled_results(owner, [rec])
                        return True
                    except Exception:
                        # driver unreachable over RPC too: keep nudging
                        # the ring until it closes (break-lane recovery)
                        log.debug("ooo result spill failed", exc_info=True)
                deadline = loop.time() + 0.1
            await asyncio.sleep(0.002)

    async def _fast_reply_burst(self, ring, recs) -> bool:
        """Push a burst of stream chunk records in ONE ring lock round
        and at most one consumer wake (rt_ring_push_batch takes whole
        records) — on a small host the per-push wake syscalls alone cost
        a context switch each. Whatever does not fit immediately falls
        back to the per-record spill-backed push."""
        from ray_tpu_torch.core import fastpath

        if len(recs) == 1:
            return await self._fast_reply_one(ring, recs[0])
        framed = [fastpath.frame_one(r) for r in recs]
        buf = b"".join(framed)
        took = ring.push_batch(fastpath.REP, buf, 0)
        if took < 0:
            return False  # ring closed (driver recovery owns it)
        if took >= len(buf):
            return True
        i, off = 0, 0  # took lands on a whole-record boundary
        while off < took:
            off += len(framed[i])
            i += 1
        for rec in recs[i:]:
            if not await self._fast_reply_one(ring, rec):
                return False
        return True

    async def _fast_exec_stream(self, ring, tid, mname, group, args,
                                kwargs, t_sub, t_pop, seq, trc=b"",
                                transport="ring"):
        """Drive one stream-called generator method ("gm:" record, wire
        2.3): one "G" chunk record per yielded item through
        :meth:`_fast_reply_one` (ring or tunnel sink — the same
        spill-backed push out-of-order replies use), then ONE ordinary
        terminal reply (OK + chunk count, or ERR) on the lane's seq
        machinery. Async generators run on the loop; sync generators
        pull each item on the actor's executor/group pool (where the
        RPC path would run them). The drive stops early when the
        driver abandons the stream (rpc_stream_abandon — client
        disconnect) or the ring closes under us; either way the user
        generator is closed so GeneratorExit reaches its finally (the
        cancellation surface: an LLM stream's finally frees its decode
        slot)."""
        from ray_tpu_torch.core import fastpath

        inst = self.actor_instance
        inline_max = self.cfg.fastpath_inline_result_max
        node = getattr(ring, "_desc_node", None)
        aborts = getattr(self, "_fast_stream_aborts", None)
        if aborts is None:
            aborts = self._fast_stream_aborts = set()
        span = (self._fast_exec_span(trc, tid, mname, transport)
                if self._trace_on else None)
        loop = asyncio.get_running_loop()
        t_x0 = time.perf_counter_ns()
        nchunks = 0
        agen = it = None
        pending = None  # in-flight agen.__anext__ carried between bursts
        ok, err = True, None
        try:
            if chaos.ENABLED:
                chaos.point("worker.exec", name=mname, fast=1, stream=1)
            m = getattr(inst, mname)
            if group and group not in self._group_execs:
                raise TaskError(
                    f"concurrency group {group!r} not declared on this "
                    f"actor (declared: {sorted(self._group_execs)})")
            if span is not None:
                span.__enter__()
            executor = (self._group_execs[group] if group
                        else self.executor)
            if inspect.isasyncgenfunction(m):
                agen = m(*args, **kwargs)
            else:
                gen = await loop.run_in_executor(
                    executor, lambda: m(*args, **kwargs))
                if hasattr(gen, "__anext__"):
                    agen = gen  # method returned an async generator
                else:
                    it = iter(gen)
            _end = object()

            def _pull_batch(nmax=64, budget_s=5e-4):
                # amortize the executor round-trip (~hundreds of µs of
                # thread wakeups) over every item a fast sync generator
                # has ready: keep pulling until the time budget or nmax.
                # A slow generator exits after ONE item (its next() alone
                # blows the budget), so per-chunk latency is unchanged
                # where it matters and throughput-bound streams stop
                # paying a threadpool hop per chunk. A mid-batch user
                # exception is DEFERRED, never raised here: the already-
                # pulled prefix must flush as chunks before the error
                # becomes the stream's terminal.
                out = []
                err = None
                t0 = time.perf_counter()
                try:
                    while len(out) < nmax:
                        out.append(next(it))
                        if time.perf_counter() - t0 >= budget_s:
                            break
                except StopIteration:
                    out.append(_end)
                except BaseException as e:  # noqa: BLE001 — deferred
                    err = e
                return out, err

            async def _drive(coro, f):
                # finish a partially-stepped __anext__ coroutine in THIS
                # task — context continuity: the generator body may hold
                # contextvar tokens (serve's deadline), so every step
                # must run under one Context, which rules out wrapping
                # the coroutine in a fresh Task
                while True:
                    if f is not None and hasattr(
                            f, "_asyncio_future_blocking"):
                        f._asyncio_future_blocking = False
                        try:
                            await f
                        except BaseException:  # raylint: disable=RT012 — not a swallow: the frame re-raises from f.result() at the next send
                            pass
                    else:
                        await asyncio.sleep(0)
                    try:
                        f = coro.send(None)
                    except StopIteration as si:
                        return si.value

            done = False
            defer_err = None  # user error held until its prefix flushes
            while not done:
                if tid in aborts:
                    break  # consumer is gone: close the generator below
                if agen is not None:
                    items = []
                    if pending is not None:
                        coro, f = pending
                        pending = None
                        try:
                            items.append(await _drive(coro, f))
                        except StopAsyncIteration:
                            done = True
                        except BaseException as e:  # noqa: BLE001
                            defer_err = e
                            done = True
                    # greedy ready-drain: step __anext__ synchronously —
                    # a producer with items buffered (the serve replica
                    # wrapper's pool batch, a decode block) yields each
                    # without suspending, so the whole backlog lands in
                    # ONE burst (one ring push + one consumer wake)
                    # instead of a push per item
                    while not done and len(items) < 64:
                        coro = agen.__anext__()
                        try:
                            f = coro.send(None)
                        except StopIteration as si:
                            items.append(si.value)
                            continue
                        except StopAsyncIteration:
                            done = True
                            break
                        except BaseException as e:  # noqa: BLE001
                            defer_err = e
                            done = True
                            break
                        # producer suspended: flush what is ready now;
                        # the parked step resumes after the burst lands
                        if items:
                            pending = (coro, f)
                        else:
                            try:
                                items.append(await _drive(coro, f))
                            except StopAsyncIteration:
                                done = True
                            except BaseException as e:  # noqa: BLE001
                                defer_err = e
                                done = True
                        break
                else:
                    items, defer_err = await loop.run_in_executor(
                        executor, _pull_batch)
                    if defer_err is not None:
                        done = True
                burst = []
                for item in items:
                    if item is _end:
                        done = True
                        break
                    burst.append(self._fast_pack_chunk(
                        tid, item, inline_max, nchunks, node, trc))
                    nchunks += 1
                if burst and not await self._fast_reply_burst(ring, burst):
                    return  # ring closed: recovery owns it
            if defer_err is not None:
                raise defer_err
            if span is not None:
                span.__exit__(None, None, None)
        except BaseException as e:  # noqa: BLE001 — reply on
            ok, err = False, e
            if span is not None and span._token is not None:
                span.__exit__(type(e), e, None)
        finally:
            aborts.discard(tid)
            if agen is not None:
                if pending is not None:
                    # a parked __anext__ is mid-flight inside the
                    # generator: close the step (GeneratorExit reaches
                    # the body's finally) or aclose would see it
                    # "already running"
                    try:
                        pending[0].close()
                    except BaseException:  # raylint: disable=RT012 — cleanup: aclose below reports the real failure
                        pass
                try:
                    await agen.aclose()
                except BaseException:  # noqa: BLE001 — cleanup only
                    log.debug("stream aclose failed", exc_info=True)
            elif it is not None:
                try:
                    await loop.run_in_executor(None, it.close)
                except BaseException:  # noqa: BLE001 — cleanup only
                    log.debug("stream close failed", exc_info=True)
        t_x1 = time.perf_counter_ns()
        stamp = (fastpath.pack_stamp(t_pop - t_sub, max(0, t_x0 - t_pop),
                                     t_x1 - t_x0) if t_sub else b"")
        if ok:
            rep = fastpath.pack_reply(tid, fastpath.OK,
                                      fastpath.pack_stream_fin(nchunks),
                                      stamp, seq, trc)
        else:
            rep = fastpath.pack_reply(tid, fastpath.ERR,
                                      self._fast_pack_error(err), stamp,
                                      seq, trc)
        await self._fast_reply_one(ring, rep)

    def _fast_pack_chunk(self, tid: bytes, item, inline_max: int,
                         chunk_seq: int, node: bytes | None,
                         trc: bytes = b"") -> bytes:
        """Pack one yielded item as a "G" chunk record: inline when it
        fits, else sealed into the node arena under return index
        chunk_seq + 1 (index 0 stays the terminal reply's) and shipped
        as a shm size/desc — exactly the OK_SHM economics, per chunk.
        An unpackable item raises, which ends the stream with a terminal
        ERR — loud at the consumer, never a silent skip."""
        from ray_tpu_torch.core import fastpath

        t_ns = time.perf_counter_ns()
        try:
            meta, buffers = serialization.dumps_with_buffers(item)
            size = serialization.total_size(meta, buffers)
            payload = _pack_bytes(meta, buffers, size)
            if size <= inline_max:
                return fastpath.pack_chunk(tid, fastpath.CHUNK, payload,
                                           chunk_seq, t_ns, trc)
            oid = ObjectID.for_task_return(TaskID(tid), chunk_seq + 1)
            if not self.core.store.contains(oid):
                self.core.store.put_raw(oid, payload)
            return fastpath.pack_chunk(
                tid, fastpath.CHUNK_SHM,
                fastpath.pack_shm_desc(size, node) if node is not None
                else fastpath.pack_shm_size(size),
                chunk_seq, t_ns, trc)
        except Exception as e:
            raise TaskError(f"unpackable stream item: {e!r}") from e

    async def rpc_stream_abandon(self, conn, p):
        """Driver-side consumer of an open stream went away (client
        disconnect, sink aclose): stop flushing its chunks and close
        the user generator at the next yield point. Best-effort notify
        — an id that never arrives just means the stream runs to its
        natural end against a closed ring."""
        aborts = getattr(self, "_fast_stream_aborts", None)
        if aborts is None:
            aborts = self._fast_stream_aborts = set()
        for tid in p.get("task_ids", ()):
            aborts.add(bytes(tid))
        return True

    # -------------------------------------------- node tunnel (core/tunnel.py)
    async def rpc_tunnel_attach(self, conn, p):
        """The local raylet binds one tunnel lane onto this worker on
        behalf of a remote driver (protocol 2.0). Records arrive as
        ``tunnel_records`` frames — the SAME packed records the shm
        rings carry — and replies coalesce back per loop tick through a
        :class:`_TunnelSink`. Actor lanes ship the method eligibility
        table exactly like ``attach_fast_ring`` does."""
        lane = int(p["lane"])
        if p.get("kind", "task") == "task":
            # a task lane's records carry no spec: ask the raylet for the
            # lease's cards (the cross-node twin of attach_fast_ring's)
            env = await self.core.raylet.call(
                "get_lease_env", {"worker_id": self.worker_id.hex()})
            self._apply_accel_env((env or {}).get("gpu_ids"))
        st = {"lane": lane, "kind": p.get("kind", "task"), "conn": conn,
              "downgraded": False, "reply_buf": [], "reply_armed": False,
              "closed": False}
        st["sink"] = _TunnelSink(self, st)
        if st["kind"] == "actor":
            # same verdict as attach_fast_ring: a pure-sync serial actor
            # executes whole record batches INLINE on its executor thread
            # (one handoff per batch, not two per call); async/threaded/
            # grouped actors dispatch per record and reply out of order
            table = getattr(self, "_actor_method_table", None)
            st["dispatch_only"] = (
                getattr(self, "_actor_max_concurrency", 1) > 1
                or bool(self._group_execs)
                or any(v[0] == "async" for v in (table or {}).values()))
            self._tunnel_lanes[lane] = st
            return {"ok": True, "methods": table}
        self._tunnel_lanes[lane] = st
        return {"ok": True}

    async def rpc_tunnel_detach(self, conn, p):
        for lane in p.get("lanes", ()):
            st = self._tunnel_lanes.pop(lane, None)
            if st is not None:
                st["closed"] = True
        return True

    async def rpc_tunnel_records(self, conn, p):
        """One tunnel frame's records for this worker (notify). Records
        are dispatched in frame order — dispatch order IS the caller's
        FIFO invariant, completion order is not (each call replies as it
        finishes, seq-matched driver-side like ring completions).

        Batch execution mirrors the ring pump's economics: a pure-sync
        serial actor's batch (and any task-record batch) runs in ONE
        executor hop and replies as one coalesced frame — per-record
        thread handoffs were most of the tunnel's worker-side cost.
        Records that need the loop (async/grouped methods, descriptor
        args) dispatch per record instead."""
        from ray_tpu_torch.core import fastpath

        loop = asyncio.get_running_loop()
        t_pop = time.perf_counter_ns()
        for lane, recs_b in p["frames"]:
            st = self._tunnel_lanes.get(lane)
            if st is None:
                continue
            st["conn"] = conn  # reply on the conn the records rode in on
            recs = fastpath.unframe(recs_b)
            if st["kind"] == "task":
                try:
                    self.executor.submit(self._tunnel_exec_task_batch,
                                         st, recs, t_pop)
                except RuntimeError:
                    return  # executor shut down (worker exit)
                continue
            if not st.get("dispatch_only") and not st["downgraded"]:
                chain = st.get("seq_chain")
                if chain is not None and chain.done():
                    chain = st["seq_chain"] = None
                if chain is None \
                        and not any(self._rec_has_desc(r) for r in recs):
                    try:
                        self.executor.submit(self._tunnel_exec_batch_sync,
                                             st, recs, t_pop)
                    except RuntimeError:
                        return
                else:
                    # descriptor args force the loop's batched pull; a
                    # serial actor's records still run strictly in
                    # order — and so must every LATER frame while the
                    # chain drains (a plain batch hopping straight to
                    # the executor would overtake a record awaiting its
                    # pull), so frames append to the chain until it
                    # empties
                    t = loop.create_task(
                        self._tunnel_exec_seq(st, chain, recs, t_pop))
                    st["seq_chain"] = t
                    self._tunnel_tasks.add(t)
                    t.add_done_callback(self._tunnel_tasks.discard)
                continue
            for rec in recs:
                t = loop.create_task(self._tunnel_exec_one(st, rec, t_pop))
                self._tunnel_tasks.add(t)
                t.add_done_callback(self._tunnel_tasks.discard)

    async def _tunnel_exec_seq(self, st, prev, recs, t_pop: int):
        """Sequential batch leg for a SERIAL actor's records when some
        carry descriptors: each record completes before the next
        dispatches (and after the previous chained frame), preserving
        the per-caller FIFO the serial executor would otherwise
        provide."""
        if prev is not None:
            try:
                await asyncio.shield(prev)
            except Exception:
                # the prior frame already replied its own errors; this
                # await exists only for ordering
                log.debug("chained tunnel frame failed", exc_info=True)
        for rec in recs:
            await self._tunnel_exec_one(st, rec, t_pop)

    @staticmethod
    def _tunnel_t_sub(t_sub: int, t_pop: int) -> int:
        """Cross-host stamp guard: tunnel records may carry a submit
        stamp from a DIFFERENT host's CLOCK_MONOTONIC base. When the
        delta is implausible (>5 min) the stamp drops so stage samples
        degrade to exec-only truth instead of clamped garbage;
        same-host tunnels (one-host multi-raylet, in-process clusters)
        keep exact stamps."""
        return (t_sub if t_sub and abs(t_pop - t_sub) < 300_000_000_000
                else 0)

    @staticmethod
    def _rec_has_desc(rec: bytes) -> bool:
        """Cheap pre-check: only serialization.pack records ("C") can
        carry TunnelArgRef descriptors — C-pickled "A" bodies are simple
        immutables by construction."""
        return rec[:1] == b"C" and b"TunnelArgRef" in rec

    def _tunnel_exec_batch_sync(self, st, recs, t_pop: int):
        """One tunnel batch of a pure-sync serial actor, ON the actor's
        executor thread (the ring pump's inline shape: zero per-call
        handoffs, state affinity identical to the RPC path). Replies
        push as ONE coalesced frame."""
        from ray_tpu_torch.core import fastpath

        inline_max = self.cfg.fastpath_inline_result_max
        inst = self.actor_instance
        node = self.node_id.binary()
        replies = []
        t_prev = time.perf_counter_ns()
        for rec in recs:
            tid, mkey, args, kwargs, t_sub, seq, trc = \
                fastpath.unpack_actor_task(rec)
            t_sub = self._tunnel_t_sub(t_sub, t_pop)
            mname = mkey[3:].decode()
            verdict = None if st["downgraded"] or inst is None \
                else self._actor_fast_verdict(mname)
            if (mkey[:3] == b"gm:" and verdict is not None
                    and verdict[0] == "gen"):
                # stream call mixed into a sync serial batch: the
                # generator drive lives on the loop (chunks flush as it
                # yields) — stream calls are unordered by contract, so
                # hopping out of the serial batch is safe
                try:
                    asyncio.run_coroutine_threadsafe(
                        self._tunnel_exec_record_on_loop(st, rec, t_pop),
                        self.core.loop)
                except RuntimeError:
                    return  # loop gone (worker exit)
                t_prev = time.perf_counter_ns()
                continue
            if verdict is None or verdict[0] != "sync" or verdict[1]:
                st["downgraded"] = True
                replies.append(fastpath.pack_reply(
                    tid, fastpath.NEED_SLOW, b"", seq=seq))
                t_prev = time.perf_counter_ns()
                continue
            t_x0 = time.perf_counter_ns()
            try:
                if chaos.ENABLED:
                    chaos.point("worker.exec", name=mname, fast=1)
                m = getattr(inst, mname)
                if self._trace_on:  # sampled: exec span; else suppress
                    with self._fast_exec_span(trc, tid, mname, "tunnel"):
                        ok, val = True, m(*args, **(kwargs or {}))
                else:
                    ok, val = True, m(*args, **(kwargs or {}))
            except BaseException as e:  # noqa: BLE001 — reply on
                ok, val = False, e
            t_x1 = time.perf_counter_ns()
            stamp = (fastpath.pack_stamp(max(0, t_pop - t_sub),
                                         max(0, t_x0 - t_prev),
                                         t_x1 - t_x0)
                     if t_sub else b"")
            t_prev = t_x1
            replies.append(self._fast_pack_result(
                tid, ok, val, inline_max, stamp, seq=seq, node=node,
                trace=trc))
        if replies:
            st["sink"].push_batch(fastpath.REP, fastpath.frame(replies))

    def _tunnel_exec_task_batch(self, st, recs, t_pop: int):
        """One tunnel batch of plain task records, ON the task executor
        thread (records with descriptor args bounce to the loop path for
        their async batched pull). Functions resolve through a local
        cache; a miss bridges to the loop like the ring pump's loader."""
        from ray_tpu_torch.core import fastpath

        inline_max = self.cfg.fastpath_inline_result_max
        node = self.node_id.binary()
        cache = getattr(self, "_tunnel_funcs", None)
        if cache is None:
            cache = self._tunnel_funcs = {}
        loop = self.core.loop
        replies = []
        t_prev = t_pop  # rolling: each record's deser starts where the
        #                 previous one ended, not at the frame pop (the
        #                 ring pump's accounting — billing the whole
        #                 batch's earlier exec to later records' deser
        #                 would inflate deser p99 ~N-fold under burst)
        for rec in recs:
            if self._rec_has_desc(rec):
                # descriptor args need the loop's batched pull
                try:
                    asyncio.run_coroutine_threadsafe(
                        self._tunnel_exec_record_on_loop(st, rec, t_pop),
                        loop)
                except RuntimeError:
                    return
                t_prev = time.perf_counter_ns()
                continue
            tid, func_id, args, kwargs, t_sub, trc = \
                fastpath.unpack_task(rec)
            t_sub = self._tunnel_t_sub(t_sub, t_pop)
            fn = cache.get(func_id)
            if fn is None:
                try:
                    fut = asyncio.run_coroutine_threadsafe(
                        self._load_function(func_id), loop)
                    # function-cache miss: first call per func_id
                    # only, amortized to zero
                    fn = fut.result(15)  # raylint: disable=RT020 -- cache miss
                    cache[func_id] = fn  # only successes cache: a
                    # transient load failure must not downgrade the
                    # function to the RPC path for this worker's lifetime
                except Exception:
                    fn = None
            if (fn is None or inspect.iscoroutinefunction(fn)
                    or inspect.isgeneratorfunction(fn)
                    or inspect.isasyncgenfunction(fn)):
                replies.append(fastpath.pack_reply(
                    tid, fastpath.NEED_SLOW, b""))
                t_prev = time.perf_counter_ns()
                continue
            t_x0 = time.perf_counter_ns()
            try:
                with self._exec_mutex:
                    if chaos.ENABLED:
                        chaos.point("worker.exec",
                                    name=getattr(fn, "__name__", "task"),
                                    fast=1)
                    if self._trace_on:  # sampled: span; else suppress
                        with self._fast_exec_span(
                                trc, tid, getattr(fn, "__name__", "task"),
                                "tunnel"):
                            ok, val = True, fn(*args, **(kwargs or {}))
                    else:
                        ok, val = True, fn(*args, **(kwargs or {}))
            except BaseException as e:  # noqa: BLE001 — reply on
                ok, val = False, e
            t_x1 = time.perf_counter_ns()
            stamp = (fastpath.pack_stamp(max(0, t_pop - t_sub),
                                         max(0, t_x0 - t_prev),
                                         t_x1 - t_x0)
                     if t_sub else b"")
            t_prev = t_x1
            replies.append(self._fast_pack_result(
                tid, ok, val, inline_max, stamp, node=node, trace=trc))
        if replies:
            st["sink"].push_batch(fastpath.REP, fastpath.frame(replies))

    async def _tunnel_exec_record_on_loop(self, st, rec: bytes,
                                          t_pop: int):
        """Loop-side hand-off for a task record the executor batch could
        not run inline (descriptor args)."""
        t = asyncio.get_running_loop().create_task(
            self._tunnel_exec_one(st, rec, t_pop))
        self._tunnel_tasks.add(t)
        t.add_done_callback(self._tunnel_tasks.discard)

    async def _resolve_tunnel_descs(self, args, kwargs):
        """Adopt TunnelArgRef descriptors (oversized args the sender
        sealed into ITS shm arena): ONE batched pull_objects round trip
        through the local raylet for the whole set, then the values read
        out of local shm. The sender pins the sealed copies until this
        call's reply lands, so the pull can't race the free."""
        from ray_tpu_torch.core import fastpath

        descs = [a for a in args if isinstance(a, fastpath.TunnelArgRef)]
        if kwargs:
            descs += [v for v in kwargs.values()
                      if isinstance(v, fastpath.TunnelArgRef)]
        if not descs:
            return args, kwargs
        hints = {}
        for d in descs:
            hints.setdefault(ObjectID(d.oid), set()).add(d.node)
        await self.core.pull_objects_batch(hints)
        refs = {d.oid: ObjectRef(ObjectID(d.oid), d.owner) for d in descs}
        order = list(refs)
        vals = await self.core.get_async([refs[o] for o in order], None)
        got = dict(zip(order, vals))
        args = tuple(got[a.oid] if isinstance(a, fastpath.TunnelArgRef)
                     else a for a in args)
        if kwargs:
            kwargs = {k: got[v.oid]
                      if isinstance(v, fastpath.TunnelArgRef) else v
                      for k, v in kwargs.items()}
        return args, kwargs

    async def _tunnel_exec_one(self, st, rec: bytes, t_pop: int):
        """Execute one tunnel record and push its reply through the
        lane's sink. Actor records ride the exact dispatch path ring
        records do (_fast_exec_dispatched: async methods on the loop,
        sync methods on the actor's executor/group pool); task records
        execute on the task executor under the one-task mutex."""
        from ray_tpu_torch.core import fastpath

        sink = st["sink"]
        if st["kind"] == "actor":
            tid, mkey, args, kwargs, t_sub, seq, trc = \
                fastpath.unpack_actor_task(rec)
            t_sub = self._tunnel_t_sub(t_sub, t_pop)
            stream = mkey[:3] == b"gm:"  # stream-called generator (2.3)
            mname = mkey[3:].decode()
            verdict = None
            if not st["downgraded"] and self.actor_instance is not None:
                verdict = self._actor_fast_verdict(mname)
            if verdict is None or (verdict[0] == "gen") is not stream:
                # sticky, like the ring pump: executing later records
                # while an earlier one replays over RPC would reorder
                # the caller's calls
                st["downgraded"] = True
                await self._fast_reply_one(sink, fastpath.pack_reply(
                    tid, fastpath.NEED_SLOW, b"", seq=seq))
                return
            try:
                args, kwargs = await self._resolve_tunnel_descs(args, kwargs)
            except Exception as e:
                await self._fast_reply_one(sink, fastpath.pack_reply(
                    tid, fastpath.ERR, self._fast_pack_error(e), seq=seq))
                return
            await self._fast_exec_dispatched(
                sink, tid, mname, "gen" if stream else verdict[0],
                verdict[1], args, kwargs, t_sub, t_pop, seq, trc,
                "tunnel")
            return
        # plain task record ("Q"/"R"/"P"/"S")
        tid, func_id, args, kwargs, t_sub, trc = fastpath.unpack_task(rec)
        t_sub = self._tunnel_t_sub(t_sub, t_pop)
        try:
            fn = await self._load_function(func_id)
        except Exception:
            fn = None
        if (fn is None or inspect.iscoroutinefunction(fn)
                or inspect.isgeneratorfunction(fn)
                or inspect.isasyncgenfunction(fn)):
            # not fast-executable here: the driver resubmits over RPC
            # with the full budget (NEED_SLOW is a migration, not a loss)
            await self._fast_reply_one(sink, fastpath.pack_reply(
                tid, fastpath.NEED_SLOW, b""))
            return
        try:
            args, kwargs = await self._resolve_tunnel_descs(args, kwargs)
        except Exception as e:
            await self._fast_reply_one(sink, fastpath.pack_reply(
                tid, fastpath.ERR, self._fast_pack_error(e)))
            return

        def run():
            # one-task-per-worker, same as the ring pump's inline exec
            with self._exec_mutex:
                if chaos.ENABLED:
                    chaos.point("worker.exec",
                                name=getattr(fn, "__name__", "task"),
                                fast=1)
                if self._trace_on:  # sampled: span; else suppress
                    with self._fast_exec_span(
                            trc, tid, getattr(fn, "__name__", "task"),
                            "tunnel"):
                        return fn(*args, **(kwargs or {}))
                return fn(*args, **(kwargs or {}))

        t_x0 = time.perf_counter_ns()
        try:
            val = await self.core.loop.run_in_executor(self.executor, run)
            ok = True
        except BaseException as e:  # noqa: BLE001 — reply on
            ok, val = False, e
        t_x1 = time.perf_counter_ns()
        stamp = (fastpath.pack_stamp(max(0, t_pop - t_sub),
                                     max(0, t_x0 - t_pop), t_x1 - t_x0)
                 if t_sub else b"")
        rep = self._fast_pack_result(
            tid, ok, val, self.cfg.fastpath_inline_result_max, stamp,
            node=self.node_id.binary(), trace=trc)
        await self._fast_reply_one(sink, rep)

    def _fast_actor_pump_cycle(self, ring, state: dict):
        """ONE pump cycle, ON the actor's single executor thread: pop a
        batch (short blocking wait — a record arriving mid-wait wakes
        immediately), execute the methods INLINE (we ARE the actor
        thread, so state affinity is identical to the RPC path and no
        cross-thread handoff is paid), reply, then resubmit this cycle to
        the executor so queued RPC-path jobs get the thread between
        cycles (their added latency is bounded by the pop timeout).

        Once ANY record proves ineligible, every subsequent record is
        NEED_SLOWed too (sticky downgrade): executing later ring records
        while an earlier one replays over RPC would reorder the caller's
        calls — replies stream back in ring order, so the driver requeues
        the whole tail in FIFO order (and then retires the lane, closing
        this ring, which ends the cycling)."""
        from ray_tpu_torch.core import fastpath

        try:
            if self._exit_requested:
                self._fast_pump_close(ring)
                state["closed"] = True
                state["parked"].set()
                return
            recs = ring.pop_batch(fastpath.SUB,
                                  timeout_ms=self._PUMP_HOT_POP_MS)
            if recs is None:
                self._fast_pump_close(ring)  # driver closed/retired
                state["closed"] = True
                state["parked"].set()
                return
            if recs:
                state["idle"] = 0
                if not self._fast_actor_exec_batch(ring, state, recs):
                    self._fast_pump_close(ring)
                    state["closed"] = True
                    state["parked"].set()
                    return
            else:
                state["idle"] += 1
                if state["idle"] >= self._PUMP_IDLE_CYCLES:
                    state["parked"].set()  # hand back to the keeper thread
                    return
            self.executor.submit(self._fast_actor_pump_cycle, ring, state)
        except RuntimeError:
            # executor shut down mid-resubmit (worker exit)
            self._fast_pump_close(ring)
            state["closed"] = True
            state["parked"].set()
        except BaseException:  # noqa: BLE001 — never leave the ring open
            self._fast_pump_close(ring)
            state["closed"] = True
            state["parked"].set()
            raise

    def _fast_pump_close(self, ring):
        for i, r in enumerate(self._fast_rings):
            if r is ring:
                del self._fast_rings[i]
                break
        ring.close_pair()

    def _fast_pump(self, ring, loop):
        """Pump thread: pop task records, execute, reply in one framed
        push. No asyncio, no sockets — see fastpath.py.

        Normal tasks execute INLINE on this thread rather than hopping to
        the task executor: on a single-core host each thread handoff
        measured ~100us — more than the task itself. Normal tasks are
        stateless by contract (only actors own thread-affine state), so
        thread identity is not observable; execution stays one-at-a-time
        per worker because this worker's fast records all flow through
        this one pump."""
        from ray_tpu_torch.core import fastpath

        # completion records inline results up to the fast-lane threshold
        # (not max_inline_object_size): above it the value is sealed into
        # shm ONCE and every read is zero-copy, instead of being copied
        # through the ring and unpacked from a bytes round-trip
        inline_max = self.cfg.fastpath_inline_result_max
        fast_funcs: dict[bytes, object] = {}
        from ray_tpu_torch.utils import recorder as _rec

        rec_r = _rec.get_recorder()  # None when the recorder is disabled
        # hot-path locals: per-record attribute walks add up at ring rate
        import struct as _struct

        clock = time.perf_counter_ns
        stamp_pack = fastpath._STAMP.pack  # raw; clamp fallback below
        pack_stamp = fastpath.pack_stamp
        wt_n = 0  # W_TASK shm slots are taken every 16th task (Dapper
        #           sampling: the per-batch POP/PUSH events plus sampled
        #           task slots keep postmortems representative at a
        #           sixteenth of the write cost)

        def load(func_id):
            fn = fast_funcs.get(func_id)
            if fn is not None:
                return fn
            try:
                fut = asyncio.run_coroutine_threadsafe(
                    self._load_function(func_id), loop)
                fn = fut.result(15)  # raylint: disable=RT020 -- cache miss: once per func_id, amortized
            except Exception:
                fast_funcs[func_id] = False
                return False
            if (not callable(fn)
                    or inspect.iscoroutinefunction(fn)
                    or inspect.isgeneratorfunction(fn)
                    or inspect.isasyncgenfunction(fn)):
                fn = False  # needs the RPC path (streaming/async machinery)
            fast_funcs[func_id] = fn
            return fn

        try:
            while not self._exit_requested:
                recs = ring.pop_batch(fastpath.SUB, timeout_ms=1000)
                if recs is None:
                    break  # ring closed by the driver
                if not recs:
                    continue
                replies = []
                bad_record = False
                closed = False
                contended = False
                # per-pop batch timestamps: t_prev advances past each
                # record so deser_i never charges a batch-mate's exec
                t_pop = t_prev = clock()
                if rec_r is not None:
                    rec_r.record(b"", _rec.WORKER_POP, t_pop, a0=len(recs))
                while True:
                    for rec in recs:
                        try:
                            tid, func_id, args, kwargs, t_sub, trc = (
                                fastpath.unpack_task(rec))
                        except Exception:
                            # undecodable record: without its task id there
                            # is nothing to reply to. Flush the replies of
                            # the batch-mates that ALREADY executed, then
                            # close the ring so the driver recovers only
                            # the rest — otherwise completed side effects
                            # would re-run.
                            bad_record = True
                            break
                        fn = load(func_id)
                        if not fn:
                            replies.append(fastpath.pack_reply(
                                tid, fastpath.NEED_SLOW, b""))
                            t_prev = clock()  # don't bill the (possibly
                            # 15s) function fetch to the next record's
                            # deserialize stage
                            continue
                        # _exec_mutex: an RPC-path normal task may be on the
                        # executor thread right now (the driver's quiet-lane
                        # preference is not an exclusion). Bounded acquire,
                        # NOT a blocking one: the RPC task may itself be
                        # waiting on THIS ring record (nested get on a ref
                        # buried in a container arg) — on contention reply
                        # NEED_SLOW so the driver reroutes to a free worker
                        # instead of deadlocking the lease.
                        if not self._exec_mutex.acquire(timeout=0.05):
                            contended = True
                            replies.append(fastpath.pack_reply(
                                tid, fastpath.NEED_SLOW, b""))
                            t_prev = clock()  # the 50ms acquire timeout
                            # must not surface as a phantom deserialize
                            # spike on the next record's stamp
                            continue
                        t_x0 = clock()
                        try:
                            if chaos.ENABLED:
                                # "worker.exec", fast-lane flavor: error
                                # rides the reply as this task's failure;
                                # kill dies holding buffered completions
                                chaos.point(
                                    "worker.exec", fast=1,
                                    name=getattr(fn, "__name__", "task"))
                            if self._trace_on:  # (2.1) sampled: child
                                # exec span; unsampled: suppression —
                                # both keep the contextvar right for
                                # nested .remote() from user code
                                with self._fast_exec_span(
                                        trc, tid,
                                        getattr(fn, "__name__", "task"),
                                        "ring"):
                                    ok, val = True, fn(*args, **kwargs)
                            else:
                                ok, val = True, fn(*args, **kwargs)
                        except BaseException as e:  # noqa: BLE001 — reply on
                            ok, val = False, e
                        finally:
                            self._exec_mutex.release()
                        t_x1 = clock()
                        ring_ns = t_pop - t_sub if t_sub else 0
                        deser_ns = t_x0 - t_prev
                        exec_ns = t_x1 - t_x0
                        t_prev = t_x1
                        if t_sub:
                            try:  # zero-cost try; clamp only on anomaly
                                stamp = stamp_pack(ring_ns, deser_ns,
                                                   exec_ns)
                            except _struct.error:
                                stamp = pack_stamp(ring_ns, deser_ns,
                                                   exec_ns)
                        else:
                            stamp = b""
                        replies.append(self._fast_pack_result(
                            tid, ok, val, inline_max, stamp, trace=trc))
                        if rec_r is not None:
                            wt_n += 1
                            if not (wt_n & 15):
                                rec_r.record_wtask(
                                    tid, t_x1,
                                    min(max(ring_ns, 0), 0xFFFFFFFF),
                                    min(deser_ns, 0xFFFFFFFF), exec_ns)
                    # Reply-drain coalescing: records that arrived while
                    # this batch executed join the SAME reply frame — a
                    # pipelined burst costs the driver one reply wake per
                    # merged batch, not per pop. Bounded so the first
                    # caller's results are never held hostage to a
                    # never-empty ring; and NEVER merged past a mutex-
                    # contention NEED_SLOW — the occupant may be blocked
                    # on the driver rerouting exactly these records, and
                    # each further merged record would burn another 50ms
                    # acquire timeout before the reroute signal ships.
                    if bad_record or contended or len(replies) >= 64:
                        break
                    if not ring.pending(fastpath.SUB):
                        break
                    more = ring.pop_batch(fastpath.SUB, timeout_ms=0)
                    if more is None:
                        closed = True  # still flush what already executed
                        break
                    if not more:
                        break
                    recs = more
                    t_pop = t_prev = time.perf_counter_ns()
                    if rec_r is not None:
                        rec_r.record(b"", _rec.WORKER_POP, t_pop,
                                     a0=len(recs))
                status = self._fast_push_replies(ring, replies)
                if rec_r is not None:
                    rec_r.record(b"", _rec.COMPLETION_PUSH,
                                 a0=len(replies))
                if bad_record or closed or status != 0:
                    break  # ring closed/undecodable: driver recovers
        finally:
            # on ANY exit — clean close or unexpected error — close the
            # ring so the driver's side breaks the lane and resubmits
            # in-flight tasks instead of waiting forever
            for i, r in enumerate(self._fast_rings):
                if r is ring:
                    del self._fast_rings[i]
                    break
            ring.close_pair()

    # every reply record must fit the driver's fixed pop buffer (1 MB); an
    # oversized record would wedge the ring (pop can never drain it)
    _FAST_ERR_MAX = 256 * 1024

    def _fast_pack_result(self, tid: bytes, ok: bool, val, inline_max: int,
                          stamp: bytes = b"", seq: int | None = None,
                          node: bytes | None = None, trace: bytes = b""):
        from ray_tpu_torch.core import fastpath

        if not ok:
            return fastpath.pack_reply(tid, fastpath.ERR,
                                       self._fast_pack_error(val), stamp,
                                       seq, trace)
        try:
            meta, buffers = serialization.dumps_with_buffers(val)
            size = serialization.total_size(meta, buffers)
            if size <= inline_max:
                return fastpath.pack_reply(
                    tid, fastpath.OK, _pack_bytes(meta, buffers, size),
                    stamp, seq, trace)
            # big result: place it in the node's arena under the return oid
            # (same-node owner reads it directly; location registration is
            # the owner's migration step)
            oid = ObjectID.for_task_return(TaskID(tid), 0)
            payload = _pack_bytes(meta, buffers, size)
            if not self.core.store.contains(oid):  # retry may have stored it
                self.core.store.put_raw(oid, payload)
            # size rides in the record: the owner's location cache is
            # primed at completion time, no directory round-trip on get.
            # Tunnel lanes (cross-node owner) additionally carry the
            # sealing node id — the record IS the location registration
            return fastpath.pack_reply(
                tid, fastpath.OK_SHM,
                fastpath.pack_shm_desc(size, node) if node is not None
                else fastpath.pack_shm_size(size), stamp, seq, trace)
        except Exception as e:
            return fastpath.pack_reply(tid, fastpath.ERR,
                                       self._fast_pack_error(e), stamp,
                                       seq, trace)

    def _fast_pack_error(self, exc) -> bytes:
        payload = cloudpickle.dumps(_as_task_error(exc))
        if len(payload) > self._FAST_ERR_MAX:
            payload = cloudpickle.dumps(TaskError(
                f"{type(exc).__name__} (detail truncated: pickled error "
                f"was {len(payload)} bytes)"))
        return payload

    async def rpc_push_task_multi(self, conn, p):
        """Scatter-push handler: ONE frame carries many (corr_id, payload)
        items; each task gets its own reply frame when it finishes (ref:
        normal_task_submitter.cc PushTask pipelining — the driver amortizes
        frame/pickle/wakeup costs without batching completion).

        Contiguous runs of "simple" tasks — cached sync function, inline
        args, no runtime env / accelerator grant, plain int num_returns —
        execute in ONE executor hop: the thread handoff (~100us each way)
        would otherwise dominate sub-millisecond tasks. Execution stays
        strictly sequential (one lease = one CPU's worth of work).

        Runs on the notification dispatch path (no auto-reply), so EVERY
        item must get a reply here even when the batch machinery itself
        blows up — a stranded correlation id wedges the driver's lease."""
        items = p["items"]
        replied: set = set()
        try:
            await self._push_task_multi_inner(conn, items, replied)
        except Exception as e:
            await self._error_reply_all(conn, items, replied, e)

    async def _push_task_multi_inner(self, conn, items, replied: set):
        i = 0
        loop = asyncio.get_running_loop()
        while i < len(items):
            run = []
            while i < len(items):
                spec = items[i][1]["spec"]
                simple = (
                    isinstance(spec["num_returns"], int)
                    and not spec.get("runtime_env")
                    and not spec.get("gpu_ids")
                    and all(a[0] in ("v", "p") for a in spec["args"])
                    and all(a[0] in ("v", "p") for a in spec["kwargs"].values())
                )
                if simple:
                    fn = self._func_cache.get(spec["func_id"])
                    if fn is None:
                        try:
                            fn = await self._load_function(spec["func_id"])
                        except Exception:
                            fn = None
                    simple = fn is not None and not inspect.iscoroutinefunction(fn)
                if not simple:
                    break
                run.append((items[i][0], spec))
                i += 1
            if run:
                for _, s in run:
                    self._current_tasks.add(s["task_id"])
                    self.core.task_events.emit(
                        task_id=s["task_id"].hex(), name=s.get("name", "task"),
                        state="RUNNING", worker_id=self.worker_id.hex(),
                        node_id=self.node_id.hex(), pid=os.getpid(),
                    )
                t0 = time.monotonic()
                outcomes = await loop.run_in_executor(
                    self.executor, self._exec_simple_run, [s for _, s in run])
                per_task = (time.monotonic() - t0) / len(run)
                out = []
                for (corr, s), (ok, value) in zip(run, outcomes):
                    if ok:
                        try:
                            results = await self._store_results(
                                s["task_id"], s["num_returns"], value)
                            reply = {"results": results}
                            metrics.task_exec_seconds.observe(per_task)
                            state = "FINISHED"
                        except Exception as e:
                            reply = {"error": _as_task_error(e)}
                            state = "FAILED"
                    else:
                        reply = {"error": _as_task_error(value)}
                        state = "FAILED"
                    ev = dict(
                        task_id=s["task_id"].hex(), name=s.get("name", "task"),
                        state=state, worker_id=self.worker_id.hex(),
                        node_id=self.node_id.hex(), pid=os.getpid(),
                    )
                    if state == "FINISHED":
                        ev["duration_s"] = per_task
                    self.core.task_events.emit(**ev)
                    self._current_tasks.discard(s["task_id"])
                    out.append((corr, reply, None))
                    replied.add(corr)
                await conn.respond_multi(out)
                continue
            corr, payload = items[i]
            i += 1
            reply = await self.rpc_push_task(conn, payload)
            replied.add(corr)
            await conn.respond(corr, value=reply)

    async def rpc_push_actor_task_multi(self, conn, p):
        """Scatter-push for actor calls: dispatch every item immediately
        (the per-connection seq gates order execution for sync actors;
        async actors keep their concurrency), reply per item as each
        finishes.

        Contiguous consecutive-seq runs of "simple" calls — sync method on
        a max_concurrency=1 actor, default concurrency group, inline args —
        execute in ONE executor hop, like the normal-task fast path. Only
        when the actor is strictly serial anyway: on a wider pool two sync
        methods may legitimately rendezvous across threads, and batching
        them onto one thread would deadlock that."""
        items = p["items"]
        replied: set = set()
        try:
            await self._push_actor_multi_inner(conn, items, replied)
        except Exception as e:
            await self._error_reply_all(conn, items, replied, e)

    async def _push_actor_multi_inner(self, conn, items, replied: set):
        loop = asyncio.get_running_loop()
        i = 0
        serial_actor = (
            self.actor_instance is not None
            and getattr(self, "_actor_max_concurrency", 1) == 1
            and not self._group_execs
        )
        while i < len(items):
            run = []
            while serial_actor and i < len(items):
                spec = items[i][1]["spec"]
                ok = (
                    isinstance(spec.get("num_returns"), int)
                    and spec.get("seq") is not None
                    and not spec.get("concurrency_group")
                    and not self._method_groups.get(spec.get("method"))
                    and all(a[0] in ("v", "p") for a in spec["args"])
                    and all(a[0] in ("v", "p") for a in spec["kwargs"].values())
                )
                if ok:
                    m = getattr(self.actor_instance, spec["method"], None)
                    ok = (callable(m)
                          and not inspect.iscoroutinefunction(m)
                          and not inspect.isasyncgenfunction(m)
                          and not inspect.isgeneratorfunction(m))
                if ok and run:
                    ok = spec["seq"] == run[-1][1]["spec"]["seq"] + 1
                if not ok:
                    break
                run.append(items[i])
                i += 1
            if len(run) >= 2:
                # Spawn the run instead of awaiting it: a sync method in this
                # run may block until a LATER async method in the same frame
                # acts (legal on a serial actor — async methods run on the
                # loop), so the dispatch loop must keep going while the run
                # occupies the executor thread.
                for corr, _ in run:
                    replied.add(corr)  # the spawned run owns these replies
                loop.create_task(self._exec_actor_simple_run_task(conn, run))
                continue
            if run:
                corr, payload = run[0]
                replied.add(corr)  # _actor_push_respond owns the reply
                loop.create_task(self._actor_push_respond(conn, corr, payload))
                continue
            corr, payload = items[i]
            i += 1
            replied.add(corr)
            loop.create_task(self._actor_push_respond(conn, corr, payload))

    async def _exec_actor_simple_run_task(self, conn, run):
        """Task wrapper for a spawned simple run: replies happen in one
        respond_multi at the end, so on any earlier failure none of the
        items have been answered — answer them all with the error."""
        try:
            await self._exec_actor_simple_run(conn, run, set())
        except Exception as e:
            await self._error_reply_all(conn, run, set(), e)

    async def _error_reply_all(self, conn, items, replied: set, e: Exception):
        """Answer every not-yet-replied item of a multi-push frame with the
        same error; stop on a dead connection (driver handles the loss)."""
        err_reply = {"error": _as_task_error(e)}
        for corr, _ in items:
            if corr in replied:
                continue
            try:
                await conn.respond(corr, value=err_reply)
            except Exception:
                break

    async def _exec_actor_simple_run(self, conn, run, replied: set):
        gate = self._seq_gates.setdefault(conn, {"next": 0, "events": {}})
        s0 = run[0][1]["spec"]["seq"]
        while gate["next"] != s0:
            ev = gate["events"].setdefault(s0, asyncio.Event())
            await ev.wait()
        specs = [payload["spec"] for _, payload in run]
        for s in specs:
            self.core.task_events.emit(
                task_id=s["task_id"].hex(), name=s.get("method", "actor_task"),
                state="RUNNING", worker_id=self.worker_id.hex(),
                node_id=self.node_id.hex(), pid=os.getpid(),
                actor_id=self.actor_id.hex() if self.actor_id else None,
            )
        # open the gate BEFORE executing, exactly like the single-dispatch
        # path releases it after dispatch: later calls (notably async
        # methods, which run on the loop even on a max_concurrency=1 actor)
        # must be able to start while this run occupies the executor thread
        # — a sync method blocking on something an async method will set
        # would otherwise deadlock. Later SYNC calls still serialize behind
        # this run in the single executor thread.
        last = specs[-1]["seq"]
        gate["next"] = last + 1
        ev = gate["events"].pop(last + 1, None)
        if ev is not None:
            ev.set()
        t0 = time.monotonic()
        outcomes = await asyncio.get_running_loop().run_in_executor(
            self.executor, self._exec_actor_run_thread, specs)
        per_task = (time.monotonic() - t0) / len(specs)
        out = []
        for (corr, _), s, (ok, value) in zip(run, specs, outcomes):
            if ok:
                try:
                    results = await self._store_results(
                        s["task_id"], s["num_returns"], value)
                    reply = {"results": results}
                    metrics.task_exec_seconds.observe(per_task)
                    state = "FINISHED"
                except Exception as e:
                    reply = {"error": _as_task_error(e)}
                    state = "FAILED"
            else:
                reply = {"error": _as_task_error(value)}
                state = "FAILED"
            ev = dict(
                task_id=s["task_id"].hex(), name=s.get("method", "actor_task"),
                state=state, worker_id=self.worker_id.hex(),
                node_id=self.node_id.hex(), pid=os.getpid(),
                actor_id=self.actor_id.hex() if self.actor_id else None,
            )
            if state == "FINISHED":
                ev["duration_s"] = per_task
            self.core.task_events.emit(**ev)
            out.append((corr, reply, None))
            replied.add(corr)
        await conn.respond_multi(out)

    def _traced_call(self, spec, fn, args, kwargs):
        """Run a user callable inside a child span when the spec carries a
        trace context (ref: tracing_helper.py:36-60 — child spans around
        execution; the contextvar makes nested .remote() calls chain)."""
        if chaos.ENABLED:
            # "worker.exec", RPC-path flavor: `error` raises here and
            # becomes this task's TaskError; `kill` SIGKILLs the worker
            # mid-task (owner retries); `delay` stretches the execution
            chaos.point("worker.exec",
                        name=spec.get("name") or spec.get("method", "task"))
        tc = spec.get("trace_ctx")
        if not tc:
            if self._trace_on:  # unsampled request: inherit the decision
                with _TraceSuppress():
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        from ray_tpu_torch.utils import tracing

        name = spec.get("name") or spec.get("method", "task")
        with tracing.span(f"{name}::run", tc, self._span_sink(spec),
                          stage="exec", transport="rpc"):
            return fn(*args, **kwargs)

    async def _traced_acall(self, spec, coro_fn, args, kwargs):
        """Async twin of _traced_call for coroutine tasks/actor methods."""
        if chaos.ENABLED:
            chaos.point("worker.exec",
                        name=spec.get("name") or spec.get("method", "task"))
        tc = spec.get("trace_ctx")
        if not tc:
            if self._trace_on:  # unsampled request: inherit the decision
                with _TraceSuppress():
                    return await coro_fn(*args, **kwargs)
            return await coro_fn(*args, **kwargs)
        from ray_tpu_torch.utils import tracing

        name = spec.get("name") or spec.get("method", "task")
        with tracing.span(f"{name}::run", tc, self._span_sink(spec),
                          stage="exec", transport="rpc"):
            return await coro_fn(*args, **kwargs)

    def _span_sink(self, spec):
        def sink(s):
            self.core.task_events.emit(
                task_id=spec["task_id"].hex(), name=s["name"], state="SPAN",
                span=s, worker_id=self.worker_id.hex(),
                node_id=self.node_id.hex(), pid=os.getpid())
        return sink

    def _fast_span_sink(self, tid: bytes):
        """Span sink for fast-lane records (raw task-id bytes instead of
        a spec dict) — built only for SAMPLED records, so the allocation
        never rides the unsampled path."""
        def sink(s):
            self.core.task_events.emit(
                task_id=tid.hex(), name=s["name"], state="SPAN",
                span=s, worker_id=self.worker_id.hex(),
                node_id=self.node_id.hex(), pid=os.getpid())
        return sink

    def _fast_exec_span(self, trc: bytes, tid: bytes, name: str,
                        transport: str):
        """Child span around one sampled fast-lane record's execution:
        the record's wire leg is the parent (the driver's pre-minted
        ::call span, so exec nests inside the wire interval), the
        contextvar activates so nested ``.remote()`` calls from user
        code chain into the same trace across any number of processes.

        For an UNTRACED record under tracing-on (trc empty: the
        submitter decided unsampled), returns a suppression guard
        instead — nested submits inherit the unsampled decision rather
        than re-drawing a root mid-request."""
        from ray_tpu_torch.utils import tracing

        if not trc:
            return _TraceSuppress()
        return tracing.span(f"{name}::run", tracing.unpack_ctx(trc),
                            self._fast_span_sink(tid), stage="exec",
                            transport=transport)

    def _exec_actor_run_thread(self, specs):
        out = []
        inst = self.actor_instance
        for spec in specs:
            try:
                m = getattr(inst, spec["method"])
                args = [
                    serialization.unpack(a[1]) if a[0] == "v" else a[1]
                    for a in spec["args"]
                ]
                kwargs = {
                    k: serialization.unpack(a[1]) if a[0] == "v" else a[1]
                    for k, a in spec["kwargs"].items()
                }
                out.append((True, self._traced_call(spec, m, args, kwargs)))
            except Exception as e:
                out.append((False, e))
        return out

    async def _actor_push_respond(self, conn, corr, payload):
        try:
            reply = await self.rpc_push_actor_task(conn, payload)
            await conn.respond(corr, value=reply)
        except Exception as e:
            try:
                await conn.respond(corr, error=e)
            except (rpc.RpcError, OSError):
                pass  # caller hung up: nobody is owed this error

    def _exec_simple_run(self, run):
        """Thread-side body of the simple-batch fast path: no awaits, no
        loop interaction — just call the user functions back to back."""
        out = []
        with self._exec_mutex:  # exclude concurrent ring-pump inline exec
            for spec in run:
                try:
                    fn = self._func_cache[spec["func_id"]]
                    args = [
                        serialization.unpack(a[1]) if a[0] == "v" else a[1]
                        for a in spec["args"]
                    ]
                    kwargs = {
                        k: serialization.unpack(a[1]) if a[0] == "v" else a[1]
                        for k, a in spec["kwargs"].items()
                    }
                    value = self._traced_call(spec, fn, args, kwargs)
                    if inspect.isgenerator(value):
                        value = list(value)
                        if spec["num_returns"] != 1:
                            value = tuple(value)
                    out.append((True, value))
                except Exception as e:
                    out.append((False, e))
        return out

    async def rpc_push_task(self, conn, p):
        spec = p["spec"]
        self._current_tasks.add(spec["task_id"])
        try:
            self._apply_accel_env(spec.get("gpu_ids"))
            await self._apply_runtime_env(spec.get("runtime_env"))
            fn = await self._load_function(spec["func_id"])
            args = await self._fetch_args(spec["args"])
            kwargs = dict(zip(spec["kwargs"].keys(), await self._fetch_args(list(spec["kwargs"].values()))))
            self.core.task_events.emit(
                task_id=spec["task_id"].hex(), name=spec.get("name", "task"),
                state="RUNNING", worker_id=self.worker_id.hex(),
                node_id=self.node_id.hex(), pid=os.getpid(),
            )
            t0 = time.monotonic()
            if spec["num_returns"] == "streaming":
                return await self._execute_streaming(spec, fn, args, kwargs)
            loop = asyncio.get_running_loop()
            if inspect.iscoroutinefunction(fn):
                value = await self._traced_acall(spec, fn, args, kwargs)
            else:
                def _run_locked():
                    with self._exec_mutex:  # one task per worker
                        out = self._traced_call(spec, fn, args, kwargs)
                        if inspect.isgenerator(out):
                            # legacy generator semantics (ref: old
                            # num_returns=N generators): materialize
                            # UNDER the mutex — the user code is the
                            # generator body, not the call that made it
                            return list(out), True
                        return out, False

                value, was_gen = await loop.run_in_executor(
                    self.executor, _run_locked)
                if was_gen and spec["num_returns"] != 1:
                    value = tuple(value)  # N>1 distributes the items
            results = await self._store_results(spec["task_id"], spec["num_returns"], value)
            dur = time.monotonic() - t0
            metrics.task_exec_seconds.observe(dur)
            self.core.task_events.emit(
                task_id=spec["task_id"].hex(), name=spec.get("name", "task"),
                state="FINISHED", worker_id=self.worker_id.hex(),
                node_id=self.node_id.hex(), pid=os.getpid(), duration_s=dur,
            )
            return {"results": results}
        except Exception as e:
            self.core.task_events.emit(
                task_id=spec["task_id"].hex(), name=spec.get("name", "task"),
                state="FAILED", worker_id=self.worker_id.hex(),
                node_id=self.node_id.hex(), pid=os.getpid(),
            )
            return {"error": _as_task_error(e)}
        finally:
            self._current_tasks.discard(spec["task_id"])

    async def _execute_streaming(self, spec, fn, args, kwargs, executor=None):
        """Run a (sync or async) generator, reporting each item to the
        owner as it is produced (ref: _raylet.pyx:1363
        execute_streaming_generator_sync/async; item report RPC
        core_worker.proto:498).

        A sync generator occupies ONE executor job for its entire run (a
        driver thread iterating it), preserving the one-method-at-a-time
        actor invariant — other method calls cannot interleave between
        yields on a max_concurrency=1 actor. Backpressure: the driver
        thread blocks on a small semaphore window that the sender releases
        per owner ack (the generator_waiter.h role)."""
        task_id = spec["task_id"]
        task_name = spec.get("name") or spec.get("method", "stream")
        owner = await rpc.connect(*spec["owner_address"], timeout=10)
        loop = asyncio.get_running_loop()
        index = 0
        t0 = time.monotonic()
        try:
            gen = fn(*args, **kwargs)
            if inspect.isasyncgen(gen):
                async def items():
                    async for v in gen:
                        yield v

                item_iter = items()
                release = lambda: None  # noqa: E731  (async gen self-paces)
            elif inspect.isgenerator(gen):
                import threading

                window = threading.Semaphore(2)
                out_q: asyncio.Queue = asyncio.Queue()
                ctl = {"stop": False}

                def drive():
                    try:
                        for v in gen:
                            window.acquire()
                            if ctl["stop"]:
                                gen.close()  # runs GeneratorExit on THIS thread
                                break
                            loop.call_soon_threadsafe(out_q.put_nowait, ("item", v))
                        loop.call_soon_threadsafe(out_q.put_nowait, ("end", None))
                    except BaseException as e:  # noqa: BLE001
                        loop.call_soon_threadsafe(out_q.put_nowait, ("error", e))

                driver = loop.run_in_executor(executor or self.executor, drive)

                async def items():
                    while True:
                        kind, v = await out_q.get()
                        if kind == "item":
                            yield v
                        elif kind == "error":
                            raise v
                        else:
                            await driver
                            return

                async def cancel():
                    ctl["stop"] = True
                    window.release()
                    await driver

                item_iter = items()
                release = window.release
            else:
                raise TaskError(
                    "num_returns='streaming' requires a generator function"
                )
            if inspect.isasyncgen(gen):
                async def cancel():  # noqa: F811
                    try:
                        await gen.aclose()
                    except Exception:
                        log.debug("async generator close failed",
                                  exc_info=True)
            async for value in item_iter:
                item = await self._pack_item(task_id, index, value)
                reply = await owner.call(
                    "generator_item", {"task_id": task_id, "index": index, "item": item}
                )
                index += 1
                release()
                if not reply.get("ok"):
                    await cancel()  # consumer dropped the generator
                    break
            await owner.call("generator_item", {"task_id": task_id, "done": True})
            dur = time.monotonic() - t0
            metrics.task_exec_seconds.observe(dur)
            self.core.task_events.emit(
                task_id=task_id.hex(), name=task_name, state="FINISHED",
                worker_id=self.worker_id.hex(), node_id=self.node_id.hex(),
                pid=os.getpid(), duration_s=dur, items=index,
            )
            return {"results": [], "streaming": True, "count": index}
        except Exception as e:
            err = _as_task_error(e)
            self.core.task_events.emit(
                task_id=task_id.hex(), name=task_name, state="FAILED",
                worker_id=self.worker_id.hex(), node_id=self.node_id.hex(),
                pid=os.getpid(),
            )
            try:
                await owner.call(
                    "generator_item", {"task_id": task_id, "done": True, "error": err}
                )
            except (rpc.RpcError, OSError):
                pass  # owner gone: the stream dies with its consumer
            return {"error": err}
        finally:
            await owner.close()

    async def _pack_item(self, task_id, index: int, value) -> dict:
        """Serialize one yielded item: small inline, large via shm +
        location registration (same split as _store_results)."""
        meta, buffers = serialization.dumps_with_buffers(value)
        size = serialization.total_size(meta, buffers)
        if size <= self.cfg.max_inline_object_size:
            return {"inline": _pack_bytes(meta, buffers, size)}
        oid = ObjectID.for_task_return(task_id, index)
        await self._store_shm_object(oid, meta, buffers)
        return {"shm": True, "size": size, "node": self.node_id.binary()}

    async def _store_shm_object(self, oid, meta, buffers):
        """Seal a large value into local shm and register this node as a
        holder in the GCS object directory (shared by task returns and
        streamed items)."""
        size = serialization.total_size(meta, buffers)
        if self.core.spill_pressure(size):
            try:  # free arena by spill, not eviction (local_object_manager.h)
                await self.core.raylet.call("spill_now", {"need": size})
            except (rpc.RpcError, OSError):
                pass  # advisory: create() below retries under pressure
        from ray_tpu_torch.core.object_store import ObjectStoreFullError

        for attempt in range(5):
            try:
                buf = self.core.store.create(oid, size)
                break
            except ObjectStoreFullError:
                # arena full of pinned data: give spills / reader releases
                # a beat instead of failing the task on transient pressure
                if attempt == 4:
                    raise
                try:
                    await self.core.raylet.call("spill_now", {"need": size})
                except (rpc.RpcError, OSError):
                    pass  # advisory: the backoff retry still runs
                await asyncio.sleep(0.2 * (attempt + 1))
        serialization.pack_into(meta, buffers, buf)
        self.core.store.seal(oid)
        import pickle

        holders_blob = await self.core.gcs.call("kv_get", {"ns": "obj_loc", "key": oid.hex()})
        holders = pickle.loads(holders_blob) if holders_blob else set()
        holders.add(self.node_id.binary())
        await self.core.gcs.call(
            "kv_put", {"ns": "obj_loc", "key": oid.hex(), "value": pickle.dumps(holders)}
        )

    # --------------------------------------------------------------- actors
    async def rpc_create_actor(self, conn, p):
        spec = p["spec"]
        self._apply_accel_env(p.get("gpu_ids"))
        await self._apply_runtime_env(spec.get("runtime_env"))
        cls = cloudpickle.loads(spec["class_blob"])
        args = await self._fetch_args(spec["args"])
        kwargs = dict(zip(spec["kwargs"].keys(), await self._fetch_args(list(spec["kwargs"].values()))))
        max_concurrency = spec.get("max_concurrency", 1)
        self._actor_max_concurrency = max_concurrency
        if max_concurrency > 1:
            self.executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=max_concurrency, thread_name_prefix="rt-actor"
            )
        # named concurrency groups: each group gets its own executor pool +
        # async-slot semaphore, isolated from the default executor
        # (ref: concurrency_group_manager.cc per-group thread pools)
        self._method_groups = spec.get("method_groups") or {}
        self._group_execs = {}
        self._group_sems = {}
        for gname, slots in (spec.get("concurrency_groups") or {}).items():
            slots = max(1, int(slots))
            self._group_execs[gname] = concurrent.futures.ThreadPoolExecutor(
                max_workers=slots, thread_name_prefix=f"rt-cg-{gname}"
            )
            self._group_sems[gname] = asyncio.Semaphore(slots)
        loop = asyncio.get_running_loop()
        try:
            self.actor_instance = await loop.run_in_executor(
                self.executor, lambda: cls(*args, **kwargs)
            )
        except Exception as e:
            raise _as_task_error(e) from None
        self.actor_id = spec["actor_id"]
        # fast-lane method eligibility, resolved ONCE per actor lifetime
        # (the ring pump and the attach reply both read it; see
        # _build_actor_method_table)
        self._actor_method_table = self._build_actor_method_table(cls)
        return {"ok": True}

    async def rpc_push_actor_task(self, conn, p):
        """Executes an actor call with per-caller-connection FIFO ordering
        (ref: actor_scheduling_queue.cc sequence gating): the seq gate is
        held through arg fetching and work dispatch, then released before
        awaiting the result — sync methods serialize through the executor
        thread, async methods start in order but run concurrently."""
        spec = p["spec"]
        if self.actor_instance is None:
            return {"error": TaskError("no actor instance on this worker")}
        seq = spec.get("seq")
        gate = self._seq_gates.setdefault(conn, {"next": 0, "events": {}})
        if seq is not None:
            while gate["next"] != seq:
                ev = gate["events"].setdefault(seq, asyncio.Event())
                await ev.wait()
        work = None
        streaming = spec.get("num_returns") == "streaming"
        try:
            method = getattr(self.actor_instance, spec["method"])
            args = await self._fetch_args(spec["args"])
            kwargs = dict(zip(spec["kwargs"].keys(), await self._fetch_args(list(spec["kwargs"].values()))))
            group = (spec.get("concurrency_group")
                     or self._method_groups.get(spec["method"]))
            if group and group not in self._group_execs:
                # loud, not a silent fallback: an undeclared group name
                # (typo) would otherwise lose the isolation it asked for
                return {"error": TaskError(
                    f"concurrency group {group!r} not declared on this actor "
                    f"(declared: {sorted(self._group_execs)})")}
            if streaming:
                # a grouped generator drives its iteration on the group's
                # pool, not the default executor (isolation holds for
                # streaming methods too)
                work = asyncio.get_running_loop().create_task(
                    self._execute_streaming(
                        spec, method, args, kwargs,
                        executor=self._group_execs.get(group))
                )
            elif inspect.iscoroutinefunction(method):
                if group and group in self._group_sems:
                    sem = self._group_sems[group]

                    async def run_grouped(method=method, args=args, kwargs=kwargs):
                        async with sem:  # group-bounded async slots
                            return await self._traced_acall(
                                spec, method, args, kwargs)

                    work = asyncio.get_running_loop().create_task(run_grouped())
                else:
                    work = asyncio.get_running_loop().create_task(
                        self._traced_acall(spec, method, args, kwargs))
            else:
                loop = asyncio.get_running_loop()
                executor = self._group_execs.get(group, self.executor)
                work = loop.run_in_executor(
                    executor,
                    lambda: self._traced_call(spec, method, args, kwargs))
        except Exception as e:
            return {"error": _as_task_error(e)}
        finally:
            if seq is not None:
                gate["next"] = seq + 1
                ev = gate["events"].pop(seq + 1, None)
                if ev is not None:
                    ev.set()
        self.core.task_events.emit(
            task_id=spec["task_id"].hex(), name=spec.get("method", "actor_task"),
            state="RUNNING", worker_id=self.worker_id.hex(),
            node_id=self.node_id.hex(), pid=os.getpid(),
            actor_id=self.actor_id.hex() if self.actor_id else None,
        )
        t0 = time.monotonic()
        try:
            value = await work
            if streaming:
                return value  # _execute_streaming builds the full reply
            results = await self._store_results(spec["task_id"], spec["num_returns"], value)
            dur = time.monotonic() - t0
            metrics.task_exec_seconds.observe(dur)
            self.core.task_events.emit(
                task_id=spec["task_id"].hex(), name=spec.get("method", "actor_task"),
                state="FINISHED", worker_id=self.worker_id.hex(),
                node_id=self.node_id.hex(), pid=os.getpid(), duration_s=dur,
            )
            return {"results": results}
        except Exception as e:
            self.core.task_events.emit(
                task_id=spec["task_id"].hex(), name=spec.get("method", "actor_task"),
                state="FAILED", worker_id=self.worker_id.hex(),
                node_id=self.node_id.hex(), pid=os.getpid(),
            )
            return {"error": _as_task_error(e)}

    async def rpc_start_dag_loop(self, conn, p):
        """Run a compiled-DAG static schedule until its channels close
        (ref: compiled_dag_node.py actor loop). Dedicated thread: blocking
        channel waits must not stall the actor's normal method surface."""
        if self.actor_instance is None:
            return {"error": TaskError("no actor instance on this worker")}
        from ray_tpu_torch.dag.runner import run_dag_loop

        loop = asyncio.get_running_loop()
        ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="rt-dag"
        )
        try:
            result = await loop.run_in_executor(
                ex, lambda: run_dag_loop(self, p["schedule"])
            )
            return {"result": result}
        except Exception as e:
            return {"error": _as_task_error(e)}
        finally:
            ex.shutdown(wait=False)

    async def rpc_dump_stack(self, conn, p):
        """On-demand stack capture of every thread in this worker (ref:
        dashboard/modules/reporter/profile_manager.py:82 — there py-spy
        attaches externally; here the worker self-reports, which needs no
        ptrace capability and works in containers)."""
        import threading

        names = {t.ident: t.name for t in threading.enumerate()}
        out = [{
            "thread_id": tid,
            "name": names.get(tid, "?"),
            "stack": "".join(traceback.format_stack(frame)),
        } for tid, frame in sys._current_frames().items()]
        return {"pid": os.getpid(), "worker_id": self.worker_id.hex(),
                "threads": out}

    async def rpc_cpu_profile(self, conn, p):
        """Sampled CPU profile of this worker: walk every thread's stack
        at a fixed interval for duration_s and aggregate FOLDED stacks
        (root;child;leaf -> sample count) — the flamegraph input format
        (ref: profile_manager.py:82, where py-spy record produces
        speedscope output externally; here the worker samples itself, so
        no ptrace and no subprocess). state.get_cpu_profile renders the
        folded map as speedscope JSON."""
        import threading
        import time as _time

        duration = min(float(p.get("duration_s", 2.0)), 30.0)
        interval = max(float(p.get("interval_s", 0.01)), 0.001)

        def sample():
            folded: dict[str, int] = {}
            samples = 0
            me = threading.get_ident()
            end = _time.monotonic() + duration
            while _time.monotonic() < end:
                for tid, frame in sys._current_frames().items():
                    if tid == me:
                        continue
                    parts = []
                    f = frame
                    while f is not None:
                        code = f.f_code
                        parts.append(
                            f"{code.co_name} "
                            f"({os.path.basename(code.co_filename)}"
                            f":{f.f_lineno})")
                        f = f.f_back
                    key = ";".join(reversed(parts))
                    folded[key] = folded.get(key, 0) + 1
                samples += 1
                _time.sleep(interval)
            return folded, samples

        folded, samples = await asyncio.get_running_loop().run_in_executor(
            None, sample)
        return {"pid": os.getpid(), "worker_id": self.worker_id.hex(),
                "duration_s": duration, "interval_s": interval,
                "samples": samples, "folded": folded}

    async def rpc_heap_profile(self, conn, p):
        """On-demand heap profiling via tracemalloc (the memray role of
        the reference's profile_manager.py:191, reimplemented in-process:
        no external profiler attach, works in containers).

        action="start" begins tracing (nframes deep); "snapshot" returns
        the top-N allocation sites grouped by traceback since start;
        "stop" ends tracing and frees the bookkeeping."""
        import tracemalloc

        action = p.get("action", "snapshot")
        if action == "start":
            if not tracemalloc.is_tracing():
                tracemalloc.start(int(p.get("nframes", 8)))
            return {"tracing": True}
        if action == "stop":
            tracemalloc.stop()
            return {"tracing": False}
        if not tracemalloc.is_tracing():
            return {"error": "not tracing: call action='start' first"}
        snap = tracemalloc.take_snapshot()
        top = snap.statistics("traceback")[: int(p.get("top", 20))]
        stats = [{
            "size_bytes": s.size,
            "count": s.count,
            "traceback": s.traceback.format(),
        } for s in top]
        current, peak = tracemalloc.get_traced_memory()
        return {"pid": os.getpid(), "worker_id": self.worker_id.hex(),
                "current_bytes": current, "peak_bytes": peak,
                "top": stats}

    async def rpc_exit_worker(self, conn, p):
        self._exit_requested = True
        from ray_tpu_torch.utils import recorder as _recorder

        rec = _recorder.get_recorder() if self.cfg.recorder_enabled else None
        if rec is not None:
            rec.unlink()  # clean exit: no postmortem, don't leak the file
        if _profiler is not None:  # RT_WORKER_PROFILE_DIR diagnosis mode
            _profiler.disable()
            _profiler.dump_stats(os.path.join(
                os.environ["RT_WORKER_PROFILE_DIR"],
                f"worker-{os.getpid()}.prof"))
        asyncio.get_running_loop().call_later(0.05, os._exit, 0)
        return True

    async def rpc_ping(self, conn, p):
        return {"pid": os.getpid(), "actor": self.actor_id}


class _TraceSuppress:
    """Guard installing tracing.UNSAMPLED around one UNTRACED record's
    execution when tracing is enabled cluster-wide: head sampling is per
    request, so nested ``.remote()`` calls from an unsampled request's
    user code inherit the decision instead of re-drawing a fresh root
    mid-request. Duck-types the span interface the dispatch path's
    manual enter/exit handling expects (``_token``)."""

    __slots__ = ("_token",)

    def __init__(self):
        self._token = None

    def __enter__(self):
        from ray_tpu_torch.utils import tracing

        self._token = tracing.suppress()
        return self

    def __exit__(self, exc_type, exc, tb):
        from ray_tpu_torch.utils import tracing

        tracing.deactivate(self._token)
        self._token = None
        return False


class _TunnelSink:
    """Reply-side face of one worker tunnel lane: duck-types the reply
    half of a ring for ``_fast_reply_one``/``_fast_pack_result`` — framed
    completion records buffer here (any thread: the loop's dispatched
    execs AND the executor's inline batches) and every reply landing in
    the same loop tick coalesces into ONE ``tunnel_replies`` notify back
    through the raylet (the worker-side half of the tunnel's frame
    coalescing). ``_desc_node`` makes OK_SHM results carry this node's
    id (the cross-node location descriptor)."""

    __slots__ = ("_w", "_st", "_desc_node", "_lock")

    def __init__(self, worker: "Worker", st: dict):
        import threading as _threading

        self._w = worker
        self._st = st
        self._desc_node = worker.node_id.binary()
        self._lock = _threading.Lock()

    def push_batch(self, which: int, framed: bytes, timeout_ms: int = 0) -> int:
        st = self._st
        if st.get("closed"):
            return -7  # closed: the driver's break-lane recovery owns it
        with self._lock:
            st["reply_buf"].append(bytes(framed))
            arm = not st["reply_armed"]
            if arm:
                st["reply_armed"] = True
        if arm:
            loop = self._w.core.loop
            try:
                import threading as _threading

                if _threading.get_ident() == getattr(loop, "_thread_id",
                                                     None):
                    loop.call_soon(self._flush)
                else:
                    loop.call_soon_threadsafe(self._flush)
            except RuntimeError:
                return -7  # loop gone (worker exit)
        return len(framed)

    def push_raw(self, which: int, framed: bytes, timeout_ms: int = -1) -> int:
        return 0 if self.push_batch(which, framed, timeout_ms) >= 0 else -7

    def _flush(self):
        st = self._st
        with self._lock:
            buf = st["reply_buf"]
            if not buf:
                st["reply_armed"] = False
                return
            st["reply_buf"] = []
        data = buf[0] if len(buf) == 1 else b"".join(buf)
        conn = st["conn"]
        try:
            conn.send_nowait({"k": "n", "m": "tunnel_replies",
                              "p": {"frames": [(st["lane"], data)]}})
        except Exception:
            # raylet link gone: the driver discovers the break through
            # the raylet (tunnel_down) or its health sweep; records are
            # recovered by break-lane resubmission
            st["closed"] = True
            log.debug("tunnel reply push failed", exc_info=True)
            return
        self._w.core.loop.call_soon(self._flush)  # burst linger


def _as_task_error(e: Exception) -> Exception:
    if isinstance(e, TaskError):
        return e
    if getattr(e, "_rt_error_passthrough", False):
        # typed-error contract (serve/exceptions.py): the class promises
        # to be importable + picklable everywhere, so it ships as-is and
        # callers can dispatch on the type (retry classification, proxy
        # status mapping) instead of parsing a flattened message
        return e
    tb = traceback.format_exc()
    return TaskError(f"{type(e).__name__}: {e}", cause_repr=repr(e), traceback_str=tb)


def main():
    chaos.maybe_arm()  # fault schedule rides the serialized config

    async def run():
        worker = Worker()
        await worker.start()
        await asyncio.Event().wait()

    prof_dir = os.environ.get("RT_WORKER_PROFILE_DIR")
    if prof_dir:  # perf diagnosis: dump per-worker cProfile stats at exit
        import cProfile
        import signal

        global _profiler
        _profiler = cProfile.Profile()
        _profiler.enable()

        def _dump(signum, frame):
            _profiler.disable()
            _profiler.dump_stats(
                os.path.join(prof_dir, f"worker-{os.getpid()}.prof"))
            os._exit(0)

        signal.signal(signal.SIGTERM, _dump)
    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
