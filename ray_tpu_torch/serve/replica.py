"""Replica actor: hosts one copy of a deployment's user callable.

Equivalent of the reference ReplicaActor (ref:
python/ray/serve/_private/replica.py:925, user-code wrapper :1170). The
wrapper tracks ongoing-request counts (the autoscaling signal), enforces
the per-replica concurrency cap, resolves handle markers in init args so
deployments compose (ref: serve deployment graph .bind), and applies
user_config via the user class's optional ``reconfigure`` method.

Request fault tolerance (this layer's half of the router/replica
contract):

- **admission control**: beyond ``max_ongoing_requests`` executing plus
  ``max_queued_requests`` queued, new requests are refused with a typed
  :class:`BackPressureError` instead of queueing unboundedly — the
  router retries them elsewhere, the proxies answer 429 /
  RESOURCE_EXHAUSTED (ref: replica_scheduler queue-length admission).
- **deadline shedding**: a request whose propagated deadline already
  expired while queued is dropped at dequeue — executing it would burn
  device time on an answer nobody is waiting for (ref: Tail at Scale's
  "good enough soon beats perfect late").
- **projected-delay admission** (serve/dataplane/admission.py): a
  request whose PROJECTED queue wait — queue depth x the replica's
  execution-time EWMA over its concurrency — already exceeds the
  remaining deadline is refused at admission with ``BackPressureError``
  instead of parking in a queue it can only time out of.
- **hedge cancellation**: :meth:`cancel_request` marks a request id;
  a marked request still queued is shed before user code runs, so the
  losing copy of a hedged request costs a queue slot, not an execution.
- the chaos fault point ``serve.handle_request`` fires here, making the
  request path schedulable by seeded ChaosPlans (kill-replicas-under-
  load is the checked-in SLO plan, tests/plans/).
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextvars
import inspect
import threading
import time

try:
    import cloudpickle
except ImportError:  # pragma: no cover
    import pickle as cloudpickle

from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.serve import context as serve_context
from ray_tpu_torch.serve.dataplane.admission import AdmissionController
from ray_tpu_torch.serve.exceptions import (
    BackPressureError,
    RequestCancelledError,
    RequestTimeoutError,
)

# ---------------------------------------------------------------- latency
# Per-process serve request-latency windows, published beside the flight
# recorder's stage window via CoreClient.add_latency_source("serve"):
# one stage per deployment (``serve_<app>/<dep>`` e2e ns samples), so
# state.list_task_latency() grows per-deployment serve rows with zero
# new API and the controller's SLO-feedback autoscaler reads its p99
# signal from the same ns="latency" namespace as every other stage.
# Module-level (not per-Replica) because add_latency_source is keyed by
# suffix per process — co-located replicas share one merged window.
_LAT_WINDOW = 512          # samples kept per deployment
_LAT_FRESH_S = 30.0        # samples older than this never publish
_lat_lock = threading.Lock()
_lat_windows: dict[str, collections.deque] = {}
_lat_count = 0
_lat_published = -1
_lat_pending = -1
_lat_registered = False


def _record_request_latency(key: str, dur_ns: int,
                            slo_ns: float | None = None) -> None:
    global _lat_count
    with _lat_lock:
        win = _lat_windows.get(key)
        if win is None:
            win = _lat_windows[key] = collections.deque(maxlen=_LAT_WINDOW)
        win.append((time.time(), dur_ns))
        _lat_count += 1
    # monotonic cumulatives for the rollup plane: the controller's burn
    # monitor reads the windowed serve_slo_breach_fraction ratio
    # (breaches_delta / requests_delta) instead of re-deriving breach
    # fractions from raw latency windows each tick
    from ray_tpu_torch.utils import metrics

    metrics.serve_requests_total.inc(tags={"key": key})
    if slo_ns is not None and dur_ns > slo_ns:
        metrics.serve_slo_breaches_total.inc(tags={"key": key})


def _serve_latency_snapshot():
    """add_latency_source fn: {stages, count, ts} or None when idle.
    ``ts`` lets the autoscaler ignore a window some dead replica left
    behind in the kv namespace."""
    global _lat_pending
    with _lat_lock:
        if _lat_count == _lat_published:
            return None
        cutoff = time.time() - _LAT_FRESH_S
        stages = {f"serve_{key}": [ns for ts, ns in win if ts >= cutoff]
                  for key, win in _lat_windows.items()}
        stages = {k: v for k, v in stages.items() if v}
        if not stages:
            return None
        _lat_pending = _lat_count
        return {"count": _lat_count, "ts": time.time(), "stages": stages}


def _serve_latency_confirm() -> None:
    global _lat_published
    _lat_published = _lat_pending


def _ensure_latency_source() -> None:
    global _lat_registered
    if _lat_registered:
        return
    try:
        from ray_tpu_torch.core.api import get_core

        get_core().add_latency_source("serve", _serve_latency_snapshot,
                                      _serve_latency_confirm)
        _lat_registered = True
    except Exception:
        # no core in this process (unit tests constructing Replica
        # directly) or core still bootstrapping: stay unregistered so
        # the next Replica construction retries — a sticky flag here
        # would blind the autoscaler's p99 signal for the process life
        import logging

        logging.getLogger(__name__).debug(
            "serve latency source not registered", exc_info=True)


class HandleMarker:
    """Placeholder in init args for a handle to another deployment; the
    replica swaps it for a live DeploymentHandle at construction time."""

    def __init__(self, deployment_name: str, app_name: str):
        self.deployment_name = deployment_name
        self.app_name = app_name


class Replica:
    """Generic replica wrapper: created as an actor per replica by the
    controller; all requests flow through handle_request."""

    def __init__(self, serialized_cls: bytes, init_args: tuple, init_kwargs: dict,
                 deployment_name: str, replica_id: str, max_ongoing_requests: int,
                 user_config: dict | None = None,
                 max_queued_requests: int = -1,
                 latency_slo_ms: float | None = None,
                 app_name: str = "default",
                 ttfc_slo_ms: float | None = None,
                 interchunk_slo_ms: float | None = None):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        cls = cloudpickle.loads(serialized_cls)
        init_args = tuple(self._resolve(a, DeploymentHandle) for a in init_args)
        init_kwargs = {k: self._resolve(v, DeploymentHandle) for k, v in init_kwargs.items()}
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self.max_ongoing_requests = max_ongoing_requests
        self.max_queued_requests = max_queued_requests
        self.latency_slo_ms = latency_slo_ms
        self._slo_ns = (None if latency_slo_ms is None
                        else float(latency_slo_ms) * 1e6)
        # streaming SLOs: TTFC defaults to the unary budget (first token
        # racing the whole-response SLO is the conservative choice);
        # inter-chunk gaps only breach when explicitly configured
        self._ttfc_slo_ns = (self._slo_ns if ttfc_slo_ms is None
                             else float(ttfc_slo_ms) * 1e6)
        self._gap_slo_ns = (None if interchunk_slo_ms is None
                            else float(interchunk_slo_ms) * 1e6)
        self._lat_key = f"{app_name}/{deployment_name}"
        self._admission = AdmissionController(max_ongoing_requests)
        self._ongoing = 0
        self._executing = 0
        self._queued = 0
        self._total = 0
        self._shed = 0
        self._refused = 0
        self._gate = None  # asyncio.Semaphore, created lazily on the actor loop
        # hedge-loser cancellation: ids marked before their request
        # reached the front of the queue are shed pre-execution; bounded
        # so a spray of unknown ids can't grow without limit
        self._cancelled: collections.OrderedDict[str, None] = collections.OrderedDict()
        # sync user methods run here so the cap, not the worker's executor
        # width, bounds real concurrency
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, max_ongoing_requests), thread_name_prefix="rt-serve"
        )
        self.user = cls(*init_args, **init_kwargs) if isinstance(cls, type) else cls
        if user_config is not None:
            self._apply_user_config(user_config)
        self._wire_batch_queues()
        _ensure_latency_source()

    def _wire_batch_queues(self):
        """Hand the deployment's latency_slo_ms to @serve.batch methods
        that didn't set their own — the AIMD controller then closes its
        loop against the same budget the autoscaler and admission
        control use. Stored ON THE INSTANCE (read at lazy queue
        creation), never on the shared wrapper config: a by-reference
        pickled class is one object per process, and mutating its
        config would leak the first deployment's SLO into every
        co-located deployment of the same class."""
        if self.latency_slo_ms is None:
            return
        for name in dir(type(self.user)):
            if getattr(getattr(type(self.user), name, None),
                       "_is_serve_batch", False):
                try:
                    self.user.__rt_batch_slo__ = self.latency_slo_ms
                except AttributeError:
                    pass  # __slots__ user class: decorator budgets only
                return

    def _batch_stats(self) -> dict | None:
        """Merged AIMD stats across the user's batch queues (get_metrics
        -> controller/dashboard/bench)."""
        out = None
        for name in dir(type(self.user)):
            fn = getattr(type(self.user), name, None)
            queues = getattr(fn, "_batch_queues", None)
            if not queues:
                continue
            for q in queues.values():
                s = q.controller.stats()
                if out is None:
                    out = s
                else:  # multiple batched methods: keep the busiest
                    if s["batches"] > out["batches"]:
                        out = s
        return out

    @staticmethod
    def _resolve(arg, handle_cls):
        if isinstance(arg, HandleMarker):
            return handle_cls(arg.deployment_name, app_name=arg.app_name)
        return arg

    def _apply_user_config(self, user_config: dict):
        fn = getattr(self.user, "reconfigure", None)
        if fn is None:
            raise AttributeError(
                f"{type(self.user).__name__} got user_config but defines no "
                "reconfigure(user_config) method"
            )
        fn(user_config)

    # ------------------------------------------------------------- requests
    def _admit(self, deadline: float | None = None):
        """Admission control: refuse (typed, retryable-elsewhere) rather
        than queue past the declared bound — positionally
        (max_queued_requests) or temporally (the projected queue delay
        already eats the request's remaining deadline; shedding here
        beats the deadline shed at dequeue by the whole queue wait)."""
        if (self.max_queued_requests >= 0
                and self._executing >= self.max_ongoing_requests
                and self._queued >= self.max_queued_requests):
            self._refused += 1
            raise BackPressureError(
                f"replica {self.replica_id} at capacity "
                f"({self._executing} executing, {self._queued} queued)",
                # a slot frees when the oldest executing request finishes;
                # the queue depth is the best local estimate of that wait
                retry_after_s=0.05 * (1 + self._queued),
            )
        if (deadline is not None and self._queued > 0
                and self._admission.would_breach(self._queued, deadline)):
            self._refused += 1
            self._admission.shed += 1
            raise BackPressureError(
                f"replica {self.replica_id}: projected queue delay "
                f"{self._admission.projected_delay_s(self._queued):.3f}s "
                f"exceeds the request's remaining deadline "
                f"({max(0.0, deadline - time.monotonic()):.3f}s)",
                retry_after_s=self._admission.projected_delay_s(self._queued),
            )

    def _check_shed(self, deadline: float | None, request_id: str):
        """At dequeue (post-gate): drop work that is already dead."""
        if request_id and request_id in self._cancelled:
            self._cancelled.pop(request_id, None)
            self._shed += 1
            raise RequestCancelledError(
                f"request {request_id} cancelled before execution")
        if deadline is not None and time.monotonic() >= deadline:
            self._shed += 1
            raise RequestTimeoutError(
                f"deadline expired while queued on replica {self.replica_id}; "
                "shedding instead of executing")

    async def handle_request(self, method: str, args: tuple, kwargs: dict,
                             multiplexed_model_id: str = "",
                             timeout_s: float | None = None,
                             request_id: str = ""):
        if chaos.ENABLED:
            chaos.point("serve.handle_request", method=method,
                        deployment=self.deployment_name,
                        replica=self.replica_id)
        if self._gate is None:
            self._gate = asyncio.Semaphore(self.max_ongoing_requests)
        # arrival-relative deadline: the router sends REMAINING budget so
        # cross-node clock domains never skew the absolute deadline
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        self._admit(deadline)
        t_arrival = time.perf_counter_ns()
        self._ongoing += 1
        self._total += 1
        self._queued += 1
        if multiplexed_model_id:
            # task-local: concurrent requests on this async actor each see
            # their own id through serve.get_multiplexed_model_id()
            from ray_tpu_torch.serve.multiplex import _set_request_model_id

            _set_request_model_id(multiplexed_model_id)
        dequeued = False
        try:
            async with self._gate:
                self._queued -= 1
                dequeued = True
                self._check_shed(deadline, request_id)
                self._executing += 1
                t_exec = time.perf_counter_ns()
                try:
                    # composed handle calls inside user code inherit the
                    # remaining budget through this contextvar
                    token = serve_context.set_deadline(deadline)
                    try:
                        fn = getattr(self.user, method) if method else self.user
                        if inspect.iscoroutinefunction(fn):
                            return await fn(*args, **kwargs)
                        loop = asyncio.get_running_loop()
                        # copy_context: the model-id and deadline
                        # contextvars must be visible inside sync methods
                        # running on the pool thread
                        ctx = contextvars.copy_context()
                        return await loop.run_in_executor(
                            self._pool, lambda: ctx.run(fn, *args, **kwargs))
                    finally:
                        serve_context.reset_deadline(token)
                finally:
                    self._executing -= 1
                    done = time.perf_counter_ns()
                    # exec EWMA feeds projected-delay admission; the e2e
                    # (queue + exec) sample feeds the "serve" latency
                    # window the SLO autoscaler reads its p99 from
                    self._admission.observe_exec((done - t_exec) / 1e9)
                    _record_request_latency(self._lat_key, done - t_arrival,
                                            self._slo_ns)
        finally:
            if not dequeued:  # cancelled while waiting on the gate
                self._queued -= 1
            self._ongoing -= 1

    async def handle_request_streaming(self, method: str, args: tuple,
                                       kwargs: dict,
                                       multiplexed_model_id: str = "",
                                       timeout_s: float | None = None,
                                       request_id: str = ""):
        """Streaming requests: the user method must be a generator (sync
        or async); items flow back as "G" chunk records on the serve fast
        lane, or per-item over the actor streaming-generator plane on the
        RPC fallback (ref: serve streaming responses over
        ReportGeneratorItemReturns).

        Cancellation: :meth:`cancel_request` on a streaming id takes
        effect BETWEEN yields — the wrapper stops iterating, which closes
        the user generator (``GeneratorExit`` -> its ``finally`` frees
        the decode slot / KV pages) long before the generation would have
        finished. Abandoned consumers reach the same path: the worker
        pump closes this wrapper when the ring closes or the driver sends
        ``stream_abandon``."""
        if chaos.ENABLED:
            chaos.point("serve.handle_request", method=method,
                        deployment=self.deployment_name,
                        replica=self.replica_id, streaming=True)
        if self._gate is None:
            self._gate = asyncio.Semaphore(self.max_ongoing_requests)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        self._admit(deadline)
        t_arrival = time.perf_counter_ns()
        self._ongoing += 1
        self._total += 1
        self._queued += 1
        if multiplexed_model_id:
            from ray_tpu_torch.serve.multiplex import _set_request_model_id

            _set_request_model_id(multiplexed_model_id)
        dequeued = False
        try:
            async with self._gate:
                self._queued -= 1
                dequeued = True
                self._check_shed(deadline, request_id)
                self._executing += 1
                try:
                    from ray_tpu_torch.serve.streaming.slo import StreamLatencyTracker

                    lat = StreamLatencyTracker(
                        self._lat_key, self._ttfc_slo_ns, self._gap_slo_ns,
                        t_arrival_ns=t_arrival)
                    token = serve_context.set_deadline(deadline)
                    try:
                        fn = getattr(self.user, method) if method else self.user
                        it = fn(*args, **kwargs)
                        if hasattr(it, "__aiter__"):
                            # the finally runs on normal exhaustion AND on
                            # GeneratorExit from an abandoned consumer —
                            # either way the user generator's own finally
                            # (engine cancel, KV free) fires now, not at GC
                            try:
                                async for item in it:
                                    lat.on_chunk()
                                    yield item
                                    if (request_id
                                            and request_id in self._cancelled):
                                        self._cancelled.pop(request_id, None)
                                        self._shed += 1
                                        break
                            finally:
                                aclose = getattr(it, "aclose", None)
                                if aclose is not None:
                                    await aclose()
                        else:
                            # sync generator: step it on the pool so a
                            # blocking user body can't stall the actor loop
                            loop = asyncio.get_running_loop()
                            ctx = contextvars.copy_context()
                            _END = object()
                            def _pull_batch(nmax=64, budget_s=5e-4):
                                # amortize the pool round-trip (~hundreds
                                # of µs of thread wakeups) over every item
                                # a fast generator has ready; a slow one
                                # returns after ONE item (its next() alone
                                # blows the budget) so chunk latency is
                                # unchanged where it matters. A mid-batch
                                # user exception is deferred so the pulled
                                # prefix still streams out before it
                                # becomes the terminal.
                                out = []
                                err = None
                                t0 = time.perf_counter()
                                try:
                                    while len(out) < nmax:
                                        out.append(next(it))
                                        if (time.perf_counter() - t0
                                                >= budget_s):
                                            break
                                except StopIteration:
                                    out.append(_END)
                                except BaseException as e:  # noqa: BLE001
                                    err = e
                                return out, err

                            done = False
                            try:
                                while not done:
                                    items, err = await loop.run_in_executor(
                                        self._pool,
                                        lambda: ctx.run(_pull_batch))
                                    for item in items:
                                        if item is _END:
                                            done = True
                                            break
                                        lat.on_chunk()
                                        yield item
                                        if (request_id
                                                and request_id
                                                in self._cancelled):
                                            self._cancelled.pop(
                                                request_id, None)
                                            self._shed += 1
                                            done = True
                                            break
                                    if err is not None:
                                        raise err
                            finally:
                                close = getattr(it, "close", None)
                                if close is not None:
                                    close()
                    finally:
                        serve_context.reset_deadline(token)
                finally:
                    self._executing -= 1
        finally:
            if not dequeued:  # torn down while waiting on the gate
                self._queued -= 1
            self._ongoing -= 1

    def cancel_request(self, request_id: str) -> bool:
        """Best-effort pre-execution cancel (hedge losers): if the id is
        still queued it is shed at dequeue; an already-executing request
        runs to completion (actor tasks are never killed mid-flight)."""
        if not request_id:
            return False
        self._cancelled[request_id] = None
        while len(self._cancelled) > 256:  # bound stale-id growth
            self._cancelled.popitem(last=False)
        return True

    # ------------------------------------------------------------ lifecycle
    def get_metrics(self) -> dict:
        from ray_tpu_torch.serve.multiplex import loaded_model_ids

        # deployment-defined load signal (__serve_load__, in ongoing-
        # request equivalents): lets a deployment whose real pressure
        # lives below the request count — the disagg LLM scheduler's
        # decode tokens-in-flight — steer the router's pow-2 choice
        user_load = 0.0
        fn = getattr(self.user, "__serve_load__", None)
        if fn is not None:
            try:
                user_load = float(fn())
            except Exception:  # raylint: disable=RT012 — probe must never fail metrics
                pass
        out = {
            "replica_id": self.replica_id,
            "ongoing": self._ongoing,
            "user_load": user_load,
            "queued": self._queued,
            "shed": self._shed,
            "refused": self._refused,
            "total": self._total,
            # handle-side projected-delay admission reads these two
            # (dataplane/admission.py): the router's view of this
            # replica's drain rate
            "exec_ewma_ms": self._admission.exec_ewma_s * 1e3,
            "admission_shed": self._admission.shed,
            # resident multiplexed models: the router's affinity signal
            # (ref: multiplex model-id membership via long-poll)
            "models": loaded_model_ids(self.user),
        }
        batch = self._batch_stats()
        if batch is not None:
            out["batch"] = batch
        return out

    def check_health(self) -> bool:
        fn = getattr(self.user, "check_health", None)
        if fn is not None:
            fn()
        return True

    def reconfigure(self, user_config: dict) -> bool:
        self._apply_user_config(user_config)
        return True

    async def prepare_for_shutdown(self, timeout_s: float) -> bool:
        """Drain: wait for ongoing requests to finish (bounded)."""
        deadline = asyncio.get_event_loop().time() + timeout_s
        while self._ongoing > 0 and asyncio.get_event_loop().time() < deadline:
            await asyncio.sleep(0.02)
        return self._ongoing == 0
