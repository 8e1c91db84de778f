"""DeploymentHandle + request router.

Equivalent of the reference handle/router pair (ref:
python/ray/serve/handle.py:633 DeploymentHandle, _private/router.py:337
Router.assign_request, request_router/pow_2_router.py:27
PowerOfTwoChoicesRequestRouter). The router long-polls the controller for
replica membership and picks between two random replicas by locally
tracked in-flight counts — the same ongoing-requests signal the reference
router uses, with no per-request probe RPC on the hot path.

Request fault tolerance (this layer's half of the router/replica
contract; see README § Serve fault tolerance):

- **retries with exponential backoff + jitter**: a replica death or
  refusal replays the request on another replica, charging the
  deployment's ``max_request_retries`` budget. Failures that provably
  never executed (``BackPressureError``, ``ReplicaUnavailableError``)
  retry for every method; ambiguous failures (the replica died while
  holding the request) replay only methods the ``retry_on`` gate marks
  idempotent.
- **deadlines**: ``request_timeout_s`` stamps a deadline that bounds
  every attempt, travels to the replica (which sheds expired queued
  work), and is inherited by composed handle calls via
  serve/context.py — a nested deployment gets the REMAINING budget.
- **hedged requests** (Dean & Barroso, The Tail at Scale): after
  ``hedge_after_ms`` without a reply, one duplicate goes to a different
  replica; first result wins and the loser is cancelled (pre-execution
  shed replica-side).
- **backpressure**: the router caps its own membership-wait queue at
  ``max_queued_requests`` instead of parking unboundedly.
- **fast failure detection**: the router subscribes to the core
  actor-death pubsub, so a killed replica leaves the routing table in
  ~one raylet reap tick instead of a health-check period.

Handles work from two call sites with different blocking rules:
- driver / plain threads: .remote() routes synchronously, returns an
  ObjectRef (a promise ref the retry loop fulfills behind the scenes)
- inside async actors (deployment composition): the event loop must not
  block, so .remote() returns an awaitable response that finishes routing
  asynchronously (the reference's DeploymentResponse shape)
"""
from __future__ import annotations

import asyncio
import itertools
import random
import threading
import time

from ray_tpu_torch.serve import context as serve_context
from ray_tpu_torch.serve.controller import CONTROLLER_NAME
from ray_tpu_torch.serve.dataplane.admission import AdmissionController
from ray_tpu_torch.serve.dataplane.fastlane import ReplicaLane, fastlane_enabled
from ray_tpu_torch.serve.exceptions import (
    BackPressureError,
    RayServeException,
    ReplicaUnavailableError,
    RequestCancelledError,
    RequestTimeoutError,
)

__all__ = [
    "DeploymentHandle",
    "DeploymentResponse",
    "RayServeException",
    "BackPressureError",
    "ReplicaUnavailableError",
    "RequestCancelledError",
    "RequestTimeoutError",
]

def _default_request_ft() -> dict:
    """Router-side FT policy before the first routing info arrives —
    derived from DeploymentConfig so the two layers cannot drift."""
    from ray_tpu_torch.serve.config import DeploymentConfig

    return DeploymentConfig().request_ft()


DEFAULT_REQUEST_FT = _default_request_ft()

#: retry backoff: base * 2^(attempt-1) seconds, jittered ±50%, capped
_BACKOFF_BASE_S = 0.025
_BACKOFF_CAP_S = 1.0

#: membership wait when no deadline bounds the request (the old
#: hardcoded 30s/35s pair, now in one place and overridden by
#: request_timeout_s when configured)
_DEFAULT_MEMBERSHIP_WAIT_S = 30.0


def _core():
    from ray_tpu_torch.core.api import get_core

    return get_core()


def _on_core_loop() -> bool:
    core = _core()
    try:
        return asyncio.get_running_loop() is core.loop
    except RuntimeError:
        return False


def _retry_backoff_s(attempt: int) -> float:
    """Exponential backoff with jitter (attempt counts from 1)."""
    base = min(_BACKOFF_CAP_S, _BACKOFF_BASE_S * (2 ** (attempt - 1)))
    return base * random.uniform(0.5, 1.5)


def _serve_span_sink(core):
    """Router span rows ride the driver's task-event flush."""
    def sink(s):
        core.task_events.emit(name=s["name"], state="SPAN", span=s)
    return sink


def _trace_mod():
    """The tracing module when tracing is on, else None (one gate)."""
    from ray_tpu_torch.utils import tracing

    return tracing if tracing.enabled() else None


class _Router:
    """Shared per-(app, deployment) routing state; thread-safe because
    .remote() may be called from the driver thread or any actor loop."""

    def __init__(self, app_name: str, deployment_name: str):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self.version = -1
        self.replicas: list[dict] = []  # {replica_id, actor_name}
        self.handles: dict[str, object] = {}  # replica_id -> ActorHandle
        self.inflight: dict[str, int] = {}
        # replica-reported ongoing counts (cross-caller load visibility —
        # ref: pow_2_router.py:52 queue-len probing): refreshed by a
        # background probe loop; local inflight alone is blind to OTHER
        # callers' requests. inflight_at_probe remembers how much of the
        # reported count was OURS, so scoring doesn't double-count it.
        self.remote_ongoing: dict[str, int] = {}
        self.inflight_at_probe: dict[str, int] = {}
        # deployment-reported load (__serve_load__ probe field, in
        # ongoing-request equivalents): decode-plane pressure — the
        # disagg LLM scheduler's tokens-in-flight — folded into the
        # pow-2 score so the router admits on the decode signal, not
        # on request counts alone
        self.replica_load: dict[str, float] = {}
        # fast-lane bindings per replica (serve/dataplane/fastlane.py):
        # same-node replicas ride the actor shm ring, per-call RPC
        # fallback; dropped with the replica's other routing state
        self.lanes: dict[str, ReplicaLane] = {}
        # handle-side projected-delay admission (dataplane/admission.py):
        # per-replica drain-rate view refreshed by the probe loop
        self.admission: dict[str, AdmissionController] = {}
        self.replica_queued: dict[str, int] = {}
        self.admission_shed = 0  # requests refused at the proxy
        self.rpc_routed = 0  # dispatches that took the actor RPC plane
        # resident multiplexed models per replica (affinity routing)
        self.models: dict[str, list] = {}
        # per-deployment request-FT policy, refreshed with routing info
        self.ft: dict = dict(DEFAULT_REQUEST_FT)
        self._last_request_ts = 0.0
        self._probe_generation = 0
        self.lock = threading.Lock()
        self._poll_started = False
        self._stopped = False
        self._controller_handle = None
        self._router_id = f"router-{id(self):x}-{random.getrandbits(32):08x}"
        self._req_counter = itertools.count(1)
        self._waiting = 0  # requests blocked on empty membership
        self._death_core = None  # CoreClient the death listener is bound to
        self._ft_loaded = False  # True once request_ft arrived from the controller

    # ----------------------------------------------------------- membership
    async def _controller(self):
        if self._controller_handle is None:
            self._controller_handle = await _core().get_actor_by_name_async(
                CONTROLLER_NAME
            )
            if self._controller_handle is None:
                raise RayServeException("Serve controller is not running")
        return self._controller_handle

    async def _refresh_once(self, known_version: int, long_poll_s: float):
        core = _core()
        controller = await self._controller()
        ref = controller.get_routing_info.remote(
            self.app_name, self.deployment_name, known_version, long_poll_s
        )
        (info,) = await core.get_async([ref], long_poll_s + 15.0)
        with self.lock:
            self._apply(info)

    def _apply(self, info: dict):
        self.version = info["version"]
        self.replicas = info["replicas"]
        ft = info.get("request_ft")
        if ft:
            self.ft = {**DEFAULT_REQUEST_FT, **ft}
            self._ft_loaded = True
        live = {r["replica_id"] for r in self.replicas}
        for rid in list(self.handles):
            if rid not in live:
                self.handles.pop(rid, None)
                self.inflight.pop(rid, None)
                self.remote_ongoing.pop(rid, None)
                self.inflight_at_probe.pop(rid, None)
                self.models.pop(rid, None)
                self.lanes.pop(rid, None)
                self.admission.pop(rid, None)
                self.replica_queued.pop(rid, None)
                self.replica_load.pop(rid, None)

    # ------------------------------------------------- fast death detection
    def _ensure_death_listener(self, core):
        """Subscribe to the core actor-death pubsub (the GCS publishes
        DEAD on every actor channel the client follows): a killed replica
        leaves the routing table in ~one raylet reap tick (~0.2s) instead
        of waiting out a health-check period or the next long-poll."""
        if self._death_core is core:
            return
        core.add_actor_death_listener(self._on_actor_death)
        self._death_core = core

    def _on_actor_death(self, actor_id, info):
        with self.lock:
            rid = None
            for r, h in self.handles.items():
                if getattr(h, "actor_id", None) == actor_id:
                    rid = r
                    break
            if rid is None:
                return
            self.replicas = [r for r in self.replicas
                             if r["replica_id"] != rid]
            for d in (self.handles, self.inflight, self.remote_ongoing,
                      self.inflight_at_probe, self.models, self.lanes,
                      self.admission, self.replica_queued,
                      self.replica_load):
                d.pop(rid, None)

    def _ensure_poll_loop(self):
        """Background long-poll keeping membership fresh (the LongPollClient
        role, ref: long_poll.py LongPollClient) plus a queue-depth probe
        loop for cross-caller load visibility."""
        core = _core()
        self._ensure_death_listener(core)
        with self.lock:
            self._last_request_ts = time.monotonic()
            if self._poll_started:
                return
            self._poll_started = True
            self._probe_generation += 1
            gen = self._probe_generation

        async def poll():
            failures = 0
            while not self._stopped and self._probe_generation == gen:
                try:
                    await self._refresh_once(self.version, 10.0)
                    failures = 0
                except RayServeException:
                    # controller gone (serve.shutdown): stop polling; a
                    # later request restarts the loop
                    break
                except Exception:
                    failures += 1
                    if failures >= 20:
                        break
                    await asyncio.sleep(_retry_backoff_s(failures))
            with self.lock:
                if self._probe_generation == gen:
                    self._poll_started = False
            self._controller_handle = None

        async def probe_queue_lens():
            """Refresh replica-side ongoing counts so pow-2 sees load from
            EVERY caller (ref: pow_2_router.py queue-len probes). Probes
            run concurrently with a short timeout, pause when the handle
            has been idle, and die with their generation (a restarted
            membership poll starts a fresh pair — no loop accumulation)."""
            core = _core()
            while not self._stopped and self._probe_generation == gen:
                with self.lock:
                    reps = list(self.replicas)
                    idle = time.monotonic() - self._last_request_ts > 2.0
                    alive = self._poll_started
                if not alive:
                    break
                if idle or not reps:
                    await asyncio.sleep(0.2)  # no traffic: no probe RPCs
                    continue

                async def probe_one(r):
                    rid = r["replica_id"]
                    with self.lock:
                        actor = self.handles.get(rid)
                    if actor is None:
                        try:
                            actor = await core.get_actor_by_name_async(
                                r["actor_name"])
                        except Exception:
                            return
                        if actor is None:
                            return
                        with self.lock:
                            self.handles[rid] = actor
                    try:
                        with self.lock:
                            local_now = self.inflight.get(rid, 0)
                        # unordered: a metrics probe must never park at
                        # the fast->RPC drain barrier behind in-flight
                        # ring traffic (it would stall the whole pump)
                        ref = core.submit_actor_task(
                            actor, "get_metrics", (), {}, unordered=True)
                        (m,) = await core.get_async([ref], 1.0)
                        with self.lock:
                            self.remote_ongoing[rid] = int(m.get("ongoing", 0))
                            self.replica_load[rid] = float(
                                m.get("user_load", 0.0))
                            self.inflight_at_probe[rid] = local_now
                            self.models[rid] = list(m.get("models", ()))
                            # drain-rate view for proxy-side admission
                            self.replica_queued[rid] = int(m.get("queued", 0))
                            exec_ms = float(m.get("exec_ewma_ms", 0.0))
                            ctrl = self.admission.get(rid)
                            if ctrl is None:
                                ctrl = self.admission[rid] = (
                                    AdmissionController(1))
                            # refreshed per probe, not frozen at first
                            # sight: a redeploy can change the cap, and
                            # the first probe may race the FT fetch
                            ctrl.max_ongoing = max(1, int(self.ft.get(
                                "max_ongoing_requests", 8) or 8))
                            ctrl.exec_ewma_s = exec_ms / 1e3
                    except Exception:  # raylint: disable=RT012 — replica mid-restart: keep the stale value
                        pass

                await asyncio.gather(*[probe_one(r) for r in reps])
                await asyncio.sleep(0.15)

        core._call_on_loop(poll())
        core._call_on_loop(probe_queue_lens())

    def stop(self):
        self._stopped = True
        core, self._death_core = self._death_core, None
        if core is not None:
            core.remove_actor_death_listener(self._on_actor_death)

    async def _ensure_ft(self):
        """The first request on a fresh router must see the deployment's
        FT policy (deadline, retry_on) BEFORE routing decisions are made,
        not after the background long-poll happens to land; one immediate
        fetch, then the poll loop keeps it fresh."""
        if self._ft_loaded:
            return
        try:
            await self._refresh_once(-1, 0.0)
        except Exception:  # raylint: disable=RT012 — controller slow/missing: defaults apply; routing surfaces the real error
            pass
        self._ft_loaded = True  # one attempt per router, never per request

    # ------------------------------------------------------------ deadlines
    def _compute_deadline(self, inherited: float | None = None) -> float | None:
        """Absolute monotonic deadline for a new request: the configured
        request_timeout_s, clamped to any budget inherited from the
        composing deployment's active request (serve/context.py).
        ``inherited`` overrides the contextvar read — route_sync captures
        it on the CALLING thread, because by the time the coroutine runs
        on the core loop the caller's context is gone."""
        t = self.ft.get("request_timeout_s")
        deadline = None if t is None else time.monotonic() + float(t)
        if inherited is None:
            inherited = serve_context.current_deadline()
        if inherited is not None:
            deadline = inherited if deadline is None else min(deadline, inherited)
        return deadline

    def _membership_wait_s(self, deadline: float | None) -> float:
        """How long a request may park waiting for replicas: the caller's
        remaining deadline, else the configured request timeout, else the
        legacy 30s default (the old hardcoded fut.result(35.0) pair)."""
        if deadline is not None:
            return max(0.05, deadline - time.monotonic())
        t = self.ft.get("request_timeout_s")
        return float(t) if t else _DEFAULT_MEMBERSHIP_WAIT_S

    def _idempotent(self, method: str) -> bool:
        retry_on = self.ft.get("retry_on") or ()
        return "*" in retry_on or method in retry_on

    async def _wait_for_replicas(self, timeout_s: float | None = None):
        if timeout_s is None:
            timeout_s = _DEFAULT_MEMBERSHIP_WAIT_S
        maxq = int(self.ft.get("max_queued_requests", -1))
        if maxq >= 0 and self._waiting >= maxq:
            # router-side backpressure: refuse instead of parking demand
            # without bound (the replica-side cap's handle-side twin)
            raise BackPressureError(
                f"router queue full: {self._waiting} requests already "
                f"waiting for replicas of "
                f"{self.app_name}/{self.deployment_name}")
        deadline = time.monotonic() + timeout_s
        self._waiting += 1
        refresh_failures = 0
        try:
            while time.monotonic() < deadline:
                with self.lock:
                    if self.replicas:
                        return
                # report unplaceable demand: the scale-from-zero signal
                try:
                    controller = await self._controller()
                    # best-effort telemetry: the autoscaler treats a lost
                    # sample as stale demand, never as an error
                    controller.report_handle_queued.remote(  # raylint: disable=RT003
                        self.app_name, self.deployment_name,
                        self._router_id, self._waiting,
                    )
                except Exception:  # raylint: disable=RT012 — telemetry: a lost sample reads as stale demand
                    pass
                try:
                    await self._refresh_once(self.version, 1.0)
                    refresh_failures = 0
                except Exception:
                    refresh_failures += 1
                    await asyncio.sleep(_retry_backoff_s(refresh_failures))
            err = ReplicaUnavailableError(
                f"no ready replicas for {self.app_name}/{self.deployment_name} "
                f"within {timeout_s:.1f}s")
            # membership wait consumed its whole budget: the retry loop
            # must not re-wait it
            err.exhausted = True
            raise err
        finally:
            self._waiting -= 1
            if self._waiting == 0:
                try:
                    controller = await self._controller()
                    # best-effort: clearing the queued-demand gauge may race
                    # with shutdown; the controller expires stale reports
                    controller.report_handle_queued.remote(  # raylint: disable=RT003
                        self.app_name, self.deployment_name, self._router_id, 0
                    )
                except Exception:  # raylint: disable=RT012 — racing shutdown: stale reports expire server-side
                    pass

    # -------------------------------------------------------------- routing
    def _choose(self, model_id: str = "", exclude: set | None = None,
                hint: str = "") -> dict | None:
        """Power-of-two-choices over replica queue depth (ref:
        pow_2_router.py:52): the score combines the replica's REPORTED
        ongoing count (covers other callers) with this caller's local
        in-flight count (covers requests the probe hasn't seen yet).

        ``exclude`` drops replicas that already failed this request (the
        retry loop's exclude-and-replay); when every replica is excluded
        the full set is used again — retrying the survivor beats failing
        a request a recovered replica could serve.

        With a multiplexed ``model_id``, replicas already holding the
        model shadow the rest (ref: multiplex routing affinity) — a cache
        hit beats a shorter queue; the pow-2 tie-break still applies
        within the holding set.

        A ``hint`` (``options(routing_hint=...)``) switches to rendezvous
        hashing over the surviving replica set: every caller holding the
        same hint picks the same replica — the affinity signal for
        replica-LOCAL state like the disagg prefix cache, where a cache
        hit saves recompute but only on the replica holding the pages.
        Exclusion still applies first, so a dead/failed replica falls
        back to the next-highest-weight one deterministically."""
        with self.lock:
            reps = list(self.replicas)
            if exclude:
                kept = [r for r in reps if r["replica_id"] not in exclude]
                if kept:
                    reps = kept
            if not reps:
                return None
            if model_id:
                holding = [r for r in reps
                           if model_id in self.models.get(
                               r["replica_id"], ())]
                if holding:
                    reps = holding
            if hint:
                import hashlib

                def weight(r):
                    return hashlib.blake2b(
                        f"{hint}|{r['replica_id']}".encode(),
                        digest_size=8).digest()

                return max(reps, key=weight)
            if len(reps) == 1:
                return reps[0]
            a, b = random.sample(reps, 2)

            def score(r):
                # remote count minus the share that was OURS at probe time
                # (it is already in `inflight`), plus current local
                # inflight, plus the deployment's own probed load signal
                # (__serve_load__ — decode tokens-in-flight for the
                # disagg LLM deployment)
                rid = r["replica_id"]
                others = max(0, self.remote_ongoing.get(rid, 0)
                             - self.inflight_at_probe.get(rid, 0))
                return (others + self.inflight.get(rid, 0)
                        + self.replica_load.get(rid, 0.0))

            return a if score(a) <= score(b) else b

    async def _actor_for(self, chosen: dict):
        rid = chosen["replica_id"]
        with self.lock:
            actor = self.handles.get(rid)
        if actor is not None:
            return actor
        actor = await _core().get_actor_by_name_async(chosen["actor_name"])
        if actor is None:
            return None
        with self.lock:
            self.handles[rid] = actor
        return actor

    async def _pick_replica(self, model_id: str, exclude: set,
                            deadline: float | None,
                            hint: str = "") -> tuple[str, object]:
        chosen = self._choose(model_id, exclude, hint)
        if chosen is None:
            await self._wait_for_replicas(self._membership_wait_s(deadline))
            chosen = self._choose(model_id, exclude, hint)
            if chosen is None:
                raise ReplicaUnavailableError(
                    f"no replicas available for "
                    f"{self.app_name}/{self.deployment_name}")
        actor = await self._actor_for(chosen)
        if actor is None:
            raise ReplicaUnavailableError(
                f"replica actor {chosen['actor_name']} gone")
        return chosen["replica_id"], actor

    def _lane_for(self, rid: str, actor) -> ReplicaLane:
        with self.lock:
            lane = self.lanes.get(rid)
            if lane is None or lane.actor_id != actor.actor_id:
                lane = self.lanes[rid] = ReplicaLane(actor.actor_id)
        return lane

    def lane_stats(self) -> dict:
        """Fast-lane vs RPC routing counters + proxy-side sheds (tests
        and bench prove the ring actually carried traffic with these)."""
        with self.lock:
            return {
                "fast_calls": sum(l.fast_calls for l in self.lanes.values()),
                "rpc_calls": self.rpc_routed,
                "admission_shed": self.admission_shed,
                "fast_streams": sum(l.fast_streams
                                    for l in self.lanes.values()),
                "rpc_streams": sum(l.rpc_streams
                                   for l in self.lanes.values()),
            }

    def _admission_shed_check(self, deadline: float | None, exclude: set):
        """Proxy-side projected-delay admission: refuse (typed, the
        proxies' existing 429/RESOURCE_EXHAUSTED mapping applies) when
        EVERY candidate replica's projected queue delay — probed queue
        depth over its probed drain rate — already exceeds the request's
        remaining deadline. One replica with headroom (or no drain data
        yet) admits; the replica-side check remains the precise gate."""
        if deadline is None:
            return
        remaining = deadline - time.monotonic()
        best = None
        with self.lock:
            rids = [r["replica_id"] for r in self.replicas]
            if exclude:
                kept = [r for r in rids if r not in exclude]
                if kept:
                    rids = kept
            if not rids:
                return  # membership wait owns this case
            for rid in rids:
                ctrl = self.admission.get(rid)
                if ctrl is None or ctrl.exec_ewma_s <= 0.0:
                    return  # no drain data: cannot justify a shed
                # probed queue depth covers every caller AT probe time
                # (including our own inflight then); only our requests
                # dispatched SINCE the probe are unseen — adding raw
                # inflight would double-count (the same subtraction the
                # pow-2 score makes)
                queued = (self.replica_queued.get(rid, 0)
                          + max(0, self.inflight.get(rid, 0)
                                - self.inflight_at_probe.get(rid, 0)))
                delay = ctrl.projected_delay_s(queued)
                best = delay if best is None else min(best, delay)
        if best is not None and best > max(0.0, remaining):
            self.admission_shed += 1
            raise BackPressureError(
                f"projected queue delay {best:.3f}s on every replica of "
                f"{self.app_name}/{self.deployment_name} exceeds the "
                f"remaining deadline ({max(0.0, remaining):.3f}s)",
                retry_after_s=best)

    async def _call_replica(self, rid: str, actor, method: str, args: tuple,
                            kwargs: dict, model_id: str,
                            deadline: float | None, request_id: str):
        """One attempt on one replica: dispatch + await, bounded by the
        remaining deadline; the replica receives the remaining budget so
        it can shed the request if it expires while queued.

        Dispatch rides the actor shm ring when the replica is same-node
        and the lane is live (serve/dataplane/fastlane.py) — the reply
        resolves straight into this coroutine; anything the ring cannot
        carry takes the actor RPC plane for THIS call only, marked
        unordered so neither path ever parks behind the other.

        When the request is sampled, the attempt runs inside an
        ``attempt::<rid>`` child span — a HEDGE loser's cancellation
        lands in that span's ``error`` field, so a hedged request's
        trace shows exactly which copy won and which was shed."""
        core = _core()
        if getattr(core, "_trace_on", False):
            from ray_tpu_torch.utils import tracing

            cur = tracing.current()
            if cur is not None:
                with tracing.span(
                        f"attempt::{rid}",
                        {"trace_id": cur[0], "parent_span_id": cur[1]},
                        _serve_span_sink(core), stage="wire",
                        replica=rid):
                    return await self._call_replica_inner(
                        core, rid, actor, method, args, kwargs, model_id,
                        deadline, request_id)
        return await self._call_replica_inner(
            core, rid, actor, method, args, kwargs, model_id, deadline,
            request_id)

    async def _call_replica_inner(self, core, rid: str, actor, method: str,
                                  args: tuple, kwargs: dict, model_id: str,
                                  deadline: float | None, request_id: str):
        from ray_tpu_torch.core.ref import GetTimeoutError
        timeout_s = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        with self.lock:
            self.inflight[rid] = self.inflight.get(rid, 0) + 1
        try:
            call_args = (method, args, kwargs, model_id, timeout_s,
                         request_id)
            try:
                from ray_tpu_torch.core.core_client import FastLaneDeclined

                wait_s = (None if deadline is None
                          else max(0.05, deadline - time.monotonic()))
                if fastlane_enabled():
                    lane = self._lane_for(rid, actor)
                    out = lane.submit(core, call_args)
                    if out is not None:
                        try:
                            return await core.fast_actor_await(
                                out[0], out[1], wait_s)
                        except FastLaneDeclined:
                            # worker's method table went stale: never
                            # executed — re-dispatch THIS call over RPC
                            # (and un-count it from the ring: fast_calls
                            # is the "traffic actually rode the lane"
                            # evidence bench/tests assert on)
                            lane.fast_calls -= 1
                            lane.rpc_calls += 1
                self.rpc_routed += 1
                ref = core.submit_actor_task(
                    actor, "handle_request", call_args, {}, unordered=True)
                (result,) = await core.get_async([ref], wait_s)
            except GetTimeoutError:
                raise RequestTimeoutError(
                    f"request deadline exceeded waiting on replica {rid} "
                    f"of {self.app_name}/{self.deployment_name}") from None
            return result
        finally:
            with self.lock:
                if self.inflight.get(rid, 0) > 0:
                    self.inflight[rid] -= 1

    def _cancel_loser(self, task: asyncio.Task, rid: str, request_id: str):
        """The winner returned: stop awaiting the loser and ask its
        replica to shed the copy if it has not started executing."""
        if task.done():
            return
        task.cancel()
        with self.lock:
            actor = self.handles.get(rid)
        if actor is not None:
            try:
                # unordered: the shed marker must OVERTAKE the loser's
                # own in-flight ring record — an ordered RPC would park
                # at the fast->RPC drain barrier behind it and arrive
                # after the copy it is meant to cancel already ran
                _core().submit_actor_task(  # raylint: disable=RT003 — best-effort shed; the loser's result is discarded either way
                    actor, "cancel_request", (request_id,), {},
                    unordered=True)
            except Exception:  # raylint: disable=RT012 — replica may be gone; its copy dies with it
                pass

    async def _dispatch(self, rid: str, actor, method: str, args: tuple,
                        kwargs: dict, model_id: str, deadline: float | None,
                        request_id: str, hedgeable: bool, exclude: set):
        """One logical attempt, with optional hedging: if the primary has
        not answered within hedge_after_ms, mirror the request to a
        different replica and take the first result (The Tail at Scale's
        hedged request), cancelling the loser."""
        hedge_ms = float(self.ft.get("hedge_after_ms") or 0.0)
        if hedge_ms <= 0 or not hedgeable:
            # no hedge race possible: skip the per-request Task allocation
            return await self._call_replica(
                rid, actor, method, args, kwargs, model_id, deadline,
                request_id)
        loop = asyncio.get_running_loop()
        primary = loop.create_task(self._call_replica(
            rid, actor, method, args, kwargs, model_id, deadline, request_id))
        # race the primary against the hedge timer with ONE bare future +
        # call_later instead of wait_for(shield(...)): that stack built
        # two wrapper futures and timeout machinery per request, and at
        # serve QPS the hedge arm is on every request while the hedge
        # itself almost never fires
        waiter = loop.create_future()
        primary.add_done_callback(
            lambda t: waiter.done() or waiter.set_result(True))
        timer = loop.call_later(
            hedge_ms / 1e3,
            lambda: waiter.done() or waiter.set_result(False))
        try:
            primary_first = await waiter
        finally:
            timer.cancel()
        if primary_first:
            return primary.result()  # raises the attempt's error, as before
        alt = self._choose(model_id, exclude | {rid})
        if alt is None or alt["replica_id"] == rid:
            return await primary  # nowhere else to hedge
        actor2 = await self._actor_for(alt)
        if actor2 is None:
            return await primary
        rid2 = alt["replica_id"]
        hedge = loop.create_task(self._call_replica(
            rid2, actor2, method, args, kwargs, model_id, deadline,
            request_id))
        pending = {primary, hedge}
        first_err = None
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    if t.exception() is None:
                        return t.result()
                    if first_err is None:
                        first_err = t.exception()
            # both copies failed: tell the retry loop EVERY replica this
            # logical attempt burned, so the next attempt excludes the
            # hedge target too, not just the primary
            first_err._rt_attempted = (rid, rid2)
            raise first_err
        finally:
            for t, t_rid in ((primary, rid), (hedge, rid2)):
                if not t.done():
                    self._cancel_loser(t, t_rid, request_id)

    def _trace_root(self, method: str):
        """Root span for one serve request when tracing is on and the
        request is sampled (head-based: the decision is made HERE, where
        the trace starts; composed handle calls inherit the caller's
        sampled context instead of re-deciding). None = unsampled."""
        from ray_tpu_torch.utils import tracing

        if not tracing.enabled():
            return None
        if tracing.is_suppressed():
            return None  # a composed call inside an unsampled request
        parent = tracing.current()
        if parent is None and not tracing.sample():
            return None
        ctx = (None if parent is None
               else {"trace_id": parent[0], "parent_span_id": parent[1]})
        return tracing.span(
            f"serve::{self.app_name}/{self.deployment_name}.{method}",
            ctx, _serve_span_sink(_core()), stage="wire")

    async def route_async(self, method: str, args: tuple, kwargs: dict,
                          model_id: str = "", hint: str = "",
                          _inherited_deadline: float | None = None):
        """Loop-thread path: full async routing with the retry/deadline/
        hedge machinery; returns the result.

        A sampled request runs inside a ROOT span that survives retries
        and hedges (one request = one trace, whatever replays happened
        inside it), and its request_id IS the trace id — the id in the
        serving logs is the id you hand to ``state.get_trace()``."""
        self._ensure_poll_loop()
        await self._ensure_ft()
        deadline = self._compute_deadline(_inherited_deadline)
        root = self._trace_root(method)
        if root is None:
            request_id = f"{self._router_id}-{next(self._req_counter)}"
            if _trace_mod() is not None:
                # head decision is per REQUEST: suppress downstream
                # re-draws (a replica-hop submit re-sampling would mint
                # orphan partial traces for "unsampled" requests)
                tok = _trace_mod().suppress()
                try:
                    return await self._route_attempts(
                        method, args, kwargs, model_id, hint, deadline,
                        request_id)
                finally:
                    _trace_mod().deactivate(tok)
            return await self._route_attempts(
                method, args, kwargs, model_id, hint, deadline, request_id)
        with root:
            # the trace-STARTING request's id IS the trace id (the id in
            # the serving logs is the id you hand to state.get_trace);
            # a COMPOSED call inside that trace gets a root-span-scoped
            # suffix — two downstream calls sharing one trace must not
            # share a request_id (replica-side cancel marks key on it)
            rid = (root.trace_id if root.parent_span_id is None
                   else f"{root.trace_id}.{root.span_id}")
            root.attributes["request_id"] = rid
            return await self._route_attempts(
                method, args, kwargs, model_id, hint, deadline, rid)

    async def _route_attempts(self, method: str, args: tuple, kwargs: dict,
                              model_id: str, hint: str,
                              deadline: float | None, request_id: str):
        excluded: set[str] = set()
        attempt = 0
        while True:
            if deadline is not None and time.monotonic() >= deadline:
                raise RequestTimeoutError(
                    f"request deadline exceeded after {attempt} attempt(s) "
                    f"for {self.app_name}/{self.deployment_name}.{method}")
            rid = None
            # re-read per attempt: the poll loop may deliver the policy
            # (or a redeploy may change it) between attempts
            idempotent = self._idempotent(method)
            try:
                self._admission_shed_check(deadline, excluded)
                rid, actor = await self._pick_replica(
                    model_id, excluded, deadline, hint)
                return await self._dispatch(
                    rid, actor, method, args, kwargs, model_id, deadline,
                    request_id, hedgeable=idempotent, exclude=excluded)
            except RequestTimeoutError:
                raise  # the deadline is total budget, never per-attempt
            except (BackPressureError, ReplicaUnavailableError) as e:
                # never dispatched (or provably refused before execution):
                # safe to retry elsewhere for every method
                if getattr(e, "exhausted", False):
                    raise  # membership wait already consumed the budget
                err = e
            except Exception as e:
                # ambiguous: the replica may have executed (or begun to).
                # Replay only idempotent methods, and only on the failure
                # types that mean "replica gone", never app errors.
                if not (idempotent and _is_replica_failure(e)):
                    raise
                err = e
            attempt += 1
            if attempt > int(self.ft.get("max_request_retries", 3)):
                raise err
            attempted = getattr(err, "_rt_attempted", None)
            if attempted:  # a failed hedge burned two replicas, not one
                excluded.update(a for a in attempted if a)
            elif rid is not None:
                excluded.add(rid)
            backoff = _retry_backoff_s(attempt)
            if deadline is not None:
                backoff = min(backoff,
                              max(0.0, deadline - time.monotonic()))
            await asyncio.sleep(backoff)

    def route_sync(self, method: str, args: tuple, kwargs: dict,
                   model_id: str = "", hint: str = ""):
        """Driver-thread path: returns an ObjectRef immediately; the
        retry/deadline/hedge machinery runs on the core loop behind a
        promise ref the caller gets/waits like any task result (this is
        what lets a replayed request stay ONE ref for the caller)."""
        core = _core()
        ref, resolve = core.create_promise_ref()
        # read the composed-request deadline HERE, on the calling thread
        # (a replica pool thread for sync methods): the coroutine below
        # runs on the core loop in a different context where the
        # contextvar is invisible
        inherited = serve_context.current_deadline()

        async def run():
            try:
                resolve(value=await self.route_async(
                    method, args, kwargs, model_id, hint,
                    _inherited_deadline=inherited))
            except BaseException as e:
                resolve(error=e if isinstance(e, Exception)
                        else RayServeException(repr(e)))

        core._call_on_loop(run())
        return ref

    def route_streaming(self, method: str, args: tuple, kwargs: dict):
        """Stream a request from the DRIVER thread: yields one ObjectRef
        per item. The replica's in-flight count stays raised for the
        stream's whole life so pow-2 routing sees streaming load.
        Streams are never replayed mid-flight (consumed items would
        duplicate); only initial routing is fault-tolerant."""
        import ray_tpu_torch

        self._ensure_poll_loop()
        if not self._ft_loaded:
            # streaming membership waits derive from the FT policy too
            core = _core()
            asyncio.run_coroutine_threadsafe(
                self._ensure_ft(), core.loop).result(20.0)
        chosen = self._choose()
        if chosen is None:
            core = _core()
            wait_s = self._membership_wait_s(self._compute_deadline())
            fut = asyncio.run_coroutine_threadsafe(
                self._wait_for_replicas(wait_s), core.loop)
            fut.result(wait_s + 5.0)
            chosen = self._choose()
            if chosen is None:
                raise ReplicaUnavailableError("no replicas available")
        rid = chosen["replica_id"]
        with self.lock:
            actor = self.handles.get(rid)
        if actor is None:
            actor = ray_tpu_torch.get_actor(chosen["actor_name"])
            with self.lock:
                self.handles[rid] = actor
        gen = actor.handle_request_streaming.options(
            num_returns="streaming").remote(method, args, kwargs)
        return self._count_stream(rid, gen)

    def _count_stream(self, rid: str, gen):
        with self.lock:
            self.inflight[rid] = self.inflight.get(rid, 0) + 1
        try:
            yield from gen
        finally:
            with self.lock:
                if self.inflight.get(rid, 0) > 0:
                    self.inflight[rid] -= 1

    async def route_streaming_async(self, method: str, args: tuple,
                                    kwargs: dict):
        """Loop-thread variant (composing deployments): async generator of
        ObjectRefs; never blocks the core loop waiting for membership."""
        self._ensure_poll_loop()
        await self._ensure_ft()
        if self._choose() is None:
            await self._wait_for_replicas(
                self._membership_wait_s(self._compute_deadline()))
        chosen = self._choose()
        if chosen is None:
            raise ReplicaUnavailableError("no replicas available")
        rid = chosen["replica_id"]
        actor = await self._actor_for(chosen)
        if actor is None:
            raise ReplicaUnavailableError(
                f"replica actor {chosen['actor_name']} gone")
        gen = actor.handle_request_streaming.options(
            num_returns="streaming").remote(method, args, kwargs)
        with self.lock:
            self.inflight[rid] = self.inflight.get(rid, 0) + 1
        try:
            async for ref in gen:
                yield ref
        finally:
            with self.lock:
                if self.inflight.get(rid, 0) > 0:
                    self.inflight[rid] -= 1

    async def route_stream_chunks(self, method: str, args: tuple,
                                  kwargs: dict, model_id: str = "",
                                  hint: str = "",
                                  _inherited_deadline: float | None = None):
        """Streaming fast path (wire 2.3): async generator of CHUNK VALUES.

        Dispatch rides the replica's fast lane as one "G"-chunked stream
        (``ReplicaLane.submit_stream``) — per yielded item the worker pump
        flushes one chunk record onto the same ring/tunnel the unary
        calls use, and this coroutine consumes them through
        ``CoreClient.fast_actor_stream``. No per-item ObjectRef,
        memory-store entry, or task event. A NEED_SLOW decline (stale
        worker method table — provably before execution) re-dispatches
        the WHOLE stream over the per-item ObjectRef plane on the same
        replica.

        Fault contract: only initial routing is fault-tolerant. Once a
        chunk has been consumed the stream is never replayed — a lane or
        replica death surfaces as :class:`StreamBrokenError` carrying the
        consumed count. Early consumer exit (``aclose`` / GC / HTTP
        disconnect) cancels replica-side: the ring path abandons the pump
        (the wrapper's GeneratorExit frees the decode slot), and a
        best-effort unordered ``cancel_request`` sheds a still-queued
        stream before user code runs."""
        from ray_tpu_torch.core.core_client import FastLaneDeclined
        from ray_tpu_torch.core.ref import GetTimeoutError
        from ray_tpu_torch.serve.streaming import StreamBrokenError

        self._ensure_poll_loop()
        await self._ensure_ft()
        core = _core()
        deadline = self._compute_deadline(_inherited_deadline)
        request_id = f"{self._router_id}-{next(self._req_counter)}"
        self._admission_shed_check(deadline, set())
        rid, actor = await self._pick_replica(model_id, set(), deadline, hint)
        timeout_s = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        wait_s = (None if deadline is None
                  else max(0.05, deadline - time.monotonic()))
        call_args = (method, args, kwargs, model_id, timeout_s, request_id)
        with self.lock:
            self.inflight[rid] = self.inflight.get(rid, 0) + 1
        consumed = 0
        completed = False
        lane = None
        try:
            out = None
            if fastlane_enabled():
                lane = self._lane_for(rid, actor)
                out = lane.submit_stream(core, call_args)
            if out is not None:
                task_id, sink = out
                agen = core.fast_actor_stream(task_id, sink, wait_s)
                try:
                    try:
                        async for item in agen:
                            consumed += 1
                            yield item
                        completed = True
                        return
                    except FastLaneDeclined:
                        # NEED_SLOW precedes execution: nothing consumed,
                        # nothing ran — safe to re-dispatch the whole
                        # stream over RPC (and un-count the ring stream:
                        # fast_streams is bench/test evidence)
                        lane.fast_streams -= 1
                        lane.rpc_streams += 1
                    except GetTimeoutError:
                        raise RequestTimeoutError(
                            f"stream deadline exceeded on replica {rid} of "
                            f"{self.app_name}/{self.deployment_name} after "
                            f"{consumed} chunk(s)") from None
                    except Exception as e:
                        if _is_replica_failure(e):
                            raise StreamBrokenError(
                                f"stream broke on replica {rid} of "
                                f"{self.app_name}/{self.deployment_name} "
                                f"after {consumed} chunk(s): {e}",
                                chunks_consumed=consumed) from e
                        raise
                finally:
                    await agen.aclose()
            # per-item ObjectRef fallback (no lane, ineligible args, or
            # NEED_SLOW decline) — same replica, same request_id, so the
            # replica-side admission/cancel machinery sees one request
            self.rpc_routed += 1
            gen = actor.handle_request_streaming.options(
                num_returns="streaming").remote(*call_args)
            try:
                async for ref in gen:
                    try:
                        (item,) = await core.get_async([ref], wait_s)
                    except GetTimeoutError:
                        raise RequestTimeoutError(
                            f"stream deadline exceeded on replica {rid} of "
                            f"{self.app_name}/{self.deployment_name} after "
                            f"{consumed} chunk(s)") from None
                    except Exception as e:
                        if consumed and _is_replica_failure(e):
                            raise StreamBrokenError(
                                f"stream broke on replica {rid} of "
                                f"{self.app_name}/{self.deployment_name} "
                                f"after {consumed} chunk(s): {e}",
                                chunks_consumed=consumed) from e
                        raise
                    consumed += 1
                    yield item
                completed = True
            finally:
                aclose = getattr(gen, "aclose", None)
                if aclose is not None:
                    await aclose()
        finally:
            if not completed:
                # abandoned or broken mid-flight: shed a still-queued
                # stream / stop an executing one at its next yield.
                # Unordered so the marker overtakes the stream's own
                # in-flight record (same reasoning as _cancel_loser).
                try:
                    core.submit_actor_task(  # raylint: disable=RT003 — best-effort cancel; the stream's remainder is discarded either way
                        actor, "cancel_request", (request_id,), {},
                        unordered=True)
                except Exception:  # raylint: disable=RT012 — replica may be gone; its stream died with it
                    pass
            with self.lock:
                if self.inflight.get(rid, 0) > 0:
                    self.inflight[rid] -= 1


def _is_replica_failure(e: Exception) -> bool:
    """True for failures that mean "the replica is gone", as opposed to
    an exception the user code raised (which must surface, never
    replay)."""
    from ray_tpu_torch.core.ref import ActorError, WorkerCrashedError
    from ray_tpu_torch.utils import rpc

    return isinstance(e, (ActorError, WorkerCrashedError, rpc.ConnectionLost))


_routers: dict[tuple[str, str], _Router] = {}
_routers_lock = threading.Lock()


def _router_for(app_name: str, deployment_name: str) -> _Router:
    key = (app_name, deployment_name)
    with _routers_lock:
        r = _routers.get(key)
        if r is None:
            r = _routers[key] = _Router(app_name, deployment_name)
        return r


class DeploymentResponse:
    """Awaitable returned by handle calls made on an event loop (async
    actors composing deployments); ref: serve/handle.py DeploymentResponse."""

    def __init__(self, router: _Router, method: str, args: tuple, kwargs: dict,
                 model_id: str = "", hint: str = ""):
        self._router = router
        self._method = method
        self._args = args
        self._kwargs = kwargs
        self._model_id = model_id
        self._hint = hint

    def __await__(self):
        return self._router.route_async(
            self._method, self._args, self._kwargs, self._model_id,
            self._hint).__await__()


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._method, args, kwargs)

    def stream(self, *args, **kwargs):
        """Call an async-generator deployment method; yields one ObjectRef
        per item (ref: serve streaming DeploymentResponseGenerator). From
        the driver: a sync generator; inside async actors: an async one."""
        router = _router_for(self._handle.app_name,
                             self._handle.deployment_name)
        if _on_core_loop():
            return router.route_streaming_async(self._method, args, kwargs)
        return router.route_streaming(self._method, args, kwargs)

    def stream_chunks(self, *args, **kwargs):
        """Streaming fast path (wire 2.3): returns a
        :class:`~ray_tpu_torch.serve.streaming.ServeStream` of chunk VALUES —
        items ride the replica's shm ring / node tunnel as "G" chunk
        records with no per-item ObjectRef; the per-item plane
        (:meth:`stream`) remains the wire-level fallback. Iterate
        ``async for`` on the core loop or plainly from the driver;
        ``close()``/``aclose()`` (or just dropping it) cancels
        mid-stream, freeing the replica's decode slot before the
        generation finishes."""
        from ray_tpu_torch.serve.streaming import ServeStream

        router = _router_for(self._handle.app_name,
                             self._handle.deployment_name)
        inherited = serve_context.current_deadline()
        agen = router.route_stream_chunks(
            self._method, args, kwargs,
            self._handle.multiplexed_model_id, self._handle.routing_hint,
            _inherited_deadline=inherited)
        return ServeStream(agen, core=_core())


class DeploymentHandle:
    """User-facing handle; composable across deployments (ref:
    serve/handle.py:633). From the driver, ``handle.method.remote(*a)``
    returns an ObjectRef for ray_tpu_torch.get; inside async actors it returns an
    awaitable DeploymentResponse. ``options(multiplexed_model_id=...)``
    tags requests for model-affinity routing (ref: multiplex.py)."""

    def __init__(self, deployment_name: str, app_name: str = "default",
                 multiplexed_model_id: str = "", routing_hint: str = ""):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self.multiplexed_model_id = multiplexed_model_id
        self.routing_hint = routing_hint

    def options(self, *, multiplexed_model_id: str | None = None,
                routing_hint: str | None = None) -> "DeploymentHandle":
        """Tagged copy of the handle. ``multiplexed_model_id`` routes to
        replicas already holding a multiplexed model;
        ``routing_hint`` rendezvous-routes every request carrying the
        same hint to the same replica (replica-local state affinity —
        e.g. ``disagg.prefix_hint(prompt_tokens)`` so a shared prompt
        prefix hits the replica whose cache holds its KV pages)."""
        return DeploymentHandle(
            self.deployment_name, self.app_name,
            self.multiplexed_model_id if multiplexed_model_id is None
            else multiplexed_model_id,
            self.routing_hint if routing_hint is None else routing_hint)

    def __getattr__(self, name: str) -> _MethodCaller:
        if name.startswith("_") or name in ("deployment_name", "app_name",
                                            "multiplexed_model_id",
                                            "routing_hint"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def remote(self, *args, **kwargs):
        return self._invoke("__call__", args, kwargs)

    def _invoke(self, method: str, args: tuple, kwargs: dict):
        router = _router_for(self.app_name, self.deployment_name)
        if _on_core_loop():
            return DeploymentResponse(router, method, args, kwargs,
                                      self.multiplexed_model_id,
                                      self.routing_hint)
        return router.route_sync(method, args, kwargs,
                                 self.multiplexed_model_id,
                                 self.routing_hint)

    def _stream(self, method: str, args: tuple, kwargs: dict):
        """Ingress-internal ``stream_chunks`` by method name (dunder
        names like ``__call__`` can't route through ``__getattr__``)."""
        return _MethodCaller(self, method).stream_chunks(*args, **kwargs)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name,
                 self.multiplexed_model_id, self.routing_hint))
