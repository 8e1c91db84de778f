"""SLO-feedback replica autoscaling with hysteresis.

Replaces the controller's memoryless ``ceil(total/target)`` policy,
which upscaled and downscaled on alternate reconcile ticks whenever load
sat near a threshold (the flap the ROADMAP called out). Three fixes, in
the shape Dean & Barroso's tail-at-scale argument asks for:

- **smoothed window**: decisions read the MEAN ongoing count over
  ``metrics_window_s``, not the instantaneous probe — a one-tick spike
  or trough moves the average by ``dt/window``, not to a new regime.
- **separate up/down thresholds** (hysteresis band): upscale targets
  per-replica load at ``target_ongoing_requests``; downscale only fires
  when the surviving replicas would sit at or under
  ``downscale_headroom × target`` — between the two bands the current
  count is stable by construction.
- **p99 vs SLO as the primary signal**: queue depth says how much work
  is waiting, the flight recorder's p99 says whether users are hurting.
  A p99 breach of ``latency_slo_ms`` upscales even at modest queue
  depth (slow replicas, co-located load); a downscale is FORBIDDEN
  while p99 sits above ``slo_downscale_ratio × slo`` no matter how
  shallow the queue — shedding capacity during a latency incident is
  how incidents become outages.

Plus cooldowns (a downscale needs ``cooldown_s`` of distance from the
last scale event of either direction; upscales stay responsive) and
scale-to-zero/scale-from-zero retained from the original policy — with
the measured **arrival rate** (EWMA over the replicas' lifetime request
counters) gating scale-TO-zero: while requests still flow, at least one
replica stays up even when the ongoing window reads empty between
probes.

Every fired decision is an :class:`AutoscaleDecision` carrying its cause
and the signal values that produced it — the controller publishes these
on the ``serve_autoscale`` pubsub channel and keeps a bounded history
for ``state``/dashboard.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

#: requests/s below which a deployment counts as idle for scale-TO-zero
#: (arrival rate's gating role; above it, at least one replica stays)
_ZERO_RATE_FLOOR = 0.1


@dataclasses.dataclass
class AutoscaleDecision:
    """One fired scale event, with the evidence that fired it."""

    key: str                 # "app/deployment"
    ts: float                # wall clock (time.time) — event streams sort
    from_replicas: int
    to_replicas: int
    cause: str               # p99_breach | queue_depth | queue_drain |
                             # idle | scale_from_zero
    ongoing_avg: float       # smoothed (ongoing + handle_queued) window mean
    arrival_rate: float      # requests/s EWMA across replicas
    p99_ms: float | None     # deployment p99 at decision time (None: no data)
    slo_ms: float | None     # the budget it was judged against

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _DeploymentWindow:
    __slots__ = ("samples", "last_total", "last_total_ts", "arrival_rate",
                 "pending_dir", "pending_since", "last_scale_ts")

    def __init__(self):
        self.samples: collections.deque = collections.deque()
        self.last_total: int | None = None   # lifetime request counter sum
        self.last_total_ts = 0.0
        self.arrival_rate = 0.0
        self.pending_dir = 0      # +1 / -1 while a decision is maturing
        self.pending_since = 0.0
        self.last_scale_ts = 0.0


class ServeAutoscaler:
    """One per controller; ``decide`` runs once per reconcile tick per
    deployment. Pure policy — it never touches actors, so tests drive it
    with synthetic clocks and signals."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._state: dict[str, _DeploymentWindow] = {}

    def forget(self, key: str) -> None:
        self._state.pop(key, None)

    def window(self, key: str) -> _DeploymentWindow:
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = _DeploymentWindow()
        return st

    # ------------------------------------------------------------- signals
    def _smooth(self, st: _DeploymentWindow, now: float, total: float,
                window_s: float) -> float:
        st.samples.append((now, total))
        cutoff = now - window_s
        while st.samples and st.samples[0][0] < cutoff:
            st.samples.popleft()
        return sum(v for _, v in st.samples) / len(st.samples)

    def _rate(self, st: _DeploymentWindow, now: float,
              lifetime_total: int | None) -> float:
        """Arrival rate EWMA from the replicas' lifetime request
        counters (completed-request throughput ~ arrival rate in steady
        state; survives replica restarts via max(0, delta))."""
        if lifetime_total is None:
            return st.arrival_rate
        if st.last_total is not None and now > st.last_total_ts:
            inst = max(0, lifetime_total - st.last_total) / (
                now - st.last_total_ts)
            st.arrival_rate += 0.3 * (inst - st.arrival_rate)
        st.last_total = lifetime_total
        st.last_total_ts = now
        return st.arrival_rate

    # ------------------------------------------------------------ decision
    def decide(self, key: str, *, current: int, auto, ongoing: float,
               handle_queued: float = 0.0, p99_ms: float | None = None,
               slo_ms: float | None = None,
               lifetime_total: int | None = None
               ) -> AutoscaleDecision | None:
        """Returns a fired decision (the caller applies + publishes it)
        or None. ``auto`` is the deployment's AutoscalingConfig."""
        st = self.window(key)
        now = self._clock()
        smoothed = self._smooth(st, now, ongoing + handle_queued,
                                auto.metrics_window_s)
        rate = self._rate(st, now, lifetime_total)

        def fire(desired: int, cause: str) -> AutoscaleDecision:
            st.pending_dir = 0
            st.last_scale_ts = now
            return AutoscaleDecision(
                key=key, ts=time.time(), from_replicas=current,
                to_replicas=desired, cause=cause, ongoing_avg=smoothed,
                arrival_rate=rate, p99_ms=p99_ms, slo_ms=slo_ms)

        # scale FROM zero: requests are blocked behind routers reporting
        # queued demand — act immediately, no window, no delay
        if current == 0:
            if handle_queued > 0 or smoothed > 0:
                return fire(max(1, auto.min_replicas), "scale_from_zero")
            st.pending_dir = 0
            return None

        target = auto.target_ongoing_requests
        desired = None
        cause = None
        slo_breach = (slo_ms is not None and p99_ms is not None
                      and p99_ms > slo_ms * auto.slo_upscale_ratio)
        up_q = math.ceil(smoothed / target)
        if slo_breach:
            # latency says the fleet is too slow regardless of queue
            # math: a multiplicative step up probes capacity the way the
            # AIMD batcher probes batch size (bounded by max_replicas)
            desired = current + max(1, math.ceil(current * 0.5))
            cause = "p99_breach"
        elif up_q > current:
            desired = up_q
            cause = "queue_depth"
        else:
            # downscale band: only drop to a count that keeps survivors
            # at or under downscale_headroom * target — the hysteresis
            # gap between the bands is where "near the threshold" lives
            if smoothed <= 0:
                down_q = 0
            else:
                down_q = math.ceil(
                    smoothed / (target * auto.downscale_headroom))
            slo_quiet = not (slo_ms is not None and p99_ms is not None
                             and p99_ms > slo_ms * auto.slo_downscale_ratio)
            if down_q == 0 and rate > _ZERO_RATE_FLOOR:
                # arrival rate gates scale-TO-zero: the smoothed window
                # can read 0 between probes while requests still trickle
                # (each completing inside one probe interval), and zero
                # capacity against live traffic means every request eats
                # a cold scale-from-zero start
                down_q = 1
            if down_q < current and slo_quiet:
                desired = down_q
                cause = "idle" if down_q == 0 else "queue_drain"
        if desired is not None:
            desired = max(auto.min_replicas,
                          min(auto.max_replicas, desired))
        if desired is None or desired == current:
            st.pending_dir = 0
            return None

        direction = 1 if desired > current else -1
        if st.pending_dir != direction:
            # direction tracked, not the exact count: noisy load drifts
            # the desired count tick to tick, and re-arming the maturity
            # timer on every drift would turn hysteresis into
            # never-scaling
            st.pending_dir = direction
            st.pending_since = now
            return None
        delay = (auto.upscale_delay_s if direction > 0
                 else auto.downscale_delay_s)
        if now - st.pending_since < delay:
            return None
        if direction < 0 and now - st.last_scale_ts < auto.cooldown_s:
            return None  # too close to the last scale event to shrink
        return fire(desired, cause)
