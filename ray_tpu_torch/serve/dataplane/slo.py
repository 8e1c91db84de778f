"""SLO error-budget burn-rate monitoring for the serve data plane.

Closes the loop "The Tail at Scale" opens: the p99 signal that already
drives the autoscaler (serve/dataplane/autoscaler.py) also measures how
fast each deployment is BURNING its error budget — the SRE multiwindow,
multi-burn-rate alert (Beyer et al., SRE workbook ch.5): a deployment
whose SLO is "``slo_target`` of requests under ``latency_slo_ms``" has
an error budget of ``1 - slo_target``; the *burn rate* is the observed
breach fraction divided by that budget (burn 1.0 = spending the budget
exactly as fast as the SLO allows). Alerts fire only when BOTH a fast
window (is it happening NOW?) and a slow window (is it material, not a
blip?) burn above their thresholds — the fast window gates detection
latency, the slow window gates flap.

The serve controller drives one :class:`SLOBurnMonitor` beside its
autoscaler: each reconcile tick it folds the deployment's recent
request-latency window (the ns="latency" ``serve_<app>/<dep>`` stages
the replicas already publish) into the monitor, and every fired
:class:`BurnAlert` is published on the ``slo_burn`` pubsub channel and
a bounded ns="serve" kv history (``state.list_slo_burn_events()``,
dashboard ``/api/slo_burn``) — exactly the ``serve_autoscale`` fan-out,
one channel over.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class BurnAlert:
    key: str                 # "app/deployment"
    ts: float                # wall clock
    severity: str            # "page" | "warn" | "ok" (recovery edge)
    burn_fast: float         # budget-burn multiple over the fast window
    burn_slow: float         # ... over the slow window
    breach_fraction: float   # latest observed fraction over the SLO
    slo_ms: float
    budget: float            # 1 - slo_target

    def to_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class _KeyState:
    samples: deque = field(default_factory=deque)  # (mono_ts, breach_frac)
    last_severity: str = "ok"
    last_fired: float = 0.0


class SLOBurnMonitor:
    """Multiwindow burn-rate alerting over per-deployment breach
    fractions.

    ``observe(key, breach_fraction)`` feeds the fraction of the
    deployment's recent request window that breached its latency SLO
    (a snapshot statistic, like the p99 the autoscaler consumes — robust
    to the bounded windows re-publishing overlapping samples).
    ``check(key, slo_ms)`` evaluates both windows and returns a
    :class:`BurnAlert` on a severity EDGE (ok->warn/page, page<->warn,
    or recovery back to ok), rate-limited by ``cooldown_s`` per key.

    Default thresholds are the SRE-workbook pairs scaled to this
    stack's windows: page at burn >= 14.4 fast AND slow (2% of a
    30-day budget in an hour), warn at >= 6.
    """

    def __init__(self, *, slo_target: float = 0.99,
                 fast_window_s: float = 60.0, slow_window_s: float = 600.0,
                 page_burn: float = 14.4, warn_burn: float = 6.0,
                 cooldown_s: float = 30.0):
        if not 0.0 < slo_target < 1.0:
            raise ValueError("slo_target must be in (0, 1)")
        self.slo_target = slo_target
        self.budget = 1.0 - slo_target
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.page_burn = page_burn
        self.warn_burn = warn_burn
        self.cooldown_s = cooldown_s
        self._keys: dict[str, _KeyState] = {}

    # ------------------------------------------------------------ feeding
    def observe(self, key: str, breach_fraction: float,
                now: float | None = None) -> None:
        st = self._keys.setdefault(key, _KeyState())
        now = time.monotonic() if now is None else now
        st.samples.append((now, max(0.0, min(1.0, breach_fraction))))
        floor = now - self.slow_window_s
        while st.samples and st.samples[0][0] < floor:
            st.samples.popleft()

    def burn(self, key: str, window_s: float,
             now: float | None = None) -> float:
        """Mean breach fraction over the window / the error budget."""
        st = self._keys.get(key)
        if st is None or not st.samples:
            return 0.0
        now = time.monotonic() if now is None else now
        floor = now - window_s
        vals = [f for ts, f in st.samples if ts >= floor]
        if not vals:
            return 0.0
        return (sum(vals) / len(vals)) / self.budget

    # ----------------------------------------------------------- alerting
    def check(self, key: str, slo_ms: float,
              now: float | None = None) -> BurnAlert | None:
        st = self._keys.get(key)
        if st is None or not st.samples:
            return None
        now = time.monotonic() if now is None else now
        burn_fast = self.burn(key, self.fast_window_s, now)
        burn_slow = self.burn(key, self.slow_window_s, now)
        # multiwindow AND: the fast window proves it's happening now,
        # the slow window proves it's material
        if burn_fast >= self.page_burn and burn_slow >= self.page_burn:
            severity = "page"
        elif burn_fast >= self.warn_burn and burn_slow >= self.warn_burn:
            severity = "warn"
        else:
            severity = "ok"
        if severity == st.last_severity:
            return None  # edges only: a sustained burn fired once
        if severity != "ok" and now - st.last_fired < self.cooldown_s:
            return None  # escalation storm guard (recovery always lands)
        st.last_severity = severity
        st.last_fired = now
        return BurnAlert(
            key=key, ts=time.time(), severity=severity,
            burn_fast=round(burn_fast, 3), burn_slow=round(burn_slow, 3),
            breach_fraction=st.samples[-1][1], slo_ms=float(slo_ms),
            budget=self.budget)
