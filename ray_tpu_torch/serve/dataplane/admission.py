"""Projected-queue-delay admission control.

The earlier admission rule was positional (refuse past ``max_ongoing`` +
``max_queued``); this one is temporal: a request whose projected queue
wait already exceeds its remaining deadline is refused AT ADMISSION with
a typed :class:`BackPressureError` — before it burns a queue slot, and
long before the replica-side deadline shed would have dropped it at
dequeue. The router retries it on a less-loaded replica; the proxies map
it to HTTP 429 / gRPC RESOURCE_EXHAUSTED as before.

The projection is the M/M/c-with-FIFO steady-state estimate: requests
drain in waves of ``max_ongoing`` concurrent executions, each wave
taking the EWMA of recent execution wall times, so a queue of ``q``
requests starts executing after roughly ``(q / max_ongoing) × ewma``
seconds. Deliberately coarse — its job is to cut obviously-dead work,
not to be a scheduler; the exact deadline shed at dequeue remains the
backstop for everything it underestimates.

Used on BOTH sides of the router/replica contract:

- replica-side (`replica.py _admit`): its own queue depth + its own
  measured execution EWMA.
- handle-side (`handle.py route_async`): the probed queue depth and the
  ``exec_ewma_ms`` each replica reports in ``get_metrics`` — sheds at
  the proxy without spending a dispatch RPC when EVERY candidate
  replica's projection exceeds the remaining budget.
"""
from __future__ import annotations

import time


class AdmissionController:
    """Execution-time EWMA + projected-delay math for one replica (or
    one router's view of one replica)."""

    __slots__ = ("max_ongoing", "alpha", "exec_ewma_s", "shed")

    def __init__(self, max_ongoing: int, alpha: float = 0.2,
                 exec_ewma_s: float = 0.0):
        self.max_ongoing = max(1, max_ongoing)
        self.alpha = alpha
        self.exec_ewma_s = exec_ewma_s  # 0.0 = no data yet, never sheds
        self.shed = 0  # projected-delay refusals (telemetry)

    def observe_exec(self, seconds: float) -> None:
        if self.exec_ewma_s <= 0.0:
            self.exec_ewma_s = seconds
        else:
            self.exec_ewma_s += self.alpha * (seconds - self.exec_ewma_s)

    def projected_delay_s(self, queued: int) -> float:
        """Estimated seconds before a request admitted NOW starts
        executing, with ``queued`` requests already ahead of it."""
        if self.exec_ewma_s <= 0.0 or queued <= 0:
            return 0.0
        return (queued / self.max_ongoing) * self.exec_ewma_s

    def would_breach(self, queued: int, deadline: float | None,
                     now: float | None = None) -> bool:
        """True when the projection says the deadline expires while the
        request is still queued — the shed-at-admission signal."""
        if deadline is None:
            return False
        if now is None:
            now = time.monotonic()
        delay = self.projected_delay_s(queued)
        return delay > 0.0 and now + delay >= deadline
