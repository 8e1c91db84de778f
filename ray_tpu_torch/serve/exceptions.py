"""Typed serve error hierarchy.

A copy of ``ray_tpu/serve/exceptions.py``. Every class keeps
``_rt_error_passthrough``, the mark by which the JAX package's actor plane
ships an error typed instead of flattening it, so callers that classify
on these types (retry on ``BackPressureError``) work unchanged.
"""
from __future__ import annotations


class RayServeException(Exception):
    """Base class for every serve-layer failure."""

    #: worker error wrapper ships marked exceptions typed (not flattened
    #: into TaskError), so replica-side raises keep their class caller-side
    _rt_error_passthrough = True


class BackPressureError(RayServeException):
    """The replica (or the router's own queue cap) refused admission:
    ``max_ongoing_requests`` are executing and ``max_queued_requests``
    are already waiting. Always safe to retry elsewhere — the request
    never started executing. Proxies map it to HTTP 429 /
    gRPC RESOURCE_EXHAUSTED with a Retry-After hint."""

    def __init__(self, message: str = "request refused: queue full",
                 retry_after_s: float = 0.1):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RequestTimeoutError(RayServeException):
    """The request's deadline (``request_timeout_s``, or the remaining
    budget inherited from a composing deployment) expired — client-side
    while waiting, or replica-side before execution started (the replica
    sheds rather than executes already-dead work). Never retried: the
    deadline is the caller's total budget, not a per-attempt one."""


class ReplicaUnavailableError(RayServeException):
    """Routing-time failure: the chosen replica is gone (actor lookup
    failed / evicted between choose and dispatch) or no replica became
    ready within the membership wait. Always safe to retry — nothing was
    dispatched."""


class RequestCancelledError(RayServeException):
    """The request was cancelled before execution — the losing copy of a
    hedged request whose winner already returned."""
