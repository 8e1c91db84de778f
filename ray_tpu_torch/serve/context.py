"""Per-request serve context: the deadline that travels with a request.

The replica stamps the active request's absolute deadline (monotonic
seconds) into a contextvar before invoking user code; a composed
DeploymentHandle call made inside that code reads it back and bounds the
nested request by the REMAINING budget (ref: serve request context
propagation, _private/serve_request_context.py — deadline instead of the
full context object: it is the only field the router needs).

Contextvars flow into async user methods natively and into sync methods
via the ``contextvars.copy_context().run`` the replica already does for
the multiplexed-model id, so ``current_deadline()`` is visible from both.
"""
from __future__ import annotations

import contextvars

_request_deadline: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "rt_serve_request_deadline", default=None
)


def current_deadline() -> float | None:
    """Absolute monotonic deadline of the request being handled on this
    task/thread, or None outside a deadline-bearing request."""
    return _request_deadline.get()


def set_deadline(deadline: float | None) -> contextvars.Token:
    return _request_deadline.set(deadline)


def reset_deadline(token: contextvars.Token) -> None:
    _request_deadline.reset(token)
