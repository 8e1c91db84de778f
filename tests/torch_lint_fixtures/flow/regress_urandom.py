"""Per-submit os.urandom on the fast lane.

The submit loop called an id generator per record; each id paid a
urandom syscall (~288us under a syscall-intercepting sandbox, 60%+ of
the submit hot path). The flow pass must name the full chain:
fast_actor_submit_loop -> _pack_submit -> _fresh_task_id -> os.urandom.
"""
import os


def _fresh_task_id() -> bytes:
    return os.urandom(16)  # expect: RT021


def _pack_submit(args: bytes) -> bytes:
    tid = _fresh_task_id()
    return tid + args


def fast_actor_submit_loop(pending):
    out = []
    for args in pending:
        out.append(_pack_submit(args))
    return out
