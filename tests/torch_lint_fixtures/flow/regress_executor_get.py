"""Blocking get on the loop's DEFAULT executor.

A callback running on the core event loop shipped a blocking framework
get to run_in_executor(None, ...) — the default pool is shared with the
loop's own machinery, so the wait starved it into a whole-process
deadlock. The flow pass must follow the default-executor edge (a
PRIVATE pool submit would be the fix and stays clean):
_apply_update -> [default-executor] _fetch_state -> _pull_value -> get.
"""
import ray_tpu_torch


def _pull_value(ref):
    return ray_tpu_torch.get(ref)  # expect: RT020


def _fetch_state(ref):
    value = _pull_value(ref)
    return value


def _apply_update(loop, ref):
    return loop.run_in_executor(None, _fetch_state, ref)


def wire_callbacks(loop, ref):
    loop.call_soon(_apply_update, loop, ref)
