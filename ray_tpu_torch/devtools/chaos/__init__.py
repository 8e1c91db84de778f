"""Deterministic, cluster-wide fault injection (the chaos subsystem).

The role of the reference's reusable fault-injection harness (ref:
_private/test_utils.py:1419 ResourceKiller + the chaos release tests),
generalized the way Basiri et al. (IEEE Software '16) frame chaos
engineering: every robustness property the runtime ships — task retries,
lease spillback, ring RPC-spill, WAL recovery, OOM kills — is exercised
by SEEDED, REPLAYABLE fault schedules instead of hand-rolled test
threads.

Three layers:

- **Fault points** (`chaos.point("ring.push", ...)`): named hooks
  threaded through the L1-L4 hot paths (fastpath rings, store seal, RPC
  send, GCS WAL append, raylet lease grant, worker exec). Call sites
  guard with ``if chaos.ENABLED:`` — when chaos is off (the default and
  the production state) a fault point is ONE module-attribute load and a
  falsy branch, no function call, no config lookup (bench.py
  ``chaos_overhead_us``).
- **Native fault arms** (ring.cc / store.cc): env-gated counters below
  Python that force partial ring pushes, ring wait timeouts, and store
  seal failures — see :func:`arm_native`.

A :class:`ChaosController` (:mod:`.controller`) runs a
:class:`ChaosPlan` (:mod:`.plan`): ``seed`` + ordered ``(point, match,
action, timing)`` rules with actions **delay / drop / duplicate / error
/ corrupt / kill**. The same seed over the same call sequence yields a
byte-identical fault log (``controller.signature()``). Every fired
fault is appended to a per-process JSONL under the session chaos dir
(``state.list_chaos_events()``) and stamped into the flight recorder
(utils/recorder.py stage ``chaos``) so a failed run leaves a replayable
trace.

Config: ``RT_CHAOS_ENABLED`` / ``RT_CHAOS_PLAN`` /
``RT_CHAOS_SEED`` / ``RT_CHAOS_LOG_DIR``, serialized to every spawned
process like the rest of the flag table.
"""

from __future__ import annotations

import os

from ray_tpu_torch.devtools.chaos.controller import (  # noqa: F401  (public API)
    Act,
    ChaosController,
    ChaosError,
)
from ray_tpu_torch.devtools.chaos.plan import ChaosPlan, ChaosRule  # noqa: F401

#: THE hot-path gate. Call sites do ``if chaos.ENABLED: chaos.point(...)``
#: — a module-attribute load and a truth test when disabled, nothing else.
ENABLED = False

_controller: ChaosController | None = None


def point(name: str, payload: bytes | None = None, /, **ctx):
    """Fire the fault point ``name``. Only called behind an ``ENABLED``
    guard. Returns None (proceed) or an :class:`Act` the call site must
    honor (``drop`` / ``duplicate`` / ``corrupt`` with the mangled
    payload); ``delay`` sleeps here, ``error`` raises
    :class:`ChaosError`, ``kill`` SIGKILLs this process."""
    ctrl = _controller
    if ctrl is None:
        return None
    return ctrl.fire(name, payload, ctx)


def get_controller() -> ChaosController | None:
    return _controller


def enable(plan: ChaosPlan, log_dir: str | None = None) -> ChaosController:
    """Arm chaos in this process: compile ``plan``, open the per-process
    event log, apply the plan's native arms, flip :data:`ENABLED`."""
    global ENABLED, _controller
    if any(r.cluster_once for r in plan.rules):
        # per-run id for cluster_once sentinels: the first armer (the
        # driver, ahead of any spawn) stamps it into the environment so
        # every descendant process shares one claim namespace, and a
        # REUSED log dir re-arms the rule on the next run
        import time as _time

        os.environ.setdefault(
            "RT_CHAOS_RUN_ID",
            f"{os.getpid():x}-{int(_time.time() * 1e3):x}")
    log_path = None
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"chaos-{os.getpid()}.jsonl")
    _controller = ChaosController(plan, log_path=log_path)
    if plan.native:
        arm_native(**plan.native)
    ENABLED = True
    return _controller


def disable() -> None:
    """Disarm: fault points compile back to the falsy-gate no-op and the
    native arms reset to 0."""
    global ENABLED, _controller
    ENABLED = False
    ctrl, _controller = _controller, None
    if ctrl is not None:
        ctrl.close()
        if ctrl.plan.native:
            arm_native()  # reset every armed counter


def maybe_arm() -> bool:
    """Arm from the flag table (RT_CHAOS_ENABLED / RT_CHAOS_PLAN /
    RT_CHAOS_SEED / RT_CHAOS_LOG_DIR). Called at every process
    entrypoint (driver init, worker/raylet/GCS main); a no-op returning
    False when chaos is off — the common case costs one config read at
    process start, never on any hot path."""
    from ray_tpu_torch.config import get_config

    if ENABLED:
        return True
    cfg = get_config()
    if not getattr(cfg, "chaos_enabled", False):
        return False
    plan = (ChaosPlan.load(cfg.chaos_plan) if cfg.chaos_plan
            else ChaosPlan(seed=0, rules=[]))
    if cfg.chaos_seed >= 0:
        plan.seed = cfg.chaos_seed
    enable(plan, log_dir=default_log_dir(cfg))
    return True


def default_log_dir(cfg=None) -> str:
    from ray_tpu_torch.config import get_config

    cfg = cfg or get_config()
    return cfg.chaos_log_dir or os.path.join(cfg.temp_dir, "chaos")


def note(name: str, action: str, **ctx) -> None:
    """Record an externally-executed fault (e.g. a killer's SIGKILL) in
    the chaos event log without running any rule. No-op when disarmed."""
    ctrl = _controller
    if ctrl is not None:
        ctrl.log_external(name, action, ctx)


def arm_native(ring_partial_every: int = 0, ring_timeout_every: int = 0,
               store_seal_fail_every: int = 0) -> None:
    """Set the native fault-arm counters in ring.cc / store.cc (0
    disarms). The same arms read ``RT_CHAOS_RING_PARTIAL_EVERY`` /
    ``RT_CHAOS_RING_TIMEOUT_EVERY`` / ``RT_CHAOS_STORE_SEAL_FAIL_EVERY``
    from the environment at library load, which is how spawned workers
    inherit them; this setter re-arms a library that is already
    loaded."""
    from ray_tpu_torch import _native

    lib = _native.get_lib()
    lib.rt_ring_chaos_set(int(ring_partial_every), int(ring_timeout_every))
    lib.rt_store_chaos_set(int(store_seal_fail_every))
