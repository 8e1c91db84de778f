"""Process-level chaos: seeded interval/burst raylet- and worker-killers.

The reusable home of what used to live as an inline thread in
``tests/test_resilience.py`` (ref: _private/test_utils.py:1419
ResourceKiller — kill a node/process on a cadence, no goodbyes, while a
workload runs). Raylet kills go through ``Cluster.kill_node`` (SIGKILL
every worker, drop the server, no lease returns, no GCS goodbye) and by
default each loss is RESTORED with a fresh node so cluster capacity
never drains to zero; worker kills SIGKILL a live worker process under
a random raylet, exercising the owner's retry path without losing the
node.

The port's copy of ``ray_tpu/devtools/chaos/killers.py``, over the
port's ``core/cluster.py``. A restored node takes the victim's resource
totals (JAX's restore carries only its CPU count), so a card node comes
back with its card.

Deterministic: victim selection comes off one ``random.Random(seed)``
stream, so the same seed over the same cluster shape picks the same
victims in the same order. Every kill is appended to ``self.kills`` and
mirrored into the chaos event log when the controller is armed
(``chaos.note``), so killer strikes line up with fault-point events in
``state.list_chaos_events()``.
"""

from __future__ import annotations

import logging
import os
import random
import signal
import threading
import time

log = logging.getLogger(__name__)


class ProcessKiller:
    """Base killer: every ``interval_s`` pick ``burst`` victims and kill
    them. ``target`` is ``"raylet"`` (hard node loss + optional capacity
    restore) or ``"worker"`` (SIGKILL a leased/idle worker process).
    The head node (``cluster.raylets[0]`` at construction) is protected
    unless ``protect_head=False``."""

    def __init__(self, cluster, *, seed: int = 0, interval_s: float = 2.0,
                 burst: int = 1, target: str = "raylet",
                 restore: bool = True, protect_head: bool = True,
                 max_kills: int = 0):
        if target not in ("raylet", "worker"):
            raise ValueError(f"unknown killer target {target!r}")
        self.cluster = cluster
        self.interval_s = interval_s
        self.burst = burst
        self.target = target
        self.restore = restore
        self.max_kills = max_kills
        self.kills: list[dict] = []
        self._rng = random.Random(seed)
        self._head = cluster.raylets[0] if (protect_head
                                            and cluster.raylets) else None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------------- control
    def start(self) -> "ProcessKiller":
        if self._thread is not None:
            raise RuntimeError("killer already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"chaos-{self.target}-killer")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self) -> "ProcessKiller":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def strike_once(self) -> None:
        """One synchronous seeded strike — progress-paced chaos. A
        wall-clock cadence couples the fault schedule to host speed (a
        loaded box takes N× longer per unit of work, so the same
        interval lands N× more kills per task attempt — the seeded run
        stops being the same experiment); callers that need a
        deterministic schedule strike at workload milestones instead and
        draw victims off the same seeded stream."""
        if self.max_kills and len(self.kills) >= self.max_kills:
            return
        for _ in range(self.burst):
            try:
                if self.target == "raylet":
                    self._kill_raylet()
                else:
                    self._kill_worker()
            except Exception:
                log.debug("killer strike failed", exc_info=True)

    # ------------------------------------------------------------------ loop
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self.max_kills and len(self.kills) >= self.max_kills:
                return
            # chaos races real teardown by design (a victim can die
            # between choice and kill); strike_once skips the strike,
            # never escalates into a test-harness crash
            self.strike_once()

    def _kill_raylet(self) -> None:
        victims = [r for r in self.cluster.raylets if r is not self._head]
        if not victims:
            return
        victim = self._rng.choice(victims)
        totals = dict(victim.ledger.total)
        self.cluster.kill_node(victim)
        self._note("raylet", node=victim.node_id.hex())
        if self.restore:
            self.cluster.add_node(resources=totals)

    def _kill_worker(self) -> None:
        # only READY workers (address set): strangling every worker during
        # startup starves the pool instead of exercising retry paths
        pool = [(r, w) for r in self.cluster.raylets
                for w in r.all_workers.values()
                if w.proc.poll() is None and w.address is not None]
        if not pool:
            return
        raylet, w = self._rng.choice(pool)
        os.kill(w.proc.pid, signal.SIGKILL)
        self._note("worker", node=raylet.node_id.hex(), pid=w.proc.pid,
                   worker=w.worker_id.hex())

    def _note(self, kind: str, **ctx) -> None:
        from ray_tpu_torch.devtools import chaos

        self.kills.append({"ts": time.time(), "target": kind, **ctx})
        if chaos.ENABLED:
            chaos.note(f"killer.{kind}", "kill", **ctx)


class IntervalKiller(ProcessKiller):
    """One victim per interval — the reference ResourceKiller cadence."""

    def __init__(self, cluster, **kw):
        kw.setdefault("burst", 1)
        super().__init__(cluster, **kw)


class BurstKiller(ProcessKiller):
    """Several victims at once per interval: correlated failures (a rack
    loss), the shape single-kill schedules never produce."""

    def __init__(self, cluster, **kw):
        kw.setdefault("burst", 2)
        super().__init__(cluster, **kw)
