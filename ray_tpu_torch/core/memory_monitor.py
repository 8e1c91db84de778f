"""Memory monitor + OOM worker killing.

Counterpart of the reference's memory protection (ref:
src/ray/common/memory_monitor.h:52 usage polling,
src/ray/raylet/worker_killing_policy.h:39 — kill the newest retriable
work first so long-running work survives). The raylet polls system
memory; past the threshold it terminates the most recently leased
worker, whose in-flight task fails back to its owner as a worker crash
and retries (possibly elsewhere / later, when memory frees).
"""
from __future__ import annotations

import time


def read_system_memory() -> tuple[int, int]:
    """(available_bytes, total_bytes) from /proc/meminfo (the reference
    reads the same file, cgroup-aware variant omitted)."""
    total = available = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("MemAvailable:"):
                available = int(line.split()[1]) * 1024
            if total and available:
                break
    return available, total


class MemoryMonitor:
    """Drives the kill policy from a pluggable usage reader (tests inject
    a fake reader; production uses /proc/meminfo)."""

    def __init__(self, raylet, threshold: float, min_interval_s: float = 1.0,
                 reader=read_system_memory):
        self.raylet = raylet
        self.threshold = threshold
        self.min_interval_s = min_interval_s
        self.reader = reader
        self._last_kill = 0.0
        self.kills: list[dict] = []  # observability

    def usage_fraction(self) -> float:
        available, total = self.reader()
        if total <= 0:
            return 0.0
        return 1.0 - (available / total)

    def maybe_kill(self) -> bool:
        """One poll: above threshold -> kill the newest leased worker
        (ref: worker_killing_policy 'newest first' — it is the most
        retriable and frees memory fastest)."""
        usage = self.usage_fraction()
        if usage < self.threshold:
            return False
        now = time.monotonic()
        if now - self._last_kill < self.min_interval_s:
            return False  # give the previous kill time to free memory
        victim = None
        victim_lease = None
        # two passes: plain task workers first (retriable), actor workers
        # only as a last resort (an actor with max_restarts=0 dies forever)
        for actors_allowed in (False, True):
            for lease in self.raylet.leases.values():
                if lease.worker.proc.poll() is not None:
                    continue
                if (lease.worker.actor_id is not None) != actors_allowed:
                    continue
                if victim_lease is None or lease.lease_id > victim_lease.lease_id:
                    victim_lease = lease
                    victim = lease.worker
            if victim is not None:
                break
        if victim is None:
            return False
        self._last_kill = now
        self.kills.append({
            "ts": time.time(),
            "usage": usage,
            "worker_pid": victim.proc.pid,
            "lease_id": victim_lease.lease_id,
        })
        try:
            victim.proc.kill()  # hard kill: the owner sees a worker crash
        except OSError:
            pass  # raced its own exit: the pressure is relieved either way
        return True
