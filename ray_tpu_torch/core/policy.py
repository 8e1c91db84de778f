"""Shared scheduling policy: hybrid top-k node choice.

One implementation for both placement sites — GCS node pick and raylet
spillback (ref: hybrid_scheduling_policy.h:50 + policy/scorer.h): score
candidates by worst post-placement utilization on the requested
dimensions; randomize only among comfortable nodes (below the
utilization threshold) to avoid herding, else fall back to the single
best — a nearly-full node must never win a coin toss against an idle one.
"""

from __future__ import annotations

import random

# randomize among nodes whose worst post-placement utilization stays
# below this; above it, placement is deterministic best-first
UTIL_THRESHOLD = 0.75
TOP_K = 3


def fits(resources: dict, available: dict) -> bool:
    """Every requested dimension is available (1e-9 float slack)."""
    return all(available.get(k, 0.0) >= v - 1e-9
               for k, v in resources.items())


def score(resources: dict, total: dict, available: dict) -> float:
    """Worst post-placement utilization across the requested dimensions."""
    worst = 0.0
    for k, v in resources.items():
        cap = total.get(k, 0.0) or 1.0
        worst = max(worst, (cap - available.get(k, 0.0) + v) / cap)
    return worst


def pick(candidates: list[tuple[float, object]]):
    """candidates: [(score, item)]. Returns an item or None.

    Comfortable nodes (under the threshold) shadow tight ones, but the
    final choice is ALWAYS randomized over a set: concurrent requests
    act on gossip-stale views, and any deterministic pick herds them
    all onto one node until the next heartbeat."""
    if not candidates:
        return None
    candidates.sort(key=lambda si: si[0])
    comfortable = [i for s, i in candidates[:TOP_K] if s <= UTIL_THRESHOLD]
    if comfortable:
        return random.choice(comfortable)
    return random.choice([i for _, i in candidates[:TOP_K]])
