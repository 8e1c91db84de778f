"""Arena-owner registry for cooperative spill (memory tiering).

The raylet's spill monitor can only see *unreferenced* sealed objects;
the planes that matter under pressure — the radix prefix cache, the
sharded plane, decode-pool staging — hold live borrows on every page
they cache, so those bytes were previously unreclaimable short of
eviction (and eviction means re-prefill / re-seal). This module is the
handshake that fixes that: an arena owner registers a *provider*
callback that can name cold referenced objects it is willing to trade
to tier-1, and the raylet asks through the owner process's core client
(``rpc_arena_spill_candidates``) when the arena crosses the spill
threshold. After the raylet writes the bytes out it reports back
(``rpc_arena_spilled``) so the owner can stamp the manifest entry's
``(tier, path)`` leg.

Everything here is process-local state plus two thin client RPC routes;
the actual byte movement stays in ``core/raylet.py``.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Callable

log = logging.getLogger(__name__)

# tier legs on manifest entries (KVPageEntry / ShardEntry)
TIER_SHM = 0   # bytes sealed in the local shm arena
TIER_DISK = 1  # bytes in the raylet's spill directory; restore on read

# provider: (need_bytes, cold_after_s) -> [(oid_binary, nbytes), ...]
Provider = Callable[[int, float], list]

_lock = threading.Lock()
_providers: dict[str, Provider] = {}
# spilled-notification sinks: name -> (oid_binary, path) -> None
_sinks: dict[str, Callable[[bytes, str], None]] = {}
_attached: set[int] = set()  # id(core) of clients already raylet-registered
# arena byte accounting (observability plane): name -> () -> {"bytes": n,
# "capacity": n | 0}. Sampled on the core client's flush timer into the
# rt_arena_* gauges; peaks tracked per arena so watermark HISTORY (not an
# instantaneous read) reaches the rollup plane and the dashboard.
_stats: dict[str, Callable[[], dict]] = {}
_watermarks: dict[str, "object"] = {}  # name -> WatermarkTracker


def register_arena_owner(name: str, provider: Provider,
                         on_spilled: Callable[[bytes, str], None]
                         | None = None) -> None:
    """Register a cold-candidate provider under ``name`` (idempotent —
    re-registering replaces). Registration is process-local and lazy:
    the raylet learns this process can provide candidates the first time
    a core client is attached (see :func:`attach_core`)."""
    with _lock:
        _providers[name] = provider
        if on_spilled is not None:
            _sinks[name] = on_spilled
    _try_attach()


def unregister_arena_owner(name: str) -> None:
    with _lock:
        _providers.pop(name, None)
        _sinks.pop(name, None)
        _stats.pop(name, None)
        _watermarks.pop(name, None)


def register_arena_stats(name: str,
                         stats: Callable[[], dict]) -> None:
    """Register a byte-accounting callback for arena ``name``:
    ``() -> {"bytes": live, "capacity": total | 0}``. Idempotent; the
    arena's watermark tracker starts fresh on (re)registration."""
    from ray_tpu_torch.core.metrics_store import WatermarkTracker

    with _lock:
        _stats[name] = stats
        _watermarks[name] = WatermarkTracker()


def sample_arenas(now: float | None = None) -> dict[str, dict]:
    """Sample every registered arena's live bytes into its watermark
    tracker and return ``{name: {bytes, peak, recent_peak, capacity}}``.
    Called from the core client's 1/s flush (gauge publish) and usable
    anywhere history beats an instantaneous read. A failing provider is
    skipped, never raised."""
    with _lock:
        items = [(n, _stats[n], _watermarks[n]) for n in _stats]
    out = {}
    for name, fn, wm in items:
        try:
            st = fn() or {}
            wm.note(float(st.get("bytes", 0)), now)
        except Exception:
            log.debug("arena stats provider %s failed", name, exc_info=True)
            continue
        out[name] = {"bytes": wm.live, "peak": wm.peak,
                     "recent_peak": wm.recent_peak(10.0, now),
                     "capacity": float(st.get("capacity", 0) or 0)}
    return out


def arena_watermark(name: str):
    """The arena's WatermarkTracker (None when unregistered) — spill
    policy and tests read peak history through this."""
    with _lock:
        return _watermarks.get(name)


def collect_candidates(need: int, cold_after_s: float) -> list[dict]:
    """All providers' cold candidates, oldest-first, enough to cover
    ``need`` bytes (providers may return less; never more than asked)."""
    with _lock:
        provs = list(_providers.values())
    out, got = [], 0
    for p in provs:
        try:
            cands = p(max(0, need - got), cold_after_s)
        except Exception:
            continue
        for oid, nbytes in cands:
            out.append({"object_id": oid, "nbytes": int(nbytes)})
            got += int(nbytes)
        if got >= need > 0:
            break
    return out


def notify_spilled(spilled: list[dict]) -> None:
    """Raylet reported these objects now live on tier-1; fan out to every
    owner so manifests can stamp their (tier, path) legs."""
    with _lock:
        sinks = list(_sinks.values())
    for item in spilled:
        oid, path = item.get("object_id"), item.get("path", "")
        for sink in sinks:
            try:
                sink(oid, path)
            except Exception:
                log.debug("spill sink failed", exc_info=True)


def attach_core(core) -> None:
    """Tell ``core``'s raylet that this process serves spill candidates
    (once per client). Safe to call before the client is connected —
    registration is retried from register_arena_owner call sites."""
    if core is None or getattr(core, "raylet", None) is None:
        return
    with _lock:
        if id(core) in _attached:
            return
        if not _providers:
            return
        _attached.add(id(core))
    try:
        core.register_spill_provider()
    except Exception:
        with _lock:
            _attached.discard(id(core))


def _try_attach() -> None:
    try:
        from ray_tpu_torch.core import api

        attach_core(getattr(api, "_core", None))
    except Exception:
        log.debug("spill-provider attach failed", exc_info=True)


def _reset_for_tests() -> None:
    with _lock:
        _providers.clear()
        _sinks.clear()
        _attached.clear()
        _stats.clear()
        _watermarks.clear()


class ColdTracker:
    """Cold-set bookkeeping for a plane that seals arena objects it keeps
    referenced (shard plane seals, decode-pool staging pages). Tracks
    (seal time, nbytes, entry) per oid and serves as both the provider
    (cold, tier-0, still-alive entries) and the spilled sink (stamps the
    entry's tier leg). Entries are held by weakref so the tracker never
    extends an object's lifetime past its manifest."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        # oid binary -> (ts, nbytes, weakref(entry))
        self._items: dict[bytes, tuple] = {}
        register_arena_owner(name, self.candidates, self.on_spilled)
        register_arena_stats(name, lambda: {"bytes": self.total_bytes()})

    def total_bytes(self) -> int:
        """Tier-0 bytes this plane still holds referenced (dead entries
        and already-spilled ones don't count against the arena)."""
        total = 0
        with self._lock:
            items = list(self._items.values())
        for _ts, nbytes, eref in items:
            entry = eref()
            if entry is not None and \
                    getattr(entry, "tier", TIER_SHM) == TIER_SHM:
                total += nbytes
        return total

    def track(self, oid: bytes, nbytes: int, entry) -> None:
        with self._lock:
            self._items[oid] = (time.monotonic(), int(nbytes),
                                weakref.ref(entry))

    def untrack(self, oid: bytes) -> None:
        with self._lock:
            self._items.pop(oid, None)

    def candidates(self, need: int, cold_after_s: float) -> list:
        now = time.monotonic()
        out, got, dead = [], 0, []
        with self._lock:
            items = sorted(self._items.items(), key=lambda kv: kv[1][0])
        for oid, (ts, nbytes, eref) in items:
            entry = eref()
            if entry is None:
                dead.append(oid)
                continue
            if getattr(entry, "tier", TIER_SHM) != TIER_SHM:
                continue
            if now - ts < cold_after_s:
                continue
            out.append((oid, nbytes))
            got += nbytes
            if got >= need > 0:
                break
        if dead:
            with self._lock:
                for oid in dead:
                    self._items.pop(oid, None)
        return out

    def on_spilled(self, oid: bytes, path: str) -> None:
        with self._lock:
            item = self._items.get(oid)
        if item is None:
            return
        entry = item[2]()
        if entry is not None:
            entry.tier = TIER_DISK
            entry.spill_path = path

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)
