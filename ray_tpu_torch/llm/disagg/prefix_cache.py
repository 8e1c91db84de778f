"""Cross-request prefix cache: a radix tree over token-id pages.

Counterpart of ``ray_tpu/llm/disagg/prefix_cache.py``.

The PagedAttention sharing argument (Kwon et al., SOSP'23) applied
cross-request AND cross-worker: a prompt's KV for its first ``k`` FULL
pages depends only on those ``k * page_size`` tokens (causal attention),
so two requests sharing a token prefix share those pages byte-for-byte.
The cache maps page-granular token chunks to pinned
:class:`~.kv_plane.KVPageEntry` refs — the pages themselves stay sealed
in the prefill workers' shm arenas; the tree holds ~100-byte metadata
per page and the refs keep the arena bytes alive.

- **Radix layout**: one node per page, keyed by that page's token tuple;
  a lookup walks from the root matching whole pages and returns the
  longest cached prefix as a ready-to-adopt :class:`KVPageManifest`
  (sharing the tree's entries, and therefore its refs).
- **Pinning**: a lookup pins every node on the returned path until
  :meth:`release` — an adopting decode worker must never race an
  eviction that drops the last ref mid-fetch.
- **Eviction**: arena-pressure LRU. The cache tracks the payload bytes
  its refs pin; past ``capacity_bytes`` it drops least-recently-used
  LEAF nodes first (an interior page is load-bearing for every cached
  descendant), skipping pinned paths. Dropping a node releases its page
  refs; the owner frees the shm copy when the last borrower lets go —
  eviction here IS arena memory coming back.
- **Tiering** (``spill=True``): instead of dropping, the LRU victim is
  SPILLED — the tree keeps the node, the raylet moves the page bytes to
  its spill directory, and the entry's ``(tier, spill_path)`` leg flips
  to tier-1 (core/tiering.py). A later lookup on the path still hits;
  the adopt restores the pages with one sequential disk read instead of
  re-running prefill. The spill frontier recedes leaf-upward (a node
  spills only once its children are tier-1), tier-1 has its own byte
  budget past which the old drop-eviction resumes, and the cache
  registers as a cooperative arena owner so the raylet can claim cold
  unpinned pages under pressure it notices first.
- **Affinity**: :func:`prefix_hint` hashes a prompt's first page(s) into
  a stable routing hint; ``DeploymentHandle.options(routing_hint=...)``
  rendezvous-routes every request sharing that prefix to the replica
  already holding its pages (each replica's cache is local by design —
  no coherence traffic, the hint makes locality the common case).
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
import weakref

from ray_tpu_torch.core import tiering
from ray_tpu_torch.llm.disagg.kv_plane import KVPageManifest, untrack_staging


def prefix_hint(token_ids, page_size: int = 16, n_pages: int = 1) -> str:
    """Stable affinity hint for a prompt: a hash of its first
    ``n_pages`` full pages of tokens. Prompts sharing those pages map to
    the same hint (and, through rendezvous routing, the same replica);
    prompts too short to fill one page return ``""`` — nothing cacheable,
    route by load."""
    n = (min(len(token_ids), n_pages * page_size) // page_size) * page_size
    if n == 0:
        return ""
    blob = b"|".join(str(int(t)).encode() for t in token_ids[:n])
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


class _Node:
    __slots__ = ("key", "entry", "children", "parent", "pins", "last_used",
                 "touched", "t1_acct")

    def __init__(self, key, entry, parent):
        self.key = key            # tuple of page_size token ids
        self.entry = entry        # KVPageEntry (shared with manifests)
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.pins = 0
        self.last_used = 0
        self.touched = 0.0        # wall clock, coldness gate for spill
        self.t1_acct = False      # bytes accounted in the tier-1 ledger


class PrefixCache:
    """Radix tree of cached KV pages with pinning and LRU eviction."""

    def __init__(self, page_size: int, *, capacity_bytes: int = 64 << 20,
                 kv_dtype: str = "native", spill: bool = False,
                 tier1_capacity_bytes: int = 1 << 30,
                 spill_cold_after_s: float = 0.25):
        self.PS = int(page_size)
        self.capacity_bytes = int(capacity_bytes)
        self.kv_dtype = kv_dtype
        # spill defaults OFF: a standalone cache (no runtime) keeps the
        # original drop-eviction contract; the scheduler opts in via
        # config.prefix_cache_spill
        self.spill = bool(spill)
        self.tier1_capacity_bytes = int(tier1_capacity_bytes)
        self.spill_cold_after_s = float(spill_cold_after_s)
        self._children: dict[tuple, _Node] = {}  # the root's children
        self._lock = threading.Lock()
        self._clock = itertools.count(1)
        self._pinned: dict[int, tuple[KVPageManifest, list[_Node]]] = {}
        self._by_oid: dict[bytes, _Node] = {}  # component oid -> node
        self.bytes = 0           # tier-0 (shm-resident) payload bytes
        self.tier1_bytes = 0     # tier-1 (spilled-to-disk) payload bytes
        self.hits = 0            # lookups matching >= 1 page
        self.full_hits = 0       # lookups matching EVERY full page
        self.misses = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.spills = 0          # pages moved shm -> tier-1
        self.spilled_bytes = 0
        self.tier1_hits = 0      # lookups whose path held >=1 tier-1 page
        self.tier1_hit_pages = 0
        self.hit_tokens = 0      # tokens served from cache
        self.lookup_tokens = 0   # cacheable tokens asked for
        if self.spill:
            # cooperative arena owner: the raylet may ask for cold
            # unpinned pages (provider) and reports landed spill files
            # (sink). Weakref-bound so the registry never outlives us.
            ref = weakref.ref(self)
            self._owner_name = f"prefix_cache:{id(self)}"

            def _provider(need, cold_after_s, _r=ref):
                c = _r()
                return ([] if c is None
                        else c._spill_candidates(need, cold_after_s))

            def _sink(oid, path, _r=ref):
                c = _r()
                if c is not None:
                    c._on_spilled(oid, path)

            tiering.register_arena_owner(self._owner_name, _provider,
                                         on_spilled=_sink)

            def _stats(_r=ref):
                c = _r()
                if c is None:
                    return {}
                return {"bytes": c.bytes, "capacity": c.capacity_bytes}

            def _tier1_stats(_r=ref):
                c = _r()
                if c is None:
                    return {}
                return {"bytes": c.tier1_bytes,
                        "capacity": c.tier1_capacity_bytes}

            # byte ledgers for the watermark plane: shm-resident and
            # tier-1 arenas report separately (they fill independently)
            tiering.register_arena_stats("prefix_cache", _stats)
            tiering.register_arena_stats("prefix_cache_tier1", _tier1_stats)

    # -------------------------------------------------------------- write
    def insert(self, manifest: KVPageManifest) -> int:
        """Cache a manifest's FULL pages (the shareable span; a ragged
        tail page is only correct for the exact prompt that wrote it).
        Existing nodes are kept — their entries already share refs with
        every earlier reader; new pages extend the path. Returns the
        number of newly cached pages. May evict LRU leaves to stay under
        ``capacity_bytes``; insertion itself is never refused."""
        n_full = manifest.full_pages()
        toks = manifest.token_ids
        added = 0
        adopted = []
        with self._lock:
            now = next(self._clock)
            wall = time.monotonic()
            children = self._children
            parent = None
            for i in range(min(n_full, manifest.n_pages)):
                key = tuple(toks[i * self.PS:(i + 1) * self.PS])
                node = children.get(key)
                if node is None:
                    node = _Node(key, manifest.pages[i], parent)
                    children[key] = node
                    self.bytes += node.entry.nbytes
                    added += 1
                    adopted.append(node.entry)
                    for ref in node.entry.refs.values():
                        self._by_oid[ref.id.binary()] = node
                node.last_used = now
                node.touched = wall
                parent = node
                children = node.children
            to_spill = self._evict_lru_locked()
        for entry in adopted:
            # the cache is the long-lived owner now: stop the kv-plane
            # staging tracker offering these pages behind our back
            untrack_staging(entry)
        self._request_spill(to_spill)
        return added

    # --------------------------------------------------------------- read
    def lookup(self, token_ids, *,
               max_tokens: int | None = None) -> KVPageManifest | None:
        """Longest cached page-aligned prefix of ``token_ids`` (capped at
        ``max_tokens`` — the scheduler caps at ``len(prompt) - 1`` so at
        least one suffix token remains to produce the first logits).
        Returns a PINNED manifest sharing the tree's page entries, or
        None on a miss; the caller MUST :meth:`release` it after
        adoption."""
        limit = len(token_ids) if max_tokens is None else min(
            len(token_ids), max_tokens)
        n_full = limit // self.PS
        with self._lock:
            self.lookup_tokens += n_full * self.PS
            now = next(self._clock)
            wall = time.monotonic()
            children = self._children
            path: list[_Node] = []
            for i in range(n_full):
                key = tuple(int(t) for t in
                            token_ids[i * self.PS:(i + 1) * self.PS])
                node = children.get(key)
                if node is None:
                    break
                node.last_used = now
                node.touched = wall
                path.append(node)
                children = node.children
            if not path:
                self.misses += 1
                return None
            self.hits += 1
            if len(path) == n_full:
                self.full_hits += 1
            self.hit_tokens += len(path) * self.PS
            t1_pages = 0
            for node in path:
                node.pins += 1
                if node.t1_acct:
                    # tier-1 hit: the adopt will restore these pages via
                    # the batched pull; promote the byte ledger back to
                    # tier 0 now so eviction pressure sees them as hot
                    # shm residents again
                    t1_pages += 1
                    nb = node.entry.nbytes
                    self.tier1_bytes -= nb
                    self.bytes += nb
                    node.t1_acct = False
            if t1_pages:
                self.tier1_hits += 1
                self.tier1_hit_pages += t1_pages
            if self.spill:
                from ray_tpu_torch.utils import metrics
                metrics.tier1_hit_rate.set(
                    self.tier1_hits / max(1, self.hits))
            m = KVPageManifest(
                token_ids=tuple(int(t)
                                for t in token_ids[:len(path) * self.PS]),
                page_size=self.PS, kv_dtype=self.kv_dtype,
                pages=[n.entry for n in path])
            self._pinned[id(m)] = (m, path)
            return m

    def release(self, manifest: KVPageManifest | None) -> None:
        """Unpin a manifest returned by :meth:`lookup` (idempotent, None
        tolerated so error paths can release unconditionally)."""
        if manifest is None:
            return
        with self._lock:
            entry = self._pinned.pop(id(manifest), None)
            if entry is None:
                return
            for node in entry[1]:
                node.pins = max(0, node.pins - 1)
            to_spill = self._evict_lru_locked()
        self._request_spill(to_spill)

    def invalidate(self, token_ids) -> int:
        """Drop the cached path for ``token_ids`` (pages lost/corrupt:
        the scheduler re-prefills and re-inserts). Pinned nodes survive —
        another request is mid-adoption on them. Returns pages dropped."""
        with self._lock:
            children = self._children
            path = []
            for i in range(len(token_ids) // self.PS):
                key = tuple(int(t) for t in
                            token_ids[i * self.PS:(i + 1) * self.PS])
                node = children.get(key)
                if node is None:
                    break
                path.append(node)
                children = node.children
            dropped = 0
            for node in reversed(path):
                if node.children or node.pins:
                    break
                self._drop_locked(node)
                dropped += 1
            return dropped

    # ----------------------------------------------------------- eviction
    def _drop_locked(self, node: _Node) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._children)
        siblings.pop(node.key, None)
        if node.t1_acct:
            self.tier1_bytes -= node.entry.nbytes
        else:
            self.bytes -= node.entry.nbytes
        for ref in node.entry.refs.values():
            self._by_oid.pop(ref.id.binary(), None)
        node.entry = None  # drop the page refs NOW, not at next gc

    def _evict_lru_locked(self) -> list:
        """Arena pressure. Spill mode: MOVE least-recently-used unpinned
        pages to tier-1 instead of dropping them — the tree node stays,
        its entry's tier leg flips, and the returned entries must be
        handed to :meth:`_request_spill` OUTSIDE the lock (it does RPC).
        The frontier recedes leaf-upward: a node spills only once every
        child is already tier-1, so surviving tier-0 paths stay
        contiguous from the root. Past ``tier1_capacity_bytes`` (or with
        spill off) the original behavior — drop LRU unpinned LEAVES, a
        pinned leaf (mid-adoption) is never touched."""
        to_spill = []
        if self.spill:
            while self.bytes > self.capacity_bytes:
                victim = self._spill_victim_locked()
                if victim is None:
                    break  # everything tier-0 is pinned
                self._mark_spilled_locked(victim)
                to_spill.append(victim.entry)
        # tier-1 over budget (or spill disabled): really drop. In spill
        # mode only tier-1 leaves are droppable — a pinned tier-0 path
        # holding bytes over capacity is transient, not drop pressure.
        while (self.tier1_bytes > self.tier1_capacity_bytes
               or (not self.spill and self.bytes > self.capacity_bytes)):
            victim = None
            stack = list(self._children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif (node.pins == 0
                      and (node.t1_acct or not self.spill)
                      and (victim is None
                           or node.last_used < victim.last_used)):
                    victim = node
            if victim is None:
                break  # everything left is pinned or interior
            nbytes = victim.entry.nbytes
            self._drop_locked(victim)
            self.evictions += 1
            self.evicted_bytes += nbytes
        return to_spill

    # ----------------------------------------------------------- tiering
    def _spill_victim_locked(self) -> _Node | None:
        """LRU unpinned tier-0 node whose children are all tier-1 (or
        absent) — inductively its whole subtree is already on disk, so
        spilling it keeps the tier-0 frontier connected to the root."""
        victim = None
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            if (not node.t1_acct and node.pins == 0
                    and all(c.t1_acct for c in node.children.values())
                    and (victim is None
                         or node.last_used < victim.last_used)):
                victim = node
        return victim

    def _mark_spilled_locked(self, node: _Node) -> None:
        nb = node.entry.nbytes
        self.bytes -= nb
        self.tier1_bytes += nb
        node.t1_acct = True
        node.entry.tier = tiering.TIER_DISK
        self.spills += 1
        self.spilled_bytes += nb

    def _request_spill(self, entries) -> None:
        """Ask the raylet to move these entries' pages to its spill dir.
        Best-effort and advisory: until the raylet confirms (the tiering
        sink stamps ``spill_path``), the pages are still shm-resident and
        every read path works unchanged. Standalone caches (no runtime)
        skip the RPC — the tier leg is then purely an accounting mark."""
        if not entries:
            return
        from ray_tpu_torch.core import api
        core = api._core
        if core is None or getattr(core, "store", None) is None:
            return
        oids = [ref.id for e in entries for ref in e.refs.values()]
        t0 = time.perf_counter_ns()
        try:
            core.spill_objects(oids)
        except Exception:
            return  # raylet gone mid-shutdown: pages stay in shm
        from ray_tpu_torch.llm.disagg import telemetry
        telemetry.record(telemetry.SPILL, time.perf_counter_ns() - t0,
                         sum(int(e.nbytes) for e in entries))

    def _spill_candidates(self, need: int, cold_after_s: float) -> list:
        """Cooperative-spill provider (tiering.register_arena_owner):
        cold unpinned tier-0 pages, coldest first, up to ``need`` bytes.
        Pinned paths are invisible here — a page mid-adoption must never
        leave shm under the adopter."""
        out = []
        with self._lock:
            cutoff = time.monotonic() - max(cold_after_s,
                                            self.spill_cold_after_s)
            cands = []
            stack = list(self._children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if (not node.t1_acct and node.pins == 0
                        and node.touched <= cutoff
                        and all(c.t1_acct
                                for c in node.children.values())):
                    cands.append(node)
            cands.sort(key=lambda n: n.last_used)
            got = 0
            for node in cands:
                if got >= need:
                    break
                refs = node.entry.refs
                per = max(1, int(node.entry.nbytes) // max(1, len(refs)))
                for ref in refs.values():
                    out.append({"object_id": ref.id.binary(),
                                "nbytes": per})
                got += int(node.entry.nbytes)
        return out

    def _on_spilled(self, oid: bytes, path: str) -> None:
        """Tiering sink: the raylet landed a spill file for one of our
        component oids. Stamp the entry's tier leg; move the byte ledger
        on the FIRST component (k and v spill together in practice)."""
        with self._lock:
            node = self._by_oid.get(bytes(oid))
            if node is None or node.entry is None:
                return
            node.entry.tier = tiering.TIER_DISK
            node.entry.spill_path = str(path)
            if not node.t1_acct and node.pins == 0:
                nb = node.entry.nbytes
                self.bytes -= nb
                self.tier1_bytes += nb
                node.t1_acct = True
                self.spills += 1
                self.spilled_bytes += nb

    def spill_all(self) -> int:
        """Force every unpinned cached page to tier-1 and WAIT for the
        raylet to confirm (deterministic pressure for tests/bench —
        production spilling is the incremental paths above). Returns the
        number of pages spilled."""
        entries = []
        with self._lock:
            stack = list(self._children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if not node.t1_acct and node.pins == 0:
                    self._mark_spilled_locked(node)
                    entries.append(node.entry)
        self._request_spill(entries)
        return len(entries)

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "pages": self._count_locked(),
                "bytes": self.bytes,
                "hits": self.hits, "full_hits": self.full_hits,
                "misses": self.misses,
                "hit_rate": self.hits / lookups if lookups else 0.0,
                "token_hit_rate": (self.hit_tokens / self.lookup_tokens
                                   if self.lookup_tokens else 0.0),
                "evictions": self.evictions,
                "evicted_bytes": self.evicted_bytes,
                "pinned": len(self._pinned),
                "spill": self.spill,
                "tier1_bytes": self.tier1_bytes,
                "spills": self.spills,
                "spilled_bytes": self.spilled_bytes,
                "tier1_hits": self.tier1_hits,
                "tier1_hit_pages": self.tier1_hit_pages,
                "tier1_hit_rate": (self.tier1_hits / self.hits
                                   if self.hits else 0.0),
            }

    def _count_locked(self) -> int:
        n = 0
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n
