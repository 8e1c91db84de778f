"""Cross-request prefix cache: a radix tree over token-id pages.

Counterpart of ``ray_tpu/llm/disagg/prefix_cache.py`` without its disk
tier. A prompt's KV for its first ``k`` FULL pages depends only on those
``k * page_size`` tokens (causal attention), so two requests sharing a
token prefix share those pages exactly. The cache maps page-granular token
chunks to :class:`~.kv_plane.KVPageEntry` objects, whose host arrays are
the pages themselves.

- **Radix layout**: one node per page, keyed by that page's token tuple; a
  lookup walks from the root matching whole pages and returns the longest
  cached prefix as a ready-to-adopt :class:`KVPageManifest` sharing the
  tree's entries.
- **Pinning**: a lookup pins every node on the returned path until
  :meth:`release`, so no eviction drops a page an adoption is reading.
- **Eviction**: LRU under ``capacity_bytes`` of page payload; least
  recently used LEAF nodes go first (an interior page serves every cached
  descendant), pinned paths are skipped. Dropping a node drops the cache's
  reference to its arrays.
- **Affinity**: :func:`prefix_hint` hashes a prompt's first page(s) into a
  stable routing hint, so requests sharing a prefix can be sent where its
  pages are cached.

Left out: the tier-1 spill (``_spill_*``, ``spill_all``, the raylet's
cooperative spill), which rides on the JAX package's ``core.tiering``;
``stats()`` keeps its keys with the spill counters at 0.
"""
from __future__ import annotations

import hashlib
import itertools
import threading

from ray_tpu_torch.llm.disagg.kv_plane import KVPageManifest


def prefix_hint(token_ids, page_size: int = 16, n_pages: int = 1) -> str:
    """Stable affinity hint for a prompt: a hash of its first ``n_pages``
    full pages of tokens. Prompts sharing those pages map to the same
    hint; prompts too short to fill one page return ``""`` (nothing
    cacheable, route by load)."""
    n = (min(len(token_ids), n_pages * page_size) // page_size) * page_size
    if n == 0:
        return ""
    blob = b"|".join(str(int(t)).encode() for t in token_ids[:n])
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


class _Node:
    __slots__ = ("key", "entry", "children", "parent", "pins", "last_used")

    def __init__(self, key, entry, parent):
        self.key = key            # tuple of page_size token ids
        self.entry = entry        # KVPageEntry (shared with manifests)
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.pins = 0
        self.last_used = 0


class PrefixCache:
    """Radix tree of cached KV pages with pinning and LRU eviction."""

    def __init__(self, page_size: int, *, capacity_bytes: int = 64 << 20,
                 kv_dtype: str = "native"):
        self.PS = int(page_size)
        self.capacity_bytes = int(capacity_bytes)
        self.kv_dtype = kv_dtype
        self._children: dict[tuple, _Node] = {}  # the root's children
        self._lock = threading.Lock()
        self._clock = itertools.count(1)
        self._pinned: dict[int, tuple[KVPageManifest, list[_Node]]] = {}
        self.bytes = 0           # cached page payload bytes
        self.hits = 0            # lookups matching >= 1 page
        self.full_hits = 0       # lookups matching EVERY full page
        self.misses = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.hit_tokens = 0      # tokens served from cache
        self.lookup_tokens = 0   # cacheable tokens asked for

    # -------------------------------------------------------------- write
    def insert(self, manifest: KVPageManifest) -> int:
        """Cache a manifest's FULL pages (the shareable span; a ragged tail
        page is only correct for the exact prompt that wrote it). Existing
        nodes are kept; new pages extend the path. Returns the number of
        newly cached pages. May evict LRU leaves to stay under
        ``capacity_bytes``; insertion itself is never refused."""
        n_full = manifest.full_pages()
        toks = manifest.token_ids
        added = 0
        with self._lock:
            now = next(self._clock)
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
                node.last_used = now
                parent = node
                children = node.children
            self._evict_lru_locked()
        return added

    # --------------------------------------------------------------- read
    def lookup(self, token_ids, *,
               max_tokens: int | None = None) -> KVPageManifest | None:
        """Longest cached page-aligned prefix of ``token_ids`` (capped at
        ``max_tokens``; cap at ``len(prompt) - 1`` so at least one suffix
        token remains to produce the first logits). Returns a PINNED
        manifest sharing the tree's page entries, or None on a miss; the
        caller MUST :meth:`release` it after adoption."""
        limit = len(token_ids) if max_tokens is None else min(
            len(token_ids), max_tokens)
        n_full = limit // self.PS
        with self._lock:
            self.lookup_tokens += n_full * self.PS
            now = next(self._clock)
            children = self._children
            path: list[_Node] = []
            for i in range(n_full):
                key = tuple(int(t) for t in
                            token_ids[i * self.PS:(i + 1) * self.PS])
                node = children.get(key)
                if node is None:
                    break
                node.last_used = now
                path.append(node)
                children = node.children
            if not path:
                self.misses += 1
                return None
            self.hits += 1
            if len(path) == n_full:
                self.full_hits += 1
            self.hit_tokens += len(path) * self.PS
            for node in path:
                node.pins += 1
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
            self._evict_lru_locked()

    def invalidate(self, token_ids) -> int:
        """Drop the cached path for ``token_ids`` (pages found bad: the
        caller re-prefills and re-inserts). Pinned nodes survive, as do
        interior nodes with other children. Returns pages dropped."""
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
        self.bytes -= node.entry.nbytes
        node.entry = None  # drop the page arrays now, not at the next gc

    def _evict_lru_locked(self) -> None:
        """Past ``capacity_bytes``, drop least-recently-used unpinned
        LEAVES; a pinned leaf (mid-adoption) is never touched."""
        while self.bytes > self.capacity_bytes:
            victim = None
            stack = list(self._children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif node.pins == 0 and (
                        victim is None or node.last_used < victim.last_used):
                    victim = node
            if victim is None:
                break  # everything left is pinned or interior
            nbytes = victim.entry.nbytes
            self._drop_locked(victim)
            self.evictions += 1
            self.evicted_bytes += nbytes

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
                # the JAX cache's disk tier, which the port does not have
                "spill": False,
                "tier1_bytes": 0,
                "spills": 0,
                "spilled_bytes": 0,
                "tier1_hits": 0,
                "tier1_hit_pages": 0,
                "tier1_hit_rate": 0.0,
            }

    def _count_locked(self) -> int:
        n = 0
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n
