"""KV-page plane: paged-KV slices as first-class shm objects.

Counterpart of ``ray_tpu/llm/disagg/kv_plane.py``, on the port's runtime.
A prefill pool holds a prompt's KV in page rows (``[L, page, PS, KV, hd]``
per pool); :func:`ship_pages` gathers the produced pages on the pool's
device, copies them to host memory (ONE copy per pool component) and
seals each page's components into the local shm arena with
``put_value(prefer_shm=True)``, returning a :class:`KVPageManifest`:
token ids, per-page object refs, producing node, nbytes. The manifest is
metadata (~100 bytes a page); the page bytes move shm -> shm (same node,
zero-copy) or through the object plane's pull protocol (cross node),
never inside an RPC frame. A CUDA tensor is never sealed: the page is on
the host before the seal.

A decode worker :func:`adopt_pages` the manifest: components in the local
arena are read zero-copy on the calling thread, the rest with one batched
get (after a ``pull_objects_batch`` prefetch when two or more refs are
not local), stacked into the scatter-ready ``(k_stack, v_stack)``
CPU tensors that ``ContinuousBatchingEngine.submit_prefilled`` and
``scatter_pages`` take. Pages are int8-KV aware: a quantized pool ships
its ``q``/``s`` components as separate refs (``k.q``, ``k.s``, ``v.q``,
``v.s``). numpy has no bfloat16, so a bf16 component is sealed as its
uint16 bit pattern and turned back into a bfloat16 tensor by
:func:`adopt_pages`; no pool component is ever uint16.

Page granularity makes the pages shareable: a cached prefix of ``k`` full
pages is exactly the first ``k`` entries of any manifest over the same
token prefix, so the prefix cache (prefix_cache.py) pins page entries,
and a suffix prefill reuses the cached entries without resealing a byte.

Fault story: every ship and adopt passes the ``llm.kv_ship`` chaos point
(ctx ``phase`` = "seal"/"adopt", adopt also ``role``): ``error``/``drop``
surface as :class:`KVShipError` (the scheduler re-prefills), ``kill``
dies mid-adoption (the decode-death window that
``tests/plans/llm_decode_kill.json`` exercises).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch.core import tiering
from ray_tpu_torch.core.ref import ObjectRef
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.llm.disagg import telemetry

log = logging.getLogger(__name__)

# shipped-but-not-yet-adopted pages are this process's coldest referenced
# bytes; the tracker offers them to the raylet's cooperative spill
_staging: tiering.ColdTracker | None = None


def _staging_tracker() -> tiering.ColdTracker:
    global _staging
    if _staging is None:
        _staging = tiering.ColdTracker("kv_staging")
    return _staging


def untrack_staging(entry: "KVPageEntry") -> None:
    """Remove a page entry's components from this process's staging
    tracker (the prefix cache takes ownership at insert)."""
    if _staging is None:
        return
    for ref in entry.refs.values():
        _staging.untrack(ref.id.binary())


class KVShipError(Exception):
    """KV pages failed to ship or adopt (sealed copy lost, injected fault,
    a page lacking a component). Always recoverable by re-prefilling the
    prompt."""

    #: shipped typed through the actor plane (core/worker.py
    #: _as_task_error): the scheduler classifies on this type to take the
    #: re-prefill leg instead of the re-adopt leg
    _rt_error_passthrough = True


def _core():
    from ray_tpu_torch.core import api

    return api.get_core()


@dataclass
class KVPageEntry:
    """One KV page: component refs (``k``/``v``, or ``k.q``/``k.s``/
    ``v.q``/``v.s`` for int8 pools), each sealing a ``[L, PS, KV(, hd)]``
    host array, the node whose arena sealed them, and the payload byte
    count.

    The ``(tier, spill_path, spill_offset)`` leg is ADVISORY tiering
    metadata (core/tiering.py): tier-1 means the sealing node moved the
    bytes to its spill directory. Consumers never branch on it (the object
    plane restores on the next get or pull); the cache and ledgers use it
    to tell a disk hit from a shm hit."""

    refs: dict[str, ObjectRef]
    node: bytes | None = None
    nbytes: int = 0
    tier: int = tiering.TIER_SHM
    spill_path: str = ""
    spill_offset: int = 0


@dataclass
class KVPageManifest:
    """Token ids and page refs for one prompt's KV (the ShardManifest shape
    at page granularity). ``token_ids`` covers the prompt positions the
    pages hold, ``len(pages) * page_size`` rounded down to the prompt
    length. Pickling ships the manifest and its refs ride the borrower
    protocol, so every holder owns real borrows on the pages."""

    token_ids: tuple
    page_size: int
    kv_dtype: str  # "native" | "bf16" | "int8"
    pages: list[KVPageEntry] = field(default_factory=list)

    @property
    def n_tokens(self) -> int:
        return len(self.token_ids)

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.pages)

    def full_pages(self) -> int:
        """Pages completely covered by token_ids, the shareable span (the
        last page of a ragged prompt is partly written and only adoptable
        by a request whose prefix covers all its tokens)."""
        return self.n_tokens // self.page_size

    def prefix(self, n_pages: int) -> "KVPageManifest":
        """Sub-manifest over the first ``n_pages`` pages, sharing the page
        entries (and so the refs): the cache-insert view."""
        n_pages = min(n_pages, self.n_pages)
        return KVPageManifest(
            token_ids=tuple(self.token_ids[: n_pages * self.page_size]),
            page_size=self.page_size,
            kv_dtype=self.kv_dtype,
            pages=self.pages[:n_pages],
        )


def manifest_nbytes(m: KVPageManifest) -> int:
    """Deterministic wire-size estimate of the manifest (what crosses the
    RPC plane for a disagg request): header + token ids + ~(oid + owner
    address + node id) per component ref."""
    n_refs = sum(len(p.refs) for p in m.pages)
    return 48 + 8 * len(m.token_ids) + 96 * n_refs


# ------------------------------------------------------------ pool slicing
def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device->host copy as numpy; bfloat16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_host(a: np.ndarray) -> torch.Tensor:
    """The host array as a CPU tensor; uint16 bits back to bfloat16."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _pool_components(pool, page_ids) -> dict[str, np.ndarray]:
    """Host copies of the selected pages, page-major, one array per pool
    component: ``{"": [n, L, PS, KV, hd]}`` for plain pools, ``{"q": ...,
    "s": ...}`` for int8, so each page is one contiguous block to seal.
    One gather (and the page-major copy) on the pool's device and ONE
    device->host copy per component, queued after everything already
    queued there that writes the pool; the host waits for it."""
    parts = pool if isinstance(pool, dict) else {"": pool}
    out = {}
    for name, t in parts.items():
        idx = torch.as_tensor(np.asarray(page_ids, np.int64), device=t.device)
        out[name] = _to_host(t[:, idx].transpose(0, 1).contiguous())
    return out


def _chaos_kv_ship(phase: str, **ctx):
    """Fire the ``llm.kv_ship`` fault point; map injected faults onto the
    plane's real failure surface (KVShipError)."""
    try:
        act = chaos.point("llm.kv_ship", phase=phase, **ctx)
    except chaos.ChaosError as e:
        raise KVShipError(f"kv_ship {phase}: {e}") from e
    if act is not None and act.kind == "drop":
        # "the pages were lost in flight": the scheduler's recovery
        # window, a re-prefill from the cached prefix or from scratch
        raise KVShipError(f"kv_ship {phase}: pages dropped (injected)")


def ship_pages(kpool, vpool, page_ids, token_ids, *, page_size: int,
               kv_dtype: str = "native", trace_ctx=None) -> KVPageManifest:
    """Seal the KV pages ``page_ids`` (pool row indices, prompt order)
    into the local shm arena and return their manifest.

    ``token_ids`` are the prompt tokens the pages cover. Runs where the
    pool lives (the prefill worker); callers only ever see the returned
    manifest. Needs the port's runtime (``ray_tpu_torch.init``).
    ``trace_ctx`` (an owning request's captured (trace_id, span_id)) tags
    the seal as a ``pull``-stage span in the request's trace when sampled.
    """
    core = _core()
    node = core.node_id.binary() if core.node_id is not None else None
    t0 = time.perf_counter_ns()
    kc = _pool_components(kpool, page_ids)
    vc = _pool_components(vpool, page_ids)
    entries: list[KVPageEntry] = []
    shipped = 0
    for i in range(len(page_ids)):
        if chaos.ENABLED:
            _chaos_kv_ship("seal", page=i)
        refs: dict[str, ObjectRef] = {}
        nbytes = 0
        for side, comps in (("k", kc), ("v", vc)):
            for name, arr in comps.items():
                page = arr[i]  # contiguous: the copy is page-major
                key = side if not name else f"{side}.{name}"
                refs[key] = core.put_value(page, prefer_shm=True)
                nbytes += int(page.nbytes)
        entry = KVPageEntry(refs=refs, node=node, nbytes=nbytes)
        entries.append(entry)
        shipped += nbytes
        if core.store is not None:
            tracker = _staging_tracker()
            per = max(1, nbytes // max(1, len(refs)))
            for ref in refs.values():
                tracker.track(ref.id.binary(), per, entry)
    m = KVPageManifest(token_ids=tuple(int(t) for t in token_ids),
                       page_size=int(page_size), kv_dtype=kv_dtype,
                       pages=entries)
    dt = time.perf_counter_ns() - t0
    telemetry.record(telemetry.KV_SHIP, dt, shipped, trace_ctx=trace_ctx)
    # ship_ns/ship_bytes (and adopt_*) split the kv_ship stage's time and
    # bytes by leg, for GB/s readings
    telemetry.count(pages_shipped=len(entries), kv_array_bytes=shipped,
                    kv_driver_bytes=manifest_nbytes(m), ship_ns=dt,
                    ship_bytes=shipped)
    return m


def _prefetch(core, pages, keys) -> None:
    """Cross-node adoption: pull every non-local page component in ONE
    batched ``pull_objects_batch`` round trip through the local raylet,
    hinted with each page's sealing node, so the get reads them zero-copy
    out of local shm. Same-node manifests skip it (everything is local).
    Best effort: the get keeps its per-ref pull and recovery fallbacks.
    Raises ``BackPressureError`` when the raylet's admission window shed
    part of the adoption; promotes restored pages' tier legs."""
    hints: dict = {}
    sizes: dict = {}
    owners: dict = {}
    for p in pages:
        per = max(1, p.nbytes // max(1, len(p.refs)))
        for k in keys:
            oid = p.refs[k].id
            if not core.store.contains(oid):
                hints.setdefault(oid, set()).add(p.node)
                sizes[oid] = per
                owners[oid.hex()] = (p, per)
    if len(hints) < 2:
        return
    t_pull = time.perf_counter_ns()
    try:
        res = core._run_sync(
            core.pull_objects_batch(
                hints, sizes=sizes,
                timeout_s=core.cfg.pull_admission_timeout_s),
            timeout=60)
    except Exception:
        # loop-resident caller, or a stalled pull hitting the bridge
        # timeout: strictly an optimization
        res = {}
        log.debug("batched KV prefetch skipped", exc_info=True)
    bp = (res or {}).get("_bp")
    if bp:
        # the admission window shed part of this adoption: typed
        # back-pressure, so the scheduler retries elsewhere instead of
        # overfilling this arena
        from ray_tpu_torch.serve.exceptions import BackPressureError

        raise BackPressureError(
            f"kv adoption shed by pull admission "
            f"({len(bp)}/{len(hints)} pages queued past deadline)",
            retry_after_s=float(max(bp.values())))
    restored = (res or {}).get("_restored") or ()
    if restored:
        disk_bytes = 0
        for h in restored:
            ent = owners.get(h)
            if ent is None:
                continue
            p, per = ent
            disk_bytes += per
            p.tier = tiering.TIER_SHM  # promoted back to shm by the restore
            p.spill_path = ""
        telemetry.record(telemetry.RESTORE, time.perf_counter_ns() - t_pull,
                         disk_bytes)
        telemetry.count(kv_disk_bytes=disk_bytes,
                        pages_restored=len(restored))


def adopt_pages(manifest: KVPageManifest,
                extra: KVPageManifest | None = None, *,
                role: str = "decode"):
    """Fetch a manifest's pages (zero-copy out of local shm on this thread
    when same-node, one batched get through the object plane otherwise)
    and stack them into
    scatter-ready ``(k_stack, v_stack)`` CPU tensors: ``[L, n, PS, KV,
    hd]`` each, or ``{"q", "s"}`` dicts for int8 pools.

    ``extra`` appends a second manifest's pages (a cached prefix plus the
    request's suffix adopt as ONE scatter). ``role`` is chaos context
    ("decode" for engine admission, "prefill" for a suffix wave's prefix
    adoption), so a fault plan can target one side of the plane. Raises
    :class:`KVShipError` on injected loss or a page that lacks a
    component of the first page, and ``ObjectLostError`` when a page's
    sealed bytes are gone and cannot be recovered.
    """
    from ray_tpu_torch.core import api

    pages = list(manifest.pages) + (list(extra.pages) if extra else [])
    if not pages:
        raise ValueError("empty manifest")
    if chaos.ENABLED:
        _chaos_kv_ship("adopt", pages=len(pages), role=role)
    t0 = time.perf_counter_ns()
    keys = sorted(pages[0].refs)
    for i, p in enumerate(pages):
        if sorted(p.refs) != keys:
            raise KVShipError(f"adopt: page {i} holds {sorted(p.refs)}, "
                              f"page 0 holds {keys}")
    core = _core()
    flat = [p.refs[k] for p in pages for k in keys]
    vals: list = [None] * len(flat)
    if core.store is not None:
        _prefetch(core, pages, keys)
        # components sealed in this node's arena are read zero-copy on this
        # thread: api.get of a BORROWED ref hops onto the core loop, which
        # in a decode worker is busy dispatching decode blocks (the async
        # actor's methods run there), so each adoption would wait behind
        # them; whatever is not local goes through api.get below
        for i, ref in enumerate(flat):
            hit = core.store.try_get(ref.id)
            if hit is not None and isinstance(hit[0], np.ndarray):
                vals[i] = hit[0]
    miss = [i for i, v in enumerate(vals) if v is None]
    if miss:
        for i, v in zip(miss, api.get([flat[i] for i in miss])):
            vals[i] = v
    nk = len(keys)
    fetched = sum(int(getattr(v, "nbytes", 0)) for v in vals)

    def stack(side: str):
        out = {}
        for j, ck in enumerate(keys):
            part = ck.split(".")
            if part[0] == side:
                name = part[1] if len(part) > 1 else ""
                out[name] = _from_host(np.stack(
                    [vals[i * nk + j] for i in range(len(pages))], axis=1))
        return out[""] if list(out) == [""] else out

    k_stack, v_stack = stack("k"), stack("v")
    dm = manifest_nbytes(manifest) + (manifest_nbytes(extra) if extra else 0)
    dt = time.perf_counter_ns() - t0
    telemetry.record(telemetry.KV_SHIP, dt, fetched)  # in the request's context
    telemetry.count(pages_adopted=len(pages), adoptions=1,
                    kv_array_bytes=fetched, kv_driver_bytes=dm, adopt_ns=dt,
                    adopt_bytes=fetched)
    return k_stack, v_stack
