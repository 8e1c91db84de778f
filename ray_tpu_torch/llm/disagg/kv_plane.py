"""KV-page plane: paged-KV slices as host page objects.

Counterpart of ``ray_tpu/llm/disagg/kv_plane.py``, in one process. A
prefill pool holds a prompt's KV in page rows (``[L, page, PS, KV, hd]``
per pool); :func:`ship_pages` gathers the produced pages on the card,
copies them to host memory (one copy per pool component) and returns a
:class:`KVPageManifest`: token ids and one :class:`KVPageEntry` of numpy
components per page. Where the JAX package seals each page into a shared
memory arena and ships object refs, the port's entries hold the host
arrays themselves: the manifest is the page data, and a decode worker in
the same process adopts it directly. :func:`adopt_pages` stacks a
manifest's pages into the scatter-ready ``(k_stack, v_stack)`` that
``ContinuousBatchingEngine.submit_prefilled`` and ``scatter_pages`` take.

Pages are int8-KV aware: a quantized pool ships its ``q``/``s`` components
as separate arrays (``k.q``, ``k.s``, ``v.q``, ``v.s``). numpy has no
bfloat16, so a bf16 component is held as its uint16 bit pattern and
turned back into a bfloat16 tensor by :func:`adopt_pages`; no pool
component is ever uint16.

Page granularity makes the pages shareable: a cached prefix of ``k`` full
pages is exactly the first ``k`` entries of any manifest over the same
token prefix, so the prefix cache (prefix_cache.py) keeps page entries and
a suffix prefill reuses them as they are.

Left out, as they ride on the JAX package's runtime: the shm arena, the
object plane's pulls, tiering (spill and restore) and the ``llm.kv_ship``
chaos point.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch.llm.disagg import telemetry


class KVShipError(Exception):
    """KV pages failed to ship or adopt (a page lacks a component).
    Always recoverable by re-prefilling the prompt."""


@dataclass
class KVPageEntry:
    """One KV page: its host components (``k``/``v``, or ``k.q``/``k.s``/
    ``v.q``/``v.s`` for int8 pools), each ``[L, PS, KV(, hd)]``, and the
    payload byte count. ``node`` is None: every page lives in this
    process."""

    refs: dict[str, np.ndarray]
    node: bytes | None = None
    nbytes: int = 0


@dataclass
class KVPageManifest:
    """Token ids and page entries for one prompt's KV. ``token_ids``
    covers the prompt positions the pages hold, ``len(pages) *
    page_size`` rounded down to the prompt length."""

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
        entries: the cache-insert view."""
        n_pages = min(n_pages, self.n_pages)
        return KVPageManifest(
            token_ids=tuple(self.token_ids[: n_pages * self.page_size]),
            page_size=self.page_size,
            kv_dtype=self.kv_dtype,
            pages=self.pages[:n_pages],
        )


def manifest_nbytes(m: KVPageManifest) -> int:
    """Deterministic wire-size estimate of the manifest, the JAX plane's
    formula: header + token ids + ~(oid + owner address + node id) per
    component. The port sends no manifest over a wire; the estimate keeps
    the ledger's ``kv_driver_bytes`` comparable."""
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
    """Host copies of the selected pages, one array per pool component:
    ``{"": [L, n, PS, KV, hd]}`` for plain pools, ``{"q": ..., "s": ...}``
    for int8. One gather on the pool's device and ONE device->host copy
    per component."""
    parts = pool if isinstance(pool, dict) else {"": pool}
    out = {}
    for name, t in parts.items():
        idx = torch.as_tensor(np.asarray(page_ids, np.int64), device=t.device)
        out[name] = _to_host(t[:, idx])
    return out


def ship_pages(kpool, vpool, page_ids, token_ids, *, page_size: int,
               kv_dtype: str = "native", trace_ctx=None) -> KVPageManifest:
    """Copy the KV pages ``page_ids`` (pool row indices, prompt order) to
    host memory and return their manifest. ``token_ids`` are the prompt
    tokens the pages cover. The copies are queued on the pool's device
    after everything already queued there that writes the pool, and the
    host waits for them."""
    t0 = time.perf_counter_ns()
    kc = _pool_components(kpool, page_ids)
    vc = _pool_components(vpool, page_ids)
    entries: list[KVPageEntry] = []
    shipped = 0
    for i in range(len(page_ids)):
        refs: dict[str, np.ndarray] = {}
        nbytes = 0
        for side, comps in (("k", kc), ("v", vc)):
            for name, arr in comps.items():
                page = np.ascontiguousarray(arr[:, i])
                refs[side if not name else f"{side}.{name}"] = page
                nbytes += int(page.nbytes)
        entries.append(KVPageEntry(refs=refs, nbytes=nbytes))
        shipped += nbytes
    m = KVPageManifest(token_ids=tuple(int(t) for t in token_ids),
                       page_size=int(page_size), kv_dtype=kv_dtype,
                       pages=entries)
    telemetry.record(telemetry.KV_SHIP, time.perf_counter_ns() - t0,
                     shipped, trace_ctx=trace_ctx)
    telemetry.count(pages_shipped=len(entries), kv_array_bytes=shipped,
                    kv_driver_bytes=manifest_nbytes(m))
    return m


def adopt_pages(manifest: KVPageManifest,
                extra: KVPageManifest | None = None, *,
                role: str = "decode"):
    """Stack a manifest's pages into scatter-ready ``(k_stack, v_stack)``
    CPU tensors: ``[L, n, PS, KV, hd]`` each, or ``{"q", "s"}`` dicts for
    int8 pools. ``extra`` appends a second manifest's pages (a cached
    prefix plus the request's suffix adopt as ONE scatter). ``role``
    ("decode" or "prefill") keeps the JAX signature, where it tags a
    fault-injection point. Raises :class:`KVShipError` for a page that
    lacks a component of the first page."""
    pages = list(manifest.pages) + (list(extra.pages) if extra else [])
    if not pages:
        raise ValueError("empty manifest")
    t0 = time.perf_counter_ns()
    keys = sorted(pages[0].refs)
    for i, p in enumerate(pages):
        if sorted(p.refs) != keys:
            raise KVShipError(f"adopt: page {i} holds {sorted(p.refs)}, "
                              f"page 0 holds {keys}")
    fetched = sum(int(p.refs[k].nbytes) for p in pages for k in keys)

    def stack(side: str):
        out = {}
        for ck in keys:
            part = ck.split(".")
            if part[0] == side:
                name = part[1] if len(part) > 1 else ""
                out[name] = _from_host(
                    np.stack([p.refs[ck] for p in pages], axis=1))
        return out[""] if list(out) == [""] else out

    k_stack, v_stack = stack("k"), stack("v")
    dm = manifest_nbytes(manifest) + (manifest_nbytes(extra) if extra else 0)
    telemetry.record(telemetry.KV_SHIP, time.perf_counter_ns() - t0, fetched)
    telemetry.count(pages_adopted=len(pages), adoptions=1,
                    kv_array_bytes=fetched, kv_driver_bytes=dm)
    return k_stack, v_stack
