"""GCS-side timeseries rollup plane (the cluster's metric history).

Equivalent of the reference stats aggregation layer (ref:
src/ray/stats/ + the dashboard's time-series export behind
``export_*.proto``): workers keep piggybacking registry snapshots into
the volatile ns="metrics" KV on the task-event flush timer, and the GCS
— which already sees every one of those puts in ``rpc_kv_put`` — folds
them into ring-buffered fixed windows here instead of only remembering
"now". Aggregation stays off the worker hot path (the Dapper/Monarch
shape the flight recorder already follows): the rollup cost rides the
1/s flush, never a task submit.

Three ideas, all restart-safe:

* **Counter deltas.** Snapshots carry monotonic cumulatives. Per
  (source, metric, tag-cell) the store remembers the last cumulative and
  windows the *delta*; a reset (worker restarted, registry re-created —
  the new cumulative is below the old) contributes the new cumulative
  itself, clamped >= 0, so a restart can never produce a negative rate.
* **Mergeable histograms.** Snapshots carry fixed-boundary bucket
  counts; deltas merge bucket-wise across sources, and quantiles come
  from the merged buckets (prometheus-style interpolation), so a
  cluster-wide p99 needs no raw samples.
* **Derived ratios.** Rate-of-two-counters series (spec-decode
  acceptance, serve SLO breach fraction) are computed slot-by-slot from
  their numerator/denominator deltas — boundary-free and correct across
  restarts, unlike averaging per-process lifetime gauges.

Windows exist at three resolutions (1s/10s/60s) with bounded retention;
``window()`` picks the finest resolution whose retention covers the
request. Everything in this module is plain dict/float state guarded by
one lock — no asyncio, no RPC — so tests can drive it directly.
"""
from __future__ import annotations

import threading
import time

# (resolution seconds, retained slots): 1s for 3 min, 10s for 1 h,
# 60s for 4 h — bounded memory no matter how long the cluster lives.
RESOLUTIONS = (1, 10, 60)
RETENTION_SLOTS = {1: 180, 10: 360, 60: 240}

# Derived ratio series: name -> (numerator counter, denominator counter).
# Registered by default so `state.metric_window("llm_spec_accept_rate",
# 10)` works with no extra wiring anywhere else.
DEFAULT_RATIOS = {
    "llm_spec_accept_rate": ("rt_llm_spec_accepted_total",
                             "rt_llm_spec_proposed_total"),
    "serve_slo_breach_fraction": ("rt_serve_slo_breaches_total",
                                  "rt_serve_requests_total"),
}


def bucket_quantile(boundaries, counts, q: float) -> float:
    """Quantile from fixed-boundary bucket counts (prometheus
    histogram_quantile shape: linear interpolation inside the bucket,
    the +Inf bucket clamps to the last finite boundary)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            lo = boundaries[i - 1] if i > 0 else 0.0
            hi = boundaries[i] if i < len(boundaries) else boundaries[-1]
            frac = (rank - (cum - c)) / c
            return lo + (hi - lo) * frac
    return float(boundaries[-1]) if boundaries else 0.0


def _tag_key(tags: dict | None) -> tuple:
    return tuple(sorted((tags or {}).items()))


class RollupStore:
    """Multi-resolution windowed rollups over per-source registry
    snapshots. One instance lives on the GCS; ``ingest`` is called from
    ``rpc_kv_put`` for every ns="metrics" publish (source = the kv key:
    worker hex, "gcs", "raylet.<node>")."""

    def __init__(self, ratios: dict | None = None):
        self._lock = threading.Lock()
        self._types: dict[str, str] = {}
        self._bounds: dict[str, tuple] = {}
        # (source, name, tagkey) -> last counter cumulative
        self._last_counter: dict[tuple, float] = {}
        # (source, name, tagkey) -> (bucket counts tuple, sum)
        self._last_hist: dict[tuple, tuple] = {}
        # res -> slot epoch -> name -> tagkey -> cell
        #   counter cell: float delta          gauge cell: {source: value}
        #   histogram cell: {"counts": [...], "sum": float}
        self._slots: dict[int, dict[int, dict]] = {r: {} for r in RESOLUTIONS}
        self._ratios = dict(DEFAULT_RATIOS if ratios is None else ratios)
        # source -> last ingest wall ts (stale-source GC for the delta maps)
        self._source_seen: dict[str, float] = {}

    # -------------------------------------------------------------- ingest
    def ingest(self, source: str, snap: dict, now: float | None = None):
        """Fold one registry snapshot (``{"metrics": {name: {...}}}``)
        into every resolution's current slot. Arrival-timestamped: slot
        alignment uses the GCS clock, not the publisher's."""
        now = time.time() if now is None else now
        metrics = (snap or {}).get("metrics") or {}
        with self._lock:
            self._source_seen[source] = now
            for name, m in metrics.items():
                kind = m.get("type")
                samples = m.get("samples")
                if kind not in ("counter", "gauge", "histogram") or \
                        samples is None:
                    continue
                self._types[name] = kind
                if kind == "histogram":
                    self._bounds[name] = tuple(m.get("boundaries") or ())
                for s in samples:
                    tkey = _tag_key(s.get("tags"))
                    if kind == "counter":
                        self._ingest_counter(source, name, tkey,
                                             float(s.get("value", 0.0)), now)
                    elif kind == "gauge":
                        self._ingest_gauge(source, name, tkey,
                                           float(s.get("value", 0.0)), now)
                    else:
                        self._ingest_hist(source, name, tkey,
                                          s.get("counts") or [],
                                          float(s.get("sum", 0.0)), now)
            self._evict(now)

    def _cell(self, res: int, now: float, name: str, tkey: tuple,
              default):
        slot = int(now) - int(now) % res
        by_name = self._slots[res].setdefault(slot, {})
        return by_name.setdefault(name, {}).setdefault(tkey, default)

    def _ingest_counter(self, source, name, tkey, cum, now):
        key = (source, name, tkey)
        last = self._last_counter.get(key)
        # restart-safe delta: a reset (cum < last) counts the new
        # cumulative itself — clamped >= 0, never a negative rate
        delta = cum if (last is None or cum < last) else cum - last
        self._last_counter[key] = cum
        if delta <= 0:
            return
        for res in RESOLUTIONS:
            slot = int(now) - int(now) % res
            by_name = self._slots[res].setdefault(slot, {})
            cells = by_name.setdefault(name, {})
            cells[tkey] = cells.get(tkey, 0.0) + delta

    def _ingest_gauge(self, source, name, tkey, value, now):
        for res in RESOLUTIONS:
            cell = self._cell(res, now, name, tkey, None)
            if cell is None:
                slot = int(now) - int(now) % res
                cell = self._slots[res][slot][name][tkey] = {}
            cell[source] = value

    def _ingest_hist(self, source, name, tkey, counts, total, now):
        key = (source, name, tkey)
        cur = tuple(int(c) for c in counts)
        last = self._last_hist.get(key)
        if last is None or len(last[0]) != len(cur) or \
                any(c < p for c, p in zip(cur, last[0])):
            # first sight or reset: the whole cumulative is the delta
            dc, ds = cur, total
        else:
            dc = tuple(c - p for c, p in zip(cur, last[0]))
            ds = max(0.0, total - last[1])
        self._last_hist[key] = (cur, total)
        if not any(dc):
            return
        for res in RESOLUTIONS:
            cell = self._cell(res, now, name, tkey, None)
            if cell is None:
                slot = int(now) - int(now) % res
                cell = self._slots[res][slot][name][tkey] = {
                    "counts": [0] * len(dc), "sum": 0.0}
            if len(cell["counts"]) != len(dc):
                cell["counts"] = [0] * len(dc)
            cell["counts"] = [a + b for a, b in zip(cell["counts"], dc)]
            cell["sum"] += ds

    def _evict(self, now: float):
        for res in RESOLUTIONS:
            floor = (int(now) - int(now) % res) - res * RETENTION_SLOTS[res]
            slots = self._slots[res]
            for slot in [s for s in slots if s < floor]:
                del slots[slot]
        # delta maps for sources gone > 10 min keep no ghosts around
        dead = [s for s, ts in self._source_seen.items() if now - ts > 600.0]
        for s in dead:
            del self._source_seen[s]
            for m in (self._last_counter, self._last_hist):
                for key in [k for k in m if k[0] == s]:
                    del m[key]

    # --------------------------------------------------------------- query
    def _pick_res(self, secs: float) -> int:
        for res in RESOLUTIONS:
            if res * RETENTION_SLOTS[res] >= secs:
                return res
        return RESOLUTIONS[-1]

    def names(self) -> list[dict]:
        with self._lock:
            rows = [{"name": n, "type": t}
                    for n, t in sorted(self._types.items())]
            rows.extend({"name": n, "type": "ratio",
                         "num": num, "den": den}
                        for n, (num, den) in sorted(self._ratios.items()))
        return rows

    def window(self, name: str, secs: float, tags: dict | None = None,
               now: float | None = None) -> dict:
        """Rate/quantile series over the trailing ``secs`` seconds,
        oldest-first, one point per non-empty slot at the finest
        resolution whose retention covers the request. Counter points:
        ``{ts, value (delta), rate}``; gauge points: ``{ts, value}``
        (summed across sources/cells); histogram points: ``{ts, count,
        sum, rate, p50, p90, p99}``; ratio points: ``{ts, value, num,
        den}`` (slots with a zero denominator are skipped)."""
        now = time.time() if now is None else now
        with self._lock:
            ratio = self._ratios.get(name)
            if ratio is not None:
                return self._ratio_window(name, *ratio, secs, tags, now)
            kind = self._types.get(name)
            res = self._pick_res(secs)
            points = []
            if kind is not None:
                tkey = _tag_key(tags) if tags else None
                for slot, cells in self._iter_slots(name, res, secs, now):
                    if tkey is not None:
                        if tkey not in cells:
                            continue
                        picked = [cells[tkey]]
                    else:
                        picked = list(cells.values())
                    pt = self._point(kind, name, slot, res, picked)
                    if pt is not None:
                        points.append(pt)
            return {"name": name, "type": kind, "res": res,
                    "points": points}

    def _iter_slots(self, name, res, secs, now):
        """(slot, tag-cells) for every retained slot of ``name`` inside
        the window, ascending."""
        end = int(now) - int(now) % res
        start = end - (int(secs // res) * res)
        slots = self._slots[res]
        out = []
        for slot in sorted(slots):
            if slot < start or slot > end:
                continue
            cells = slots[slot].get(name)
            if cells:
                out.append((slot, cells))
        return out

    def _point(self, kind, name, slot, res, cells):
        if kind == "counter":
            delta = float(sum(cells))
            return {"ts": slot, "value": delta, "rate": delta / res}
        if kind == "gauge":
            # sum across sources and tag cells: per-arena bytes add up
            # to cluster bytes; filter by tags for one cell's value
            return {"ts": slot,
                    "value": float(sum(sum(c.values()) for c in cells))}
        counts = None
        total = 0.0
        for c in cells:
            if counts is None:
                counts = list(c["counts"])
            else:
                counts = [a + b for a, b in zip(counts, c["counts"])]
            total += c["sum"]
        if not counts:
            return None
        bounds = self._bounds.get(name, ())
        n = sum(counts)
        return {"ts": slot, "count": int(n), "sum": total,
                "rate": n / res,
                "p50": bucket_quantile(bounds, counts, 0.5),
                "p90": bucket_quantile(bounds, counts, 0.9),
                "p99": bucket_quantile(bounds, counts, 0.99)}

    def _ratio_window(self, name, num, den, secs, tags, now):
        res = self._pick_res(secs)
        tkey = _tag_key(tags) if tags else None

        def deltas(metric):
            out = {}
            for slot, cells in self._iter_slots(metric, res, secs, now):
                if tkey is not None:
                    if tkey in cells:
                        out[slot] = float(cells[tkey])
                else:
                    out[slot] = float(sum(cells.values()))
            return out

        nd, dd = deltas(num), deltas(den)
        points = []
        for slot in sorted(dd):
            d = dd[slot]
            if d <= 0:
                continue
            n = nd.get(slot, 0.0)
            points.append({"ts": slot, "value": n / d, "num": n, "den": d})
        return {"name": name, "type": "ratio", "res": res, "points": points}

    def export_rates(self, secs: float = 10.0,
                     now: float | None = None) -> dict:
        """Per-tag-cell trailing rates for every counter plus every
        derived ratio's trailing value — the compact feed
        ``state.prometheus_metrics`` renders as ``:rate10s`` families."""
        now = time.time() if now is None else now
        out: dict[str, dict] = {}
        with self._lock:
            res = self._pick_res(secs)
            for name, kind in self._types.items():
                if kind != "counter":
                    continue
                cells: dict[tuple, float] = {}
                for _slot, by_tag in self._iter_slots(name, res, secs, now):
                    for tkey, delta in by_tag.items():
                        cells[tkey] = cells.get(tkey, 0.0) + float(delta)
                if cells:
                    out[name] = {"type": "counter", "samples": [
                        {"tags": dict(tk), "rate": v / secs}
                        for tk, v in cells.items()]}
            for name, (num, den) in self._ratios.items():
                win = self._ratio_window(name, num, den, secs, None, now)
                pts = win["points"]
                if not pts:
                    continue
                n = sum(p["num"] for p in pts)
                d = sum(p["den"] for p in pts)
                if d > 0:
                    out[name] = {"type": "ratio", "samples": [
                        {"tags": {}, "rate": n / d}]}
        return out


class WatermarkTracker:
    """Live + peak byte watermarks with a short per-second peak ring, so
    consumers (the raylet's spill trigger, the dashboard) read recent
    *history* instead of whatever instant they happened to sample."""

    def __init__(self, ring_slots: int = 120, slot_s: float = 1.0):
        self.slot_s = float(slot_s)
        self.ring_slots = int(ring_slots)
        self.live = 0.0
        self.peak = 0.0  # lifetime high-water
        self._ring: dict[int, float] = {}  # slot epoch -> max live seen

    def note(self, live_bytes: float, now: float | None = None):
        now = time.time() if now is None else now
        self.live = float(live_bytes)
        if self.live > self.peak:
            self.peak = self.live
        slot = int(now / self.slot_s)
        cur = self._ring.get(slot)
        if cur is None or self.live > cur:
            self._ring[slot] = self.live
        floor = slot - self.ring_slots
        for s in [s for s in self._ring if s < floor]:
            del self._ring[s]

    def recent_peak(self, secs: float, now: float | None = None) -> float:
        """Max live bytes noted inside the trailing ``secs`` (includes
        the current live value — a window with no samples is just now)."""
        now = time.time() if now is None else now
        floor = int((now - secs) / self.slot_s)
        vals = [v for s, v in self._ring.items() if s >= floor]
        return max(vals) if vals else self.live

    def series(self, secs: float, now: float | None = None) -> list[tuple]:
        now = time.time() if now is None else now
        floor = int((now - secs) / self.slot_s)
        return sorted((s * self.slot_s, v) for s, v in self._ring.items()
                      if s >= floor)
