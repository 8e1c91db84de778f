"""In-process metrics registry.

Equivalent of the reference stats layer (ref:
src/ray/stats/metric_defs.cc metric definitions, python/ray/util/metrics.py
user-facing Counter/Gauge/Histogram). Each process keeps one registry;
component code records locally (lock-free dict bumps on the hot path) and
the core client piggybacks periodic snapshots to the GCS KV
(ns="metrics", key=worker hex) on the task-event flush timer, where the
state API aggregates them cluster-wide.

Snapshot format: each metric exports structured ``samples`` —
``{"tags": {...}, "value": v}`` (counters/gauges) or
``{"tags": {...}, "counts": [...], "sum": s}`` (histograms) — so
``state.prometheus_metrics()`` can emit real labels without reparsing
stringified tag tuples, and the GCS rollup plane
(``core/metrics_store.py``) can window counter deltas and merge
histogram buckets across sources. Counters are monotonic cumulatives on
the wire; rates live GCS-side (``state.metric_window``), never here.
"""
from __future__ import annotations

import threading
import time
from typing import Sequence


class Metric:
    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        _registry.register(self)

    def _key(self, tags: dict | None) -> tuple:
        if not tags:
            return ()
        return tuple(sorted(tags.items()))


class Counter(Metric):
    def __init__(self, name, description="", tag_keys=()):
        self._values: dict[tuple, float] = {}
        super().__init__(name, description, tag_keys)

    def inc(self, value: float = 1.0, tags: dict | None = None):
        k = self._key(tags)
        self._values[k] = self._values.get(k, 0.0) + value

    def snapshot(self):
        return {"type": "counter",
                "samples": [{"tags": dict(k), "value": v}
                            for k, v in self._values.items()]}


class Gauge(Metric):
    def __init__(self, name, description="", tag_keys=()):
        self._values: dict[tuple, float] = {}
        super().__init__(name, description, tag_keys)

    def set(self, value: float, tags: dict | None = None):
        self._values[self._key(tags)] = value

    def snapshot(self):
        return {"type": "gauge",
                "samples": [{"tags": dict(k), "value": v}
                            for k, v in self._values.items()]}


class Histogram(Metric):
    """Fixed-boundary histogram (ref: metrics.py Histogram)."""

    def __init__(self, name, description="", boundaries: Sequence[float] = (), tag_keys=()):
        self.boundaries = tuple(boundaries) or (
            0.001, 0.01, 0.1, 1.0, 10.0, 100.0, 1000.0
        )
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float, tags: dict | None = None):
        k = self._key(tags)
        counts = self._counts.setdefault(k, [0] * (len(self.boundaries) + 1))
        i = 0
        while i < len(self.boundaries) and value > self.boundaries[i]:
            i += 1
        counts[i] += 1
        self._sums[k] = self._sums.get(k, 0.0) + value

    def observe_many(self, values, tags: dict | None = None):
        """Bulk feed (flush-time batches, e.g. the flight recorder's
        sampled stage latencies): one key lookup + bisect per value
        instead of a linear boundary scan per observe."""
        from bisect import bisect_left

        k = self._key(tags)
        counts = self._counts.setdefault(k, [0] * (len(self.boundaries) + 1))
        b = self.boundaries
        total = 0.0
        for v in values:
            counts[bisect_left(b, v)] += 1
            total += v
        self._sums[k] = self._sums.get(k, 0.0) + total

    def snapshot(self):
        return {
            "type": "histogram",
            "boundaries": list(self.boundaries),
            "samples": [{"tags": dict(k), "counts": list(c),
                         "sum": self._sums.get(k, 0.0)}
                        for k, c in self._counts.items()],
        }


class _Registry:
    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric):
        with self._lock:
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ts": time.time(),
                "metrics": {name: m.snapshot() for name, m in self._metrics.items()},
            }


_registry = _Registry()


def registry() -> _Registry:
    return _registry


# --- core runtime metrics (ref: metric_defs.cc tasks/objects families) ------
tasks_submitted = Counter("rt_tasks_submitted", "tasks submitted by this process")
tasks_finished = Counter("rt_tasks_finished", "task replies applied, by outcome",
                         tag_keys=("outcome",))
actor_calls = Counter("rt_actor_calls", "actor method calls submitted")
objects_put = Counter("rt_objects_put", "objects created via put")
object_bytes_put = Counter("rt_object_bytes_put", "bytes written via put")
objects_spilled = Counter("rt_objects_spilled", "objects spilled to disk")
objects_restored = Counter("rt_objects_restored", "spilled objects restored")
# memory tiering (PR 18): byte-granular spill/restore traffic plus the
# prefix cache's tier-1 effectiveness (set from cache stats)
spill_bytes_total = Counter("rt_spill_bytes_total",
                            "bytes written to tier-1 spill files")
restore_bytes_total = Counter("rt_restore_bytes_total",
                              "bytes restored from tier-1 into shm arenas")
tier1_hit_rate = Gauge("rt_tier1_hit_rate",
                       "fraction of prefix-cache hits served from tier-1")
# arena watermarks (rollup plane): live/peak/capacity bytes per arena the
# tiering registry knows (core/tiering.py stats providers — prefix cache,
# shard plane, KV staging; the raylet hand-rolls the object_store cells
# into its own snapshot). Set at flush time from sample_arenas().
arena_bytes = Gauge("rt_arena_bytes", "live bytes in a tiering arena",
                    tag_keys=("arena",))
arena_peak_bytes = Gauge("rt_arena_peak_bytes",
                         "high-water bytes a tiering arena has held",
                         tag_keys=("arena",))
arena_capacity_bytes = Gauge("rt_arena_capacity_bytes",
                             "configured capacity of a tiering arena",
                             tag_keys=("arena",))
task_exec_seconds = Histogram("rt_task_exec_seconds", "worker-side task execution time")

# --- flight-recorder families (PR 4; see utils/recorder.py) -----------------
# Per-stage fast-lane latency. Fed at flush time from the recorder's
# retained sample window (bounded batch per flush — Dapper-style
# sampling under load), NOT per task: the hot path pays one ring store.
task_stage_seconds = Histogram(
    "rt_task_stage_seconds",
    "fast-lane per-stage task latency (sampled by the flight recorder)",
    boundaries=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0),
    tag_keys=("stage",))
task_stage_us = Gauge(
    "rt_task_stage_us",
    "fast-lane per-stage latency percentiles over the recorder window (µs)",
    tag_keys=("stage", "q"))
recorder_samples = Gauge(
    "rt_recorder_samples", "per-task latency samples recorded (lifetime)")
# --- LLM decode-plane signals (llm/disagg/telemetry.py) ---------------------
# Published per decode-worker process; the disagg scheduler and serve
# router admit on tokens-in-flight + page headroom instead of request
# counts (cross-replica decode batching), and the spec-decode gauges are
# the same numbers the bench's A/B arm reports.
llm_decode_tokens_in_flight = Gauge(
    "rt_llm_decode_tokens_in_flight",
    "decode tokens still owed by this process's LLM engine")
llm_spec_accept_rate = Gauge(
    "rt_llm_spec_accept_rate",
    "speculative-decode draft acceptance rate (lifetime ratio)")
llm_tokens_per_step = Gauge(
    "rt_llm_tokens_per_step",
    "tokens emitted per fused decode step (recent-block mean)")
# monotonic spec-decode cumulatives: the rollup plane's derived
# llm_spec_accept_rate series is accepted/proposed per window slot —
# restart-safe and windowable, unlike the lifetime-ratio gauge above
llm_spec_proposed_total = Counter(
    "rt_llm_spec_proposed_total",
    "draft tokens proposed to the fused spec-decode verify")
llm_spec_accepted_total = Counter(
    "rt_llm_spec_accepted_total",
    "draft tokens the fused spec-decode verify accepted")
# serve SLO cumulatives: serve_slo_breach_fraction = breaches/requests
# per window slot (boundary-free, unlike bucketing latencies at the SLO)
serve_requests_total = Counter(
    "rt_serve_requests_total", "serve requests completed by a replica",
    tag_keys=("key",))
serve_slo_breaches_total = Counter(
    "rt_serve_slo_breaches_total",
    "serve requests that finished over their deployment's latency SLO",
    tag_keys=("key",))
# NOTE: rt_request_critical_path_us (the GCS trace assembler's per-stage
# request-latency histogram) is deliberately NOT declared here: the GCS
# hand-rolls its cells (core/gcs.py _trace_metrics_tick) because an
# in-process GCS shares this process-global registry with the driver,
# and publishing the shared snapshot under a second kv key would
# double-count every driver metric.
# Native shm transport counters (ring.cc RingStats / store.cc StoreStats),
# summed over live lanes and set at flush time.
fastpath_ring = Gauge(
    "rt_fastpath_ring",
    "shm task-ring counters summed over live lanes (ring.cc RingStats)",
    tag_keys=("which", "stat"))
object_store_stat = Gauge(
    "rt_object_store",
    "shm arena counters (store.cc StoreStats)",
    tag_keys=("stat",))
