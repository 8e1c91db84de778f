"""Sharded-plane telemetry: stage windows, Prometheus feeds, byte counters.

A copy of ``ray_tpu/sharded/telemetry.py`` onto the port's
``utils/metrics`` and ``utils/recorder``. Every sharded operation records
(stage, duration_ns, nbytes), stages ``shard_seal`` / ``shard_fetch`` /
``reshard``, into

- the process flight-recorder ring (utils/recorder.py stage ids 12-14),
  so postmortems show which shard op a process died inside;
- ``metrics.task_stage_seconds`` histograms + ``task_stage_us``
  percentile gauges (Prometheus/dashboard, same families as the task
  stages);
- a bounded per-process latency window published on the task-event
  flush timer under GCS ns="latency" (key ``<worker>.sharded``) so
  the GCS's latency view merges the sharded stages beside
  ring_sub/exec/... with no extra surface.

Byte counters back the zero-copy claim: ``driver_bytes`` counts only
manifest/descriptor metadata that crossed the driver; ``array_bytes``
counts shard payload bytes that moved via shm and the device instead.
"""

from __future__ import annotations

import threading

from ray_tpu_torch.utils import metrics, recorder

SHARD_SEAL = "shard_seal"
SHARD_FETCH = "shard_fetch"
RESHARD = "reshard"
STAGES = (SHARD_SEAL, SHARD_FETCH, RESHARD)

_REC_STAGE = {SHARD_SEAL: recorder.SHARD_SEAL,
              SHARD_FETCH: recorder.SHARD_FETCH,
              RESHARD: recorder.RESHARD}

_WINDOW_CAP = 1024

_lock = threading.Lock()
_windows: dict[str, list[int]] = {s: [] for s in STAGES}
_count = 0
_published = -1
_snapped = -1  # _count at the last snapshot handed to the flush
# process-lifetime counters, like the metrics registry: totals span
# init/shutdown cycles within one process (reset_counters for A/B runs)
_counters = {"driver_bytes": 0, "array_bytes": 0,
             "shards_sealed": 0, "shards_fetched": 0, "reshards": 0}
_registered_core = None  # the CoreClient the latency source is attached to


def record(stage: str, dur_ns: int, nbytes: int = 0) -> None:
    """One sharded-plane stage event. ms-scale ops, so the histogram
    observe happens inline (no deferred decode needed, unlike the
    sub-µs task stages)."""
    global _count
    dur_ns = max(0, int(dur_ns))
    with _lock:
        win = _windows[stage]
        win.append(dur_ns)
        if len(win) > _WINDOW_CAP:
            del win[: len(win) - _WINDOW_CAP]
        _count += 1
        if stage == SHARD_SEAL:
            _counters["shards_sealed"] += 1
            _counters["array_bytes"] += nbytes
        elif stage == SHARD_FETCH:
            _counters["shards_fetched"] += 1
        else:
            _counters["reshards"] += 1
    metrics.task_stage_seconds.observe(dur_ns / 1e9, tags={"stage": stage})
    rec = recorder.get_recorder()
    if rec is not None:
        rec.record(b"", _REC_STAGE[stage],
                   a0=min(dur_ns, 0xFFFFFFFF),
                   a1=nbytes & 0xFFFFFFFF, a2=(nbytes >> 32) & 0xFFFFFFFF)
    _maybe_register()


def count_driver_bytes(n: int) -> None:
    """Metadata bytes (manifests, shard descriptors) that crossed the
    driver for a sharded op — the O(manifest) side of the ledger."""
    with _lock:
        _counters["driver_bytes"] += int(n)


def counters() -> dict:
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    """Bench A/B support: zero the byte/op counters (windows kept)."""
    with _lock:
        for k in _counters:
            _counters[k] = 0


def snapshot_if_fresh() -> dict | None:
    """Latency-source hook (CoreClient.add_latency_source): the bounded
    stage windows in the ns="latency" publish format, or None when no
    new sharded op happened since the last CONFIRMED publish.
    ``mark_published`` advances the cursor only once the flush's kv_put
    landed — a transient GCS error republishes this window next tick."""
    global _snapped
    with _lock:
        if _count == _published:
            return None
        _snapped = _count
        stages = {s: list(w) for s, w in _windows.items() if w}
    if not stages:
        return None
    for name, vals in stages.items():
        svals = sorted(vals)
        for q, qn in ((0.5, "p50"), (0.99, "p99")):
            metrics.task_stage_us.set(
                recorder.percentile(svals, q) / 1e3,
                tags={"stage": name, "q": qn})
    # no "count" key: list_task_latency's tasks_total must keep counting
    # TASKS — the per-stage counts below come from the stage lists
    return {"stages": stages}


def mark_published() -> None:
    """Publish confirmation from the flush (kv_put landed)."""
    global _published
    with _lock:
        _published = _snapped


def _maybe_register() -> None:
    """Attach the sharded window to the CURRENT CoreClient's latency
    publish loop (idempotent per core; skipped quietly before a core
    exists). Tracked by core identity, not a boolean: an init ->
    shutdown -> init cycle builds a fresh CoreClient whose
    _latency_sources starts empty — a sticky flag would silently stop
    publishing the sharded stages for the second session."""
    global _registered_core
    from ray_tpu_torch.core import api

    core = api._core
    if core is None or core is _registered_core:
        return
    try:
        core.add_latency_source("sharded", snapshot_if_fresh,
                                confirm=mark_published)
        _registered_core = core
    except AttributeError:
        pass


def _reset_for_tests() -> None:
    global _count, _published, _snapped, _registered_core
    with _lock:
        for w in _windows.values():
            w.clear()
        _count = 0
        _published = -1
        _snapped = -1
        _registered_core = None
        for k in _counters:
            _counters[k] = 0
