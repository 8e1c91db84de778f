"""Disagg-serving telemetry: stage windows, Prometheus feeds, byte ledger.

Counterpart of ``ray_tpu/llm/disagg/telemetry.py``. Every disagg operation
records (stage, duration_ns, nbytes): stages ``prefill_queue`` /
``kv_ship`` / ``decode_queue``, the derived request metrics ``ttft`` /
``tpot``, the speculative block metrics, and the tiering legs ``spill`` /
``restore``. Each event lands in

- the process flight-recorder ring (utils/recorder.py stage ids 15-17,
  20-21), so a postmortem shows which serving leg a worker died inside;
- ``metrics.task_stage_seconds`` histograms and ``task_stage_us``
  percentile gauges (Prometheus and the dashboard, the families the task
  and sharded stages feed);
- a bounded per-process latency window, published on the runtime's
  task-event flush under GCS ns="latency" (key ``<worker>.llm``), so
  ``state.list_task_latency()`` merges the serving stages beside the
  task stages;
- a retro span in the owning request's trace when it is sampled
  (:func:`traced`, :func:`capture_trace_ctx`).

The byte ledger backs the zero-copy claim: ``kv_driver_bytes`` counts
only the manifest metadata that crosses an RPC frame; ``kv_array_bytes``
counts KV page payload bytes that moved through the shm arena or the
object plane instead.
"""

from __future__ import annotations

import contextlib
import threading

from ray_tpu_torch.utils import metrics, recorder

PREFILL_QUEUE = "prefill_queue"
KV_SHIP = "kv_ship"
DECODE_QUEUE = "decode_queue"
TTFT = "ttft"
TPOT = "tpot"
# speculative-decoding block metrics (scaled integers riding the same
# ns-valued windows: tokens_per_step is stored in MILLI-tokens/step and
# spec_accept_rate in rate×1e6, so the generic µs percentile columns of
# state.list_task_latency() read as tokens/step and rate×1e3)
TOKENS_PER_STEP = "tokens_per_step"
SPEC_ACCEPT = "spec_accept_rate"
# memory tiering: time a spill request / a tier-1 restore took, nbytes =
# the disk-leg payload moved
SPILL = "spill"
RESTORE = "restore"
STAGES = (PREFILL_QUEUE, KV_SHIP, DECODE_QUEUE, TTFT, TPOT,
          TOKENS_PER_STEP, SPEC_ACCEPT, SPILL, RESTORE)

# ttft/tpot are request-level derived metrics: they live in the latency
# window + Prometheus but not in the per-op recorder ring
_REC_STAGE = {PREFILL_QUEUE: recorder.PREFILL_QUEUE,
              KV_SHIP: recorder.KV_SHIP,
              DECODE_QUEUE: recorder.DECODE_QUEUE,
              SPILL: recorder.SPILL,
              RESTORE: recorder.RESTORE}

_WINDOW_CAP = 2048

_lock = threading.Lock()
_windows: dict[str, list[int]] = {s: [] for s in STAGES}
_count = 0
_published = -1
_snapped = -1
_counters = {"kv_driver_bytes": 0, "kv_array_bytes": 0,
             "pages_shipped": 0, "pages_adopted": 0,
             "prefills": 0, "suffix_prefills": 0, "adoptions": 0,
             # disk-leg split of the byte ledger: payload bytes that
             # came back from tier-1 instead of staying shm-resident
             "kv_disk_bytes": 0, "pages_restored": 0}
_registered_core = None


# request-trace stage class per disagg stage (TraceCriticalPath's
# vocabulary): queue waits vs page movement; ttft/tpot are derived
# request metrics, not operations — they get no span
_SPAN_STAGE = {PREFILL_QUEUE: "queue", DECODE_QUEUE: "queue",
               KV_SHIP: "pull", SPILL: "pull", RESTORE: "pull"}


def record(stage: str, dur_ns: int, nbytes: int = 0,
           trace_ctx=None) -> None:
    """One disagg stage event (ms-scale ops: inline histogram observe).

    When the owning request is SAMPLED (ambient trace context, or an
    explicitly captured ``trace_ctx`` (trace_id, span_id) tuple for
    wave-coalesced work running outside the request's context), the
    event additionally lands as a retro span in the request's trace —
    so a disagg request's waterfall shows its queue waits and KV-page
    movement beside the prefill/decode exec spans."""
    global _count
    dur_ns = max(0, int(dur_ns))
    with _lock:
        win = _windows[stage]
        win.append(dur_ns)
        if len(win) > _WINDOW_CAP:
            del win[: len(win) - _WINDOW_CAP]
        _count += 1
    metrics.task_stage_seconds.observe(dur_ns / 1e9, tags={"stage": stage})
    rec_stage = _REC_STAGE.get(stage)
    if rec_stage is not None:
        rec = recorder.get_recorder()
        if rec is not None:
            rec.record(b"", rec_stage,
                       a0=min(dur_ns, 0xFFFFFFFF),
                       a1=nbytes & 0xFFFFFFFF,
                       a2=(nbytes >> 32) & 0xFFFFFFFF)
    span_stage = _SPAN_STAGE.get(stage)
    if span_stage is not None:
        from ray_tpu_torch.utils import tracing

        if tracing.enabled():
            ctx = trace_ctx or tracing.current()
            sink = _span_sink()
            if ctx is not None and sink is not None:
                tracing.emit_retro(
                    f"disagg::{stage}",
                    {"trace_id": ctx[0], "parent_span_id": ctx[1]},
                    sink, dur_ns / 1e9, stage=span_stage, nbytes=nbytes)
    _maybe_register()


def capture_trace_ctx():
    """The ambient (trace_id, span_id) when this request is sampled, or
    None — captured ONCE where a request enters a coalescing queue (the
    prefill wave, the decode ring) so batch-stamped telemetry can keep
    attributing work to the right trace outside the request's context
    (the raylint RT016 shape: never re-derive per loop iteration)."""
    from ray_tpu_torch.utils import tracing

    if not tracing.enabled():
        return None
    return tracing.current()


def traced(name: str, stage: str = "exec"):
    """Child span around one disagg leg when the ambient request is
    sampled; a no-op context manager otherwise. Used by the scheduler
    for the prefill/adopt/decode legs of a request."""
    from ray_tpu_torch.utils import tracing

    if not tracing.enabled():
        return contextlib.nullcontext()
    ctx = tracing.current()
    sink = _span_sink()
    if ctx is None or sink is None:
        return contextlib.nullcontext()
    return tracing.span(name, {"trace_id": ctx[0], "parent_span_id": ctx[1]},
                        sink, stage=stage)


def _span_sink():
    """Span rows ride the same task-event flush everything else uses."""
    from ray_tpu_torch.core import api

    core = api._core
    if core is None:
        return None

    def sink(s):
        core.task_events.emit(name=s["name"], state="SPAN", span=s,
                              worker_id=core.worker_id.hex())
    return sink


def publish_decode_signals(engine) -> None:
    """Drain one engine's per-block speculative log into the stage
    windows and refresh the decode-plane gauges — called by the decode
    worker after each request and from ``headroom()`` probes, so the
    scheduler's admission signal, Prometheus, the dashboard LLM panel
    and the bench all read the SAME numbers."""
    st = engine.spec_stats(drain=True)
    for n_steps, emitted, proposed, accepted in st["blocks"]:
        record(TOKENS_PER_STEP, emitted * 1000 // max(1, n_steps))
        if proposed:
            record(SPEC_ACCEPT, accepted * 1_000_000 // proposed)
            # monotonic cumulatives for the rollup plane: the GCS
            # derives the windowed llm_spec_accept_rate series
            # (state.metric_window) from these two counters' deltas
            metrics.llm_spec_proposed_total.inc(proposed)
            metrics.llm_spec_accepted_total.inc(accepted)
        count(spec_proposed=proposed, spec_accepted=accepted,
              spec_steps=n_steps, spec_tokens=emitted)
    metrics.llm_decode_tokens_in_flight.set(engine.tokens_in_flight())
    if st["spec_proposed"]:
        metrics.llm_spec_accept_rate.set(st["spec_accept_rate"])
    win = stage_window(TOKENS_PER_STEP)
    if win:
        metrics.llm_tokens_per_step.set(
            sum(win[-64:]) / len(win[-64:]) / 1000.0)


def count(**deltas: int) -> None:
    """Bump ledger counters (kv_driver_bytes, kv_array_bytes, ...).
    Unseen keys start at zero — recovery-path counters
    (duplicate_prefills, ...) only exist on runs that took that path."""
    with _lock:
        for k, v in deltas.items():
            _counters[k] = _counters.get(k, 0) + int(v)


def counters() -> dict:
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    """Bench A/B support: zero the byte/op counters (windows kept)."""
    with _lock:
        for k in _counters:
            _counters[k] = 0


def stage_window(stage: str) -> list[int]:
    """Copy of one stage's bounded duration window (ns) — the bench arm
    reads ttft/tpot percentiles from here without a GCS round trip."""
    with _lock:
        return list(_windows[stage])


def snapshot_if_fresh() -> dict | None:
    """Latency-source hook (CoreClient.add_latency_source): the bounded
    stage windows in the ns="latency" publish format, or None when
    nothing new happened since the last CONFIRMED publish."""
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
    return {"stages": stages}


def mark_published() -> None:
    """Publish confirmation from the flush (kv_put landed)."""
    global _published
    with _lock:
        _published = _snapped


def _maybe_register() -> None:
    """Attach this window to the CURRENT CoreClient's latency publish
    loop (idempotent per core identity — an init/shutdown/init cycle
    re-registers on the fresh core, same invariant as the sharded
    source)."""
    global _registered_core
    from ray_tpu_torch.core import api

    core = api._core
    if core is None or core is _registered_core:
        return
    try:
        core.add_latency_source("llm", snapshot_if_fresh,
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
