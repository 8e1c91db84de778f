"""Disagg-serving telemetry: per-stage windows and the byte/op ledger.

Counterpart of ``ray_tpu/llm/disagg/telemetry.py``, in process: every
disagg operation records (stage, duration_ns) into a bounded window per
stage (``prefill_queue``, ``kv_ship``, ``decode_queue``, plus the derived
``ttft``/``tpot`` and the speculative block metrics), read back with
:func:`stage_window`. The counter ledger (:func:`count`,
:func:`counters`, :func:`reset_counters`) backs the data-movement
accounting: ``kv_array_bytes`` counts KV page payload bytes copied between
the card and host memory, ``kv_driver_bytes`` the manifest metadata that
would cross a process boundary. The JAX package's Prometheus feeds,
flight recorder, trace spans and GCS publish ride on its runtime and are
left out; :func:`capture_trace_ctx` returns None.
"""
from __future__ import annotations

import threading

PREFILL_QUEUE = "prefill_queue"
KV_SHIP = "kv_ship"
DECODE_QUEUE = "decode_queue"
TTFT = "ttft"
TPOT = "tpot"
# speculative-decoding block metrics, scaled integers in the same windows:
# tokens_per_step in milli-tokens/step, spec_accept_rate in rate x 1e6
TOKENS_PER_STEP = "tokens_per_step"
SPEC_ACCEPT = "spec_accept_rate"
STAGES = (PREFILL_QUEUE, KV_SHIP, DECODE_QUEUE, TTFT, TPOT,
          TOKENS_PER_STEP, SPEC_ACCEPT)

_WINDOW_CAP = 2048

_lock = threading.Lock()
_windows: dict[str, list[int]] = {s: [] for s in STAGES}
_counters = {"kv_driver_bytes": 0, "kv_array_bytes": 0,
             "pages_shipped": 0, "pages_adopted": 0,
             "prefills": 0, "suffix_prefills": 0, "adoptions": 0,
             # kept for the JAX ledger's keys: the port has no disk tier
             "kv_disk_bytes": 0, "pages_restored": 0}


def record(stage: str, dur_ns: int, nbytes: int = 0, trace_ctx=None) -> None:
    """One disagg stage event into the stage's bounded window. ``nbytes``
    and ``trace_ctx`` keep the JAX signature; the byte count goes to the
    ledger through :func:`count`."""
    dur_ns = max(0, int(dur_ns))
    with _lock:
        win = _windows[stage]
        win.append(dur_ns)
        if len(win) > _WINDOW_CAP:
            del win[: len(win) - _WINDOW_CAP]


def capture_trace_ctx():
    """The port has no request tracing: always None."""
    return None


def publish_decode_signals(engine) -> None:
    """Drain one engine's per-block speculative log into the stage windows
    and the ledger (the JAX version also refreshes its Prometheus gauges)."""
    st = engine.spec_stats(drain=True)
    for n_steps, emitted, proposed, accepted in st["blocks"]:
        record(TOKENS_PER_STEP, emitted * 1000 // max(1, n_steps))
        if proposed:
            record(SPEC_ACCEPT, accepted * 1_000_000 // proposed)
        count(spec_proposed=proposed, spec_accepted=accepted,
              spec_steps=n_steps, spec_tokens=emitted)


def count(**deltas: int) -> None:
    """Bump ledger counters (kv_driver_bytes, kv_array_bytes, ...). Unseen
    keys start at zero."""
    with _lock:
        for k, v in deltas.items():
            _counters[k] = _counters.get(k, 0) + int(v)


def counters() -> dict:
    with _lock:
        return dict(_counters)


def reset_counters() -> None:
    """Zero the byte/op counters (windows kept)."""
    with _lock:
        for k in _counters:
            _counters[k] = 0


def stage_window(stage: str) -> list[int]:
    """Copy of one stage's bounded duration window (ns)."""
    with _lock:
        return list(_windows[stage])


def _reset_for_tests() -> None:
    with _lock:
        for w in _windows.values():
            w.clear()
        for k in _counters:
            _counters[k] = 0
