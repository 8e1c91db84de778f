"""Streaming SLOs: time-to-first-chunk and inter-chunk gaps.

A streaming request has no single e2e latency — its health is TTFC (how
long until the consumer sees anything) and the inter-chunk gap tail (does
the stream stall mid-generation when decode batches saturate). Both are
recorded into the SAME per-process serve latency windows the unary plane
uses (replica.py ``_record_request_latency``), under prefixed keys:

    ``ttfc:<app>/<dep>``   one sample per stream, arrival -> first chunk
    ``gap:<app>/<dep>``    one sample per chunk after the first

so everything downstream works unmodified: the windows publish as
``serve_ttfc:<key>`` / ``serve_gap:<key>`` stages on the ns="latency"
plane, the controller's ``_refresh_p99`` strips the ``serve_`` prefix and
lands ``ttfc:<key>`` / ``gap:<key>`` p99s, the rollup plane's
``serve_slo_breach_fraction`` ratio is already tagged per key, and the
burn monitor + autoscaler pick whichever signal (e2e, TTFC, gap) is
burning hottest (controller.py ``_autoscale``).

Imports from ``ray_tpu_torch.serve.replica`` happen lazily inside functions:
replica.py imports this module at stream time, so a top-level import
here would be circular.
"""
from __future__ import annotations

import time

TTFC_PREFIX = "ttfc:"
GAP_PREFIX = "gap:"


def record_ttfc(key: str, dur_ns: int, slo_ns: float | None = None) -> None:
    from ray_tpu_torch.serve.replica import _record_request_latency

    _record_request_latency(TTFC_PREFIX + key, dur_ns, slo_ns)


def record_gap(key: str, dur_ns: int, slo_ns: float | None = None) -> None:
    from ray_tpu_torch.serve.replica import _record_request_latency

    _record_request_latency(GAP_PREFIX + key, dur_ns, slo_ns)


class StreamLatencyTracker:
    """Per-stream recorder: call :meth:`on_chunk` once per yielded item.

    First chunk records TTFC against ``ttfc_slo_ns`` (falling back to the
    deployment's unary SLO when unset: a stream's first token racing the
    whole-response budget is the conservative default); every later chunk
    records the gap since the previous one against ``gap_slo_ns``."""

    __slots__ = ("key", "ttfc_slo_ns", "gap_slo_ns", "_t_prev", "chunks")

    def __init__(self, key: str, ttfc_slo_ns: float | None,
                 gap_slo_ns: float | None,
                 t_arrival_ns: int | None = None):
        self.key = key
        self.ttfc_slo_ns = ttfc_slo_ns
        self.gap_slo_ns = gap_slo_ns
        self._t_prev = (time.perf_counter_ns()
                        if t_arrival_ns is None else t_arrival_ns)
        self.chunks = 0

    def on_chunk(self) -> None:
        now = time.perf_counter_ns()
        if self.chunks == 0:
            record_ttfc(self.key, now - self._t_prev, self.ttfc_slo_ns)
        else:
            record_gap(self.key, now - self._t_prev, self.gap_slo_ns)
        self._t_prev = now
        self.chunks += 1
