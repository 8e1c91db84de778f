"""Distributed request tracing: sampled span context as a wire citizen.

Counterpart of the reference tracing layer (ref:
python/ray/util/tracing/tracing_helper.py:36-60 — there OTel span context
is injected into task specs by decorator wrappers and child spans open
around execution), grown the Dapper way (Sigelman et al., 2010): the
context ``(trace_id_128, span_id_64, sampled)`` rides the wire ITSELF —
packed fast-lane records and node-tunnel frames carry an optional
25-byte trace leg (core/fastpath.py, flag ``TRACED``) — so causality is
cheap enough to leave on in production. Spans use OTel-shaped ids
(128-bit trace, 64-bit span), ride the task-event pipeline into the GCS
trace assembler (``state.get_trace`` / ``state.list_traces``) and the
chrome timeline. If the ``opentelemetry`` API is installed and
configured, spans are mirrored onto it as well.

Enable with ``Config.tracing_enabled`` (env ``RT_TRACING_ENABLED=1``).
Sampling is HEAD-BASED (``Config.trace_sample_rate``): the decision is
made once where a trace starts (the serve router's root, a driver
``.remote()`` with no active context) and carried in the wire leg;
an unsampled request pays one contextvar read and one branch — the
chaos-gate cost model — and ships NO trace bytes.

Propagation model: a contextvar holds the active (trace_id, span_id).
Submitting a task captures it into the spec (``trace_ctx``) or the
packed record's trace leg; executing a task opens a child span and
activates it for the duration of the user function, so nested
``.remote()`` calls chain parent -> child across any number of
processes and transports (shm ring, node tunnel, RPC).

Span ids come from a per-process random prefix + counter — one urandom
syscall per process, not per span (the per-call ``os.urandom`` measured
~288µs under the syscall-intercepting sandbox, the same hot-path cost
PR 8 and PR 11 evicted from task and promise ids).
"""

from __future__ import annotations

import contextvars
import itertools
import os
import struct
import threading as _threading
import time

from ray_tpu_torch.config import get_config

_ctx: contextvars.ContextVar[tuple[str, str] | None] = contextvars.ContextVar(
    "rt_trace_ctx", default=None)

# Span clock: durations come from perf_counter_ns (monotonic, ns
# resolution — time.time() collapses sub-ms spans to zero on coarse
# clocks and a wall-clock step mid-span would yield a NEGATIVE
# duration); one wall anchor captured at import reconstructs absolute
# start/end times for the timeline.
_ANCHOR_PERF_NS = time.perf_counter_ns()
_ANCHOR_WALL_NS = time.time_ns()


def _wall_s(t_perf_ns: int) -> float:
    return (_ANCHOR_WALL_NS + (t_perf_ns - _ANCHOR_PERF_NS)) / 1e9

try:  # probe ONCE: a failed import per span would be a hot-path tax
    from opentelemetry import trace as _otel_trace
except Exception:  # pragma: no cover - otel genuinely optional
    _otel_trace = None


def enabled() -> bool:
    return get_config().tracing_enabled


# ------------------------------------------------------------------ id gen
# Prefix + counter, the TaskID.generate scheme (utils/ids.py): ONE
# urandom per process; the counter's next() is a single GIL-atomic C
# step so user threads and the loop thread can mint ids concurrently.
# 128/64-bit OTel shapes are kept: trace ids are 9 random bytes + a
# 7-byte counter, span ids 4 random bytes + 4-byte counter.
_gen_lock = _threading.Lock()
_trace_prefix: bytes = b""
_trace_counter = None
_span_prefix: bytes = b""
_span_counter = None


def _gen_trace_id() -> str:
    global _trace_prefix, _trace_counter
    if _trace_counter is None:
        with _gen_lock:
            if _trace_counter is None:
                _trace_prefix = os.urandom(9)  # raylint: disable=RT021 -- one-time prefix init, counter per call
                _trace_counter = itertools.count()
    n = next(_trace_counter) % (1 << 56)
    return (_trace_prefix + n.to_bytes(7, "little")).hex()


def _gen_span_id() -> str:
    global _span_prefix, _span_counter
    if _span_counter is None:
        with _gen_lock:
            if _span_counter is None:
                _span_prefix = os.urandom(4)  # raylint: disable=RT021 -- one-time prefix init, counter per call
                _span_counter = itertools.count()
    n = next(_span_counter) % (1 << 32)
    return (_span_prefix + n.to_bytes(4, "little")).hex()


def _reset_prefixes() -> None:
    global _trace_prefix, _trace_counter, _span_prefix, _span_counter
    with _gen_lock:
        _trace_prefix = b""
        _trace_counter = None
        _span_prefix = b""
        _span_counter = None


if hasattr(os, "register_at_fork"):  # a fork child must mint fresh ids
    os.register_at_fork(after_in_child=_reset_prefixes)


# ---------------------------------------------------------------- sampling
# Head-based, deterministic: every Nth root is sampled (N derived from
# trace_sample_rate), so the unsampled path is one counter bump + one
# compare — no RNG, no syscall. The decision is carried in the wire
# leg's sampled bit; children never re-decide.
_sample_counter = itertools.count()
_stride_cache: tuple[float, int] | None = None


def sample() -> bool:
    """One head-sampling decision (call only where a trace would START)."""
    global _stride_cache
    rate = get_config().trace_sample_rate
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    cached = _stride_cache
    if cached is None or cached[0] != rate:
        cached = _stride_cache = (rate, max(1, round(1.0 / rate)))
    return next(_sample_counter) % cached[1] == 0


# ------------------------------------------------------------- wire format
# The 25-byte trace leg packed records carry (core/fastpath.py, wire
# 2.1): <16s trace_id><8s span_id><B flags> — flags bit0 = sampled.
# Unsampled requests ship NO leg at all; the leg's presence is flagged
# by the record's TRACE_CTX bit / the reply's TRACED status flag.
_WIRE = struct.Struct("<16s8sB")
WIRE_LEN = _WIRE.size  # 25


def pack_ctx(trace_id: str, span_id: str, sampled: bool = True) -> bytes:
    return _WIRE.pack(bytes.fromhex(trace_id), bytes.fromhex(span_id),
                      1 if sampled else 0)


def unpack_ctx(leg: bytes) -> dict:
    tid, sid, flags = _WIRE.unpack_from(leg)
    return {"trace_id": tid.hex(), "parent_span_id": sid.hex(),
            "sampled": bool(flags & 1)}


# Sentinel an UNSAMPLED root installs in the contextvar: the head
# decision is per REQUEST, so downstream submits inside an unsampled
# request must not re-draw (each stray draw would mint an orphan
# partial trace AND consume a stride tick, skewing the configured rate).
UNSAMPLED = ("", "")


def current() -> tuple[str, str] | None:
    """(trace_id, span_id) of the active span, if any."""
    ctx = _ctx.get()
    return None if ctx is UNSAMPLED else ctx


def suppress():
    """Mark the current context UNSAMPLED (a root that lost the head
    draw): downstream :func:`submit_context` calls inherit the decision
    instead of re-drawing. Returns a token for :func:`deactivate`."""
    return _ctx.set(UNSAMPLED)


def is_suppressed() -> bool:
    return _ctx.get() is UNSAMPLED


def inject() -> dict:
    """Capture the caller's span context for a task spec; starts a fresh
    trace when the caller has none (every traced task belongs to some
    trace — the reference behaves the same for root calls). Does NOT
    apply sampling: use :func:`submit_context` on request paths."""
    ctx = _ctx.get()
    if ctx is None or ctx is UNSAMPLED:
        return {"trace_id": _gen_trace_id(), "parent_span_id": None}
    return {"trace_id": ctx[0], "parent_span_id": ctx[1]}


def submit_context() -> dict | None:
    """Sampling-aware :func:`inject`: inherit the active (already
    decided) context, or head-sample a fresh root. None = this request
    is unsampled — ship nothing, record nothing."""
    ctx = _ctx.get()
    if ctx is not None:
        if ctx is UNSAMPLED:
            return None  # decided at the request's root: no re-draw
        return {"trace_id": ctx[0], "parent_span_id": ctx[1]}
    if not sample():
        return None
    return {"trace_id": _gen_trace_id(), "parent_span_id": None}


class span:
    """Context manager recording one span into ``sink`` (a callable
    taking the span dict — typically the task-event buffer's emit).
    Extra ``attributes`` land in the span dict verbatim; ``stage``
    (queue | exec | wire | pull) and ``transport`` (ring | tunnel |
    rpc) are the ones TraceCriticalPath understands."""

    def __init__(self, name: str, trace_ctx: dict | None, sink,
                 **attributes):
        self.name = name
        self.sink = sink
        self.attributes = attributes
        ctx = trace_ctx or inject()
        self.trace_id = ctx["trace_id"]
        self.parent_span_id = ctx.get("parent_span_id")
        self.span_id = _gen_span_id()
        self._token = None
        self._otel = None

    def __enter__(self):
        self._t0_ns = time.perf_counter_ns()
        self.start = _wall_s(self._t0_ns)
        self._token = _ctx.set((self.trace_id, self.span_id))
        if _otel_trace is not None:
            try:  # optional mirror onto a configured OTel SDK
                self._otel = _otel_trace.get_tracer("ray_tpu_torch").start_span(
                    self.name)
            except Exception:
                self._otel = None
        return self

    def __exit__(self, exc_type, exc, tb):
        _ctx.reset(self._token)
        # same monotonic clock as __enter__: end >= start ALWAYS, and a
        # 2µs span reports 2µs instead of 0.0
        end = self.start + (time.perf_counter_ns() - self._t0_ns) / 1e9
        if self._otel is not None:
            try:
                self._otel.end()
            except Exception:  # raylint: disable=RT012 — optional exporter must never break user code
                pass
        self.sink({
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "start_ts": self.start,
            "end_ts": end,
            "error": repr(exc) if exc is not None else None,
            **self.attributes,
        })
        return False


def emit_point(name: str, trace_ctx: dict, sink, **attributes) -> str:
    """Record a zero-duration span (the submit-side marker) and return
    its span id — the parent the executing side's child span links to."""
    span_id = _gen_span_id()
    now = _wall_s(time.perf_counter_ns())
    sink({
        "trace_id": trace_ctx["trace_id"], "span_id": span_id,
        "parent_span_id": trace_ctx.get("parent_span_id"),
        "name": name, "start_ts": now, "end_ts": now,
        **attributes,
    })
    return span_id


def emit_retro(name: str, trace_ctx: dict, sink, dur_s: float,
               **attributes) -> str:
    """Record a span for an operation that already FINISHED (duration
    known after the fact — the disagg telemetry shape, where stage
    durations are measured first and reported once)."""
    span_id = _gen_span_id()
    end = _wall_s(time.perf_counter_ns())
    sink({
        "trace_id": trace_ctx["trace_id"], "span_id": span_id,
        "parent_span_id": trace_ctx.get("parent_span_id"),
        "name": name, "start_ts": end - max(0.0, dur_s), "end_ts": end,
        **attributes,
    })
    return span_id


def activate(trace_ctx: dict | None):
    """Set the ambient context from a spec's trace_ctx WITHOUT opening a
    span (thread-side helper); returns a reset token or None."""
    if not trace_ctx:
        return None
    return _ctx.set((trace_ctx["trace_id"],
                     trace_ctx.get("parent_span_id") or _gen_span_id()))


def deactivate(token) -> None:
    if token is not None:
        _ctx.reset(token)


# -------------------------------------------------------- critical path
class TraceCriticalPath:
    """Attribute one assembled trace's latency to stages.

    Walks the span tree of one request and splits the root span's wall
    time into ``queue`` (admission/batch queues), ``exec`` (user code),
    ``wire`` (submit/reply hops, routing), ``pull`` (object/KV-page
    movement) and ``other`` — each span's SELF time (its duration minus
    the union of its children's overlap) is charged to its stage, so
    concurrent children never double-bill the parent. The result feeds
    the ``request_critical_path_us`` metrics and the ``/api/trace/<id>``
    waterfall's stage strip.
    """

    STAGES = ("queue", "exec", "wire", "pull", "other")

    @staticmethod
    def classify(s: dict) -> str:
        stage = s.get("stage")
        if stage in TraceCriticalPath.STAGES:
            return stage
        name = s.get("name", "")
        if name.endswith("::run") or name.endswith("::exec"):
            return "exec"
        if name.endswith(".remote") or name.endswith("::call"):
            return "wire"
        if "queue" in name or "admission" in name:
            return "queue"
        if ("adopt" in name or "ship" in name or "pull" in name
                or "kv_" in name):
            return "pull"
        return "other"

    @staticmethod
    def compute(spans: list[dict]) -> dict | None:
        """-> {total_us, stages: {stage: us}, root_span_id, path: [span
        ids root->leaf along the latest-finishing chain]} or None for an
        empty/parentless span set."""
        if not spans:
            return None
        by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
        children: dict[str | None, list[dict]] = {}
        for s in spans:
            children.setdefault(s.get("parent_span_id"), []).append(s)
        roots = [s for s in spans
                 if s.get("parent_span_id") not in by_id]
        if not roots:
            return None
        root = min(roots, key=lambda s: s.get("start_ts", 0.0))
        stages = {st: 0.0 for st in TraceCriticalPath.STAGES}

        def self_time(s: dict) -> float:
            dur = max(0.0, s.get("end_ts", 0.0) - s.get("start_ts", 0.0))
            kids = children.get(s.get("span_id"), ())
            if not kids:
                return dur
            # union of child intervals clipped to this span
            ivs = sorted(
                (max(k["start_ts"], s["start_ts"]),
                 min(k["end_ts"], s["end_ts"])) for k in kids)
            covered = 0.0
            cur_a = cur_b = None
            for a, b in ivs:
                if b <= a:
                    continue
                if cur_b is None or a > cur_b:
                    if cur_b is not None:
                        covered += cur_b - cur_a
                    cur_a, cur_b = a, b
                else:
                    cur_b = max(cur_b, b)
            if cur_b is not None:
                covered += cur_b - cur_a
            return max(0.0, dur - covered)

        # attribute self time over the whole tree under the chosen root
        seen = set()
        stack = [root]
        tree_end = root.get("end_ts", 0.0)
        while stack:
            s = stack.pop()
            sid = s.get("span_id")
            if sid in seen:
                continue
            seen.add(sid)
            tree_end = max(tree_end, s.get("end_ts", 0.0))
            stages[TraceCriticalPath.classify(s)] += self_time(s)
            stack.extend(children.get(sid, ()))
        # critical chain: from the root, follow the latest-finishing child
        path = [root["span_id"]]
        cur = root
        while True:
            kids = [k for k in children.get(cur.get("span_id"), ())
                    if k.get("span_id") not in path]
            if not kids:
                break
            cur = max(kids, key=lambda k: k.get("end_ts", 0.0))
            path.append(cur["span_id"])
        # total spans the whole tree, not just the root's own interval —
        # a driver-rooted trace's root is a zero-duration submit POINT
        # whose children carry all the time
        total = max(0.0, tree_end - root.get("start_ts", 0.0))
        return {
            "total_us": total * 1e6,
            "stages": {st: v * 1e6 for st, v in stages.items()},
            "root_span_id": root["span_id"],
            "root_name": root.get("name"),
            "path": path,
        }
