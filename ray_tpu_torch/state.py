"""Cluster state API + chrome-trace timeline export.

The port's copy of ``ray_tpu/state.py``, over the port's GCS and raylet
RPCs (ref: python/ray/util/state/api.py list_tasks/list_actors/
list_nodes/..., python/ray/_private/state.py:440 timeline export). All
queries hit the GCS tables the runtime already maintains; task events come
from the _TaskEventBuffer producers in every core client and worker.
Metric names keep the ``rt_`` prefix, so one Prometheus scrape config
reads either package's dashboard.

    import ray_tpu_torch
    from ray_tpu_torch import state

    state.list_tasks(filters=[("state", "=", "FINISHED")])
    state.list_actors()
    state.timeline("/tmp/trace.json")  # open in chrome://tracing / perfetto
"""
from __future__ import annotations

import json
import pickle
import time
from typing import Any


def _core():
    from ray_tpu_torch.core.api import get_core

    return get_core()


def _call(method: str, payload: dict | None = None):
    core = _core()
    return core._run_sync(core.gcs.call(method, payload or {}))


def _raylet_call(method: str, payload: dict, node_address: tuple | None):
    """Call the local raylet (or a named node's) with connection cleanup —
    the shared scaffolding for node-addressed state calls."""
    core = _core()

    async def fetch():
        if node_address is None or tuple(node_address) == tuple(core.raylet_address):
            conn = core.raylet
            owns = False
        else:
            from ray_tpu_torch.utils import rpc as _rpc

            conn = await _rpc.connect(*node_address, timeout=10)
            owns = True
        try:
            return await conn.call(method, payload)
        finally:
            if owns:
                await conn.close()

    return core._run_sync(fetch())


def get_log(worker_id: str, *, stream: str = "out", tail: int = 64 * 1024,
            node_address: tuple | None = None) -> str | None:
    """Tail a worker's captured stdout/stderr (ref: ray.util.state.get_log
    over the session log tree). ``worker_id`` may be a hex prefix; pass
    ``node_address`` for a worker on another node (defaults to the local
    raylet)."""
    return _raylet_call(
        "get_log", {"worker_id": worker_id, "stream": stream, "tail": tail},
        node_address)


def get_stack(worker_id: str, *, node_address: tuple | None = None) -> dict | None:
    """On-demand per-thread stack dump of a live worker (ref: the
    dashboard reporter's py-spy endpoint, profile_manager.py:82 — here the
    worker self-reports via RPC, so no ptrace capability is needed).
    ``worker_id`` may be a hex prefix; ``node_address`` targets a remote
    node's raylet."""
    return _raylet_call("dump_worker_stack", {"worker_id": worker_id},
                        node_address)


def get_heap_profile(worker_id: str, *, action: str = "snapshot",
                     top: int = 20,
                     node_address: tuple | None = None) -> dict | None:
    """On-demand heap profile of a live worker (ref: the dashboard
    reporter's memray endpoint, profile_manager.py:191 — here tracemalloc
    in-process, no external attach). Call once with action="start", let
    the workload run, then action="snapshot" returns the top allocation
    sites; action="stop" ends tracing. ``worker_id`` may be a hex
    prefix."""
    return _raylet_call(
        "heap_profile_worker",
        {"worker_id": worker_id, "action": action, "top": top},
        node_address)


def get_cpu_profile(worker_id: str, *, duration_s: float = 2.0,
                    interval_s: float = 0.01, format: str = "folded",
                    node_address: tuple | None = None):
    """Sampled CPU profile of a live worker (ref: the dashboard
    reporter's py-spy `record` endpoint, profile_manager.py:82 — here the
    worker samples its own threads, no ptrace). format="folded" returns
    {stack: count} (flamegraph.pl input); format="speedscope" returns a
    speedscope-format JSON document (load at speedscope.app)."""
    res = _raylet_call(
        "cpu_profile_worker",
        {"worker_id": worker_id, "duration_s": duration_s,
         "interval_s": interval_s},
        node_address)
    if res is None or format != "speedscope":
        return res
    return _folded_to_speedscope(res)


def _folded_to_speedscope(res: dict) -> dict:
    """Fold-map -> speedscope 'sampled' profile document."""
    frames: list[dict] = []
    frame_ix: dict[str, int] = {}
    samples: list[list[int]] = []
    weights: list[float] = []
    for stack, count in res.get("folded", {}).items():
        ixs = []
        for name in stack.split(";"):
            if name not in frame_ix:
                frame_ix[name] = len(frames)
                frames.append({"name": name})
            ixs.append(frame_ix[name])
        samples.append(ixs)
        weights.append(count * res.get("interval_s", 0.01))
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": f"worker {res.get('worker_id', '?')[:12]} "
                    f"(pid {res.get('pid')})",
            "unit": "seconds",
            "startValue": 0,
            "endValue": res.get("duration_s", 0),
            "samples": samples,
            "weights": weights,
        }],
    }


def _match(row: dict, filters) -> bool:
    for key, op, value in filters or ():
        have = row.get(key)
        if op in ("=", "=="):
            if str(have) != str(value):
                return False
        elif op == "!=":
            if str(have) == str(value):
                return False
        else:
            raise ValueError(f"unsupported filter op {op!r} (use '=' or '!=')")
    return True


# ------------------------------------------------------------------- listing
def list_tasks(filters=None, limit: int = 1000, detail: bool = False) -> list[dict]:
    """Latest lifecycle state per task, newest first (ref: state/api.py
    list_tasks). Filter keys: name, state, task_id, worker_id, node_id."""
    events = _call("get_task_events")
    _TERMINAL = ("FINISHED", "FAILED")
    latest: dict[str, dict] = {}
    # merge in timestamp order; a terminal state is never overwritten by a
    # non-terminal one (client FINISHED and worker RUNNING batches can
    # arrive in either order within a flush interval)
    for ev in sorted(events, key=lambda e: e.get("ts", 0)):
        tid = ev.get("task_id")
        if tid is None:
            continue
        merged = dict(latest.get(tid, {}))
        if merged.get("state") in _TERMINAL and ev.get("state") not in _TERMINAL:
            ev = {k: v for k, v in ev.items() if k not in ("state", "ts")}
        merged.update(ev)
        latest[tid] = merged
    rows = [r for r in latest.values() if _match(r, filters)]
    rows.sort(key=lambda r: r.get("ts", 0), reverse=True)
    rows = rows[:limit]
    if not detail:
        keep = ("task_id", "name", "state", "ts", "worker_id", "node_id",
                "actor_id", "duration_s", "error")
        rows = [{k: r[k] for k in keep if k in r} for r in rows]
    return rows


def list_task_events(limit: int = 10000) -> list[dict]:
    """Raw lifecycle event stream (every transition, not just the latest)."""
    return _call("get_task_events")[-limit:]


def list_spans(trace_id: str | None = None, limit: int = 1000,
               offset: int = 0) -> list[dict]:
    """Trace spans recorded through the task-event pipeline (ref:
    tracing_helper.py spans; enable with Config.tracing_enabled). Each row:
    trace_id / span_id / parent_span_id / name / start_ts / end_ts plus
    the task id and executing worker/node.

    Paginated newest-last: ``limit``/``offset`` are applied SERVER-side
    over the bounded span stream (``offset`` skips that many of the
    newest rows), so a long-lived cluster never ships its whole event
    ring per call. For one request's assembled tree prefer
    :func:`get_trace` — the GCS indexes spans per trace at ingest."""
    if trace_id is not None:
        # one trace: the assembler's bucket is the cheap, complete answer
        tr = _call("get_trace", {"trace_id": trace_id})
        spans = (tr or {}).get("spans", [])
        if offset:
            spans = spans[:-offset] if offset < len(spans) else []
        return spans[-limit:]
    events = _call("get_task_events",
                   {"span_only": True, "limit": limit, "offset": offset})
    return [{**ev["span"], "task_id": ev.get("task_id"),
             "worker_id": ev.get("worker_id"),
             "node_id": ev.get("node_id")}
            for ev in events if ev.get("span")]


def get_trace(trace_id: str) -> dict | None:
    """One assembled request trace from the GCS trace table:
    ``{trace_id, spans (start-sorted, each with worker/node/pid),
    start_ts, end_ts, dur_ms, n_spans, procs, critical_path}`` —
    ``critical_path`` is the TraceCriticalPath pass attributing the
    request's wall time to queue / exec / wire / pull self-time plus the
    latest-finishing span chain. None for an unknown (or evicted)
    trace id; eviction keeps the slowest ``Config.trace_slow_keep``
    fraction, so p99 outliers outlive the table cap."""
    return _call("get_trace", {"trace_id": trace_id})


def list_traces(limit: int = 100, offset: int = 0) -> list[dict]:
    """Assembled-trace summaries, newest first: ``{trace_id, root_name,
    start_ts, end_ts, dur_ms, n_spans, procs}`` (span bodies stay
    GCS-side; fetch one with :func:`get_trace`)."""
    return _call("list_traces", {"limit": limit, "offset": offset})


def list_slo_burn_events(key: str | None = None) -> list[dict]:
    """SLO error-budget burn-rate alerts fired by the serve controller's
    ``SLOBurnMonitor`` (newest last): ``{key, ts, severity (page|warn|
    ok), burn_fast, burn_slow, breach_fraction, slo_ms, budget}`` — the
    multiwindow alert fires when BOTH the fast and slow windows burn
    budget above their thresholds (pushed live on the ``slo_burn``
    pubsub channel beside ``serve_autoscale``). ``key`` filters to one
    "app/deployment"."""
    blob = _call("kv_get", {"ns": "serve", "key": "slo_burn_events"})
    if not blob:
        return []
    events = pickle.loads(blob)
    if key is not None:
        events = [e for e in events if e.get("key") == key]
    return events


def list_actors(filters=None, limit: int = 1000) -> list[dict]:
    rows = _call("list_actors")
    rows = [dict(r, actor_id=r["actor_id"].hex() if hasattr(r["actor_id"], "hex")
                 else r["actor_id"]) for r in rows]
    return [r for r in rows if _match(r, filters)][:limit]


def list_nodes(filters=None, limit: int = 1000) -> list[dict]:
    rows = _call("get_cluster")
    rows = [dict(r, node_id=r["node_id"].hex() if hasattr(r["node_id"], "hex")
                 else r["node_id"]) for r in rows]
    return [r for r in rows if _match(r, filters)][:limit]


def list_placement_groups(filters=None, limit: int = 1000) -> list[dict]:
    """Per-PG rows from the GCS table: ``pg_id``, ``bundles``,
    ``strategy``, ``state`` (PENDING / CREATED / RESCHEDULING / REMOVED),
    ``bundle_nodes`` (hex node id per bundle; ``None`` for a bundle whose
    node died and is being re-placed), ``reschedule_cause`` (the node
    loss behind the most recent repair) and ``reschedules`` (lifetime
    repair count). Filter e.g. ``[("state", "=", "RESCHEDULING")]`` to
    watch repairs in flight (the dashboard's /api/placement_groups serves
    the same rows)."""
    rows = _call("list_placement_groups")
    return [r for r in rows if _match(r, filters)][:limit]


def list_objects(limit: int = 1000) -> list[dict]:
    """Objects with registered shm locations (ref: list_objects — here the
    GCS object directory; owner-inlined objects aren't listed)."""
    keys = _call("kv_keys", {"ns": "obj_loc", "prefix": ""})[:limit]
    blobs = _call("kv_multi_get", {"ns": "obj_loc", "keys": keys})
    out = []
    for k in keys:
        blob = blobs.get(k)
        holders = pickle.loads(blob) if blob else set()
        out.append({"object_id": k, "locations": [h.hex() if isinstance(h, bytes)
                                                  else h for h in holders]})
    return out


def summary_tasks() -> dict:
    """Task counts grouped by (name, state) (ref: summarize_tasks)."""
    out: dict[str, dict[str, int]] = {}
    for row in list_tasks(limit=100_000):
        by_state = out.setdefault(row.get("name", "?"), {})
        st = row.get("state", "?")
        by_state[st] = by_state.get(st, 0) + 1
    return out


# ------------------------------------------------------------------- metrics
def cluster_metrics() -> dict[str, Any]:
    """Aggregate the per-process metric snapshots pushed to the GCS KV.

    Returns ``{name: {"type": ..., ["boundaries": ...,] "samples":
    [{"tags": {...}, "value": v} | {"tags": {...}, "counts": [...],
    "sum": s}]}}`` — tags stay structured end to end."""
    keys = _call("kv_keys", {"ns": "metrics", "prefix": ""})
    blobs = _call("kv_multi_get", {"ns": "metrics", "keys": keys})
    agg: dict[str, Any] = {}
    merged: dict[str, dict] = {}  # name -> tag-tuple -> cell
    for k in keys:
        blob = blobs.get(k)
        if not blob:
            continue
        snap = pickle.loads(blob)
        for name, m in snap.get("metrics", {}).items():
            slot = agg.setdefault(name, {"type": m["type"]})
            if "boundaries" in m:
                slot.setdefault("boundaries", m["boundaries"])
            cells = merged.setdefault(name, {})
            # structured samples only: the pre-1.7 stringified-tag
            # "values" format is gone (rollups never consumed it)
            for s in m.get("samples", []):
                tkey = tuple(sorted(s.get("tags", {}).items()))
                if m["type"] == "counter":
                    cell = cells.setdefault(tkey, {"value": 0.0})
                    cell["value"] += s.get("value", 0.0)
                elif m["type"] == "gauge":
                    cells[tkey] = {"value": s.get("value", 0.0)}
                else:  # histogram: merge counts and sums
                    counts = s.get("counts", [])
                    cell = cells.setdefault(
                        tkey, {"counts": [0] * len(counts), "sum": 0.0})
                    cell["counts"] = [a + b for a, b in
                                      zip(cell["counts"], counts)]
                    cell["sum"] += s.get("sum", 0.0)
    for name, cells in merged.items():
        agg[name]["samples"] = [{"tags": dict(tkey), **cell}
                                for tkey, cell in cells.items()]
    return agg


def metric_window(name: str, secs: float = 60.0,
                  tags: dict | None = None) -> dict:
    """Windowed history for one metric from the GCS rollup plane
    (core/metrics_store.py): ``{name, type, res, points}`` with one
    point per non-empty slot, oldest first, at the finest rollup
    resolution (1s/10s/60s) whose retention covers ``secs``.

    Counter points carry ``value`` (the slot's delta) and ``rate``
    (delta/resolution — restart-safe: a worker restart clamps to >= 0,
    never a negative rate). Histogram points carry ``count``/``sum``/
    ``rate`` plus merged-bucket ``p50``/``p90``/``p99``. Gauge points
    carry ``value`` summed across sources and tag cells (pass ``tags``
    to read one cell, e.g. ``tags={"arena": "prefix_cache"}``). Derived
    ratio series (``llm_spec_accept_rate``, ``serve_slo_breach_
    fraction``) are computed slot-by-slot from their numerator/
    denominator counter deltas — the same windows ``SLOBurnMonitor``
    and the drafter auto-selector consume."""
    return _call("metric_window", {"name": name, "secs": secs,
                                   "tags": tags})


def metric_names() -> list[dict]:
    """Every metric the rollup plane has seen (``[{name, type}]``) plus
    the derived ratio series it computes."""
    return _call("metric_names")


def prometheus_metrics() -> str:
    """Render the aggregated cluster metrics in the Prometheus text
    exposition format (ref: dashboard/modules/metrics — there a sidecar
    agent exposes OpenCensus metrics to a Prometheus scraper; here the
    dashboard's /metrics endpoint serves the same role directly).
    Labels come straight from the structured sample tags."""

    def esc(v) -> str:
        # exposition-format escaping: one bad label value must not make
        # Prometheus reject the whole scrape
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def labels(tags: dict, extra: str = "") -> str:
        inner = ",".join(f'{k}="{esc(v)}"' for k, v in sorted(tags.items()))
        if extra:
            inner = f"{inner},{extra}" if inner else extra
        return "{" + inner + "}" if inner else ""

    lines: list[str] = []
    for name, m in sorted(cluster_metrics().items()):
        pname = name.replace(".", "_").replace("-", "_")
        if not pname.startswith("rt_"):
            pname = "rt_" + pname  # runtime metrics are already rt_*
        kind = m["type"]
        lines.append(f"# TYPE {pname} {kind}")
        if kind in ("counter", "gauge"):
            for s in m.get("samples", []):
                lines.append(f"{pname}{labels(s['tags'])} {s['value']}")
            continue
        bounds = list(m.get("boundaries") or [])
        for s in m.get("samples", []):
            cum = 0
            for i, count in enumerate(s.get("counts", [])):
                cum += count
                le = bounds[i] if i < len(bounds) else "+Inf"
                extra = 'le="%s"' % le
                lines.append(
                    f"{pname}_bucket{labels(s['tags'], extra)} {cum}")
            lines.append(f"{pname}_sum{labels(s['tags'])} {s['sum']}")
            lines.append(f"{pname}_count{labels(s['tags'])} {cum}")
    # rate families from the rollup plane: one :rate10s gauge per
    # counter tag cell plus the derived ratio series, so a scraper gets
    # correctly-windowed rates without PromQL over raw cumulatives
    try:
        exported = _call("metric_export", {"secs": 10.0})
    except Exception:
        exported = {}
    for name, m in sorted(exported.items()):
        pname = name.replace(".", "_").replace("-", "_")
        if not pname.startswith("rt_"):
            pname = "rt_" + pname
        lines.append(f"# TYPE {pname}:rate10s gauge")
        for s in m.get("samples", []):
            lines.append(f"{pname}:rate10s{labels(s['tags'])} {s['rate']}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------- flight recorder
def list_task_latency() -> dict[str, dict]:
    """Per-stage fast-lane latency percentiles from the flight-recorder
    windows every process publishes on the task-event flush timer
    (utils/recorder.py). Stages: ring_sub (submit pack -> worker pop,
    the submit-ring hop), deserialize, exec (worker-side user function),
    ring_reply (exec end -> driver apply, the completion-ring hop) and
    total. Returns ``{stage: {count, p50_us, p99_us, mean_us, max_us}}``
    plus a ``"tasks_total"`` lifetime counter; empty dict when no
    fast-lane task has completed (recorder off / RPC-only workload)."""
    from ray_tpu_torch.utils import recorder as _rec

    keys = _call("kv_keys", {"ns": "latency", "prefix": ""})
    blobs = _call("kv_multi_get", {"ns": "latency", "keys": keys})
    stages: dict[str, list] = {}
    total_count = 0
    for k in keys:
        blob = blobs.get(k)
        if not blob:
            continue
        snap = pickle.loads(blob)
        total_count += snap.get("count", 0)
        for name, vals in snap.get("stages", {}).items():
            stages.setdefault(name, []).extend(vals)
    out: dict[str, dict] = {}
    for name, vals in stages.items():
        vals.sort()
        out[name] = {
            "count": len(vals),
            "p50_us": _rec.percentile(vals, 0.5) / 1e3,
            "p99_us": _rec.percentile(vals, 0.99) / 1e3,
            "mean_us": (sum(vals) / len(vals)) / 1e3 if vals else 0.0,
            "max_us": vals[-1] / 1e3 if vals else 0.0,
        }
    if out:
        out["tasks_total"] = total_count
    return out


_LLM_STAGES = ("prefill_queue", "kv_ship", "decode_queue", "ttft", "tpot",
               "tokens_per_step", "spec_accept_rate")


def list_llm_metrics() -> dict:
    """LLM decode-plane panel: the disagg serving stage percentiles
    (``prefill_queue``/``kv_ship``/``decode_queue``/``ttft``/``tpot``
    plus the speculative ``tokens_per_step`` and ``spec_accept_rate``
    windows — scaled integers, see llm/disagg/telemetry.py) and every
    per-process ``rt_llm_*`` gauge (decode tokens-in-flight, accept
    rate, tokens/step). The scheduler's admission, the serve router's
    ``__serve_load__`` probe, the bench and this panel all read the
    same numbers."""
    stages = {k: v for k, v in list_task_latency().items()
              if k in _LLM_STAGES}
    gauges = {name: m for name, m in cluster_metrics().items()
              if name.startswith("rt_llm_")}
    return {"stages": stages, "gauges": gauges}


_TIERING_STAGES = ("spill", "restore")
_TIERING_GAUGES = ("rt_spill_bytes_total", "rt_restore_bytes_total",
                   "rt_tier1_hit_rate", "rt_objects_spilled",
                   "rt_objects_restored", "rt_arena_bytes",
                   "rt_arena_peak_bytes", "rt_arena_capacity_bytes")


def list_tiering() -> dict:
    """Memory-tiering panel: ``spill``/``restore`` stage percentiles
    (time a spill request / tier-1 restore took, from the same
    ns="latency" publish the disagg stages ride) beside the cluster-wide
    tier-1 counters — bytes spilled/restored, objects moved each way,
    and the prefix cache's tier-1 hit rate."""
    stages = {k: v for k, v in list_task_latency().items()
              if k in _TIERING_STAGES}
    gauges = {name: m for name, m in cluster_metrics().items()
              if name in _TIERING_GAUGES}
    return {"stages": stages, "gauges": gauges}


def list_serve_autoscale_events(key: str | None = None) -> list[dict]:
    """Fired serve autoscale decisions (newest last), each carrying its
    cause and the signals that produced it — {key, ts, from_replicas,
    to_replicas, cause, ongoing_avg, arrival_rate, p99_ms, slo_ms}. The
    controller appends every applied decision to a bounded ns="serve" kv
    history (and pushes it live on the ``serve_autoscale`` pubsub
    channel); ``key`` filters to one "app/deployment". Empty when no
    autoscaled deployment has scaled."""
    blob = _call("kv_get", {"ns": "serve", "key": "autoscale_events"})
    if not blob:
        return []
    events = pickle.loads(blob)
    if key is not None:
        events = [e for e in events if e.get("key") == key]
    return events


def list_chaos_events(limit: int = 10000, log_dir: str | None = None) -> list[dict]:
    """Faults fired by the chaos subsystem (devtools/chaos), merged
    across every armed process on this host — each controller appends a
    JSON line per fired fault (point, rule index, action, pid, ts, ctx)
    to its file under the chaos log dir, plus killer strikes
    (``killer.raylet`` / ``killer.worker``). Works without a cluster
    connection (post-run forensics: ``ray_tpu_torch chaos events``); returns
    ``[]`` when chaos never armed."""
    from ray_tpu_torch.devtools import chaos
    from ray_tpu_torch.devtools.chaos.cli import read_events

    events = read_events(log_dir or chaos.default_log_dir())
    ctrl = chaos.get_controller()
    if ctrl is not None:
        # an unwritable log dir must not hide the in-process events
        seen = {(e.get("pid"), e.get("n")) for e in events}
        events.extend(e for e in list(ctrl.events)
                      if (e.get("pid"), e.get("n")) not in seen)
        events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0),
                                   e.get("n", 0)))
    return events[-limit:]


def list_worker_deaths(limit: int = 100) -> list[dict]:
    """Postmortem reports the raylet writes when a worker process dies:
    pid, exit code/signal, lease/actor context, and the victim's last-N
    flight-recorder events (read from its shm recorder ring AFTER death
    — survives SIGKILL)."""
    keys = _call("kv_keys", {"ns": "worker_deaths", "prefix": ""})[:limit]
    blobs = _call("kv_multi_get", {"ns": "worker_deaths", "keys": keys})
    out = []
    for k in keys:
        blob = blobs.get(k)
        if blob:
            out.append(pickle.loads(blob))
    out.sort(key=lambda r: r.get("ts", 0), reverse=True)
    return out


# ------------------------------------------------------------------ timeline
def timeline(filename: str | None = None) -> list[dict]:
    """Chrome trace events built from worker-side RUNNING->FINISHED/FAILED
    pairs (ref: _private/state.py:440 chrome_tracing_dump): one row per
    worker pid, one 'X' slice per task execution. Open the file in
    chrome://tracing or ui.perfetto.dev."""
    events = _call("get_task_events")
    starts: dict[str, dict] = {}
    trace: list[dict] = []
    for ev in events:
        state = ev.get("state")
        tid = ev.get("task_id")
        if state == "SPAN" and ev.get("span"):
            s = ev["span"]
            trace.append({
                "name": s.get("name", "span"), "cat": "span", "ph": "X",
                "ts": s["start_ts"] * 1e6,
                "dur": max(0.0, s["end_ts"] - s["start_ts"]) * 1e6,
                "pid": (ev.get("node_id") or "driver")[:8],
                "tid": ev.get("pid", 0),
                "args": {"trace_id": s.get("trace_id"),
                         "span_id": s.get("span_id"),
                         "parent_span_id": s.get("parent_span_id"),
                         "task_id": tid},
            })
            continue
        if state == "RUNNING":
            starts[tid] = ev
        elif state in ("FINISHED", "FAILED") and tid in starts and ev.get("pid"):
            s = starts.pop(tid)
            trace.append({
                "name": ev.get("name", "task"),
                "cat": "task",
                "ph": "X",
                "ts": s["ts"] * 1e6,  # chrome tracing wants microseconds
                "dur": max(ev["ts"] - s["ts"], ev.get("duration_s", 0)) * 1e6,
                "pid": (ev.get("node_id") or "node")[:8],
                "tid": ev.get("pid"),
                "args": {"task_id": tid, "state": state},
            })
    # still-running tasks appear as instant events
    now = time.time()
    for tid, s in starts.items():
        trace.append({
            "name": s.get("name", "task"), "cat": "task", "ph": "X",
            "ts": s["ts"] * 1e6, "dur": (now - s["ts"]) * 1e6,
            "pid": (s.get("node_id") or "node")[:8], "tid": s.get("pid"),
            "args": {"task_id": tid, "state": "RUNNING"},
        })
    trace.extend(_fastlane_timeline())
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


def _fastlane_timeline() -> list[dict]:
    """Fast-lane stage slices from the flight-recorder latency samples:
    tasks that ride the shm rings never touch the RPC task-event RUNNING/
    FINISHED pair, so without these the timeline shows nothing between
    .remote() and reply-apply. Each published sample (wall-anchored)
    expands into one slice per stage on a per-owner 'fastlane' row."""
    try:
        keys = _call("kv_keys", {"ns": "latency", "prefix": ""})
        blobs = _call("kv_multi_get", {"ns": "latency", "keys": keys})
    except Exception:
        return []
    out: list[dict] = []
    for k in keys:
        blob = blobs.get(k)
        if not blob:
            continue
        try:
            snap = pickle.loads(blob)
        except Exception:
            continue
        row = f"fastlane-{snap.get('worker_id', k)[:8]}"
        for tid, wall_apply, ring, deser, exec_ns, reply in \
                snap.get("samples", []):
            t0 = wall_apply - reply - exec_ns - deser - ring
            for stage, start, dur in (
                    ("ring_sub", t0, ring),
                    ("deserialize", t0 + ring, deser),
                    ("exec", t0 + ring + deser, exec_ns),
                    ("ring_reply", t0 + ring + deser + exec_ns, reply)):
                out.append({
                    "name": stage, "cat": "fastlane", "ph": "X",
                    "ts": start / 1e3,  # ns -> µs (chrome-trace unit)
                    "dur": max(dur, 1) / 1e3,
                    "pid": row, "tid": 0,
                    "args": {"task_id": tid},
                })
    return out
