"""Dashboard: JSON API + SPA frontend.

The port's copy of ``ray_tpu/dashboard.py`` (ref: python/ray/dashboard/
head + python/ray/dashboard/client/src React SPA): the same routes and the
same JSON over the state API, serving the dependency-free hash-routed JS
app from ``dashboard_client/``, no build step. JAX's is an aiohttp app;
this one is the standard library's ``http.server.ThreadingHTTPServer`` in
a daemon thread, so a host without aiohttp (the card's) serves it. Each
request runs in a thread of its own and calls the state API there, off the
core's event loop, where ``_run_sync`` is safe:

    GET /                      SPA shell (views: overview/nodes/actors/
                               tasks/objects/pgs/jobs/serve/metrics/timeline)
    GET /static/*              SPA assets
    GET /api/cluster           nodes + resources
    GET /api/tasks             latest task states
    GET /api/actors            actor table
    GET /api/objects           object table (size/location/spill/refs)
    GET /api/placement_groups  placement group table
    GET /api/summary/tasks     task counts by state
    GET /api/serve             serve applications/deployments status
    GET /api/serve_autoscale   fired autoscale decisions (?key=app/dep)
    GET /api/slo_burn          SLO burn-rate alerts (?key=app/dep)
    GET /api/traces            assembled request traces (newest first)
    GET /api/trace/{id}        one trace as a waterfall + critical path
    GET /api/metrics           aggregated cluster metrics
    GET /api/metric_window     rollup timeseries (?name=&secs=&tag.k=v)
    GET /api/metric_names      metric names known to the rollup store
    GET /api/timeline          chrome-trace events (load into perfetto)
    GET /api/latency           flight-recorder per-stage task latency
    GET /api/llm               LLM decode-plane panel (disagg stages + spec gauges)
    GET /api/tiering           memory-tiering panel (spill/restore stages + tier-1 counters)
    GET /api/worker_deaths     worker postmortems (recorder event dumps)
    GET /api/workers/{id}/stack  live stack dump (py-spy role)
    GET /api/workers/{id}/heap   tracemalloc heap profile
    GET /api/workers/{id}/profile  sampled CPU profile (speedscope)
    GET /metrics               Prometheus text exposition
    POST/GET /api/jobs, GET /api/jobs/{id}[/logs], POST /api/jobs/{id}/stop

Every GET route answers HEAD too, as aiohttp's do.
"""
from __future__ import annotations

import json
import mimetypes
import os
import re
import threading
import urllib.parse

_CLIENT_DIR = os.path.join(os.path.dirname(__file__), "dashboard_client")
# job submissions ship runtime_env packages inline (base64)
_MAX_BODY = 256 * 1024 * 1024

_PAGE = """<!doctype html><html><head><title>ray_tpu_torch dashboard</title>
<style>
body{font-family:monospace;margin:2em;background:#111;color:#ddd}
h1{color:#7fd} table{border-collapse:collapse}
td,th{border:1px solid #444;padding:4px 10px;text-align:left}
</style></head><body>
<h1>ray_tpu_torch dashboard</h1>
<p>The SPA's files (dashboard_client/) are missing; the JSON API is under
<a href="/api/cluster">/api/</a>.</p>
</body></html>"""


class _Request:
    """What a handler sees: the query, the path's named parts and the body."""

    def __init__(self, query: dict, match_info: dict, body: bytes):
        self.query = query
        self.match_info = match_info
        self.body = body

    def json(self):
        return json.loads(self.body or b"null")


class _Response:
    def __init__(self, body: bytes, content_type: str, status: int = 200):
        self.body = body
        self.content_type = content_type
        self.status = status


def _json_response(obj, status: int = 200) -> _Response:
    return _Response(json.dumps(obj).encode(), "application/json", status)


def _text_response(text: str, content_type: str = "text/plain",
                  status: int = 200) -> _Response:
    return _Response(text.encode(), content_type, status)


class _App:
    """The dashboard's routes: (method, path pattern, handler), patterns
    in aiohttp's syntax (``/api/jobs/{job_id}``), plus static prefixes."""

    def __init__(self):
        self.routes: list[tuple[str, str, re.Pattern, object]] = []
        self.statics: list[tuple[str, str]] = []

    def add_get(self, pattern: str, handler) -> None:
        self._add("GET", pattern, handler)
        self._add("HEAD", pattern, handler)

    def add_post(self, pattern: str, handler) -> None:
        self._add("POST", pattern, handler)

    def add_static(self, prefix: str, directory: str) -> None:
        self.statics.append((prefix.rstrip("/"), directory))

    def _add(self, method: str, pattern: str, handler) -> None:
        rx = re.compile("^" + re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[^/]+)",
                                     re.escape(pattern)) + "$")
        self.routes.append((method, pattern, rx, handler))

    def route_table(self) -> set[tuple[str, str]]:
        """{(method, path pattern)}, static prefixes as GET and HEAD."""
        table = {(m, p) for m, p, _, _ in self.routes}
        for prefix, _ in self.statics:
            table |= {("GET", prefix), ("HEAD", prefix)}
        return table

    def dispatch(self, method: str, target: str, body: bytes) -> _Response:
        url = urllib.parse.urlsplit(target)
        path = urllib.parse.unquote(url.path)
        query = dict(urllib.parse.parse_qsl(url.query, keep_blank_values=True))
        allowed = False
        for m, _, rx, handler in self.routes:
            hit = rx.match(path)
            if hit is None:
                continue
            if m != method:
                allowed = True
                continue
            return handler(_Request(query, hit.groupdict(), body))
        if method in ("GET", "HEAD"):
            for prefix, directory in self.statics:
                if path.startswith(prefix + "/"):
                    return _static(directory, path[len(prefix) + 1:])
        if allowed:
            return _json_response({"error": "method not allowed"}, status=405)
        return _json_response({"error": "not found"}, status=404)


def _static(directory: str, rel: str) -> _Response:
    root = os.path.realpath(directory)
    path = os.path.realpath(os.path.join(root, rel))
    if not path.startswith(root + os.sep) or not os.path.isfile(path):
        return _json_response({"error": "not found"}, status=404)
    with open(path, "rb") as f:
        data = f.read()
    return _Response(data, mimetypes.guess_type(path)[0] or "application/octet-stream")


def build_app() -> _App:
    from ray_tpu_torch import state

    def index(request):
        path = os.path.join(_CLIENT_DIR, "index.html")
        if os.path.exists(path):
            with open(path) as f:
                return _text_response(f.read(), "text/html")
        return _text_response(_PAGE, "text/html")

    def _json(fn):
        return lambda request: _json_response(fn())

    app = _App()
    app.add_get("/", index)
    app.add_get("/api/cluster", _json(lambda: _plain(state.list_nodes())))
    app.add_get("/api/tasks", _json(lambda: _plain(state.list_tasks())))
    app.add_get("/api/actors", _json(lambda: _plain(state.list_actors())))
    app.add_get("/api/metrics", _json(lambda: _plain(state.cluster_metrics())))
    # Prometheus scrape endpoint (text exposition format); the
    # conventional path so a scrape_config needs only the address
    app.add_get("/metrics", lambda request: _text_response(state.prometheus_metrics()))

    def metric_window(request):
        # rollup-plane timeseries: windowed points for one metric from
        # the GCS RollupStore (counters as rates, histograms as
        # mergeable quantiles, ratios as num/den)
        name = request.query.get("name")
        if not name:
            return _json_response({"error": "name required"}, status=400)
        tags = {k[4:]: v for k, v in request.query.items() if k.startswith("tag.")} or None
        try:
            return _json_response(_plain(state.metric_window(
                name, float(request.query.get("secs", 60.0)), tags)))
        except Exception as e:
            return _json_response({"error": str(e)}, status=503)

    app.add_get("/api/metric_window", metric_window)
    app.add_get("/api/metric_names", _json(lambda: _plain(state.metric_names())))
    app.add_get("/api/timeline", _json(lambda: state.timeline()))
    # flight-recorder surfaces: per-stage latency percentiles and worker
    # postmortems (see utils/recorder.py, state.list_task_latency)
    app.add_get("/api/latency", _json(lambda: _plain(state.list_task_latency())))
    app.add_get("/api/llm", _json(lambda: _plain(state.list_llm_metrics())))
    app.add_get("/api/tiering", _json(lambda: _plain(state.list_tiering())))
    app.add_get("/api/worker_deaths", _json(lambda: _plain(state.list_worker_deaths())))
    app.add_get("/api/objects", _json(lambda: _plain(state.list_objects())))
    app.add_get("/api/placement_groups",
                _json(lambda: _plain(state.list_placement_groups())))
    app.add_get("/api/summary/tasks", _json(lambda: _plain(state.summary_tasks())))

    def guarded(fn, status=503):
        def handler(request):
            try:
                return fn(request)
            except Exception as e:
                return _json_response({"error": str(e)}, status=status)

        return handler

    def serve_status(request):
        from ray_tpu_torch import serve

        return _json_response(_plain(serve.status()))

    app.add_get("/api/serve", guarded(serve_status))
    # fired autoscale decisions with causes (serve/dataplane/autoscaler)
    app.add_get("/api/serve_autoscale", guarded(lambda request: _json_response(
        _plain(state.list_serve_autoscale_events(request.query.get("key"))))))
    # SLO error-budget burn-rate alerts (serve/dataplane/slo.py)
    app.add_get("/api/slo_burn", guarded(lambda request: _json_response(
        _plain(state.list_slo_burn_events(request.query.get("key"))))))
    app.add_get("/api/traces", guarded(lambda request: _json_response(_plain(
        state.list_traces(int(request.query.get("limit", 100)),
                          int(request.query.get("offset", 0)))))))

    def trace_waterfall(request):
        """One assembled trace as a waterfall: spans sorted by start,
        each with its offset/duration relative to the trace start plus
        the critical-path stage attribution."""
        tr = state.get_trace(request.match_info["trace_id"])
        if tr is None:
            return _json_response({"error": "unknown trace"}, status=404)
        t0 = tr.get("start_ts", 0.0)
        for s in tr.get("spans", []):
            s["offset_ms"] = max(0.0, (s.get("start_ts", t0) - t0) * 1e3)
            s["dur_ms"] = max(0.0, (s.get("end_ts", 0.0) - s.get("start_ts", 0.0)) * 1e3)
        return _json_response(_plain(tr))

    app.add_get("/api/trace/{trace_id}", guarded(trace_waterfall))

    def worker_view(fn):
        def handler(request):
            res = fn(request.match_info["worker_id"], request.query)
            if res is None:
                return _json_response({"error": "worker not found"}, status=404)
            return _json_response(_plain(res))

        return guarded(handler, status=500)

    app.add_get("/api/workers/{worker_id}/stack",
                worker_view(lambda wid, q: state.get_stack(wid)))
    app.add_get("/api/workers/{worker_id}/heap", worker_view(
        lambda wid, q: state.get_heap_profile(wid, action=q.get("action", "snapshot"))))
    app.add_get("/api/workers/{worker_id}/profile", worker_view(
        lambda wid, q: state.get_cpu_profile(
            wid, duration_s=float(q.get("duration_s", 2.0)),
            format=q.get("format", "speedscope"))))
    if os.path.isdir(_CLIENT_DIR):
        app.add_static("/static", _CLIENT_DIR)
    _add_job_routes(app)
    return app


def _add_job_routes(app: _App) -> None:
    """Job REST API (ref: dashboard/modules/job REST head + sdk.py):

        POST /api/jobs                  {entrypoint, runtime_env, packages}
        GET  /api/jobs                  list
        GET  /api/jobs/{id}             status record
        GET  /api/jobs/{id}/logs        captured driver output
        POST /api/jobs/{id}/stop
    """
    import base64

    from ray_tpu_torch import job as jobmod

    def submit(request):
        try:
            body = request.json()
            from ray_tpu_torch.core import api

            core = api.get_core()
            for digest, blob_b64 in (body.get("packages") or {}).items():
                core._run_sync(core.gcs.call("kv_put", {
                    "ns": "runtime_env_packages", "key": digest,
                    "value": base64.b64decode(blob_b64)}))
            env = body.get("runtime_env")
            if env:
                env = {**env, "_packaged": True}
            job_id = jobmod.submit_job(
                body["entrypoint"], runtime_env=env,
                job_id=body.get("submission_id"), metadata=body.get("metadata"))
            return _json_response({"job_id": job_id})
        except Exception as e:
            return _json_response({"error": str(e)}, status=400)

    def not_found(fn):
        def handler(request):
            try:
                return fn(request)
            except KeyError as e:
                return _json_response({"error": str(e)}, status=404)

        return handler

    app.add_post("/api/jobs", submit)
    app.add_get("/api/jobs", lambda request: _json_response(jobmod.list_jobs()))
    app.add_get("/api/jobs/{job_id}", not_found(
        lambda request: _json_response(jobmod.job_status(request.match_info["job_id"]))))
    app.add_get("/api/jobs/{job_id}/logs", not_found(lambda request: _json_response(
        {"logs": jobmod.job_logs(request.match_info["job_id"])})))
    app.add_post("/api/jobs/{job_id}/stop", lambda request: _json_response(
        {"stopped": bool(jobmod.stop_job(request.match_info["job_id"]))}))


def _plain(obj):
    """IDs and tuples -> JSON-safe. Floats stay numbers (JAX's copy turns
    them into ``float.hex`` strings: a float has a ``hex`` method too)."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "hex") and not isinstance(obj, (str, bytes, float)):
        return obj.hex()
    if isinstance(obj, bytes):
        return obj.hex()
    return obj


def _server(app: _App, host: str, port: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _answer(self, method: str) -> None:
            n = int(self.headers.get("Content-Length") or 0)
            if n > _MAX_BODY:
                resp = _json_response({"error": "request body too large"}, status=413)
                self.close_connection = True
            else:
                body = self.rfile.read(n) if n else b""
                try:
                    resp = app.dispatch(method, self.path, body)
                except Exception as e:  # a handler's fault is the request's 500
                    resp = _json_response({"error": f"{type(e).__name__}: {e}"}, status=500)
            self.send_response(resp.status)
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            if method != "HEAD":
                self.wfile.write(resp.body)

        def do_GET(self):
            self._answer("GET")

        def do_HEAD(self):
            self._answer("HEAD")

        def do_POST(self):
            self._answer("POST")

        def log_message(self, format, *args):  # noqa: A002 — the base class's name
            pass  # one line per request on stderr would drown the CLI's output

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server


class _DashboardRunner:
    """A dashboard serving in a daemon thread (the role of aiohttp's
    ``AppRunner`` in JAX's ``start_dashboard_async``)."""

    def __init__(self, server):
        self.server = server
        self.thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.05},
            name="rtt-dashboard", daemon=True)
        self.thread.start()

    @property
    def addresses(self) -> list[tuple[str, int]]:
        return [self.server.server_address[:2]]

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)

    async def cleanup(self) -> None:
        import asyncio

        await asyncio.to_thread(self.close)


def run_dashboard(host: str = "127.0.0.1", port: int = 8265):
    """Blocking server (the CLI entry; ref: dashboard default port 8265)."""
    server = _server(build_app(), host, port)
    try:
        server.serve_forever(poll_interval=0.2)
    finally:
        server.server_close()


def start_dashboard_async(host: str = "127.0.0.1", port: int = 0):
    """A coroutine that starts the dashboard in a daemon thread and gives
    (runner, (host, port)); ``await runner.cleanup()`` stops it."""

    async def go():
        runner = _DashboardRunner(_server(build_app(), host, port))
        return runner, (host, runner.addresses[0][1])

    return go()
