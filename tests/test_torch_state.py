"""The port's state API (``ray_tpu_torch.state``) on its runtime, on the
CPU, against the JAX package's ``ray_tpu.state``.

Every case of ``tests/test_state.py``, translated, and the state and
Prometheus cases of ``tests/test_flight_recorder.py`` and
``tests/test_tiering.py``. JAX's live-worker cases sleep a fixed 6-8 s so
that the worker is still busy when it is profiled; their counterparts here
hold the task until the test releases it (a file appears), and every wait
polls with a deadline. Then: a user ``Counter`` from
``ray_tpu_torch.util.metrics`` shows up in ``cluster_metrics()`` and on
the dashboard's ``/metrics``; and one scripted workload (three named
tasks, one that fails, an actor and a placement group) gives the same
``summary_tasks()``, the same column keys of each ``list_*``, the same
``# TYPE`` lines of the runtime's own metrics and the same keys, ``ph``
and ``cat`` of timeline events on both packages
(``tests/_torch_state_jax.py``, each package's runtime in a process of its
own).

One port runtime serves the module, its task events reported every 0.2 s
and idle leases returned after 1 s.
"""

import concurrent.futures
import dataclasses
import gc
import json
import os
import time
import urllib.request

import pytest

import _torch_state_jax
import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse
from ray_tpu_torch import state

_module_limit, _test_limit = time_limits(module_s=180, test_s=60)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both packages' scripted runs, started now and read by the parity
    tests at the end of the module (they run while the module does)."""
    # the base temp dir is made at its first use, unlocked: made here, before
    # the runs' threads, so they and this module's tests never race to mkdir it
    tmp_path_factory.getbasetemp()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(_torch_state_jax.run_once, tmp_path_factory)
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def rt(parity):
    from ray_tpu_torch import config

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, task_events_report_interval_s=0.2,
                                          worker_lease_timeout_s=1.0))
    ray_tpu_torch.init(num_cpus=16)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)


@pytest.fixture(autouse=True)
def collect():
    yield
    gc.collect()


def _wait_for(pred, timeout=20, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise AssertionError(f"timed out: {msg}")


def _running(name: str) -> dict:
    """The RUNNING row of the task ``name`` once its worker reported it."""
    return _wait_for(lambda: ([t for t in state.list_tasks()
                               if t.get("name") == name and t.get("worker_id")
                               and t.get("state") == "RUNNING"] or [None])[-1],
                     msg=f"{name} never reported RUNNING")


def _until(path: str) -> None:
    """Hold a task until the test releases it (creates ``path``)."""
    while not os.path.exists(path):
        time.sleep(0.02)


# ----------------------------------------------- tests/test_state.py, translated
def test_task_events_and_list_tasks(rt):
    @ray_tpu_torch.remote
    def traced_task(x):
        return x + 1

    refs = [traced_task.remote(i) for i in range(5)]
    assert ray_tpu_torch.get(refs, timeout=60) == [1, 2, 3, 4, 5]
    # wait until the worker-side detail (duration) has also arrived, not
    # just the client-side FINISHED
    rows = _wait_for(
        lambda: (lambda rs: rs if len(rs) == 5
                 and any(r.get("duration_s") is not None for r in rs) else None)(
            [r for r in state.list_tasks(filters=[("name", "=", "traced_task")])
             if r.get("state") == "FINISHED"]),
        msg="no complete traced_task events")
    assert all(r.get("worker_id") for r in rows)


def test_failed_task_event(rt):
    @ray_tpu_torch.remote(max_retries=0)
    def boom():
        raise ValueError("kaput")

    with pytest.raises(Exception):
        ray_tpu_torch.get(boom.remote(), timeout=60)
    rows = _wait_for(lambda: state.list_tasks(
        filters=[("name", "=", "boom"), ("state", "=", "FAILED")]), msg="no FAILED boom event")
    assert rows


def test_list_actors_and_nodes(rt):
    @ray_tpu_torch.remote
    class Marker:
        def ping(self):
            return True

    a = Marker.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60)
    actors = state.list_actors(filters=[("state", "=", "ALIVE")])
    assert any(x["state"] == "ALIVE" for x in actors)
    nodes = state.list_nodes()
    assert len(nodes) >= 1 and nodes[0]["alive"]
    ray_tpu_torch.kill(a)


def test_placement_group_listing(rt):
    pg = ray_tpu_torch.placement_group([{"CPU": 1.0}], strategy="PACK")
    assert pg.ready(timeout=30)
    pgs = state.list_placement_groups(filters=[("state", "=", "CREATED")])
    assert any(p["pg_id"] == pg.id.hex() for p in pgs)
    ray_tpu_torch.remove_placement_group(pg)


def test_timeline_export(rt, tmp_path):
    @ray_tpu_torch.remote
    def slice_task():
        time.sleep(0.05)
        return 1

    ray_tpu_torch.get([slice_task.remote() for _ in range(3)], timeout=60)
    path = str(tmp_path / "trace.json")

    def all_slices():
        rows = [e for e in state.timeline(path)
                if e["name"] == "slice_task" and e["args"]["state"] == "FINISHED"]
        return rows if len(rows) >= 3 else None

    trace = _wait_for(all_slices, msg="fewer than 3 timeline slices")
    assert len(trace) >= 3
    with open(path) as f:
        saved = json.load(f)
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in saved)


def test_cluster_metrics_aggregation(rt):
    @ray_tpu_torch.remote
    def metered():
        return 1

    ray_tpu_torch.get([metered.remote() for _ in range(3)], timeout=60)
    ray_tpu_torch.put(list(range(1000)))

    def have_metrics():
        m = state.cluster_metrics()

        def untagged(name):
            for s in m.get(name, {}).get("samples", []):
                if not s.get("tags"):
                    return s.get("value", 0)
            return 0

        execs = m.get("rt_task_exec_seconds", {}).get("samples", [])
        return (untagged("rt_tasks_submitted") >= 3 and untagged("rt_objects_put") >= 1
                and execs and m)

    m = _wait_for(have_metrics, msg="metrics never aggregated")
    assert m["rt_task_exec_seconds"]["type"] == "histogram"
    # structured tags survive aggregation (the prometheus renderer reads them)
    fin = m.get("rt_tasks_finished", {}).get("samples", [])
    assert any(s["tags"].get("outcome") == "ok" for s in fin)


def test_summary_tasks(rt):
    @ray_tpu_torch.remote
    def summarized():
        return 1

    ray_tpu_torch.get([summarized.remote() for _ in range(4)], timeout=60)
    summary = _wait_for(
        lambda: (lambda s: s if s and s.get("FINISHED", 0) >= 4 else None)(
            state.summary_tasks().get("summarized")),
        msg="no FINISHED summary for summarized")
    assert summary["FINISHED"] >= 4


def test_streaming_task_gets_terminal_event(rt):
    """Streaming tasks close their timeline slice (worker FINISHED with a
    duration)."""
    @ray_tpu_torch.remote(num_returns="streaming")
    def streamer():
        yield from range(3)

    assert len(list(streamer.remote())) == 3
    rows = _wait_for(
        lambda: [r for r in state.list_tasks(filters=[("name", "=", "streamer")])
                 if r.get("state") == "FINISHED" and r.get("duration_s") is not None],
        msg="no terminal streaming event")
    assert rows


def test_get_log_worker_stdout(rt):
    """Worker stdout/stderr land in the session log tree and are served back
    by state.get_log."""
    @ray_tpu_torch.remote
    def chatty():
        import sys

        print("needle-on-stdout-12345", flush=True)
        print("needle-on-stderr-67890", file=sys.stderr, flush=True)
        return ray_tpu_torch.get_runtime_context().worker_id.hex()

    wid = ray_tpu_torch.get(chatty.remote(), timeout=120)
    out = _wait_for(lambda: (lambda s: s if s and "needle-on-stdout-12345" in s else None)(
        state.get_log(wid, stream="out")), msg="no stdout log")
    assert "needle-on-stdout-12345" in out
    err = _wait_for(lambda: (lambda s: s if s and "needle-on-stderr-67890" in s else None)(
        state.get_log(wid, stream="err")), msg="no stderr log")
    assert "needle-on-stderr-67890" in err
    assert state.get_log(wid, stream="bogus") is None


def test_get_stack_live_worker(rt, tmp_path):
    """On-demand stack dump of a worker mid-task (the py-spy role,
    self-reported over RPC)."""
    release = str(tmp_path / "release")

    @ray_tpu_torch.remote
    def busy_sleeper(path):
        _until(path)  # a recognizable frame to find in the dump
        return 1

    ref = busy_sleeper.remote(release)
    try:
        dump = state.get_stack(_running("busy_sleeper")["worker_id"])
        assert dump and dump["threads"], dump
        joined = "\n".join(t["stack"] for t in dump["threads"])
        assert "busy_sleeper" in joined or "sleep" in joined
    finally:
        open(release, "w").close()
    assert ray_tpu_torch.get(ref, timeout=60) == 1


def test_heap_profile_live_worker(rt, tmp_path):
    """On-demand heap profile (the memray role, tracemalloc in-process):
    start tracing on a worker holding an allocation, snapshot, stop."""
    release = str(tmp_path / "release")

    @ray_tpu_torch.remote
    def allocator(path):
        hoard = [bytearray(256 * 1024) for _ in range(40)]  # ~10MB
        _until(path)
        return len(hoard)

    ref = allocator.remote(release)
    try:
        wid = _running("allocator")["worker_id"]
        assert state.get_heap_profile(wid, action="start") == {"tracing": True}
        time.sleep(0.2)
        snap = state.get_heap_profile(wid, action="snapshot", top=10)
        # tracing started after the hoard was allocated: the shape of the
        # reply is the contract
        assert snap and "current_bytes" in snap and isinstance(snap["top"], list)
        assert state.get_heap_profile(wid, action="stop") == {"tracing": False}
    finally:
        open(release, "w").close()
    assert ray_tpu_torch.get(ref, timeout=60) == 40


def test_cpu_profile_flamegraph(rt, tmp_path):
    """Sampled CPU profile (the py-spy record role, in-process sampler):
    folded stacks catch the busy function; the speedscope render holds."""
    release = str(tmp_path / "release")

    @ray_tpu_torch.remote
    def spinner(path):
        # pure bytecode between rare checks: a loop that enters a syscall
        # (and so drops the GIL) every few microseconds wins the GIL back
        # each time and starves the worker's sampler thread
        x, checked = 0, time.monotonic()
        while True:
            x += 1
            if time.monotonic() - checked > 0.05:
                if os.path.exists(path):
                    return x
                checked = time.monotonic()

    ref = spinner.remote(release)
    try:
        wid = _running("spinner")["worker_id"]
        prof = state.get_cpu_profile(wid, duration_s=0.5, interval_s=0.02)
        assert prof and prof["samples"] > 10, prof
        joined = "\n".join(prof["folded"])
        assert "spinner" in joined, joined[:2000]
        sps = state.get_cpu_profile(wid, duration_s=0.3, format="speedscope")
        assert sps["profiles"][0]["type"] == "sampled"
        assert sps["shared"]["frames"], sps
        assert len(sps["profiles"][0]["samples"]) == len(sps["profiles"][0]["weights"])
    finally:
        open(release, "w").close()
    assert ray_tpu_torch.get(ref, timeout=60) > 0


# ------------------ tests/test_flight_recorder.py and test_tiering.py, translated
@ray_tpu_torch.remote
def _echo(x):
    return x


def _pump_fast_lane(n=10):
    """Lone submit-then-get round trips ride the ring once a lane exists;
    returns once the driver recorder has accumulated samples."""
    from ray_tpu_torch.utils import recorder

    def go():
        for i in range(n):
            assert ray_tpu_torch.get(_echo.remote(i)) == i
        st = recorder.get_stats()
        return st.n if st is not None else 0

    return _wait_for(go, msg="no fast-lane latency samples accumulated")


def test_prometheus_metrics_and_native_gauges(rt):
    # ring stats are summed over live lanes, and this module returns idle
    # leases (closing their lanes) after 1 s: every poll keeps a lane busy,
    # so the 1 Hz flush and the read below see it however slow the host is.
    # The stage histogram can exist before this test's task stages do: an
    # earlier test in this process left actor_* stages (or telemetry's
    # spill/restore), and the task samples the pump adds reach the registry
    # only at this process's next 1 Hz flush. So the poll waits for the exec
    # stage, not just for the series' name.
    def surfaced():
        _pump_fast_lane(n=2)
        pm = state.prometheus_metrics()
        return pm if ("rt_fastpath_ring" in pm and "rt_task_stage_seconds_bucket" in pm
                      and "rt_object_store" in pm and 'stage="exec"' in pm
                      and 'which="sub"' in pm) else None

    pm = _wait_for(surfaced, msg="native gauges / stage histograms absent")
    # structured labels render as real prometheus label pairs
    assert 'stage="exec"' in pm
    assert 'which="sub"' in pm and 'stat="push_records"' in pm
    assert 'le="+Inf"' in pm

    # native stats also visible zero-copy through the core API
    def pushed():
        _pump_fast_lane(n=2)
        ns = ray_tpu_torch.get_core().native_stats()
        return ns if sum(d.get("push_records", 0) for d in ns["ring"].values()) >= 1 else None

    ns = _wait_for(pushed, msg="no ring push records on a live lane")
    assert ns["store"] is not None and ns["store"]["creates"] >= 0


def test_dashboard_metrics_endpoint(rt):
    from ray_tpu_torch import dashboard

    _pump_fast_lane()
    core = ray_tpu_torch.get_core()
    runner, (host, port) = core._run_sync(dashboard.start_dashboard_async())
    try:
        def scrape():
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as resp:
                body = resp.read().decode()
            return body if "rt_task_stage_seconds" in body else None

        body = _wait_for(scrape, msg="/metrics missing stage histograms")
        assert "# TYPE rt_task_stage_seconds histogram" in body
        with urllib.request.urlopen(f"http://{host}:{port}/api/latency", timeout=10) as resp:
            assert resp.status == 200
    finally:
        core._run_sync(runner.cleanup())


def test_timeline_carries_fastlane_stages(rt):
    _pump_fast_lane()

    def has_fastlane():
        return [e for e in state.timeline() if e.get("cat") == "fastlane"] or None

    rows = _wait_for(has_fastlane, msg="timeline has no fastlane slices")
    assert {"ring_sub", "exec", "ring_reply"} <= {r["name"] for r in rows}
    assert all(r["ph"] == "X" and r["dur"] > 0 for r in rows)


def test_tiering_telemetry_and_state_surfaces(rt):
    """spill/restore ride the recorder's stage windows, and
    state.list_tiering() gives the panel the dashboard serves."""
    from ray_tpu_torch.llm.disagg import telemetry
    from ray_tpu_torch.utils import recorder

    assert recorder.STAGE_NAMES[recorder.SPILL] == "spill"
    assert recorder.STAGE_NAMES[recorder.RESTORE] == "restore"
    telemetry.record(telemetry.SPILL, 1_000_000, 4096)
    telemetry.record(telemetry.RESTORE, 2_000_000, 4096)
    assert telemetry.stage_window(telemetry.SPILL)
    assert telemetry.stage_window(telemetry.RESTORE)
    out = state.list_tiering()
    assert set(out) == {"stages", "gauges"}
    for name in out["gauges"]:
        assert name.startswith("rt_")


# ------------------------------------------------------------- the port's own
def test_user_counter_reaches_cluster_metrics_and_prometheus(rt):
    """A Counter of ray_tpu_torch.util.metrics, incremented in a task and in
    the driver, is summed by cluster_metrics() per tag and rendered on the
    dashboard's /metrics under the rt_ prefix."""
    from ray_tpu_torch import dashboard
    from ray_tpu_torch.util.metrics import Counter

    @ray_tpu_torch.remote
    def count_in_task(n):
        from ray_tpu_torch.util.metrics import Counter

        c = Counter("app_user_requests", description="requests", tag_keys=("route",))
        c.inc(n, tags={"route": "/task"})
        return n

    assert ray_tpu_torch.get(count_in_task.remote(3), timeout=60) == 3
    Counter("app_user_requests", tag_keys=("route",)).inc(2, tags={"route": "/driver"})

    def counted():
        m = state.cluster_metrics().get("app_user_requests")
        if not m:
            return None
        by_route = {s["tags"].get("route"): s["value"] for s in m["samples"]}
        return m if by_route.get("/task") == 3 and by_route.get("/driver") == 2 else None

    m = _wait_for(counted, msg="the user counter never reached cluster_metrics()")
    assert m["type"] == "counter"
    core = ray_tpu_torch.get_core()
    runner, (host, port) = core._run_sync(dashboard.start_dashboard_async())
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
    finally:
        core._run_sync(runner.cleanup())
    assert "# TYPE rt_app_user_requests counter" in body
    assert 'rt_app_user_requests{route="/task"} 3.0' in body


def test_util_metrics_is_the_runtime_registry():
    import ray_tpu.util.metrics as jm

    from ray_tpu_torch.util import metrics
    from ray_tpu_torch.utils import metrics as registry

    assert metrics.__all__ == jm.__all__
    assert (metrics.Counter, metrics.Gauge, metrics.Histogram) == (
        registry.Counter, registry.Gauge, registry.Histogram)


# ---------------------------------------------- one workload, both packages
def test_scripted_summary_matches_jax(parity):
    runs = parity.result()
    jax, ours = runs["ray_tpu"], runs["ray_tpu_torch"]
    assert ours["summary"] == jax["summary"] == {
        "sc_alpha": {"FINISHED": 3}, "sc_beta": {"FINISHED": 3},
        "sc_gamma": {"FINISHED": 1}, "sc_omega": {"FAILED": 1}}


@pytest.mark.parametrize("table", ["tasks", "actors", "nodes", "placement_groups", "objects"])
def test_scripted_list_columns_match_jax(parity, table):
    runs = parity.result()
    jax, ours = runs["ray_tpu"]["columns"][table], runs["ray_tpu_torch"]["columns"][table]
    assert jax, table  # the workload made rows of every table
    assert ours == jax


def test_scripted_metric_types_match_jax(parity):
    runs = parity.result()
    assert runs["ray_tpu_torch"]["metric_types"] == runs["ray_tpu"]["metric_types"]
    assert "# TYPE rt_tasks_submitted counter" in runs["ray_tpu_torch"]["metric_types"]


def test_scripted_timeline_events_match_jax(parity):
    runs = parity.result()
    assert runs["ray_tpu_torch"]["timeline"] == runs["ray_tpu"]["timeline"]
    assert {(e[1], e[2], e[4]) for e in runs["ray_tpu_torch"]["timeline"]} == {
        ("X", "task", "FINISHED"), ("X", "task", "FAILED")}
