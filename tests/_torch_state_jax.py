"""One scripted workload on a package's runtime, and what its state API,
metrics, timeline and job manager say about it, for
``tests/test_torch_state.py`` and ``tests/test_torch_job.py``. Not a test
module.

    python tests/_torch_state_jax.py <out.json> [ray_tpu|ray_tpu_torch]

Starts a fresh runtime of the named package (JAX's ``ray_tpu`` by
default) in this process and runs: three named tasks (``sc_alpha`` x3,
``sc_beta`` x3, ``sc_gamma``), one that fails (``sc_omega``), an actor
(``ScKeeper``) and a placement group; then three jobs (one that succeeds,
one that exits with code 3, one stopped while it runs). It writes
``summary_tasks()`` for those names, the column keys of each ``list_*``
row, the ``# TYPE`` lines of the runtime's own metrics, the keys, ``ph``
and ``cat`` of the scripted tasks' timeline events, and each job's
statuses in the order seen, its ``message`` and its record's keys. The
tests run it for both packages (``run_once``), each in a process of its
own (two runtimes never share a process), and compare the two.
"""
import faulthandler
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUSH_S = 0.2  # both runtimes' task-event (and metrics) report interval here
NAMES = ("sc_alpha", "sc_beta", "sc_gamma", "sc_omega")
JOBS = {
    "succeeds": "python -c \"import time; time.sleep(0.5); print('job ok')\"",
    "exits_3": "python -c \"import time; time.sleep(0.5); raise SystemExit(3)\"",
    "stopped": "python -c \"import time; time.sleep(600)\"",
}


def _wait_for(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError("timed out")


def _scripted(rt, state) -> dict:
    @rt.remote
    def sc_alpha(x):
        return x + 1

    @rt.remote
    def sc_beta(x):
        return x * 2

    @rt.remote
    def sc_gamma():
        time.sleep(0.05)
        return 3

    @rt.remote(max_retries=0)
    def sc_omega():
        raise ValueError("scripted failure")

    @rt.remote
    class ScKeeper:
        def ping(self):
            return "pong"

    refs = [sc_alpha.remote(i) for i in range(3)] + [sc_beta.remote(i) for i in range(3)]
    assert rt.get(refs + [sc_gamma.remote()], timeout=60) == [1, 2, 3, 0, 2, 4, 3]
    try:
        rt.get(sc_omega.remote(), timeout=60)
    except Exception:  # noqa: BLE001 — the task's error, as each package wraps it
        pass
    else:
        raise AssertionError("sc_omega did not fail")
    keeper = ScKeeper.options(name="sc_keeper").remote()
    assert rt.get(keeper.ping.remote(), timeout=60) == "pong"
    pg = rt.placement_group([{"CPU": 1.0}], strategy="PACK")
    assert pg.ready(timeout=30)
    obj = rt.put(list(range(100_000)))  # above the inline cutoff: an shm object

    want = {"sc_alpha": 3, "sc_beta": 3, "sc_gamma": 1}

    def settled():
        rows = [r for r in state.list_tasks(limit=100_000) if r.get("name") in NAMES]
        done = [r for r in rows if r.get("state") == "FINISHED"
                and r.get("duration_s") is not None]
        counts = {n: sum(r["name"] == n for r in done) for n in want}
        failed = [r for r in rows if r["name"] == "sc_omega" and r.get("state") == "FAILED"]
        # the executing worker's events (node and worker ids) in every row
        whole = all(r.get("node_id") and r.get("worker_id") for r in rows)
        return rows if counts == want and failed and whole else None

    rows = _wait_for(settled)
    summary = {n: s for n, s in state.summary_tasks().items() if n in NAMES}
    columns = {"tasks": {f"{r['name']}:{r['state']}": sorted(r) for r in rows}}
    columns["actors"] = [sorted(r) for r in state.list_actors(
        filters=[("name", "=", "sc_keeper")])]
    columns["nodes"] = [sorted(r) for r in state.list_nodes()]
    columns["placement_groups"] = [sorted(r) for r in state.list_placement_groups(
        filters=[("pg_id", "=", pg.id.hex())])]
    columns["objects"] = sorted({tuple(sorted(r)) for r in state.list_objects()})

    def metric_types():
        return sorted(ln for ln in state.prometheus_metrics().splitlines()
                      if ln.startswith("# TYPE ") and ":rate10s" not in ln)

    # every process publishes its snapshot on the task-event flush: read
    # until the workload's metrics are in and two reads two flushes apart
    # agree
    core = {"rt_tasks_submitted", "rt_tasks_finished", "rt_task_exec_seconds",
            "rt_objects_put", "rt_actor_calls"}
    types, prev = None, None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        types = metric_types()
        names = {ln.split()[2] for ln in types}
        if core <= names and types == prev:
            break
        prev = types
        time.sleep(2 * FLUSH_S)

    def timeline_events():
        evs = [e for e in state.timeline() if e.get("name") in NAMES]
        return evs if len(evs) >= 8 else None

    events = _wait_for(timeline_events)
    timeline = sorted({json.dumps([sorted(e), e["ph"], e["cat"], sorted(e["args"]),
                                   e["args"].get("state")]) for e in events})
    del obj, keeper
    rt.remove_placement_group(pg)
    return {"summary": summary, "columns": columns, "metric_types": types,
            "timeline": [json.loads(t) for t in timeline]}


def _jobs(jobmod) -> dict:
    ids = {case: jobmod.submit_job(entry) for case, entry in JOBS.items()}
    seen = {case: [] for case in JOBS}
    stop_sent = False
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        for case, jid in ids.items():
            status = jobmod.job_status(jid)["status"]
            if not seen[case] or seen[case][-1] != status:
                seen[case].append(status)
        if not stop_sent and seen["stopped"][-1] == jobmod.RUNNING:
            stop_sent = jobmod.stop_job(ids["stopped"])
        if all(s[-1] in (jobmod.SUCCEEDED, jobmod.FAILED, jobmod.STOPPED)
               for s in seen.values()):
            break
        time.sleep(0.02)
    out = {}
    for case, jid in ids.items():
        rec = jobmod.job_status(jid)
        out[case] = {"statuses": seen[case], "message": rec["message"], "keys": sorted(rec),
                     "logs": jobmod.job_logs(jid)}
    return out


def run_once(tmp_path_factory) -> dict:
    """{package: this script's JSON} for both packages, run at the same
    time, each once a test session (``_torch_data_jax.run_once``, shared
    by the xdist workers)."""
    import concurrent.futures

    import _torch_data_jax

    packages = ("ray_tpu", "ray_tpu_torch")
    with concurrent.futures.ThreadPoolExecutor(len(packages)) as pool:
        runs = [pool.submit(_torch_data_jax.run_once, tmp_path_factory, "_torch_state_jax.py",
                            150, (p,)) for p in packages]
        return dict(zip(packages, (r.result() for r in runs)))


def main() -> int:
    faulthandler.dump_traceback_later(150, exit=True)
    package = sys.argv[2] if len(sys.argv) > 2 else "ray_tpu"
    # this process's runtime and its children: reports every FLUSH_S, and
    # idle leases returned after 1 s (the actor waits for a CPU the
    # finished tasks' workers hold)
    os.environ["RT_TASK_EVENTS_REPORT_INTERVAL_S"] = str(FLUSH_S)
    os.environ["RT_WORKER_LEASE_TIMEOUT_S"] = "1.0"
    sys.path.insert(0, ROOT)
    import importlib

    rt = importlib.import_module(package)
    state = importlib.import_module(f"{package}.state")
    jobmod = importlib.import_module(f"{package}.job")
    rt.init(num_cpus=8)
    try:
        out = _scripted(rt, state)
        out["jobs"] = _jobs(jobmod)
    finally:
        rt.shutdown()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
