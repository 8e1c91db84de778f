"""The port's operator surface on the CPU: the command line
(``python -m ray_tpu_torch``, ``ray_tpu_torch/scripts.py``), the dashboard
(``ray_tpu_torch/dashboard.py`` with ``dashboard_client/``) and the chaos
subcommand, against the JAX package's.

Every case of ``tests/test_cluster_tools.py`` but the autoscaler's (that
one is in ``tests/test_torch_autoscaler.py``): a head started and stopped
through the CLI, ``stop`` ending the session's processes, and the
dashboard's endpoints. JAX's dashboard case sleeps a fixed 1.5 s for the task-event
flush; here it polls. Then the operator's path that ``chip_smoke.py``'s
``job_cli`` phase drives on the card, with aiohttp hidden from every
process of the cluster (as on the card's host): ``start --head``,
``status``, the ``dashboard`` command, a job through
``JobSubmissionClient`` whose driver runs a task, ``job list``, ``list
actors``, the job's logs, ``/api/tasks``, ``/api/timeline``, ``/metrics``,
a second job stopped over REST, and ``stop``. And: the dashboard's
(method, path) routes equal those of JAX's ``build_app()``; the three SPA
files equal JAX's but for the brand name; the CLI parser has JAX's
subcommands and flags (``start --autoscale``, ``_autoscaler_monitor`` and
``lint`` among them) but for ``--num-gpus`` in place of ``--num-tpus``.

Every CLI cluster has a ``TMPDIR`` of its own, is stopped in a finalizer,
and its processes are checked gone.
"""

import argparse
import gc
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

_module_limit, _test_limit = time_limits(module_s=240, test_s=120)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def no_aiohttp(tmp_path_factory):
    """A directory whose ``aiohttp`` raises ImportError, first on the
    PYTHONPATH of every CLI process (and so of the daemons, the workers
    and the jobs' drivers they start)."""
    d = tmp_path_factory.mktemp("no_aiohttp")
    (d / "aiohttp").mkdir()
    (d / "aiohttp" / "__init__.py").write_text(
        "raise ImportError('aiohttp is hidden from this process')\n")
    return str(d)


def _env(tmp: str, no_aiohttp: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("RT_ADDRESS", "PYTHONPATH")}
    env["PYTHONPATH"] = os.pathsep.join([no_aiohttp, REPO])
    env["TMPDIR"] = tmp  # the session file, logs and job logs of this cluster
    env["RT_TASK_EVENTS_REPORT_INTERVAL_S"] = "0.2"
    return env


def _cli(env: dict, *args, timeout=60):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout, env=env)


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def _session_pids(tmp: str) -> list:
    with open(os.path.join(tmp, "ray_tpu_torch", "session.json")) as f:
        return json.load(f)["pids"]


def _gone(pids, timeout=15.0) -> bool:
    deadline = time.monotonic() + timeout
    while any(_alive(p) for p in pids):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


class CliCluster:
    """A head started through the CLI; ``stop()`` stops it through the CLI
    and checks that the session's processes are gone."""

    def __init__(self, tmp: str, no_aiohttp: str, *start_args):
        self.tmp = tmp
        self.env = _env(tmp, no_aiohttp)
        r = _cli(self.env, "start", "--head", *(start_args or ("--num-cpus", "4")))
        assert r.returncode == 0, r.stderr
        self.address = [ln for ln in r.stdout.splitlines()
                        if "started at" in ln][0].split()[-1]
        self.pids = _session_pids(tmp)
        self.stopped = False

    def cli(self, *args, timeout=60):
        return _cli(self.env, *args, timeout=timeout)

    def stop(self):
        if self.stopped:
            return
        self.stopped = True
        r = self.cli("stop")
        assert r.returncode == 0, r.stderr
        assert _gone(self.pids), [p for p in self.pids if _alive(p)]


@pytest.fixture()
def cli_session(tmp_path, no_aiohttp):
    cluster = CliCluster(str(tmp_path), no_aiohttp)
    yield cluster
    cluster.stop()


def _wait_for(pred, timeout=30, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.1)
    raise AssertionError(f"timed out: {msg}")


# ----------------------------------------- tests/test_cluster_tools.py, translated
def test_cli_start_status_stop(tmp_path, no_aiohttp):
    """Also: --num-gpus reaches the raylet (the CPU host's card count is 0)."""
    c = CliCluster(str(tmp_path), no_aiohttp, "--num-cpus", "4", "--num-gpus", "2")
    try:
        def status():
            r = c.cli("status", "--address", c.address)
            return r if r.returncode == 0 and "nodes: 1" in r.stdout else None

        r = _wait_for(status, msg="status never saw the node")
        assert "CPU: 4/4" in r.stdout and "GPU: 2/2" in r.stdout
        r = c.cli("list", "nodes", "--address", c.address)
        assert r.returncode == 0, r.stderr
        assert len(json.loads(r.stdout)) == 1
    finally:
        c.stop()


def test_cli_stop_kills_processes(tmp_path, no_aiohttp):
    cluster = CliCluster(str(tmp_path), no_aiohttp, "--num-cpus", "2")
    try:
        assert cluster.pids and all(_alive(p) for p in cluster.pids)
        assert os.path.exists(os.path.join(str(tmp_path), "ray_tpu_torch", "session.json"))
        # the JAX package's session file is another file: its stop cannot
        # reach this cluster
        assert not os.path.exists(os.path.join(str(tmp_path), "ray_tpu", "session.json"))
    finally:
        cluster.stop()
    assert not os.path.exists(os.path.join(str(tmp_path), "ray_tpu_torch", "session.json"))


@pytest.fixture()
def rt_dashboard():
    from ray_tpu_torch.dashboard import start_dashboard_async

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    ray_tpu_torch.init(num_cpus=4)
    core = ray_tpu_torch.get_core()
    runner, (host, port) = core._run_sync(start_dashboard_async())
    yield f"http://{host}:{port}"
    core._run_sync(runner.cleanup())
    ray_tpu_torch.shutdown()
    gc.collect()


def _get(base: str, path: str) -> bytes:
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.read()


def test_dashboard_endpoints(rt_dashboard):
    base = rt_dashboard

    @ray_tpu_torch.remote
    def touch():
        return 1

    assert ray_tpu_torch.get([touch.remote() for _ in range(3)], timeout=60) == [1, 1, 1]
    tasks = _wait_for(lambda: (lambda ts: ts if any(t["name"] == "touch" for t in ts) else None)(
        json.loads(_get(base, "/api/tasks"))), msg="no touch task on /api/tasks")
    assert any(t["name"] == "touch" for t in tasks)
    assert b"ray_tpu_torch dashboard" in _get(base, "/")
    # SPA assets + views wiring
    assert b'href="#/nodes"' in _get(base, "/")
    assert b"hash router" in _get(base, "/static/app.js") or b"views" in _get(
        base, "/static/app.js")
    assert b"--accent" in _get(base, "/static/style.css")
    assert isinstance(json.loads(_get(base, "/api/summary/tasks")), dict)
    assert json.loads(_get(base, "/api/objects")) is not None
    assert json.loads(_get(base, "/api/placement_groups")) == []
    cluster = json.loads(_get(base, "/api/cluster"))
    assert len(cluster) == 1 and cluster[0]["alive"]
    assert cluster[0]["resources_total"]["CPU"] == 4.0  # numbers stay numbers
    metrics = _wait_for(lambda: (lambda m: m if "rt_tasks_submitted" in m else None)(
        json.loads(_get(base, "/api/metrics"))), msg="no rt_tasks_submitted")
    assert "rt_tasks_submitted" in metrics
    # Prometheus text exposition (scrape endpoint)
    prom = _wait_for(lambda: (lambda p: p if "rt_task_exec_seconds_bucket" in p else None)(
        _get(base, "/metrics").decode()), msg="no exec histogram on /metrics")
    assert "# TYPE rt_tasks_submitted counter" in prom
    assert "rt_rt_" not in prom  # no double prefixing
    assert 'le="+Inf"' in prom


def test_dashboard_answers_errors_as_json(rt_dashboard):
    base = rt_dashboard
    for path, code in (("/api/nope", 404), ("/api/metric_window", 400),
                       ("/api/jobs/raysubmit_missing", 404), ("/static/../dashboard.py", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base, path)
        assert e.value.code == code, path
        assert "error" in json.loads(e.value.read())
    req = urllib.request.Request(base + "/api/cluster", method="HEAD")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200 and r.read() == b""
    req = urllib.request.Request(base + "/api/cluster", method="POST", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 405


# --------------------------------------------- the operator's path, no aiohttp
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_DRIVER = """
import json, os, sys
import ray_tpu_torch

ray_tpu_torch.init()  # joins through RT_ADDRESS


@ray_tpu_torch.remote
def cli_probe(n):
    return {"sum": sum(range(n)), "pid": os.getpid()}


out = ray_tpu_torch.get(cli_probe.remote(10))
print(json.dumps({"sum": out["sum"], "task_pid": out["pid"], "driver_pid": os.getpid(),
                  "aiohttp": "aiohttp" in sys.modules}), flush=True)
ray_tpu_torch.shutdown()
"""


def test_cli_dashboard_and_rest_job_without_aiohttp(cli_session, tmp_path):
    from ray_tpu_torch.job import JobSubmissionClient

    c = cli_session
    r = _wait_for(lambda: (lambda r: r if r.returncode == 0 and "nodes: 1" in r.stdout else None)(
        c.cli("status", "--address", c.address)), msg="status never saw the node")
    assert "CPU: 4/4" in r.stdout
    port = _free_port()
    dash = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", "dashboard", "--address",
                             c.address, "--port", str(port)], env=c.env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        def up():
            assert dash.poll() is None, dash.stdout.read()
            try:
                return _get(base, "/")
            except OSError:
                return None

        assert b"ray_tpu_torch dashboard" in _wait_for(up, msg="the dashboard never answered")
        client = JobSubmissionClient(base)
        work = tmp_path / "job"
        work.mkdir()
        (work / "driver.py").write_text(_DRIVER)
        jid = client.submit_job(entrypoint=f"{sys.executable} {work / 'driver.py'}")
        rec = _wait_for(lambda: (lambda i: i if i["status"] in (
            "SUCCEEDED", "FAILED", "STOPPED") else None)(client.get_job_info(jid)),
            timeout=90, msg="the job never ended")
        logs = client.get_job_logs(jid)
        assert rec["status"] == "SUCCEEDED", (rec, logs)
        line = json.loads([ln for ln in logs.splitlines() if ln.startswith("{")][-1])
        assert line["sum"] == 45 and line["task_pid"] != line["driver_pid"]
        assert not line["aiohttp"]
        assert json.loads(_get(base, f"/api/jobs/{jid}/logs"))["logs"] == logs
        r = c.cli("job", "list", "--address", c.address)
        assert r.returncode == 0, r.stderr
        assert any(j["job_id"] == jid for j in json.loads(r.stdout))
        r = c.cli("list", "actors", "--address", c.address)
        assert r.returncode == 0, r.stderr
        assert any(a.get("name") == f"_job_supervisor_{jid}" for a in json.loads(r.stdout))
        task = _wait_for(lambda: [t for t in json.loads(_get(base, "/api/tasks"))
                                  if t.get("name") == "cli_probe"
                                  and t.get("state") == "FINISHED"], msg="no cli_probe task")
        assert task[0]["worker_id"]
        assert _wait_for(lambda: [e for e in json.loads(_get(base, "/api/timeline"))
                                  if e.get("name") == "cli_probe"], msg="no timeline event")
        assert "# TYPE rt_tasks_submitted counter" in _get(base, "/metrics").decode()
        r = c.cli("job", "submit", "--dashboard-url", base, "--wait", "--", sys.executable,
                  "-c", "print('cli job ran')", timeout=90)
        assert r.returncode == 0 and "SUCCEEDED" in r.stdout, (r.stdout, r.stderr)
        cli_jid = r.stdout.split()[0]
        r = c.cli("job", "logs", cli_jid, "--address", c.address)
        assert "cli job ran" in r.stdout, r.stderr

        sleeper = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; "
                                               "time.sleep(600)'")
        _wait_for(lambda: client.get_job_status(sleeper) == "RUNNING", msg="never RUNNING")
        req = urllib.request.Request(f"{base}/api/jobs/{sleeper}/stop", method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read()) == {"stopped": True}
        assert _wait_for(lambda: client.get_job_status(sleeper) in (
            "STOPPED", "FAILED", "SUCCEEDED") and client.get_job_status(sleeper),
            msg="the sleeper never ended") == "STOPPED"
    finally:
        dash.terminate()
        dash.wait(timeout=30)
    c.stop()


# ------------------------------------------------------------- against JAX's
def _parser_tree(parser: argparse.ArgumentParser) -> dict:
    """{subcommand path: sorted flags and positionals} of a parser."""
    out = {}

    def walk(p, path):
        flags = []
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sub in a.choices.items():
                    walk(sub, f"{path} {name}".strip())
            elif not isinstance(a, argparse._HelpAction):
                flags.append(",".join(a.option_strings) or a.dest)
        out[path] = sorted(flags)

    walk(parser, "")
    return out


def _jax_parser() -> argparse.ArgumentParser:
    from ray_tpu import scripts

    class Built(Exception):
        pass

    def capture(self, *args, **kwargs):
        raise Built(self)

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        scripts.main([])
    except Built as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = original
    raise AssertionError("ray_tpu.scripts.main built no parser")


def test_cli_parser_matches_jax():
    from ray_tpu_torch import scripts

    jax = _parser_tree(_jax_parser())
    ours = _parser_tree(scripts.build_parser())
    # the port's substitution, and nothing else
    jax["start"] = sorted("--num-gpus" if f == "--num-tpus" else f for f in jax["start"])
    assert ours == jax
    assert set(ours) >= {"start", "stop", "status", "list", "summary", "timeline", "dashboard",
                         "job submit", "job status", "job logs", "job list", "job stop",
                         "serve deploy", "serve status", "serve shutdown",
                         "chaos run", "chaos validate", "chaos events", "_autoscaler_monitor",
                         "lint"}
    assert "--autoscale" in ours["start"]


def test_dashboard_routes_match_jax():
    from ray_tpu import dashboard as jdash

    from ray_tpu_torch import dashboard

    jax = {(r.method, r.resource.canonical) for r in jdash.build_app().router.routes()}
    ours = dashboard.build_app().route_table()
    assert ours == jax
    assert ("POST", "/api/jobs/{job_id}/stop") in ours and ("GET", "/metrics") in ours


@pytest.mark.parametrize("name", ["index.html", "app.js", "style.css"])
def test_dashboard_client_files_match_jax(name):
    with open(os.path.join(REPO, "ray_tpu", "dashboard_client", name)) as f:
        jax = f.read()
    with open(os.path.join(REPO, "ray_tpu_torch", "dashboard_client", name)) as f:
        ours = f.read()
    assert ours != jax and "ray_tpu_torch" in ours
    assert ours.replace("ray_tpu_torch", "ray_tpu") == jax


def test_cli_chaos_subcommand(tmp_path, no_aiohttp):
    env = _env(str(tmp_path), no_aiohttp)
    plan = os.path.join(REPO, "tests", "plans", "pg_churn.json")
    r = _cli(env, "chaos", "validate", plan)
    assert r.returncode == 0, r.stderr
    assert "rule(s)" in r.stderr and json.loads(r.stdout)["rules"]
    log_dir = str(tmp_path / "chaos")
    r = _cli(env, "chaos", "run", "--log-dir", log_dir, plan, "--", sys.executable, "-c",
             "import os, sys; print(os.environ['RT_CHAOS_ENABLED'], "
             "os.environ['RT_CHAOS_LOG_DIR']); sys.exit(3)")
    assert r.returncode == 3, r.stderr  # the workload's exit code passes through
    assert r.stdout.split() == ["1", log_dir]
    assert "fault(s) fired" in r.stderr
    r = _cli(env, "chaos", "events", "--log-dir", log_dir)
    assert r.returncode == 0 and json.loads(r.stdout) == []
