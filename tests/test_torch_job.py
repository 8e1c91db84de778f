"""The port's job submission (``ray_tpu_torch.job``) on its runtime, on the
CPU, against the JAX package's ``ray_tpu.job``.

Every case of ``tests/test_job.py``, translated: a job's lifecycle through
the manager, a failing entrypoint, a driver that joins the cluster through
``RT_ADDRESS`` from a shipped ``working_dir``, a stopped job, and the
SDK -> REST -> manager round trip through the port's dashboard. Then: the
same three entrypoints (success, exit code 3, stop) give the same
sequence of statuses, the same ``message`` and the same record keys as on
JAX's runtime (``tests/_torch_state_jax.py``, each package in a process of
its own); and a job's log and driver path are the port's own.

One port runtime serves the module.
"""

import concurrent.futures
import gc
import os
import time

import pytest

import _torch_state_jax
import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse
from ray_tpu_torch import job as jobmod

_module_limit, _test_limit = time_limits(module_s=180, test_s=90)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both packages' job runs, started now and read by the parity tests
    at the end of the module (they run while the module does)."""
    # the base temp dir is made at its first use, unlocked: made here, before
    # the runs' threads, so they and this module's tests never race to mkdir it
    tmp_path_factory.getbasetemp()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(_torch_state_jax.run_once, tmp_path_factory)
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def rt(parity):
    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(autouse=True)
def collect():
    yield
    gc.collect()


# ------------------------------------------------ tests/test_job.py, translated
def test_job_lifecycle_direct(rt):
    jid = jobmod.submit_job(
        "python -c \"import os; print('hello from job', os.environ['RT_JOB_ID'])\"")
    rec = jobmod.wait_job(jid, timeout=60)
    assert rec["status"] == "SUCCEEDED", rec
    logs = jobmod.job_logs(jid)
    assert "hello from job" in logs and jid in logs
    assert any(r["job_id"] == jid for r in jobmod.list_jobs())


def test_job_failure_reported(rt):
    jid = jobmod.submit_job("python -c 'raise SystemExit(3)'")
    rec = jobmod.wait_job(jid, timeout=60)
    assert rec["status"] == "FAILED"
    assert "3" in rec["message"]


def test_job_connects_to_cluster(rt, tmp_path):
    """The entrypoint's ray_tpu_torch.init() joins THIS cluster (RT_ADDRESS),
    shown by a task's result that the driver prints."""
    code = (
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init()\n"  # joins through RT_ADDRESS
        "@ray_tpu_torch.remote\n"
        "def f(): return sum(range(10))\n"
        "print('RESULT', ray_tpu_torch.get(f.remote()))\n"
        "ray_tpu_torch.shutdown()\n"
    )
    (tmp_path / "entry.py").write_text(code)
    jid = jobmod.submit_job("python entry.py", runtime_env={"working_dir": str(tmp_path)})
    rec = jobmod.wait_job(jid, timeout=90)
    assert rec["status"] == "SUCCEEDED", (rec, jobmod.job_logs(jid))
    assert "RESULT 45" in jobmod.job_logs(jid)


def test_job_stop(rt):
    jid = jobmod.submit_job("python -c 'import time; time.sleep(600)'")
    deadline = time.monotonic() + 60
    while jobmod.job_status(jid)["status"] == "PENDING":
        assert time.monotonic() < deadline
        time.sleep(0.05)
    assert jobmod.stop_job(jid)
    rec = jobmod.wait_job(jid, timeout=60)
    assert rec["status"] == "STOPPED"


def test_job_rest_api_and_sdk(rt, tmp_path):
    """SDK -> REST -> manager round trip, working_dir shipped as blobs."""
    from ray_tpu_torch.dashboard import start_dashboard_async

    core = rt.get_core()
    runner, (host, port) = core._run_sync(start_dashboard_async("127.0.0.1", 0))
    try:
        client = jobmod.JobSubmissionClient(f"http://{host}:{port}")
        (tmp_path / "go.py").write_text("print('rest job ran', 7 * 6)\n")
        jid = client.submit_job(entrypoint="python go.py",
                                runtime_env={"working_dir": str(tmp_path)})
        deadline = time.monotonic() + 60
        while client.get_job_status(jid) not in ("SUCCEEDED", "FAILED", "STOPPED"):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        info = client.get_job_info(jid)
        assert info["status"] == "SUCCEEDED", info
        assert "rest job ran 42" in client.get_job_logs(jid)
        assert any(r["job_id"] == jid for r in client.list_jobs())
    finally:
        core._run_sync(runner.cleanup())


# ---------------------------------------------------------- against JAX's jobs
@pytest.mark.parametrize("case", sorted(_torch_state_jax.JOBS))
def test_job_statuses_and_records_match_jax(parity, case):
    runs = parity.result()
    jax, ours = runs["ray_tpu"]["jobs"][case], runs["ray_tpu_torch"]["jobs"][case]
    assert ours["statuses"] == jax["statuses"]
    assert ours["message"] == jax["message"]
    assert ours["keys"] == jax["keys"]
    want = {"succeeds": "SUCCEEDED", "exits_3": "FAILED", "stopped": "STOPPED"}[case]
    assert ours["statuses"] == ["PENDING", "RUNNING", want]
    if case == "succeeds":
        assert "job ok" in ours["logs"] and "job ok" in jax["logs"]


def test_job_log_and_driver_path_are_the_ports(tmp_path, monkeypatch):
    """A job's log lives under $TMPDIR/ray_tpu_torch/jobs (JAX's under
    ray_tpu/jobs), and its driver's PYTHONPATH starts at the directory that
    holds ray_tpu_torch."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    sup = jobmod.JobSupervisor("raysubmit_x", "true", None, "127.0.0.1:1")
    assert sup.log_path == os.path.join(str(tmp_path), "ray_tpu_torch", "jobs",
                                        "raysubmit_x.log")
    env, cwd = sup._prepare()
    assert cwd is None
    assert env["RT_ADDRESS"] == "127.0.0.1:1" and env["RT_JOB_ID"] == "raysubmit_x"
    parent = env["PYTHONPATH"].split(os.pathsep)[0]
    assert os.path.isfile(os.path.join(parent, "ray_tpu_torch", "job.py"))
