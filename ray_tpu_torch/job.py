"""Job submission: run an entrypoint command on the cluster.

The port's copy of ``ray_tpu/job.py``: the reference job subsystem (ref:
python/ray/dashboard/modules/job/sdk.py:36 JobSubmissionClient.submit_job,
job_manager.py JobManager/JobSupervisor): a submitted job becomes a
supervisor actor that spawns the entrypoint as a driver subprocess with
the cluster address exported, captures its output, and records status in
the GCS KV. Three entry surfaces share one manager:

  * REST on the dashboard   POST/GET /api/jobs (ref: job REST head)
  * ``JobSubmissionClient`` SDK over that REST API
  * ``python -m ray_tpu_torch job submit|status|logs|list|stop`` CLI
    (direct GCS mode — works from a bare shell with just the address)

Job records live in GCS KV ns="job_submissions"; logs stream to a file on
the supervisor's node (``$TMPDIR/ray_tpu_torch/jobs/<id>.log``, apart from
the JAX package's ``ray_tpu/jobs``) and are served back through the actor.
The supervisor holds no card (``num_cpus=0``, no ``num_gpus``); card work
belongs in the job's leased tasks, so the driver itself need not start
CUDA.
"""
from __future__ import annotations

import base64
import json
import os
import time
import uuid

_NS = "job_submissions"

# terminal states (ref: job sdk JobStatus)
PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


class JobSupervisor:
    """Actor wrapping one driver subprocess (ref: job_manager.py
    JobSupervisor). Runs the entrypoint with RT_ADDRESS exported so
    ``ray_tpu_torch.init()`` inside the job joins this cluster."""

    def __init__(self, job_id: str, entrypoint: str, runtime_env: dict | None,
                 gcs_address: str):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.runtime_env = runtime_env or {}
        self.gcs_address = gcs_address
        self.proc = None
        self._stop_requested = False
        import tempfile

        self.log_path = os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch", "jobs", f"{job_id}.log")
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)

    def _kv_update(self, **fields):
        from ray_tpu_torch.core import api

        core = api.get_core()
        rec = _get_record(core, self.job_id) or {}
        rec.update(fields)
        core._run_sync(core.gcs.call("kv_put", {
            "ns": _NS, "key": self.job_id,
            "value": json.dumps(rec).encode(), "overwrite": True}))

    def _prepare(self) -> tuple[dict, str | None]:
        """Build the driver env (and materialize the runtime_env).
        Sync — runs in an executor thread, where _run_sync is safe."""
        from ray_tpu_torch.core import api
        from ray_tpu_torch.runtime_env import apply_runtime_env

        env = dict(os.environ)
        env["RT_ADDRESS"] = self.gcs_address
        env["RT_JOB_ID"] = self.job_id
        pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
        cwd = None
        if self.runtime_env:
            core = api.get_core()

            def kv_get(key):
                return core._run_sync(core.gcs.call(
                    "kv_get", {"ns": "runtime_env_packages", "key": key}))

            # materialize in-process only to learn the extracted paths;
            # everything travels to the subprocess via env/cwd
            before = os.getcwd()
            apply_runtime_env(self.runtime_env, kv_get)
            cwd = os.getcwd()
            os.chdir(before)
            for k, v in (self.runtime_env.get("env_vars") or {}).items():
                env[k] = v
            from ray_tpu_torch.runtime_env import _cache_dir

            extra = [os.path.join(_cache_dir(), d)
                     for d in self.runtime_env.get("py_modules", [])]
            if cwd != before:
                extra.insert(0, cwd)
            if extra:
                env["PYTHONPATH"] = (
                    os.pathsep.join(extra) + os.pathsep + env["PYTHONPATH"])
        return env, cwd

    async def run(self) -> str:
        """Spawn the driver and wait for it; returns the final status.

        Async so stop()/logs_tail() stay responsive on the actor's single
        executor thread; every _run_sync-using helper is pushed OFF the
        loop (calling _run_sync on the loop thread would deadlock)."""
        import asyncio
        import subprocess

        loop = asyncio.get_running_loop()
        try:
            env, cwd = await loop.run_in_executor(None, self._prepare)
        except Exception as e:
            await loop.run_in_executor(
                None, lambda: self._kv_update(
                    status=FAILED, message=f"runtime_env failed: {e}",
                    end_time=time.time()))
            return FAILED
        if self._stop_requested:  # stop() raced the startup: honor it
            await loop.run_in_executor(
                None, lambda: self._kv_update(
                    status=STOPPED, message="stopped before start",
                    end_time=time.time()))
            return STOPPED
        await loop.run_in_executor(
            None, lambda: self._kv_update(status=RUNNING,
                                          start_time=time.time()))
        logf = open(self.log_path, "ab")
        try:
            # own process group: stop() must reach the real driver behind
            # the shell wrapper (compound entrypoints would otherwise
            # orphan it)
            self.proc = subprocess.Popen(
                self.entrypoint, shell=True, env=env, cwd=cwd,
                stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True,
            )
            rc = await loop.run_in_executor(None, self.proc.wait)
        finally:
            logf.close()
        if self._stop_requested and rc != 0:
            status, msg = STOPPED, "stopped"
        elif rc == 0:
            status, msg = SUCCEEDED, ""
        else:
            # a signal exit we did NOT request (e.g. the kernel OOM killer
            # SIGKILLing the driver) is a failure, not a stop
            status, msg = FAILED, (
                f"terminated by signal {-rc}" if rc < 0
                else f"entrypoint exited with code {rc}")
        await loop.run_in_executor(
            None, lambda: self._kv_update(status=status, message=msg,
                                          end_time=time.time()))
        return status

    def stop(self) -> bool:
        """Request termination. True if the job will stop (even if the
        driver hasn't spawned yet — run() checks the flag)."""
        self._stop_requested = True
        if self.proc is None:
            return True  # pre-start: run() will honor the flag
        if self.proc.poll() is not None:
            return False  # already finished
        import signal

        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            self.proc.terminate()
        return True

    def logs_tail(self, nbytes: int = 1 << 20) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - nbytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""


# ------------------------------------------------------------- manager API
# (requires an initialized ray_tpu_torch; used by the dashboard REST handlers,
# the CLI's direct mode, and tests)

def _get_record(core, job_id: str) -> dict | None:
    blob = core._run_sync(core.gcs.call("kv_get", {"ns": _NS, "key": job_id}))
    return json.loads(blob) if blob else None


def _gcs_address_str() -> str:
    from ray_tpu_torch.core import api

    core = api.get_core()
    host, port = core.gcs_address
    return f"{host}:{port}"


def submit_job(entrypoint: str, runtime_env: dict | None = None,
               job_id: str | None = None, metadata: dict | None = None) -> str:
    """Start a job; returns its submission id (ref: sdk.py:126 submit_job)."""
    import ray_tpu_torch
    from ray_tpu_torch.core import api

    core = api.get_core()
    job_id = job_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
    if _get_record(core, job_id) is not None:
        raise ValueError(f"job {job_id!r} already exists")
    desc = None
    if runtime_env:
        from ray_tpu_torch.runtime_env import package_runtime_env

        def kv_put(key, blob):
            core._run_sync(core.gcs.call("kv_put", {
                "ns": "runtime_env_packages", "key": key, "value": blob}))

        # already-packaged descriptors (REST path) pass through untouched
        if runtime_env.get("_packaged"):
            desc = {k: v for k, v in runtime_env.items() if k != "_packaged"}
        else:
            desc = package_runtime_env(runtime_env, kv_put)
    rec = {
        "job_id": job_id,
        "entrypoint": entrypoint,
        "status": PENDING,
        "message": "",
        "submission_time": time.time(),
        "metadata": metadata or {},
    }
    core._run_sync(core.gcs.call("kv_put", {
        "ns": _NS, "key": job_id, "value": json.dumps(rec).encode()}))
    sup = ray_tpu_torch.remote(JobSupervisor).options(
        name=f"_job_supervisor_{job_id}", num_cpus=0
    ).remote(job_id, entrypoint, desc, _gcs_address_str())
    # fire-and-forget by design: the supervisor reports terminal status
    # (and any error) into the GCS KV, which job_status() surfaces
    sup.run.remote()  # raylint: disable=RT003
    return job_id


def job_status(job_id: str) -> dict:
    from ray_tpu_torch.core import api

    rec = _get_record(api.get_core(), job_id)
    if rec is None:
        raise KeyError(f"no such job {job_id!r}")
    return rec


def list_jobs() -> list[dict]:
    from ray_tpu_torch.core import api

    core = api.get_core()
    keys = core._run_sync(core.gcs.call("kv_keys", {"ns": _NS, "prefix": ""}))
    out = []
    for k in keys or []:
        rec = _get_record(core, k if isinstance(k, str) else k.decode())
        if rec:
            out.append(rec)
    return sorted(out, key=lambda r: r.get("submission_time", 0))


def job_logs(job_id: str, nbytes: int = 1 << 20) -> str:
    import ray_tpu_torch

    try:
        sup = ray_tpu_torch.get_actor(f"_job_supervisor_{job_id}")
    except ValueError:
        rec = job_status(job_id)
        return rec.get("message", "")
    return ray_tpu_torch.get(sup.logs_tail.remote(nbytes), timeout=30)


def stop_job(job_id: str) -> bool:
    import ray_tpu_torch

    try:
        sup = ray_tpu_torch.get_actor(f"_job_supervisor_{job_id}")
    except ValueError:
        return False
    return ray_tpu_torch.get(sup.stop.remote(), timeout=30)


def wait_job(job_id: str, timeout: float = 300.0) -> dict:
    """Poll until the job reaches a terminal state (tests / CLI --wait)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rec = job_status(job_id)
        if rec["status"] in (SUCCEEDED, FAILED, STOPPED):
            return rec
        time.sleep(0.3)
    raise TimeoutError(f"job {job_id} still {rec['status']} after {timeout}s")


# ----------------------------------------------------------------- REST SDK
class JobSubmissionClient:
    """HTTP client for the dashboard's /api/jobs endpoints (ref: sdk.py:36).
    Packages working_dir/py_modules locally and ships the blobs inline."""

    def __init__(self, address: str):
        self.base = address.rstrip("/")
        if not self.base.startswith("http"):
            self.base = "http://" + self.base

    def _request(self, method: str, path: str, body: dict | None = None):
        import urllib.request

        req = urllib.request.Request(
            self.base + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read().decode())

    def submit_job(self, *, entrypoint: str, runtime_env: dict | None = None,
                   submission_id: str | None = None,
                   metadata: dict | None = None) -> str:
        packages: dict[str, str] = {}
        desc = None
        if runtime_env:
            from ray_tpu_torch.runtime_env import package_runtime_env

            def collect(key, blob):
                packages[key] = base64.b64encode(blob).decode()

            desc = package_runtime_env(runtime_env, collect)
        reply = self._request("POST", "/api/jobs", {
            "entrypoint": entrypoint,
            "runtime_env": desc,
            "packages": packages,
            "submission_id": submission_id,
            "metadata": metadata,
        })
        if "error" in reply:
            raise RuntimeError(reply["error"])
        return reply["job_id"]

    def get_job_status(self, job_id: str) -> str:
        return self._request("GET", f"/api/jobs/{job_id}")["status"]

    def get_job_info(self, job_id: str) -> dict:
        return self._request("GET", f"/api/jobs/{job_id}")

    def get_job_logs(self, job_id: str) -> str:
        return self._request("GET", f"/api/jobs/{job_id}/logs")["logs"]

    def list_jobs(self) -> list[dict]:
        return self._request("GET", "/api/jobs")

    def stop_job(self, job_id: str) -> bool:
        return self._request("POST", f"/api/jobs/{job_id}/stop")["stopped"]
