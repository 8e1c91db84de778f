"""TorchTrainer: a controller and a group of worker processes.

Counterpart of ``JaxTrainer`` (``ray_tpu/train/trainer.py``), with the same
constructor, ``fit()``, ``Result`` and ``TrainingFailedError``, on a
process launcher of the port's own instead of the actor runtime: the
controller starts ``num_workers`` processes (``subprocess.Popen`` of
``python -m ray_tpu_torch.train.worker``; no fork, no actors), which meet in
one ``torch.distributed`` world through a file store in the run's
directory (NCCL on the cards, gloo otherwise) and each run
``train_loop_per_worker(config)``. The controller reads their reports as
they come, registers rank 0's checkpoints with a ``CheckpointManager``
(top-K retention), and on a worker's failure (an exception, or an exit
code other than 0) kills the whole group and restarts it at the same size
from the latest checkpoint, up to ``FailureConfig.max_failures`` times,
with JAX's backoff. Every worker is killed on the way out.

The loop travels by name, so it must be importable: a module-level
function (of a module, or of the script being run). A nested function or a
lambda cannot travel: the port does not depend on cloudpickle to ship
code by value.
"""

from __future__ import annotations

import math
import os
import pickle
import random
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable

from ray_tpu_torch.accelerators import GPUAcceleratorManager
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.session import Channel

#: Seconds one attempt may run before its workers are killed and it counts
#: as failed (``None``: no limit). The tests set it, as a clock.
ATTEMPT_TIMEOUT_S: float | None = None
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class TrainingFailedError(RuntimeError):
    pass


class Result:
    def __init__(self, metrics: dict, checkpoint: Checkpoint | None,
                 metrics_history: list[dict], error: Exception | None = None):
        self.metrics = metrics
        self.checkpoint = checkpoint
        self.metrics_history = metrics_history
        self.error = error

    def __repr__(self):
        return f"Result(metrics={self.metrics}, checkpoint={self.checkpoint})"


def _loop_ref(fn) -> tuple[str, list[str]]:
    """("module:qualname", the directory to import the module from) for
    the loop function ``fn``."""
    module, qualname = fn.__module__, fn.__qualname__
    if "<locals>" in qualname or "<lambda>" in qualname:
        raise ValueError(f"train_loop_per_worker {qualname!r} must be importable by name "
                         "(a module-level function): a nested function or a lambda cannot "
                         "reach a worker process")
    file = getattr(sys.modules.get(module), "__file__", None)
    if file is None:
        raise ValueError(f"train_loop_per_worker's module {module!r} has no file to import")
    file = os.path.abspath(file)
    if module == "__main__":  # the script being run, imported under its own name
        return f"{os.path.splitext(os.path.basename(file))[0]}:{qualname}", [
            os.path.dirname(file)]
    root = os.path.dirname(file)
    levels = module.count(".") + (os.path.basename(file).startswith("__init__."))
    for _ in range(levels):
        root = os.path.dirname(root)
    return f"{module}:{qualname}", [root]


class TorchTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        resume_from_checkpoint: Checkpoint | None = None,
        datasets: dict | None = None,
    ):
        self.train_loop, self._loop_path = _loop_ref(train_loop_per_worker)
        self.train_loop_config = train_loop_config
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    # ------------------------------------------------------------------ fit
    def fit(self) -> Result:
        name = self.run_config.name or f"train_{int(time.time())}"
        storage = (self.run_config.storage_path
                   or os.path.join(tempfile.gettempdir(), "ray_tpu_torch", name))
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            storage,
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        history: list[dict] = []
        run_dir = tempfile.mkdtemp(prefix=f"rt_{name}_")
        try:
            while True:
                try:
                    metrics = self._run_attempt(name, attempt, run_dir, manager, history)
                    return Result(metrics, manager.latest(), history)
                except TrainingFailedError as e:
                    attempt += 1
                    if max_failures >= 0 and attempt > max_failures:
                        return Result(history[-1] if history else {}, manager.latest(),
                                      history, error=e)
                    # restart the whole group at the same size; the backoff
                    # widens with consecutive failures
                    time.sleep(min(5.0, 0.5 * (2 ** (attempt - 1))) * (0.5 + random.random()))
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)

    def _gpu_ids(self, n: int) -> list[list[str]] | None:
        """The card ids each worker sees: whole cards, or shares of one."""
        if not self.scaling.gpu():
            return None
        share = self.scaling.worker_resources()["GPU"]
        ok, why = GPUAcceleratorManager.validate_resource_request_quantity(share)
        if not ok:
            raise ValueError(why)
        visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        if visible is None:
            visible = [str(i) for i in range(GPUAcceleratorManager.get_current_node_num_accelerators())]
        need = math.ceil(n * share - 1e-9)
        if need > len(visible):
            raise RuntimeError(f"{n} workers of GPU={share} need {need} cards; "
                               f"{len(visible)} visible")
        if share < 1:
            return [[visible[int(i * share + 1e-9)]] for i in range(n)]
        k = int(share)
        return [visible[i * k:(i + 1) * k] for i in range(n)]

    def _run_attempt(self, name: str, attempt: int, run_dir: str,
                     manager: CheckpointManager, history: list[dict]) -> dict:
        n = self.scaling.num_workers
        work = os.path.join(run_dir, f"attempt_{attempt}")
        staging = os.path.join(work, "staging")
        os.makedirs(staging)
        gpu_ids = self._gpu_ids(n)
        resume = manager.latest() or self.resume_from_checkpoint
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PACKAGE_ROOT, *self._loop_path, *filter(None, [env.get("PYTHONPATH")])])
        if n > 1 and "OMP_NUM_THREADS" not in env:
            env["OMP_NUM_THREADS"] = "1"  # as torchrun does, not n x all the cores
        procs, logs, channels = [], [], []
        try:
            for rank in range(n):
                spec = {
                    "rank": rank, "world_size": n, "trial_name": name,
                    "group_name": f"{name}_g{attempt}", "backend": self.scaling.backend(),
                    "init_method": f"file://{os.path.join(work, 'rdzv')}",
                    "gpu_ids": gpu_ids[rank] if gpu_ids else None,
                    "loop": self.train_loop, "sys_path": self._loop_path,
                    "config": self.train_loop_config,
                    "checkpoint": resume.path if resume else None,
                    "channel": os.path.join(work, f"channel_{rank}"), "staging_dir": staging,
                }
                spec_path = os.path.join(work, f"spec_{rank}.pkl")
                with open(spec_path, "wb") as f:
                    pickle.dump(spec, f)
                channels.append(Channel(spec["channel"]))
                logs.append(open(os.path.join(work, f"worker_{rank}.log"), "wb"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.train.worker", spec_path],
                    env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
            return self._poll_loop(procs, channels, manager, history, work)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()

    def _poll_loop(self, procs, channels, manager: CheckpointManager,
                   history: list[dict], work: str) -> dict:
        """Read the workers' frames until every worker is done (the last
        metrics reported) or one fails (``TrainingFailedError``)."""
        deadline = None if ATTEMPT_TIMEOUT_S is None else time.monotonic() + ATTEMPT_TIMEOUT_S
        last_metrics: dict = {}
        done = [False] * len(procs)
        while True:
            # exit codes first: a worker that exited has written all its frames
            codes = [p.poll() for p in procs]
            for rank, channel in enumerate(channels):
                for frame in channel.read():
                    if frame[0] == "report":
                        _, metrics, ckpt_path = frame
                        metrics = {**metrics, "world_rank": rank}
                        history.append(metrics)
                        last_metrics = metrics
                        if ckpt_path and rank == 0:
                            manager.register(Checkpoint(ckpt_path), metrics,
                                             move=ckpt_path.startswith(work))
                        elif ckpt_path and ckpt_path.startswith(work):
                            shutil.rmtree(ckpt_path, ignore_errors=True)
                    elif frame[0] == "done":
                        done[rank] = True
                    else:
                        raise TrainingFailedError(f"worker {rank}: {frame[1]}")
            for rank, code in enumerate(codes):
                if code is not None and (code != 0 or not done[rank]):
                    raise TrainingFailedError(
                        f"worker {rank} exited with code {code}:\n{_tail(work, rank)}")
            if all(done) and all(c == 0 for c in codes):
                return last_metrics
            if deadline is not None and time.monotonic() > deadline:
                raise TrainingFailedError(f"attempt timed out after {ATTEMPT_TIMEOUT_S} s")
            time.sleep(0.05)


def _tail(work: str, rank: int, nbytes: int = 4000) -> str:
    with open(os.path.join(work, f"worker_{rank}.log"), "rb") as f:
        data = f.read()
    return data[-nbytes:].decode(errors="replace")
