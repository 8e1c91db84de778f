"""TorchTrainer: a controller and a group of worker actors.

Counterpart of ``JaxTrainer`` (``ray_tpu/train/trainer.py``), with the same
constructor, ``fit()``, ``Result`` and ``TrainingFailedError``, on the port's
task/actor runtime (``ray_tpu_torch.core``; ``fit`` calls
``ray_tpu_torch.init()`` on first use). The controller creates one
``TrainWorker`` actor (``train/worker.py``) per rank in a placement group
with a bundle per worker (``{"CPU": 1, "GPU": share}``); the ranks meet in
one ``torch.distributed`` world through the runtime's GCS KV under a group
name of the attempt's own, ``<name>_g<attempt>``, so a restarted attempt
never reads a dead attempt's address (NCCL on the cards, gloo otherwise),
and each runs
``train_loop_per_worker(config)``. The controller polls their reports as
they come, registers rank 0's checkpoints with a ``CheckpointManager``
(top-K retention), and on a worker's failure (an exception, or an actor
that died) kills the whole group and restarts it at the same size from the
latest checkpoint, up to ``FailureConfig.max_failures`` times, with JAX's
backoff. Every actor is killed and the placement group removed on the way
out.

The loop travels by name, so it must be importable: a module-level
function (of a module, or of the script being run). A nested function or a
lambda is refused: the port does not depend on cloudpickle to ship code by
value.
"""

from __future__ import annotations

import math
import os
import random
import shutil
import sys
import tempfile
import time
from typing import Callable

import ray_tpu_torch
from ray_tpu_torch.accelerators import GPUAcceleratorManager
from ray_tpu_torch.core.ref import ActorError, TaskError
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker import TrainWorker

#: Seconds one attempt may run before its workers are killed and it counts
#: as failed (``None``: no limit). The tests set it, as a clock.
ATTEMPT_TIMEOUT_S: float | None = None


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
        gpu_ids = self._gpu_ids(self.scaling.num_workers)  # raises without CUDA
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
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
                    metrics = self._run_attempt(name, attempt, run_dir, gpu_ids, manager,
                                                history)
                    return Result(metrics, manager.latest(), history)
                except (ActorError, TaskError, TrainingFailedError) as e:
                    attempt += 1
                    if max_failures >= 0 and attempt > max_failures:
                        return Result(history[-1] if history else {}, manager.latest(),
                                      history, error=TrainingFailedError(str(e)))
                    # restart the whole group at the same size; the backoff
                    # widens with consecutive failures
                    time.sleep(min(5.0, 0.5 * (2 ** (attempt - 1))) * (0.5 + random.random()))
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)

    def _gpu_ids(self, n: int) -> list[list[str]] | None:
        """The card each worker of a fractional share sets for itself;
        ``None`` for CPU workers and for whole cards, which the runtime's
        lease pins."""
        if not self.scaling.gpu():
            return None
        share = self.scaling.worker_resources()["GPU"]
        ok, why = GPUAcceleratorManager.validate_resource_request_quantity(share)
        if not ok:
            raise ValueError(why)
        if share >= 1:
            return None
        visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        if visible is None:
            visible = [str(i) for i in range(GPUAcceleratorManager.get_current_node_num_accelerators())]
        need = math.ceil(n * share - 1e-9)
        if need > len(visible):
            raise RuntimeError(f"{n} workers of GPU={share} need {need} cards; "
                               f"{len(visible)} visible")
        return [[visible[int(i * share + 1e-9)]] for i in range(n)]

    def _run_attempt(self, name: str, attempt: int, run_dir: str, gpu_ids,
                     manager: CheckpointManager, history: list[dict]) -> dict:
        scaling = self.scaling
        n = scaling.num_workers
        work = os.path.join(run_dir, f"attempt_{attempt}")
        staging = os.path.join(work, "staging")
        os.makedirs(staging)
        resources = scaling.worker_resources()
        pg = ray_tpu_torch.placement_group([resources] * n, strategy=scaling.placement_strategy)
        workers = []
        try:
            if not pg.ready(timeout=60):
                raise RuntimeError(f"a placement group of {n} x {resources} did not fit in "
                                   f"{ray_tpu_torch.available_resources()}")
            cls = ray_tpu_torch.remote(TrainWorker)
            # one group name per fit (run_dir is unique) and per attempt: a
            # rank never reads another fit's or a dead attempt's address
            group = f"{os.path.basename(run_dir)}_g{attempt}"
            for rank in range(n):
                # per-rank bundle index: the options differ every iteration
                workers.append(cls.options(  # raylint: disable=RT009
                    num_cpus=resources.get("CPU", 1.0),
                    resources={k: v for k, v in resources.items() if k != "CPU"},
                    placement_group=pg, placement_group_bundle_index=rank,
                    # poll() must be servable while run() blocks a thread
                    max_concurrency=2,
                ).remote(rank, n, name, scaling.backend(), group))
            resume = manager.latest() or self.resume_from_checkpoint
            spec = {"use_gpu": scaling.gpu(), "sys_path": self._loop_path,
                    "checkpoint": resume.path if resume else None, "staging_dir": staging}
            ray_tpu_torch.get([w.setup.remote({**spec, "gpu_ids": gpu_ids[r] if gpu_ids else None})
                               for r, w in enumerate(workers)], timeout=300)
            run_refs = [w.run.remote(self.train_loop, self.train_loop_config) for w in workers]
            return self._poll_loop(workers, run_refs, manager, history, work)
        finally:
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:  # noqa: BLE001  # raylint: disable=RT012 -- teardown: the actor may be dead already
                    pass
            try:
                ray_tpu_torch.remove_placement_group(pg)
            except Exception:  # noqa: BLE001  # raylint: disable=RT012 -- teardown: the group dies with the cluster
                pass

    def _poll_loop(self, workers, run_refs, manager: CheckpointManager,
                   history: list[dict], work: str) -> dict:
        """Drain the workers' reports until every worker is done (the last
        metrics reported) or one fails (``TrainingFailedError``, or the
        ``ActorError`` of a worker that died)."""
        deadline = None if ATTEMPT_TIMEOUT_S is None else time.monotonic() + ATTEMPT_TIMEOUT_S
        last_metrics: dict = {}
        pending = list(run_refs)
        while True:
            # early run() failures (an import of the loop, say) come first
            done_now, _ = ray_tpu_torch.wait(pending, num_returns=len(pending), timeout=0.01)
            for r in ray_tpu_torch.get(done_now):
                if not r.get("ok"):
                    raise TrainingFailedError(r.get("error", "unknown"))
            polls, died = [], None
            for rank, ref in enumerate([w.poll.remote() for w in workers]):
                try:
                    # every poll is in flight already; one get per rank
                    # pins a dead worker's ActorError on its rank
                    polls.append(ray_tpu_torch.get(ref, timeout=60))  # raylint: disable=RT002
                except ActorError as e:
                    # the living ranks' reports (rank 0's checkpoints) are
                    # registered first: the restart resumes from them
                    polls.append({"reports": [], "done": False, "error": None})
                    died = died or f"worker {rank} died: {e}"
            for rank, poll in enumerate(polls):
                for metrics, ckpt_path in poll["reports"]:
                    metrics = {**metrics, "world_rank": rank}
                    history.append(metrics)
                    last_metrics = metrics
                    if ckpt_path and rank == 0:
                        manager.register(Checkpoint(ckpt_path), metrics,
                                         move=ckpt_path.startswith(work))
                    elif ckpt_path and ckpt_path.startswith(work):
                        shutil.rmtree(ckpt_path, ignore_errors=True)
                if poll["error"]:
                    raise TrainingFailedError(f"worker {rank}: {poll['error']}")
            if died:
                raise TrainingFailedError(died)
            if all(p["done"] for p in polls):
                for r in ray_tpu_torch.get(pending, timeout=60):
                    if not r.get("ok"):
                        raise TrainingFailedError(r.get("error", "unknown"))
                return last_metrics
            if deadline is not None and time.monotonic() > deadline:
                raise TrainingFailedError(f"attempt timed out after {ATTEMPT_TIMEOUT_S} s")
            time.sleep(0.05)
