"""TuneController: drives trials as actors, applies scheduler decisions.

Counterpart of ``ray_tpu/tune/controller.py`` on the port's runtime (ref:
python/ray/tune/execution/tune_controller.py:68 — event loop step :666,
actor management _schedule_trial_actor :964) with PG-per-trial resources
(tune/execution/placement_groups.py PlacementGroupFactory). Trials run as
``TrialActor`` actors of ``ray_tpu_torch``, each in a placement group of
its own with ``max_concurrency=2`` so ``poll`` is served while ``run``
blocks; the controller polls their report outboxes, feeds the scheduler,
early-stops losers, executes PBT's exploit, and retries failed trials up to
max_failures_per_trial. The trial table is snapshotted to
``experiment_state.json`` (for people) and ``experiment_state.pkl`` (for
``Tuner.restore``) under the experiment's storage path.
"""
from __future__ import annotations

import logging
import json
import os
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.schedulers import CONTINUE, EXPLOIT, STOP

_log = logging.getLogger(__name__)

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
STOPPED = "STOPPED"  # early-stopped by the scheduler
ERRORED = "ERRORED"


class TrialActor:
    """Actor hosting one trial's trainable function."""

    def __init__(self, trial_id: str, storage_path: str):
        from ray_tpu_torch.tune import session as tune_session

        self.trial_id = trial_id
        self.storage_path = storage_path
        self._done = False
        self._error: str | None = None
        self._session = None
        self._tune_session_mod = tune_session

    def run(self, trainable: Callable, config: dict,
            checkpoint_path: str | None = None, start_iteration: int = 0):
        """Blocking trainable execution (executor thread; poll() stays
        servable on the actor loop — same split as TrainWorker.run)."""
        from ray_tpu_torch.tune.session import TrialStopped, init_session

        ckpt = Checkpoint.from_directory(checkpoint_path) if checkpoint_path else None
        self._session = init_session(self.trial_id, config, ckpt)
        # resumed trials continue their iteration count so schedulers don't
        # re-record rungs the trial already passed
        self._session.iteration = start_iteration
        try:
            out = trainable(config)
            return {"ok": True, "result": out}
        except TrialStopped:
            return {"ok": True, "stopped": True}
        except Exception as e:  # noqa: BLE001
            self._error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            return {"ok": False, "error": self._error}
        finally:
            self._done = True

    def poll(self):
        # read _done BEFORE draining: a report enqueued between the drain
        # and the done-check would otherwise be lost on the final poll
        done = self._done
        out = []
        if self._session is not None:
            while not self._session.outbox.empty():
                metrics, ckpt = self._session.outbox.get_nowait()
                out.append((metrics, ckpt.path if ckpt else None))
        return {"reports": out, "done": done, "error": self._error}

    def request_stop(self):
        if self._session is not None:
            self._session.stop_requested = True
        return True


@dataclass
class Trial:
    trial_id: str
    config: dict
    status: str = PENDING
    metrics: dict = field(default_factory=dict)
    history: list = field(default_factory=list)
    checkpoint_path: str | None = None
    error: str | None = None
    failures: int = 0
    actor: Any = None
    run_ref: Any = None
    pg: Any = None


class TuneController:
    def __init__(self, trainable: Callable, variants: list[dict], *,
                 scheduler=None, metric: str | None = None, mode: str = "max",
                 max_concurrent_trials: int | None = None,
                 resources_per_trial: dict | None = None,
                 storage_path: str, max_failures_per_trial: int = 0,
                 trials: list[Trial] | None = None,
                 searcher=None, num_samples: int | None = None,
                 callbacks: list | None = None):
        self.trainable = trainable
        self.scheduler = scheduler or sched_mod.FIFOScheduler()
        # suggest-driven search (ref: tune_controller + SearchGenerator):
        # trials are appended on demand up to num_samples, so each
        # suggest() observes every completed trial so far
        self.searcher = searcher
        self.num_samples = num_samples or 1
        self._searcher_exhausted = False  # suggest() returned None
        # driver-side logger callbacks (ref: tune/logger LoggerCallback;
        # air/integrations wandb+mlflow ride this hook)
        self.callbacks = list(callbacks or [])
        for cb in self.callbacks:
            cb.setup(os.path.basename(storage_path))
        self.metric = metric
        self.mode = mode
        self.max_concurrent = max_concurrent_trials or 4
        self.resources = dict(resources_per_trial or {"CPU": 1.0})
        self.storage_path = storage_path
        self.max_failures = max_failures_per_trial
        # restored experiments pass their rebuilt trial table directly
        self.trials = trials if trials is not None else [
            Trial(trial_id=f"trial_{i:05d}_{uuid.uuid4().hex[:6]}", config=cfg)
            for i, cfg in enumerate(variants)
        ]
        os.makedirs(storage_path, exist_ok=True)

    # -------------------------------------------------------------- run loop
    def run(self) -> list[Trial]:
        """Event loop (ref: tune_controller.py step :666)."""
        last_state_write = 0.0
        while True:
            self._maybe_suggest()
            self._start_pending()
            # periodic state snapshots make a killed driver resumable via
            # Tuner.restore (ref: experiment_state.py periodic sync)
            if time.monotonic() - last_state_write > 1.0:
                self._write_experiment_state()
                last_state_write = time.monotonic()
            running = [t for t in self.trials if t.status == RUNNING]
            if not running:
                done_count = 0 if (self.searcher is None
                                   or self._searcher_exhausted) \
                    else self.num_samples
                if (len(self.trials) >= done_count
                        and all(t.status in (TERMINATED, STOPPED, ERRORED)
                                for t in self.trials)):
                    break
                time.sleep(0.02)
                continue
            self._poll_running(running)
            time.sleep(0.02)
        self._write_experiment_state()
        for cb in self.callbacks:
            try:
                cb.on_experiment_end()
            except Exception:
                _log.debug("callback on_experiment_end failed", exc_info=True)
        return self.trials

    def _maybe_suggest(self):
        if self.searcher is None:
            return
        active = sum(1 for t in self.trials
                     if t.status in (PENDING, RUNNING))
        while (not self._searcher_exhausted
               and len(self.trials) < self.num_samples
               and active < self.max_concurrent):
            tid = f"trial_{len(self.trials):05d}_{uuid.uuid4().hex[:6]}"
            cfg = self.searcher.suggest(tid)
            if cfg is None:
                # the searcher is done producing configs: run() must
                # terminate after the existing trials finish, not wait
                # for num_samples that will never come
                self._searcher_exhausted = True
                break
            self.trials.append(Trial(trial_id=tid, config=cfg))
            active += 1

    def _start_pending(self):
        running = sum(1 for t in self.trials if t.status == RUNNING)
        for trial in self.trials:
            if running >= self.max_concurrent:
                break
            if trial.status != PENDING:
                continue
            try:
                self._launch(trial)
                running += 1
            except Exception as e:  # cluster can't host it right now
                trial.error = str(e)
                trial.status = ERRORED

    def _launch(self, trial: Trial):
        # PG-per-trial so multi-resource trials get gang placement
        # (ref: tune/execution/placement_groups.py)
        trial.pg = ray_tpu_torch.placement_group([dict(self.resources)], strategy="PACK")
        if not trial.pg.ready(timeout=60):
            raise RuntimeError(
                f"trial {trial.trial_id}: placement group {self.resources} "
                "not placeable on this cluster"
            )
        cpus = self.resources.get("CPU", 1.0)
        other = {k: v for k, v in self.resources.items() if k != "CPU"}
        trial.actor = (
            ray_tpu_torch.remote(TrialActor)
            .options(
                num_cpus=cpus,
                resources=other,
                placement_group=trial.pg,
                placement_group_bundle_index=0,
                max_concurrency=2,  # poll() while run() occupies the executor
            )
            .remote(trial.trial_id, self.storage_path)
        )
        trial.run_ref = trial.actor.run.remote(
            self.trainable, trial.config, trial.checkpoint_path, len(trial.history)
        )
        trial.status = RUNNING
        for cb in self.callbacks:
            try:
                cb.on_trial_start(trial.trial_id, trial.config)
            except Exception:
                _log.debug("callback on_trial_start failed", exc_info=True)

    def _poll_running(self, running: list[Trial]):
        # submit every poll before retrieving any so trials answer
        # concurrently; retrieval stays per-ref because one dead actor
        # must not sink the whole batch
        refs = [t.actor.poll.remote() for t in running]
        polls = []
        for ref in refs:
            try:
                polls.append(ray_tpu_torch.get(ref, timeout=30))  # raylint: disable=RT002
            except Exception:
                polls.append(None)  # actor died
        for trial, poll in zip(running, polls):
            if poll is None:
                self._on_trial_failed(trial, "trial actor died")
                continue
            for metrics, ckpt_path in poll["reports"]:
                trial.metrics = metrics
                trial.history.append(metrics)
                for cb in self.callbacks:
                    try:
                        cb.on_trial_result(trial.trial_id, metrics)
                    except Exception:
                        _log.debug("callback on_trial_result failed",
                                   exc_info=True)
                if ckpt_path:
                    trial.checkpoint_path = ckpt_path
                decision = self.scheduler.on_result(trial.trial_id, metrics)
                if decision == STOP:
                    self._stop_trial(trial)
                    break
                if decision == EXPLOIT:
                    self._exploit_trial(trial)
                    break
            if trial.status == RUNNING and poll["done"]:
                self._finish_trial(trial, poll)

    def _finish_trial(self, trial: Trial, poll: dict):
        try:
            r = ray_tpu_torch.get(trial.run_ref, timeout=30)
        except Exception as e:
            self._on_trial_failed(trial, str(e))
            return
        if not r.get("ok"):
            self._on_trial_failed(trial, r.get("error", "unknown"))
            return
        trial.status = STOPPED if r.get("stopped") else TERMINATED
        self.scheduler.on_trial_complete(trial.trial_id, trial.metrics or None)
        if self.searcher is not None:
            self.searcher.on_trial_complete(trial.trial_id,
                                            trial.metrics or None)
        for cb in self.callbacks:
            try:
                cb.on_trial_complete(trial.trial_id, trial.metrics or None)
            except Exception:
                _log.debug("callback on_trial_complete failed", exc_info=True)
        self._teardown(trial)

    def _stop_trial(self, trial: Trial):
        """Scheduler early-stop: ask the trainable to raise at next report."""
        try:
            ray_tpu_torch.get(trial.actor.request_stop.remote(), timeout=10)
        except Exception:  # raylint: disable=RT012 — actor may already be dead; teardown below reaps it
            pass
        trial.status = STOPPED
        self.scheduler.on_trial_complete(trial.trial_id, trial.metrics or None)
        if self.searcher is not None:
            self.searcher.on_trial_complete(trial.trial_id,
                                            trial.metrics or None)
        for cb in self.callbacks:
            try:
                cb.on_trial_complete(trial.trial_id, trial.metrics or None)
            except Exception:
                _log.debug("callback on_trial_complete failed", exc_info=True)
        self._teardown(trial)

    def _exploit_trial(self, trial: Trial):
        """PBT exploit+explore (ref: tune/schedulers/pbt.py): clone a
        top-quantile trial's checkpoint, mutate its config, restart this
        trial from the clone."""
        donor_id = self.scheduler.pick_donor(exclude=trial.trial_id)
        donor = next((t for t in self.trials if t.trial_id == donor_id), None)
        if donor is None or donor.checkpoint_path is None:
            return  # nothing to clone yet: keep training
        try:
            ray_tpu_torch.get(trial.actor.request_stop.remote(), timeout=10)
        except Exception:  # raylint: disable=RT012 — actor may already be dead; teardown below reaps it
            pass
        self._teardown(trial)
        trial.config = self.scheduler.explore(dict(donor.config))
        trial.checkpoint_path = donor.checkpoint_path
        trial.status = PENDING  # relaunch resumes from the donor's state
        self.scheduler.num_exploits += 1

    def _on_trial_failed(self, trial: Trial, error: str):
        trial.failures += 1
        self._teardown(trial)
        if trial.failures <= self.max_failures:
            trial.status = PENDING  # retry (resumes from its last checkpoint)
        else:
            trial.status = ERRORED
            trial.error = error
            self.scheduler.on_trial_complete(trial.trial_id, None)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, None)
            for cb in self.callbacks:
                try:
                    cb.on_trial_complete(trial.trial_id, None)
                except Exception:
                    _log.debug("callback on_trial_complete failed",
                               exc_info=True)

    def _teardown(self, trial: Trial):
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:  # raylint: disable=RT012 — teardown: actor may already be dead
                pass
            trial.actor = None
        if trial.pg is not None:
            try:
                ray_tpu_torch.remove_placement_group(trial.pg)
            except Exception:  # raylint: disable=RT012 — teardown: PG may already be gone
                pass
            trial.pg = None

    # ------------------------------------------------------------ experiment
    def _write_experiment_state(self):
        """Persist the trial table for resumability + analysis
        (ref: tune/execution/experiment_state.py). JSON for humans; a
        pickle sidecar carries full-fidelity configs/history for
        Tuner.restore."""
        state = [
            {
                "trial_id": t.trial_id,
                "config": _jsonable(t.config),
                "status": t.status,
                "metrics": _jsonable(t.metrics),
                "checkpoint_path": t.checkpoint_path,
                "error": t.error,
            }
            for t in self.trials
        ]
        with open(os.path.join(self.storage_path, "experiment_state.json"), "w") as f:
            json.dump(state, f, indent=2, default=str)
        import pickle

        full = [
            {
                "trial_id": t.trial_id,
                "config": t.config,
                "status": t.status,
                "metrics": t.metrics,
                "history": t.history,
                "checkpoint_path": t.checkpoint_path,
                "error": t.error,
            }
            for t in self.trials
        ]
        tmp = os.path.join(self.storage_path, "experiment_state.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(full, f)
        os.replace(tmp, os.path.join(self.storage_path, "experiment_state.pkl"))

    @staticmethod
    def load_experiment_state(storage_path: str) -> list[Trial]:
        """Rebuild the trial table from a (possibly killed) experiment's
        snapshots. Unfinished trials come back PENDING and resume from
        their last checkpoint; finished ones keep their results."""
        import pickle

        path = os.path.join(storage_path, "experiment_state.pkl")
        with open(path, "rb") as f:
            rows = pickle.load(f)
        trials = []
        for r in rows:
            t = Trial(trial_id=r["trial_id"], config=r["config"])
            t.metrics = r.get("metrics") or {}
            t.history = r.get("history") or []
            t.checkpoint_path = r.get("checkpoint_path")
            status = r.get("status")
            if status in (TERMINATED, STOPPED):
                t.status = status
                t.error = r.get("error")
            else:  # PENDING / RUNNING / ERRORED at kill time: run it again
                t.status = PENDING
            trials.append(t)
        return trials


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return repr(obj)
