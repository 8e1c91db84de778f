"""ray_tpu_torch.tune — hyperparameter search on the port's runtime.

Counterpart of ``ray_tpu/tune`` (ref: python/ray/tune/): ``Tuner.fit``
(tuner.py:43, fit :312) drives a ``TuneController`` event loop
(execution/tune_controller.py:68) over actor-per-trial trainables with
PG-per-trial placement, basic variant generation (grid + random sampling),
TPE search, and ASHA / median-stopping / PBT scheduling (schedulers/). A
``TorchTrainer`` is a trainable too (Tune over Train): each trial runs a
whole ``fit()`` from an actor that holds no card, and the trainer's worker
actors lease the cards.

    from ray_tpu_torch import tune

    def trainable(config):
        for step in range(10):
            tune.report({"loss": config["lr"] * step})

    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.loguniform(1e-4, 1e-1)},
        tune_config=tune.TuneConfig(num_samples=8, metric="loss", mode="min"),
    )
    results = tuner.fit()
    best = results.get_best_result()

An experiment's storage defaults to ``$TMPDIR/ray_tpu_torch/tune/<name>_<id>``,
under the port's own root, never the JAX package's.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import uuid
from typing import Callable

from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401  (re-export)
from ray_tpu_torch.tune.controller import (  # noqa: F401
    ERRORED,
    STOPPED,
    TERMINATED,
    Trial,
    TuneController,
)
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (  # noqa: F401
    Searcher,
    TPESearcher,
    choice,
    generate_variants,
    grid_search,
    loguniform,
    quniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.session import get_checkpoint, report

__all__ = [
    "ASHAScheduler",
    "Searcher",
    "TPESearcher",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Result",
    "ResultGrid",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "quniform",
    "randint",
    "report",
    "uniform",
]


@dataclasses.dataclass
class TuneConfig:
    """(ref: tune/tune_config.py TuneConfig)"""

    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int | None = None
    scheduler: object | None = None
    search_alg: object | None = None  # a search.Searcher (e.g. TPESearcher)
    callbacks: list | None = None  # air.LoggerCallback instances
    seed: int | None = None
    max_failures_per_trial: int = 0


class Result:
    def __init__(self, trial: Trial):
        self.trial_id = trial.trial_id
        self.config = trial.config
        self.metrics = trial.metrics
        self.metrics_history = trial.history
        self.checkpoint = (
            Checkpoint(trial.checkpoint_path) if trial.checkpoint_path else None
        )
        self.error = trial.error
        self.status = trial.status

    def __repr__(self):
        return f"Result({self.trial_id}, status={self.status}, metrics={self.metrics})"


class ResultGrid:
    """(ref: tune/result_grid.py ResultGrid)"""

    def __init__(self, results: list[Result], metric: str | None, mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> list[Result]:
        return [r for r in self._results if r.error]

    def get_best_result(self, metric: str | None = None, mode: str | None = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("no metric given to get_best_result or TuneConfig")
        scored = [r for r in self._results if metric in (r.metrics or {})]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        rows = [
            {"trial_id": r.trial_id, **{f"config/{k}": v for k, v in r.config.items()},
             **(r.metrics or {})}
            for r in self._results
        ]
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:
            return rows


class Tuner:
    """(ref: tune/tuner.py:43; restore/resume is the experiment_state.json
    written by the controller)"""

    def __init__(self, trainable: Callable | object, *, param_space: dict | None = None,
                 tune_config: TuneConfig | None = None, run_config=None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config

    def fit(self) -> ResultGrid:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        tc = self.tune_config
        trainable, resources = _as_trainable(self.trainable)
        if tc.search_alg is not None:
            # suggest-driven: the controller creates trials on demand so
            # later suggestions observe earlier results (TPE semantics)
            variants = []
        else:
            variants = generate_variants(self.param_space, tc.num_samples,
                                         tc.seed)
            if not variants:
                variants = [{}]
        storage = name = None
        if self.run_config is not None:
            storage = getattr(self.run_config, "storage_path", None)
            name = getattr(self.run_config, "name", None)
        if storage is None:
            storage = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "tune",
                                   f"{name or 'exp'}_{uuid.uuid4().hex[:8]}")
        controller = TuneController(
            trainable,
            variants,
            scheduler=tc.scheduler,
            metric=tc.metric,
            mode=tc.mode,
            max_concurrent_trials=tc.max_concurrent_trials,
            resources_per_trial=resources,
            storage_path=storage,
            max_failures_per_trial=tc.max_failures_per_trial,
            trials=getattr(self, "_restored_trials", None),
            searcher=tc.search_alg,
            num_samples=tc.num_samples,
            callbacks=tc.callbacks,
        )
        trials = controller.run()
        return ResultGrid([Result(t) for t in trials], tc.metric, tc.mode)

    @classmethod
    def restore(cls, path: str, trainable: Callable | object,
                tune_config: TuneConfig | None = None) -> "Tuner":
        """Resume an interrupted experiment from its storage_path (ref:
        tune/tuner.py Tuner.restore + execution/experiment_state.py): the
        controller's periodic snapshots rebuild the trial table; finished
        trials keep their results, unfinished ones run again from their
        last checkpoint. Call .fit() on the returned Tuner to continue."""
        import types

        trials = TuneController.load_experiment_state(path)
        tuner = cls(trainable, tune_config=tune_config,
                    run_config=types.SimpleNamespace(storage_path=path,
                                                    name=None))
        tuner._restored_trials = trials
        return tuner


def _as_trainable(obj) -> tuple[Callable, dict]:
    """Accept a plain function(config) or a TorchTrainer (Tune-over-Train,
    ref: BaseTrainer.fit wrapping itself as a Trainable, base_trainer.py:808).
    A function's trial leases ``obj.trial_resources`` when it names them
    (an RL trainable that learns in its own process on the card), else
    one CPU."""
    from ray_tpu_torch.train.trainer import TorchTrainer

    if isinstance(obj, TorchTrainer):
        trainer = obj

        def trainable(config: dict):
            import copy
            import dataclasses as _dc
            import os as _os

            from ray_tpu_torch import tune
            from ray_tpu_torch.tune.session import get_session

            merged = dict(trainer.train_loop_config or {})
            merged.update(config.get("train_loop_config", config))
            # per-trial run name + storage subdir: concurrent trials must
            # not share checkpoint dirs (each fit's collective group is
            # named after its own temp run dir)
            trial_id = get_session().trial_id
            run_cfg = _dc.replace(trainer.run_config)
            run_cfg.name = f"{run_cfg.name or 'tune'}_{trial_id}"
            if run_cfg.storage_path:
                run_cfg.storage_path = _os.path.join(run_cfg.storage_path, trial_id)
            # the loop travels by name (the trainer holds its import path)
            t = copy.copy(trainer)
            t.train_loop_config = merged
            t.run_config = run_cfg
            result = t.fit()
            if result.error is not None:
                raise result.error
            tune.report(result.metrics, checkpoint=result.checkpoint)
            return result.metrics

        # the trial actor itself is light and holds no card; its nested
        # train workers carry the real resources
        return trainable, {"CPU": 0.5}
    return obj, dict(getattr(obj, "trial_resources", None) or {"CPU": 1.0})
