"""Experiment-tracking logger callbacks (wandb / mlflow).

A copy of ``ray_tpu/air/integrations.py``; the MLflow experiment defaults
to "ray_tpu_torch".

Ref: python/ray/air/integrations/wandb.py:371 WandbLoggerCallback,
python/ray/air/integrations/mlflow.py:158 MLflowLoggerCallback. Design
difference: the reference runs wandb logging in a separate actor per
trial; here callbacks run driver-side in the tune controller loop (the
controller already serializes trial reports, and the driver owns the
experiment credentials).
"""

from __future__ import annotations

from typing import Any


class LoggerCallback:
    """Tune controller callback surface (ref: tune/logger/logger.py
    LoggerCallback). Attach via ``TuneConfig(callbacks=[...])``."""

    def setup(self, experiment_name: str | None = None) -> None:
        pass

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        pass

    def on_trial_result(self, trial_id: str, metrics: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          metrics: dict | None) -> None:
        pass

    def on_experiment_end(self) -> None:
        pass


class WandbLoggerCallback(LoggerCallback):
    """Log every trial's reports as a wandb run (ref: wandb.py:371).

    One wandb run per trial (named by trial id, grouped by experiment),
    results via run.log, completion finalizes the run."""

    def __init__(self, project: str, *, group: str | None = None,
                 api_key: str | None = None, **wandb_init_kwargs: Any):
        try:
            import wandb  # noqa: F401
        except ImportError as e:  # pragma: no cover - env without wandb
            raise ImportError(
                "WandbLoggerCallback needs the `wandb` package; pip "
                "install wandb (and run `wandb login`)") from e
        self._wandb = __import__("wandb")
        if api_key:
            self._wandb.login(key=api_key)
        self.project = project
        self.group = group
        self.kwargs = wandb_init_kwargs
        self._runs: dict[str, Any] = {}

    def setup(self, experiment_name: str | None = None) -> None:
        if self.group is None:
            self.group = experiment_name

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        self._runs[trial_id] = self._wandb.init(
            project=self.project, group=self.group, name=trial_id,
            config=config, reinit=True, **self.kwargs)

    def on_trial_result(self, trial_id: str, metrics: dict) -> None:
        run = self._runs.get(trial_id)
        if run is not None:
            run.log({k: v for k, v in metrics.items()
                     if isinstance(v, (int, float))})

    def on_trial_complete(self, trial_id: str,
                          metrics: dict | None) -> None:
        run = self._runs.pop(trial_id, None)
        if run is not None:
            run.finish()

    def on_experiment_end(self) -> None:
        for run in self._runs.values():
            run.finish()
        self._runs.clear()


class MLflowLoggerCallback(LoggerCallback):
    """Log trials as MLflow runs (ref: mlflow.py:158): params once at
    start, metrics per report with a step counter, terminal status at
    completion."""

    def __init__(self, *, tracking_uri: str | None = None,
                 experiment_name: str | None = None,
                 tags: dict | None = None):
        try:
            import mlflow  # noqa: F401
        except ImportError as e:  # pragma: no cover - env without mlflow
            raise ImportError(
                "MLflowLoggerCallback needs the `mlflow` package") from e
        self._mlflow = __import__("mlflow")
        if tracking_uri:
            self._mlflow.set_tracking_uri(tracking_uri)
        self.experiment_name = experiment_name
        self.tags = tags or {}
        self._runs: dict[str, Any] = {}
        self._steps: dict[str, int] = {}

    def setup(self, experiment_name: str | None = None) -> None:
        name = self.experiment_name or experiment_name or "ray_tpu_torch"
        self._mlflow.set_experiment(name)

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        run = self._mlflow.start_run(run_name=trial_id, nested=False,
                                     tags=self.tags)
        self._runs[trial_id] = run
        self._steps[trial_id] = 0
        with self._active(run):
            self._mlflow.log_params(
                {k: v for k, v in config.items()
                 if isinstance(v, (int, float, str, bool))})

    def _active(self, run):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            # mlflow's fluent API is active-run-global; re-enter the
            # trial's run for each log call
            self._mlflow.end_run()
            with self._mlflow.start_run(run_id=run.info.run_id):
                yield

        return ctx()

    def on_trial_result(self, trial_id: str, metrics: dict) -> None:
        run = self._runs.get(trial_id)
        if run is None:
            return
        step = self._steps[trial_id] = self._steps.get(trial_id, 0) + 1
        with self._active(run):
            self._mlflow.log_metrics(
                {k: float(v) for k, v in metrics.items()
                 if isinstance(v, (int, float))}, step=step)

    def on_trial_complete(self, trial_id: str,
                          metrics: dict | None) -> None:
        run = self._runs.pop(trial_id, None)
        if run is not None:
            self._mlflow.end_run()

    def on_experiment_end(self) -> None:
        self._mlflow.end_run()
