"""Per-trial session: tune.report / tune.get_checkpoint inside trainables.

Counterpart of ``ray_tpu/tune/session.py`` (ref:
python/ray/tune/trainable/function_trainable.py _StatusReporter,
tune/trainable/session.py), over the port's ``train.checkpoint.Checkpoint``.
One session per trial-actor process; the trainable's thread enqueues
reports that the driver-side controller drains via ``TrialActor.poll()``.
"""
from __future__ import annotations

import queue

from ray_tpu_torch.train.checkpoint import Checkpoint

_session = None


class TuneSession:
    def __init__(self, trial_id: str, config: dict, checkpoint: Checkpoint | None):
        self.trial_id = trial_id
        self.config = config
        self.checkpoint = checkpoint
        self.outbox: queue.Queue = queue.Queue()
        self.iteration = 0
        self.stop_requested = False


def init_session(trial_id: str, config: dict, checkpoint: Checkpoint | None) -> TuneSession:
    global _session
    _session = TuneSession(trial_id, config, checkpoint)
    return _session


def get_session() -> TuneSession:
    if _session is None:
        raise RuntimeError("tune.report called outside a Tune trial")
    return _session


class TrialStopped(Exception):
    """Raised inside the trainable when the scheduler stopped the trial."""


def report(metrics: dict, *, checkpoint: Checkpoint | None = None) -> None:
    """Report metrics (and optionally a checkpoint) to the controller
    (ref: tune session.report). training_iteration auto-increments if the
    trainable doesn't set it. Raises TrialStopped if the scheduler has
    decided to early-stop this trial."""
    s = get_session()
    s.iteration += 1
    metrics = dict(metrics)
    metrics.setdefault("training_iteration", s.iteration)
    s.outbox.put((metrics, checkpoint))
    if s.stop_requested:
        raise TrialStopped()


def get_checkpoint() -> Checkpoint | None:
    return get_session().checkpoint
