"""Per-worker training session (counterpart of ``ray_tpu/train/session.py``:
``report``, ``get_checkpoint``, ``get_context`` live here).

A worker actor (``train/worker.py``'s ``TrainWorker``) opens one session.
Its reports wait in the session's outbox, a queue of ``(metrics,
checkpoint)`` pairs that the controller (``TorchTrainer``) drains through
the actor's ``poll``, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import queue

import torch

from ray_tpu_torch.train.checkpoint import Checkpoint

_session: "TrainSession | None" = None


@dataclasses.dataclass
class TrainContext:
    world_rank: int
    world_size: int
    local_rank: int
    trial_name: str
    collective_group: str

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank


class TrainSession:
    def __init__(self, context: TrainContext, checkpoint: Checkpoint | None,
                 staging_dir: str, device: torch.device):
        self.context = context
        self.starting_checkpoint = checkpoint
        #: where ``Checkpoint.from_dict`` writes inside this worker
        self.staging_dir = staging_dir
        self.device = device
        self.reports: list[dict] = []
        #: (metrics, checkpoint) pairs drained by the controller's poll
        self.outbox: queue.Queue = queue.Queue()

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None):
        self.reports.append(metrics)
        self.outbox.put((dict(metrics), checkpoint))


def init_session(context: TrainContext, checkpoint: Checkpoint | None, staging_dir: str,
                 device: torch.device) -> TrainSession:
    global _session
    _session = TrainSession(context, checkpoint, staging_dir, device)
    return _session


def current() -> TrainSession | None:
    """This process's session, or ``None`` outside a training worker."""
    return _session


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError("not inside a ray_tpu_torch.train worker")
    return _session


def get_context() -> TrainContext:
    return get_session().context


def get_device() -> torch.device:
    """The device this worker trains on: its card, or the CPU."""
    return get_session().device


def report(metrics: dict, checkpoint: Checkpoint | None = None) -> None:
    """Report metrics (+ optional checkpoint) to the trainer controller."""
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Checkpoint | None:
    return get_session().starting_checkpoint
