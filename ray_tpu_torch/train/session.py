"""Per-worker training session (counterpart of ``ray_tpu/train/session.py``:
``report``, ``get_checkpoint``, ``get_context`` live here).

A worker process (``train/worker.py``) opens one session. Its reports leave
the process on a ``Channel``: an append-only file of length-prefixed
pickled frames that the controller (``TorchTrainer``) reads as they come.
A frame is ``("report", metrics, checkpoint path or None)``,
``("done", result)`` or ``("error", traceback text)``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import struct

import torch

from ray_tpu_torch.train.checkpoint import Checkpoint

_LEN = struct.Struct("<Q")
_session: "TrainSession | None" = None


class Channel:
    """Frames in one file: the worker appends, the controller reads."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0

    def put(self, frame) -> None:
        data = pickle.dumps(frame, protocol=5)
        with open(self.path, "ab") as f:
            f.write(_LEN.pack(len(data)) + data)
            f.flush()
            os.fsync(f.fileno())

    def read(self) -> list:
        """The frames written since the last read; a frame still being
        written waits for the next read."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            buf = f.read()
        out, pos = [], 0
        while pos + _LEN.size <= len(buf):
            (n,) = _LEN.unpack_from(buf, pos)
            if pos + _LEN.size + n > len(buf):
                break
            out.append(pickle.loads(buf[pos + _LEN.size:pos + _LEN.size + n]))
            pos += _LEN.size + n
        self._offset += pos
        return out


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
                 channel: Channel, staging_dir: str, device: torch.device):
        self.context = context
        self.starting_checkpoint = checkpoint
        self.channel = channel
        #: where ``Checkpoint.from_dict`` writes inside this worker
        self.staging_dir = staging_dir
        self.device = device
        self.reports: list[dict] = []

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None):
        self.reports.append(metrics)
        self.channel.put(("report", dict(metrics), checkpoint.path if checkpoint else None))


def init_session(context: TrainContext, checkpoint: Checkpoint | None, channel: Channel,
                 staging_dir: str, device: torch.device) -> TrainSession:
    global _session
    _session = TrainSession(context, checkpoint, channel, staging_dir, device)
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
