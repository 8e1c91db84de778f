"""Checkpoint: directory-of-files abstraction + top-K retention.

Counterpart of ``ray_tpu/train/checkpoint.py`` (Ray Train's Checkpoint and
CheckpointManager), with the same retention and scoring. ``from_dict``
writes ``state.pkl`` as host numpy through ``utils.serialization.to_host``
(bfloat16 as ``HostTensor`` bits), so a float32 checkpoint written by the
JAX package's ``Checkpoint.from_dict`` reads back through ``to_dict`` here.
``from_state_dict``/``to_state_dict`` carry tensor trees, a ``torch.optim``
state dict among them: an optimizer loaded from it resumes bit for bit.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

from ray_tpu_torch.utils.serialization import from_host, to_host


def _staging_dir() -> str | None:
    """Where a training worker writes new checkpoints (its run's staging
    directory); ``None`` outside a worker, for the system temp dir."""
    from ray_tpu_torch.train import session

    current = session.current()
    return current.staging_dir if current is not None else None


class Checkpoint:
    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        """Persist a tree (tensors become host numpy) as a checkpoint."""
        tmp = tempfile.mkdtemp(prefix="rt_ckpt_", dir=_staging_dir())
        with open(os.path.join(tmp, "state.pkl"), "wb") as f:
            pickle.dump(to_host(data), f, protocol=5)
        return cls(tmp)

    @classmethod
    def from_state_dict(cls, state: dict) -> "Checkpoint":
        """Persist a tree of tensors, e.g. ``{"params": ..., "opt":
        optimizer.state_dict(), "step": n}``; ``to_state_dict`` reads it."""
        return cls.from_dict(state)

    def to_dict(self) -> dict:
        """The stored tree in host form (numpy; bfloat16 as ``HostTensor``)."""
        with open(os.path.join(self.path, "state.pkl"), "rb") as f:
            return pickle.load(f)

    def to_state_dict(self, device) -> dict:
        """The stored tree with every array a tensor on ``device``."""
        return from_host(self.to_dict(), device)

    def as_directory(self) -> str:
        return self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"


class CheckpointManager:
    """Top-K retention on a storage path (Ray Train's checkpoint_manager)."""

    def __init__(self, storage_path: str, num_to_keep: int | None = None,
                 score_attribute: str | None = None, score_order: str = "max"):
        self.storage_path = storage_path
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self.checkpoints: list[tuple[float, str, dict]] = []  # (score, path, metrics)
        self._seq = 0  # monotonic: len(checkpoints) shrinks on evict and would collide
        os.makedirs(storage_path, exist_ok=True)

    def register(self, checkpoint: Checkpoint, metrics: dict, move: bool = False) -> Checkpoint:
        """Keep ``checkpoint`` under the storage path: a copy, or with
        ``move`` the directory itself (the trainer moves what its workers
        staged: a checkpoint may be many GB)."""
        self._seq += 1
        name = f"checkpoint_{int(time.time() * 1000)}_{self._seq:06d}"
        dest = os.path.join(self.storage_path, name)
        if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
            (shutil.move if move else shutil.copytree)(checkpoint.path, dest)
        score = self._score(metrics)
        self.checkpoints.append((score, dest, dict(metrics)))
        self._evict()
        return Checkpoint(dest)

    def _score(self, metrics: dict) -> float:
        if self.score_attribute and self.score_attribute in metrics:
            v = float(metrics[self.score_attribute])
            return v if self.score_order == "max" else -v
        return float(len(self.checkpoints))  # recency

    def _evict(self):
        if self.num_to_keep is None:
            return
        while len(self.checkpoints) > self.num_to_keep:
            self.checkpoints.sort(key=lambda t: t[0])
            score, path, _ = self.checkpoints.pop(0)
            shutil.rmtree(path, ignore_errors=True)

    def best(self) -> Checkpoint | None:
        if not self.checkpoints:
            return None
        return Checkpoint(max(self.checkpoints, key=lambda t: t[0])[1])

    def latest(self) -> Checkpoint | None:
        if not self.checkpoints:
            return None
        return Checkpoint(self.checkpoints[-1][1])
