"""Replay buffers for off-policy RL.

A copy of ``ray_tpu/rllib/replay_buffer.py`` (numpy; the same
``default_rng(seed)`` draws, so both packages sample the same indices),
itself the counterpart of the reference buffer layer (ref:
rllib/utils/replay_buffers/replay_buffer.py ReplayBuffer,
prioritized_episode_buffer.py): preallocated numpy rings holding flat
transition batches; sampling returns contiguous arrays for one batched
update.
"""
from __future__ import annotations

import numpy as np


class ReplayBuffer:
    """Uniform ring buffer over flat transition arrays."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self._store: dict[str, np.ndarray] | None = None
        self._next = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: dict) -> None:
        """batch: {name: [N, ...]} transition arrays, all equal length."""
        n = len(next(iter(batch.values())))
        if self._store is None:
            self._store = {
                k: np.zeros((self.capacity,) + np.asarray(v).shape[1:],
                            dtype=np.asarray(v).dtype)
                for k, v in batch.items()
            }
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._store[k][idx] = np.asarray(v)
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        self._added_indices = idx  # for subclasses (priority init)

    def sample(self, batch_size: int) -> dict:
        idx = self._rng.integers(0, self._size, size=batch_size)
        out = {k: v[idx] for k, v in self._store.items()}
        out["indices"] = idx
        out["weights"] = np.ones(batch_size, dtype=np.float32)
        return out

    def update_priorities(self, indices, priorities) -> None:
        pass  # uniform: no-op (shared API with the prioritized variant)


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized sampling (ref:
    rllib/utils/replay_buffers/prioritized_replay_buffer.py): new
    transitions enter at max priority; sample probability ~ p^alpha with
    importance-sampling weights corrected by beta."""

    def __init__(self, capacity: int, alpha: float = 0.6, beta: float = 0.4,
                 seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._prios = np.zeros(capacity, dtype=np.float64)
        self._max_prio = 1.0

    def add_batch(self, batch: dict) -> None:
        super().add_batch(batch)
        self._prios[self._added_indices] = self._max_prio

    def sample(self, batch_size: int) -> dict:
        p = self._prios[: self._size] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(self._size, size=batch_size, p=p)
        out = {k: v[idx] for k, v in self._store.items()}
        w = (self._size * p[idx]) ** (-self.beta)
        out["indices"] = idx
        out["weights"] = (w / w.max()).astype(np.float32)
        return out

    def update_priorities(self, indices, priorities) -> None:
        priorities = np.abs(np.asarray(priorities, dtype=np.float64)) + 1e-6
        self._prios[np.asarray(indices)] = priorities
        self._max_prio = max(self._max_prio, float(priorities.max()))
