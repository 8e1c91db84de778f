"""streaming_split: n coordinated consumers over one dataset execution.

Counterpart of ``ray_tpu/data/split.py``. One coordinator actor
(``num_cpus=0``) drives the streaming executor exactly once; each train
worker owns a DataIterator that pulls its round-robin share of whole
blocks. Blocks travel driver-free: task -> shm object store ->
coordinator -> consumer. The iterators carry the coordinator's handle, so
they can travel to TrainWorker actors inside ``train_loop_config``.
"""

from __future__ import annotations

import collections

import ray_tpu_torch


class SplitCoordinator:
    """Actor: runs the stream, deals blocks round-robin to n consumers.

    equal=True deals whole blocks round-robin (±1 block skew — the
    reference's row-exact equalization is an upgrade, not a behavior
    change); consumers signal epoch restarts via reset()."""

    def __init__(self, dataset, n: int, equal: bool = True):
        self._dataset = dataset
        self._n = n
        self._equal = equal
        self._start()

    def _start(self):
        self._stream = iter(self._dataset.iter_block_refs())
        self._queues = [collections.deque() for _ in range(self._n)]
        self._next_assign = 0
        self._exhausted = False

    def next(self, i: int):
        """Next block for consumer i, or None at end of stream."""
        q = self._queues[i]
        while not q and not self._exhausted:
            try:
                ref = next(self._stream)
            except StopIteration:
                self._exhausted = True
                break
            self._queues[self._next_assign].append(ref)
            self._next_assign = (self._next_assign + 1) % self._n
        if not q:
            return None
        return ray_tpu_torch.get(q.popleft())

    def reset(self):
        """Start a new epoch (re-executes the lazy plan)."""
        self._start()
        return True


def make_stream_splits(dataset, n: int, *, equal: bool = True) -> list:
    from ray_tpu_torch.data.iterator import DataIterator

    Coord = ray_tpu_torch.remote(SplitCoordinator).options(num_cpus=0)
    coord = Coord.remote(dataset, n, equal)

    def make_next(i):
        return lambda: ray_tpu_torch.get(coord.next.remote(i))

    iterators = []
    for i in range(n):
        it = DataIterator(make_next(i), name=f"split-{i}/{n}")
        it._coordinator = coord  # keep the actor alive with the iterators
        iterators.append(it)
    return iterators
