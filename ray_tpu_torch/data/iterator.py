"""Batch iteration over a stream of block refs with prefetch.

Counterpart of ``ray_tpu/data/iterator.py``. Keeps ``prefetch`` block
fetches in flight while the consumer works, so a training loop's host
reads overlap its steps on the card.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor


def iter_batches_over_refs(refs: Iterable, *, batch_size: int,
                           batch_format: str | None, drop_last: bool,
                           prefetch: int = 2) -> Iterator:
    spare = None  # leftover rows as a block
    for block in _prefetched_blocks(refs, prefetch):
        if spare is not None:
            block = BlockAccessor.concat([spare, block])
            spare = None
        acc = BlockAccessor.for_block(block)
        n = acc.num_rows()
        pos = 0
        while n - pos >= batch_size:
            yield BlockAccessor.for_block(
                acc.slice(pos, pos + batch_size)
            ).to_batch(batch_format)
            pos += batch_size
        if pos < n:
            spare = acc.slice(pos, n)
    if spare is not None and not drop_last:
        acc = BlockAccessor.for_block(spare)
        if acc.num_rows():
            yield acc.to_batch(batch_format)


def _prefetched_blocks(refs: Iterable, prefetch: int):
    window: collections.deque = collections.deque()
    it = iter(refs)
    try:
        for _ in range(max(1, prefetch)):
            window.append(next(it))
    except StopIteration:
        pass
    while window:
        block = ray_tpu_torch.get(window.popleft())
        try:
            window.append(next(it))
        except StopIteration:
            pass
        yield block


class DataIterator:
    """One consumer's view of a streaming_split (ref: DataIterator API)."""

    def __init__(self, next_block_fn, name: str = "split"):
        self._next_block = next_block_fn
        self._name = name

    def _blocks(self):
        while True:
            block = self._next_block()
            if block is None:
                return
            yield block

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str | None = "numpy",
                     drop_last: bool = False):
        spare = None
        for block in self._blocks():
            if spare is not None:
                block = BlockAccessor.concat([spare, block])
                spare = None
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            pos = 0
            while n - pos >= batch_size:
                yield BlockAccessor.for_block(
                    acc.slice(pos, pos + batch_size)
                ).to_batch(batch_format)
                pos += batch_size
            if pos < n:
                spare = acc.slice(pos, n)
        if spare is not None and not drop_last:
            acc = BlockAccessor.for_block(spare)
            if acc.num_rows():
                yield acc.to_batch(batch_format)

    def iter_rows(self):
        for block in self._blocks():
            yield from BlockAccessor.for_block(block).rows()

    def __repr__(self):
        return f"DataIterator({self._name})"
