"""An in-process dataset: ``from_items``, ``map_batches`` and ``take_all``.

Counterpart of the part of ``ray_tpu/data`` that batch inference rides on,
without its executor, actors or object store (they ride on the JAX
package's runtime). A dataset is a list of blocks held in this process; a
block is a list of rows or a dict of numpy columns. Batches reach the
mapped function in ``ray_tpu.data``'s numpy batch format
(``data/block.py`` ``to_batch``, ``rows_to_columns``): a dict of column
arrays built with ``np.asarray``, so a column of equal-length lists
arrives as one 2-D array and a ragged one raises as it does there.
``map_batches(batch_size=n)`` re-chunks first into ``ceil(rows / n)``
equal-ish blocks, as ``repartition_by_rows`` does (10 rows at n = 4 give
blocks of 4, 3 and 3). Transforms run when they are called.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

DEFAULT_BLOCK_ROWS = 1000


def rows_to_columns(rows: list[dict]) -> dict[str, np.ndarray]:
    if not rows:
        return {}
    keys = list(rows[0])
    return {k: np.asarray([r[k] for r in rows]) for k in keys}


def _num_rows(block) -> int:
    if isinstance(block, dict):
        return len(next(iter(block.values()))) if block else 0
    return len(block)


def _rows(block):
    if isinstance(block, dict):
        keys = list(block)
        for i in range(_num_rows(block)):
            yield {k: block[k][i] for k in keys}
    else:
        yield from block


def _slice(block, start: int, end: int):
    if isinstance(block, dict):
        return {k: v[start:end] for k, v in block.items()}
    return block[start:end]


def _concat(blocks: list):
    blocks = [b for b in blocks if _num_rows(b) > 0]
    if not blocks:
        return []
    if len(blocks) == 1:
        return blocks[0]
    if all(isinstance(b, dict) for b in blocks):
        return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
    return [r for b in blocks for r in _rows(b)]


def _normalize(batch):
    """A mapped function's output as a block: a dict of numpy columns, or a
    bare array as the column ``data``."""
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return {"data": batch}
    raise TypeError(f"cannot treat {type(batch)} as a block")


def to_batch(block):
    """A block in numpy batch format: a dict of column arrays for dict
    rows, else one array."""
    if isinstance(block, dict):
        return {k: np.asarray(v) for k, v in block.items()}
    if block and isinstance(block[0], dict):
        return rows_to_columns(block)
    return np.asarray(block)


class Dataset:
    def __init__(self, blocks: list):
        self._blocks = list(blocks)

    def count(self) -> int:
        return sum(_num_rows(b) for b in self._blocks)

    def repartition(self, num_blocks: int) -> "Dataset":
        """The rows in ``num_blocks`` blocks whose sizes differ by at most
        one, the larger first (``data/executor.py`` ``RepartitionOp``)."""
        total = self.count()
        if total == 0:
            return Dataset([])
        base, rem = divmod(total, num_blocks)
        sizes = [base + (1 if i < rem else 0) for i in range(num_blocks)]
        flat = _concat(self._blocks)
        out, pos = [], 0
        for size in sizes:
            if size:
                out.append(_slice(flat, pos, pos + size))
                pos += size
        return Dataset(out)

    def map_batches(self, fn: Callable, *, batch_size: int | None = None,
                    batch_format: str | None = "numpy") -> "Dataset":
        """Apply ``fn`` to every block in numpy batch format (the only one
        the port renders); ``batch_size`` re-chunks into
        ``ceil(rows / batch_size)`` blocks first."""
        if batch_format not in (None, "default", "numpy"):
            raise ValueError(f"unsupported batch_format {batch_format!r}")
        ds = self
        if batch_size is not None:
            ds = ds.repartition(max(1, -(-self.count() // batch_size)))
        return Dataset([_normalize(fn(to_batch(b))) for b in ds._blocks])

    def take_all(self) -> list:
        return [r for b in self._blocks for r in _rows(b)]


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    """A dataset of ``items`` (one row each) in ``parallelism`` blocks
    (default: one block per 1000 rows, at most 8)."""
    items = list(items)
    if parallelism <= 0:
        parallelism = max(1, min(8, len(items) // DEFAULT_BLOCK_ROWS or 1))
    chunks = np.array_split(np.arange(len(items)), parallelism)
    return Dataset([[items[i] for i in c] for c in chunks if len(c)])

