"""Block model: the unit of data that flows through the streaming executor.

Counterpart of ``ray_tpu/data/block.py``, with the same layouts and the
same rendering:

  - pyarrow.Table:          canonical tabular block (zero-copy numpy column
                            views, O(1) slice); multi-dim columns ride
                            Arrow's FixedShapeTensorArray
  - dict[str, np.ndarray]:  columnar block for what Arrow cannot hold, and
                            every tabular block where pyarrow is not
                            installed
  - list:                   simple row path

pandas and pyarrow are imported lazily, when a block needs them: a host
without them (the card's) keeps tabular blocks as numpy dicts, and the
"numpy" batch format renders them as JAX's does. Batches feed
``torch.from_numpy`` without row pivots.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np


def _pa():
    """pyarrow, or None where it is not installed."""
    try:
        import pyarrow as pa
    except ImportError:
        return None
    return pa


def _is_table(block) -> bool:
    try:
        import pyarrow as pa
    except ImportError:  # pragma: no cover
        return False
    return isinstance(block, pa.Table)


def _is_tabular(block) -> bool:
    return isinstance(block, dict) or _is_table(block)


def columns_to_table(cols: dict):
    """numpy-dict -> pa.Table, or None when Arrow can't hold a column
    (object arrays of arbitrary Python values). Multi-dim columns become
    FixedShapeTensorArrays (ref: _internal/arrow_block.py tensor
    extension). None too where pyarrow is not installed."""
    pa = _pa()
    if pa is None:
        return None
    arrays = {}
    for k, v in cols.items():
        v = np.asarray(v)
        try:
            if v.ndim > 1:
                flat = np.ascontiguousarray(v)
                arrays[k] = pa.FixedShapeTensorArray.from_numpy_ndarray(flat)
            else:
                arr = pa.array(v)
                if pa.types.is_null(arr.type) and len(arr):
                    return None  # all-None object column: keep numpy
                arrays[k] = arr
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError,
                ValueError, TypeError):
            return None
    return pa.table(arrays)


def _col_to_numpy(chunked) -> np.ndarray:
    """One column -> numpy, zero-copy where the layout allows."""
    pa = _pa()
    arr = chunked.combine_chunks() if hasattr(chunked, "combine_chunks") \
        else chunked
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.chunk(0) if arr.num_chunks == 1 else pa.concat_arrays(
            arr.chunks)
    if isinstance(arr.type, pa.FixedShapeTensorType):
        return arr.to_numpy_ndarray()
    try:
        return arr.to_numpy(zero_copy_only=True)
    except pa.ArrowInvalid:
        return arr.to_numpy(zero_copy_only=False)


class BlockAccessor:
    """Uniform view over a block (ref: block.py BlockAccessor.for_block)."""

    def __init__(self, block):
        self.block = block

    @staticmethod
    def for_block(block) -> "BlockAccessor":
        return BlockAccessor(normalize_block(block))

    # ------------------------------------------------------------- basics
    def is_tabular(self) -> bool:
        return _is_tabular(self.block)

    def num_rows(self) -> int:
        if _is_table(self.block):
            return self.block.num_rows
        if isinstance(self.block, dict):
            if not self.block:
                return 0
            return len(next(iter(self.block.values())))
        return len(self.block)

    def size_bytes(self) -> int:
        if _is_table(self.block):
            return int(self.block.nbytes)
        if isinstance(self.block, dict):
            return int(sum(np.asarray(v).nbytes for v in self.block.values()))
        total = 0
        for row in self.block[:10]:
            total += _rough_size(row)
        n = len(self.block)
        return (total // max(1, min(10, n))) * n if n else 0

    def schema(self):
        if _is_table(self.block):
            return {name: self.block.schema.field(name).type
                    for name in self.block.column_names}
        if isinstance(self.block, dict):
            return {k: np.asarray(v).dtype for k, v in self.block.items()}
        if self.block:
            first = self.block[0]
            if isinstance(first, dict):
                return {k: type(v).__name__ for k, v in first.items()}
            return type(first).__name__
        return None

    # ------------------------------------------------------------ columnar
    def column_names(self) -> list[str]:
        if _is_table(self.block):
            return list(self.block.column_names)
        if isinstance(self.block, dict):
            return list(self.block)
        raise TypeError("row blocks have no columns")

    def columns(self) -> dict[str, np.ndarray]:
        """Tabular block -> numpy column dict (zero-copy views where the
        Arrow layout allows)."""
        if _is_table(self.block):
            return {name: _col_to_numpy(self.block[name])
                    for name in self.block.column_names}
        if isinstance(self.block, dict):
            return {k: np.asarray(v) for k, v in self.block.items()}
        raise TypeError("row blocks have no columns")

    def column(self, name: str) -> np.ndarray:
        if _is_table(self.block):
            return _col_to_numpy(self.block[name])
        if isinstance(self.block, dict):
            return np.asarray(self.block[name])
        raise TypeError("row blocks have no columns")

    def take(self, indices) -> Any:
        """Row-select by integer indices, preserving block kind."""
        indices = np.asarray(indices)
        if _is_table(self.block):
            return self.block.take(_pa().array(indices))
        if isinstance(self.block, dict):
            return {k: np.asarray(v)[indices] for k, v in self.block.items()}
        return [self.block[int(i)] for i in indices]

    def mask(self, m) -> Any:
        m = np.asarray(m, dtype=bool)
        if _is_table(self.block):
            return self.block.filter(_pa().array(m))
        if isinstance(self.block, dict):
            return {k: np.asarray(v)[m] for k, v in self.block.items()}
        return [r for r, keep in zip(self.block, m) if keep]

    # -------------------------------------------------------------- slices
    def slice(self, start: int, end: int):
        if _is_table(self.block):
            return self.block.slice(start, end - start)  # zero-copy
        if isinstance(self.block, dict):
            return {k: v[start:end] for k, v in self.block.items()}
        return self.block[start:end]

    def rows(self) -> Iterable[Any]:
        if _is_table(self.block):
            cols = self.columns()
            keys = list(cols)
            for i in range(self.block.num_rows):
                yield {k: cols[k][i] for k in keys}
        elif isinstance(self.block, dict):
            keys = list(self.block)
            for i in range(self.num_rows()):
                yield {k: self.block[k][i] for k in keys}
        else:
            yield from self.block

    # ------------------------------------------------------------- formats
    def to_batch(self, batch_format: str | None):
        """Render this block in the requested format
        (ref: data iter_batches batch_format semantics)."""
        if batch_format in (None, "default", "numpy"):
            if _is_tabular(self.block):
                return self.columns()
            if self.block and isinstance(self.block[0], dict):
                return rows_to_columns(self.block)
            return np.asarray(self.block)
        if batch_format == "rows":
            return list(self.rows())
        if batch_format == "pandas":
            import pandas as pd

            if _is_table(self.block):
                try:
                    return self.block.to_pandas()
                except Exception:
                    return pd.DataFrame(self.columns())
            if isinstance(self.block, dict):
                return pd.DataFrame(
                    {k: np.asarray(v) for k, v in self.block.items()})
            return pd.DataFrame(list(self.rows()))
        if batch_format == "pyarrow":
            import pyarrow as pa

            if _is_table(self.block):
                return self.block
            if isinstance(self.block, dict):
                t = columns_to_table(self.block)
                if t is None:
                    raise ValueError(
                        "block columns cannot be represented in Arrow")
                return t
            return pa.Table.from_pylist(list(self.rows()))
        raise ValueError(f"unknown batch_format {batch_format!r}")

    # ---------------------------------------------------------------- ops
    @staticmethod
    def concat(blocks: list) -> Any:
        blocks = [normalize_block(b) for b in blocks]
        blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
        if not blocks:
            return []
        if all(_is_table(b) for b in blocks):
            import pyarrow as pa

            try:
                return pa.concat_tables(blocks, promote_options="default")
            except (pa.ArrowException, TypeError):
                pass  # schema drift: fall through to columnar concat
        if all(_is_tabular(b) for b in blocks):
            cols = [BlockAccessor(b).columns() for b in blocks]
            keys = list(cols[0])
            merged = {k: np.concatenate([c[k] for c in cols]) for k in keys}
            t = columns_to_table(merged)
            return t if t is not None else merged
        out: list = []
        for b in blocks:
            out.extend(BlockAccessor(b).rows())
        return out


def normalize_block(batch) -> Any:
    """Accept user/edge formats; canonicalize tabular data to pa.Table
    (numpy-dict when Arrow can't hold a column), rows stay a list."""
    if batch is None:
        return []
    if _is_table(batch):
        return batch
    cols = None
    try:
        import pandas as pd

        if isinstance(batch, pd.DataFrame):
            cols = {c: batch[c].to_numpy() for c in batch.columns}
    except ImportError:  # pragma: no cover
        pass
    if cols is None:
        if isinstance(batch, dict):
            cols = {k: np.asarray(v) for k, v in batch.items()}
        elif isinstance(batch, np.ndarray):
            cols = {"data": batch}
        elif isinstance(batch, (list, tuple)):
            return list(batch)
        else:
            raise TypeError(f"cannot treat {type(batch)} as a block")
    t = columns_to_table(cols)
    return t if t is not None else cols


def rows_to_columns(rows: list[dict]) -> dict[str, np.ndarray]:
    if not rows:
        return {}
    keys = list(rows[0])
    return {k: np.asarray([r[k] for r in rows]) for k in keys}


def _rough_size(obj) -> int:
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_rough_size(v) for v in obj.values()) + 64
    if isinstance(obj, (bytes, str)):
        return len(obj)
    return 32
