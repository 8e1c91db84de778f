"""Dataset: lazy, streaming, task-parallel datasets.

Counterpart of ``ray_tpu/data/dataset.py`` on the port's task/actor
runtime: the same API, the same plans and the same rows. Every transform
is lazy — consumption drives the streaming executor (executor.py), which
keeps a bounded number of block tasks in flight on the runtime's workers.

The training endpoints are ``iter_batches(batch_format="numpy")`` (host
columns -> ``torch.from_numpy`` -> the card) and ``streaming_split(n)``
(one coordinator actor feeding n TorchTrainer workers).
"""

from __future__ import annotations

import builtins
import functools
import itertools
from typing import Any, Callable, Iterable

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, normalize_block, rows_to_columns
from ray_tpu_torch.data.executor import (
    LimitOp,
    MapBlocks,
    Plan,
    RepartitionOp,
    ShuffleOp,
    SortOp,
)

DEFAULT_BLOCK_ROWS = 1000


class ActorPoolStrategy:
    """compute= strategy for map_batches: a fixed pool of stateful map
    actors (ref: ActorPoolStrategy in python/ray/data/_internal/compute.py
    — the autoscaling min/max pool collapses to a fixed size here)."""

    def __init__(self, size: int = 2, *,
                 max_tasks_in_flight_per_actor: int = 2):
        if size < 1:
            raise ValueError("ActorPoolStrategy size must be >= 1")
        self.size = size
        self.max_tasks_in_flight_per_actor = max_tasks_in_flight_per_actor


class Dataset:
    def __init__(self, plan: Plan):
        self._plan = plan

    # ---------------------------------------------------------- transforms
    def map_batches(self, fn: Callable, *, batch_size: int | None = None,
                    batch_format: str | None = "numpy",
                    fn_kwargs: dict | None = None,
                    compute=None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: dict | None = None,
                    num_cpus: float = 1.0,
                    num_gpus: float | None = None) -> "Dataset":
        """Apply fn to whole blocks rendered as ``batch_format``
        (ref: dataset.py map_batches). batch_size re-chunks first when
        given. ``compute=ActorPoolStrategy(size=N)`` (or a callable CLASS
        as fn) runs the map on a pool of stateful actors — construct the
        class once per actor and amortize model loads across blocks
        (ref: actor_pool_map_operator.py). ``num_gpus``: the cards each
        map task or actor leases from the runtime, which then runs no
        more of them at once than its cards hold."""
        kwargs = fn_kwargs or {}
        ds = self
        if batch_size is not None:
            ds = ds.repartition_by_rows(batch_size)
        if compute is not None or isinstance(fn, type):
            from ray_tpu_torch.data.executor import ActorPoolMapBlocks

            strategy = compute or ActorPoolStrategy()
            if isinstance(fn, type):
                cls = fn

                class _Callable(cls):  # render batches + kwargs inside
                    def __call__(self, block, _k=kwargs, _bf=batch_format):
                        batch = BlockAccessor.for_block(block).to_batch(_bf)
                        return super().__call__(batch, **_k)

                target = _Callable
            else:
                def target(block, _fn=fn, _k=kwargs, _bf=batch_format):
                    batch = BlockAccessor.for_block(block).to_batch(_bf)
                    return _fn(batch, **_k) if _k else _fn(batch)
            return Dataset(ds._plan.with_op(ActorPoolMapBlocks(
                "map_batches(actors)", target,
                size=strategy.size,
                max_tasks_per_actor=strategy.max_tasks_in_flight_per_actor,
                fn_constructor_args=fn_constructor_args,
                fn_constructor_kwargs=fn_constructor_kwargs,
                num_cpus=num_cpus, num_gpus=num_gpus)))

        def apply(block):
            batch = BlockAccessor.for_block(block).to_batch(batch_format)
            return fn(batch, **kwargs) if kwargs else fn(batch)

        return Dataset(ds._plan.with_op(MapBlocks("map_batches", apply,
                                                  num_gpus=num_gpus)))

    def map(self, fn: Callable) -> "Dataset":
        def apply(block):
            rows = [fn(r) for r in BlockAccessor.for_block(block).rows()]
            return rows_to_columns(rows) if rows and isinstance(rows[0], dict) else rows

        return Dataset(self._plan.with_op(
            MapBlocks("map", apply, preserves_rows=True)))

    def flat_map(self, fn: Callable) -> "Dataset":
        def apply(block):
            rows = [o for r in BlockAccessor.for_block(block).rows() for o in fn(r)]
            return rows_to_columns(rows) if rows and isinstance(rows[0], dict) else rows

        return Dataset(self._plan.with_op(MapBlocks("flat_map", apply)))

    def filter(self, fn: Callable) -> "Dataset":
        def apply(block):
            acc = BlockAccessor.for_block(block)
            if acc.is_tabular():
                mask = np.asarray([bool(fn(r)) for r in acc.rows()])
                return acc.mask(mask)
            return [r for r in acc.block if fn(r)]

        return Dataset(self._plan.with_op(MapBlocks("filter", apply)))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def apply(batch):
            batch[name] = fn(batch)
            return batch

        return self.map_batches(apply, batch_format="numpy")

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self.map_batches(
            lambda b: {k: v for k, v in
                       BlockAccessor.for_block(b).columns().items()
                       if k not in set(cols)},
            batch_format="numpy",
        )

    def select_columns(self, cols: list[str]) -> "Dataset":
        cols = list(cols)

        def apply(block):
            batch = BlockAccessor.for_block(block).to_batch("numpy")
            return {k: batch[k] for k in cols}

        op = MapBlocks("select_columns", apply, preserves_rows=True)
        # optimizer hook: as the first op over parquet reads this becomes
        # a column projection on the read itself (optimizer.py
        # projection_pushdown)
        op.projected_columns = cols
        return Dataset(self._plan.with_op(op))

    def explain(self) -> str:
        """Logical vs optimized physical op chain (ref: Dataset.explain)."""
        from ray_tpu_torch.data.optimizer import explain

        return explain(self._plan)

    def limit(self, n: int) -> "Dataset":
        return Dataset(self._plan.with_op(LimitOp(n)))

    def repartition(self, num_blocks: int) -> "Dataset":
        return Dataset(self._plan.with_op(RepartitionOp(num_blocks)))

    def repartition_by_rows(self, rows_per_block: int) -> "Dataset":
        """Helper used by map_batches(batch_size=...): barrier + resize."""
        total = self.count()
        blocks = max(1, -(-total // rows_per_block))
        return self.repartition(blocks)

    def random_shuffle(self, *, seed: int | None = None) -> "Dataset":
        return Dataset(self._plan.with_op(ShuffleOp(seed)))

    def sort(self, key=None, descending: bool = False) -> "Dataset":
        return Dataset(self._plan.with_op(SortOp(key, descending)))

    def groupby(self, key: str) -> "GroupedDataset":
        """Group rows by a key column (ref: dataset.py groupby ->
        grouped_data.py; hash-aggregated map-side partials + one merge)."""
        return GroupedDataset(self, key)

    def join(self, other: "Dataset", on: str, *, how: str = "inner",
             suffix: str = "_r", num_partitions: int | None = None,
             ) -> "Dataset":
        """Distributed hash join on a key column (ref:
        _internal/execution/operators/join.py:28 JoinOperator +
        hash_shuffle.py): both sides hash-partition their blocks by key
        (map side, one task per block), then each partition builds a hash
        table from its left rows and probes the right rows (one task per
        partition). Output columns: the key, left columns, right columns
        (name collisions on the right take ``suffix``).

        how: "inner" | "left" | "right" | "outer". Missing sides of
        outer rows are null-filled (Arrow take-with-null semantics).
        """
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"unknown join how={how!r}")
        left_refs = list(self.iter_block_refs())
        right_refs = list(other.iter_block_refs())
        P = num_partitions or builtins.min(
            16, builtins.max(len(left_refs), len(right_refs), 1))

        @ray_tpu_torch.remote(num_returns=P)
        def shard(block):
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            if n == 0:
                empty = acc.slice(0, 0)
                return tuple(empty for _ in builtins.range(P)) \
                    if P > 1 else empty
            keys = acc.column(on) if acc.is_tabular() \
                else [r[on] for r in acc.rows()]
            part = np.array([_key_shard(k, P) for k in keys])
            outs = tuple(acc.take(np.nonzero(part == p)[0])
                         for p in builtins.range(P))
            return outs if P > 1 else outs[0]

        @ray_tpu_torch.remote
        def join_partition(n_left, *parts):
            return _hash_join_blocks(
                list(parts[:n_left]), list(parts[n_left:]), on, how, suffix)

        lsh = [shard.remote(r) for r in left_refs]
        rsh = [shard.remote(r) for r in right_refs]

        def col(shards, p):
            if P == 1:
                return list(shards)
            return [s[p] for s in shards]

        out_refs = [
            join_partition.remote(
                len(lsh), *col(lsh, p), *col(rsh, p))
            for p in builtins.range(P)
        ]
        # hand the partition refs straight to the plan (NO remote re-fetch
        # hop: a read task get()ing a ref would hold the only lease on a
        # 1-CPU node while the join tasks it waits on need one)
        from ray_tpu_torch.data.executor import InjectRefs

        return Dataset(Plan([], (InjectRefs("join", out_refs),)))

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two datasets with equal row counts (ref:
        dataset.py zip; right-side name collisions take a ``_1`` suffix).
        A barrier over REFS only: right blocks are sliced to the left's
        block boundaries and each aligned pair zips in its own task —
        the driver never materializes a row."""
        from ray_tpu_torch.data.executor import (InjectRefs, _count_rows,
                                           _slice_block)

        left_refs = list(self.iter_block_refs())
        right_refs = list(other.iter_block_refs())
        lcounts = ray_tpu_torch.get([_count_rows.remote(r) for r in left_refs])
        rcounts = ray_tpu_torch.get([_count_rows.remote(r) for r in right_refs])
        if sum(lcounts) != sum(rcounts):
            raise ValueError(
                f"zip requires equal row counts: "
                f"{sum(lcounts)} vs {sum(rcounts)}")

        @ray_tpu_torch.remote
        def zip_blocks(lblock, *rparts):
            lacc = BlockAccessor.for_block(lblock)
            racc = BlockAccessor.for_block(BlockAccessor.concat(list(rparts)))
            out = []
            for lr, rr in builtins.zip(lacc.rows(), racc.rows()):
                row = dict(lr)
                for k, v in rr.items():
                    row[k + "_1" if k in row else k] = v
                out.append(row)
            return rows_to_columns(out) if out else []

        # walk right blocks, carving each left block's row range
        out_refs = []
        ri = 0       # current right block
        roff = 0     # rows of right block ri already consumed
        for lref, need in builtins.zip(left_refs, lcounts):
            parts = []
            remaining = need
            while remaining > 0:
                avail = rcounts[ri] - roff
                take = builtins.min(avail, remaining)
                if take == rcounts[ri] and roff == 0:
                    parts.append(right_refs[ri])
                else:
                    parts.append(_slice_block.remote(
                        right_refs[ri], roff, roff + take))
                roff += take
                remaining -= take
                if roff == rcounts[ri]:
                    ri += 1
                    roff = 0
            out_refs.append(zip_blocks.remote(lref, *parts))
        return Dataset(Plan([], (InjectRefs("zip", out_refs),)))

    def unique(self, column: str) -> list:
        """Distinct values of one column (ref: dataset.py unique) —
        per-block set on the workers, one merge here."""
        @ray_tpu_torch.remote
        def block_unique(block):
            acc = BlockAccessor.for_block(block)
            if acc.is_tabular():
                return set(np.unique(acc.column(column)).tolist())
            return {r[column] for r in acc.rows()}

        sets = ray_tpu_torch.get(
            [block_unique.remote(r) for r in self.iter_block_refs()])
        out: set = set()
        for s in sets:
            out |= s
        return sorted(out, key=str)

    def random_sample(self, fraction: float, *, seed: int | None = None
                      ) -> "Dataset":
        """Bernoulli row sample (ref: dataset.py random_sample)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")

        def apply(block, index, _f=fraction, _s=seed):
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            # per-block seed from the STREAM INDEX: deterministic under a
            # fixed seed, and distinct across blocks even when their row
            # counts are identical (equal-sized blocks would otherwise
            # draw identical masks — a correlated, biased sample)
            rs = np.random.RandomState(
                None if _s is None else (_s * 7919 + index) % (2**31))
            return acc.take(np.nonzero(rs.random_sample(n) < _f)[0])

        return Dataset(self._plan.with_op(
            MapBlocks("random_sample", apply, indexed=True)))

    def columns(self) -> list[str] | None:
        """Column names of the first non-empty block (ref: Dataset.columns);
        None for non-record datasets (plain item lists)."""
        for block in self.iter_blocks():
            acc = BlockAccessor.for_block(block)
            if acc.num_rows():
                if acc.is_tabular():
                    return list(acc.column_names())
                first = next(iter(acc.rows()))
                return list(first) if isinstance(first, dict) else None
        return None

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            print(row)

    def union(self, other: "Dataset") -> "Dataset":
        if self._plan.ops or other._plan.ops:
            # materialize both sides into read tasks
            left = self.materialize()
            right = other.materialize()
            return Dataset(Plan(left._plan.read_tasks + right._plan.read_tasks))
        return Dataset(Plan(self._plan.read_tasks + other._plan.read_tasks))

    # ---------------------------------------------------------- execution
    def iter_block_refs(self) -> Iterable:
        stream, self._last_stats = self._plan.execute()
        return stream

    def iter_blocks(self) -> Iterable:
        # streaming by design: one materialised block in memory at a time;
        # batching the gets would buffer the whole dataset
        for ref in self.iter_block_refs():
            yield ray_tpu_torch.get(ref)  # raylint: disable=RT002

    def materialize(self) -> "Dataset":
        """Execute now; the result holds its blocks (ref: MaterializedDataset)."""
        blocks = list(self.iter_blocks())
        return Dataset(Plan([_HoldBlock(b) for b in blocks]))

    def stats(self) -> str:
        st = getattr(self, "_last_stats", None)
        if not st:
            return "(not executed yet)"
        return "\n".join(s.row() for s in st)

    # --------------------------------------------------------- consumption
    def take(self, n: int = 20) -> list:
        out: list = []
        for block in self.limit(n).iter_blocks():
            out.extend(BlockAccessor.for_block(block).rows())
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> list:
        out: list = []
        for block in self.iter_blocks():
            out.extend(BlockAccessor.for_block(block).rows())
        return out

    def count(self) -> int:
        return sum(
            BlockAccessor.for_block(b).num_rows() for b in self.iter_blocks()
        )

    def schema(self):
        for block in self.iter_blocks():
            acc = BlockAccessor.for_block(block)
            if acc.num_rows():
                return acc.schema()
        return None

    def _column_agg(self, on: str | None, agg: Callable):
        vals: list = []
        for block in self.iter_blocks():
            acc = BlockAccessor.for_block(block)
            if acc.is_tabular():
                col = on or acc.column_names()[0]
                if acc.num_rows():
                    vals.append(acc.column(col))
            else:
                rows = [r[on] if on else r for r in acc.rows()]
                if rows:
                    vals.append(np.asarray(rows))
        if not vals:
            return None
        return agg(np.concatenate(vals))

    def sum(self, on: str | None = None):
        v = self._column_agg(on, np.sum)
        return None if v is None else v.item()

    def min(self, on: str | None = None):
        v = self._column_agg(on, np.min)
        return None if v is None else v.item()

    def max(self, on: str | None = None):
        v = self._column_agg(on, np.max)
        return None if v is None else v.item()

    def mean(self, on: str | None = None):
        v = self._column_agg(on, np.mean)
        return None if v is None else v.item()

    def iter_rows(self) -> Iterable:
        for block in self.iter_blocks():
            yield from BlockAccessor.for_block(block).rows()

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str | None = "numpy",
                     drop_last: bool = False, prefetch_blocks: int = 2):
        from ray_tpu_torch.data.iterator import iter_batches_over_refs

        return iter_batches_over_refs(
            self.iter_block_refs(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
            prefetch=prefetch_blocks,
        )

    def iter_torch_batches(self, *, batch_size: int = 256, drop_last=False):
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            if isinstance(batch, dict):
                yield {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in batch.items()}
            else:
                yield torch.as_tensor(np.ascontiguousarray(batch))

    # ----------------------------------------------------------- splitting
    def split(self, n: int) -> list["Dataset"]:
        """Materialized equal split (ref: dataset.py split)."""
        parts = self.repartition(n).materialize()
        tasks = parts._plan.read_tasks
        per = max(1, len(tasks) // n)
        out = []
        for i in range(n):
            chunk = tasks[i * per: (i + 1) * per] if i < n - 1 else tasks[(n - 1) * per:]
            out.append(Dataset(Plan(list(chunk))))
        return out

    def streaming_split(self, n: int, *, equal: bool = True,
                        locality_hints=None) -> list:
        """n coordinated iterators over ONE execution of this dataset
        (ref: dataset.py:1731, stream_split_iterator.py:37): a
        SplitCoordinator actor runs the stream and hands blocks round-robin
        to consumers — the TorchTrainer input path."""
        from ray_tpu_torch.data.split import make_stream_splits

        return make_stream_splits(self, n, equal=equal)

    def __repr__(self):
        ops = " -> ".join(op.name for op in self._plan.ops) or "source"
        return f"Dataset({len(self._plan.read_tasks)} read tasks, {ops})"

    # ------------------------------------------------------------- sinks
    def _write_files(self, path: str, ext: str, write_block: Callable) -> list[str]:
        """One file per block: path/part-<i>.<ext> (ref: write_parquet &
        friends — per-block write tasks, no driver materialization)."""
        import os

        os.makedirs(path, exist_ok=True)

        @ray_tpu_torch.remote
        def write(block, out_path):
            write_block(block, out_path)
            return out_path

        refs = []
        for i, ref in enumerate(self.iter_block_refs()):
            refs.append(write.remote(ref, os.path.join(path, f"part-{i:05d}.{ext}")))
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str) -> list[str]:
        def wb(block, out_path):
            import pandas as pd
            import pyarrow as pa
            import pyarrow.parquet as pq

            cols = rows_to_columns(block) if isinstance(block, list) else block
            pq.write_table(pa.Table.from_pandas(pd.DataFrame(cols)), out_path)

        return self._write_files(path, "parquet", wb)

    def write_csv(self, path: str) -> list[str]:
        def wb(block, out_path):
            import pandas as pd

            cols = rows_to_columns(block) if isinstance(block, list) else block
            pd.DataFrame(cols).to_csv(out_path, index=False)

        return self._write_files(path, "csv", wb)

    def write_json(self, path: str) -> list[str]:
        def wb(block, out_path):
            import pandas as pd

            cols = rows_to_columns(block) if isinstance(block, list) else block
            pd.DataFrame(cols).to_json(out_path, orient="records", lines=True)

        return self._write_files(path, "json", wb)


class AggregateFn:
    """A named groupby aggregation (ref: python/ray/data/aggregate.py
    AggregateFn): ``init() -> state``, ``accumulate(state, row) -> state``,
    ``merge(a, b) -> state``, ``finalize(state) -> value``."""

    def __init__(self, init: Callable, accumulate: Callable, merge: Callable,
                 finalize: Callable | None = None, name: str = "agg"):
        self.init = init
        self.accumulate = accumulate
        self.merge = merge
        self.finalize = finalize or (lambda s: s)
        self.name = name


def _count_agg():
    return AggregateFn(lambda: 0, lambda s, r: s + 1, lambda a, b: a + b,
                       name="count()")


def _sum_agg(on):
    return AggregateFn(lambda: 0, lambda s, r: s + r[on], lambda a, b: a + b,
                       name=f"sum({on})")


def _min_agg(on):
    return AggregateFn(
        lambda: None, lambda s, r: r[on] if s is None else builtins.min(s, r[on]),
        lambda a, b: builtins.min(a, b), name=f"min({on})")


def _max_agg(on):
    return AggregateFn(
        lambda: None, lambda s, r: r[on] if s is None else builtins.max(s, r[on]),
        lambda a, b: builtins.max(a, b), name=f"max({on})")


def _mean_agg(on):
    return AggregateFn(
        lambda: (0.0, 0), lambda s, r: (s[0] + r[on], s[1] + 1),
        lambda a, b: (a[0] + b[0], a[1] + b[1]),
        lambda s: s[0] / s[1] if s[1] else float("nan"), name=f"mean({on})")


def _std_agg(on, ddof=1):
    # Welford-mergeable (count, mean, M2) — numerically stable across
    # shard merges, unlike sum/sum-of-squares
    def merge(a, b):
        (na, ma, m2a), (nb, mb, m2b) = a, b
        if na == 0:
            return b
        if nb == 0:
            return a
        n = na + nb
        d = mb - ma
        return (n, ma + d * nb / n, m2a + m2b + d * d * na * nb / n)

    def accum(s, r):
        n, m, m2 = s
        x = r[on]
        n += 1
        d = x - m
        m += d / n
        return (n, m, m2 + d * (x - m))

    return AggregateFn(
        lambda: (0, 0.0, 0.0), accum, merge,
        lambda s: (s[2] / (s[0] - ddof)) ** 0.5 if s[0] > ddof else float("nan"),
        name=f"std({on})")


class GroupedDataset:
    """Result of Dataset.groupby(key) (ref: grouped_data.py GroupedData:
    count/sum/min/max/mean/std/aggregate/map_groups). Aggregations run as
    a distributed hash aggregate (ref: execution/operators/
    hash_shuffle.py hash-aggregate shape): each block computes per-shard
    partial states (map side, num_returns=P), then P independent reduce
    tasks merge and finalize their shard — reduce parallelism P, no
    single task sees every group."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        """Run several aggregations in one pass; output rows are
        {key, agg1.name: v1, ...} (ref: GroupedData.aggregate)."""
        key = self._key
        block_refs = list(self._ds.iter_block_refs())
        if not block_refs:
            return from_items([])
        P = builtins.min(len(block_refs), 16) or 1

        @ray_tpu_torch.remote(num_returns=P)
        def partial(block):
            acc = BlockAccessor.for_block(block)
            shards: list[dict] = [{} for _ in builtins.range(P)]
            for row in acc.rows():
                k = row[key]
                states = shards[_key_shard(k, P)].get(k)
                if states is None:
                    states = [a.init() for a in aggs]
                    shards[_key_shard(k, P)][k] = states
                for i, a in enumerate(aggs):
                    states[i] = a.accumulate(states[i], row)
            return tuple(shards) if P > 1 else shards[0]

        @ray_tpu_torch.remote
        def reduce_shard(*parts):
            merged: dict = {}
            for p in parts:
                for k, states in p.items():
                    cur = merged.get(k)
                    if cur is None:
                        merged[k] = list(states)
                    else:
                        for i, a in enumerate(aggs):
                            cur[i] = a.merge(cur[i], states[i])
            return [
                dict({key: k},
                     **{a.name: a.finalize(s)
                        for a, s in zip(aggs, merged[k])})
                for k in sorted(merged, key=str)
            ]

        @ray_tpu_torch.remote
        def merge_sorted(*shard_rows):
            # shards are tiny (one row per group): a final key-sorted
            # merge keeps the pre-hash-aggregate contract of globally
            # key-ordered output without a driver materialization of
            # anything bigger than the aggregate itself
            out = [r for rows in shard_rows for r in rows]
            out.sort(key=lambda r: str(r[key]))
            return out

        sharded = [partial.remote(r) for r in block_refs]
        if P == 1:
            cols = [[s] for s in sharded]
        else:
            cols = [[sharded[b][p] for b in builtins.range(len(sharded))]
                    for p in builtins.range(P)]
        out_refs = [reduce_shard.remote(*col) for col in cols]
        from ray_tpu_torch.data.executor import InjectRefs

        return Dataset(Plan(
            [], (InjectRefs("hash_aggregate",
                            [merge_sorted.remote(*out_refs)]),)))

    def count(self) -> Dataset:
        return self.aggregate(_count_agg())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(_sum_agg(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(_min_agg(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(_max_agg(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(_mean_agg(on))

    def std(self, on: str, ddof: int = 1) -> Dataset:
        return self.aggregate(_std_agg(on, ddof))

    def map_groups(self, fn: Callable) -> Dataset:
        """Apply fn(list_of_rows) -> list_of_rows per complete group.

        Hash-shuffle shape (ref: execution/operators/hash_shuffle.py): each
        block is hash-partitioned by key into P shards; one apply task per
        shard sees only its shard of every block — parallelism P, no task
        materializes the whole dataset."""
        key = self._key
        block_refs = list(self._ds.iter_block_refs())
        if not block_refs:
            return from_items([])
        P = builtins.min(len(block_refs), 16) or 1

        @ray_tpu_torch.remote(num_returns=P)
        def partition(block):
            acc = BlockAccessor.for_block(block)
            shards: list[dict] = [{} for _ in builtins.range(P)]
            for row in acc.rows():
                k = row[key]
                shards[_key_shard(k, P)].setdefault(k, []).append(row)
            return tuple(shards) if P > 1 else shards[0]

        @ray_tpu_torch.remote
        def apply_shard(*shard_parts):
            groups: dict = {}
            for p in shard_parts:
                for k, rows in p.items():
                    groups.setdefault(k, []).extend(rows)
            out = []
            for k in sorted(groups, key=str):
                out.extend(fn(groups[k]))
            return out

        sharded = [partition.remote(r) for r in block_refs]
        if P == 1:
            shard_cols = [[s] for s in sharded]
        else:
            shard_cols = [[sharded[b][p] for b in builtins.range(len(sharded))]
                          for p in builtins.range(P)]
        out_rows: list = []
        for rows in ray_tpu_torch.get(
                [apply_shard.remote(*col) for col in shard_cols]):
            out_rows.extend(rows)
        return from_items(out_rows)


class _HoldBlock:
    """Picklable closure holding a materialized block as a read task."""

    def __init__(self, block):
        self.block = block

    def __call__(self):
        return self.block


# ------------------------------------------------------------------ sources
def _key_shard(k, P: int) -> int:
    """Stable partition of a join/group key (equal keys route identically
    across processes; 1 == 1.0 == True share an encoding)."""
    import zlib

    if isinstance(k, np.generic):
        k = k.item()
    if isinstance(k, str):
        b = b"s:" + k.encode()
    elif isinstance(k, bytes):
        b = b"b:" + k
    elif isinstance(k, (bool, int, float)):
        try:
            b = b"n:" + repr(float(k)).encode()
        except OverflowError:
            b = b"i:" + repr(int(k)).encode()
    else:
        b = b"o:" + repr(k).encode()
    return zlib.crc32(b) % P


def _hash_join_blocks(left_parts: list, right_parts: list, on: str,
                      how: str, suffix: str):
    """One partition's hash join: build key -> row-indices from the left,
    probe the right; row selection via Arrow take with null indices so
    outer rows null-fill naturally (ref: join.py:28 hash join build/probe)."""
    import pyarrow as pa
    import pyarrow.compute  # noqa: F401 — pa.compute is not auto-imported

    def side(parts):
        acc = BlockAccessor.for_block(BlockAccessor.concat(parts))
        if not acc.is_tabular() and acc.num_rows():
            # rows-list side (e.g. from_items): pivot to columnar once
            acc = BlockAccessor.for_block(rows_to_columns(list(acc.rows())))
        return acc

    lt = side(left_parts)
    rt = side(right_parts)
    n_l, n_r = lt.num_rows(), rt.num_rows()
    if (n_l == 0 and how in ("inner", "left")) or (
            n_r == 0 and how in ("inner", "right")):
        return []
    lkeys = lt.column(on).tolist() if n_l else []
    rkeys = rt.column(on).tolist() if n_r else []
    pos: dict = {}
    for i, k in enumerate(lkeys):
        pos.setdefault(k, []).append(i)
    li: list = []
    ri: list = []
    matched = np.zeros(n_l, dtype=bool)
    for j, k in enumerate(rkeys):
        hits = pos.get(k)
        if hits:
            matched[hits] = True
            for i in hits:
                li.append(i)
                ri.append(j)
        elif how in ("right", "outer"):
            li.append(None)
            ri.append(j)
    if how in ("left", "outer"):
        for i in np.nonzero(~matched)[0]:
            li.append(int(i))
            ri.append(None)
    if not li:
        return []

    def table_of(acc):
        b = acc.block
        if isinstance(b, pa.Table):
            return b
        t = acc.to_batch("pyarrow") if acc.num_rows() else pa.table({})
        return t

    ltab = table_of(lt) if n_l else None
    rtab = table_of(rt) if n_r else None
    lsel = ltab.take(pa.array(li, type=pa.int64())) if ltab is not None \
        else None
    rsel = rtab.take(pa.array(ri, type=pa.int64())) if rtab is not None \
        else None
    out: dict = {}
    # key column: from whichever side has it per row
    if lsel is not None and rsel is not None and on in rsel.column_names:
        lk, rk = lsel[on], rsel[on]
        out[on] = pa.chunked_array([
            pa.compute.if_else(pa.compute.is_valid(lk.combine_chunks()),
                               lk.combine_chunks(), rk.combine_chunks())])
    elif lsel is not None:
        out[on] = lsel[on]
    else:
        out[on] = rsel[on]
    if lsel is not None:
        for name in lsel.column_names:
            if name != on:
                out[name] = lsel[name]
    if rsel is not None:
        for name in rsel.column_names:
            if name == on:
                continue
            out[name + suffix if name in out else name] = rsel[name]
    return pa.table(out)


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    if parallelism <= 0:
        parallelism = max(1, min(8, n // DEFAULT_BLOCK_ROWS or 1))
    edges = np.linspace(0, n, parallelism + 1, dtype=np.int64)

    def make(lo: int, hi: int):
        return lambda: {"id": np.arange(lo, hi, dtype=np.int64)}

    return Dataset(Plan([make(int(lo), int(hi))
                         for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]))


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    items = list(items)
    if parallelism <= 0:
        parallelism = max(1, min(8, len(items) // DEFAULT_BLOCK_ROWS or 1))
    chunks = np.array_split(np.arange(len(items)), parallelism)

    def make(chunk_items):
        return lambda: list(chunk_items)

    return Dataset(Plan([make([items[i] for i in c]) for c in chunks if len(c)]))


def from_numpy(arr, *, parallelism: int = -1) -> Dataset:
    if isinstance(arr, dict):
        n = len(next(iter(arr.values())))
        cols = {k: np.asarray(v) for k, v in arr.items()}
    else:
        arr = np.asarray(arr)
        n = len(arr)
        cols = {"data": arr}
    if parallelism <= 0:
        parallelism = max(1, min(8, n // DEFAULT_BLOCK_ROWS or 1))
    edges = np.linspace(0, n, parallelism + 1, dtype=np.int64)

    def make(lo, hi):
        return lambda: {k: v[lo:hi] for k, v in cols.items()}

    return Dataset(Plan([make(int(lo), int(hi))
                         for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]))


def from_pandas(df) -> Dataset:
    return Dataset(Plan([functools.partial(normalize_block, df)]))


def from_arrow(table) -> Dataset:
    return Dataset(Plan([functools.partial(normalize_block, table)]))


def _expand_paths(paths) -> list[str]:
    import glob
    import os

    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")
            ))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    return out


def read_csv(paths, **pandas_kwargs) -> Dataset:
    files = _expand_paths(paths)

    def make(path):
        def read():
            import pandas as pd

            return normalize_block(pd.read_csv(path, **pandas_kwargs))

        return read

    return Dataset(Plan([make(p) for p in files]))


class _ParquetReadTask:
    """Projectable parquet read (the optimizer's projection_pushdown
    retargets ``columns`` when select_columns is the first op)."""

    def __init__(self, path: str, columns: list[str] | None):
        self.path = path
        self.columns = columns

    def __call__(self):
        import pyarrow.parquet as pq

        return normalize_block(pq.read_table(self.path, columns=self.columns))

    def with_columns(self, cols: list[str]) -> "_ParquetReadTask":
        if self.columns is not None and any(
                c not in self.columns for c in cols):
            # refuse rather than silently narrow: the optimizer then keeps
            # the select_columns op, which raises KeyError at execution —
            # the same observable behavior as the unoptimized plan
            raise AttributeError(
                f"projection {cols} not serveable from {self.columns}")
        return _ParquetReadTask(self.path, list(cols))


def read_parquet(paths, columns: list[str] | None = None) -> Dataset:
    files = _expand_paths(paths)
    return Dataset(Plan([_ParquetReadTask(p, columns) for p in files]))


def read_json(paths, *, lines: bool = True) -> Dataset:
    files = _expand_paths(paths)

    def make(path):
        def read():
            import json

            with open(path) as f:
                if lines:
                    return [json.loads(line) for line in f if line.strip()]
                data = json.load(f)
                return data if isinstance(data, list) else [data]

        return read

    return Dataset(Plan([make(p) for p in files]))


def read_text(paths) -> Dataset:
    files = _expand_paths(paths)

    def make(path):
        def read():
            with open(path) as f:
                return [{"text": line.rstrip("\n")} for line in f]

        return read

    return Dataset(Plan([make(p) for p in files]))


def read_numpy(paths) -> Dataset:
    files = _expand_paths(paths)

    def make(path):
        return lambda: {"data": np.load(path)}

    return Dataset(Plan([make(p) for p in files]))


def read_images(paths, *, size: tuple[int, int] | None = None,
                mode: str | None = None,
                include_paths: bool = False) -> Dataset:
    """One row per image: {"image": HxWxC uint8 array[, "path"]} (ref:
    read_api.py read_images). ``size=(h, w)`` resizes; ``mode`` converts
    (e.g. "RGB", "L")."""
    files = _expand_paths(paths)

    def make(path):
        def read():
            from PIL import Image

            img = Image.open(path)
            if mode:
                img = img.convert(mode)
            if size:
                img = img.resize((size[1], size[0]))
            row = {"image": np.asarray(img)}
            if include_paths:
                row["path"] = path
            return [row]

        return read

    return Dataset(Plan([make(p) for p in files]))


def read_sql(sql: str, connection_factory: Callable) -> Dataset:
    """Rows from any DB-API connection (ref: read_api.py read_sql —
    there over a connector zoo; here the caller supplies the
    ``connection_factory`` so sqlite3/psycopg/etc. all work the same).
    One read task executes the query on a worker (not the driver);
    ``.repartition(n)`` afterwards for downstream parallelism."""
    def read():
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            if cur.description is None:
                raise ValueError(
                    "read_sql requires a statement that returns rows "
                    "(cursor.description is None — DDL/INSERT?)")
            cols = [d[0] for d in cur.description]
            return [dict(builtins.zip(cols, row)) for row in cur.fetchall()]
        finally:
            conn.close()

    return Dataset(Plan([read]))


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    """One row per file: {"bytes": ...[, "path": ...]} (ref:
    read_api.py read_binary_files)."""
    files = _expand_paths(paths)

    def make(path):
        def read():
            with open(path, "rb") as f:
                data = f.read()
            row = {"bytes": data}
            if include_paths:
                row["path"] = path
            return [row]

        return read

    return Dataset(Plan([make(p) for p in files]))
