"""Streaming block executor: bounded in-flight task-parallel execution.

Counterpart of ``ray_tpu/data/executor.py`` on the port's task/actor
runtime (``ray_tpu_torch.core``), operator for operator:

  - the plan is a chain of block operators over a lazy source,
  - each operator keeps at most ``max_in_flight`` block tasks running
    (backpressure: upstream is only pulled when a slot frees),
  - blocks stream through the object store as ObjectRefs — the driver never
    holds more than a prefetch window of materialized data,
  - barrier ops (repartition / shuffle / sort) materialize their input ref
    list but still produce a streaming output.

A map task's function travels with every task as a by-value argument, so
what it closes over rides the runtime's RPC frame: large state (weights)
belongs in the worker (a cache keyed by config) or in an actor pool's
constructor, not in the closure. The shuffle's permutations come from the
same numpy seeds as JAX's, so one seed gives the same rows in both.

Per-op wall-clock and task counts are recorded for Dataset.stats().
"""

from __future__ import annotations

import logging
import collections
import time
from typing import Any, Callable, Iterator

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, normalize_block

_log = logging.getLogger(__name__)

DEFAULT_MAX_IN_FLIGHT = 8


# Remote helpers live at module scope: workers import ray_tpu_torch.data, so
# these ship by reference (cheap); user fns inside op specs travel by value.
@ray_tpu_torch.remote
def _run_read_task(read_fn) -> Any:
    return normalize_block(read_fn())


@ray_tpu_torch.remote
def _apply_op(fn, block) -> Any:
    return normalize_block(fn(block))


@ray_tpu_torch.remote
def _apply_op_indexed(fn, index, block) -> Any:
    return normalize_block(fn(block, index))


@ray_tpu_torch.remote
def _count_rows(block) -> int:
    return BlockAccessor.for_block(block).num_rows()


@ray_tpu_torch.remote
def _slice_block(block, start, end) -> Any:
    return BlockAccessor.for_block(block).slice(start, end)


@ray_tpu_torch.remote
def _concat_blocks(*blocks) -> Any:
    return BlockAccessor.concat(list(blocks))


class OpStats:
    def __init__(self, name: str):
        self.name = name
        self.tasks = 0
        self.wall_s = 0.0

    def row(self) -> str:
        return f"{self.name}: {self.tasks} tasks, {self.wall_s:.2f}s wall"


class Operator:
    """Base logical op. ``transform`` rewrites a stream of block refs."""

    name = "op"

    def transform(self, refs: Iterator, stats: OpStats) -> Iterator:
        raise NotImplementedError


class InjectRefs(Operator):
    """Source-style op: yields pre-computed block refs (join outputs and
    other already-launched distributed results) into the stream."""

    def __init__(self, name: str, refs: list):
        self.name = name
        self.refs = list(refs)

    def transform(self, refs: Iterator, stats: OpStats) -> Iterator:
        def gen():
            yield from refs  # upstream (usually empty for a ref source)
            yield from self.refs
            stats.tasks += len(self.refs)

        return gen()


class MapBlocks(Operator):
    """map_batches / map / filter / flat_map all lower to this
    (ref: execution/operators/map_operator.py)."""

    def __init__(self, name: str, fn: Callable, max_in_flight: int | None = None,
                 preserves_rows: bool = False, indexed: bool = False,
                 num_gpus: float | None = None):
        self.name = name
        self.fn = fn
        self.max_in_flight = max_in_flight or DEFAULT_MAX_IN_FLIGHT
        # cards each task leases: the runtime then runs no more of them at
        # once than the cards hold, whatever max_in_flight allows
        self.num_gpus = num_gpus
        # optimizer metadata (data/optimizer.py): True only when the op
        # emits exactly one output row per input row (map, add_column,
        # select_columns — NOT filter/flat_map/map_batches)
        self.preserves_rows = preserves_rows
        # indexed ops receive (block, stream_index) — per-block seeds etc.
        self.indexed = indexed

    def transform(self, refs, stats):
        inflight: collections.deque = collections.deque()
        t0 = time.perf_counter()
        apply, apply_indexed = _apply_op, _apply_op_indexed
        if self.num_gpus:
            apply = apply.options(num_gpus=self.num_gpus)
            apply_indexed = apply_indexed.options(num_gpus=self.num_gpus)
        try:
            for i, ref in enumerate(refs):
                while len(inflight) >= self.max_in_flight:
                    yield inflight.popleft()  # ordered: wait for the head
                if self.indexed:
                    inflight.append(apply_indexed.remote(self.fn, i, ref))
                else:
                    inflight.append(apply.remote(self.fn, ref))
                stats.tasks += 1
            while inflight:
                yield inflight.popleft()
        finally:
            stats.wall_s += time.perf_counter() - t0


class _MapWorker:
    """Stateful map actor (ref: _MapWorker in
    execution/operators/actor_pool_map_operator.py): constructs the
    user's callable class ONCE, then applies it per block — the whole
    point of actor compute is amortizing expensive setup (model loads,
    connections) across blocks."""

    def __init__(self, fn_or_cls, fn_constructor_args: tuple,
                 fn_constructor_kwargs: dict):
        if isinstance(fn_or_cls, type):
            self._fn = fn_or_cls(*fn_constructor_args,
                                 **fn_constructor_kwargs)
        else:
            self._fn = fn_or_cls

    def apply(self, block):
        from ray_tpu_torch.data.block import normalize_block

        return normalize_block(self._fn(block))


class ActorPoolMapBlocks(Operator):
    """Map over a pool of stateful actors (ref:
    execution/operators/actor_pool_map_operator.py + ActorPoolStrategy):
    blocks dispatch to the least-loaded live actor, bounded in flight;
    output order is preserved. Actors are created lazily on first use and
    killed when the stream ends."""

    def __init__(self, name: str, fn_or_cls, *, size: int = 2,
                 max_tasks_per_actor: int = 2,
                 fn_constructor_args: tuple = (),
                 fn_constructor_kwargs: dict | None = None,
                 num_cpus: float = 1.0, num_gpus: float | None = None):
        self.name = name
        self.fn_or_cls = fn_or_cls
        self.size = max(1, int(size))
        self.max_tasks_per_actor = max(1, int(max_tasks_per_actor))
        self.fn_constructor_args = tuple(fn_constructor_args)
        self.fn_constructor_kwargs = dict(fn_constructor_kwargs or {})
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus  # cards each actor leases

    def transform(self, refs, stats):
        t0 = time.perf_counter()
        WorkerCls = ray_tpu_torch.remote(_MapWorker).options(num_cpus=self.num_cpus,
                                                             num_gpus=self.num_gpus)
        actors = [
            WorkerCls.remote(
                self.fn_or_cls, self.fn_constructor_args,
                self.fn_constructor_kwargs)
            for _ in range(self.size)
        ]
        load = [0] * self.size
        inflight: collections.deque = collections.deque()  # (ref, actor_i)
        issued: list = []
        cap = self.size * self.max_tasks_per_actor
        try:
            for ref in refs:
                while len(inflight) >= cap:
                    done, ai = inflight.popleft()
                    load[ai] -= 1
                    yield done
                ai = min(range(self.size), key=load.__getitem__)
                load[ai] += 1
                out = actors[ai].apply.remote(ref)
                issued.append(out)
                inflight.append((out, ai))
                stats.tasks += 1
            while inflight:
                done, ai = inflight.popleft()
                load[ai] -= 1
                yield done
        finally:
            stats.wall_s += time.perf_counter() - t0
            # yielded refs may still be BACKED by pending actor tasks (a
            # downstream barrier op collects refs before resolving them):
            # the pool must outlive every issued task, not just the
            # generator — wait without fetching, then kill
            try:
                if issued:
                    ray_tpu_torch.wait(issued, num_returns=len(issued),
                                 timeout=600, fetch_local=False)
            except Exception:
                _log.debug("drain-before-kill wait failed", exc_info=True)
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    _log.debug("actor kill failed", exc_info=True)


class LimitOp(Operator):
    name = "limit"

    def __init__(self, n: int):
        self.n = n

    def transform(self, refs, stats):
        remaining = self.n
        t0 = time.perf_counter()
        try:
            for ref in refs:
                if remaining <= 0:
                    return
                # limit stays lazy: count blocks one at a time and stop at
                # the cut instead of forcing the whole upstream stream
                count = ray_tpu_torch.get(_count_rows.remote(ref))  # raylint: disable=RT002
                if count <= remaining:
                    remaining -= count
                    yield ref
                else:
                    yield _slice_block.remote(ref, 0, remaining)
                    remaining = 0
                    return
        finally:
            stats.wall_s += time.perf_counter() - t0


class RepartitionOp(Operator):
    """Barrier: rebalance the stream into ``num_blocks`` equal-ish blocks
    (ref: data repartition; the all-to-all exchange reduced to slice+concat
    tasks — no driver materialization of data, only of refs)."""

    name = "repartition"

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks

    def transform(self, refs, stats):
        t0 = time.perf_counter()
        in_refs = list(refs)
        counts = ray_tpu_torch.get([_count_rows.remote(r) for r in in_refs])
        total = sum(counts)
        stats.tasks += len(in_refs)
        if total == 0:
            stats.wall_s += time.perf_counter() - t0
            return
        # target row ranges per output block
        base, rem = divmod(total, self.num_blocks)
        sizes = [base + (1 if i < rem else 0) for i in range(self.num_blocks)]
        # map global row ranges onto (input block, local range) slices
        starts = []
        pos = 0
        for c in counts:
            starts.append(pos)
            pos += c
        out_pos = 0
        for size in sizes:
            if size == 0:
                continue
            pieces = []
            need_start, need_end = out_pos, out_pos + size
            for (bstart, c, ref) in zip(starts, counts, in_refs):
                bend = bstart + c
                lo, hi = max(need_start, bstart), min(need_end, bend)
                if lo < hi:
                    if lo == bstart and hi == bend:
                        pieces.append(ref)
                    else:
                        pieces.append(_slice_block.remote(ref, lo - bstart, hi - bstart))
                        stats.tasks += 1
            out_pos = need_end
            if len(pieces) == 1:
                yield pieces[0]
            else:
                stats.tasks += 1
                yield _concat_blocks.remote(*pieces)
        stats.wall_s += time.perf_counter() - t0


def _shuffle_rows(block, s):
    import numpy as np

    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    perm = np.random.RandomState(s).permutation(n)
    return acc.take(perm)


@ray_tpu_torch.remote
def _shuffle_split(block, seed: int, n_parts: int):
    """Map stage of the push-based shuffle: randomly permute this block's
    rows and cut them into n_parts slices (one per merger). Called with
    num_returns=n_parts so the slices stay in the object plane — the
    driver only ever handles refs."""
    import numpy as np

    block = _shuffle_rows(block, seed)
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    bounds = np.linspace(0, n, n_parts + 1).astype(int)
    parts = tuple(acc.slice(int(bounds[i]), int(bounds[i + 1]))
                  for i in range(n_parts))
    return parts if n_parts > 1 else parts[0]


@ray_tpu_torch.remote
def _shuffle_merge(seed: int, *parts):
    """Merge stage: concatenate one partition's slices from every mapper
    (or every round-merge) and re-permute rows."""
    merged = BlockAccessor.concat([p for p in parts
                                   if BlockAccessor.for_block(p).num_rows()])
    return normalize_block(_shuffle_rows(merged, seed))


class ShuffleOp(Operator):
    """Barrier: exact global random permutation of rows.

    Small inputs use the simple per-block permute + reorder. Larger ones
    run a PUSH-BASED two-stage shuffle (ref: _internal/planner/exchange/
    push_based_shuffle_task_scheduler.py): mappers split each block into P
    random slices; merges run in ROUNDS as mapper outputs appear, so merge
    work overlaps the map stage and no single task ever touches more than
    ~round_size block slices — the property that lets the reference
    shuffle 100TB without head-of-line materialization."""

    name = "random_shuffle"
    PUSH_THRESHOLD = 8  # blocks; below this the simple path is cheaper
    ROUND = 4           # mappers per merge round

    def __init__(self, seed: int | None = None):
        self.seed = seed

    def transform(self, refs, stats):
        import numpy as np

        t0 = time.perf_counter()
        in_refs = list(refs)
        if not in_refs:
            return
        rng = np.random.RandomState(self.seed)
        try:
            if len(in_refs) <= self.PUSH_THRESHOLD:
                yield from self._simple(in_refs, rng, stats)
            else:
                yield from self._push_based(in_refs, rng, stats)
        finally:
            stats.wall_s += time.perf_counter() - t0

    def _simple(self, in_refs, rng, stats):
        seed_for = [int(rng.randint(0, 2**31 - 1)) for _ in in_refs]
        shuffled = [
            _apply_op.remote(lambda b, s=s: _shuffle_rows(b, s), r)
            for r, s in zip(in_refs, seed_for)
        ]
        stats.tasks += len(shuffled)
        for i in rng.permutation(len(shuffled)):
            yield shuffled[i]

    def _push_based(self, in_refs, rng, stats):
        n_parts = max(2, min(len(in_refs),
                             int(len(in_refs) ** 0.5) + 1))
        # per-partition accumulators of round-merge refs
        partials: list[list] = [[] for _ in range(n_parts)]
        round_splits: list = []

        def flush_round():
            # partial merges per partition over this round's mappers:
            # merge work starts while later mappers still run (the "push")
            for p in range(n_parts):
                parts = [splits[p] for splits in round_splits]
                if parts:
                    partials[p].append(_shuffle_merge.remote(
                        int(rng.randint(0, 2**31 - 1)), *parts))
                    stats.tasks += 1
            round_splits.clear()

        split_task = _shuffle_split.options(num_returns=n_parts)
        for r in in_refs:
            split = split_task.remote(
                r, int(rng.randint(0, 2**31 - 1)), n_parts)
            stats.tasks += 1
            round_splits.append(split if isinstance(split, list) else [split])
            if len(round_splits) >= self.ROUND:
                flush_round()
        flush_round()
        out = [
            _shuffle_merge.remote(int(rng.randint(0, 2**31 - 1)), *parts)
            for parts in partials if parts
        ]
        stats.tasks += len(out)
        for i in rng.permutation(len(out)):
            yield out[i]


class SortOp(Operator):
    """Barrier: global sort by key (ref: sort_task_spec.py two-phase
    sample/partition sort, collapsed to sort-merge at this scale)."""

    name = "sort"

    def __init__(self, key, descending: bool = False):
        self.key = key
        self.descending = descending

    def transform(self, refs, stats):
        import numpy as np

        t0 = time.perf_counter()
        in_refs = list(refs)
        if not in_refs:
            return
        key, desc = self.key, self.descending

        def sort_block(block):
            acc = BlockAccessor.for_block(block)
            if acc.is_tabular():
                idx = np.argsort(acc.column(key), kind="stable")
                if desc:
                    idx = idx[::-1]
                return acc.take(idx)
            rows = list(acc.rows())
            getter = (lambda r: r[key]) if key else (lambda r: r)
            return sorted(rows, key=getter, reverse=desc)

        # sort each block, then a single merge task (fine at library scale;
        # the reference's sampled range partitioning is a perf upgrade here)
        sorted_refs = [_apply_op.remote(sort_block, r) for r in in_refs]
        stats.tasks += len(sorted_refs) + 1

        def merge(*blocks):
            b = BlockAccessor.concat(list(blocks))
            return sort_block(b)

        yield _concat_and_apply.remote(merge, *sorted_refs)
        stats.wall_s += time.perf_counter() - t0


@ray_tpu_torch.remote
def _concat_and_apply(fn, *blocks):
    return normalize_block(fn(*blocks))


class Plan:
    """Source + operator chain (ref: LogicalPlan over the streaming
    executor). ``execute`` first runs the rule optimizer
    (data/optimizer.py: redundant-op elimination, limit/projection
    pushdown, map and read-map fusion), then streams the physical chain."""

    def __init__(self, read_tasks: list[Callable], ops: tuple = ()):
        self.read_tasks = list(read_tasks)
        self.ops = tuple(ops)

    def with_op(self, op: Operator) -> "Plan":
        return Plan(self.read_tasks, (*self.ops, op))

    def execute(self, max_source_in_flight: int = DEFAULT_MAX_IN_FLIGHT,
                _optimize: bool = True):
        """Returns (iterator of block refs, list[OpStats])."""
        if _optimize:
            from ray_tpu_torch.data.optimizer import optimize

            return optimize(self).execute(max_source_in_flight,
                                          _optimize=False)
        all_stats = [OpStats("read")]

        def source():
            inflight: collections.deque = collections.deque()
            t0 = time.perf_counter()
            for rt in self.read_tasks:
                while len(inflight) >= max_source_in_flight:
                    yield inflight.popleft()
                inflight.append(_run_read_task.remote(rt))
                all_stats[0].tasks += 1
            while inflight:
                yield inflight.popleft()
            all_stats[0].wall_s += time.perf_counter() - t0

        stream = source()
        for op in self.ops:
            st = OpStats(op.name)
            all_stats.append(st)
            stream = op.transform(stream, st)
        return stream, all_stats
