"""Rule-based logical plan optimizer.

Counterpart of ``ray_tpu/data/optimizer.py``, rule for rule: rewrite the
op chain before execution so fewer tasks touch fewer rows.

  - EliminateRedundantOps  limit∘limit -> min; repartition/shuffle
                           immediately re-done -> last one wins (sorts
                           never collapse: stable-sort tie-breaks)
  - LimitPushdown          move limit below row-count-preserving maps, so
                           the map only sees surviving rows
  - ProjectionPushdown     select_columns as the FIRST op over parquet
                           reads -> read only those columns from disk
  - MapFusion              adjacent MapBlocks -> one task per block for
                           the whole chain (one serialization round-trip)
  - ReadMapFusion          leading MapBlocks folds into the read task
                           itself -> transform runs where the read ran

Every rule is a pure Plan -> Plan function; ``optimize`` runs them to a
bounded fixpoint. ``explain(plan)`` renders before/after for
Dataset.explain(), in JAX's words.
"""

from __future__ import annotations

from typing import Callable

from ray_tpu_torch.data import executor as ex


def _is_map(op) -> bool:
    # indexed maps take (block, stream_index) — excluded from fusion,
    # whose composed fns assume the plain (block) signature
    return type(op) is ex.MapBlocks and not getattr(op, "indexed", False)


def eliminate_redundant(plan: "ex.Plan") -> "ex.Plan":
    ops = list(plan.ops)
    out: list = []
    for op in ops:
        if out:
            prev = out[-1]
            if isinstance(op, ex.LimitOp) and isinstance(prev, ex.LimitOp):
                out[-1] = ex.LimitOp(min(prev.n, op.n))
                continue
            # a barrier immediately followed by the same barrier kind:
            # only the last one determines the output
            # (repartition(4).repartition(8), shuffle().shuffle()). Sorts
            # do NOT collapse: sort is stable, so sort(a).sort(b) means
            # "by b, ties broken by a" — dropping sort(a) changes output.
            for kind in (ex.RepartitionOp, ex.ShuffleOp):
                if isinstance(op, kind) and isinstance(prev, kind):
                    out[-1] = op
                    break
            else:
                out.append(op)
            continue
        out.append(op)
    return ex.Plan(plan.read_tasks, tuple(out))


def limit_pushdown(plan: "ex.Plan") -> "ex.Plan":
    """limit after a rows-preserving map commutes with it: mapping rows
    that the limit then drops is wasted work (ref: rules/limit_pushdown)."""
    ops = list(plan.ops)
    changed = True
    while changed:
        changed = False
        for i in range(1, len(ops)):
            if (isinstance(ops[i], ex.LimitOp) and _is_map(ops[i - 1])
                    and getattr(ops[i - 1], "preserves_rows", False)):
                ops[i - 1], ops[i] = ops[i], ops[i - 1]
                changed = True
    return ex.Plan(plan.read_tasks, tuple(ops))


def projection_pushdown(plan: "ex.Plan") -> "ex.Plan":
    """select_columns as the first op over column-projectable reads
    (parquet) becomes a column list on the read itself (ref:
    planner/plan_read_op.py apply_output_blocks_handling... — here the
    read task carries the projection)."""
    if not plan.ops:
        return plan
    first = plan.ops[0]
    cols = getattr(first, "projected_columns", None)
    if not cols or not plan.read_tasks:
        return plan
    try:
        projected = [rt.with_columns(cols) for rt in plan.read_tasks]
    except (AttributeError, TypeError):
        return plan  # at least one read is not projectable
    return ex.Plan(projected, plan.ops[1:])


def _compose(f: Callable, g: Callable) -> Callable:
    def fused(block, _f=f, _g=g):
        return _g(ex.normalize_block(_f(block)))

    return fused


def map_fusion(plan: "ex.Plan") -> "ex.Plan":
    """Adjacent maps that lease the same cards (none, most often) become
    one task per block."""
    ops = list(plan.ops)
    out: list = []
    for op in ops:
        if (out and _is_map(op) and _is_map(out[-1])
                and op.num_gpus == out[-1].num_gpus):
            prev = out[-1]
            fused = ex.MapBlocks(
                f"{prev.name}->{op.name}", _compose(prev.fn, op.fn),
                max_in_flight=min(prev.max_in_flight, op.max_in_flight),
                num_gpus=op.num_gpus)
            fused.preserves_rows = (
                getattr(prev, "preserves_rows", False)
                and getattr(op, "preserves_rows", False))
            out[-1] = fused
        else:
            out.append(op)
    return ex.Plan(plan.read_tasks, tuple(out))


class _FusedRead:
    """Read task with a map folded in; keeps the original's projection
    hook so ProjectionPushdown and ReadMapFusion compose in either order."""

    def __init__(self, read_task, fn):
        self.read_task = read_task
        self.fn = fn

    def __call__(self):
        return self.fn(ex.normalize_block(self.read_task()))

    def with_columns(self, cols):
        if not hasattr(self.read_task, "with_columns"):
            raise AttributeError("inner read is not projectable")
        return _FusedRead(self.read_task.with_columns(cols), self.fn)

    @property
    def __name__(self):
        return "fused_read"


def read_map_fusion(plan: "ex.Plan") -> "ex.Plan":
    """Fold a leading MapBlocks into the read tasks: the transform runs in
    the same task (same worker, zero extra hop) as the read (ref:
    rules/operator_fusion.py fusing MapOperator into the upstream Read).
    A map that leases cards stays a task of its own: reads lease none."""
    if (not plan.ops or not _is_map(plan.ops[0]) or plan.ops[0].num_gpus
            or not plan.read_tasks):
        return plan
    fn = plan.ops[0].fn
    return ex.Plan([_FusedRead(rt, fn) for rt in plan.read_tasks],
                   plan.ops[1:])


# projection BEFORE limit pushdown: limit_pushdown would otherwise swap a
# trailing limit in front of a leading select_columns (it preserves rows),
# after which select is no longer ops[0] and the parquet projection never
# fires — reading every column the select exists to drop
RULES: tuple = (
    eliminate_redundant,
    projection_pushdown,
    limit_pushdown,
    map_fusion,
    read_map_fusion,
)


def optimize(plan: "ex.Plan") -> "ex.Plan":
    for _ in range(4):  # bounded fixpoint: each rule is idempotent-ish
        before = _signature(plan)
        for rule in RULES:
            plan = rule(plan)
        if _signature(plan) == before:
            break
    return plan


def _signature(plan: "ex.Plan") -> tuple:
    return (len(plan.read_tasks),
            tuple((type(op).__name__, op.name) for op in plan.ops))


def describe(plan: "ex.Plan") -> str:
    src = f"read[{len(plan.read_tasks)} tasks]"
    chain = " -> ".join([src] + [op.name for op in plan.ops])
    return chain


def explain(plan: "ex.Plan") -> str:
    return (f"logical : {describe(plan)}\n"
            f"physical: {describe(optimize(plan))}")
