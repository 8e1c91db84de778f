"""Task/actor scheduling strategies (ref:
python/ray/util/scheduling_strategies.py:15,:41,:135).

Pass via ``.options(scheduling_strategy=...)``:

* ``"DEFAULT"`` — hybrid top-k (prefer the local node until it is
  loaded, then randomized best-fit; core/policy.py).
* ``"SPREAD"`` — round-robin leases across feasible nodes (ref:
  spread_scheduling_policy.cc).
* :class:`NodeAffinitySchedulingStrategy` — pin to one node; ``soft``
  falls back to DEFAULT if that node is gone/full (ref:
  scheduling_strategies.py:41).
* :class:`NodeLabelSchedulingStrategy` — place only on nodes whose
  labels match ``hard`` (value or any-of list); among those, prefer
  nodes matching ``soft`` (ref: scheduling_strategies.py:135,
  node_label_scheduling_policy.h:25). Hard-infeasible submissions fail
  fast with a scheduling error rather than parking forever.

The placement-group strategy keeps its dedicated ``placement_group=``
option; :class:`PlacementGroupSchedulingStrategy` is accepted for
API parity.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PlacementGroupSchedulingStrategy:
    """API-parity wrapper (ref: scheduling_strategies.py:15)."""

    placement_group: object
    placement_group_bundle_index: int = -1


@dataclass
class NodeAffinitySchedulingStrategy:
    """Run on the given node. ``soft=False`` fails if the node is dead
    or full; ``soft=True`` falls back to the default policy."""

    node_id: str  # hex node id (ray_tpu_torch.nodes()[i]["node_id"].hex())
    soft: bool = False

    def to_wire(self) -> dict:
        return {"type": "node_affinity", "node_id": self.node_id,
                "soft": bool(self.soft)}


@dataclass
class NodeLabelSchedulingStrategy:
    """Label-constrained placement. ``hard``/``soft`` map label keys to a
    required value or a list of acceptable values (the reference's In()
    operator); a ``hard`` miss on every node fails the submission."""

    hard: dict = field(default_factory=dict)
    soft: dict = field(default_factory=dict)

    def to_wire(self) -> dict:
        norm = lambda d: {k: list(v) if isinstance(v, (list, tuple, set))
                          else [v] for k, v in d.items()}
        return {"type": "node_label", "hard": norm(self.hard),
                "soft": norm(self.soft)}


def normalize(strategy) -> dict | None:
    """Normalize the user-facing option into the wire dict (None =
    default hybrid policy)."""
    if strategy is None or strategy == "DEFAULT":
        return None
    if strategy == "SPREAD":
        return {"type": "spread"}
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        return None  # carried by the dedicated placement_group option
    if isinstance(strategy, (NodeAffinitySchedulingStrategy,
                             NodeLabelSchedulingStrategy)):
        return strategy.to_wire()
    raise ValueError(f"unknown scheduling_strategy {strategy!r}")


def labels_match(labels: dict, selector: dict) -> bool:
    """selector maps label keys to an acceptable value or list of values
    (all keys must match). Handles both the wire form (lists) and bare
    values, so call sites never need to re-normalize — a stray
    ``list("tpu")`` would silently match nothing."""
    for k, v in selector.items():
        accepted = v if isinstance(v, (list, tuple, set)) else (v,)
        if labels.get(k) not in accepted:
            return False
    return True
