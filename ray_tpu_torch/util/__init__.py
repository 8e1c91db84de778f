"""User-facing distributed utilities (ref: python/ray/util/*)."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "ActorPool", "Queue", "Empty", "Full",
    "NodeAffinitySchedulingStrategy", "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]
