"""Compiled graphs: static dataflow over actors on shm channels.

Counterpart of ``ray_tpu/dag/`` (ref: python/ray/dag/ +
python/ray/experimental/channel/), with cross-node channels mirrored over
the raylet transfer plane and collective nodes riding
``ray_tpu_torch.collective``. A CUDA tensor crosses a channel as host
bytes and comes back on the reading stage's current card
(``utils/serialization.py``); a stage without a card raises.
"""

from ray_tpu_torch.dag.channel import ChannelClosed, ShmChannel
from ray_tpu_torch.dag.compiled_dag import CompiledDAG, CompiledDAGFuture, CompiledDAGRef
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    CollectiveNode,
    DAGNode,
    InputNode,
    MultiOutputNode,
    allreduce_bind,
    bind,
)

__all__ = [
    "ChannelClosed",
    "ShmChannel",
    "CompiledDAG",
    "CompiledDAGRef",
    "CompiledDAGFuture",
    "ClassMethodNode",
    "CollectiveNode",
    "DAGNode",
    "InputNode",
    "MultiOutputNode",
    "allreduce_bind",
    "bind",
]
