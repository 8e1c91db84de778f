"""Collective communication between processes.

Counterpart of ``ray_tpu/collective``: the module-level API of
``ray.util.collective`` on ``torch.distributed`` (NCCL on the card, gloo on
the CPU), through ``TorchCollectiveGroup``.
"""

from ray_tpu_torch.collective.collective import (  # noqa: F401
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_group_handle,
    init_collective_group,
    recv,
    reduce,
    reducescatter,
    send,
)
from ray_tpu_torch.collective.types import Backend, ReduceOp  # noqa: F401
