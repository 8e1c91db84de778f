"""Process-group management and the module-level collective API.

Counterpart of ``ray_tpu/collective/collective.py``: the same names and
signatures, each group a ``TorchCollectiveGroup``. ``create_collective_group``
tells actors of the port's runtime to join.
"""

from __future__ import annotations

import threading
from typing import Any

from ray_tpu_torch.collective.communicator import Communicator
from ray_tpu_torch.collective.torch_group import TorchCollectiveGroup
from ray_tpu_torch.collective.types import Backend, ReduceOp


class GroupManager:
    def __init__(self):
        self._groups: dict[str, Communicator] = {}
        self._lock = threading.Lock()

    def create_group(self, backend: str, world_size: int, rank: int, group_name: str,
                     init_method: str | None = None) -> Communicator:
        with self._lock:
            if group_name in self._groups:
                return self._groups[group_name]
        group = TorchCollectiveGroup(world_size, rank, group_name, backend, init_method)
        with self._lock:
            self._groups[group_name] = group
        return group

    def get(self, group_name: str) -> Communicator:
        group = self._groups.get(group_name)
        if group is None:
            raise ValueError(
                f"collective group {group_name!r} is not initialized in this "
                "process; call init_collective_group first"
            )
        return group

    def destroy(self, group_name: str):
        group = self._groups.pop(group_name, None)
        if group is not None:
            group.destroy()


_manager = GroupManager()


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = Backend.NCCL,
    group_name: str = "default",
    init_method: str | None = None,
) -> Communicator:
    """Join this process into a collective group (call once per member).
    Without a default process group, ``init_method`` (e.g.
    ``"file://<dir>/rdzv"``) starts one."""
    return _manager.create_group(backend, world_size, rank, group_name, init_method)


def create_collective_group(
    actors: list,
    world_size: int,
    ranks: list[int],
    backend: str = Backend.GLOO,
    group_name: str = "default",
):
    """Declarative variant (ref: collective.py:160): tell N actors to join.
    Each actor's class defines ``_setup_collective_group(world_size, rank,
    backend, group_name)``, which calls ``init_collective_group`` with its
    rendezvous, as JAX's callers do. A handle refuses attributes that
    start with "_", so the method is named to ``ActorMethod`` directly."""
    import ray_tpu_torch
    from ray_tpu_torch.core.ref import ActorMethod

    refs = [
        ActorMethod(actor, "_setup_collective_group").remote(world_size, rank, backend,
                                                              group_name)
        for actor, rank in zip(actors, ranks)
    ]
    ray_tpu_torch.get(refs)


def get_group_handle(group_name: str = "default") -> Communicator:
    return _manager.get(group_name)


def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _manager.get(group_name).allreduce(tensor, op)


def allgather(tensor, group_name: str = "default"):
    return _manager.get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _manager.get(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _manager.get(group_name).broadcast(tensor, src_rank)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM):
    return _manager.get(group_name).reduce(tensor, dst_rank, op)


def barrier(group_name: str = "default"):
    _manager.get(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default"):
    _manager.get(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default") -> Any:
    return _manager.get(group_name).recv(src_rank)


def destroy_collective_group(group_name: str = "default"):
    _manager.destroy(group_name)
