"""Communicator abstract base.

A copy of ``ray_tpu/collective/communicator.py``: the interface the
collective library's groups implement (send/recv/allreduce/allgather/
reducescatter/broadcast/reduce/barrier and rank/world size).
"""

from __future__ import annotations

import abc
from typing import Any

from ray_tpu_torch.collective.types import ReduceOp


class Communicator(abc.ABC):
    def __init__(self, world_size: int, rank: int, group_name: str):
        self._world_size = world_size
        self._rank = rank
        self._group_name = group_name

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def group_name(self) -> str:
        return self._group_name

    # -- collectives --------------------------------------------------------
    @abc.abstractmethod
    def allreduce(self, value, op: ReduceOp = ReduceOp.SUM):
        ...

    @abc.abstractmethod
    def allgather(self, value):
        """Returns stacked values from all ranks along a new axis 0."""

    @abc.abstractmethod
    def reducescatter(self, value, op: ReduceOp = ReduceOp.SUM):
        """Reduce then scatter equal chunks of axis 0; returns this rank's."""

    @abc.abstractmethod
    def broadcast(self, value, src_rank: int = 0):
        ...

    @abc.abstractmethod
    def reduce(self, value, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        ...

    @abc.abstractmethod
    def barrier(self) -> None:
        ...

    # -- p2p ----------------------------------------------------------------
    @abc.abstractmethod
    def send(self, value, dst_rank: int) -> None:
        ...

    @abc.abstractmethod
    def recv(self, src_rank: int) -> Any:
        ...

    def destroy(self) -> None:
        pass
