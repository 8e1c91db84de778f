"""Distributed FIFO queue backed by an async actor
(ref: python/ray/util/queue.py — Queue over an _QueueActor with
put/get/qsize/empty/full, blocking and timeout variants)."""

from __future__ import annotations

import asyncio

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote(num_cpus=0, max_concurrency=16)
class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: float | None = None) -> bool:
        try:
            if timeout is None:
                await self._q.put(item)
            else:
                await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_nowait(self, item) -> bool:
        # async so it runs on the actor's event loop: asyncio.Queue is not
        # thread-safe and a sync method would mutate it from executor threads
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: float | None = None):
        try:
            if timeout is None:
                return True, await self._q.get()
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def qsize(self) -> int:
        return self._q.qsize()


class Queue:
    """Cluster-wide FIFO usable from any driver/worker/actor."""

    def __init__(self, maxsize: int = 0, *, actor_options: dict | None = None):
        self.maxsize = maxsize
        opts = actor_options or {}
        self.actor = (_QueueActor.options(**opts) if opts else _QueueActor).remote(maxsize)

    def put(self, item, block: bool = True, timeout: float | None = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full("queue is full")
            return
        if not ray_tpu_torch.get(self.actor.put.remote(item, timeout)):
            raise Full("put timed out")

    def get(self, block: bool = True, timeout: float | None = None):
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty("queue is empty")
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty("get timed out")
        return item

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
