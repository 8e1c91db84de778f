"""ActorPool: multiplex tasks over a fixed set of actors
(ref: python/ray/util/actor_pool.py — same surface: submit/get_next/
get_next_unordered/map/map_unordered/has_next/push/pop_idle)."""

from __future__ import annotations

from typing import Any, Callable, Iterable

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: list):
        self._idle = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list[tuple[Callable, Any]] = []

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef; queued until an actor is idle."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        idx = self._next_return_index
        if idx not in self._index_to_future:
            raise StopIteration("result already consumed")
        ref = self._index_to_future[idx]
        # get BEFORE mutating pool state: a timeout must leave the task
        # retrievable and the actor owned by the pool
        value = ray_tpu_torch.get(ref, timeout=timeout)
        del self._index_to_future[idx]
        self._next_return_index += 1
        self._return_actor(self._future_to_actor.pop(ref))
        return value

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        refs = list(self._index_to_future.values())
        done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not done:
            raise TimeoutError("no result within timeout")
        ref = done[0]
        value = ray_tpu_torch.get(ref)  # ready: cannot block
        for idx, r in list(self._index_to_future.items()):
            if r is ref:
                del self._index_to_future[idx]
                break
        self._return_actor(self._future_to_actor.pop(ref))
        return value

    def map(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterable:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        while self._pending_submits and self._idle:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def push(self, actor) -> None:
        """Add an idle actor to the pool."""
        self._return_actor(actor)

    def pop_idle(self):
        """Remove and return an idle actor, or None."""
        return self._idle.pop() if self._idle else None
