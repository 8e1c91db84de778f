"""Small asyncio helpers shared by the control-plane components.

The reference runtime tears down its event loops by joining C++ threads;
our asyncio equivalents instead track every background task they spawn so
close()/stop() can cancel them deterministically (no "Task was destroyed
but it is pending!" spray on interpreter exit).
"""
from __future__ import annotations

import asyncio
import logging

logger = logging.getLogger("ray_tpu_torch")


class TaskGroup:
    """Tracks background tasks so they can be cancelled together on close."""

    def __init__(self) -> None:
        self._tasks: set[asyncio.Task] = set()
        self._closed = False

    def spawn(self, coro, loop: asyncio.AbstractEventLoop | None = None) -> asyncio.Task | None:
        if self._closed:
            coro.close()
            return None
        lp = loop or asyncio.get_running_loop()
        task = lp.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._on_done)
        return task

    def _on_done(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        if not task.cancelled():
            # retrieve (and log) the exception now instead of asyncio's
            # nondeterministic "never retrieved" warning at GC time
            exc = task.exception()
            if exc is not None:
                logger.warning("background task %s failed", task.get_name(), exc_info=exc)

    async def cancel_all(self) -> None:
        self._closed = True
        tasks = list(self._tasks)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self._tasks.clear()
