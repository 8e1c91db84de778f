"""@serve.batch — coalesce concurrent requests into one batched call.

Counterpart of ``ray_tpu/serve/batching.py`` (an asyncio queue, no runtime
needed). On the card as on the TPU, N concurrent decode requests should
reach the model as ONE batch-N forward pass, not N batch-1 passes. The
wrapped method must be async and take a list of requests, returning a
list of results of the same length.

Data-plane behavior (serve/dataplane/batching.py):

- **adaptive batch size**: with a ``latency_slo_ms`` budget (set on the
  decorator, or inherited from the deployment's config by the replica),
  the effective batch cap is AIMD-controlled — it grows additively
  while measured batch p99 stays under the budget (past the configured
  ``max_batch_size``, up to ``max_batch_size_cap``) and halves on a
  breach. Clipper's latency-feedback adaptive batching, not a static
  knob. Without a budget the cap is fixed at ``max_batch_size``.
- **no timeout tail on a full batch**: a submit that fills the batch
  flushes it in the same loop tick — the wait timer is strictly the
  partial-batch path, so a burst of ``cap`` requests never waits out
  ``batch_wait_timeout_s``.
"""
from __future__ import annotations

import asyncio
import functools
import time

from ray_tpu_torch.serve.dataplane.batching import AIMDBatchController


class _BatchConfig:
    """Mutable knobs shared between a wrapper and its queues (a replica
    injects the deployment's ``latency_slo_ms`` here when the decorator
    didn't set one, before any request creates a queue)."""

    __slots__ = ("max_batch_size", "batch_wait_timeout_s",
                 "latency_slo_ms", "max_batch_size_cap")

    def __init__(self, max_batch_size: int, batch_wait_timeout_s: float,
                 latency_slo_ms: float | None,
                 max_batch_size_cap: int | None):
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self.latency_slo_ms = latency_slo_ms
        self.max_batch_size_cap = max_batch_size_cap


class _BatchQueue:
    def __init__(self, fn, cfg: _BatchConfig,
                 slo_override: float | None = None):
        self.fn = fn
        self.cfg = cfg
        slo = (cfg.latency_slo_ms if cfg.latency_slo_ms is not None
               else slo_override)
        self.controller = AIMDBatchController(
            cfg.max_batch_size, slo, hard_cap=cfg.max_batch_size_cap)
        self.queue: list[tuple[tuple, dict, asyncio.Future]] = []
        self._flusher: asyncio.Task | None = None

    async def submit(self, args: tuple, kwargs: dict):
        fut = asyncio.get_running_loop().create_future()
        self.queue.append((args, kwargs, fut))
        if len(self.queue) >= self.controller.current:
            # full batch: flush in THIS loop tick — the wait timer is
            # only ever the partial-batch path
            self._flush_now()
        elif self._flusher is None or self._flusher.done():
            self._flusher = asyncio.get_running_loop().create_task(
                self._wait_flush())
        return await fut

    async def _wait_flush(self):
        await asyncio.sleep(self.cfg.batch_wait_timeout_s)
        self._flush_now()

    def _flush_now(self):
        if self._flusher is not None and not self._flusher.done():
            self._flusher.cancel()
        self._flusher = None
        loop = asyncio.get_running_loop()
        # chunked: an AIMD cut can leave the queue deeper than the new
        # cap — never hand the fn more than the cap it is judged against
        while self.queue:
            cap = max(1, self.controller.current)
            batch, self.queue = self.queue[:cap], self.queue[cap:]
            loop.create_task(self._run(batch))

    async def _run(self, batch):
        # the batched fn receives the list of first positional args:
        # `async def handler(self, requests: list)`
        requests = [a[0] if a else None for a, _, _ in batch]
        t0 = time.perf_counter()
        try:
            results = await self.fn(requests)
            if len(results) != len(batch):
                raise ValueError(
                    f"batched function returned {len(results)} results "
                    f"for a batch of {len(batch)}"
                )
            self.controller.observe(
                len(batch), (time.perf_counter() - t0) * 1e3)
            for (_, _, fut), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as e:
            self.controller.observe(
                len(batch), (time.perf_counter() - t0) * 1e3)
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def batch(fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01,
          latency_slo_ms: float | None = None,
          max_batch_size_cap: int | None = None):
    """Decorator for an async method taking a list of requests.

    ``latency_slo_ms`` arms the AIMD batch-size controller (see module
    docstring); left None it is read from an instance's
    ``__rt_batch_slo__`` attribute where one is set.
    ``max_batch_size_cap`` bounds adaptive growth (default 8x
    ``max_batch_size``)."""

    def wrap(f):
        if not asyncio.iscoroutinefunction(f):
            raise TypeError("@serve.batch requires an async function")
        queues: dict[int, _BatchQueue] = {}
        cfg = _BatchConfig(max_batch_size, batch_wait_timeout_s,
                           latency_slo_ms, max_batch_size_cap)

        @functools.wraps(f)
        async def wrapper(self_or_first, *rest, **kwargs):
            # bound-method case: first arg is `self`; free-function case:
            # first arg is the request itself
            if hasattr(type(self_or_first), f.__name__):
                bound = functools.partial(f, self_or_first)
                key = id(self_or_first)
                request_args = rest
            else:
                bound = f
                key = 0
                request_args = (self_or_first, *rest)
            q = queues.get(key)
            if q is None:
                # deployment-level SLO inheritance (a replica stamps
                # __rt_batch_slo__ on its instance): decorator-set
                # budgets win; free functions have no instance to read
                q = queues[key] = _BatchQueue(
                    bound, cfg,
                    getattr(self_or_first, "__rt_batch_slo__", None)
                    if key else None)
            return await q.submit(request_args, kwargs)

        wrapper._is_serve_batch = True
        wrapper._batch_config = cfg
        wrapper._batch_queues = queues
        return wrapper

    if fn is not None:
        return wrap(fn)
    return wrap
