"""Streaming plane for ray_tpu_torch.serve (wire protocol 2.3).

Chunked partial completions ride the serve fast lane as "G" records
(core/fastpath.py ``pack_chunk``): the replica's
``handle_request_streaming`` async generator runs under the worker's
stream pump, which flushes one chunk record per yielded item onto the
SAME shm ring / node tunnel the unary calls use — no per-item ObjectRef,
memory-store entry, or task event. The router's streaming fast path
(handle.py ``route_stream_chunks``) consumes them through
``CoreClient.fast_actor_stream``; the per-item ObjectRef generator plane
(``route_streaming``) remains the RPC fallback and is only entered when
nothing has been consumed yet (a NEED_SLOW terminal precedes execution).

This package holds the pieces above the wire:

- :class:`ServeStream` — the caller-facing stream handle ``.stream_chunks()``
  returns: async iteration on the core loop, sync iteration from the
  driver thread, and mid-stream cancellation (``close``/``aclose`` or
  just abandoning the iterator) that propagates replica-side so decode
  slots free before the generation finishes.
- :class:`StreamBrokenError` — a lane/replica died mid-stream. Streams
  are NEVER replayed after the first consumed chunk (the consumer
  already acted on the prefix); the error carries how many chunks
  landed so callers can resume at the application layer if they can.
- SSE framing helpers (:func:`sse_event`, :data:`SSE_DONE`) shared by
  the HTTP proxy and tests.
- :mod:`ray_tpu_torch.serve.streaming.slo` — TTFC and inter-chunk latency
  recording, published through the same ns="latency" plane the unary
  serve windows use so the autoscaler and SLO burn monitor read
  streaming health with zero new transport.
"""
from __future__ import annotations

import asyncio
import collections
import json

from ray_tpu_torch.serve.exceptions import RayServeException

__all__ = ["ServeStream", "StreamBrokenError", "sse_event", "SSE_DONE"]


class StreamBrokenError(RayServeException):
    """The stream's lane or replica died after chunks were consumed.

    Never retried by the router: the consumed prefix was already
    delivered (and possibly acted on), so a replay would duplicate it.
    ``chunks_consumed`` tells the application layer where the stream
    stopped."""

    def __init__(self, message: str, chunks_consumed: int = 0):
        super().__init__(message)
        self.chunks_consumed = chunks_consumed


# --------------------------------------------------------------- SSE frames
#: terminal SSE frame (the OpenAI-style end-of-stream marker)
SSE_DONE = b"data: [DONE]\n\n"


def sse_event(data, event: str | None = None) -> bytes:
    """One Server-Sent-Events frame: ``data:`` JSON-encoded unless the
    payload is already a string. Multi-line payloads are split into one
    ``data:`` line each per the SSE spec."""
    body = data if isinstance(data, str) else json.dumps(data)
    lines = body.split("\n")
    head = f"event: {event}\n" if event else ""
    return (head + "".join(f"data: {ln}\n" for ln in lines) + "\n").encode()


class ServeStream:
    """Caller-facing handle for one streaming serve request.

    Wraps the router's chunk generator (``route_stream_chunks``) with
    the two call-site shapes handles support everywhere else:

    - on the core loop (proxies, composed deployments):
      ``async for chunk in stream`` / ``await stream.aclose()``
    - from the driver or a plain thread: ``for chunk in stream`` /
      ``stream.close()`` — each item bridges through
      ``run_coroutine_threadsafe`` like ``route_sync`` does.

    Dropping the stream early (``close``, ``break`` + ``close``, or GC
    of the proxies' response task) cancels mid-stream: the worker pump
    stops, the replica's wrapper closes the user generator
    (``GeneratorExit`` → the LLM engine frees the request's decode slot
    and KV pages), and late shm chunks free instead of leaking."""

    #: max chunks pulled across the thread bridge per hop. Bounds driver
    #: memory for a producer that is much faster than the consumer.
    BRIDGE_BATCH = 64

    def __init__(self, agen, core=None):
        self._agen = agen
        self._core = core
        self._closed = False
        self.chunks = 0  # consumed so far (mirrors StreamBrokenError's)
        # sync-bridge state: chunks already pulled to the driver side, a
        # loop-side __anext__ still in flight, and the stream's terminal
        # (exhausted / typed error) observed while items were buffered.
        self._buf = collections.deque()
        self._pending = None
        self._exhausted = False
        self._err = None
        self._hops = 0  # bridge round-trips (batch amortization stat)

    # ------------------------------------------------------------ async API
    def __aiter__(self):
        return self

    async def __anext__(self):
        item = await self._agen.__anext__()
        self.chunks += 1
        return item

    async def aclose(self) -> None:
        self._closed = True
        await self._close_bridge()

    # ------------------------------------------------- sync (driver) bridge
    def _run(self, coro, timeout: float = 300.0):
        core = self._core
        if core is None:
            from ray_tpu_torch.core.api import get_core

            core = self._core = get_core()
        return asyncio.run_coroutine_threadsafe(
            coro, core.loop).result(timeout)

    async def _next_batch(self):
        """One bridge hop, as many chunks as are already queued.

        Awaits the next item, then keeps collecting while further items
        resolve without blocking (the sink already has them buffered).
        A per-item ``run_coroutine_threadsafe`` round-trip costs
        hundreds of µs in thread wakeups; draining the ready backlog per
        hop amortizes that for fast producers while a slow stream still
        sees each chunk the moment it lands (the first await blocks on
        it directly). A terminal seen mid-drain is remembered so
        buffered chunks are delivered in order before it surfaces."""
        items = []
        task = self._pending
        self._pending = None
        while True:
            if task is None:
                task = asyncio.ensure_future(self._agen.__anext__())
            try:
                items.append(await task)
            except StopAsyncIteration:
                self._exhausted = True
                return items
            except BaseException as e:
                self._exhausted = True
                self._err = e
                return items
            task = None
            if len(items) >= self.BRIDGE_BATCH:
                return items
            nxt = asyncio.ensure_future(self._agen.__anext__())
            # a queued chunk resolves within a couple of loop passes
            # (generator resume -> queue get); if it hasn't, the
            # producer is genuinely behind — park the task and return
            # what we have rather than stalling the consumer on it.
            for _ in range(3):
                await asyncio.sleep(0)
                if nxt.done():
                    break
            if not nxt.done():
                self._pending = nxt
                return items
            task = nxt

    def __iter__(self):
        return self

    def __next__(self):
        while not self._buf:
            if self._exhausted:
                if self._err is not None:
                    err, self._err = self._err, None
                    raise err
                raise StopIteration
            self._hops += 1
            self._buf.extend(self._run(self._next_batch()))
        self.chunks += 1
        return self._buf.popleft()

    async def _close_bridge(self):
        task, self._pending = self._pending, None
        if task is not None:
            task.cancel()
            try:
                await task
            except BaseException:  # raylint: disable=RT012 — draining the cancelled parked step; aclose below reports real failures
                pass
        await self._agen.aclose()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._run(self._close_bridge(), timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
