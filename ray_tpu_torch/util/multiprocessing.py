"""multiprocessing.Pool-compatible API over cluster tasks
(ref: python/ray/util/multiprocessing/pool.py — drop-in Pool so existing
multiprocessing code scales past one machine). The port's copy of
``ray_tpu/util/multiprocessing.py``, over ``ray_tpu_torch``'s
``remote``/``get``/``wait``: its tasks run on the host CPU and lease no
card.

    from ray_tpu_torch.util.multiprocessing import Pool
    with Pool() as p:
        print(p.map(f, range(100)))
"""

from __future__ import annotations

import os
from collections import deque
from itertools import islice
from typing import Callable, Iterable

import ray_tpu_torch


class AsyncResult:
    """multiprocessing.pool.AsyncResult shape over ObjectRefs."""

    def __init__(self, refs: list, single: bool, callback=None,
                 error_callback=None):
        self._refs = refs
        self._single = single
        self._callback = callback
        self._error_callback = error_callback
        self._delivered = False

    def get(self, timeout: float | None = None):
        try:
            values = ray_tpu_torch.get(self._refs, timeout=timeout)
        except Exception as e:
            if self._error_callback and not self._delivered:
                self._delivered = True
                self._error_callback(e)
            raise
        if self._callback and not self._delivered:
            self._delivered = True
            self._callback(values[0] if self._single else values)
        return values[0] if self._single else values

    def wait(self, timeout: float | None = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """Task-backed process pool. ``processes`` bounds concurrent in-flight
    tasks (default: cluster CPU count); initializer runs lazily inside each
    executing worker process."""

    def __init__(self, processes: int | None = None, initializer=None,
                 initargs: tuple = ()):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = int(ray_tpu_torch.cluster_resources().get("CPU", 0)) or \
                (os.cpu_count() or 1)
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._processes = processes
        self._closed = False
        pool_id = f"{os.getpid()}:{id(self)}"

        @ray_tpu_torch.remote
        def _run(fn, batch, _star=False, _pool_id=pool_id, _init=initializer,
                 _initargs=initargs):
            if _init is not None:
                # once per (worker process, pool): the marker lives on a
                # module every worker has imported
                import builtins

                done = getattr(builtins, "_rt_mp_inited", None)
                if done is None:
                    done = set()
                    builtins._rt_mp_inited = done
                if _pool_id not in done:
                    _init(*_initargs)
                    done.add(_pool_id)
            if _star:
                return [fn(*a) for a in batch]
            return [fn(a) for a in batch]

        self._run = _run

    # ------------------------------------------------------------- helpers
    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _auto_chunksize(self, n: int) -> int:
        return max(1, n // (self._processes * 4) or 1)

    def _chunks(self, iterable: Iterable, chunksize: int | None):
        items = list(iterable)
        if chunksize is None:
            chunksize = self._auto_chunksize(len(items))
        return [items[i:i + chunksize] for i in
                range(0, len(items), chunksize)] or [[]]

    # ----------------------------------------------------------------- api
    def apply(self, fn: Callable, args: tuple = (), kwds: dict | None = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: dict | None = None, callback=None,
                    error_callback=None) -> AsyncResult:
        self._check_open()
        kwds = kwds or {}

        @ray_tpu_torch.remote
        def _call(f, a, kw):
            return f(*a, **kw)

        return AsyncResult([_call.remote(fn, args, kwds)], single=True,
                           callback=callback, error_callback=error_callback)

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: int | None = None) -> list:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: int | None = None, callback=None,
                  error_callback=None) -> AsyncResult:
        self._check_open()
        chunks = self._chunks(iterable, chunksize)
        refs = [self._run.remote(fn, c) for c in chunks]
        return _FlattenResult(refs, callback=callback,
                              error_callback=error_callback)

    def starmap(self, fn: Callable, iterable: Iterable[tuple],
                chunksize: int | None = None) -> list:
        return self.starmap_async(fn, iterable, chunksize).get()

    def starmap_async(self, fn, iterable, chunksize=None, callback=None,
                      error_callback=None) -> AsyncResult:
        self._check_open()
        chunks = self._chunks([tuple(a) for a in iterable], chunksize)
        refs = [self._run.remote(fn, c, True) for c in chunks]
        return _FlattenResult(refs, callback=callback,
                              error_callback=error_callback)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int | None = None):
        # validate eagerly (stdlib parity: errors surface at the call
        # site, not at first iteration), then hand off to the generator
        self._check_open()
        if chunksize is None:
            try:
                chunksize = self._auto_chunksize(len(iterable))  # type: ignore[arg-type]
            except TypeError:
                chunksize = 16  # lazy iterable: no len() to size against
        elif chunksize < 1:
            raise ValueError(f"Chunksize must be 1+, not {chunksize}")
        return self._imap_gen(fn, iter(iterable), chunksize)

    def _imap_gen(self, fn: Callable, it, chunksize: int):
        # bounded submission window: a few chunks stay in flight ahead of
        # the consumer (workers pipeline) without ever materializing the
        # iterable, so unbounded generators stream; the per-ref get is
        # the ordered yield imap's contract requires
        depth = max(2, self._processes * 2)
        window: deque = deque()

        def submit_next() -> bool:
            chunk = list(islice(it, chunksize))
            if not chunk:
                return False
            window.append(self._run.remote(fn, chunk))
            return True

        for _ in range(depth):
            if not submit_next():
                break
        # if the consumer abandons the generator mid-stream, the <= depth
        # in-flight chunks finish in the background and their results and
        # errors are discarded — same contract as stdlib Pool.imap, and
        # deliberately non-blocking (draining here would stall a `break`
        # for up to a full chunk's runtime)
        while window:
            ref = window.popleft()
            submit_next()
            for v in ray_tpu_torch.get(ref):
                yield v

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int | None = None):
        self._check_open()
        pending = [self._run.remote(fn, c)
                   for c in self._chunks(iterable, chunksize)]
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for v in ray_tpu_torch.get(done[0]):
                yield v

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()


class _FlattenResult(AsyncResult):
    """AsyncResult over chunked map tasks: flattens chunk lists."""

    def __init__(self, refs, callback=None, error_callback=None):
        super().__init__(refs, single=False, callback=None,
                         error_callback=error_callback)
        self._flat_callback = callback

    def get(self, timeout: float | None = None):
        chunks = super().get(timeout)
        flat = [v for chunk in chunks for v in chunk]
        if self._flat_callback and not self._delivered:
            self._delivered = True
            self._flat_callback(flat)
        return flat
