"""Model multiplexing: many models behind one deployment's replicas.

Equivalent of the reference multiplex surface (ref:
python/ray/serve/multiplex.py _ModelMultiplexWrapper + api.py
@serve.multiplexed / get_multiplexed_model_id): a replica lazily loads
models through a user loader into a bounded per-replica LRU; callers tag
requests with ``handle.options(multiplexed_model_id=...)`` and the
router prefers replicas that already hold that model (affinity), falling
back to power-of-two-choices — which is what makes the LRU hit rate high
enough to matter.

    @serve.deployment
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            return load_checkpoint(model_id)   # arbitrary object

        async def __call__(self, x):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return model(x)

    h = serve.run(Multi.bind())
    h.options(multiplexed_model_id="m1").remote(x)
"""

from __future__ import annotations

import collections
import contextvars
import inspect

_model_id_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")

_LRU_ATTR = "_serve_mux_models"


def get_multiplexed_model_id() -> str:
    """The model id the CURRENT request was tagged with (task-local)."""
    return _model_id_ctx.get()


def _set_request_model_id(model_id: str):
    return _model_id_ctx.set(model_id or "")


def loaded_model_ids(user_instance) -> list[str]:
    """Model ids currently resident on a replica's user instance."""
    lru = getattr(user_instance, _LRU_ATTR, None)
    return list(lru.keys()) if lru else []


def multiplexed(func=None, *, max_num_models_per_replica: int = 3):
    """Decorator for a replica method ``(self, model_id) -> model`` that
    turns it into an LRU-cached loader (ref: serve/api.py multiplexed).
    The wrapped method is always a coroutine function."""
    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def deco(fn):
        is_coro = inspect.iscoroutinefunction(fn)

        async def load(self, model_id: str):
            import asyncio

            if not isinstance(model_id, str) or not model_id:
                raise ValueError("multiplexed model_id must be a non-empty "
                                 f"string, got {model_id!r}")
            lru = self.__dict__.get(_LRU_ATTR)
            if lru is None:
                lru = collections.OrderedDict()
                setattr(self, _LRU_ATTR, lru)
            # per-model-id load lock: concurrent first requests must not
            # each run a multi-GB load and silently drop all but the last
            # instance (the reference serializes loads the same way)
            locks = self.__dict__.setdefault("_serve_mux_locks", {})
            lock = locks.setdefault(model_id, asyncio.Lock())
            async with lock:
                if model_id in lru:
                    lru.move_to_end(model_id)
                    return lru[model_id]
                while len(lru) >= max_num_models_per_replica:
                    _, evicted = lru.popitem(last=False)
                    unload = getattr(evicted, "__serve_unload__", None)
                    if callable(unload):
                        out = unload()
                        if inspect.isawaitable(out):
                            await out
                model = fn(self, model_id)
                if is_coro:
                    model = await model
                lru[model_id] = model
                locks.pop(model_id, None)  # resident: no lock needed now
                return model

        load.__name__ = fn.__name__
        load.__serve_multiplexed__ = True
        return load

    if func is not None:
        return deco(func)
    return deco
