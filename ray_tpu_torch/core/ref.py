"""ObjectRef and user-facing error types.

Equivalent of the reference's ObjectRef + error taxonomy
(ref: python/ray/_raylet.pyx ObjectRef, python/ray/exceptions.py).
An ObjectRef carries its owner's RPC address — ownership-based object
resolution (ref: ownership_object_directory.cc): whoever created the object
serves its metadata and small values.
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.utils.ids import ActorID, ObjectID, TaskID


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ray.get (ref: RayTaskError)."""

    def __init__(self, message: str, cause_repr: str = "", traceback_str: str = ""):
        super().__init__(message)
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str

    def __str__(self):
        base = super().__str__()
        if self.traceback_str:
            return f"{base}\n\n--- remote traceback ---\n{self.traceback_str}"
        return base


class ActorError(RayTpuError):
    """The actor died before/while executing this call (ref: RayActorError)."""


class ActorUnavailableError(ActorError):
    pass


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ray.cancel (ref: TaskCancelledError)."""


class WorkerCrashedError(TaskError):
    def __init__(self, message="worker process died while executing the task"):
        super().__init__(message)


class ObjectLostError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ConfigurationError(RayTpuError):
    """The cluster cannot run this task as configured (e.g. a cpp task with
    no RT_CPP_WORKER binary). Never transient: retrying cannot succeed, so
    the lease-failure breaker fails pending tasks on it immediately."""


class SchedulingError(ConfigurationError):
    """No node can satisfy the task's scheduling strategy (hard node
    affinity to a dead node, hard labels nothing matches). Fails fast
    like ConfigurationError rather than parking forever (deliberate
    deviation from the reference's wait-for-a-matching-node)."""


class ObjectRef:
    """Future-like handle to a (possibly pending) remote object."""

    __slots__ = ("id", "owner_address", "_core", "_borrowed", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_address: tuple[str, int] | None = None,
                 _core=None, _borrowed: bool = False):
        self.id = object_id
        self.owner_address = owner_address
        self._core = _core  # owner: enables GC; borrower: enables unborrow
        self._borrowed = _borrowed

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def task_id(self) -> TaskID:
        return self.id.task_id()

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __reduce__(self):
        # Borrower protocol (ref: reference_count.h:72): the sender notes
        # the shipment (owner defers freeing while refs are in flight) and
        # the receiver registers itself as a borrower at unpickle time.
        core = self._core
        if core is None:
            from ray_tpu_torch.core import api

            core = api._core
        if core is not None:
            try:
                # payload-embedded ref: the recipient rehydrates it as an
                # ObjectRef and registers a borrow — the owner holds the
                # object on the long no-borrow leash until that lands
                core.note_ref_shipped(self.id, self, expect_borrow=True)
            except Exception:  # raylint: disable=RT012 — __reduce__ during teardown must never raise
                pass
        return (_rebuild_borrowed_ref, (self.id, self.owner_address))

    def __del__(self):
        core = self._core
        if core is not None:
            try:
                if self._borrowed:
                    core.on_borrowed_ref_deleted(self.id, self.owner_address)
                else:
                    core.on_owned_ref_deleted(self.id)
            except Exception:  # raylint: disable=RT012 — __del__ may run at interpreter exit
                pass

    # await support inside async actors
    def __await__(self):
        from ray_tpu_torch.core import api

        async def _get():
            # completion fast lane: an already-resolved ref (ready
            # memory-store entry, sealed local shm object) returns
            # without entering the async get machinery at all
            core = self._core or api._core
            if core is not None:
                hit = core.get_local_prepass([self]).get(self.id)
                if hit is not None:
                    if hit[0] == "e":
                        raise hit[1]
                    return hit[1]
            return await api._async_get(self)

        return _get().__await__()


def _rebuild_borrowed_ref(object_id: ObjectID, owner_address):
    """Unpickle hook: register this process as a borrower with the owner
    (ref: borrower registration in reference_count.cc). On the owner's own
    process the ref resolves back to an owned handle."""
    from ray_tpu_torch.core import api

    core = api._core
    if core is None:
        return ObjectRef(object_id, owner_address)
    if owner_address is not None and tuple(owner_address) == core.address:
        core.on_owned_ref_created(object_id)
        return ObjectRef(object_id, owner_address, _core=core)
    core.on_borrowed_ref_created(object_id, owner_address)
    return ObjectRef(object_id, owner_address, _core=core, _borrowed=True)


class ObjectRefGenerator:
    """Iterator over the ObjectRefs a streaming task yields one by one
    (ref: python/ray/_raylet.pyx:282 ObjectRefGenerator; items are reported
    back to the owner as they are produced, core_worker.proto:498
    ReportGeneratorItemReturns). Works as a sync iterator on driver
    threads and an async iterator inside async actors."""

    def __init__(self, task_id: TaskID, core):
        self._task_id = task_id
        self._core = core

    # ------------------------------------------------------------------ sync
    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        ref = self._core.gen_next_sync(self._task_id)
        if ref is None:
            raise StopIteration
        return ref

    # ----------------------------------------------------------------- async
    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        ref = await self._core.gen_next(self._task_id)
        if ref is None:
            raise StopAsyncIteration
        return ref

    def completed(self) -> bool:
        return self._core.gen_completed(self._task_id)

    def __del__(self):
        core = self._core
        if core is not None:
            try:
                core.gen_release(self._task_id)
            except Exception:  # raylint: disable=RT012 — __del__ may run at interpreter exit
                pass


class ActorHandle:
    """Typed proxy for remote actor method calls; see core_client.submit_actor_task."""

    def __init__(self, actor_id: ActorID, core=None, method_names: tuple = (),
                 options: dict | None = None):
        self._actor_id = actor_id
        self._core = core
        self._method_names = method_names
        self._options = options or {}
        # owner-local handle refcount (core_client autokill): only
        # handles of unnamed actors the creating driver enrolled count;
        # at zero the core kills the actor so its lease returns
        self._counted = False
        if core is not None:
            try:
                self._counted = core.note_actor_handle_created(actor_id)
            except AttributeError:
                pass

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        num_returns = self._options.get("method_num_returns", {}).get(name)
        m = ActorMethod(self, name, num_returns=num_returns)
        # cache on the instance: the next ``handle.method`` hits plain
        # attribute lookup and skips both __getattr__ and the ActorMethod
        # rebuild — the actor-call analogue of the submit template. NOT
        # serialized (__reduce__ rebuilds from ids alone).
        self.__dict__[name] = m
        return m

    def __reduce__(self):
        if self._counted:
            try:
                # a shipped handle may outlive every local one: the
                # actor is permanently exempt from autokill
                self._core.note_actor_handle_shipped(self._actor_id)
            except Exception:  # raylint: disable=RT012 — __reduce__ during teardown must never raise
                pass
        return (_rebuild_actor_handle, (self._actor_id, self._method_names, self._options))

    def __del__(self):
        if self._counted:
            try:
                self._core.note_actor_handle_dropped(self._actor_id)
            except Exception:  # raylint: disable=RT012 — __del__ may run at interpreter exit
                pass

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"


class ActorMethod:
    def __init__(self, handle: ActorHandle, name: str, num_returns: int | None = None,
                 concurrency_group: str | None = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group
        # frozen per-(handle, method) submission template
        # (core_client.ActorCallTemplate): method-key bytes + options
        # eligibility + lane binding resolved once at the first call —
        # the actor twin of PR 2's SubmitTemplate. ActorMethods are
        # cached on the handle, so the template survives across calls.
        self._ftmpl = None

    def __getstate__(self):
        # the template pins the driver's CoreClient and lane: never ship
        # it with a method handle (it rebuilds wherever the method lands)
        state = self.__dict__.copy()
        state["_ftmpl"] = None
        return state

    def options(self, num_returns: int | None = None,
                concurrency_group: str | None = None, **kw):
        return ActorMethod(
            self._handle, self._name,
            self._num_returns if num_returns is None else num_returns,
            concurrency_group or self._concurrency_group)

    def remote(self, *args, **kwargs) -> Any:
        core = self._handle._core
        if core is None:
            from ray_tpu_torch.core import api

            # backfill a deserialized handle once: later calls (and later
            # methods of the same handle) skip the lookup
            core = self._handle._core = api.get_core()
        tmpl = self._ftmpl
        if tmpl is None or tmpl.core is not core:
            tmpl = self._ftmpl = core.actor_call_template(
                self._handle.actor_id, self._name,
                self._num_returns or 1, self._concurrency_group)
        return core.submit_actor_task(
            self._handle, self._name, args, kwargs,
            num_returns=self._num_returns or 1,
            concurrency_group=self._concurrency_group,
            _tmpl=tmpl,
        )

    def bind(self, *args) -> Any:
        """Author a compiled-graph node for this method
        (ref: dag/dag_node.py bind API)."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args)


def _rebuild_actor_handle(actor_id, method_names, options):
    return ActorHandle(actor_id, core=None, method_names=method_names, options=options)
