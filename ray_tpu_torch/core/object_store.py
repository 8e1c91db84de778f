"""Python client for the C++ shared-memory object store.

Pairs the ctypes control path (create/seal/get/release with blocking waits in
native code) with an mmap of the same /dev/shm arena for zero-copy data
access — the role plasma's client plays in the reference
(ref: src/ray/core_worker/store_provider/plasma_store_provider.h:93), minus
the socket protocol: every process maps the arena directly.
"""

from __future__ import annotations

import ctypes
import mmap
import os

from ray_tpu_torch._native import get_lib
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.utils.ids import ObjectID


class ObjectStoreError(Exception):
    pass


class ObjectStoreFullError(ObjectStoreError):
    pass


class ObjectTimeoutError(ObjectStoreError):
    pass


class ChannelClosedError(ObjectStoreError):
    pass


class ObjectEvictedError(ObjectStoreError):
    """The object was sealed, then LRU-evicted: it is gone from this node.
    Callers surface ObjectLostError / trigger lineage reconstruction instead
    of blocking forever on a get."""


_ERRNAMES = {
    -1: "not found",
    -2: "already exists",
    -3: "out of memory",
    -4: "timeout",
    -5: "bad state",
    -6: "system error",
    -7: "closed",
    -8: "evicted",
}


def _check(rc: int, what: str):
    if rc == 0:
        return
    if rc == -3:
        raise ObjectStoreFullError(what)
    if rc == -4:
        raise ObjectTimeoutError(what)
    if rc == -7:
        raise ChannelClosedError(what)
    if rc == -8:
        raise ObjectEvictedError(what)
    raise ObjectStoreError(f"{what}: {_ERRNAMES.get(rc, rc)}")


class _ReleaseGuard:
    """Releases an object-store reference when the last zero-copy view dies."""

    __slots__ = ("_store", "_oid", "armed", "_done")

    def __init__(self, store: "SharedObjectStore", oid: ObjectID):
        self._store = store
        self._oid = oid
        self.armed = False
        self._done = False

    def release_now(self):
        if not self._done:
            self._done = True
            try:
                if self._store._handle:
                    self._store.release(self._oid)
            except Exception:  # raylint: disable=RT012 — guard __del__ path must never raise
                pass

    def __del__(self):
        if self.armed:
            self.release_now()


class SharedObjectStore:
    """Per-node shm object store client (also the creator on the raylet)."""

    def __init__(self, name: str, capacity: int | None = None, create: bool = False):
        self._lib = get_lib()
        self._name = name
        if create:
            assert capacity is not None
            self._handle = self._lib.rt_store_create(name.encode(), capacity)
        else:
            self._handle = self._lib.rt_store_connect(name.encode())
        if not self._handle:
            raise ObjectStoreError(
                f"could not {'create' if create else 'connect to'} store {name}"
            )
        self._created = create
        # python-side counters the native header has no slot for (the
        # spill writer lives in this process, so per-process is exact)
        self.spill_failures = 0
        path = "/dev/shm/" + name.lstrip("/")
        self._file = open(path, "r+b")
        self._mmap = mmap.mmap(self._file.fileno(), 0)
        self._view = memoryview(self._mmap)

    # -- raw object API ------------------------------------------------------

    def create(self, object_id: ObjectID, size: int) -> memoryview:
        off = ctypes.c_uint64()
        rc = self._lib.rt_create(self._handle, object_id.binary(), size, ctypes.byref(off))
        _check(rc, f"create {object_id}")
        return self._view[off.value : off.value + size]

    def seal(self, object_id: ObjectID) -> None:
        if chaos.ENABLED:
            # "store.seal" fault point: an `error` action raises here as
            # an ObjectStoreError — exactly what a native seal failure
            # (chaos-armed or real) surfaces, so both travel one path
            try:
                chaos.point("store.seal", oid=object_id.hex())
            except chaos.ChaosError as e:
                raise ObjectStoreError(f"seal {object_id}: {e}") from e
        _check(self._lib.rt_seal(self._handle, object_id.binary()), f"seal {object_id}")

    def get_buffer(self, object_id: ObjectID, timeout_ms: int = -1) -> memoryview:
        """Blocking zero-copy view of a sealed object; takes a reference."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rt_get(
            self._handle, object_id.binary(), timeout_ms, ctypes.byref(off), ctypes.byref(size)
        )
        _check(rc, f"get {object_id}")
        return self._view[off.value : off.value + size.value]

    def contains(self, object_id: ObjectID) -> bool:
        return bool(self._lib.rt_contains(self._handle, object_id.binary()))

    def is_evicted(self, object_id: ObjectID) -> bool:
        """True if this id was sealed here and later LRU-evicted (tombstone)."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rt_get(
            self._handle, object_id.binary(), 0, ctypes.byref(off), ctypes.byref(size)
        )
        if rc == 0:  # present after all — drop the ref we just took
            self.release(object_id)
            return False
        return rc == -8

    def release(self, object_id: ObjectID) -> None:
        self._lib.rt_release(self._handle, object_id.binary())

    def delete(self, object_id: ObjectID) -> None:
        self._lib.rt_delete(self._handle, object_id.binary())

    @property
    def capacity(self) -> int:
        return self._lib.rt_store_capacity(self._handle)

    @property
    def bytes_in_use(self) -> int:
        return self._lib.rt_store_bytes_in_use(self._handle)

    # rt_store_stats field order (store.cc StoreStats)
    STAT_FIELDS = (
        "creates", "create_bytes", "seals", "gets", "get_waits", "get_lost",
        "releases", "deletes", "evictions", "evicted_bytes", "peak_bytes",
    )

    def stats(self) -> dict[str, int]:
        """Arena-wide counters from the shared header (store.cc
        StoreStats): every process mapping the arena reads the same
        numbers, so one metrics flush per node covers all clients."""
        out = (ctypes.c_uint64 * len(self.STAT_FIELDS))()
        n = self._lib.rt_store_stats(
            self._handle,
            ctypes.cast(out, ctypes.POINTER(ctypes.c_uint64)), len(out))
        d = {name: int(out[i]) for i, name in enumerate(self.STAT_FIELDS[:n])}
        d["bytes_in_use"] = int(self.bytes_in_use)
        d["capacity"] = int(self.capacity)
        d["spill_failures"] = int(self.spill_failures)
        return d

    def note_spill_failure(self) -> None:
        """Record one failed spill attempt (write error / chaos fault);
        surfaced through stats() so the backoff satellite is observable."""
        self.spill_failures += 1

    def list_spillable(self, max_count: int = 64) -> list[tuple[ObjectID, int]]:
        """Sealed, unreferenced objects in LRU order (spill candidates for
        the raylet's spill manager, ref: local_object_manager.h:42)."""
        ids = ctypes.create_string_buffer(20 * max_count)
        sizes = (ctypes.c_uint64 * max_count)()
        n = self._lib.rt_store_list_spillable(
            self._handle, ids,
            ctypes.cast(sizes, ctypes.POINTER(ctypes.c_uint64)), max_count)
        out = []
        for i in range(n):
            out.append((ObjectID(ids.raw[i * 20:(i + 1) * 20]), int(sizes[i])))
        return out

    # -- serialized object API ----------------------------------------------

    def put(self, object_id: ObjectID, value) -> int:
        """Serialize ``value`` directly into shm; returns stored size."""
        meta, buffers = serialization.dumps_with_buffers(value)
        size = serialization.total_size(meta, buffers)
        buf = self.create(object_id, size)
        serialization.pack_into(meta, buffers, buf)
        self.seal(object_id)
        return size

    def put_raw(self, object_id: ObjectID, payload) -> int:
        """Store pre-packed bytes (e.g. forwarded from another node)."""
        payload = memoryview(payload).cast("B")
        buf = self.create(object_id, payload.nbytes)
        buf[:] = payload
        self.seal(object_id)
        return payload.nbytes

    def get(self, object_id: ObjectID, timeout_ms: int = -1):
        """Deserialize a stored object.

        Zero-copy: array payloads alias the shm arena. The store reference
        taken by the underlying native get is tied to the deserialized views
        via a guard (see serialization._GuardedBuffer) and dropped when the
        last view is garbage-collected; values with no out-of-band buffers
        release the reference immediately.
        """
        buf = self.get_buffer(object_id, timeout_ms)
        guard = _ReleaseGuard(self, object_id)
        guard.armed = True
        try:
            value = serialization.unpack(buf, guard=guard)
        except Exception:
            guard.release_now()
            raise
        if not serialization.unpack_has_buffers(buf):
            guard.release_now()
        return value

    def try_get(self, object_id: ObjectID):
        """Non-blocking zero-copy read for the completion fast lane's
        caller-thread get: returns ``(value,)`` when the object is sealed
        locally, None when it is absent/pending/evicted — one native call,
        no contains()-then-get() race window."""
        try:
            return (self.get(object_id, timeout_ms=0),)
        except ObjectStoreError:
            return None

    # -- mutable channels (compiled-graph substrate) -------------------------

    def channel_create(self, object_id: ObjectID, size: int, num_readers: int) -> None:
        off = ctypes.c_uint64()
        rc = self._lib.rt_chan_create(
            self._handle, object_id.binary(), size, num_readers, ctypes.byref(off)
        )
        _check(rc, f"chan_create {object_id}")

    def channel_buffer(self, object_id: ObjectID) -> memoryview:
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rt_chan_data(
            self._handle, object_id.binary(), ctypes.byref(off), ctypes.byref(size)
        )
        _check(rc, f"chan_data {object_id}")
        return self._view[off.value : off.value + size.value]

    def channel_write_acquire(self, object_id: ObjectID, timeout_ms: int = -1) -> memoryview:
        rc = self._lib.rt_chan_write_acquire(self._handle, object_id.binary(), timeout_ms)
        _check(rc, f"chan_write_acquire {object_id}")
        return self.channel_buffer(object_id)

    def channel_write_release(self, object_id: ObjectID, payload_size: int = 0) -> None:
        rc = self._lib.rt_chan_write_release(self._handle, object_id.binary(), payload_size)
        _check(rc, f"chan_write_release {object_id}")

    def channel_read_acquire(
        self, object_id: ObjectID, last_version: int, timeout_ms: int = -1
    ) -> tuple[memoryview, int]:
        """Returns (payload_view, version); payload_view is sized to the
        writer's payload_size (or the whole buffer for size-0 writers)."""
        version = ctypes.c_uint64()
        payload = ctypes.c_uint64()
        rc = self._lib.rt_chan_read_acquire(
            self._handle,
            object_id.binary(),
            last_version,
            timeout_ms,
            ctypes.byref(version),
            ctypes.byref(payload),
        )
        _check(rc, f"chan_read_acquire {object_id}")
        buf = self.channel_buffer(object_id)
        if payload.value:
            buf = buf[: payload.value]
        return buf, version.value

    def channel_read_release(self, object_id: ObjectID) -> None:
        rc = self._lib.rt_chan_read_release(self._handle, object_id.binary())
        _check(rc, f"chan_read_release {object_id}")

    def channel_close(self, object_id: ObjectID) -> None:
        self._lib.rt_chan_close(self._handle, object_id.binary())

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        if self._handle:
            self._view.release()
            try:
                self._mmap.close()
            except BufferError:
                # zero-copy views handed out by get() still alias the mapping;
                # leave it to the process teardown to unmap.
                pass
            self._file.close()
            self._lib.rt_store_close(self._handle)
            self._handle = None

    def destroy(self) -> None:
        """Close and unlink the arena (creator only)."""
        name = self._name
        self.close()
        self._lib.rt_store_destroy(name.encode())

    def __del__(self):
        try:
            self.close()
        except Exception:  # raylint: disable=RT012 — __del__ may run at interpreter exit
            pass
