"""The port's shm object store (``ray_tpu_torch.core.object_store`` over the
port's own ``_native`` library): cases of ``tests/test_object_store.py``.

The library is the port's build (``ray_tpu_torch/_native/build/``), never
the JAX package's, and its arenas are named ``/rtt_*``.
"""

import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse
from ray_tpu_torch import _native
from ray_tpu_torch.core.object_store import (
    ObjectStoreError,
    ObjectTimeoutError,
    SharedObjectStore,
)
from ray_tpu_torch.utils.ids import ObjectID

# slowest case ~5 s alone (test_cross_process_get, which forks a child)
_module_limit, _test_limit = time_limits(module_s=60, test_s=25)


@pytest.fixture
def store():
    name = f"/rtt_test_{os.getpid()}_{time.monotonic_ns()}"
    s = SharedObjectStore(name, capacity=64 * 1024 * 1024, create=True)
    yield s
    s.destroy()


def test_the_library_is_the_ports_own():
    path = _native.get_lib()._name
    assert os.path.dirname(path) == os.path.join(os.path.dirname(_native.__file__), "build")
    assert os.path.basename(path).startswith("libray_tpu_torch_native_")


@pytest.mark.parametrize("value", [{"a": 1, "b": [1, 2, 3], "s": "hello"}, 42, b"x" * 100],
                         ids=["dict", "int", "bytes"])
def test_put_get_roundtrip(store, value):
    oid = ObjectID.from_random()
    store.put(oid, value)
    assert store.get(oid) == value


def test_create_seal_get(store):
    """The two-phase write: create a buffer, fill it, seal; a reader gets
    the bytes, and a second create of the id is refused."""
    oid = ObjectID.from_random()
    buf = store.create(oid, 16)
    buf[:] = bytes(range(16))
    assert not store.contains(oid)  # unsealed objects are invisible
    store.seal(oid)
    assert bytes(store.get_buffer(oid)) == bytes(range(16))
    store.release(oid)
    with pytest.raises(ObjectStoreError):
        store.create(oid, 16)


def test_numpy_zero_copy(store):
    oid = ObjectID.from_random()
    arr = np.arange(1_000_000, dtype=np.float32)
    store.put(oid, arr)
    out = store.get(oid)
    np.testing.assert_array_equal(out, arr)
    assert not out.flags["OWNDATA"]  # aliases the shm mapping


def test_tensor_through_the_store(store):
    """A bfloat16 tensor is stored as its bits and read back as a copy."""
    oid = ObjectID.from_random()
    t = torch.randn(256, 64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    store.put(oid, t)
    out = store.get(oid)
    assert out.dtype == torch.bfloat16 and torch.equal(out, t)


def test_get_timeout(store):
    with pytest.raises(ObjectTimeoutError):
        store.get(ObjectID.from_random(), timeout_ms=50)


def _child_put(name, oid_bytes):
    s = SharedObjectStore(name)
    s.put(ObjectID(oid_bytes), {"from": "child", "pid": os.getpid()})
    s.close()


def test_cross_process_get(store):
    oid = ObjectID.from_random()
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=_child_put, args=(store._name, oid.binary()))
    p.start()
    value = store.get(oid, timeout_ms=30_000)  # blocks until the child seals
    p.join(timeout=30)
    assert not p.is_alive()
    assert value == {"from": "child", "pid": p.pid}
