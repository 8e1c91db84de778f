"""Binary IDs for jobs, tasks, actors, objects and nodes.

Mirrors the reference's ID scheme (ref: src/ray/common/id.h): fixed-size binary
ids; an ObjectID embeds the id of the task that created it plus a return-index,
so ownership (which worker's memory store owns the value) is derivable from the
id itself — the property the reference's ownership-based object directory
relies on (ref: src/ray/object_manager/ownership_object_directory.cc).
"""

from __future__ import annotations

import itertools
import os
import struct
import threading as _threading

_TASK_ID_SIZE = 16
_UNIQUE_ID_SIZE = 16
_OBJECT_INDEX_SIZE = 4
_OBJECT_ID_SIZE = _TASK_ID_SIZE + _OBJECT_INDEX_SIZE  # 20 bytes


class BaseID:
    SIZE = _UNIQUE_ID_SIZE
    __slots__ = ("_bytes", "_hash")

    def __init__(self, b: bytes):
        if len(b) != self.SIZE:
            raise ValueError(f"{type(self).__name__} needs {self.SIZE} bytes, got {len(b)}")
        self._bytes = bytes(b)
        # ids key nearly every hot-path dict (memory store, refcounts,
        # lineage): cache the hash instead of re-hashing 20 bytes per lookup
        self._hash = hash(self._bytes)

    @classmethod
    def generate(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:12]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE
    # Last id byte tags the task kind so owners can tell actor tasks apart
    # from normal tasks without per-task state (cancel semantics differ).
    _ACTOR_MARK = 0xA5

    # Normal task ids are a random per-process prefix + a counter: one
    # urandom syscall per process instead of one per task (ids are a
    # measurable slice of the submission hot path). itertools.count is the
    # counter because its __next__ is a single C step — generate() is
    # called concurrently from user and loop threads and a Python-level
    # read-modify-write would mint duplicate ids. The final byte is the
    # kind tag (never _ACTOR_MARK for normal tasks).
    _gen_prefix: bytes = b""
    _gen_counter = None
    _gen_lock = _threading.Lock()

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(job_id.binary() + b"\x00" * (cls.SIZE - JobID.SIZE))

    @classmethod
    def _generate_marked(cls, mark: bytes) -> "TaskID":
        # fork safety WITHOUT a per-call os.getpid(): that's a real
        # syscall (~30us under syscall-intercepting sandboxes) on the
        # submission hot path. _reset_task_prefix below invalidates the
        # prefix in fork children; fresh processes start invalidated.
        if cls._gen_counter is None:
            with cls._gen_lock:
                if cls._gen_counter is None:
                    # ONE urandom per process (double-checked init);
                    # per-call ids come from the counter below
                    cls._gen_prefix = os.urandom(cls.SIZE - 8)  # raylint: disable=RT021 -- init-once
                    cls._gen_counter = itertools.count()
        n = next(cls._gen_counter) % (1 << 56)
        return cls(cls._gen_prefix + n.to_bytes(7, "little") + mark)

    @classmethod
    def generate(cls):
        return cls._generate_marked(b"\x00")

    @classmethod
    def generate_actor(cls) -> "TaskID":
        # same prefix+counter scheme as generate() — a per-call
        # os.urandom(16) measured ~288us under the syscall-intercepting
        # sandbox, 60%+ of the whole actor submission hot path. The kind
        # tag in the final byte keeps actor ids disjoint from normal
        # task ids minted from the same prefix and counter.
        return cls._generate_marked(bytes((cls._ACTOR_MARK,)))

    def is_actor_task(self) -> bool:
        return self._bytes[-1] == self._ACTOR_MARK

    @classmethod
    def _reset_prefix(cls) -> None:
        with cls._gen_lock:
            cls._gen_prefix = b""
            cls._gen_counter = None


if hasattr(os, "register_at_fork"):  # a fork child must mint fresh ids
    os.register_at_fork(after_in_child=TaskID._reset_prefix)


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack("<I", index))

    @classmethod
    def from_random(cls) -> "ObjectID":
        # ``put()`` objects: owner task id + random index space (high bit set
        # to never collide with task returns). The task-id half rides the
        # prefix+counter scheme, not a per-call os.urandom(16) — the serve
        # router mints one of these per request (promise refs), and the
        # urandom syscall measured ~288us under the intercepting sandbox
        # (the same cost generate_actor shed in PR 8).
        return cls(TaskID.generate().binary() + struct.pack("<I", 1 << 31))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_TASK_ID_SIZE])

    def return_index(self) -> int:
        return struct.unpack("<I", self._bytes[_TASK_ID_SIZE:])[0]
