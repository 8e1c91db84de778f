"""Cgroup manager: per-worker memory isolation.

The reference's "physical execution mode" (ref: src/ray/common/cgroup/
cgroup_manager.h, cgroup_setup.h, README.md layout
/sys/fs/cgroup/ray_node_<id>/application) puts each worker in a cgroup so
a task's memory cap is enforced by the kernel, not just advised by the
memory monitor. Same shape here:

    rt_node_<id>/              node root
        application/           all workers (leaf cgroups per worker)
            w_<worker_id>/     memory.max = the lease's "memory" resource

Drivers: cgroup v2 (unified hierarchy), cgroup v1 (memory controller),
and a Fake driver recording operations for tests (ref:
fake_cgroup_setup.h). Real kernels need write access to the hierarchy;
when unavailable the manager reports unsupported and the raylet skips
isolation (advisory memory monitor still runs).
"""

from __future__ import annotations

import os


class CgroupError(Exception):
    pass


class CgroupV2Driver:
    """Unified hierarchy: /sys/fs/cgroup with cgroup.controllers present."""

    def __init__(self, base: str = "/sys/fs/cgroup"):
        self.base = base

    def supported(self) -> bool:
        return (
            os.path.isfile(os.path.join(self.base, "cgroup.controllers"))
            and os.access(self.base, os.W_OK)
        )

    def create(self, path: str, mem_limit: int | None = None) -> None:
        full = os.path.join(self.base, path)
        os.makedirs(full, exist_ok=True)
        # v2: a child only gets a memory.max file if its PARENT delegates
        # the controller. Never write the group's own subtree_control —
        # that would trip the no-internal-process rule for leaves.
        parent = os.path.dirname(full) or self.base
        try:
            with open(os.path.join(parent, "cgroup.subtree_control"), "w") as f:
                f.write("+memory")
        except OSError:
            pass  # root policy may refuse: delegation is best-effort
        if mem_limit is not None:
            self.set_limit(path, mem_limit)

    def set_limit(self, path: str, mem_limit: int | None) -> None:
        value = "max" if mem_limit is None else str(int(mem_limit))
        with open(os.path.join(self.base, path, "memory.max"), "w") as f:
            f.write(value)

    def add_pid(self, path: str, pid: int) -> None:
        with open(os.path.join(self.base, path, "cgroup.procs"), "w") as f:
            f.write(str(pid))

    def remove(self, path: str) -> bool:
        full = os.path.join(self.base, path)
        try:
            os.rmdir(full)
            return True
        except FileNotFoundError:
            return True
        except OSError:
            return not os.path.isdir(full)  # EBUSY: procs still exiting

    def current_usage(self, path: str) -> int | None:
        try:
            with open(os.path.join(self.base, path, "memory.current")) as f:
                return int(f.read())
        except OSError:
            return None


class CgroupV1Driver:
    """Legacy split hierarchy: memory controller at /sys/fs/cgroup/memory."""

    def __init__(self, base: str = "/sys/fs/cgroup/memory"):
        self.base = base

    def supported(self) -> bool:
        return (
            os.path.isfile(os.path.join(self.base, "memory.limit_in_bytes"))
            and os.access(self.base, os.W_OK)
        )

    def create(self, path: str, mem_limit: int | None = None) -> None:
        full = os.path.join(self.base, path)
        os.makedirs(full, exist_ok=True)
        if mem_limit is not None:
            self.set_limit(path, mem_limit)

    def set_limit(self, path: str, mem_limit: int | None) -> None:
        value = "-1" if mem_limit is None else str(int(mem_limit))
        with open(os.path.join(self.base, path, "memory.limit_in_bytes"), "w") as f:
            f.write(value)

    def add_pid(self, path: str, pid: int) -> None:
        with open(os.path.join(self.base, path, "cgroup.procs"), "w") as f:
            f.write(str(pid))

    def remove(self, path: str) -> bool:
        full = os.path.join(self.base, path)
        try:
            os.rmdir(full)
            return True
        except FileNotFoundError:
            return True
        except OSError:
            return not os.path.isdir(full)

    def current_usage(self, path: str) -> int | None:
        try:
            with open(os.path.join(self.base, path,
                                   "memory.usage_in_bytes")) as f:
                return int(f.read())
        except OSError:
            return None


class FakeCgroupDriver:
    """In-memory driver for tests (ref: fake_cgroup_setup.h): records every
    create/add_pid/remove so assertions can check the lifecycle without a
    writable kernel hierarchy."""

    def __init__(self):
        self.cgroups: dict[str, dict] = {}  # path -> {"limit":, "pids": set}
        self.removed: list[str] = []

    def supported(self) -> bool:
        return True

    def create(self, path: str, mem_limit: int | None = None) -> None:
        self.cgroups.setdefault(path, {"limit": None, "pids": set()})
        if mem_limit is not None:
            self.cgroups[path]["limit"] = mem_limit

    def set_limit(self, path: str, mem_limit: int | None) -> None:
        if path not in self.cgroups:
            raise CgroupError(f"no cgroup {path}")
        self.cgroups[path]["limit"] = mem_limit

    def add_pid(self, path: str, pid: int) -> None:
        if path not in self.cgroups:
            raise CgroupError(f"no cgroup {path}")
        self.cgroups[path]["pids"].add(pid)

    def remove(self, path: str) -> bool:
        self.cgroups.pop(path, None)
        self.removed.append(path)
        return True

    def current_usage(self, path: str) -> int | None:
        return 0 if path in self.cgroups else None


def detect_driver():
    """Best available real driver, or None (isolation unsupported)."""
    for driver in (CgroupV2Driver(), CgroupV1Driver()):
        if driver.supported():
            return driver
    return None


class CgroupManager:
    """Node-scoped cgroup tree with per-worker leaves.

    Created by the raylet when worker isolation is enabled; the "memory"
    resource on a lease becomes the worker's kernel memory cap (ref:
    cgroup_manager.h per-task memory caps).
    """

    def __init__(self, node_id_hex: str, driver=None):
        self.driver = driver
        self.root = f"rt_node_{node_id_hex[:12]}"
        self.app = f"{self.root}/application"
        self._workers: dict[str, str] = {}  # worker_id -> leaf path
        if self.driver is not None:
            try:
                self.driver.create(self.root, None)
                self.driver.create(self.app, None)
            except (OSError, CgroupError):
                # detect_driver's W_OK probe can pass in containers where
                # mkdir is still refused: degrade to advisory-only instead
                # of failing raylet startup
                self.driver = None

    @property
    def enabled(self) -> bool:
        return self.driver is not None

    def isolate_worker(self, worker_id_hex: str, pid: int,
                       mem_limit: int | None) -> bool:
        """Place a worker in its leaf cgroup with an optional memory cap."""
        if not self.enabled:
            return False
        leaf = f"{self.app}/w_{worker_id_hex[:12]}"
        try:
            self.driver.create(leaf, mem_limit)
            self.driver.add_pid(leaf, pid)
        except (OSError, CgroupError):
            self.driver.remove(leaf)  # partial create must not leak the dir
            return False
        self._workers[worker_id_hex] = leaf
        return True

    def set_limit(self, worker_id_hex: str, mem_limit: int | None) -> bool:
        """Update (or with None, RESET) a worker's memory cap — a recycled
        worker must not inherit the previous lease's limit."""
        leaf = self._workers.get(worker_id_hex)
        if leaf is None or not self.enabled:
            return False
        try:
            self.driver.set_limit(leaf, mem_limit)
        except (OSError, CgroupError):
            return False
        return True

    def release_worker(self, worker_id_hex: str) -> None:
        leaf = self._workers.get(worker_id_hex)
        if leaf is None:
            return
        if not self.enabled or self.driver.remove(leaf):
            self._workers.pop(worker_id_hex, None)
        # else: leaf still busy (proc exiting); kept for a later retry

    def worker_usage(self, worker_id_hex: str) -> int | None:
        leaf = self._workers.get(worker_id_hex)
        if leaf is None or not self.enabled:
            return None
        return self.driver.current_usage(leaf)

    def teardown(self) -> bool:
        """Remove all leaves + the node tree; False if anything is still
        busy (caller may retry after the owning processes exit)."""
        if not self.enabled:
            return True
        for wid in list(self._workers):
            self.release_worker(wid)
        ok = not self._workers
        ok = self.driver.remove(self.app) and ok
        return self.driver.remove(self.root) and ok
