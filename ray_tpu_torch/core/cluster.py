"""Multi-node-in-one-machine cluster harness.

Equivalent of the reference's `ray.cluster_utils.Cluster`
(ref: python/ray/cluster_utils.py:135): a real GCS plus N real raylets —
each with its own shm object store, resource ledger, and worker pool of
real subprocesses — so scheduling, spillback, object transfer and failure
paths are exercised without multiple machines. GCS and raylets run on one
background event loop; workers are real OS processes.
"""

from __future__ import annotations

import asyncio
import logging

from ray_tpu_torch.core.gcs import GcsServer
from ray_tpu_torch.core.raylet import Raylet
from ray_tpu_torch.utils import rpc

_log = logging.getLogger(__name__)


class Cluster:
    def __init__(self, io: rpc.EventLoopThread | None = None, session: str | None = None):
        import os
        import time

        self._own_io = io is None
        self.io = io or rpc.EventLoopThread()
        self.session = session or f"c{os.getpid()}_{time.monotonic_ns() % 1_000_000}"
        self.gcs = GcsServer()
        self.gcs_address = self.io.run(self.gcs.start())
        self.raylets: list[Raylet] = []
        # crash-safe: unlink shm arenas even if the driver dies mid-test
        import atexit

        atexit.register(self._cleanup_stores)

    def _cleanup_stores(self):
        for raylet in self.raylets:
            try:
                raylet.store.destroy()
            except Exception:  # raylint: disable=RT012 — atexit hook: nowhere to report
                pass

    def add_node(
        self,
        num_cpus: float | None = None,
        resources: dict[str, float] | None = None,
        object_store_memory: int | None = None,
        labels: dict[str, str] | None = None,
    ) -> Raylet:
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        res.setdefault("CPU", 4.0)

        async def _add():
            raylet = Raylet(
                self.gcs_address,
                resources=res,
                store_capacity=object_store_memory,
                labels=labels,
                session=f"{self.session}_{len(self.raylets)}",
            )
            await raylet.start()
            return raylet

        raylet = self.io.run(_add())
        self.raylets.append(raylet)
        return raylet

    def remove_node(self, raylet: Raylet) -> None:
        """Gracefully stop a node (drains leases, says goodbye)."""
        self.raylets.remove(raylet)
        self.io.run(raylet.stop())

    def kill_node(self, raylet: Raylet) -> None:
        """Hard-kill a node (chaos testing; ref: test_utils.py:1419
        ResourceKiller): workers SIGKILLed, no lease returns, no GCS
        goodbye — failure is discovered, not announced."""
        self.raylets.remove(raylet)
        self.io.run(raylet.kill())

    def shutdown(self) -> None:
        for raylet in list(self.raylets):
            try:
                self.io.run(raylet.stop())
            except Exception:
                _log.debug("raylet stop failed", exc_info=True)
        self.raylets.clear()
        try:
            self.io.run(self.gcs.stop())
        except Exception:
            _log.debug("GCS stop failed", exc_info=True)
        if self._own_io:
            self.io.stop()
