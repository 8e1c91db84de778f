"""Raylet: per-node daemon — worker pool, local scheduler, object transfer.

Equivalent of the reference raylet (ref: src/ray/raylet/
node_manager.h:124): grants resource-backed worker leases
(node_manager.proto:413 RequestWorkerLease semantics, including spillback
replies), forks and pools language workers (worker_pool.h:231), accounts
placement-group bundles with prepare/commit/return (ref:
placement_group_resource_manager.h), pulls remote objects into the node's
shm store (pull_manager.h:49 / push_manager.h:28 — here a direct
fetch-from-holder transfer driven by the GCS object directory), and
heartbeats resource views to the GCS (the RaySyncer role, ray_syncer.h:83).

One raylet owns one shm object store arena; several raylets can run on one
machine as virtual nodes — the multi-node-in-one-process test strategy the
reference uses (ref: python/ray/cluster_utils.py:135).
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import logging
import os
import pickle
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field

from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager
from ray_tpu_torch.config import get_config
from ray_tpu_torch.core import policy
from ray_tpu_torch.core.object_store import ObjectStoreError, SharedObjectStore
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.utils import aio, metrics, rpc
from ray_tpu_torch.utils.ids import NodeID, ObjectID, WorkerID

log = logging.getLogger(__name__)

_GPU = GPUAcceleratorManager.get_resource_name()


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    proc: subprocess.Popen
    address: tuple[str, int] | None = None
    ready: asyncio.Event = field(default_factory=asyncio.Event)
    lease_id: int | None = None
    actor_id: bytes | None = None
    idle_since: float = 0.0
    language: str = "python"


@dataclass
class Lease:
    lease_id: int
    resources: dict[str, float]
    worker: WorkerHandle
    pg_key: tuple | None = None  # (pg_id, bundle_index) if inside a bundle
    owner_conn: object = None  # requester's connection: leases die with it
    gpu_ids: list | None = None  # card ids granted to this lease


class PullBackPressure(Exception):
    """A queued pull/restore was shed at its admission deadline. Typed so
    the client plane can surface a serve-level BackPressureError with a
    retry hint instead of an opaque pull failure."""

    def __init__(self, message: str, retry_after_s: float = 0.1):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class PullAdmission:
    """PullManager-shaped admission window (ref: pull_manager.h:49):
    bounds the BYTES of concurrent restores/pulls in flight — not the
    request count — against a fixed budget and live arena headroom.
    Excess requests park FIFO; a parked request past its deadline is shed
    with :class:`PullBackPressure`, so a steal/adopt burst back-pressures
    instead of OOMing the receiving arena mid-decode."""

    def __init__(self, raylet):
        self.raylet = raylet
        self.max_bytes = max(1, int(raylet.cfg.pull_max_bytes_in_flight))
        self.in_flight = 0
        self.admitted = 0
        self.shed = 0
        self._q: collections.deque = collections.deque()
        self._pumping = False

    def stats(self) -> dict:
        return {"in_flight_bytes": int(self.in_flight),
                "queued": len(self._q),
                "admitted": int(self.admitted), "shed": int(self.shed)}

    async def acquire(self, nbytes: int, deadline: float | None = None):
        """Admit ``nbytes`` of inbound transfer, parking FIFO until the
        window (and the arena) has room or ``deadline`` passes."""
        nbytes = max(1, int(nbytes))
        if deadline is None:
            deadline = (time.monotonic()
                        + self.raylet.cfg.pull_admission_timeout_s)
        if not self._q and self._try_admit(nbytes):
            return
        fut = asyncio.get_running_loop().create_future()
        self._q.append((nbytes, deadline, fut))
        if not self._pumping:
            self._pumping = True
            self.raylet._bg.spawn(self._pump_loop())
        await fut

    def release(self, nbytes: int):
        self.in_flight = max(0, self.in_flight - max(1, int(nbytes)))
        self._pump()

    def _retry_hint(self) -> float:
        queued = sum(n for n, _, _ in self._q)
        return min(2.0, max(0.05,
                            0.1 * (self.in_flight + queued) / self.max_bytes))

    def _try_admit(self, nbytes: int) -> bool:
        if self.in_flight + nbytes > self.max_bytes:
            # an object larger than the whole window still admits when
            # alone — the budget bounds concurrency, it must not strand
            # a single oversized pull forever
            if not (self.in_flight == 0 and nbytes > self.max_bytes):
                return False
        store, cfg = self.raylet.store, self.raylet.cfg
        if store is not None and cfg.object_spilling_threshold > 0:
            cap = max(1, store.capacity)
            used = store.bytes_in_use + self.in_flight
            if used + nbytes > cap:
                # truly would not fit: park until spill frees headroom
                self.raylet._bg.spawn(
                    self.raylet._spill_until_low_water(extra_need=nbytes))
                return False
            if used + nbytes > cfg.object_spilling_threshold * cap:
                # fits, but crosses the pressure line: admit and kick the
                # spiller so headroom recovers behind the transfer
                self.raylet._bg.spawn(
                    self.raylet._spill_until_low_water(extra_need=nbytes))
        self.in_flight += nbytes
        self.admitted += 1
        return True

    def _pump(self):
        now = time.monotonic()
        while self._q:
            nbytes, deadline, fut = self._q[0]
            if fut.done():
                self._q.popleft()
                continue
            if now >= deadline:
                self._q.popleft()
                self.shed += 1
                fut.set_exception(PullBackPressure(
                    f"pull admission shed at deadline ({self.in_flight}B in "
                    f"flight, window {self.max_bytes}B)",
                    retry_after_s=self._retry_hint()))
                continue
            if not self._try_admit(nbytes):
                return  # strict FIFO: a blocked head parks the queue
            self._q.popleft()
            fut.set_result(True)

    async def _pump_loop(self):
        # deadline sheds and arena-headroom recoveries need a clock even
        # when no release() fires; cheap poll only while anyone waits
        try:
            while self._q:
                self._pump()
                await asyncio.sleep(0.05)
        finally:
            self._pumping = False


# Fixed-point resource quantum (ref: src/ray/common/scheduling/
# fixed_point.h — 1/10000 granules). All ledger arithmetic is integral so
# allocate/free cycles of fractional demands (0.1 CPU x 10) can never
# drift a slot away through float error.
FP_ONE = 10_000


def _fp(v: float) -> int:
    return round(v * FP_ONE)


def _fp_dict(d: dict[str, float]) -> dict[str, int]:
    return {k: _fp(v) for k, v in d.items()}


def _unfp_dict(d: dict[str, int]) -> dict[str, float]:
    return {k: v / FP_ONE for k, v in d.items()}


class ResourceLedger:
    """Fractional resource accounting for one node, incl. PG bundles
    (ref: src/ray/common/scheduling/resource_instance_set.h semantics,
    simplified to totals — per-slot card instance tracking lives in the
    accelerator layer). Internally fixed-point; the dict[str, float] API
    converts at the boundary."""

    def __init__(self, total: dict[str, float]):
        self._total = _fp_dict(total)
        self._available = dict(self._total)
        # (pg_id, bundle_index) -> {"resources": ..., "available": ..., "committed": bool}
        self.bundles: dict[tuple, dict] = {}

    @property
    def total(self) -> dict[str, float]:
        return _unfp_dict(self._total)

    @property
    def available(self) -> dict[str, float]:
        return _unfp_dict(self._available)

    def fits(self, req: dict[str, float]) -> bool:
        return all(self._available.get(k, 0) >= _fp(v) for k, v in req.items())

    def allocate(self, req: dict[str, float]) -> bool:
        if not self.fits(req):
            return False
        for k, v in req.items():
            self._available[k] = self._available.get(k, 0) - _fp(v)
        return True

    def free(self, req: dict[str, float]) -> None:
        for k, v in req.items():
            cap = self._total.get(k, _fp(v))
            self._available[k] = min(self._available.get(k, 0) + _fp(v), cap)

    # -- placement group bundles ------------------------------------------
    def prepare_bundle(self, key: tuple, resources: dict[str, float]) -> bool:
        b = self.bundles.get(key)
        if b is not None:
            # 2PC retry over an already-held reservation: refresh the
            # lease stamp so the GC clock restarts with the new round
            b["prepared_at"] = time.monotonic()
            return True
        if not self.allocate(resources):
            return False
        self.bundles[key] = {
            "resources": _fp_dict(resources),
            "available": _fp_dict(resources),
            "committed": False,
            # prepared-but-uncommitted reservations carry a lease: if the
            # coordinating GCS dies between prepare and commit, the
            # raylet-side GC (Raylet._gc_stale_bundles) reclaims the
            # capacity after cfg.pg_bundle_lease_s instead of leaking it
            # forever
            "prepared_at": time.monotonic(),
        }
        return True

    def commit_bundle(self, key: tuple) -> bool:
        b = self.bundles.get(key)
        if b is None:
            return False
        b["committed"] = True
        return True

    def return_bundle(self, key: tuple) -> None:
        b = self.bundles.pop(key, None)
        if b is not None:
            self.free(_unfp_dict(b["resources"]))

    def bundle_allocate(self, key: tuple, req: dict[str, float]) -> bool:
        b = self.bundles.get(key)
        if b is None or not b["committed"]:
            return False
        if not all(b["available"].get(k, 0) >= _fp(v) for k, v in req.items()):
            return False
        for k, v in req.items():
            b["available"][k] -= _fp(v)
        return True

    def bundle_free(self, key: tuple, req: dict[str, float]) -> None:
        b = self.bundles.get(key)
        if b is None:
            return
        for k, v in req.items():
            cap = b["resources"].get(k, _fp(v))
            b["available"][k] = min(b["available"].get(k, 0) + _fp(v), cap)

    def held_bundles(self) -> list[dict]:
        """The wire shape bundle reservations travel in (register_node
        reports, rpc_list_bundles audits) — shared by the real raylet
        and the churn harness's SimRaylet so they can't drift."""
        return [
            {"pg_id": key[0], "bundle_index": key[1],
             "resources": _unfp_dict(b["resources"]),
             "committed": bool(b.get("committed"))}
            for key, b in self.bundles.items()
        ]

    def gc_stale_bundles(self, now: float, lease_s: float) -> list[tuple]:
        """Return (and free) prepared-but-never-committed reservations
        whose lease expired: the coordinating GCS died (or gave up)
        mid-2PC, so nothing will ever commit or return them. Returns the
        reclaimed keys."""
        if lease_s <= 0:
            return []
        stale = [key for key, b in self.bundles.items()
                 if not b.get("committed")
                 and now - b.get("prepared_at", now) > lease_s]
        for key in stale:
            self.return_bundle(key)
        return stale


class Raylet:
    def __init__(
        self,
        gcs_address: tuple[str, int],
        resources: dict[str, float] | None = None,
        store_capacity: int | None = None,
        host: str = "127.0.0.1",
        labels: dict[str, str] | None = None,
        session: str = "",
    ):
        self.cfg = get_config()
        self.node_id = NodeID.generate()
        self.gcs_address = gcs_address
        self.host = host
        self.labels = labels or {}
        # per-card instance tracking (ref: the reference's per-slot
        # resource_instance_set; cards are handed to leases by id so workers
        # can isolate via CUDA_VISIBLE_DEVICES): the ids this process sees,
        # else 0..n-1
        n_gpus = int((resources or {}).get(_GPU, 0))
        visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        self._gpu_ids_free: list[str] = (
            list(visible[:n_gpus]) if visible is not None and len(visible) >= n_gpus
            else [str(i) for i in range(n_gpus)])
        self._worker_gpus: dict = {}  # worker_id -> list[str]
        self._gpus_exiting = 0  # pinned workers whose cards await their exit
        self.session = session or f"s{os.getpid()}"

        if resources is None:
            resources = {"CPU": float(os.cpu_count() or 1)}
        resources.setdefault("node", 1.0)
        if "memory" not in resources:
            # advertise system memory (bytes) so memory-capped leases are
            # schedulable (ref: memory as a default node resource)
            try:
                from ray_tpu_torch.core.memory_monitor import read_system_memory

                resources["memory"] = float(read_system_memory()[1])
            except (OSError, ValueError):
                pass  # no /proc: memory simply isn't advertised
        self.ledger = ResourceLedger(resources)

        self.log_dir = os.path.join(
            self.cfg.temp_dir, f"session_{self.session}", "logs"
        )
        # "rtt_": apart from the JAX package's "/rt_" arenas on one host
        self.store_name = f"/rtt_{self.session}_{self.node_id.hex()[:8]}"
        self.store = SharedObjectStore(
            self.store_name,
            capacity=store_capacity or self.cfg.object_store_memory,
            create=True,
        )

        self.server = rpc.make_server(host, 0)
        self.server.add_routes(self)
        self.server.on_disconnect = self._on_client_disconnect
        self.gcs: rpc.Connection | None = None

        self._lease_ids = itertools.count(1)
        self._spread_rr = 0  # SPREAD strategy round-robin cursor
        self._view_versions = itertools.count(1)  # resource-view sync versions
        self.leases: dict[int, Lease] = {}
        self.idle_workers: list[WorkerHandle] = []
        self.all_workers: dict[WorkerID, WorkerHandle] = {}
        self._pending_lease_q: asyncio.Queue = asyncio.Queue()
        self._lease_waiters: list[tuple[dict, asyncio.Future, tuple | None]] = []
        # client-reported task backlog (work queued driver-side that is not
        # a parked lease request), summed into the heartbeat demand signal
        # (ref: autoscaler v2 resource-demand reporting, autoscaler.proto)
        # keyed by the live Connection OBJECT (identity hash): an id()
        # key could alias a new connection after CPython address reuse,
        # letting a dead client's stale backlog skew the autoscaler
        # demand signal. The dict entry pins the conn until disconnect
        # pops it, so aliasing is impossible.
        self._demand_reports: dict[object, int] = {}
        self.cluster_view: list[dict] = []
        # object spilling (ref: local_object_manager.h:42): sealed objects
        # move to disk under arena pressure and restore on demand
        self._spilled: dict[ObjectID, str] = {}  # oid -> file path
        self._spill_lock = asyncio.Lock()
        # Guards the _spilling_now/_freed_while_spilling handshake between
        # the loop thread (_drop_spill_file) and spill executor threads
        # (_spill_one's finally) — membership check + marker add must be
        # atomic or a freed-during-spill file leaks.
        self._spill_state_lock = threading.Lock()
        self._spilling_now: set[ObjectID] = set()
        self._freed_while_spilling: set[ObjectID] = set()
        self._spill_failed_at: dict[ObjectID, float] = {}
        self._spill_fail_n: dict[ObjectID, int] = {}  # consecutive failures
        # observability plane: object-store watermark history (the spill
        # trigger reads the recent PEAK, not one instant) plus lease
        # lifecycle cumulatives, both published as a hand-rolled snapshot
        # under ns="metrics" key raylet.<node> — never the process-global
        # registry, which an in-process topology shares with the driver
        # (same double-count hazard as the GCS's _trace_metrics_tick)
        from ray_tpu_torch.core.metrics_store import WatermarkTracker

        self._store_watermark = WatermarkTracker()
        self._lease_stats = {"granted": 0, "returned": 0,
                             "owner_disconnect": 0, "worker_death": 0}
        self._metrics_published_at = 0.0
        base = self.cfg.object_spilling_dir or os.path.join(
            self.cfg.temp_dir, f"session_{self.session}", "spill")
        self.spill_dir = os.path.join(base, self.node_id.hex()[:12])
        # cooperative spill: client processes that registered arena-owner
        # providers (prefix cache, shard plane, staging) by RPC address
        self._spill_providers: set[tuple] = set()
        self._provider_conns: dict[tuple, object] = {}
        # tier-1 peer serving: (conn, oid) -> open spill-file fd, so a
        # concurrent unlink can't tear a chunked transfer mid-stream
        self._spill_serves: dict[tuple, tuple] = {}
        # object transfer: coalesce duplicate pulls + byte-budget admission
        # of inbound restores/pulls (ref: pull_manager.h:49)
        self._active_pulls: dict[ObjectID, asyncio.Future] = {}
        self._pull_admission = PullAdmission(self)
        self._transfer_pins: dict[tuple, bool] = {}  # (conn, oid) -> pinned
        # node tunnel (core/tunnel.py): this raylet terminates its node's
        # end of every driver<->node tunnel and routes record frames to
        # local workers over cached raylet->worker connections
        self._tunnel_ids = itertools.count(1)
        self._tunnel_lanes: dict[int, dict] = {}   # lane -> routing entry
        self._tunnel_worker_conns: dict[WorkerID, object] = {}
        self._stopping = False
        self._bg = aio.TaskGroup()
        self.memory_monitor = None
        if self.cfg.memory_usage_threshold > 0:
            from ray_tpu_torch.core.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(
                self, self.cfg.memory_usage_threshold,
                self.cfg.memory_monitor_refresh_s,
            )
        # kernel-enforced per-worker memory caps ("physical execution
        # mode", ref: cgroup_manager.h); advisory monitor still runs when
        # the hierarchy isn't writable
        from ray_tpu_torch.core.cgroup import CgroupManager, detect_driver

        driver = detect_driver() if self.cfg.enable_worker_cgroups else None
        self.cgroups = CgroupManager(self.node_id.hex(), driver)

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> tuple[str, int]:
        addr = await self.server.start()
        self.gcs = await rpc.connect(*self.gcs_address, timeout=self.cfg.rpc_connect_timeout_s)
        self.gcs.on_message = self._on_gcs_push
        reply = await self.gcs.call(
            "register_node",
            {
                "node_id": self.node_id,
                "address": addr,
                "store_name": self.store_name,
                "resources": self.ledger.total,
                "labels": self.labels,
                "pid": os.getpid(),
                "bundles": self._held_bundles(),
            },
        )
        self.cluster_view = reply["cluster"]
        self._apply_bundle_reconciliation(reply)
        await self.gcs.call("subscribe", {"channel": "nodes"})
        self._bg.spawn(self._heartbeat_loop())
        self._bg.spawn(self._reaper_loop())
        if self.cfg.object_spilling_threshold > 0:
            self._bg.spawn(self._spill_monitor_loop())
        return addr

    async def _reconnect_gcs(self):
        """Dial a (possibly restarted) GCS and re-establish registration.
        The old connection closes only AFTER re-registration replaced its
        mapping server-side — closing first would read as a node death."""
        conn = await rpc.connect(*self.gcs_address, timeout=5)
        old = self.gcs
        self.gcs = conn
        self.gcs.on_message = self._on_gcs_push
        await self._reregister()
        if old is not None:
            try:
                await old.close()
            except (rpc.RpcError, OSError):
                pass  # replacing a dead connection: close is best-effort

    async def _reregister(self):
        # held bundles ride the registration so a restarted GCS can
        # reconcile its recovered pgs table against what this node's
        # ledger actually reserves (adopt committed bundles, order stale
        # ones returned)
        reply = await self.gcs.call(
            "register_node",
            {
                "node_id": self.node_id,
                "address": self.server.address,
                "store_name": self.store_name,
                "resources": self.ledger.total,
                "labels": self.labels,
                "pid": os.getpid(),
                "bundles": self._held_bundles(),
            },
        )
        self.cluster_view = reply["cluster"]
        self._apply_bundle_reconciliation(reply)
        await self.gcs.call("subscribe", {"channel": "nodes"})

    def _apply_bundle_reconciliation(self, reply: dict) -> None:
        stale = reply.get("return_bundles") or ()
        for key in stale:
            self.ledger.return_bundle(tuple(key))
        if stale:
            self._grant_waiters()

    def _on_gcs_push(self, msg):
        if msg.get("m") == "pubsub" and msg["p"]["channel"] == "nodes":
            event = msg["p"]["message"]
            if event.get("event") in ("added", "updated"):
                node = event["node"]
                for n in self.cluster_view:
                    if n["node_id"] != node["node_id"]:
                        continue
                    # versioned apply (ray_syncer.h:83): a reordered push
                    # must not roll the peer's view back to an older state
                    if node.get("view_version", 0) < n.get("view_version", 0):
                        return
                    break
                self.cluster_view = [
                    n for n in self.cluster_view if n["node_id"] != node["node_id"]
                ]
                self.cluster_view.append(node)
            elif event.get("event") == "removed":
                self.cluster_view = [
                    n for n in self.cluster_view if n["node_id"] != event["node_id"]
                ]

    async def _heartbeat_loop(self):
        failures = 0
        while not self._stopping:
            try:
                reply = await self.gcs.call(
                    "heartbeat",
                    {"node_id": self.node_id,
                     "resources_available": self.ledger.available,
                     # monotone view version: the GCS and peers drop
                     # reordered/stale reports (ray_syncer.h versioning)
                     "version": next(self._view_versions),
                     # demand signal for the autoscaler (ref: autoscaler v2
                     # resource-demand reporting): parked lease requests
                     # plus client-reported driver-side backlog
                     "queued_leases": len(self._lease_waiters)
                     + sum(self._demand_reports.values())},
                )
                failures = 0
                if isinstance(reply, dict) and not reply.get("ok", True):
                    # a restarted GCS doesn't know this node: re-register
                    # (the GCS-FT reconnection path, ref: gcs_client
                    # reconnection in accessor.h)
                    await self._reregister()
            except Exception:
                failures += 1
                if failures >= 3:
                    try:
                        await self._reconnect_gcs()
                        failures = 0
                    except Exception:
                        log.debug("GCS reconnect attempt failed",
                                  exc_info=True)
            await asyncio.sleep(self.cfg.health_check_period_s)

    async def _reaper_loop(self):
        """Reap dead worker processes; free leases; trim the idle pool;
        poll the memory monitor (OOM protection)."""
        last_mem_check = 0.0
        while not self._stopping:
            await asyncio.sleep(0.2)
            now = time.monotonic()
            if (self.memory_monitor is not None
                    and now - last_mem_check >= self.cfg.memory_monitor_refresh_s):
                last_mem_check = now
                try:
                    self.memory_monitor.maybe_kill()
                except Exception:
                    log.debug("memory monitor sweep failed", exc_info=True)
            self._gc_stale_bundles(now)
            for w in list(self.all_workers.values()):
                if w.proc.poll() is not None:
                    await self._on_worker_death(w)
            # trim idle workers beyond the warm minimum, counted per
            # language: an idle cpp worker must not occupy the python warm
            # slot (or vice versa) — pools are language-segregated
            keep: list[WorkerHandle] = []
            kept_by_lang: dict[str, int] = {}
            for w in self.idle_workers:
                if (
                    kept_by_lang.get(w.language, 0) >= self.cfg.min_idle_workers
                    and now - w.idle_since > self.cfg.worker_lease_timeout_s
                ):
                    w.proc.terminate()
                    self.all_workers.pop(w.worker_id, None)
                    self._release_cgroup_after_exit(w)
                    # trimmed workers never run their clean-exit recorder
                    # unlink and skip the death-report path: drop the file
                    # here or it leaks 256KB per trim for the session
                    from ray_tpu_torch.utils import recorder as _recorder

                    try:
                        os.unlink(_recorder.worker_recorder_path(
                            self.cfg.temp_dir, self.session,
                            w.worker_id.hex()))
                    except OSError:
                        pass
                else:
                    keep.append(w)
                    kept_by_lang[w.language] = kept_by_lang.get(w.language, 0) + 1
            self.idle_workers = keep

    def _release_cgroup_after_exit(self, w: WorkerHandle):
        """rmdir of a leaf fails EBUSY while the (just-terminated) process
        is still listed in cgroup.procs — release only after it exits."""
        if not self.cgroups.enabled:
            return

        async def waiter():
            deadline = time.monotonic() + 10.0
            while w.proc.poll() is None and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            self.cgroups.release_worker(w.worker_id.hex())

        self._bg.spawn(waiter(), asyncio.get_running_loop())

    async def _on_worker_death(self, w: WorkerHandle):
        self.all_workers.pop(w.worker_id, None)
        self._reap_tunnel_lanes_for_worker(w.worker_id)
        self.cgroups.release_worker(w.worker_id.hex())  # already exited
        if w in self.idle_workers:
            self.idle_workers.remove(w)
        if w.lease_id is not None and w.lease_id in self.leases:
            lease = self.leases.pop(w.lease_id)
            self._lease_stats["worker_death"] += 1
            self._free_lease_resources(lease)
            self._grant_waiters()
        await self._report_worker_death(w)
        if w.actor_id is not None:
            try:
                await self.gcs.call(
                    "report_actor_death",
                    {"actor_id": w.actor_id, "cause": f"worker pid={w.proc.pid} exited"},
                )
            except Exception:
                log.debug("actor death report failed", exc_info=True)

    async def _report_worker_death(self, w: WorkerHandle):
        """Postmortem: the victim's flight-recorder ring lives in a shm
        file under the session tree (utils/recorder.py), so it survives
        a SIGKILL — dump the last-N stage events plus exit context into
        the GCS death-report table (state.list_worker_deaths). A clean
        exit_worker unlinks its recorder first, so only real deaths
        carry events."""
        from ray_tpu_torch.utils import recorder as _recorder

        rec_path = _recorder.worker_recorder_path(
            self.cfg.temp_dir, self.session, w.worker_id.hex())
        events = _recorder.read_events(rec_path, last=64)
        try:
            os.unlink(rec_path)
        except OSError:
            pass
        returncode = w.proc.poll()
        report = {
            "worker_id": w.worker_id.hex(),
            "node_id": self.node_id.hex(),
            "pid": w.proc.pid,
            "ts": time.time(),
            "returncode": returncode,
            # negative returncode = killed by that signal (SIGKILL -> -9)
            "signal": -returncode if returncode and returncode < 0 else None,
            "actor_id": w.actor_id.hex()
                        if hasattr(w.actor_id, "hex") else w.actor_id,
            "leased": w.lease_id is not None,
            "recorder_events": events,
        }
        try:
            await self.gcs.call("kv_put", {
                "ns": "worker_deaths", "key": w.worker_id.hex(),
                "value": pickle.dumps(report)})
        except Exception:
            # GCS unreachable: the death still frees the lease above
            log.debug("worker death report failed", exc_info=True)

    # ---------------------------------------------------------- worker pool
    def _spawn_worker(self, language: str = "python") -> WorkerHandle:
        worker_id = WorkerID.generate()
        env = dict(os.environ)
        env.update(self.cfg.to_env())
        pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
        env.update(
            {
                "RT_WORKER_ID": worker_id.hex(),
                "RT_RAYLET_HOST": self.server.address[0],
                "RT_RAYLET_PORT": str(self.server.address[1]),
                "RT_GCS_HOST": self.gcs_address[0],
                "RT_GCS_PORT": str(self.gcs_address[1]),
                "RT_STORE_NAME": self.store_name,
                "RT_NODE_ID": self.node_id.hex(),
                "RT_SESSION": self.session,
            }
        )
        if language == "cpp":
            # C++ worker binary (rt_cpp_worker.cc runtime + user RT_REMOTE
            # functions), pointed at via RT_CPP_WORKER (ref: cpp/ worker API)
            binary = os.environ.get("RT_CPP_WORKER") or self.cfg.cpp_worker_binary
            if not binary:
                from ray_tpu_torch.core.ref import ConfigurationError

                raise ConfigurationError(
                    "cpp task submitted but no C++ worker binary configured "
                    "(set RT_CPP_WORKER=<path to binary built against "
                    "rt_cpp_api.h>)"
                )
            argv = [binary]
        else:
            argv = [sys.executable, "-m", "ray_tpu_torch.core.worker"]
        # per-worker log files (ref: the /tmp/ray/session_*/logs tree +
        # pipe_logger.h redirection): stdout/err land in the session log dir
        # and are served back via rpc_get_log / state.get_log
        out_f = err_f = None
        try:
            os.makedirs(self.log_dir, exist_ok=True)
            stem = os.path.join(self.log_dir, f"worker-{worker_id.hex()[:12]}")
            out_f = open(stem + ".out", "ab")
            err_f = open(stem + ".err", "ab")
        except OSError:
            if out_f is not None:
                out_f.close()  # .err open failed: don't leak the .out fd
            out_f = err_f = None  # unwritable tmp: inherit the raylet's fds
        proc = subprocess.Popen(argv, env=env, stdout=out_f, stderr=err_f)
        if out_f is not None:
            out_f.close()
            err_f.close()
        w = WorkerHandle(worker_id=worker_id, proc=proc, language=language)
        self.all_workers[worker_id] = w
        self.cgroups.isolate_worker(worker_id.hex(), proc.pid, None)
        return w

    async def _proxy_worker_call(self, p, method: str, payload: dict,
                                 timeout: float = 10.0):
        """Proxy an on-demand RPC to one of this node's workers (ref:
        dashboard reporter profiling endpoints). worker_id may be a hex
        prefix; unique match required. Degrades to None (like get_log)
        for missing/ambiguous ids, dead workers, and workers that don't
        speak the RPC (C++)."""
        prefix = (p.get("worker_id") or "")
        if not prefix:
            return None
        matches = [w for wid, w in self.all_workers.items()
                   if wid.hex().startswith(prefix)]
        if len(matches) != 1 or matches[0].address is None:
            return None
        try:
            wconn = await rpc.connect(*matches[0].address, timeout=5)
            try:
                return await wconn.call(method, payload, timeout=timeout)
            finally:
                await wconn.close()
        except Exception:
            return None

    async def rpc_dump_worker_stack(self, conn, p):
        return await self._proxy_worker_call(p, "dump_stack", {})

    async def rpc_heap_profile_worker(self, conn, p):
        """Proxy heap-profile control/snapshots to a worker (the memray /
        profile_manager.py:191 role; tracemalloc in-process)."""
        return await self._proxy_worker_call(
            p, "heap_profile",
            {k: p[k] for k in ("action", "top", "nframes") if k in p})

    async def rpc_cpu_profile_worker(self, conn, p):
        """Proxy a sampled CPU profile (flamegraph data) to a worker (ref:
        profile_manager.py:82 py-spy `record` role; in-process sampler)."""
        duration = min(float(p.get("duration_s", 2.0)), 30.0)
        return await self._proxy_worker_call(
            p, "cpu_profile",
            {k: p[k] for k in ("duration_s", "interval_s") if k in p},
            timeout=duration + 10.0)

    async def rpc_get_log(self, conn, p):
        """Serve a worker's captured stdout/stderr tail (ref: state API
        get_log over the dashboard log tree). p: worker_id (hex prefix ok),
        stream ("out"|"err"), tail bytes."""
        stream = p.get("stream", "out")
        if stream not in ("out", "err"):
            return None
        prefix = (p.get("worker_id") or "")[:12]
        if not prefix:
            return None
        path = os.path.join(self.log_dir, f"worker-{prefix}.{stream}")
        if not os.path.exists(path):
            # short hex prefixes are allowed: resolve by glob, unique match
            import glob as _glob

            matches = _glob.glob(
                os.path.join(self.log_dir, f"worker-{prefix}*.{stream}"))
            if len(matches) != 1:
                return None
            path = matches[0]
        tail = int(p.get("tail", 64 * 1024))
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail))
                return f.read().decode(errors="replace")
        except OSError:
            return None

    async def rpc_get_lease_env(self, conn, p):
        """Worker-side query for its accelerator assignment (applied as
        CUDA_VISIBLE_DEVICES before the first user code runs)."""
        from ray_tpu_torch.utils.ids import WorkerID as _WID

        gpu_ids = self._worker_gpus.get(_WID.from_hex(p["worker_id"]))
        return {"gpu_ids": gpu_ids}

    async def rpc_kill_worker(self, conn, p):
        """Force-kill a worker (task cancellation with force=True; ref:
        CancelTask force_kill path)."""
        from ray_tpu_torch.utils.ids import WorkerID as _WID

        w = self.all_workers.get(_WID.from_hex(p["worker_id"]))
        if w is None:
            return False
        try:
            w.proc.kill()
        except Exception:
            return False
        return True

    async def rpc_worker_ready(self, conn, p):
        w = self.all_workers.get(WorkerID.from_hex(p["worker_id"]))
        if w is None:
            return {"ok": False}
        w.address = tuple(p["address"])
        w.ready.set()
        return {"ok": True}

    async def _pop_worker(self, language: str = "python") -> WorkerHandle:
        # language-segregated pop (ref: worker_pool.h:231 per-language pools)
        for i in range(len(self.idle_workers) - 1, -1, -1):
            if self.idle_workers[i].language != language:
                continue
            w = self.idle_workers.pop(i)
            if w.proc.poll() is None:
                return w
            await self._on_worker_death(w)
        w = self._spawn_worker(language)
        try:
            await asyncio.wait_for(w.ready.wait(), timeout=self.cfg.worker_start_timeout_s)
        except asyncio.TimeoutError:
            w.proc.kill()
            self.all_workers.pop(w.worker_id, None)
            self._release_cgroup_after_exit(w)
            raise RuntimeError("worker failed to start in time")
        return w

    # --------------------------------------------------------------- leases
    async def rpc_lease_worker(self, conn, p):
        """Grant a worker lease, spill back, or queue until resources free.

        Mirrors HandleRequestWorkerLease (ref: node_manager.cc:1886 →
        cluster_task_manager.h:44): local grant if resources fit now;
        otherwise if another node in the synced cluster view fits, reply
        with a spillback address; otherwise queue (infeasible-now).
        """
        resources = dict(p.get("resources") or {"CPU": 1.0})
        if chaos.ENABLED:
            # "raylet.lease_grant" fault point: `error` raises out of the
            # handler (the requester's lease RPC fails — its retry/
            # spillback logic must absorb it); `drop` refuses the grant
            # explicitly; `delay` stalls this raylet's loop like an
            # overloaded node manager would
            act = chaos.point("raylet.lease_grant",
                              cpus=float(resources.get("CPU", 0.0)))
            if act is not None and act.kind == "drop":
                raise rpc.RpcError("chaos: lease grant dropped")
        pg_key = None
        if p.get("pg_id") is not None:
            pg_key = (p["pg_id"], p.get("bundle_index", 0))
        strategy = p.get("strategy")
        if strategy is not None:
            redirect = self._apply_strategy(strategy, resources, p)
            if redirect is not None:
                return redirect
        granted = self._try_allocate(resources, pg_key)
        if not granted:
            spill = self._pick_spillback(resources, p)
            if spill is not None:
                return {"granted": False, "spill_to": spill}
            fut = asyncio.get_running_loop().create_future()
            self._lease_waiters.append((resources, fut, pg_key, conn))
            try:
                await fut  # resolved by _grant_waiters when resources free up
            except asyncio.CancelledError:
                # requester disconnected while queued (see _on_disconnect)
                if fut.done() and not fut.cancelled():
                    self._free_resources(resources, pg_key)
                raise
        return await self._grant_lease(conn, p, resources, pg_key)

    async def _grant_lease(self, conn, p, resources, pg_key) -> dict:
        """Shared grant tail (resources already allocated): pop/spawn a
        worker, stamp the lease, build the reply. On failure the
        allocation is returned."""
        if conn._closed:
            # requester died between grant and reply: give the slot back
            self._free_resources(resources, pg_key)
            self._grant_waiters()
            raise rpc.RpcError("lease requester disconnected")
        try:
            w = await self._pop_worker(p.get("language") or "python")
        except Exception:
            self._free_resources(resources, pg_key)
            raise
        lease_id = next(self._lease_ids)
        w.lease_id = lease_id
        # the lease's memory resource becomes a kernel cap; None RESETS the
        # cap so a recycled worker can't inherit the previous lease's limit
        mem = resources.get("memory")
        self.cgroups.set_limit(w.worker_id.hex(), int(mem) if mem else None)
        # whole cards are pinned; a share of one (GPU < 1) pins none, so
        # the worker sees every card
        gpu_ids = None
        n_gpu = int(resources.get(_GPU, 0))
        # the ledger frees a pinned lease's cards when the lease returns,
        # their ids only once its worker has exited (_release_gpus): wait
        # for the ids, or a whole-card lease would pin fewer cards than it
        # holds (bounded by _release_gpus's kill deadline)
        while n_gpu > len(self._gpu_ids_free) and self._gpus_exiting:
            await asyncio.sleep(0.02)
        if n_gpu > 0 and self._gpu_ids_free:
            gpu_ids = [self._gpu_ids_free.pop(0) for _ in range(min(n_gpu, len(self._gpu_ids_free)))]
            self._worker_gpus[w.worker_id] = gpu_ids
        if p.get("for_actor") is not None:
            w.actor_id = p["for_actor"]
        # A lease dies with its owner's connection only when the owner says
        # so (core_client sets owner_bound on its persistent raylet conn).
        # Actor leases and spillback leases arrive over transient connections
        # that close right after the grant — reaping those would kill the
        # worker we just handed out.
        owner_conn = conn if p.get("owner_bound") else None
        lease = self.leases[lease_id] = Lease(lease_id, resources, w, pg_key, owner_conn, gpu_ids)
        self._lease_stats["granted"] += 1
        if owner_conn is not None and owner_conn._closed:
            # the owner went while its worker was popped or spawned, after
            # _on_client_disconnect reaped its leases: this one would
            # outlive it, holding the worker and its resources for good
            self._reap_owner_lease(lease)
            self._grant_waiters()
            raise rpc.RpcError("lease requester disconnected")
        return {
            "granted": True,
            "lease_id": lease_id,
            "worker_address": w.address,
            "worker_id": w.worker_id.hex(),
            "node_id": self.node_id,
            "gpu_ids": gpu_ids,
        }

    async def rpc_lease_workers(self, conn, p):
        """Batched lease grants (protocol 2.0): allocate every fitting
        request in ONE ledger pass, then pop/spawn the granted workers in
        parallel. Non-fitting requests never park (a parked item would
        hold its whole batch hostage): they reply spillback or
        ``busy`` and the caller's retry loop (the GCS actor scheduler)
        re-sends. One reply list, positionally matching ``requests``."""
        requests = p["requests"]
        out: list = [None] * len(requests)
        granted: list = []
        # one ledger pass: allocation order is batch order
        for i, req in enumerate(requests):
            resources = dict(req.get("resources") or {"CPU": 1.0})
            if chaos.ENABLED:
                # per-request verdict, absorbed per slot: an injected
                # `error` must fail THIS request only — raising out of
                # the handler here would abort batch-mates whose ledger
                # allocations are already committed (a capacity leak)
                try:
                    act = chaos.point("raylet.lease_grant",
                                      cpus=float(resources.get("CPU", 0.0)),
                                      batch=len(requests))
                except chaos.ChaosError as e:
                    out[i] = {"granted": False, "busy": True,
                              "error": f"chaos: {e}"}
                    continue
                if act is not None and act.kind == "drop":
                    out[i] = {"granted": False, "busy": True,
                              "error": "chaos: lease grant dropped"}
                    continue
            pg_key = None
            if req.get("pg_id") is not None:
                pg_key = (req["pg_id"], req.get("bundle_index", 0))
            if self._try_allocate(resources, pg_key):
                granted.append((i, resources, pg_key, req))
            else:
                spill = self._pick_spillback(resources, req)
                out[i] = ({"granted": False, "spill_to": spill}
                          if spill is not None
                          else {"granted": False, "busy": True})

        async def grant(i, resources, pg_key, req):
            try:
                out[i] = await self._grant_lease(conn, req, resources, pg_key)
            except Exception as e:
                out[i] = {"granted": False, "busy": True, "error": repr(e)}

        if len(granted) == 1:
            await grant(*granted[0])
        elif granted:
            await asyncio.gather(*(grant(*g) for g in granted))
        return out

    def _apply_strategy(self, strategy: dict, resources: dict, p: dict):
        """Strategy-directed placement at the lease site (ref: raylet
        scheduling policies — spread_scheduling_policy.cc,
        node_label_scheduling_policy.h:25). Returns a reply dict to send
        back (spillback / infeasible), or None to continue with the
        normal local-grant path."""
        from ray_tpu_torch.util.scheduling_strategies import labels_match

        t = strategy.get("type")
        if t == "spread":
            # round-robin over feasible nodes (self included): leases
            # land on distinct nodes regardless of local headroom
            nodes = [{"node_id": self.node_id, "address": None,
                      "labels": self.labels,
                      "resources_available": self.ledger.available}]
            nodes += [n for n in self.cluster_view
                      if n.get("alive", True)
                      and n["node_id"] != self.node_id]
            feasible = [
                n for n in sorted(nodes, key=lambda n: n["node_id"].hex())
                if policy.fits(resources, n.get("resources_available", {}))
            ]
            if not feasible:
                return None  # nothing fits anywhere: queue locally
            self._spread_rr += 1
            chosen = feasible[self._spread_rr % len(feasible)]
            if chosen["address"] is None:  # ourselves
                return None
            # drop_strategy: the target grants locally instead of
            # re-spreading (its own rr counter would ping-pong the lease)
            return {"granted": False, "spill_to": tuple(chosen["address"]),
                    "drop_strategy": True}
        if t == "node_label":
            hard = strategy.get("hard", {})
            soft = strategy.get("soft", {})
            peers = [n for n in self.cluster_view
                     if n.get("alive", True)
                     and n["node_id"] != self.node_id
                     and labels_match(n.get("labels", {}), hard)]
            preferred = [n for n in peers
                         if labels_match(n.get("labels", {}), soft)]
            if labels_match(self.labels, hard):
                if not soft or labels_match(self.labels, soft):
                    return None  # we qualify fully: normal local path
                if preferred:
                    # a peer matches hard AND soft; hand over with
                    # drop_strategy — redirecting with the strategy kept
                    # would let two hard-matching soft-missing nodes
                    # spill the lease to each other forever
                    n = min(preferred, key=lambda n: policy.score(
                        resources, n.get("resources_total", {}),
                        n.get("resources_available", {})))
                    return {"granted": False,
                            "spill_to": tuple(n["address"]),
                            "drop_strategy": True}
                return None  # soft miss everywhere: we still qualify
            pool = preferred or peers
            if pool:
                # local node fails hard: keep the strategy so the target
                # (which matches hard) re-checks and its own resource
                # spillback stays label-constrained
                n = min(pool, key=lambda n: policy.score(
                    resources, n.get("resources_total", {}),
                    n.get("resources_available", {})))
                return {"granted": False, "spill_to": tuple(n["address"])}
            return {"granted": False, "infeasible": True,
                    "error": f"no alive node matches labels {hard}"}
        return None

    def _try_allocate(self, resources, pg_key) -> bool:
        if pg_key is not None:
            return self.ledger.bundle_allocate(pg_key, resources)
        return self.ledger.allocate(resources)

    def _free_resources(self, resources, pg_key):
        if pg_key is not None:
            self.ledger.bundle_free(pg_key, resources)
        else:
            self.ledger.free(resources)

    def _free_lease_resources(self, lease: Lease):
        self._free_resources(lease.resources, lease.pg_key)
        if lease.gpu_ids:
            self._worker_gpus.pop(lease.worker.worker_id, None)
            self._release_gpus(lease.worker, list(lease.gpu_ids))

    def _release_gpus(self, w: WorkerHandle, gpu_ids: list):
        """Cards return to the pool only after the worker process actually
        exits — its CUDA context holds the card until then."""
        if w.proc.poll() is not None:
            self._gpu_ids_free.extend(gpu_ids)
            self._grant_waiters()
            return
        self._gpus_exiting += 1

        async def wait_exit():
            deadline = time.monotonic() + 5.0
            while w.proc.poll() is None:
                if time.monotonic() > deadline:
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
                await asyncio.sleep(0.05)
            self._gpu_ids_free.extend(gpu_ids)
            self._gpus_exiting -= 1
            self._grant_waiters()

        self._bg.spawn(wait_exit())

    def _grant_waiters(self):
        still: list = []
        for resources, fut, pg_key, conn in self._lease_waiters:
            if fut.done() or conn._closed:
                continue  # requester gone: drop without allocating
            if self._try_allocate(resources, pg_key):
                fut.set_result(True)
            else:
                still.append((resources, fut, pg_key, conn))
        self._lease_waiters = still

    def _on_client_disconnect(self, conn):
        self._demand_reports.pop(conn, None)
        for key in [k for k in self._transfer_pins if k[0] is conn]:
            self._release_transfer_pin(conn, key[1])
        for key in [k for k in self._spill_serves if k[0] is conn]:
            self._spill_serve_close(conn, key[1])
        # tunnel lanes bound over this (driver) connection die with it;
        # detach the workers so their lane state frees
        victims = [(lane, ent) for lane, ent in self._tunnel_lanes.items()
                   if ent["client"] is conn]
        by_worker: dict[int, tuple] = {}
        for lane, ent in victims:
            self._tunnel_lanes.pop(lane, None)
            if not ent["wconn"]._closed:
                by_worker.setdefault(id(ent["wconn"]),
                                     (ent["wconn"], []))[1].append(lane)
        self._tunnel_send_grouped(by_worker, "tunnel_detach", "lanes")
        # a failed send means the worker is gone too
        for resources, fut, pg_key, waiter_conn in self._lease_waiters:
            if waiter_conn is conn and not fut.done():
                fut.cancel()
        self._lease_waiters = [w for w in self._lease_waiters if w[3] is not conn]
        # Reclaim *granted* leases whose owner died without return_lease:
        # otherwise the worker and its resources leak forever (ref: raylet
        # disposes of leased workers when the lease owner dies).
        dead = [l for l in self.leases.values() if l.owner_conn is conn]
        for lease in dead:
            self._reap_owner_lease(lease)
        if dead:
            self._grant_waiters()

    def _reap_owner_lease(self, lease: Lease) -> None:
        """Take back a granted lease whose owner's connection closed."""
        self.leases.pop(lease.lease_id, None)
        self._lease_stats["owner_disconnect"] += 1
        self._free_lease_resources(lease)
        w = lease.worker
        w.lease_id = None
        # the worker may be mid-task for a dead owner — terminate rather
        # than recycle (actor workers are single-purpose anyway)
        try:
            w.proc.terminate()
        except OSError:
            pass
        self.all_workers.pop(w.worker_id, None)
        self._release_cgroup_after_exit(w)

    def _pick_spillback(self, resources, p):
        """Hybrid-policy spillback: if we can never or not-now satisfy but a
        peer advertises availability, point the client there
        (ref: hybrid_scheduling_policy.h:50, normal_task_submitter.cc:461)."""
        if p.get("no_spill") or p.get("pg_id") is not None:
            return None
        # hard label constraints restrict where resource pressure may
        # spill a lease (ref: node_label_scheduling_policy.h:25)
        hard = None
        strategy = p.get("strategy")
        if strategy and strategy.get("type") == "node_label":
            from ray_tpu_torch.util.scheduling_strategies import labels_match

            hard = strategy.get("hard", {})
        # hybrid top-k among feasible peers (ref: hybrid_scheduling_policy,
        # shared impl in core/policy.py): first-fit would herd every spilled
        # lease from every concurrent client onto the same peer
        scored = []
        for n in self.cluster_view:
            if n["node_id"] == self.node_id or not n.get("alive", True):
                continue
            if hard is not None and not labels_match(
                    n.get("labels", {}), hard):
                continue
            av = n.get("resources_available", {})
            if not policy.fits(resources, av):
                continue
            scored.append((
                policy.score(resources, n.get("resources_total", {}), av),
                tuple(n["address"]),
            ))
        return policy.pick(scored)

    async def rpc_return_lease(self, conn, p):
        lease = self.leases.pop(p["lease_id"], None)
        if lease is None:
            return False
        self._lease_stats["returned"] += 1
        self._free_lease_resources(lease)
        w = lease.worker
        w.lease_id = None
        if p.get("kill") or w.actor_id is not None or lease.gpu_ids:
            # pinned workers are single-assignment: CUDA_VISIBLE_DEVICES is
            # read at CUDA's first call, so recycling would leak the old cards
            w.proc.terminate()
            self.all_workers.pop(w.worker_id, None)
            self._release_cgroup_after_exit(w)
        elif w.proc.poll() is None:
            w.idle_since = time.monotonic()
            self.idle_workers.append(w)
        self._grant_waiters()
        return True

    # ----------------------------------------------------- placement bundles
    async def rpc_prepare_bundle(self, conn, p):
        key = (p["pg_id"], p["bundle_index"])
        return {"ok": self.ledger.prepare_bundle(key, p["resources"])}

    async def rpc_commit_bundle(self, conn, p):
        return {"ok": self.ledger.commit_bundle((p["pg_id"], p["bundle_index"]))}

    async def rpc_prepare_bundles(self, conn, p):
        """Batched 2PC phase 1 (protocol 2.0): every bundle this node
        hosts for one PG reserves in a single ledger pass — one RPC per
        node per phase instead of one per bundle. Per-bundle outcomes so
        the GCS repairs exactly what failed."""
        return [{"ok": self.ledger.prepare_bundle((p["pg_id"], idx), res)}
                for idx, res in p["bundles"]]

    async def rpc_commit_bundles(self, conn, p):
        """Batched 2PC phase 2 — the commit twin of prepare_bundles."""
        return [{"ok": self.ledger.commit_bundle((p["pg_id"], idx))}
                for idx in p["indices"]]

    async def rpc_return_bundle(self, conn, p):
        self.ledger.return_bundle((p["pg_id"], p["bundle_index"]))
        self._grant_waiters()
        return {"ok": True}

    async def rpc_list_bundles(self, conn, p):
        """Bundle reservations this node's ledger holds (the PG
        fault-tolerance audit surface: the churn harness and tests
        assert zero leaked reservations here after settle)."""
        return self._held_bundles()

    def _held_bundles(self) -> list[dict]:
        return self.ledger.held_bundles()

    def _gc_stale_bundles(self, now: float) -> None:
        """Reclaim expired prepared-uncommitted reservations (the sweep
        behind the bundle-lease semantics — without it a GCS crash
        between prepare and commit leaks the capacity forever)."""
        stale = self.ledger.gc_stale_bundles(
            now, getattr(self.cfg, "pg_bundle_lease_s", 30.0))
        for key in stale:
            log.warning(
                "returned stale prepared bundle %s (no commit within the "
                "lease: 2PC coordinator lost)", key)
        if stale:
            self._grant_waiters()

    async def rpc_report_demand(self, conn, p):
        """Client backlog report: tasks queued driver-side (including shm
        fast-path rings) that no live lease can absorb. Feeds the
        autoscaler via the heartbeat demand signal (ref: autoscaler v2
        resource-demand reporting). Latest report per client wins."""
        count = int(p.get("count", 0))
        if count <= 0:
            self._demand_reports.pop(conn, None)
        else:
            self._demand_reports[conn] = count
        return True

    # -------------------------------------------------------- object plane
    async def rpc_register_client(self, conn, p):
        """Drivers/workers on this node discover the store + node identity."""
        return {
            "node_id": self.node_id,
            "store_name": self.store_name,
            "address": self.server.address,
            "resources_total": self.ledger.total,
        }

    async def rpc_delete_object(self, conn, p):
        """Owner-driven release of this node's sealed copy (the reference's
        free-objects batch, local_object_manager.h). A copy with live
        reader refs only gets LRU-demoted by the native delete, so retry
        until the readers drop and the bytes actually free."""
        oid = ObjectID(p["object_id"])
        self._drop_spill_file(oid)  # freed objects don't keep disk copies

        async def drain():
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                try:
                    self.store.delete(oid)
                except Exception:
                    return
                if not self.store.contains(oid):
                    return
                await asyncio.sleep(0.25)

        if p.get("wait"):
            await drain()  # tests / synchronous callers
        else:
            self._bg.spawn(drain())
        return True

    # ----------------------------------------------------- object spilling
    # (ref: local_object_manager.h:42 SpillObjects/RestoreSpilledObject:
    # sealed objects move to disk under arena pressure; pulls and peer
    # fetches restore them on demand. The node stays listed as a holder in
    # the GCS directory — it can always materialize the bytes.)

    async def _spill_monitor_loop(self):
        while not self._stopping:
            try:
                # watermark first: the spill trigger reads the recent
                # PEAK (1s of history) instead of whatever instant this
                # tick sampled — a burst that allocated and briefly
                # dipped still crosses the threshold
                self._store_watermark.note(self.store.bytes_in_use)
                peak = self._store_watermark.recent_peak(1.0)
                usage = peak / max(1, self.store.capacity)
                if usage >= self.cfg.object_spilling_threshold:
                    await self._spill_until_low_water()
                await self._publish_raylet_metrics()
            except Exception:
                if self._stopping:  # executor torn down mid-pass
                    return
                traceback.print_exc()
            await asyncio.sleep(0.2)

    async def _publish_raylet_metrics(self):
        """~1/s hand-rolled snapshot into ns="metrics" (key
        raylet.<node>): object-store watermarks + lease lifecycle
        counters. Hand-rolled cells, NOT the process registry — the
        in-process topology shares that registry with the driver whose
        flush already publishes it (see _trace_metrics_tick in gcs.py
        for the same idiom)."""
        now = time.monotonic()
        if now - self._metrics_published_at < 1.0 or self.gcs is None:
            return
        self._metrics_published_at = now
        wm = self._store_watermark
        tags = {"arena": "object_store"}
        snap = {"metrics": {
            "rt_arena_bytes": {"type": "gauge", "samples": [
                {"tags": tags, "value": float(wm.live)}]},
            "rt_arena_peak_bytes": {"type": "gauge", "samples": [
                {"tags": tags, "value": float(wm.peak)}]},
            "rt_arena_capacity_bytes": {"type": "gauge", "samples": [
                {"tags": tags, "value": float(self.store.capacity)}]},
            "rt_leases_active": {"type": "gauge", "samples": [
                {"tags": {}, "value": float(len(self.leases))}]},
            "rt_lease_events_total": {"type": "counter", "samples": [
                {"tags": {"event": k}, "value": float(v)}
                for k, v in self._lease_stats.items()]},
        }}
        try:
            await self.gcs.call("kv_put", {
                "ns": "metrics", "key": f"raylet.{self.node_id.hex()}",
                "value": pickle.dumps(snap)})
        except Exception:
            log.debug("raylet metrics publish failed", exc_info=True)

    async def rpc_spill_now(self, conn, p):
        """Synchronous spill pass — pressured putters call this before a
        large create so the arena frees by SPILL (bytes preserved on disk)
        rather than by LRU eviction (bytes destroyed, lineage recompute)."""
        need = int(p.get("need", 0))
        await self._spill_until_low_water(extra_need=need)
        return True

    async def _spill_until_low_water(self, extra_need: int = 0):
        async with self._spill_lock:
            cap = max(1, self.store.capacity)
            target = int(self.cfg.object_spilling_low_water * cap) - extra_need
            loop = asyncio.get_running_loop()
            now = time.monotonic()
            while self.store.bytes_in_use > target:
                cands = [
                    (oid, sz)
                    for oid, sz in self.store.list_spillable(64)
                    # skip candidates whose spill recently failed (full
                    # disk etc.), with per-oid exponential backoff so the
                    # monitor doesn't hot-loop on a bad disk
                    if now - self._spill_failed_at.get(oid, -1e9)
                    >= self._spill_backoff_s(oid)
                ]
                if not cands:
                    break
                for oid, _sz in cands:
                    if self.store.bytes_in_use <= target:
                        return
                    await loop.run_in_executor(None, self._spill_one, oid)
            if self.store.bytes_in_use > target:
                # unreferenced candidates exhausted: ask registered arena
                # owners (prefix cache, shard plane, staging trackers) to
                # trade cold REFERENCED pages to tier-1
                await self._cooperative_spill(
                    self.store.bytes_in_use - target, loop)

    def _spill_backoff_s(self, oid: ObjectID) -> float:
        n = self._spill_fail_n.get(oid, 0)
        return 0.0 if n == 0 else min(60.0, 0.5 * (2 ** (n - 1)))

    def _note_spill_failure(self, oid: ObjectID):
        self._spill_failed_at[oid] = time.monotonic()
        self._spill_fail_n[oid] = self._spill_fail_n.get(oid, 0) + 1
        self.store.note_spill_failure()

    async def rpc_register_spill_provider(self, conn, p):
        """A local client process declares it can serve cold arena-owner
        spill candidates (core/tiering.py registry) at this RPC address."""
        self._spill_providers.add(tuple(p["address"]))
        return True

    async def _provider_conn(self, addr: tuple):
        conn = self._provider_conns.get(addr)
        if conn is not None and not conn._closed:
            return conn
        try:
            conn = await rpc.connect(*addr, timeout=2.0)
        except Exception:
            self._spill_providers.discard(addr)
            self._provider_conns.pop(addr, None)
            return None
        self._provider_conns[addr] = conn
        return conn

    async def _cooperative_spill(self, need: int, loop):
        """Ask each registered provider for cold referenced candidates and
        spill them; report the landed (oid, path) pairs back so owners can
        stamp manifest tier legs. Runs under _spill_lock (caller holds)."""
        for addr in sorted(self._spill_providers):
            conn = await self._provider_conn(addr)
            if conn is None:
                continue
            try:
                cands = await conn.call(
                    "arena_spill_candidates",
                    {"need": int(need),
                     "cold_after_s": self.cfg.spill_cold_after_s},
                    timeout=2.0)
            except (rpc.RpcError, OSError):
                self._spill_providers.discard(addr)
                self._provider_conns.pop(addr, None)
                continue
            spilled = []
            for item in cands or ():
                oid = ObjectID(item["object_id"])
                if not self.store.contains(oid):
                    continue
                await loop.run_in_executor(None, self._spill_one, oid)
                path = self._spilled.get(oid)
                if path is not None and not self.store.contains(oid):
                    spilled.append({"object_id": oid.binary(), "path": path})
                    need -= int(item.get("nbytes", 0))
            if spilled:
                try:
                    await conn.call("arena_spilled", {"spilled": spilled},
                                    timeout=2.0)
                except (rpc.RpcError, OSError):
                    pass  # owner gone; its refs will free the files
            if need <= 0:
                return

    async def rpc_spill_objects(self, conn, p):
        """Explicit spill of specific sealed objects — the owner-initiated
        leg of cooperative tiering (e.g. the prefix cache's spill-not-drop
        eviction trades its own cold pages for headroom without waiting
        for the monitor). Returns {oid hex: {"ok", "path"}}."""
        loop = asyncio.get_running_loop()
        out: dict[str, dict] = {}
        async with self._spill_lock:
            for raw in p.get("object_ids") or ():
                oid = ObjectID(raw)
                have = self.store.contains(oid)
                if not have and oid in self._spilled:
                    out[oid.hex()] = {"ok": True, "path": self._spilled[oid]}
                    continue
                if not have:
                    out[oid.hex()] = {"ok": False, "path": ""}
                    continue
                await loop.run_in_executor(None, self._spill_one, oid)
                path = self._spilled.get(oid)
                ok = path is not None and not self.store.contains(oid)
                out[oid.hex()] = {"ok": bool(ok), "path": path or ""}
        return out

    def _spill_one(self, oid: ObjectID):
        """Move one sealed object's bytes out of the arena. Runs off-loop
        (disk IO). A previously-spilled object whose file is still valid
        (restore keeps it) skips the write — dropping the arena copy is
        enough. Safe vs concurrent gets: the buffer ref pins the bytes
        while copying; after delete, readers miss and take the pull path
        which restores from disk."""
        with self._spill_state_lock:
            self._spilling_now.add(oid)
        try:
            path = self._spilled.get(oid)
            if path is None or not os.path.exists(path):
                act = None
                if chaos.ENABLED:
                    # "store.spill" fault point (phase=write): error acts
                    # like a failed disk write (backoff + counter), drop
                    # means the file was lost after the write, delay
                    # widens the mid-spill window
                    try:
                        act = chaos.point("store.spill", oid=oid.hex(),
                                          phase="write")
                    except chaos.ChaosError:
                        self._note_spill_failure(oid)
                        return
                try:
                    buf = self.store.get_buffer(oid, timeout_ms=0)
                except ObjectStoreError:
                    return  # raced an eviction/delete: nothing to spill
                nbytes = len(buf)
                path = os.path.join(self.spill_dir, oid.hex())
                tmp = path + ".tmp"
                try:
                    os.makedirs(self.spill_dir, exist_ok=True)
                    with open(tmp, "wb") as f:
                        f.write(buf)
                    os.replace(tmp, path)
                except OSError:
                    # disk full / unwritable: remember (with exponential
                    # backoff) and move on
                    self._note_spill_failure(oid)
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
                    return
                finally:
                    self.store.release(oid)
                if act is not None and act.kind == "drop":
                    try:
                        os.remove(path)
                    except OSError:
                        pass
                    self._note_spill_failure(oid)
                    return
                self._spilled[oid] = path
                self._spill_failed_at.pop(oid, None)
                self._spill_fail_n.pop(oid, None)
                metrics.objects_spilled.inc()
                metrics.spill_bytes_total.inc(nbytes)
            self.store.delete(oid)
        finally:
            with self._spill_state_lock:
                self._spilling_now.discard(oid)
                freed = oid in self._freed_while_spilling
                self._freed_while_spilling.discard(oid)
            if freed:
                self._drop_spill_file(oid)

    def _restore_spilled(self, oid: ObjectID) -> bool:
        """Disk -> arena (blocking; call off-loop): one sequential read
        straight into a fresh arena create, then seal — no intermediate
        heap copy. Leaves the file in place until the object is freed, so
        repeated pressure cycles re-spill without rewriting unchanged
        bytes."""
        path = self._spilled.get(oid)
        if path is None:
            return False
        if chaos.ENABLED:
            # "store.restore" fault point (phase=read): error/drop act
            # like an unreadable tier-1 file (this attempt fails; the
            # puller falls back / retries), delay models slow disk
            try:
                act = chaos.point("store.restore", oid=oid.hex(),
                                  phase="read")
            except chaos.ChaosError:
                return False
            if act is not None and act.kind == "drop":
                return False
        try:
            size = os.path.getsize(path)
        except OSError:
            self._spilled.pop(oid, None)
            return False
        try:
            buf = self.store.create(oid, size)
        except ObjectStoreError:
            return self.store.contains(oid)  # raced another restore
        ok = False
        try:
            with open(path, "rb") as f:
                ok = f.readinto(buf) == size
        except OSError:
            ok = False
        finally:
            del buf
            if ok:
                try:
                    self.store.seal(oid)
                except ObjectStoreError:
                    ok = False
            if not ok:
                try:
                    self.store.delete(oid)  # abort the half-create
                except ObjectStoreError:
                    pass
        if not ok:
            return False
        metrics.objects_restored.inc()
        metrics.restore_bytes_total.inc(size)
        return True

    def _drop_spill_file(self, oid: ObjectID):
        with self._spill_state_lock:
            if oid in self._spilling_now:
                # a spill is writing this object's file right now; the
                # spill's finally will see the marker and drop the file
                self._freed_while_spilling.add(oid)
                return
            self._spill_failed_at.pop(oid, None)
            self._spill_fail_n.pop(oid, None)
            path = self._spilled.pop(oid, None)
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass

    # -------------------------------------------- cross-node DAG channels
    # (the RegisterMutableObjectReader role, ref: core_worker.proto:577 +
    # experimental_mutable_object_provider.cc: remote readers of a mutable
    # object get a local mirror cell fed one push per version)

    async def rpc_channel_create(self, conn, p):
        """Create a channel cell (origin or mirror) in this node's arena."""
        cid = ObjectID(p["chan_id"])
        self.store.channel_create(cid, int(p["size"]), int(p["num_readers"]))
        return True

    async def rpc_channel_push(self, conn, p):
        """Write one version's packed payload into a local mirror cell.
        Blocks (off-loop) until the mirror's readers released the previous
        version — backpressure propagates across the network."""
        cid = ObjectID(p["chan_id"])
        payload = p["payload"]

        def push():
            buf = self.store.channel_write_acquire(cid, -1)
            buf[: len(payload)] = payload
            self.store.channel_write_release(cid, len(payload))

        await asyncio.get_running_loop().run_in_executor(
            self._chan_io_executor(cid), push)
        return True

    async def rpc_channel_register_remote(self, conn, p):
        """Start a forwarder pumping this node's channel cell to mirror
        cells on remote nodes, one push per version, releasing the origin
        only after every mirror accepted (keeps the end-to-end depth-1
        write/read protocol of the shm cells)."""
        cid = ObjectID(p["chan_id"])
        targets = [tuple(a) for a in p["readers"]]
        self._bg.spawn(self._channel_forwarder(cid, targets))
        return True

    async def rpc_channel_close(self, conn, p):
        cid = ObjectID(p["chan_id"])
        try:
            self.store.channel_close(cid)
        except Exception:
            log.debug("channel close failed", exc_info=True)
        # mirror nodes create a push executor per channel: release it here
        # (the forwarder's finally only runs on the origin node)
        ex = getattr(self, "_chan_execs", {}).pop(cid, None)
        if ex is not None:
            ex.shutdown(wait=False)
        return True

    def _chan_io_executor(self, cid: ObjectID):
        """One single-thread executor per channel: blocking cell waits must
        not starve the shared pool (a parked forwarder would otherwise hold
        a shared worker thread for the DAG's lifetime)."""
        if not hasattr(self, "_chan_execs"):
            self._chan_execs = {}
        ex = self._chan_execs.get(cid)
        if ex is None:
            import concurrent.futures as _cf

            ex = self._chan_execs[cid] = _cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"rt-chan-{cid.hex()[:8]}")
        return ex

    async def _channel_forwarder(self, cid: ObjectID, targets: list):
        from ray_tpu_torch.core.object_store import ChannelClosedError

        loop = asyncio.get_running_loop()
        ex = self._chan_io_executor(cid)
        conns = []
        try:
            for t in targets:
                conns.append(await rpc.connect(
                    *t, timeout=self.cfg.rpc_connect_timeout_s))
            last_version = 0

            def read_next(v=None):
                return self.store.channel_read_acquire(cid, last_version, -1)

            while True:
                payload, version = await loop.run_in_executor(ex, read_next)
                data = bytes(payload)
                await asyncio.gather(*[
                    c.call("channel_push",
                           {"chan_id": cid.binary(), "payload": data},
                           timeout=None)
                    for c in conns
                ])
                self.store.channel_read_release(cid)
                last_version = version
        except ChannelClosedError:
            pass  # normal teardown: origin closed under us
        except Exception:
            # a mirror died or the forwarder itself broke: this is NOT a
            # clean close — log it, or the DAG just stops delivering
            # versions with zero diagnostics
            traceback.print_exc()
        finally:
            # propagate the close both ways: mirrors stop their readers,
            # and the ORIGIN cell closes so the producer's next write
            # raises ChannelClosed instead of blocking forever on the
            # never-released read slot
            for c in conns:
                try:
                    await c.call("channel_close", {"chan_id": cid.binary()},
                                 timeout=5)
                except Exception:
                    log.debug("mirror channel_close failed", exc_info=True)
            try:
                self.store.channel_close(cid)
            except Exception:
                log.debug("origin channel close failed", exc_info=True)
            for c in conns:
                try:
                    await c.close()
                except (rpc.RpcError, OSError):
                    pass  # reader link already dead
            ex2 = getattr(self, "_chan_execs", {}).pop(cid, None)
            if ex2 is not None:
                ex2.shutdown(wait=False)

    # --------------------------------------------- node tunnel (core/tunnel.py)
    def _find_tunnel_worker(self, p) -> "WorkerHandle | None":
        """Resolve a bind target: explicit worker id, or the worker
        hosting the named actor (actor leases stamp w.actor_id)."""
        wid = p.get("worker_id")
        if wid is not None:
            return self.all_workers.get(WorkerID.from_hex(wid))
        aid = p.get("actor_id")
        if aid is None:
            return None
        for w in self.all_workers.values():
            wa = w.actor_id
            if wa is None:
                continue
            wa_hex = wa.hex() if hasattr(wa, "hex") else str(wa)
            if wa_hex == aid:
                return w
        return None

    async def _tunnel_worker_conn(self, w: "WorkerHandle"):
        """Cached persistent raylet->worker connection for tunnel
        traffic (one per worker, shared by every lane bound on it)."""
        conn = self._tunnel_worker_conns.get(w.worker_id)
        if conn is not None and not conn._closed:
            return conn
        conn = await rpc.connect(*w.address, timeout=5)
        conn.on_message = self._on_tunnel_worker_push
        self._tunnel_worker_conns[w.worker_id] = conn
        return conn

    async def rpc_tunnel_bind(self, conn, p):
        """Bind one tunnel lane: remote driver -> (this raylet) -> local
        worker (protocol 2.0). The reply carries the raylet-assigned lane
        id and, for actor lanes, the worker's method eligibility table.
        The lane lives until the driver detaches, the driver's tunnel
        connection drops, or the worker dies (-> tunnel_down push)."""
        w = self._find_tunnel_worker(p)
        if w is None or w.address is None or w.proc.poll() is not None:
            return {"ok": False, "error": "no such worker"}
        try:
            wconn = await self._tunnel_worker_conn(w)
            lane = next(self._tunnel_ids)
            reply = await wconn.call(
                "tunnel_attach", {"lane": lane, "kind": p.get("kind", "task")},
                timeout=10)
        except (rpc.RpcError, OSError, asyncio.TimeoutError):
            return {"ok": False, "error": "worker unreachable"}
        if not isinstance(reply, dict) or not reply.get("ok"):
            return {"ok": False, "error": "worker refused"}
        self._tunnel_lanes[lane] = {
            "client": conn, "worker": w.worker_id, "wconn": wconn,
        }
        return {"ok": True, "lane": lane, "methods": reply.get("methods")}

    @staticmethod
    def _tunnel_send_grouped(groups: dict, method: str, key: str) -> list:
        """One tunnel notify per connection. ``groups``: id(conn) ->
        (conn, items); the payload is ``{key: items}``. Returns the
        items of every connection whose send failed (dead link) so the
        caller can reap/bounce exactly those — the one shared shape
        behind every tunnel fan-out below."""
        failed: list = []
        for conn, items in groups.values():
            try:
                conn.send_nowait({"k": "n", "m": method, "p": {key: items}})
            except (rpc.ConnectionLost, OSError):
                failed.extend(items)
        return failed

    async def rpc_tunnel_frame(self, conn, p):
        """Forward one driver frame's per-lane record chunks to their
        workers (notify; no reply). Forwarding is synchronous within the
        handler so frame order per lane is preserved end to end —
        dispatch order is the caller's FIFO invariant. Lanes this raylet
        does not know (worker died, stale bind) bounce back as a
        tunnel_down push so the driver breaks exactly those lanes."""
        by_worker: dict[int, tuple] = {}
        dead: list = []
        for lane, recs in p["frames"]:
            ent = self._tunnel_lanes.get(lane)
            if ent is None or ent["client"] is not conn:
                dead.append(lane)
                continue
            wconn = ent["wconn"]
            if wconn._closed:
                dead.append(lane)
                self._tunnel_lanes.pop(lane, None)
                continue
            by_worker.setdefault(id(wconn), (wconn, []))[1].append(
                (lane, recs))
        for lane, _ in self._tunnel_send_grouped(
                by_worker, "tunnel_records", "frames"):
            dead.append(lane)
            self._tunnel_lanes.pop(lane, None)
        if dead:
            self._tunnel_send_grouped(
                {0: (conn, dead)}, "tunnel_down", "lanes")
            # driver gone too: its health sweep owns the break

    async def rpc_tunnel_detach(self, conn, p):
        """Driver closed lanes (notify): reap routing entries and tell
        the workers so their lane state frees."""
        by_worker: dict[int, tuple] = {}
        for lane in p.get("lanes", ()):
            ent = self._tunnel_lanes.pop(lane, None)
            if ent is None or ent["wconn"]._closed:
                continue
            by_worker.setdefault(id(ent["wconn"]),
                                 (ent["wconn"], []))[1].append(lane)
        self._tunnel_send_grouped(by_worker, "tunnel_detach", "lanes")
        # a failed send means the worker is gone: lane state died with it

    def _on_tunnel_worker_push(self, msg):
        """Reply frames from a worker: forward each lane's records to
        the driver that bound the lane, coalesced per client connection."""
        if msg.get("m") != "tunnel_replies":
            return
        by_client: dict[int, tuple] = {}
        for lane, recs in msg["p"]["frames"]:
            ent = self._tunnel_lanes.get(lane)
            if ent is None:
                continue
            by_client.setdefault(id(ent["client"]),
                                 (ent["client"], []))[1].append((lane, recs))
        for lane, _ in self._tunnel_send_grouped(
                by_client, "tunnel_frame", "frames"):
            # driver gone: drop its lanes; workers are detached by the
            # disconnect sweep
            self._tunnel_lanes.pop(lane, None)

    def _reap_tunnel_lanes_for_worker(self, worker_id: WorkerID):
        """Worker died: push tunnel_down for its lanes so every bound
        driver breaks them (per-call RPC fallback + revival later)."""
        self._tunnel_worker_conns.pop(worker_id, None)
        victims = [(lane, ent) for lane, ent in self._tunnel_lanes.items()
                   if ent["worker"] == worker_id]
        by_client: dict[int, tuple] = {}
        for lane, ent in victims:
            self._tunnel_lanes.pop(lane, None)
            by_client.setdefault(id(ent["client"]),
                                 (ent["client"], []))[1].append(lane)
        self._tunnel_send_grouped(by_client, "tunnel_down", "lanes")
        # a failed send means the driver is gone: nothing left to tell

    async def rpc_pull_objects(self, conn, p):
        """Batched multi-object pull (protocol 2.0): one round trip
        fetches a whole arg/KV-manifest set into the local store. Hinted
        objects skip the directory entirely; the UNHINTED miss-set costs
        exactly ONE ``kv_multi_get`` (not one directory lookup per oid —
        PR 3's completion-time priming, extended to the raylet path).
        Each inbound transfer/restore is byte-admitted through the
        PullAdmission window (items may carry an ``nbytes`` estimate; the
        payload may carry ``timeout_s`` as the admission deadline). A
        shed item reports its retry hint under the ``"_bp"`` key, and
        items restored from tier-1 list their hexes under ``"_restored"``
        (both safe beside the 40-char oid-hex keys).

        Returns {oid hex: bool} plus the side-channel keys."""
        out: dict = {}
        todo: list = []
        for item in p["objects"]:
            oid = ObjectID(item["object_id"])
            if self.store.contains(oid):
                out[oid.hex()] = True
                continue
            todo.append((oid, set(item.get("holders_hint") or ()),
                         int(item.get("nbytes") or 0)))
        if not todo:
            return out
        deadline = None
        if p.get("timeout_s") is not None:
            deadline = time.monotonic() + float(p["timeout_s"])
        no_hint = [oid for oid, hint, _n in todo if not hint]
        primed: dict[ObjectID, set] = {}
        if no_hint:
            try:
                blobs = await self.gcs.call(
                    "kv_multi_get",
                    {"ns": "obj_loc", "keys": [o.hex() for o in no_hint]})
            except (rpc.RpcError, OSError):
                blobs = None
            for oid in no_hint:
                blob = (blobs or {}).get(oid.hex())
                if blob:
                    try:
                        primed[oid] = set(pickle.loads(blob))
                    except (pickle.UnpicklingError, TypeError, EOFError):
                        pass  # torn directory blob: a cache miss

        restored: list[str] = []
        bp: dict[str, float] = {}

        async def one(oid: ObjectID, hint: set, nbytes: int) -> bool:
            holders = hint | primed.get(oid, set())
            was_spilled = oid in self._spilled
            if not holders and not was_spilled:
                return False  # nowhere to pull from, nothing spilled
            est = (nbytes or self._spilled_size(oid)
                   or self.cfg.object_transfer_chunk_size)
            try:
                await self._pull_admission.acquire(est, deadline)
            except PullBackPressure as e:
                bp[oid.hex()] = e.retry_after_s
                return False
            try:
                ok = await self._pull_one_dedup(oid, sorted(holders))
            finally:
                self._pull_admission.release(est)
            if ok and was_spilled:
                restored.append(oid.hex())
            return ok

        results = await asyncio.gather(
            *(one(oid, hint, n) for oid, hint, n in todo),
            return_exceptions=True)
        for (oid, _h, _n), ok in zip(todo, results):
            out[oid.hex()] = ok is True
        if restored:
            out["_restored"] = restored
        if bp:
            out["_bp"] = bp
        return out

    async def rpc_pull_object(self, conn, p):
        """Pull an object into the local store from whichever node holds it.
        The caller may pass ``holders_hint`` (node ids from its
        completion-time location cache): hinted nodes are tried first
        WITHOUT consulting the GCS object directory — zero directory
        round-trips in steady state — and a stale hint falls back to the
        directory, which stays the source of truth. Concurrent pulls of
        the same object coalesce onto one transfer (ref: pull_manager.h:49
        request dedup + admission control)."""
        oid = ObjectID(p["object_id"])
        if self.store.contains(oid):
            return True
        est = self._spilled_size(oid) or self.cfg.object_transfer_chunk_size
        try:
            # single-object gets keep wait-then-succeed semantics: a long
            # default deadline parks them through bursts instead of
            # shedding (the shed path belongs to batched adoptions)
            await self._pull_admission.acquire(est)
        except PullBackPressure:
            return False
        try:
            return await self._pull_one_dedup(oid, p.get("holders_hint"))
        finally:
            self._pull_admission.release(est)

    def _spilled_size(self, oid: ObjectID) -> int:
        path = self._spilled.get(oid)
        if path is None:
            return 0
        try:
            return os.path.getsize(path)
        except OSError:
            return 0

    async def _pull_one_dedup(self, oid: ObjectID, holders_hint=None) -> bool:
        """Dedup'd single-object pull: concurrent pulls of the same oid
        (including batch-mates from pull_objects) coalesce onto one
        transfer."""
        if self.store.contains(oid):
            return True
        if oid in self._spilled:  # restore beats a network pull
            if await self._ensure_local_bytes(oid):
                return True
        fut = self._active_pulls.get(oid)
        if fut is not None:
            return await asyncio.shield(fut)
        fut = asyncio.get_running_loop().create_future()
        self._active_pulls[oid] = fut
        try:
            ok = await self._pull_object(oid, holders_hint)
            fut.set_result(ok)
            return ok
        except Exception as e:
            fut.set_result(False)
            raise e
        finally:
            self._active_pulls.pop(oid, None)

    async def _pull_object(self, oid: ObjectID, holders_hint=None) -> bool:
        if holders_hint:
            if await self._pull_from_holders(oid, set(holders_hint),
                                             register=True):
                return True
            # hint was stale (holder died / copy evicted): directory path
        locs = await self.gcs.call("kv_get", {"ns": "obj_loc", "key": oid.hex()})
        if not locs:
            return False
        import pickle as _p

        holders = _p.loads(locs)
        return await self._pull_from_holders(oid, holders, register=True)

    async def _pull_from_holders(self, oid: ObjectID, holders: set,
                                 register: bool) -> bool:
        import pickle as _p

        for node in self.cluster_view:
            if node["node_id"].binary() in holders and node["node_id"] != self.node_id:
                # byte-budget admission happened at the pull entry point
                # (rpc_pull_object/rpc_pull_objects), so the transfer
                # itself runs unthrottled here
                try:
                    if await self._chunked_fetch(oid, tuple(node["address"])):
                        if register:
                            # read-modify-write the directory so later
                            # pulls (and the owner's free) see this copy
                            locs = await self.gcs.call(
                                "kv_get",
                                {"ns": "obj_loc", "key": oid.hex()})
                            merged = _p.loads(locs) if locs else set()
                            merged.add(self.node_id.binary())
                            await self.gcs.call(
                                "kv_put",
                                {"ns": "obj_loc", "key": oid.hex(),
                                 "value": _p.dumps(merged)},
                            )
                        return True
                except Exception:
                    continue
        return False

    async def _chunked_fetch(self, oid: ObjectID, address: tuple) -> bool:
        """Stream an object in bounded chunks straight into local shm —
        peak transient memory is chunk_size x window, independent of object
        size (ref: push_manager.h:28 chunked pushes,
        chunk_object_reader.cc)."""
        chunk = self.cfg.object_transfer_chunk_size
        window = 4  # in-flight chunk requests (pipelined)
        c = await rpc.connect(*address, timeout=self.cfg.rpc_connect_timeout_s)
        pinned = False
        try:
            meta = await c.call("fetch_object_meta", {"object_id": oid.binary()},
                                timeout=self.cfg.rpc_connect_timeout_s)
            if not meta:
                return False
            pinned = True  # holder keeps a store ref until fetch_object_done
            size = meta["size"]
            if self.store.contains(oid):
                return True
            if size <= chunk:
                raw = await c.call("fetch_object", {"object_id": oid.binary()},
                                   timeout=self.cfg.rpc_connect_timeout_s)
                if raw is None:
                    return False
                self.store.put_raw(oid, raw)
                return True
            buf = self.store.create(oid, size)
            try:
                # true sliding window: `window` chunk requests always in
                # flight (a barriered gather per batch would idle the link
                # for a full RTT between batches)
                sem = asyncio.Semaphore(window)

                async def fetch_one(off: int):
                    async with sem:
                        part = await c.call(
                            "fetch_object_chunk",
                            {"object_id": oid.binary(), "offset": off,
                             "length": min(chunk, size - off)},
                            timeout=self.cfg.rpc_connect_timeout_s,
                        )
                    if part is None:
                        raise rpc.RpcError(f"holder lost {oid} mid-transfer")
                    buf[off : off + len(part)] = part

                await asyncio.gather(
                    *(fetch_one(off) for off in range(0, size, chunk))
                )
                self.store.seal(oid)
                return True
            except Exception:
                try:  # abort the half-written create so the slot isn't stuck
                    self.store.delete(oid)
                except ObjectStoreError:
                    pass  # nothing to abort (create itself failed)
                raise
        finally:
            if pinned:
                try:
                    await c.notify("fetch_object_done", {"object_id": oid.binary()})
                except (rpc.RpcError, OSError):
                    pass  # holder gone: its pin died with it
            await c.close()

    async def _ensure_local_bytes(self, oid: ObjectID) -> bool:
        """Restore a spilled object into the arena if needed (peer fetches
        and local pulls both land here before touching the store).

        Spills FIRST when the restore wouldn't fit below the pressure
        threshold: a restore-triggered eviction could otherwise destroy a
        resident object that has no disk copy yet."""
        if self.store.contains(oid):
            return True
        path = self._spilled.get(oid)
        if path is None:
            return False
        try:
            need = os.path.getsize(path)
        except OSError:
            need = 0
        cap = max(1, self.store.capacity)
        loop = asyncio.get_running_loop()
        # retry across transient full-arena conditions: the bytes exist on
        # disk, so "arena fully pinned by reader views right now" must wait
        # for releases, not surface as object-lost
        deadline = time.monotonic() + 30.0
        while True:
            if self.store.bytes_in_use + need > self.cfg.object_spilling_threshold * cap:
                await self._spill_until_low_water(extra_need=need)
            if await loop.run_in_executor(None, self._restore_spilled, oid):
                return True
            if oid not in self._spilled or time.monotonic() > deadline:
                return False
            await asyncio.sleep(0.2)

    def _spill_serve_open(self, conn, oid: ObjectID):
        """Open (and cache per (conn, oid)) this object's tier-1 file for
        peer serving. The held fd plays the transfer pin's role: a
        concurrent free/unlink can't tear the chunked stream, the kernel
        keeps the inode until fetch_object_done closes it."""
        key = (conn, oid)
        ent = self._spill_serves.get(key)
        if ent is not None:
            return ent
        if self.store.contains(oid):
            return None  # shm copy wins: serve zero-copy from the arena
        path = self._spilled.get(oid)
        if path is None:
            return None
        try:
            f = open(path, "rb")
        except OSError:
            return None
        ent = (f, os.fstat(f.fileno()).st_size)
        self._spill_serves[key] = ent
        return ent

    def _spill_serve_close(self, conn, oid: ObjectID):
        ent = self._spill_serves.pop((conn, oid), None)
        if ent is not None:
            try:
                ent[0].close()
            except OSError:
                pass

    async def rpc_fetch_object_meta(self, conn, p):
        """Start of a transfer: pin the object (one store ref held for the
        whole transfer so eviction/owner-delete can't yank it mid-stream);
        the peer releases via fetch_object_done or by disconnecting. A
        spilled object serves straight from its tier-1 file — no restore
        into (so no pressure on) this node's arena; the open fd is the
        pin."""
        oid = ObjectID(p["object_id"])
        ent = self._spill_serve_open(conn, oid)
        if ent is not None:
            return {"size": ent[1]}
        try:
            buf = self.store.get_buffer(oid, timeout_ms=0)
        except Exception:
            return None
        size = len(buf)
        del buf
        key = (conn, oid)
        if key in self._transfer_pins:
            self.store.release(oid)  # already pinned by this peer
        else:
            self._transfer_pins[key] = True
        return {"size": size}

    def _release_transfer_pin(self, conn, oid: ObjectID):
        self._spill_serve_close(conn, oid)
        if self._transfer_pins.pop((conn, oid), None):
            try:
                self.store.release(oid)
            except ObjectStoreError:
                pass  # already deleted/evicted: the pin is moot

    async def rpc_fetch_object_done(self, conn, p):
        self._release_transfer_pin(conn, ObjectID(p["object_id"]))
        return True

    async def rpc_fetch_object_chunk(self, conn, p):
        oid = ObjectID(p["object_id"])
        off, length = p["offset"], p["length"]
        ent = self._spill_serve_open(conn, oid)
        if ent is not None:
            loop = asyncio.get_running_loop()
            try:
                return await loop.run_in_executor(
                    None, os.pread, ent[0].fileno(), length, off)
            except OSError:
                return None
        await self._ensure_local_bytes(oid)
        try:
            buf = self.store.get_buffer(oid, timeout_ms=0)
        except Exception:
            return None
        try:
            return bytes(buf[off : off + length])
        finally:
            del buf
            self.store.release(oid)

    async def rpc_fetch_object(self, conn, p):
        """Single-frame fetch for objects at or below one chunk."""
        oid = ObjectID(p["object_id"])
        ent = self._spill_serve_open(conn, oid)
        if ent is not None:
            loop = asyncio.get_running_loop()
            try:
                data = await loop.run_in_executor(
                    None, os.pread, ent[0].fileno(), ent[1], 0)
            except OSError:
                data = None
            self._spill_serve_close(conn, oid)
            return data
        await self._ensure_local_bytes(oid)
        try:
            buf = self.store.get_buffer(oid, timeout_ms=0)
        except Exception:
            return None
        try:
            return bytes(buf)
        finally:
            del buf
            self.store.release(oid)

    async def kill(self):
        """Chaos-test hard death (ref: test_utils.py:1419 ResourceKiller
        SIGKILLing raylets): SIGKILL every worker, drop the server with no
        lease returns / GCS goodbyes — peers must discover the loss via
        missed heartbeats and recover by retry + lineage."""
        import signal as _signal

        self._stopping = True
        await self._bg.cancel_all()
        for w in self.all_workers.values():
            try:
                os.kill(w.proc.pid, _signal.SIGKILL)
            except OSError:
                pass
        await self.server.stop()
        if self.gcs is not None:
            try:
                await self.gcs.close()
            except (rpc.RpcError, OSError):
                pass  # hard-death semantics: no goodbyes anyway
        try:
            self.store.destroy()
        except Exception:
            log.debug("store destroy failed", exc_info=True)

    async def stop(self):
        self._stopping = True
        await self._bg.cancel_all()
        for w in self.all_workers.values():
            try:
                w.proc.terminate()
            except OSError:
                pass
        # terminated workers never run their clean-exit recorder unlink:
        # drop OUR workers' recorder files (256KB each) — only ours, the
        # session rec/ dir is shared by every node of an in-process
        # cluster and other raylets' workers may still be alive
        from ray_tpu_torch.utils import recorder as _recorder

        for w in self.all_workers.values():
            try:
                os.unlink(_recorder.worker_recorder_path(
                    self.cfg.temp_dir, self.session, w.worker_id.hex()))
            except OSError:
                pass
        try:  # removes the dir only once the LAST node emptied it
            os.rmdir(os.path.join(
                self.cfg.temp_dir, f"session_{self.session}", "rec"))
        except OSError:
            pass
        for wconn in list(self._tunnel_worker_conns.values()):
            try:
                await wconn.close()
            except Exception:
                log.debug("tunnel worker conn close failed", exc_info=True)
        self._tunnel_worker_conns.clear()
        self._tunnel_lanes.clear()
        for pconn in list(self._provider_conns.values()):
            try:
                await pconn.close()
            except Exception:
                log.debug("spill provider conn close failed", exc_info=True)
        self._provider_conns.clear()
        for conn, oid in list(self._spill_serves):
            self._spill_serve_close(conn, oid)
        await self.server.stop()
        if self.gcs is not None:
            await self.gcs.close()
        if self.cgroups.enabled:
            # leaves rmdir EBUSY until their procs exit — including workers
            # already popped from all_workers whose deferred release waiters
            # were cancelled above; retry teardown until clean or deadline
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline:
                try:
                    if self.cgroups.teardown():
                        break
                except Exception:
                    break
                await asyncio.sleep(0.05)
        try:
            self.store.destroy()
        except Exception:
            log.debug("store destroy failed", exc_info=True)


def main():
    import argparse

    chaos.maybe_arm()  # fault schedule rides the serialized config

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs", required=True, help="host:port of the GCS")
    parser.add_argument("--num-cpus", type=float, default=float(os.cpu_count() or 1))
    parser.add_argument("--num-gpus", type=float, default=0.0)
    parser.add_argument("--resources", default="", help="k=v,k=v extra resources")
    parser.add_argument("--labels", default="", help="k=v,k=v node labels")
    parser.add_argument("--store-capacity", type=int, default=0)
    parser.add_argument("--session", default="")
    args = parser.parse_args()

    host, port = args.gcs.rsplit(":", 1)
    resources = {"CPU": args.num_cpus}
    labels: dict[str, str] = {}
    if args.num_gpus:
        resources[_GPU] = args.num_gpus
    else:
        for k, v in GPUAcceleratorManager.get_current_node_resources().items():
            resources.setdefault(k, v)
    for kv in filter(None, args.resources.split(",")):
        k, v = kv.split("=")
        resources[k] = float(v)
    for kv in filter(None, args.labels.split(",")):
        k, v = kv.split("=")
        labels[k] = v

    raylet_box: list[Raylet] = []

    def _terminate(signum, frame):
        # SIGTERM from the head's shutdown(): unlink the shm arena and kill
        # workers, or every run leaks object_store_memory of /dev/shm
        if raylet_box:
            r = raylet_box[0]
            for w in r.all_workers.values():
                try:
                    w.proc.terminate()
                except OSError:
                    pass
            try:
                r.store.destroy()
            except Exception:  # raylint: disable=RT012 — exiting via os._exit: nowhere to report
                pass
        os._exit(0)

    import signal

    signal.signal(signal.SIGTERM, _terminate)

    async def run():
        raylet = Raylet(
            (host, int(port)),
            resources=resources,
            store_capacity=args.store_capacity or None,
            labels=labels,
            session=args.session,
        )
        raylet_box.append(raylet)
        addr = await raylet.start()
        print(f"raylet {raylet.node_id.hex()[:8]} on {addr[0]}:{addr[1]}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        if raylet_box:
            try:
                raylet_box[0].store.destroy()
            except Exception:  # raylint: disable=RT012 — ^C teardown: nowhere to report
                pass


if __name__ == "__main__":
    main()
