"""Global Control Service: cluster metadata authority.

Equivalent of the reference GCS server (ref:
src/ray/gcs/gcs_server/gcs_server.h:90) — node registry + health checks
(gcs_health_check_manager.h:45), actor manager + scheduler
(gcs_actor_manager.h:329, gcs_actor_scheduler.h), placement groups with
two-phase bundle reservation (gcs_placement_group_mgr.h:232,
LeaseStatusTracker gcs_placement_group_scheduler.h:133), internal KV
(gcs_kv_manager.h:34), long-poll-free push pubsub (src/ray/pubsub/
publisher.h:300), and the function table the workers fetch code from.

Runs as its own process (``python -m ray_tpu_torch.core.gcs``); all state is
in-memory (the reference's default) — a Redis-style persistence backend can
slot behind the table dicts for GCS fault tolerance in a later iteration.
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.config import get_config
from ray_tpu_torch.core import policy
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.utils import aio, rpc
from ray_tpu_torch.utils.ids import ActorID, JobID, NodeID, PlacementGroupID

log = logging.getLogger(__name__)

# actor lifecycle states (ref: gcs.proto ActorTableData.ActorState)
PENDING = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


@dataclass
class NodeInfo:
    node_id: NodeID
    address: tuple[str, int]  # raylet rpc address
    store_name: str
    resources_total: dict[str, float]
    resources_available: dict[str, float]
    labels: dict[str, str] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    queued_leases: int = 0  # demand signal (autoscaler)
    pid: int = 0
    # sender-assigned monotonic version of this node's resource view
    # (ref: ray_syncer.h:83 versioned messages — stale deliveries are
    # dropped by version comparison, both at the GCS and at receivers)
    view_version: int = 0

    def view(self) -> dict:
        return {
            "node_id": self.node_id,
            "address": self.address,
            "store_name": self.store_name,
            "resources_total": dict(self.resources_total),
            "resources_available": dict(self.resources_available),
            "labels": dict(self.labels),
            "alive": self.alive,
            "queued_leases": self.queued_leases,
            "pid": self.pid,
            "view_version": self.view_version,
        }


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: str | None
    state: str
    spec: dict  # creation spec (class bytes ref, args, resources, options)
    address: tuple[str, int] | None = None
    node_id: NodeID | None = None
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: str | None = None

    def view(self) -> dict:
        return {
            "actor_id": self.actor_id,
            "name": self.name,
            "state": self.state,
            "address": self.address,
            "node_id": self.node_id,
            "num_restarts": self.num_restarts,
            "death_cause": self.death_cause,
            # driver-side method metadata: handles from get_actor() must
            # honor @method(num_returns=...) like creation handles do
            "method_num_returns": self.spec.get("method_num_returns") or {},
        }


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    bundles: list[dict[str, float]]
    strategy: str
    # state machine: PENDING -> CREATED -> (RESCHEDULING <-> CREATED) -> REMOVED
    # (ref: gcs_placement_group_mgr.h:232 PlacementGroupState — RESCHEDULING
    # is the reconciled-desired-state leg: bundles on dead nodes are
    # re-placed instead of the PG being abandoned)
    state: str
    # one slot per bundle; None = not (or no longer) placed. Fully
    # populated exactly when state == CREATED.
    bundle_nodes: list[NodeID | None] = field(default_factory=list)
    reschedule_cause: str | None = None
    reschedules: int = 0

    def __setstate__(self, state):
        # WAL/snapshot records from before the FT fields existed restore
        # without them: default in place so recovery never AttributeErrors
        self.__dict__.update(state)
        self.__dict__.setdefault("reschedule_cause", None)
        self.__dict__.setdefault("reschedules", 0)

    def lost_indices(self, alive: "set[NodeID]") -> list[int]:
        return [i for i, nid in enumerate(self.bundle_nodes)
                if nid is None or nid not in alive]


class BundleTxn:
    """Tracker for one two-phase reservation round over a subset of a
    PG's bundles (the LeaseStatusTracker role, ref:
    gcs_placement_group_scheduler.h:133). Prepare and commit each fan
    out in PARALLEL over the GCS's pooled raylet connections; per-bundle
    outcomes land in ``prepared`` / ``committed`` / ``failed`` so the
    caller can repair exactly what broke instead of raising out of the
    RPC with reservations stranded on every prepared node."""

    def __init__(self, gcs: "GcsServer", pg: PlacementGroupInfo,
                 placement: dict[int, NodeInfo]):
        self.gcs = gcs
        self.pg = pg
        self.placement = placement  # bundle index -> target node
        self.prepared: dict[int, NodeInfo] = {}
        self.committed: dict[int, NodeInfo] = {}
        self.failed: dict[int, NodeInfo] = {}

    async def _phase_one(self, point: str, method: str, index: int,
                         node: NodeInfo) -> bool:
        if chaos.ENABLED:
            # "gcs.pg_prepare" / "gcs.pg_commit" fault points: `error`
            # raises here and is absorbed as THAT bundle's phase failure
            # (repair re-places it); `drop` refuses the reservation;
            # `delay` time.sleeps the whole GCS loop — the
            # frozen-coordinator shape, same semantics as the other
            # GCS-side points (keep delay_ms small in plans)
            act = chaos.point(point, pg=self.pg.pg_id.hex()[:12],
                              bundle=index, node=node.node_id.hex()[:12])
            if act is not None and act.kind == "drop":
                return False
        # no call/phase timeout on purpose: wait_for task-wraps its
        # awaitable (~70µs per Task on a small host — it dominated the
        # create path). The unhang guarantee comes from the pool
        # instead: _mark_node_dead drops the node's pooled connection,
        # which fails every in-flight call here with ConnectionLost.
        r = await self.gcs._node_call(
            node, method,
            {"pg_id": self.pg.pg_id, "bundle_index": index,
             "resources": self.pg.bundles[index]})
        return bool(r and r.get("ok"))

    async def _phase(self, point: str, method: str,
                     items: list[tuple[int, NodeInfo]],
                     into: dict[int, NodeInfo]) -> bool:
        """Run one 2PC phase over ``items``. Bundles GROUP per node and
        each node's group rides ONE batched RPC (prepare_bundles /
        commit_bundles — one ledger pass raylet-side) since protocol
        2.0; distinct nodes still fan out in parallel (the RTTs
        overlap). A single bundle awaits directly — the gather/Task
        wrapping costs ~70µs a phase on a small host, most of a
        1-bundle PG's create path."""
        if len(items) == 1:
            index, node = items[0]
            try:
                ok = await self._phase_one(point, method, index, node)
            except Exception:
                ok = False
            (into if ok else self.failed)[index] = node
            return not self.failed
        groups: dict = {}
        for index, node in items:
            groups.setdefault(node.node_id, []).append((index, node))
        coros = []
        for group in groups.values():
            if len(group) == 1:
                coros.append(self._phase_single(point, method, group[0],
                                                into))
            else:
                coros.append(self._phase_group(point, method, group, into))
        if len(coros) == 1:
            await coros[0]
        else:
            await asyncio.gather(*coros)
        return not self.failed

    async def _phase_single(self, point: str, method: str, item, into):
        index, node = item
        try:
            ok = await self._phase_one(point, method, index, node)
        except Exception:
            ok = False
        (into if ok else self.failed)[index] = node

    async def _phase_group(self, point: str, method: str,
                           group: list, into) -> None:
        """One node's multi-bundle phase leg: per-bundle chaos verdicts
        first (an injected fault fails exactly that bundle, the rest
        still ride the batch), then ONE batched raylet RPC."""
        node = group[0][1]
        send: list[int] = []
        for index, _ in group:
            if chaos.ENABLED:
                try:
                    act = chaos.point(point, pg=self.pg.pg_id.hex()[:12],
                                      bundle=index,
                                      node=node.node_id.hex()[:12])
                except chaos.ChaosError:
                    self.failed[index] = node
                    continue
                if act is not None and act.kind == "drop":
                    self.failed[index] = node
                    continue
            send.append(index)
        if not send:
            return
        try:
            if method == "prepare_bundle":
                rs = await self.gcs._node_call(
                    node, "prepare_bundles",
                    {"pg_id": self.pg.pg_id,
                     "bundles": [(i, self.pg.bundles[i]) for i in send]})
            else:
                rs = await self.gcs._node_call(
                    node, "commit_bundles",
                    {"pg_id": self.pg.pg_id, "indices": send})
        except Exception:
            rs = None
        for pos, index in enumerate(send):
            ok = bool(rs and pos < len(rs) and rs[pos]
                      and rs[pos].get("ok"))
            (into if ok else self.failed)[index] = node

    async def prepare(self) -> bool:
        """Parallel phase 1. True iff every bundle reserved."""
        return await self._phase("gcs.pg_prepare", "prepare_bundle",
                                 list(self.placement.items()),
                                 self.prepared)

    async def commit(self) -> bool:
        """Parallel phase 2 over the prepared set. Failures (node died
        between phases, injected faults) land in ``failed`` for repair —
        they are NEVER raised out of the transaction."""
        return await self._phase("gcs.pg_commit", "commit_bundle",
                                 list(self.prepared.items()),
                                 self.committed)

    async def rollback(self) -> None:
        """Return every reservation this txn made that did not commit
        (prepared-only slots, plus commit-phase failures whose node may
        still hold the prepared bundle). Best effort: a dead node's
        reservation died with it; a live-but-unreachable node's
        uncommitted one is reclaimed by its own bundle-lease GC, and a
        commit that LANDED but whose ack was lost (lease GC skips
        committed entries) is caught by the GCS's periodic ledger audit
        (_audit_node_bundles)."""
        victims = [(self.pg.pg_id, i, n) for i, n in self.prepared.items()
                   if i not in self.committed]
        await self.gcs._return_bundles(victims)


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: str | None = None):
        self.cfg = get_config()
        self.persist_path = persist_path
        self._dirty = False
        self.server = rpc.make_server(host, port)
        self.server.add_routes(self)
        self.server.on_disconnect = self._on_disconnect
        # Native state engine (C++, _native/src/gcs_core.cc): KV tables,
        # write-ahead journal, snapshot/recovery all live native; this
        # process only dispatches RPCs and runs policy (ref role:
        # src/ray/gcs/gcs_server/store_client/redis_store_client.cc,
        # gcs_table_storage.h)
        from ray_tpu_torch.core.gcs_store import NativeGcsStore

        self.kvstore = NativeGcsStore(persist_path)
        # opt-in machine-crash durability (cfg.gcs_fsync): journaled KV
        # writes are acked only after their WAL record is fdatasync'd,
        # group-committed so every write landing in the same event-loop
        # tick shares ONE disk sync; snapshots fsync before their rename.
        # Default (off) remains process-kill-safe: appends are fflushed to
        # the OS page cache, which survives a GCS crash but not the box.
        self._fsync = bool(getattr(self.cfg, "gcs_fsync", False)) \
            and persist_path is not None
        if self._fsync:
            self.kvstore.set_fsync(True)
        self._sync_fut: asyncio.Future | None = None
        self.nodes: dict[NodeID, NodeInfo] = {}
        self.actors: dict[ActorID, ActorInfo] = {}
        self.named_actors: dict[str, ActorID] = {}
        self.pgs: dict[PlacementGroupID, PlacementGroupInfo] = {}
        self._actor_spread_rr = 0  # SPREAD actor round-robin cursor
        # per-raylet lease-request coalescer (_schedule_actor): concurrent
        # actor creations targeting the same node in one loop tick ride
        # ONE batched lease_workers RPC (one ledger pass raylet-side)
        self._lease_batches: dict[tuple, list] = {}
        self.job_counter = 0
        self.task_events: list[dict] = []  # ring buffer of task lifecycle events
        # trace assembler (utils/tracing.py wire context): span rows
        # riding report_task_events fold into per-trace buckets here, so
        # one request's causal tree is ONE lookup (rpc_get_trace) instead
        # of a scan over the whole event ring. Bounded by
        # cfg.trace_table_max with SLOW-TRACE retention: eviction
        # protects the slowest cfg.trace_slow_keep fraction (the p99
        # outliers tracing exists to explain) and drops the oldest of
        # the rest. Volatile (like task_events): not journaled.
        self.traces: dict[str, dict] = {}
        self._trace_cp_done: set[str] = set()  # critical path computed
        # ns="latency" retention (satellite): last-touch stamps per key;
        # the health loop sweeps entries dead publishers left behind
        self._latency_touched: dict[str, float] = {}
        # timeseries rollup plane (core/metrics_store.py): every
        # ns="metrics" snapshot put folds into ring-buffered 1s/10s/60s
        # windows here, so metric_window/prometheus rates read history
        # instead of the latest value. Volatile like the snapshots.
        from ray_tpu_torch.core.metrics_store import RollupStore

        self.rollups = RollupStore()

        # pubsub: channel -> {Connection}
        self.subs: dict[str, set[rpc.Connection]] = {}
        # connections that are raylets (for health/cleanup): conn -> node_id
        self.raylet_conns: dict[rpc.Connection, NodeID] = {}
        # pooled GCS->raylet connections for short control RPCs (bundle
        # prepare/commit/return): the old per-bundle rpc.connect loop was
        # most of the placement-group benchmark's cost. Never used for
        # parking calls (lease_worker), whose cancel-on-disconnect
        # semantics need a per-request connection.
        self._node_conns: dict[NodeID, rpc.Connection] = {}
        # placement-group reconciliation: pg ids with a drive pass in
        # flight (one reconciler per PG at a time)
        self._pg_reconciling: set[PlacementGroupID] = set()
        # actor worker connections for cleanup: conn -> actor_ids
        self._stopping = False
        self._bg = aio.TaskGroup()

    # ------------------------------------------------------------------ pubsub
    async def publish(self, channel: str, message: Any):
        if channel == "actors":
            # actor-table choke point: every actor state transition
            # publishes here — journal the entry's current state
            aid = message.get("actor_id") if isinstance(message, dict) else None
            info = self.actors.get(aid)
            if info is not None:
                self._journal(("actor", info))
        elif channel in ("pgs",) or channel.startswith("actor:"):
            self.mark_dirty()  # covered by the periodic snapshot
        dead = []
        for conn in self.subs.get(channel, ()):  # push-based: no long-poll
            try:
                await conn.notify("pubsub", {"channel": channel, "message": message})
            except Exception:
                dead.append(conn)
        for conn in dead:
            self.subs.get(channel, set()).discard(conn)

    async def rpc_subscribe(self, conn, p):
        self.subs.setdefault(p["channel"], set()).add(conn)
        return True

    async def rpc_publish(self, conn, p):
        """Client-originated pubsub (ref: GcsPublisher — workers publish
        through the GCS fan-out): the serve controller announces
        autoscale decisions on ``serve_autoscale`` this way."""
        await self.publish(p["channel"], p["message"])
        return True

    # ---------------------------------------------------------------------- kv
    # All KV state lives in the native engine; puts/dels journal to the
    # C++ WAL inside the same native call (GIL released throughout).
    async def rpc_kv_put(self, conn, p):
        ns = p.get("ns", "")
        journal = ns != "metrics"  # metrics are volatile: snapshot-only
        if chaos.ENABLED and journal:
            # "gcs.wal_append" fault point, journaled-KV flavor: an
            # `error` action raises out of this handler, so the client
            # sees a failed (never-acked, never-journaled) write —
            # delay stalls the ack like a slow disk would
            chaos.point("gcs.wal_append", ns=ns, kind="kv_put")
        ok = self.kvstore.put(ns, p["key"], p["value"],
                              overwrite=p.get("overwrite", True),
                              journal=journal)
        if ns == "metrics":
            # rollup ingest rides the same put the snapshot already
            # pays for (worker hex / raylet.<node> keys); a malformed
            # blob must not fail the kv write it piggybacks on
            try:
                self.rollups.ingest(p["key"], pickle.loads(p["value"]))
            except Exception:
                log.debug("metric rollup ingest failed", exc_info=True)
        if ns == "latency":  # retention clock (see _latency_sweep)
            self._latency_touched[p["key"]] = time.monotonic()
        self.mark_dirty()
        if journal:
            await self._commit_barrier()
        return ok

    async def rpc_kv_get(self, conn, p):
        return self.kvstore.get(p.get("ns", ""), p["key"])

    async def rpc_kv_multi_get(self, conn, p):
        return self.kvstore.multi_get(p.get("ns", ""), p["keys"])

    async def rpc_kv_del(self, conn, p):
        ok = self.kvstore.delete(p.get("ns", ""), p["key"])
        self.mark_dirty()
        await self._commit_barrier()
        return ok

    # ------------------------------------------------------- metric rollups
    async def rpc_metric_window(self, conn, p):
        """Windowed rate/quantile series from the rollup plane (since
        2.2): ``{name, type, res, points}`` — see RollupStore.window."""
        return self.rollups.window(p["name"], float(p.get("secs", 60.0)),
                                   tags=p.get("tags"))

    async def rpc_metric_names(self, conn, p):
        """Every metric the rollup plane has seen plus the derived
        ratio series it computes (since 2.2)."""
        return self.rollups.names()

    async def rpc_metric_export(self, conn, p):
        """Trailing per-tag counter rates + ratio values (since 2.2) —
        the prometheus ``:rate<secs>s`` family feed."""
        return self.rollups.export_rates(float(p.get("secs", 10.0)))

    async def _commit_barrier(self):
        """Group commit (cfg.gcs_fsync off = no-op): hold this journaled
        write's ack until its WAL record is on disk. One syncer future per
        event-loop tick — concurrent writers all await the same fdatasync
        (the classic group-commit amortization), which runs in an executor
        with the GIL released. A FAILED sync raises: the caller's RPC
        errors out instead of acking a write that is not durable (the
        whole point of the opt-in mode)."""
        if not self._fsync:
            return
        loop = asyncio.get_running_loop()
        fut = self._sync_fut
        if fut is None:
            fut = loop.create_future()
            self._sync_fut = fut

            async def sync(fut=fut):
                ok = False
                try:
                    await asyncio.sleep(0)  # let batch-mates append first
                    self._sync_fut = None
                    ok = await loop.run_in_executor(
                        None, self.kvstore.wal_sync)
                finally:
                    # cancellation-safe (stop() cancels _bg tasks while
                    # writers may be parked on fut): ALWAYS resolve the
                    # barrier and clear the slot, or those writers — and
                    # every later one finding the dead future — hang
                    if self._sync_fut is fut:
                        self._sync_fut = None
                    if not fut.done():
                        fut.set_result(ok)

            if self._bg.spawn(sync()) is None and not fut.done():
                # shutting down: sync inline rather than faking success
                # (stop()'s final snapshot has not happened yet). Clear
                # the slot — sync() never ran, and leaving a completed
                # future here would ack every later write without a sync.
                self._sync_fut = None
                fut.set_result(self.kvstore.wal_sync())
        if not await fut:
            raise RuntimeError(
                "GCS WAL fdatasync failed: write is NOT durable "
                "(gcs_fsync mode refuses to ack it)")

    def _kick_sync(self):
        """Fire-and-forget group sync for table-op journal records (actor
        transitions, job counters): the records reach disk promptly via
        the shared syncer, without withholding the mutation's reply."""
        if not self._fsync:
            return
        try:
            self._bg.spawn(self._commit_barrier())
        except RuntimeError:
            pass  # no running loop (restore path): snapshot covers it

    async def rpc_kv_exists(self, conn, p):
        return self.kvstore.exists(p.get("ns", ""), p["key"])

    async def rpc_kv_keys(self, conn, p):
        return self.kvstore.keys(p.get("ns", ""), p.get("prefix", ""))

    # -------------------------------------------------------------------- jobs
    async def rpc_register_job(self, conn, p):
        self.job_counter += 1
        self._journal(("job", self.job_counter))
        return JobID(self.job_counter.to_bytes(4, "little"))

    # ----------------------------------------------- pooled raylet control RPC
    async def _node_conn(self, node: NodeInfo) -> rpc.Connection:
        conn = self._node_conns.get(node.node_id)
        if conn is not None and not conn._closed:
            return conn
        conn = await rpc.connect(*node.address,
                                 timeout=self.cfg.rpc_connect_timeout_s)
        cur = self._node_conns.get(node.node_id)
        if cur is not None and not cur._closed:
            # lost a concurrent-dial race (parallel 2PC legs to one
            # node): keep the pooled winner, close ours — overwriting
            # would leak the first socket until process exit
            self._bg.spawn(conn.close())
            return cur
        self._node_conns[node.node_id] = conn
        return conn

    def _drop_node_conn(self, node_id: NodeID) -> None:
        conn = self._node_conns.pop(node_id, None)
        if conn is not None:
            self._bg.spawn(conn.close())

    async def _node_call(self, node: NodeInfo, method: str, payload: dict,
                         timeout: float | None = None):
        """One short control RPC over the pooled connection. A pooled
        socket that died since its last use is replaced and the call
        retried ONCE on the fresh dial; a failure on the fresh socket is
        the node's problem and propagates."""
        for attempt in (0, 1):
            try:
                conn = await self._node_conn(node)
                return await conn.call(method, payload, timeout=timeout)
            except (rpc.RpcError, OSError, asyncio.TimeoutError):
                self._drop_node_conn(node.node_id)
                if attempt:
                    raise

    async def _return_bundles(
            self,
            victims: list[tuple[PlacementGroupID, int, NodeInfo]]) -> None:
        """Parallel best-effort bundle returns (2PC rollback/repair,
        remove and drain paths). Dead or unreachable nodes are skipped —
        their reservations are reclaimed by the raylet bundle-lease GC
        or died with the process."""

        async def one(pg_id: PlacementGroupID, index: int, node: NodeInfo):
            try:
                # no wait_for (Task-wrap cost, see BundleTxn._phase_one):
                # a dying node's pooled conn drop fails this call instead
                await self._node_call(
                    node, "return_bundle",
                    {"pg_id": pg_id, "bundle_index": index})
            except Exception:
                log.debug("bundle return failed on %s",
                          node.node_id.hex()[:12], exc_info=True)

        live = [(p, i, n) for p, i, n in victims
                if self.nodes.get(n.node_id) is not None
                and self.nodes[n.node_id].alive]
        if len(live) == 1:
            await one(*live[0])  # skip the gather wrapping (see _phase)
        elif live:
            await asyncio.gather(*(one(p, i, n) for p, i, n in live))

    # ------------------------------------------------------------------- nodes
    async def rpc_register_node(self, conn, p):
        info = NodeInfo(
            node_id=p["node_id"],
            address=tuple(p["address"]),
            store_name=p["store_name"],
            resources_total=dict(p["resources"]),
            resources_available=dict(p["resources"]),
            labels=p.get("labels", {}),
            pid=int(p.get("pid", 0)),
        )
        self.nodes[info.node_id] = info
        self._drop_node_conn(info.node_id)  # pooled socket may predate a restart
        # a re-registering raylet (GCS-FT reconnect) replaces its old
        # connection mapping, so the old socket's close is a no-op
        for old_conn, nid in list(self.raylet_conns.items()):
            if nid == info.node_id and old_conn is not conn:
                self.raylet_conns.pop(old_conn, None)
        self.raylet_conns[conn] = info.node_id
        # bundle reconciliation (GCS FT): the raylet reports every bundle
        # reservation its ledger holds; reservations the recovered pgs
        # table doesn't recognize are returned, committed ones it does are
        # adopted back into bundle_nodes (the table may have been restored
        # from a snapshot older than the placement)
        stale = self._reconcile_reported_bundles(
            info, p.get("bundles") or ())
        await self.publish("nodes", {"event": "added", "node": info.view()})
        # fresh capacity: wake PENDING (infeasible-at-create) and
        # RESCHEDULING placement groups
        self._kick_pgs()
        return {"node_id": info.node_id, "cluster": self.cluster_view(),
                "return_bundles": stale}

    def _reconcile_reported_bundles(self, info: NodeInfo, reported,
                                    live_audit: bool = False) -> list[tuple]:
        stale: list[tuple] = []
        for b in reported:
            pg_id, index = b["pg_id"], int(b["bundle_index"])
            pg = self.pgs.get(pg_id)
            if (pg is None or pg.state == "REMOVED"
                    or index >= len(pg.bundles)):
                stale.append((pg_id, index))
                continue
            if not b.get("committed"):
                # registration path: a reservation the coordinating 2PC
                # never committed (it died with the old GCS) — return it.
                # Live-audit path: this may be THIS GCS's own prepare in
                # flight between the phases — leave it to the raylet's
                # bundle-lease GC.
                if not live_audit:
                    stale.append((pg_id, index))
                continue
            if len(pg.bundle_nodes) != len(pg.bundles):
                pg.bundle_nodes = [None] * len(pg.bundles)
            current = pg.bundle_nodes[index]
            if current is not None and current != info.node_id:
                # rescheduled elsewhere while this node was away: its old
                # copy of the bundle is stale capacity
                stale.append((pg_id, index))
            elif current is None and pg_id in self._pg_reconciling:
                # a repair txn for this PG is mid-flight and may be about
                # to commit this very slot on another node — adopting now
                # would be overwritten by the commit and strand this
                # node's committed reservation forever (the lease GC only
                # reclaims uncommitted ones). Return it; the txn's
                # outcome is authoritative.
                stale.append((pg_id, index))
            else:
                pg.bundle_nodes[index] = info.node_id
        return stale

    async def rpc_heartbeat(self, conn, p):
        info = self.nodes.get(p["node_id"])
        if info is None:
            return {"ok": False}
        info.last_heartbeat = time.monotonic()
        # queued_leases is a latest-wins scalar independent of the versioned
        # resource view: apply it even on stale frames so the autoscaler
        # demand signal tracks the most recent report
        if "queued_leases" in p:
            info.queued_leases = int(p.get("queued_leases", 0))
        version = int(p.get("version", 0))
        if version and version <= info.view_version:
            # stale or reordered report (e.g. a delayed frame after a GCS
            # reconnect): liveness refreshed above, view NOT applied
            return {"ok": True, "stale": True}
        if p.get("resources_available") is not None:
            changed = info.resources_available != p["resources_available"]
            info.resources_available = dict(p["resources_available"])
            if version:
                info.view_version = version
            if changed:
                # versioned resource-view gossip to all raylets (the
                # RaySyncer role, ref: ray_syncer.h:83)
                await self.publish("nodes", {"event": "updated", "node": info.view()})
        return {"ok": True}

    async def rpc_get_cluster(self, conn, p):
        return self.cluster_view()

    def cluster_view(self) -> list[dict]:
        return [n.view() for n in self.nodes.values() if n.alive]

    async def rpc_drain_node(self, conn, p):
        node_id = p["node_id"]
        info = self.nodes.get(node_id)
        if info is not None and info.alive:
            # graceful half of a drain: hand the node's bundle
            # reservations back (one parallel wave) while its raylet is
            # still up, so the ledger frees NOW instead of waiting on
            # the raylet-side bundle-lease GC after the dead-mark
            victims = []
            for pg in self.pgs.values():
                if pg.state == "REMOVED":
                    continue
                victims.extend(
                    (pg.pg_id, i, info)
                    for i, nid in enumerate(pg.bundle_nodes)
                    if nid == node_id)
            await self._return_bundles(victims)
        await self._mark_node_dead(node_id, "drained")
        return True

    async def _mark_node_dead(self, node_id: NodeID, cause: str):
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        self._drop_node_conn(node_id)
        await self.publish("nodes", {"event": "removed", "node_id": node_id, "cause": cause})
        # dedicated low-traffic channel for location-cache invalidation:
        # every CoreClient subscribes to THIS, not "nodes" — the "nodes"
        # channel also carries per-heartbeat resource gossip that every
        # driver and worker would otherwise receive and discard
        await self.publish("node_removed", {"node_id": node_id})
        # placement groups FIRST (before the actor failover below): a
        # PG-bound actor rescheduling must observe RESCHEDULING and wait
        # for the repair — not a still-CREATED pg whose bundle_nodes
        # point at the dead node, which would spin its _pick_node loop
        # against a bundle that can never grant until the start timeout
        # killed it
        for pg in list(self.pgs.values()):
            if pg.state not in ("CREATED", "RESCHEDULING"):
                continue
            lost = [i for i, nid in enumerate(pg.bundle_nodes)
                    if nid == node_id]
            if lost:
                await self._reschedule_lost(
                    pg, lost, f"node {node_id.hex()[:12]} {cause}")
        # fail actors living on that node (ref: gcs_actor_manager.cc OnNodeDead)
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state in (ALIVE, PENDING):
                await self._on_actor_failure(actor, f"node {node_id} died: {cause}")

    # ------------------------------------------------------------------ actors
    async def rpc_register_actor(self, conn, p):
        spec = p["spec"]
        actor_id = spec["actor_id"]
        name = spec.get("name")
        if name:
            if name in self.named_actors:
                existing = self.actors.get(self.named_actors[name])
                if existing is not None and existing.state != DEAD:
                    if spec.get("get_if_exists"):
                        return existing.view()
                    raise ValueError(f"actor name {name!r} already taken")
        info = ActorInfo(
            actor_id=actor_id,
            name=name,
            state=PENDING,
            spec=spec,
            max_restarts=spec.get("max_restarts", 0),
        )
        self.actors[actor_id] = info
        self._journal(("actor", info))
        if name:
            self.named_actors[name] = actor_id
            self._journal(("name", name, actor_id))
        self._bg.spawn(self._schedule_actor(info))
        return info.view()

    async def _schedule_actor(self, info: ActorInfo):
        """GCS-side actor scheduling (ref: gcs_actor_scheduler.h): lease a
        worker from a raylet chosen by resource fit, then push the creation
        task to that worker directly. Lease races and raylet deaths
        retry with exponential backoff + jitter under ONE
        worker_start_timeout_s deadline (the old path respawned itself
        with a flat 0.05s sleep and a fresh deadline every time —
        raylint RT013's synchronized-herd shape, and an actor could
        retry forever)."""
        try:
            resources = info.spec.get("resources", {"CPU": 1.0})
            pg_id = info.spec.get("placement_group")
            bundle_index = info.spec.get("bundle_index", -1)
            strategy = info.spec.get("scheduling_strategy")
            deadline = time.monotonic() + self.cfg.worker_start_timeout_s
            retries = 0
            while True:
                node = self._pick_node(resources, pg_id, bundle_index,
                                       strategy)
                if node is None:
                    if time.monotonic() > deadline:
                        info.state = DEAD
                        info.death_cause = (
                            f"no node can host actor resources {resources}"
                            + (f" under strategy {strategy}" if strategy
                               else "")
                            + (" (placement group not CREATED)"
                               if pg_id is not None else ""))
                        await self.publish("actors", info.view())
                        await self.publish(
                            f"actor:{info.actor_id.hex()}", info.view())
                        return
                    await asyncio.sleep(0.1)  # poll: placement may repair
                    continue
                # leases ride the batched lease_workers path (2.0):
                # concurrent actor creations targeting the same raylet
                # coalesce into ONE RPC and one ledger pass; the batched
                # handler never parks (busy replies retry here), so no
                # cancel-on-disconnect concern remains
                lease = None
                try:
                    lease = await self._lease_via_batch(
                        node,
                        {"resources": resources,
                         "for_actor": info.actor_id,
                         "pg_id": pg_id, "bundle_index": bundle_index},
                        timeout=max(1.0, deadline - time.monotonic()),
                    )
                except (rpc.RpcError, OSError, asyncio.TimeoutError):
                    # chosen raylet died or stalled mid-grant: re-pick —
                    # node death will have updated self.nodes by the time
                    # the backoff elapses
                    log.debug("actor lease attempt on %s failed",
                              node.node_id.hex()[:12], exc_info=True)
                if lease and lease.get("granted"):
                    break
                if time.monotonic() > deadline:
                    info.state = DEAD
                    info.death_cause = (
                        f"actor lease not granted within "
                        f"worker_start_timeout_s="
                        f"{self.cfg.worker_start_timeout_s}")
                    await self.publish("actors", info.view())
                    await self.publish(
                        f"actor:{info.actor_id.hex()}", info.view())
                    return
                retries += 1
                base = min(0.05 * (2 ** min(retries, 5)), 1.0)
                await asyncio.sleep(base * (0.5 + random.random() / 2))

            worker_addr = tuple(lease["worker_address"])
            wconn = await rpc.connect(*worker_addr)
            try:
                await wconn.call(
                    "create_actor",
                    {"spec": info.spec, "gpu_ids": lease.get("gpu_ids")},
                    timeout=self.cfg.worker_start_timeout_s,
                )
            finally:
                await wconn.close()
            info.state = ALIVE
            info.address = worker_addr
            info.node_id = node.node_id
            await self.publish("actors", info.view())
            await self.publish(f"actor:{info.actor_id.hex()}", info.view())
        except Exception as e:  # scheduling failed terminally
            info.state = DEAD
            info.death_cause = f"actor creation failed: {e!r}"
            await self.publish("actors", info.view())
            await self.publish(f"actor:{info.actor_id.hex()}", info.view())

    async def _lease_via_batch(self, node: "NodeInfo", payload: dict,
                               timeout: float):
        """Coalesced actor-lease request: every request targeting the
        same raylet address queued within one loop tick ships as ONE
        ``lease_workers`` call (a serve scale-up creating N replicas
        pays one RPC + one ledger pass instead of N). Goes over a
        per-batch transient connection, like the old per-request dial."""
        addr = tuple(node.address)
        fut = asyncio.get_running_loop().create_future()
        q = self._lease_batches.setdefault(addr, [])
        q.append((payload, fut))
        if len(q) == 1:
            # flush NEXT tick so same-tick siblings can pile on
            asyncio.get_running_loop().call_soon(
                lambda: self._bg.spawn(self._flush_lease_batch(addr)))
        return await asyncio.wait_for(fut, timeout)

    async def _flush_lease_batch(self, addr: tuple) -> None:
        batch = self._lease_batches.pop(addr, [])
        if not batch:
            return
        payloads = [p for p, _ in batch]
        replies = None
        err: Exception | None = None
        try:
            conn = await rpc.connect(*addr, timeout=5)
            try:
                replies = await conn.call(
                    "lease_workers", {"requests": payloads},
                    timeout=self.cfg.worker_start_timeout_s + 10)
            finally:
                await conn.close()
        except Exception as e:
            err = e if isinstance(e, Exception) else rpc.RpcError(repr(e))
        for i, (_, fut) in enumerate(batch):
            rep = (replies[i] if replies is not None and i < len(replies)
                   else None)
            if fut.done():
                # caller timed out/cancelled while the grant was in
                # flight: nobody owns this lease now — return it, or the
                # worker and its allocation leak (actor leases are not
                # owner_bound, so no disconnect sweep reclaims them)
                if rep and rep.get("granted"):
                    self._bg.spawn(self._return_orphan_lease(addr, rep))
                continue
            if err is not None or rep is None:
                fut.set_exception(
                    err or rpc.RpcError("short lease_workers reply"))
            else:
                fut.set_result(rep)

    async def _return_orphan_lease(self, addr: tuple, rep: dict) -> None:
        """Best-effort return (kill: single-purpose actor worker) of a
        batched lease whose requester gave up before the grant landed."""
        try:
            conn = await rpc.connect(*addr, timeout=5)
            try:
                await conn.call("return_lease",
                                {"lease_id": rep["lease_id"], "kill": True},
                                timeout=10)
            finally:
                await conn.close()
        except Exception:
            log.debug("orphan lease return failed", exc_info=True)

    def _pick_node(self, resources, pg_id=None, bundle_index=-1,
                   strategy=None) -> NodeInfo | None:
        if pg_id is not None:
            pg = self.pgs.get(pg_id)
            if pg is None or pg.state != "CREATED":
                return None
            candidates = (
                [pg.bundle_nodes[bundle_index]]
                if bundle_index >= 0
                else list(dict.fromkeys(pg.bundle_nodes))
            )
            alive = [n for n in (self.nodes.get(nid) for nid in candidates)
                     if n and n.alive]
            # a node's reported view excludes what its bundles reserved: a
            # bundle of the node's last card leaves it 0 there, so the
            # bundle's own ledger on the raylet decides (busy replies retry)
            return next((n for n in alive if _fits(resources, n.resources_available)),
                        alive[0] if alive else None)
        fitting = [node for node in self.nodes.values()
                   if node.alive and _fits(resources, node.resources_available)]
        if strategy is not None:
            # actor-site scheduling strategies (ref: gcs_actor_scheduler
            # consulting the cluster scheduling policies)
            from ray_tpu_torch.util.scheduling_strategies import labels_match

            t = strategy.get("type")
            if t == "node_affinity":
                node = next((n for n in fitting
                             if n.node_id.hex() == strategy["node_id"]), None)
                if node is not None or not strategy.get("soft"):
                    return node  # hard: only that node (None => retry/DEAD)
            elif t == "spread":
                self._actor_spread_rr += 1
                ordered = sorted(fitting, key=lambda n: n.node_id.hex())
                if ordered:
                    return ordered[self._actor_spread_rr % len(ordered)]
                return None
            elif t == "node_label":
                hard = strategy.get("hard", {})
                soft = strategy.get("soft", {})
                matching = [n for n in fitting
                            if labels_match(n.labels, hard)]
                preferred = [n for n in matching
                             if labels_match(n.labels, soft)]
                fitting = preferred or matching
        # hybrid top-k (ref: hybrid_scheduling_policy.h:50 + policy/scorer.h,
        # shared impl in core/policy.py): randomize among comfortable nodes,
        # deterministic best when everything is tight.
        scored = [
            (policy.score(resources, node.resources_total,
                          node.resources_available), node)
            for node in fitting
        ]
        return policy.pick(scored)

    async def rpc_get_actor(self, conn, p):
        actor_id = p.get("actor_id")
        if actor_id is None:
            actor_id = self.named_actors.get(p["name"])
            if actor_id is None:
                return None
        info = self.actors.get(actor_id)
        return info.view() if info else None

    async def rpc_list_actors(self, conn, p):
        return [a.view() for a in self.actors.values()]

    async def rpc_list_placement_groups(self, conn, p):
        return [self._pg_view(pg) for pg in self.pgs.values()]

    async def rpc_report_actor_death(self, conn, p):
        info = self.actors.get(p["actor_id"])
        if info is not None and info.state != DEAD:
            await self._on_actor_failure(info, p.get("cause", "actor process died"))
        return True

    async def rpc_kill_actor(self, conn, p):
        info = self.actors.get(p["actor_id"])
        if info is None:
            return False
        info.max_restarts = 0  # explicit kill never restarts
        if info.address is not None:
            try:
                wconn = await rpc.connect(*info.address, timeout=2)
                await wconn.notify("exit_worker", {"force": not p.get("no_restart", False)})
                await wconn.close()
            except (rpc.RpcError, OSError):
                pass  # worker already dead: the kill is moot
        await self._on_actor_failure(info, "killed via kill_actor")
        return True

    async def _on_actor_failure(self, info: ActorInfo, cause: str):
        if info.num_restarts < info.max_restarts:
            info.num_restarts += 1
            info.state = RESTARTING
            info.address = None
            info.node_id = None
            await self.publish("actors", info.view())
            await self.publish(f"actor:{info.actor_id.hex()}", info.view())
            self._bg.spawn(self._schedule_actor(info))
        else:
            info.state = DEAD
            info.death_cause = cause
            info.address = None
            await self.publish("actors", info.view())
            await self.publish(f"actor:{info.actor_id.hex()}", info.view())
            if info.name and self.named_actors.get(info.name) == info.actor_id:
                del self.named_actors[info.name]
                self._journal(("namedel", info.name))

    # -------------------------------------------------------- placement groups
    # PGs are a RECONCILED desired state, not a one-shot RPC (ref:
    # gcs_placement_group_mgr.h:232 + the Borg model of placement as a
    # converged spec): _drive_pg runs the two-phase reservation through a
    # BundleTxn with parallel prepare/commit over pooled connections,
    # repairs commit-phase failures by re-placing exactly the failed
    # bundles, and is re-kicked by node registration, node death, and the
    # health-loop sweep until the PG converges (or is removed).

    async def rpc_create_placement_group(self, conn, p):
        """Two-phase bundle reservation across raylets (ref:
        gcs_placement_group_scheduler.h:288 prepare/commit protocol)."""
        pg_id = p["pg_id"]
        bundles = p["bundles"]
        strategy = p.get("strategy", "PACK")
        pg = PlacementGroupInfo(
            pg_id=pg_id, bundles=bundles, strategy=strategy, state="PENDING",
            bundle_nodes=[None] * len(bundles))
        self.pgs[pg_id] = pg
        self._journal(("pg", pg))
        await self._reconcile_pg(pg)
        if pg.state == "CREATED":
            return {"state": "CREATED",
                    "bundle_nodes": list(pg.bundle_nodes)}
        # infeasible now: the PG stays PENDING and a later node
        # registration wakes it (the caller's ready()/wait observes the
        # transition via the "pgs" pubsub channel)
        return {"state": "INFEASIBLE"}

    async def _reschedule_lost(self, pg: PlacementGroupInfo,
                               lost: list[int], cause: str) -> None:
        """Shared node-loss bookkeeping (_mark_node_dead and the
        GCS-restart sweep): null the lost slots, move to RESCHEDULING,
        stamp the cause, journal + publish the transition, kick the
        reconciler (a no-op while a pass is in flight — that pass's
        liveness re-check picks the loss up instead)."""
        for i in lost:
            pg.bundle_nodes[i] = None
        pg.state = "RESCHEDULING"
        pg.reschedules += 1
        pg.reschedule_cause = cause
        self._journal(("pg", pg))
        await self._publish_pg(pg)
        self._kick_pg(pg)

    async def _audit_node_bundles(self, info: NodeInfo) -> None:
        """Audit one live node's bundle ledger against the pgs table:
        reservations the table doesn't assign to this node are returned
        (stranded committed bundles included), recognized committed ones
        are adopted — the same reconciliation re-registration runs,
        initiated server-side on the health-loop cadence."""
        try:
            held = await self._node_call(info, "list_bundles", {})
        except Exception:
            log.debug("bundle audit of %s failed",
                      info.node_id.hex()[:12], exc_info=True)
            return
        stale = self._reconcile_reported_bundles(info, held or (),
                                                 live_audit=True)
        if stale:
            await self._return_bundles(
                [(pg_id, index, info) for pg_id, index in stale])

    def _kick_pg(self, pg: PlacementGroupInfo) -> None:
        if (pg.state in ("PENDING", "RESCHEDULING")
                and pg.pg_id not in self._pg_reconciling):
            self._bg.spawn(self._reconcile_pg(pg))

    def _kick_pgs(self) -> None:
        for pg in list(self.pgs.values()):
            self._kick_pg(pg)

    async def _reconcile_pg(self, pg: PlacementGroupInfo) -> None:
        """Serialized entry: at most one drive pass per PG in flight."""
        if pg.pg_id in self._pg_reconciling:
            return
        self._pg_reconciling.add(pg.pg_id)
        try:
            await self._drive_pg(pg)
        finally:
            self._pg_reconciling.discard(pg.pg_id)

    async def _drive_pg(self, pg: PlacementGroupInfo) -> None:
        """One reconciliation pass: place every unassigned/lost bundle,
        2PC the placement, repair per-bundle failures by re-placing them
        on other nodes. Leaves the PG PENDING/RESCHEDULING when the
        cluster can't satisfy it right now — node registration or the
        health-loop sweep kicks another pass later."""
        bad: set[NodeID] = set()  # nodes that failed a phase this pass
        failures = 0
        for _round in range(16):  # hard cap: the next kick resumes
            if pg.state not in ("PENDING", "RESCHEDULING"):
                return
            if len(pg.bundle_nodes) != len(pg.bundles):
                pg.bundle_nodes = [None] * len(pg.bundles)
            alive = {nid for nid, n in self.nodes.items() if n.alive}
            lost = pg.lost_indices(alive)
            if not lost:
                # the liveness check above is the ONLY gate to CREATED:
                # a node death that landed while this pass was awaiting
                # a 2PC phase (its _kick_pg no-opped on the reconciling
                # guard) shows up here as a fresh lost slot and loops
                # back into placement instead of being declared CREATED
                # with a dead/None bundle_nodes entry
                await self._pg_created(pg)
                return
            if failures >= 4:
                break
            for i in lost:
                pg.bundle_nodes[i] = None
            survivors = {nid for nid in pg.bundle_nodes if nid is not None}
            placement = self._place_bundles(
                [pg.bundles[i] for i in lost], pg.strategy,
                exclude=bad, used=survivors)
            if placement is None:
                if bad:
                    # a phase-failed node may have been a transient fault,
                    # not a death: widen the candidate set once before
                    # giving up the pass
                    bad.clear()
                    continue
                return  # infeasible now; stays PENDING/RESCHEDULING
            txn = BundleTxn(self, pg, dict(zip(lost, placement)))
            if not await txn.prepare():
                await txn.rollback()
                bad.update(n.node_id for n in txn.failed.values())
                failures += 1
                continue
            await txn.commit()
            if pg.state == "REMOVED":
                # removal raced the commit: hand everything straight back
                await self._return_bundles(
                    [(pg.pg_id, i, n) for i, n in txn.placement.items()])
                return
            for index, node in txn.committed.items():
                pg.bundle_nodes[index] = node.node_id
            if txn.failed:
                # commit-phase failures (node died between phases /
                # injected fault): REPAIR — return what may still be
                # reserved there and re-place just those bundles — never
                # raise out with reservations stranded
                await txn.rollback()
                bad.update(n.node_id for n in txn.failed.values())
                failures += 1
            # success or repair: loop back to the liveness re-check
        log.warning("placement group %s did not converge this pass "
                    "(state=%s); will retry on the next kick",
                    pg.pg_id.hex()[:12], pg.state)

    async def _pg_created(self, pg: PlacementGroupInfo) -> None:
        pg.state = "CREATED"
        self._journal(("pg", pg))
        await self._publish_pg(pg)

    def _pg_view(self, pg: PlacementGroupInfo) -> dict:
        return {
            "pg_id": pg.pg_id.hex(),
            "bundles": pg.bundles,
            "strategy": pg.strategy,
            "state": pg.state,
            "bundle_nodes": [n.hex() if n is not None else None
                             for n in pg.bundle_nodes],
            "reschedule_cause": pg.reschedule_cause,
            "reschedules": pg.reschedules,
        }

    async def _publish_pg(self, pg: PlacementGroupInfo) -> None:
        await self.publish("pgs", dict(self._pg_view(pg), ts=time.time()))

    def _place_bundles(self, bundles, strategy, *,
                       exclude: set | frozenset = frozenset(),
                       used: set | frozenset = frozenset(),
                       ) -> list[NodeInfo] | None:
        """Place ``bundles`` on alive nodes. ``exclude`` removes nodes
        from candidacy entirely (repair passes exclude nodes that just
        failed a 2PC phase); ``used`` seeds the spread constraint with
        nodes already holding SURVIVING bundles of the same PG, so a
        STRICT_SPREAD repair never doubles up on a survivor."""
        alive = [n for n in self.nodes.values()
                 if n.alive and n.node_id not in exclude]
        avail = {n.node_id: dict(n.resources_available) for n in alive}

        def take(node, bundle):
            for k, v in bundle.items():
                if avail[node.node_id].get(k, 0.0) < v - 1e-9:
                    return False
            for k, v in bundle.items():
                avail[node.node_id][k] -= v
            return True

        assignment: list[NodeInfo] = []
        if strategy in ("STRICT_PACK", "PACK"):
            # try to fit everything on one node first; a partial
            # STRICT_PACK repair must land on the node holding the
            # surviving bundles (there is at most one by construction)
            candidates = ([n for n in alive if n.node_id in used]
                          if strategy == "STRICT_PACK" and used else alive)
            for n in candidates:
                snapshot = dict(avail[n.node_id])
                if _fits_all(bundles, snapshot):
                    for b in bundles:
                        take(n, b)
                    return [n] * len(bundles)
            if strategy == "STRICT_PACK":
                return None
        if strategy in ("SPREAD", "STRICT_SPREAD", "PACK"):
            nodes_sorted = sorted(alive, key=lambda n: -sum(avail[n.node_id].values()))
            pg_used: set[NodeID] = set(used)
            for b in bundles:
                placed = False
                for n in nodes_sorted:
                    if strategy == "STRICT_SPREAD" and n.node_id in pg_used:
                        continue
                    if take(n, b):
                        assignment.append(n)
                        pg_used.add(n.node_id)
                        placed = True
                        break
                if not placed:
                    return None
            return assignment
        return None

    async def rpc_remove_placement_group(self, conn, p):
        pg = self.pgs.get(p["pg_id"])
        if pg is None:
            return False
        victims = [(pg.pg_id, i, self.nodes[nid])
                   for i, nid in enumerate(pg.bundle_nodes)
                   if nid is not None and nid in self.nodes]
        pg.state = "REMOVED"  # set BEFORE the returns: an in-flight
        pg.bundle_nodes = []  # reconcile pass observes it and backs out
        self._journal(("pg", pg))
        await self._return_bundles(victims)
        await self._publish_pg(pg)
        return True

    async def rpc_get_placement_group(self, conn, p):
        pg = self.pgs.get(p["pg_id"])
        if pg is None:
            return None
        return {"state": pg.state, "bundle_nodes": list(pg.bundle_nodes),
                "bundles": pg.bundles, "strategy": pg.strategy,
                "reschedule_cause": pg.reschedule_cause,
                "reschedules": pg.reschedules}

    # -------------------------------------------------- task events / timeline
    async def rpc_report_task_events(self, conn, p):
        events = p["events"]
        self.task_events.extend(events)
        cap = getattr(self.cfg, "gcs_task_events_cap", 100_000)
        if len(self.task_events) > cap:
            del self.task_events[: len(self.task_events) - cap]
        for ev in events:
            if ev.get("state") == "SPAN":
                self._trace_ingest(ev)
        return True

    async def rpc_get_task_events(self, conn, p):
        events = self.task_events
        if p.get("span_only"):
            events = [e for e in events if e.get("state") == "SPAN"]
        offset = int(p.get("offset") or 0)
        limit = p.get("limit")
        if offset:
            events = events[:-offset] if offset < len(events) else []
        if limit is not None:
            events = events[-int(limit):]
        return list(events)

    # ------------------------------------------------- trace assembler
    def _trace_ingest(self, ev: dict) -> None:
        """Fold one span row into its trace bucket (report ingest)."""
        span = ev.get("span") or {}
        trace_id = span.get("trace_id")
        if not trace_id:
            return
        row = {**span,
               "task_id": ev.get("task_id"),
               "worker_id": ev.get("worker_id"),
               "node_id": ev.get("node_id"),
               "pid": ev.get("pid")}
        tr = self.traces.get(trace_id)
        if tr is None:
            if len(self.traces) >= max(2, self.cfg.trace_table_max):
                self._trace_evict()
            tr = self.traces[trace_id] = {
                "spans": [], "start_ts": row.get("start_ts", 0.0),
                "end_ts": row.get("end_ts", 0.0),
                "touched": time.monotonic()}
        if len(tr["spans"]) < max(8, self.cfg.trace_spans_max):
            tr["spans"].append(row)
        tr["start_ts"] = min(tr["start_ts"], row.get("start_ts", tr["start_ts"]))
        tr["end_ts"] = max(tr["end_ts"], row.get("end_ts", tr["end_ts"]))
        tr["touched"] = time.monotonic()
        # NOTE: _trace_cp_done stays sticky — a straggler span landing
        # after the critical-path pass joins the assembled trace (the
        # get_trace view recomputes live) but must not re-OBSERVE the
        # whole stage set into the histogram (metrics are once per trace)

    def _trace_evict(self) -> None:
        """Slow-trace retention: protect the slowest ``trace_slow_keep``
        fraction (by root wall duration), evict the OLDEST of the rest —
        the p99 outlier you will be paged about at 3am survives, the
        10,000 identical fast requests around it are sampled by age."""
        items = list(self.traces.items())
        keep = max(1, int(len(items) * self.cfg.trace_slow_keep))
        by_dur = sorted(items, key=lambda kv: kv[1]["end_ts"] - kv[1]["start_ts"],
                        reverse=True)
        protected = {tid for tid, _ in by_dur[:keep]}
        evictable = [(tid, tr) for tid, tr in items if tid not in protected]
        if not evictable:
            evictable = items
        victim = min(evictable, key=lambda kv: kv[1]["touched"])[0]
        self.traces.pop(victim, None)
        self._trace_cp_done.discard(victim)

    def _trace_view(self, trace_id: str, tr: dict,
                    with_spans: bool) -> dict:
        spans = tr["spans"]
        procs = {(s.get("node_id"), s.get("pid")) for s in spans}
        view = {
            "trace_id": trace_id,
            "start_ts": tr["start_ts"],
            "end_ts": tr["end_ts"],
            "dur_ms": max(0.0, tr["end_ts"] - tr["start_ts"]) * 1e3,
            "n_spans": len(spans),
            "procs": len(procs),
        }
        # root name: earliest parentless span — O(n), no critical-path
        # interval math (list_traces runs this per trace per poll)
        ids = {s.get("span_id") for s in spans}
        roots = [s for s in spans if s.get("parent_span_id") not in ids]
        if roots:
            view["root_name"] = min(
                roots, key=lambda s: s.get("start_ts", 0.0)).get("name")
        if with_spans:
            from ray_tpu_torch.utils.tracing import TraceCriticalPath

            view["spans"] = sorted(spans,
                                   key=lambda s: s.get("start_ts", 0.0))
            view["critical_path"] = TraceCriticalPath.compute(spans)
        return view

    async def rpc_get_trace(self, conn, p):
        tr = self.traces.get(p["trace_id"])
        if tr is None:
            return None
        return self._trace_view(p["trace_id"], tr, with_spans=True)

    async def rpc_list_traces(self, conn, p):
        rows = [self._trace_view(tid, tr, with_spans=False)
                for tid, tr in self.traces.items()]
        rows.sort(key=lambda r: r["start_ts"], reverse=True)
        offset = int(p.get("offset") or 0)
        limit = int(p.get("limit") or 1000)
        return rows[offset:offset + limit]

    _CP_BOUNDS = (10.0, 100.0, 1e3, 1e4, 1e5, 1e6, 1e7)

    def _trace_metrics_tick(self) -> None:
        """Critical-path pass over QUIESCED traces (no new span for >2
        flush intervals): attribute each sampled request's latency to
        queue/exec/wire/pull once and publish the
        ``rt_request_critical_path_us`` histogram into the volatile
        ns="metrics" kv beside the workers' snapshots (the dashboard and
        prometheus_metrics merge it for free). Cells are HAND-ROLLED
        per-stage, never the process-global metrics registry: an
        in-process GCS (the default ``ray_tpu_torch.init()`` topology) shares
        that registry with the driver, whose own flush already publishes
        it — re-publishing the shared snapshot under a second key would
        double-count every driver metric."""
        from ray_tpu_torch.utils.tracing import TraceCriticalPath

        cells = getattr(self, "_cp_cells", None)
        if cells is None:
            cells = self._cp_cells = {}
        quiet = time.monotonic() - 2.0 * max(
            0.5, self.cfg.task_events_report_interval_s)
        fresh = False
        for trace_id, tr in list(self.traces.items()):
            if trace_id in self._trace_cp_done or tr["touched"] > quiet:
                continue
            self._trace_cp_done.add(trace_id)
            cp = TraceCriticalPath.compute(tr["spans"])
            if cp is None:
                continue
            fresh = True
            for stage, us in cp["stages"].items():
                if us <= 0:
                    continue
                cell = cells.setdefault(
                    stage, {"counts": [0] * (len(self._CP_BOUNDS) + 1),
                            "sum": 0.0})
                i = 0
                while i < len(self._CP_BOUNDS) and us > self._CP_BOUNDS[i]:
                    i += 1
                cell["counts"][i] += 1
                cell["sum"] += us
        if fresh:
            snap = {"metrics": {"rt_request_critical_path_us": {
                "type": "histogram",
                "boundaries": list(self._CP_BOUNDS),
                "samples": [{"tags": {"stage": st}, **cell}
                            for st, cell in cells.items()],
            }}}
            try:
                self.kvstore.put("metrics", "gcs", pickle.dumps(snap),
                                 overwrite=True, journal=False)
                # direct kvstore puts bypass rpc_kv_put's rollup hook
                self.rollups.ingest("gcs", snap)
            except Exception:
                log.debug("trace metrics publish failed", exc_info=True)

    def _latency_sweep(self) -> None:
        """ns="latency" retention (cfg.latency_retention_s): windows a
        dead worker last published live forever otherwise — an idle
        long-lived cluster accumulates one leftover window per departed
        worker. Keys re-put recently stay; the rest are deleted."""
        keep_s = self.cfg.latency_retention_s
        if keep_s <= 0:
            return
        now = time.monotonic()
        try:
            keys = self.kvstore.keys("latency", "")
        except Exception:
            return
        for k in keys:
            touched = self._latency_touched.get(k)
            if touched is None:
                # first sight (e.g. GCS restart): start the clock now
                self._latency_touched[k] = now
            elif now - touched > keep_s:
                self.kvstore.delete("latency", k)
                self._latency_touched.pop(k, None)
        # drop stamps for keys already gone
        live = set(keys)
        for k in list(self._latency_touched):
            if k not in live:
                self._latency_touched.pop(k, None)

    # -------------------------------------------------------------- lifecycle
    def _on_disconnect(self, conn):
        for subs in self.subs.values():
            subs.discard(conn)
        node_id = self.raylet_conns.pop(conn, None)
        if node_id is not None:
            self._bg.spawn(self._mark_node_dead(node_id, "raylet disconnected"))

    async def _health_loop(self):
        cfg = self.cfg
        while not self._stopping:
            await asyncio.sleep(cfg.health_check_period_s)
            now = time.monotonic()
            deadline = cfg.health_check_period_s * cfg.health_check_failure_threshold
            for info in list(self.nodes.values()):
                if info.alive and now - info.last_heartbeat > deadline:
                    await self._mark_node_dead(info.node_id, "health check timeout")
            # reconciler safety net: kick any PENDING/RESCHEDULING pg
            # with no drive pass in flight (event kicks cover the common
            # cases; this rescues passes that gave up mid-churn)
            self._kick_pgs()
            # ledger audit (every ~10 ticks): cross-check each live
            # node's held bundles against the pgs table. The backstop
            # for a commit that LANDED raylet-side but whose ack was
            # lost (dead pooled socket, raylet alive): the bundle is
            # committed, so the raylet's own lease GC will never
            # reclaim it — only this sweep (or a re-register) can
            self._audit_tick = getattr(self, "_audit_tick", 0) + 1
            if self._audit_tick % 10 == 0:
                for info in list(self.nodes.values()):
                    if info.alive:
                        await self._audit_node_bundles(info)
                self._latency_sweep()
            # trace critical-path pass over quiesced traces (cheap: only
            # traces that stopped growing since the last tick)
            if self.traces:
                self._trace_metrics_tick()
            # restored ALIVE actors whose node never re-registered after a
            # GCS restart are dead, not merely unobserved
            restored_at = getattr(self, "_restored_at", None)
            if restored_at is not None and now - restored_at > deadline:
                self._restored_at = None
                alive_nodes = {nid for nid, n in self.nodes.items() if n.alive}
                for info in list(self.actors.values()):
                    if info.state == ALIVE and info.node_id not in alive_nodes:
                        await self._on_actor_failure(
                            info, "node lost across GCS restart"
                        )
                # restored CREATED pgs with bundles on nodes that never
                # came back reschedule exactly like a live node death
                for pg in list(self.pgs.values()):
                    if pg.state != "CREATED":
                        continue
                    lost = pg.lost_indices(alive_nodes)
                    if lost:
                        await self._reschedule_lost(
                            pg, lost, "node lost across GCS restart")

    def _restore(self):
        """Recover durable tables (ref role: GCS FT via the Redis store
        client, src/ray/gcs/gcs_server/store_client/redis_store_client.cc
        — there every table op journals through Redis). KV bytes were
        already recovered by the native engine at open (snapshot +
        CRC-checked WAL replay, torn tail truncated); this replays the
        Python-side table ops: the snapshot's pickled table blob, then
        every journaled op newer than it. Volatile state (node registry,
        metrics) is rebuilt by re-registration."""
        import pickle as _p

        if not self.persist_path:
            return
        recovered_ops = []
        legacy_migrated = False
        for rec in self.kvstore.recovered_aux_records():
            try:
                op = _p.loads(rec)
            except Exception:
                continue  # CRC passed but unpicklable (version skew): skip
            if op[0] == "legacy_migrated":
                legacy_migrated = True
            recovered_ops.append(op)
        if not self.kvstore.had_snapshot and not legacy_migrated:
            # No native snapshot and no positive migration-complete
            # sentinel: either a fresh cluster, the first start after the
            # engine swap, or a crash MID-migration (some legacy ops
            # journaled, sentinel absent). Re-run the migration — its puts
            # are idempotent (overwrite=False defers to already-migrated
            # native state), so a partial previous pass can never be
            # silently dropped nor clobber what it already wrote.
            # Known narrow edge: a migration completed by a PRE-sentinel
            # build also lands here (records, no sentinel) and re-puts
            # legacy keys that native kvdels since removed — absent delete
            # tombstones the two states are indistinguishable. The window
            # is ~1s: migration marks dirty and the persist loop writes a
            # native snapshot (had_snapshot → skip) on its next tick.
            self._restore_legacy()
        aux = self.kvstore.recovered_snapshot_aux()
        if aux:
            try:
                snap = _p.loads(aux)
                self.job_counter = snap.get("job_counter", 0)
                self.actors = snap.get("actors", {})
                self.named_actors = snap.get("named_actors", {})
                self.pgs = snap.get("pgs", {})
            except Exception:
                # unreadable table blob: KV still recovered
                log.debug("snapshot aux blob unreadable", exc_info=True)
        for op in recovered_ops:
            kind = op[0]
            if kind == "job":
                self.job_counter = max(self.job_counter, op[1])
            elif kind == "actor":
                self.actors[op[1].actor_id] = op[1]
            elif kind == "name":
                self.named_actors[op[1]] = op[2]
            elif kind == "namedel":
                self.named_actors.pop(op[1], None)
            elif kind == "pg":
                self.pgs[op[1].pg_id] = op[1]
        self._restored_at = time.monotonic()

    def _restore_legacy(self):
        """Migration from the pre-native persistence format (a whole-state
        pickle snapshot + [u32 len][pickle(op)] WAL). The native engine
        rejects the old magic and sidelines an unparseable WAL as
        .wal.legacy; this reads both and re-journals EVERY loaded op into
        the native WAL, so acknowledged old-format writes are durable
        immediately — not only after the first snapshot tick.

        Crash-safe: a ("legacy_migrated",) sentinel aux record journals
        once BOTH legacy sources migrated fully — and before the legacy
        WAL file is deleted — and _restore re-runs this whole pass while
        the sentinel is absent. Re-runs are idempotent: the first write of
        each key this pass uses overwrite=False (native state — what an
        interrupted earlier pass already migrated — wins), while later
        legacy ops on a key this pass already wrote use overwrite=True so
        the legacy log's own ordering is preserved."""
        import pickle as _p
        import struct as _s

        state_loaded = False
        snap_ok = False   # snapshot portion fully migrated (or absent)
        wal_ok = False    # WAL portion fully migrated (or absent)
        touched: set[tuple[str, str]] = set()  # (ns, key) written this pass

        def kv_migrate(ns: str, k: str, v) -> None:
            self.kvstore.put(ns, k, v, overwrite=(ns, k) in touched,
                             journal=True)
            touched.add((ns, k))

        try:
            if os.path.exists(self.persist_path):
                with open(self.persist_path, "rb") as f:
                    head = f.read(2)
                if head[:1] == b"\x80":  # pickle protocol marker
                    with open(self.persist_path, "rb") as f:
                        snap = _p.load(f)
                    for ns, table in snap.get("kv", {}).items():
                        if ns == "metrics":
                            continue
                        for k, v in table.items():
                            kv_migrate(ns, k, v)
                    self.job_counter = snap.get("job_counter", 0)
                    self.actors = snap.get("actors", {})
                    self.named_actors = snap.get("named_actors", {})
                    self.pgs = snap.get("pgs", {})
                    if self.job_counter:
                        self.kvstore.journal_aux(
                            _p.dumps(("job", self.job_counter)))
                    for info in self.actors.values():
                        self.kvstore.journal_aux(_p.dumps(("actor", info)))
                    for name, aid in self.named_actors.items():
                        self.kvstore.journal_aux(_p.dumps(("name", name, aid)))
                    for pg in self.pgs.values():
                        self.kvstore.journal_aux(_p.dumps(("pg", pg)))
                    state_loaded = True
            snap_ok = True  # absent, non-legacy, or fully journaled
        except Exception:
            # partial migration: sentinel stays absent, next start re-runs
            log.debug("legacy snapshot migration incomplete", exc_info=True)
        legacy_wal = self.persist_path + ".wal.legacy"
        try:
            if not os.path.exists(legacy_wal):
                wal_ok = True
            else:
                with open(legacy_wal, "rb") as f:
                    buf = f.read()
                off = 0
                while off + 4 <= len(buf):
                    (ln,) = _s.unpack_from("<I", buf, off)
                    if off + 4 + ln > len(buf):
                        break
                    try:
                        op = _p.loads(buf[off + 4:off + 4 + ln])
                    except Exception:
                        break  # new-format bytes sidelined by a torn head
                    off += 4 + ln
                    kind = op[0]
                    if kind == "kvput":
                        kv_migrate(op[1], op[2], op[3])
                    elif kind == "kvdel":
                        self.kvstore.delete(op[1], op[2], journal=True)
                        touched.add((op[1], op[2]))
                    elif kind == "job":
                        self.job_counter = max(self.job_counter, op[1])
                        self.kvstore.journal_aux(_p.dumps(op))
                    elif kind == "actor":
                        self.actors[op[1].actor_id] = op[1]
                        self.kvstore.journal_aux(_p.dumps(op))
                    elif kind == "name":
                        self.named_actors[op[1]] = op[2]
                        self.kvstore.journal_aux(_p.dumps(op))
                    elif kind == "namedel":
                        self.named_actors.pop(op[1], None)
                        self.kvstore.journal_aux(_p.dumps(op))
                    elif kind == "pg":
                        self.pgs[op[1].pg_id] = op[1]
                        self.kvstore.journal_aux(_p.dumps(op))
                    state_loaded = True
                wal_ok = True
        except Exception:
            log.debug("legacy WAL migration incomplete", exc_info=True)
        if snap_ok and wal_ok:
            try:
                # Migration-complete sentinel: journaled only when BOTH
                # legacy sources migrated fully, and BEFORE the legacy WAL
                # is deleted — a crash anywhere earlier leaves the sentinel
                # absent (next start re-runs the idempotent migration with
                # every source still on disk); a crash between sentinel
                # and remove only leaks an already-migrated file.
                self.kvstore.journal_aux(_p.dumps(("legacy_migrated",)))
                if os.path.exists(legacy_wal):
                    # every replayed op is in the native WAL (flushed per
                    # append): the legacy copy is redundant
                    os.remove(legacy_wal)
            except (OSError, TypeError):
                pass  # sentinel retry next start; sources still on disk
        if state_loaded:
            self.mark_dirty()  # next snapshot converts to native format

    # ------------------------------------------------------------- WAL
    # Table ops journal as opaque (pickled) aux records through the
    # native engine's WAL — one binary log, CRC-framed, shared with the
    # KV ops the engine journals itself (gcs_core.cc).
    def _journal(self, op: tuple) -> None:
        import pickle as _p

        if chaos.ENABLED:
            # "gcs.wal_append", table-op flavor: an `error` action raises
            # out of the mutation handler mid-flight — the un-acked,
            # un-journaled write the WAL recovery tests replay against
            chaos.point("gcs.wal_append", kind=op[0])
        try:
            self.kvstore.journal_aux(_p.dumps(op))
        except (_p.PicklingError, TypeError, AttributeError):
            # unpicklable table entry: this aux record is skipped but the
            # periodic snapshot still covers the mutation
            log.debug("WAL aux journal skipped for %r", op[0],
                      exc_info=True)
        self.mark_dirty()
        self._kick_sync()

    def mark_dirty(self):
        self._dirty = True

    async def _persist_loop(self):
        import pickle as _p

        while not self._stopping:
            await asyncio.sleep(1.0)
            if not self._dirty:
                continue
            self._dirty = False
            if not self._write_snapshot():
                self._dirty = True  # keep trying: the write failed

    def _write_snapshot(self) -> bool:
        """Native atomic snapshot: KV bytes stream from C++, the Python
        tables ride as the pickled aux blob; the WAL truncates inside the
        same native call."""
        import pickle as _p

        try:
            aux = _p.dumps({
                "job_counter": self.job_counter,
                "actors": dict(self.actors),
                "named_actors": dict(self.named_actors),
                "pgs": dict(self.pgs),
            })
            return self.kvstore.snapshot(aux, skip_ns="metrics")
        except Exception:
            return False

    async def start(self) -> tuple[str, int]:
        self._restore()
        addr = await self.server.start()
        # reconcile restored actor state (ref: GCS FT actor reconstruction):
        # PENDING actors lost their scheduling coroutine with the old
        # process — reschedule them now
        for info in self.actors.values():
            if info.state == PENDING:
                self._bg.spawn(self._schedule_actor(info))
        self._bg.spawn(self._health_loop())
        if self.persist_path:
            self._bg.spawn(self._persist_loop())
        return addr

    async def stop(self):
        self._stopping = True
        await self._bg.cancel_all()
        for conn in list(self._node_conns.values()):
            try:
                await conn.close()
            except (rpc.RpcError, OSError):
                pass  # pooled socket already dead
        self._node_conns.clear()
        if self.persist_path and self._dirty:
            self._write_snapshot()  # final flush: acknowledged writes survive
        await self.server.stop()
        self.kvstore.close()


def _fits(req: dict, avail: dict) -> bool:
    return all(avail.get(k, 0.0) >= v - 1e-9 for k, v in req.items())


def _fits_all(bundles: list[dict], avail: dict) -> bool:
    total: dict[str, float] = {}
    for b in bundles:
        for k, v in b.items():
            total[k] = total.get(k, 0.0) + v
    return _fits(total, avail)


def main():
    import argparse

    chaos.maybe_arm()  # fault schedule rides the serialized config

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--address-file", default=None)
    parser.add_argument("--persist", default=None,
                        help="snapshot file for durable tables (GCS FT)")
    args = parser.parse_args()

    # run the server from the CANONICAL module: under `python -m` this
    # file executes as __main__, and anything pickled with __main__-homed
    # classes (ActorInfo/PlacementGroupInfo in the WAL, most importantly)
    # would be unloadable by any normally-importing process
    import ray_tpu_torch.core.gcs as _canonical

    async def run():
        gcs = _canonical.GcsServer(
            args.host, args.port, persist_path=args.persist)
        host, port = await gcs.start()
        line = f"{host}:{port}"
        if args.address_file:
            tmp = args.address_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(line)
            os.replace(tmp, args.address_file)
        print(f"GCS listening on {line}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
