"""Simulated-churn harness: control-plane scale under node failure.

A simulated-churn bench for up to a thousand nodes — N lightweight
simulated raylet endpoints (a real RPC server + the real
:class:`~ray_tpu_torch.core.raylet.ResourceLedger` bundle accounting, but no
worker pool and no shm arena, so hundreds fit in one process) register
with a real GCS and then join/leave on a seeded schedule while placement
groups and PG-bound actors are created, killed off their nodes, and
repaired. The same discipline as the chaos subsystem (Basiri et al.):
the churn schedule is a seeded RNG stream and the GCS-side 2PC faults
come from a seeded :class:`~ray_tpu_torch.devtools.chaos.plan.ChaosPlan`
(``gcs.pg_prepare`` / ``gcs.pg_commit`` points), so a failing run
replays byte-for-byte.

Its metrics make scheduling scale under failure a number:

- ``pg_create_removal_per_s`` — PG create+remove cycles sustained while
  nodes churn underneath,
- ``pg_reschedule_p99_ms``   — node death → RESCHEDULING → CREATED
  repair latency, measured from the GCS's "pgs" pubsub stream,
- ``churn_unsatisfied_pg_s`` — total PG·seconds spent out of CREATED
  (the capacity-unavailability integral the repair loop minimizes).

The post-run :meth:`ChurnHarness.audit` is the leak oracle: every
bundle reservation held by a surviving node must belong to a live,
CREATED PG that assigns it to exactly that node — anything else is a
leak (and the tier-1 churn test asserts there are none).

The port's copy of ``ray_tpu/devtools/churn.py``, over the port's
``GcsServer`` and ``ResourceLedger``; it does no card work.

Usage (also ``tests/test_torch_chaos_killers.py``, with the seeded plan
``tests/plans/pg_churn.json``)::

    h = ChurnHarness(nodes=64, seed=7)
    h.start()
    try:
        metrics = h.run(duration_s=10.0)
        leaks = h.audit()
    finally:
        h.stop()
"""

from __future__ import annotations

import asyncio
import logging
import random
import time

from ray_tpu_torch.config import get_config
from ray_tpu_torch.core.gcs import GcsServer
from ray_tpu_torch.core.raylet import ResourceLedger
from ray_tpu_torch.utils import aio, rpc
from ray_tpu_torch.utils.ids import ActorID, NodeID, PlacementGroupID
from ray_tpu_torch.utils.recorder import percentile

log = logging.getLogger(__name__)


class SimRaylet:
    """A raylet-shaped control-plane endpoint: registers with the GCS,
    heartbeats, and accounts placement-group bundles through the real
    :class:`ResourceLedger` (prepare/commit/return + the stale-bundle
    lease GC) — but grants *simulated* worker leases (it answers the
    worker-side ``create_actor`` RPC itself), spawns no processes and
    maps no shm. One asyncio server per node: hundreds per process."""

    def __init__(self, gcs_address: tuple[str, int],
                 resources: dict[str, float] | None = None,
                 host: str = "127.0.0.1"):
        self.cfg = get_config()
        self.node_id = NodeID.generate()
        self.gcs_address = gcs_address
        res = dict(resources or {"CPU": 8.0})
        res.setdefault("node", 1.0)
        self.ledger = ResourceLedger(res)
        # plain asyncio server on purpose: the native mux would cost one
        # epoll thread per simulated node
        self.server = rpc.RpcServer(host, 0)
        self.server.add_routes(self)
        self.gcs: rpc.Connection | None = None
        self._lease_seq = 0
        self._alive = False
        self._bg = aio.TaskGroup()

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> tuple[str, int]:
        addr = await self.server.start()
        self.gcs = await rpc.connect(*self.gcs_address, timeout=10)
        await self._register()
        self._alive = True
        self._bg.spawn(self._heartbeat_loop())
        self._bg.spawn(self._bundle_gc_loop())
        return addr

    async def _register(self) -> None:
        """Registration payload + held-bundle reconciliation — one
        code path for the initial register and the restarted-GCS
        re-register (the heartbeat path), so they can't drift."""
        reply = await self.gcs.call("register_node", {
            "node_id": self.node_id,
            "address": self.server.address,
            "store_name": f"/sim_{self.node_id.hex()[:8]}",
            "resources": self.ledger.total,
            "labels": {"sim": "1"},
            "pid": 0,
            "bundles": self._held_bundles(),
        })
        for key in reply.get("return_bundles") or ():
            self.ledger.return_bundle(tuple(key))

    async def kill(self):
        """Abrupt death: close everything with no goodbyes — the GCS
        discovers the loss via the connection drop (one reap tick)."""
        self._alive = False
        await self._bg.cancel_all()
        if self.gcs is not None:
            try:
                await self.gcs.close()
            except (rpc.RpcError, OSError):
                pass  # hard-death semantics
        await self.server.stop()

    stop = kill  # sim nodes have nothing to drain

    async def _heartbeat_loop(self):
        version = 0
        while self._alive:
            version += 1
            try:
                reply = await self.gcs.call("heartbeat", {
                    "node_id": self.node_id,
                    "resources_available": self.ledger.available,
                    "version": version,
                })
                if isinstance(reply, dict) and not reply.get("ok", True):
                    # restarted GCS doesn't know this node: re-register
                    await self._register()
            except Exception:
                log.debug("sim heartbeat failed", exc_info=True)
            await asyncio.sleep(self.cfg.health_check_period_s)

    async def _bundle_gc_loop(self):
        lease_s = getattr(self.cfg, "pg_bundle_lease_s", 30.0)
        if lease_s <= 0:
            return
        while self._alive:
            await asyncio.sleep(max(0.2, lease_s / 4))
            self.ledger.gc_stale_bundles(time.monotonic(), lease_s)

    def _held_bundles(self) -> list[dict]:
        return self.ledger.held_bundles()

    # ------------------------------------------------------- bundle plane
    async def rpc_prepare_bundle(self, conn, p):
        key = (p["pg_id"], p["bundle_index"])
        return {"ok": self.ledger.prepare_bundle(key, p["resources"])}

    async def rpc_commit_bundle(self, conn, p):
        return {"ok": self.ledger.commit_bundle(
            (p["pg_id"], p["bundle_index"]))}

    async def rpc_return_bundle(self, conn, p):
        self.ledger.return_bundle((p["pg_id"], p["bundle_index"]))
        return {"ok": True}

    async def rpc_prepare_bundles(self, conn, p):
        """Batched 2PC phase 1 (protocol 2.0) — mirrors the real raylet."""
        return [{"ok": self.ledger.prepare_bundle((p["pg_id"], idx), res)}
                for idx, res in p["bundles"]]

    async def rpc_commit_bundles(self, conn, p):
        return [{"ok": self.ledger.commit_bundle((p["pg_id"], idx))}
                for idx in p["indices"]]

    async def rpc_list_bundles(self, conn, p):
        return self._held_bundles()

    # ---------------------------------------------------- simulated leases
    async def rpc_lease_worker(self, conn, p):
        """Simulated grant: resources allocate from the real ledger (PG
        bundles included) but the "worker" is this server itself — the
        GCS's follow-up ``create_actor`` RPC lands back here."""
        resources = dict(p.get("resources") or {"CPU": 1.0})
        pg_key = None
        if p.get("pg_id") is not None:
            pg_key = (p["pg_id"], p.get("bundle_index", 0))
            granted = self.ledger.bundle_allocate(pg_key, resources)
        else:
            granted = self.ledger.allocate(resources)
        if not granted:
            return {"granted": False}
        self._lease_seq += 1
        return {
            "granted": True,
            "lease_id": self._lease_seq,
            "worker_address": self.server.address,
            "worker_id": f"sim-{self.node_id.hex()[:8]}-{self._lease_seq}",
            "node_id": self.node_id,
            "tpu_chips": None,
        }

    async def rpc_lease_workers(self, conn, p):
        """Batched grants (protocol 2.0): one ledger pass, positional
        replies — the path _schedule_actor's lease coalescer takes."""
        return [await self.rpc_lease_worker(conn, req)
                for req in p["requests"]]

    async def rpc_return_lease(self, conn, p):
        return True  # sim leases are not tracked per-id

    # ------------------------------------------------- simulated worker RPC
    async def rpc_create_actor(self, conn, p):
        return {"ok": True}

    async def rpc_exit_worker(self, conn, p):
        return True


class ChurnHarness:
    """A real GCS + N :class:`SimRaylet` endpoints + a seeded churn/
    workload driver, all on one background event loop."""

    def __init__(self, *, nodes: int = 24, cpus_per_node: float = 8.0,
                 seed: int = 0, io: rpc.EventLoopThread | None = None):
        self.cfg = get_config()
        self.n_nodes = nodes
        self.cpus_per_node = cpus_per_node
        self.rng = random.Random(seed)
        self._own_io = io is None
        self.io = io or rpc.EventLoopThread()
        self.gcs = GcsServer()
        self.gcs_address: tuple[str, int] | None = None
        self.sims: list[SimRaylet] = []
        self.client: rpc.Connection | None = None
        #: "pgs" pubsub stream with a local receive timestamp per event —
        #: the measurement tap every churn metric derives from
        self.events: list[dict] = []
        self._persistent: list[PlacementGroupID] = []
        self._actors: list[ActorID] = []

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        from ray_tpu_torch.devtools import chaos

        chaos.maybe_arm()  # seeded 2PC faults ride the config flag table
        self.gcs_address = self.io.run(self.gcs.start())
        self.client = self.io.run(
            rpc.connect(*self.gcs_address, timeout=10))
        self.client.on_message = self._on_push
        self.io.run(self.client.call("subscribe", {"channel": "pgs"}))
        for _ in range(self.n_nodes):
            self.add_node()

    def add_node(self) -> SimRaylet:
        sim = SimRaylet(self.gcs_address,
                        resources={"CPU": self.cpus_per_node})
        self.io.run(sim.start())
        self.sims.append(sim)
        return sim

    def stop(self) -> None:
        for sim in list(self.sims):
            try:
                self.io.run(sim.stop())
            except Exception:
                log.debug("sim stop failed", exc_info=True)
        self.sims.clear()
        if self.client is not None:
            try:
                self.io.run(self.client.close())
            except Exception:
                log.debug("client close failed", exc_info=True)
        try:
            self.io.run(self.gcs.stop())
        except Exception:
            log.debug("gcs stop failed", exc_info=True)
        if self._own_io:
            self.io.stop()

    def _on_push(self, msg):
        if msg.get("m") != "pubsub":
            return
        p = msg["p"]
        if p.get("channel") == "pgs" and isinstance(p.get("message"), dict):
            self.events.append(
                dict(p["message"], recv_ts=time.monotonic()))

    # -------------------------------------------------------------- workload
    def run(self, duration_s: float = 10.0, *, pg_cyclers: int = 4,
            persistent_pgs: int = 6, bundles_per_pg: int = 2,
            actors_per_pg: int = 1, strategy: str = "SPREAD",
            kill_every_s: float = 1.0, respawn_delay_s: float = 0.4,
            min_nodes: int = 4, settle_s: float = 20.0) -> dict:
        """Drive churn for ``duration_s``: ``pg_cyclers`` loops create+
        remove short-lived PGs, ``persistent_pgs`` PGs (each with
        ``actors_per_pg`` simulated PG-bound actors) live through the
        churn and get repaired every time a bundle-holding node dies,
        and the churner kills a random sim node every ~``kill_every_s``
        (seeded), respawning a replacement after ``respawn_delay_s``.
        After the clock runs out the harness waits (up to ``settle_s``)
        for every persistent PG to re-converge to CREATED and every sim
        actor to come back ALIVE, then returns the metric dict."""
        return self.io.run(self._run(
            duration_s, pg_cyclers, persistent_pgs, bundles_per_pg,
            actors_per_pg, strategy, kill_every_s, respawn_delay_s,
            min_nodes, settle_s),
            timeout=duration_s + settle_s + 120.0)

    async def _create_pg(self, bundles, strategy) -> tuple:
        pg_id = PlacementGroupID.generate()
        r = await self.client.call("create_placement_group", {
            "pg_id": pg_id, "bundles": bundles, "strategy": strategy})
        return pg_id, r.get("state")

    async def _run(self, duration_s, pg_cyclers, persistent_pgs,
                   bundles_per_pg, actors_per_pg, strategy, kill_every_s,
                   respawn_delay_s, min_nodes, settle_s) -> dict:
        t_start = time.monotonic()
        # persistent PGs + their simulated PG-bound actors
        for _ in range(persistent_pgs):
            bundles = [{"CPU": 1.0}] * bundles_per_pg
            pg_id, state = await self._create_pg(bundles, strategy)
            self._persistent.append(pg_id)
            for i in range(actors_per_pg):
                actor_id = ActorID.generate()
                await self.client.call("register_actor", {"spec": {
                    "actor_id": actor_id,
                    "resources": {"CPU": 0.5},
                    "placement_group": pg_id,
                    "bundle_index": i % bundles_per_pg,
                    "max_restarts": 1000,
                }})
                self._actors.append(actor_id)

        stop = asyncio.Event()
        cycles = 0
        infeasible_creates = 0

        async def cycler(k: int):
            nonlocal cycles, infeasible_creates
            while not stop.is_set():
                pg_id, state = await self._create_pg(
                    [{"CPU": 1.0}], "PACK")
                if state == "CREATED":
                    await self.client.call(
                        "remove_placement_group", {"pg_id": pg_id})
                    cycles += 1
                else:
                    infeasible_creates += 1
                    await self.client.call(
                        "remove_placement_group", {"pg_id": pg_id})
                    await asyncio.sleep(0.05)

        kills = 0

        async def churner():
            nonlocal kills
            while not stop.is_set():
                await asyncio.sleep(
                    kill_every_s * (0.5 + self.rng.random()))
                if stop.is_set() or len(self.sims) <= min_nodes:
                    continue
                # prefer bundle-holding victims (seeded choice): the
                # interesting failure is a node that takes PG capacity
                # with it — a miss only exercises the node-removed path
                holders = [i for i, s in enumerate(self.sims)
                           if s.ledger.bundles]
                pool = holders or range(len(self.sims))
                victim = self.sims.pop(self.rng.choice(list(pool)))
                kills += 1
                await victim.kill()
                await asyncio.sleep(respawn_delay_s)
                if not stop.is_set():
                    sim = SimRaylet(
                        self.gcs_address,
                        resources={"CPU": self.cpus_per_node})
                    await sim.start()
                    self.sims.append(sim)

        tasks = [asyncio.ensure_future(cycler(k))
                 for k in range(pg_cyclers)]
        tasks.append(asyncio.ensure_future(churner()))
        await asyncio.sleep(duration_s)
        stop.set()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        elapsed = time.monotonic() - t_start

        # settle: every persistent PG back to CREATED, every actor ALIVE
        settle_deadline = time.monotonic() + settle_s
        unsettled = set(self._persistent)
        while unsettled and time.monotonic() < settle_deadline:
            for pg_id in list(unsettled):
                info = await self.client.call(
                    "get_placement_group", {"pg_id": pg_id})
                if info and info["state"] == "CREATED":
                    unsettled.discard(pg_id)
            if unsettled:
                await asyncio.sleep(0.1)
        actors_alive = 0
        while time.monotonic() < settle_deadline:
            rows = await self.client.call("list_actors", {})
            by_id = {r["actor_id"]: r for r in rows}
            actors_alive = sum(
                1 for a in self._actors
                if by_id.get(a, {}).get("state") == "ALIVE")
            if actors_alive == len(self._actors):
                break
            await asyncio.sleep(0.1)
        settle_end = time.monotonic()

        return {
            "pg_create_removal_per_s": cycles / max(elapsed, 1e-9),
            "pg_cycles": cycles,
            "infeasible_creates": infeasible_creates,
            "node_kills": kills,
            "nodes_alive": len(self.sims),
            "unsettled_pgs": len(unsettled),
            "actors_total": len(self._actors),
            "actors_alive": actors_alive,
            **self._episode_metrics(settle_end),
        }

    # -------------------------------------------------------------- metrics
    def _episode_metrics(self, end_ts: float) -> dict:
        """Reschedule episodes from the "pgs" event stream: each
        RESCHEDULING push opens an episode for its pg, the next CREATED
        push closes it. Durations use the harness's receive clock (one
        host, one clock domain)."""
        open_at: dict[str, float] = {}
        durations: list[float] = []
        reschedules = 0
        for ev in self.events:
            pg_hex, state = ev.get("pg_id"), ev.get("state")
            ts = ev["recv_ts"]
            if state == "RESCHEDULING":
                reschedules += 1
                open_at.setdefault(pg_hex, ts)
            elif state in ("CREATED", "REMOVED") and pg_hex in open_at:
                durations.append(ts - open_at.pop(pg_hex))
        # still-open episodes accrue unsatisfied time to the end
        unsatisfied = sum(durations) + sum(
            end_ts - t0 for t0 in open_at.values())
        durations.sort()
        return {
            "pg_reschedules": reschedules,
            "pg_reschedule_p50_ms": percentile(durations, 0.5) * 1e3,
            "pg_reschedule_p99_ms": percentile(durations, 0.99) * 1e3,
            "churn_unsatisfied_pg_s": unsatisfied,
            "open_reschedules": len(open_at),
        }

    # ---------------------------------------------------------------- audit
    def audit(self) -> dict:
        """The leak oracle. Cross-checks every surviving node's bundle
        table against the GCS pgs table:

        - ``leaked``: a reservation held for a REMOVED/unknown PG, for a
          bundle assigned to a different node, or still uncommitted
          after settle;
        - ``missing``: a CREATED PG bundle whose assigned (alive,
          simulated) node does not actually hold the reservation.

        Zero of both is the acceptance bar the churn test asserts."""
        return self.io.run(self._audit())

    async def _audit(self) -> dict:
        leaked: list[dict] = []
        missing: list[dict] = []
        pgs = dict(self.gcs.pgs)
        held_by_node: dict[NodeID, dict[tuple, dict]] = {}
        for sim in self.sims:
            held_by_node[sim.node_id] = {
                (b["pg_id"], b["bundle_index"]): b
                for b in sim._held_bundles()
            }
        for sim in self.sims:
            for (pg_id, index), b in held_by_node[sim.node_id].items():
                pg = pgs.get(pg_id)
                if pg is None or pg.state == "REMOVED":
                    leaked.append({"node": sim.node_id.hex()[:12],
                                   "pg": pg_id.hex()[:12], "bundle": index,
                                   "why": "pg removed/unknown"})
                elif (index >= len(pg.bundle_nodes)
                        or pg.bundle_nodes[index] != sim.node_id):
                    leaked.append({"node": sim.node_id.hex()[:12],
                                   "pg": pg_id.hex()[:12], "bundle": index,
                                   "why": "assigned elsewhere"})
                elif not b.get("committed"):
                    leaked.append({"node": sim.node_id.hex()[:12],
                                   "pg": pg_id.hex()[:12], "bundle": index,
                                   "why": "uncommitted after settle"})
        sim_ids = set(held_by_node)
        for pg in pgs.values():
            if pg.state != "CREATED":
                continue
            for index, nid in enumerate(pg.bundle_nodes):
                if (nid in sim_ids
                        and (pg.pg_id, index) not in held_by_node[nid]):
                    missing.append({"node": nid.hex()[:12],
                                    "pg": pg.pg_id.hex()[:12],
                                    "bundle": index})
        return {"leaked": leaked, "missing": missing}
