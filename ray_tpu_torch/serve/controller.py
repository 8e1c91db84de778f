"""Serve controller: the reconciliation brain of the serving layer.

Equivalent of the reference ServeController (ref:
python/ray/serve/_private/controller.py:87) + DeploymentState reconciler
(deployment_state.py:1266) + autoscaling state manager
(_private/autoscaling_state.py) + LongPollHost config fan-out
(long_poll.py:222). One async actor: a reconcile loop drives replica sets
toward target counts, health-checks replicas, polls their queue depth, and
applies the SLO-feedback autoscaling policy (serve/dataplane/
autoscaler.py): decisions read the smoothed ongoing window, the
deployment's p99 from the flight-recorder latency namespace (the
"serve" windows replicas publish via CoreClient.add_latency_source),
and arrival rate — with hysteresis bands + cooldowns replacing the old
memoryless ceil(total/target). Every fired decision publishes on the
``serve_autoscale`` pubsub channel with its cause and lands in a
bounded event history (state.list_serve_autoscale_events, dashboard);
routers long-poll get_routing_info for membership changes.
"""
from __future__ import annotations

import asyncio
import pickle
import time
import uuid

from ray_tpu_torch.serve.dataplane.autoscaler import ServeAutoscaler

CONTROLLER_NAME = "SERVE::controller"

#: bounded autoscale-decision history (actor method + ns="serve" kv)
AUTOSCALE_EVENTS_CAP = 256


class _DeploymentState:
    def __init__(self, app_name: str, name: str, spec: dict):
        self.app_name = app_name
        self.name = name
        self.spec = spec  # serialized_cls, init_args, init_kwargs, config
        self.target_replicas: int = spec["config"].initial_replicas()
        self.replicas: dict[str, dict] = {}  # replica_id -> {handle, healthy}
        self.metrics: dict[str, int] = {}  # replica_id -> ongoing
        self.totals: dict[str, int] = {}  # replica_id -> lifetime requests
        # demand reported by handle-side routers that cannot route (e.g.
        # scaled to zero): router_id -> (queued_count, monotonic_ts).
        # This is the scale-from-zero signal (ref: serve handle-side
        # queued-request metrics feeding autoscaling_state.py).
        self.handle_queued: dict[str, tuple[int, float]] = {}
        self.deleting = False
        self._last_health_check: float = 0.0

    @property
    def key(self) -> str:
        return f"{self.app_name}/{self.name}"


class ServeController:
    """Async actor; methods run concurrently on the worker's event loop."""

    def __init__(self):
        self._deployments: dict[str, _DeploymentState] = {}
        self._version = 0
        self._changed: asyncio.Condition | None = None  # created on the loop
        self._loop_task = None
        self._stopping = False
        # SLO-feedback autoscaling (serve/dataplane/autoscaler.py)
        self._autoscaler = ServeAutoscaler()
        self._autoscale_events: list[dict] = []
        self._p99: dict[str, float] = {}  # "app/dep" -> fresh p99 ms
        self._p99_fetched = 0.0
        # SLO burn-rate monitoring (serve/dataplane/slo.py): fed the
        # per-deployment breach fraction each tick from the same merged
        # latency windows the p99 comes from; alerts fan out on the
        # slo_burn pubsub channel + bounded kv history
        from ray_tpu_torch.serve.dataplane.slo import SLOBurnMonitor

        self._slo_monitor = SLOBurnMonitor()
        self._slo_burn_events: list[dict] = []
        self._lat_windows: dict[str, list] = {}  # "app/dep" -> raw ns

    # -------------------------------------------------------------- helpers
    async def _ensure_loop(self):
        if self._changed is None:
            self._changed = asyncio.Condition()
        if self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(self._reconcile_loop())
            # eager replacement: the actor-death pubsub flips a replica
            # out of the routing table the moment the raylet reaps it —
            # no waiting for two failed health probes — and the next
            # reconcile tick (≤0.1s) starts the replacement
            from ray_tpu_torch.core.api import get_core

            get_core().add_actor_death_listener(self._on_replica_death)

    def _on_replica_death(self, actor_id, info):
        """Pubsub callback (loop thread): drop the dead replica and wake
        routers immediately (ref: deployment_state replica-death handling,
        but push-driven instead of probe-driven)."""
        for st in self._deployments.values():
            for rid, rec in list(st.replicas.items()):
                h = rec.get("handle")
                if h is not None and getattr(h, "actor_id", None) == actor_id:
                    st.replicas.pop(rid, None)
                    st.metrics.pop(rid, None)
                    st.totals.pop(rid, None)
                    asyncio.get_running_loop().create_task(self._bump_version())
                    return

    async def _bump_version(self):
        self._version += 1
        async with self._changed:
            self._changed.notify_all()

    # ------------------------------------------------------------ deploy API
    async def deploy(self, app_name: str, name: str, spec: dict) -> bool:
        """Create or update a deployment (ref: controller.py deploy_apps)."""
        await self._ensure_loop()
        key = f"{app_name}/{name}"
        existing = self._deployments.get(key)
        if (existing is not None and not existing.deleting
                and self._only_scale_changed(existing.spec, spec)):
            # lightweight update (ref: deployment_state.py lightweight
            # config updates): same code + per-replica config, only
            # num_replicas/autoscaling changed — adjust the target and
            # let the reconciler add/remove the delta (downscale then
            # exercises compaction) instead of restarting every replica
            existing.spec = spec
            auto = spec["config"].autoscaling_config
            if auto is not None:
                # autoscaled deployment: keep the CURRENT scale, clamped
                # into the new bounds — resetting to min_replicas would
                # kill loaded replicas on a bounds-only update
                existing.target_replicas = max(
                    auto.min_replicas,
                    min(auto.max_replicas, existing.target_replicas))
            else:
                existing.target_replicas = spec["config"].initial_replicas()
            self._autoscaler.forget(existing.key)
            await self._bump_version()
            return True
        if existing is not None and not existing.deleting:
            # in-place update: new code/config. Unpublish the old replicas
            # FIRST (version bump) so routers stop sending to them, then
            # drain+kill them in the background — the deploy RPC must not
            # block on graceful shutdown.
            old = existing.replicas
            existing.spec = spec
            existing.target_replicas = spec["config"].initial_replicas()
            existing.replicas = {}
            existing.metrics = {}
            await self._bump_version()

            async def drain_old():
                for rid, rec in old.items():
                    await self._stop_replica(existing, rid, rec, drain=True)

            asyncio.get_running_loop().create_task(drain_old())
            return True
        self._deployments[key] = _DeploymentState(app_name, name, spec)
        await self._bump_version()
        return True

    @staticmethod
    def _only_scale_changed(old_spec: dict, new_spec: dict) -> bool:
        """True when the new spec differs from the old ONLY in replica
        count / autoscaling bounds — everything live replicas were
        constructed with (code, args, per-replica config) is identical."""
        import dataclasses

        try:
            if (old_spec["serialized_cls"] != new_spec["serialized_cls"]
                    or old_spec["init_args"] != new_spec["init_args"]
                    or old_spec["init_kwargs"] != new_spec["init_kwargs"]):
                return False
            oc = dataclasses.asdict(old_spec["config"])
            nc = dataclasses.asdict(new_spec["config"])
            for k in ("num_replicas", "autoscaling_config"):
                oc.pop(k, None)
                nc.pop(k, None)
            return oc == nc
        except Exception:
            return False  # anything incomparable: full replacement

    async def delete_app(self, app_name: str) -> bool:
        for st in list(self._deployments.values()):
            if st.app_name == app_name:
                st.deleting = True
        await self._bump_version()
        return True

    async def get_status(self) -> dict:
        out: dict = {}
        for st in self._deployments.values():
            opts = st.spec["config"].ray_actor_options
            # what each replica's actor leases: the CPU share it starts
            # with (below) and its cards
            resources = {"CPU": float(opts.get("num_cpus", 0.1))}
            if opts.get("num_gpus"):
                resources["GPU"] = float(opts["num_gpus"])
            info = {
                "target_replicas": st.target_replicas,
                "replicas": [
                    {"replica_id": rid, "healthy": rec["healthy"],
                     "state": ("UNHEALTHY" if not rec["healthy"] else
                               "RUNNING" if rec.get("ready") else "STARTING"),
                     "resources": dict(resources)}
                    for rid, rec in st.replicas.items()
                ],
                "ongoing": sum(st.metrics.values()),
                "deleting": st.deleting,
            }
            slo = getattr(st.spec["config"], "latency_slo_ms", None)
            if slo is not None:
                info["latency_slo_ms"] = slo
            p99 = self._p99.get(st.key)
            if p99 is not None:
                info["p99_ms"] = p99
            for ev in reversed(self._autoscale_events):
                if ev["key"] == st.key:
                    info["last_autoscale"] = ev
                    break
            out.setdefault(st.app_name, {})[st.name] = info
        return out

    async def get_routing_info(self, app_name: str, name: str,
                               known_version: int = -1, timeout_s: float = 10.0) -> dict:
        """Long-poll: return immediately when the table differs from
        known_version, else block until a change or timeout (ref:
        long_poll.py:222 LongPollHost.listen_for_change)."""
        await self._ensure_loop()
        if self._version == known_version:
            async with self._changed:
                try:
                    await asyncio.wait_for(
                        self._changed.wait_for(lambda: self._version != known_version),
                        timeout_s,
                    )
                except asyncio.TimeoutError:
                    pass
        st = self._deployments.get(f"{app_name}/{name}")
        replicas = []
        request_ft = None
        if st is not None and not st.deleting:
            replicas = [
                {"replica_id": rid, "actor_name": rec["actor_name"]}
                for rid, rec in st.replicas.items()
                if rec["healthy"] and rec.get("ready")
            ]
            # FT policy rides the long-poll so handles pick up retry/
            # deadline/hedge/backpressure config with membership — no
            # second control-plane RPC on any request path
            request_ft = st.spec["config"].request_ft()
        return {"version": self._version, "replicas": replicas,
                "request_ft": request_ft}

    async def report_handle_queued(self, app_name: str, name: str,
                                   router_id: str, queued: int) -> bool:
        """Routers report requests they cannot place (no replicas); feeds
        the autoscaler so min_replicas=0 deployments can scale from zero."""
        st = self._deployments.get(f"{app_name}/{name}")
        if st is None:
            return False
        if queued <= 0:
            st.handle_queued.pop(router_id, None)
        else:
            st.handle_queued[router_id] = (queued, time.monotonic())
        return True

    async def wait_ready(self, app_name: str, name: str, timeout_s: float = 60.0) -> bool:
        """Block until the deployment has its target count of ready replicas."""
        deadline = time.monotonic() + timeout_s
        key = f"{app_name}/{name}"
        while time.monotonic() < deadline:
            st = self._deployments.get(key)
            if st is not None:
                ready = sum(
                    1 for r in st.replicas.values() if r["healthy"] and r.get("ready")
                )
                if ready >= st.target_replicas:
                    return True
            await asyncio.sleep(0.05)
        return False

    # -------------------------------------------------------- reconcile loop
    async def _reconcile_loop(self):
        while not self._stopping:
            try:
                for st in list(self._deployments.values()):
                    await self._reconcile_one(st)
            except Exception:
                import traceback

                traceback.print_exc()
            await asyncio.sleep(0.1)

    async def _reconcile_one(self, st: _DeploymentState):
        import ray_tpu_torch

        if st.deleting:
            for rid, rec in list(st.replicas.items()):
                await self._stop_replica(st, rid, rec, drain=True)
            st.replicas.clear()
            self._deployments.pop(st.key, None)
            self._autoscaler.forget(st.key)
            await self._bump_version()
            return

        # 1. start missing replicas — SPREAD across alive nodes (fewest
        # replicas of THIS deployment first), the deployment-scheduler
        # role of the reference (ref: serve/_private/
        # deployment_scheduler.py:275 SPREAD placement + compaction)
        cfg = st.spec["config"]
        alive_nodes: list[str] | None = None
        if (len(st.replicas) < st.target_replicas
                and "scheduling_strategy" not in cfg.ray_actor_options):
            # ONE cluster-view fetch per reconcile pass; placement-intent
            # counts (target_node below) keep the SPREAD choice fresh as
            # this pass starts several replicas
            alive_nodes = await self._alive_nodes()
        while len(st.replicas) < st.target_replicas:
            rid = f"{st.name}#{uuid.uuid4().hex[:8]}"
            actor_name = f"SERVE_REPLICA::{st.app_name}/{rid}"
            from ray_tpu_torch.serve.replica import Replica

            opts = dict(cfg.ray_actor_options)
            opts.setdefault("num_cpus", 0.1)
            target_node = None
            if "scheduling_strategy" not in opts:
                target_node = self._pick_spread_node(st, alive_nodes)
                if target_node is not None:
                    from ray_tpu_torch.util.scheduling_strategies import (
                        NodeAffinitySchedulingStrategy,
                    )

                    # soft: placement is a preference — a full/dead node
                    # must not block replica startup
                    opts["scheduling_strategy"] = (
                        NodeAffinitySchedulingStrategy(target_node, soft=True))
            handle = (
                # per-replica name + placement: the options legitimately
                # differ every iteration, no handle to hoist
                ray_tpu_torch.remote(Replica)  # raylint: disable=RT009
                .options(
                    name=actor_name,
                    max_concurrency=max(8, cfg.max_ongoing_requests + 2),
                    **opts,
                )
                .remote(
                    st.spec["serialized_cls"],
                    st.spec["init_args"],
                    st.spec["init_kwargs"],
                    st.name,
                    rid,
                    cfg.max_ongoing_requests,
                    cfg.user_config,
                    getattr(cfg, "max_queued_requests", -1),
                    getattr(cfg, "latency_slo_ms", None),
                    st.app_name,
                    getattr(cfg, "ttfc_slo_ms", None),
                    getattr(cfg, "interchunk_slo_ms", None),
                )
            )
            st.replicas[rid] = {
                "handle": handle,
                "actor_name": actor_name,
                "healthy": True,
                "ready": False,
                "ping": None,
                "target_node": target_node,
            }

        # 2. stop surplus replicas — COMPACT: drain minority nodes first
        # (stop replicas on the node hosting the fewest of this
        # deployment), tie-broken by least-loaded, so downscale
        # consolidates the survivors onto fewer nodes (ref:
        # deployment_scheduler.py compaction on downscale)
        while len(st.replicas) > st.target_replicas:
            node_counts: dict = {}
            for rec in st.replicas.values():
                nid = rec.get("node_id")
                if nid is not None:
                    node_counts[nid] = node_counts.get(nid, 0) + 1

            def stop_rank(r):
                rec = st.replicas[r]
                nid = rec.get("node_id")
                # unknown-node replicas rank as majority (stop last among
                # equals on load) — their node may be the compaction target
                count = node_counts.get(nid, len(st.replicas)) \
                    if nid is not None else len(st.replicas)
                return (count, st.metrics.get(r, 0))

            rid = min(st.replicas, key=stop_rank)
            rec = st.replicas.pop(rid)
            st.metrics.pop(rid, None)
            st.totals.pop(rid, None)
            await self._stop_replica(st, rid, rec, drain=True)
            await self._bump_version()

        # 3. health + readiness + metrics probe (fan-out)
        interval = cfg.health_check_period_s
        if cfg.autoscaling_config is not None:
            interval = min(interval, cfg.autoscaling_config.metrics_interval_s)
        if any(not r.get("ready") for r in st.replicas.values()):
            interval = min(interval, 0.25)  # fast-poll only while converging
        now = time.monotonic()
        if now - st._last_health_check >= interval:
            st._last_health_check = now
            await self._probe_replicas(st)

        # 4. autoscaling decision
        await self._autoscale(st)

        # 5. SLO error-budget burn (same signals, one channel over)
        await self._slo_tick(st)

    async def _alive_nodes(self) -> list[str] | None:
        from ray_tpu_torch.core.api import get_core

        try:
            nodes = await get_core().gcs.call("get_cluster", {})
        except Exception:
            return None
        return [n["node_id"].hex() for n in nodes if n.get("alive", True)]

    def _pick_spread_node(self, st: _DeploymentState,
                          alive: list[str] | None) -> str | None:
        """SPREAD target: the alive node hosting the fewest replicas of
        this deployment. None on single-node clusters (or when the view
        is unavailable) — the default scheduler handles those fine."""
        if not alive or len(alive) <= 1:
            return None
        counts = {nid: 0 for nid in alive}
        for rec in st.replicas.values():
            # placement intent stands in until the actor table confirms
            # (several replicas start within one reconcile pass, all
            # before any probe has resolved a node_id)
            nid = rec.get("node_id") or rec.get("target_node")
            if nid in counts:
                counts[nid] += 1
        return min(alive, key=lambda nid: counts[nid])

    async def _probe_replicas(self, st: _DeploymentState):
        from ray_tpu_torch.core.api import get_core

        core = get_core()
        cfg = st.spec["config"]

        async def probe(rid, rec):
            try:
                ref = rec["handle"].get_metrics.remote()
                (m,) = await asyncio.wait_for(
                    core.get_async([ref], cfg.health_check_timeout_s),
                    cfg.health_check_timeout_s + 1,
                )
                st.metrics[rid] = int(m["ongoing"])
                st.totals[rid] = int(m.get("total", 0))  # arrival-rate feed
                if rec.get("node_id") is None:
                    # record placement once, for SPREAD counts + compaction
                    try:
                        info = await core.gcs.call(
                            "get_actor", {"actor_id": rec["handle"].actor_id})
                        if info and info.get("node_id") is not None:
                            rec["node_id"] = info["node_id"].hex()
                    except Exception:  # raylint: disable=RT012 — placement is advisory; retried next poll
                        pass
                if not rec.get("ready"):
                    rec["ready"] = True
                    await self._bump_version()
                rec["fails"] = 0
            except Exception:
                rec["fails"] = rec.get("fails", 0) + 1
                # a constructing replica is not failed: only count after ready
                if rec.get("ready") and rec["fails"] >= 2:
                    rec["healthy"] = False
                    st.replicas.pop(rid, None)
                    st.metrics.pop(rid, None)
                    st.totals.pop(rid, None)
                    await self._stop_replica(st, rid, rec, drain=False)
                    await self._bump_version()

        await asyncio.gather(*(probe(r, rec) for r, rec in list(st.replicas.items())))

    async def _autoscale(self, st: _DeploymentState):
        """One SLO-feedback autoscaling tick (policy lives in
        serve/dataplane/autoscaler.py; this gathers signals, applies the
        fired decision, and publishes it with its cause)."""
        cfg = st.spec["config"]
        auto = cfg.autoscaling_config
        if auto is None:
            return
        now = time.monotonic()
        for rid, (_, ts) in list(st.handle_queued.items()):
            if now - ts > 3.0:  # stale reporter
                st.handle_queued.pop(rid, None)
        slo_ms = getattr(cfg, "latency_slo_ms", None)
        # streaming signals share the latency plane under prefixed keys
        # (serve/streaming/slo.py): pick whichever signal — unary e2e,
        # TTFC, or inter-chunk gap — is burning hottest against ITS
        # budget, so a deployment whose streams stall upscales even while
        # its unary p99 looks healthy
        signals = self._slo_signals(st.key, cfg)
        if signals:
            await self._refresh_p99()
        best = None
        for key, budget in signals:
            p = self._p99.get(key)
            if p is not None and (best is None or p / budget > best[0]):
                best = (p / budget, p, budget)
        p99_ms, sig_slo = ((best[1], best[2]) if best is not None
                           else (self._p99.get(st.key), slo_ms))
        decision = self._autoscaler.decide(
            st.key,
            current=st.target_replicas,
            auto=auto,
            ongoing=float(sum(st.metrics.values())),
            handle_queued=float(sum(q for q, _ in st.handle_queued.values())),
            p99_ms=p99_ms,
            slo_ms=sig_slo,
            lifetime_total=sum(st.totals.values()) if st.totals else None,
        )
        if decision is None:
            return
        st.target_replicas = decision.to_replicas
        self._autoscale_events.append(decision.to_dict())
        del self._autoscale_events[:-AUTOSCALE_EVENTS_CAP]
        await self._publish_autoscale(decision)

    async def _refresh_p99(self):
        """Deployment p99s from the ns="latency" kv namespace: every
        replica worker publishes its recent serve request window there
        (replica.py's "serve" latency source, the same plumbing the
        flight recorder and the sharded plane use). Rate-limited to one
        fetch per 0.5s across all deployments; stale windows (a dead
        replica's last publish) are dropped by their embedded ts."""
        from ray_tpu_torch.core.api import get_core
        from ray_tpu_torch.utils.recorder import percentile

        now = time.monotonic()
        if now - self._p99_fetched < 0.5:
            return
        self._p99_fetched = now
        try:
            gcs = get_core().gcs
            keys = await gcs.call("kv_keys", {"ns": "latency", "prefix": ""})
            keys = [k for k in keys if k.endswith(".serve")]
            merged: dict[str, list] = {}
            if keys:
                blobs = await gcs.call("kv_multi_get",
                                       {"ns": "latency", "keys": keys})
                wall = time.time()
                for k in keys:
                    blob = blobs.get(k)
                    if not blob:
                        continue
                    snap = pickle.loads(blob)
                    if wall - snap.get("ts", 0.0) > 60.0:
                        continue  # dead publisher's leftover window
                    for stage, vals in snap.get("stages", {}).items():
                        if stage.startswith("serve_"):
                            merged.setdefault(stage[6:], []).extend(vals)
            self._p99 = {key: percentile(sorted(vals), 0.99) / 1e6
                         for key, vals in merged.items() if vals}
            self._lat_windows = merged  # raw ns windows: burn monitor
        except Exception:
            # transient GCS error: keep the previous view — autoscaling
            # on a slightly stale p99 beats flapping on a missing one
            import logging

            logging.getLogger(__name__).debug(
                "serve p99 refresh failed", exc_info=True)

    @staticmethod
    def _slo_signals(key: str, cfg) -> list[tuple[str, float]]:
        """(latency-plane key, budget_ms) pairs with a configured budget:
        unary e2e, streaming TTFC (inheriting the unary budget when
        unset, matching the replica-side default), inter-chunk gap."""
        slo_ms = getattr(cfg, "latency_slo_ms", None)
        ttfc_ms = getattr(cfg, "ttfc_slo_ms", None)
        if ttfc_ms is None:
            ttfc_ms = slo_ms
        gap_ms = getattr(cfg, "interchunk_slo_ms", None)
        return [(k, float(b)) for k, b in
                ((key, slo_ms), (f"ttfc:{key}", ttfc_ms),
                 (f"gap:{key}", gap_ms))
                if b is not None]

    async def _slo_tick(self, st: _DeploymentState):
        """One burn-rate observation + alert check per SLO signal of one
        deployment — unary e2e, streaming TTFC, inter-chunk gap; each
        burns independently against its own budget under its own monitor
        key (a stalling stream fires ``gap:<key>`` without touching the
        unary alert state). Fired alerts ride the ``slo_burn`` pubsub
        channel and a bounded ns="serve" kv history — the autoscale
        fan-out shape."""
        for key, budget in self._slo_signals(st.key, st.spec["config"]):
            breach = await self._breach_fraction(st, budget, key=key)
            if breach is None:
                continue
            self._slo_monitor.observe(key, breach)
            alert = self._slo_monitor.check(key, budget)
            if alert is None:
                continue
            self._slo_burn_events.append(alert.to_dict())
            del self._slo_burn_events[:-AUTOSCALE_EVENTS_CAP]
            await self._publish_burn(alert)

    async def _publish_burn(self, alert) -> None:
        from ray_tpu_torch.core.api import get_core

        try:
            gcs = get_core().gcs
            await gcs.call("publish", {"channel": "slo_burn",
                                       "message": alert.to_dict()})
            await gcs.call("kv_put", {
                "ns": "serve", "key": "slo_burn_events",
                "value": pickle.dumps(self._slo_burn_events)})
        except Exception:
            # telemetry only — the alert history republishes next edge
            import logging

            logging.getLogger(__name__).debug(
                "slo burn publish failed", exc_info=True)

    async def _breach_fraction(self, st: _DeploymentState, slo_ms: float,
                               key: str | None = None) -> float | None:
        """One signal's SLO breach fraction over the recent window
        (``key`` defaults to the deployment's unary e2e key; streaming
        signals pass ``ttfc:<key>`` / ``gap:<key>`` — the replica-side
        counters are tagged with the same prefixed keys).

        Primary source: the GCS rollup plane's derived
        ``serve_slo_breach_fraction`` ratio (replica-side breach/request
        counter deltas — the control loop reads its own published
        history, the same windows ``state.metric_window`` serves).
        Fallback: the raw ns="latency" windows (replicas that predate
        the counters, or a rollup plane with no points yet)."""
        from ray_tpu_torch.core.api import get_core

        key = key or st.key
        try:
            win = await get_core().gcs.call("metric_window", {
                "name": "serve_slo_breach_fraction", "secs": 30.0,
                "tags": {"key": key}})
            pts = (win or {}).get("points") or []
            den = sum(p["den"] for p in pts)
            if den > 0:
                return sum(p["num"] for p in pts) / den
        except Exception:
            import logging

            logging.getLogger(__name__).debug(
                "rollup breach-fraction fetch failed", exc_info=True)
        await self._refresh_p99()  # also refreshes _lat_windows
        window = self._lat_windows.get(key)
        if not window:
            return None
        slo_ns = slo_ms * 1e6
        return sum(1 for v in window if v > slo_ns) / len(window)

    async def get_slo_burn_events(self, key: str | None = None) -> list[dict]:
        """Bounded history of fired burn-rate alerts (newest last)."""
        if key is None:
            return list(self._slo_burn_events)
        return [e for e in self._slo_burn_events if e.get("key") == key]

    async def _publish_autoscale(self, decision):
        """Fan the decision out: the serve_autoscale pubsub channel
        (push consumers: tests, dashboards, operators' tooling) and a
        bounded ns="serve" kv history (pull consumers:
        state.list_serve_autoscale_events)."""
        from ray_tpu_torch.core.api import get_core

        try:
            gcs = get_core().gcs
            await gcs.call("publish", {"channel": "serve_autoscale",
                                       "message": decision.to_dict()})
            await gcs.call("kv_put", {
                "ns": "serve", "key": "autoscale_events",
                "value": pickle.dumps(self._autoscale_events)})
        except Exception:
            # telemetry only — the scale decision itself already applied
            import logging

            logging.getLogger(__name__).debug(
                "serve autoscale publish failed", exc_info=True)

    async def get_autoscale_events(self, key: str | None = None) -> list[dict]:
        """Bounded history of fired autoscale decisions (newest last);
        ``key`` filters to one "app/deployment"."""
        if key is None:
            return list(self._autoscale_events)
        return [e for e in self._autoscale_events if e["key"] == key]

    async def _stop_replica(self, st: _DeploymentState, rid: str, rec: dict, drain: bool):
        from ray_tpu_torch.core.api import get_core

        core = get_core()
        cfg = st.spec["config"]
        try:
            if drain and rec.get("ready"):
                ref = rec["handle"].prepare_for_shutdown.remote(
                    cfg.graceful_shutdown_timeout_s
                )
                await asyncio.wait_for(
                    core.get_async([ref], cfg.graceful_shutdown_timeout_s + 1),
                    cfg.graceful_shutdown_timeout_s + 2,
                )
        except Exception:  # raylint: disable=RT012 — graceful drain best-effort; kill below is the backstop
            pass
        try:
            await core.gcs.call(
                "kill_actor", {"actor_id": rec["handle"].actor_id, "no_restart": True}
            )
        except Exception:  # raylint: disable=RT012 — teardown: replica may already be dead
            pass

    async def shutdown(self) -> bool:
        self._stopping = True
        for st in list(self._deployments.values()):
            st.deleting = True
            for rid, rec in list(st.replicas.items()):
                await self._stop_replica(st, rid, rec, drain=False)
            st.replicas.clear()
        self._deployments.clear()
        await self._bump_version()
        return True
