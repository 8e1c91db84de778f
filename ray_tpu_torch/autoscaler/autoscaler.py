"""Autoscaler reconciler: demand up, idle down.

The port's copy of ``ray_tpu/autoscaler/autoscaler.py`` (ref:
python/ray/autoscaler/v2/instance_manager/reconciler.py): a loop that
reads the GCS cluster view (resources + queued lease demand from raylet
heartbeats), launches nodes while demand persists past upscale_delay_s,
and drains nodes idle past idle_timeout_s down to min_nodes. A node is
busy while any of its resources is leased, so a card node stays up while
its ``GPU`` is held. The decisions are JAX's, step for step.
"""
from __future__ import annotations

import dataclasses
import threading
import time


@dataclasses.dataclass
class AutoscalerConfig:
    min_nodes: int = 1
    max_nodes: int = 4
    upscale_delay_s: float = 1.0
    idle_timeout_s: float = 10.0
    poll_interval_s: float = 0.5
    #: a launched node that never registers with the GCS within this
    #: window is reclaimed (raylet crashed while the cloud resource
    #: lives; without this the permanent 'pending' wedges scale-up)
    pending_timeout_s: float = 300.0
    #: resources for each new node (the provider default if None)
    node_resources: dict | None = None


class Autoscaler:
    """Runs against a live GCS; drives a NodeProvider."""

    def __init__(self, gcs_address: tuple[str, int], provider,
                 config: AutoscalerConfig | None = None):
        self.gcs_address = gcs_address
        self.provider = provider
        self.config = config or AutoscalerConfig()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._demand_since: float | None = None
        # GCS node_id hex -> first time seen idle
        self._idle_since: dict[str, float] = {}
        # provider id -> first time seen launched-but-unregistered
        self._pending_since: dict[str, float] = {}
        # provider node ids this autoscaler launched (never scales below
        # nodes it doesn't own)
        self._launched: list[str] = []
        self.events: list[dict] = []  # scaling decisions (observability)

    # ------------------------------------------------------------- lifecycle
    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rt-autoscaler")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -------------------------------------------------------------- the loop
    def _run(self):
        import logging

        from ray_tpu_torch.utils import rpc

        logger = logging.getLogger("ray_tpu_torch.autoscaler")
        io = rpc.EventLoopThread(name="rt-autoscale-io")
        conn = None
        try:
            while not self._stop.is_set():
                try:
                    if conn is None or conn._closed:
                        conn = io.run(rpc.connect(*self.gcs_address, timeout=10))
                    nodes = io.run(conn.call("get_cluster", {}))
                    self._reconcile(nodes)
                except Exception as e:
                    logger.warning("autoscaler reconcile failed: %r", e)
                    conn = None  # reconnect on the next pass
                self._stop.wait(self.config.poll_interval_s)
            if conn is not None:
                io.run(conn.close())
        finally:
            io.stop()

    def _reconcile(self, nodes: list[dict]):
        cfg = self.config
        now = time.monotonic()
        alive = [n for n in nodes if n.get("alive")]
        total_queued = sum(int(n.get("queued_leases", 0)) for n in alive)

        # advance provider-side lifecycle (v2 instance manager state
        # machine: cloud operations, ALLOCATED->RAY_RUNNING matching);
        # reconcile() returns the live set so one cloud list serves the
        # whole pass
        live_provider = None
        if hasattr(self.provider, "reconcile"):
            live_provider = self.provider.reconcile(alive)
        if live_provider is None:
            live_provider = set(self.provider.non_terminated_nodes())
        # prune launched nodes the provider no longer tracks (and their
        # pending timestamps: a reused provider id must not inherit one)
        self._launched = [l for l in self._launched if l in live_provider]
        for k in [k for k in self._pending_since if k not in self._launched]:
            del self._pending_since[k]
        # pending = launched but not yet registered with the GCS: while any
        # exist, don't launch more (ref: v2 instance-manager pending states)
        pending = []
        for l in list(self._launched):  # reclaim mutates the list
            if any(self.provider.matches(l, n) for n in alive):
                self._pending_since.pop(l, None)
                continue
            first = self._pending_since.setdefault(l, now)
            if now - first > cfg.pending_timeout_s:
                # cloud resource lives but its raylet never registered
                # (crashed during bootstrap): reclaim it or scale-up
                # wedges behind a permanent 'pending' entry
                self.provider.terminate_node(l)
                self._launched.remove(l)
                self._pending_since.pop(l, None)
                self.events.append({"ts": time.time(), "action": "reclaim",
                                    "node": l})
                continue
            pending.append(l)

        # ---- scale up: queued demand nothing alive can absorb
        if total_queued > 0 and not pending:
            if self._demand_since is None:
                self._demand_since = now
            elif (now - self._demand_since >= cfg.upscale_delay_s
                  and len(alive) < cfg.max_nodes):
                node_id = self.provider.create_node(cfg.node_resources)
                self._launched.append(node_id)
                self._demand_since = None
                self.events.append({"ts": time.time(), "action": "up",
                                    "node": node_id, "queued": total_queued})
        else:
            self._demand_since = None

        # ---- scale down: an autoscaler-launched node idle past the timeout
        if len(alive) <= cfg.min_nodes or not self._launched:
            self._idle_since = {}
            return
        for n in alive:
            provider_id = next(
                (l for l in self._launched if self.provider.matches(l, n)),
                None)
            if provider_id is None:
                continue  # never touch nodes this autoscaler didn't launch
            nid = n["node_id"].hex() if hasattr(n["node_id"], "hex") else str(n["node_id"])
            # idle = full resources available and no queued demand
            res_t, res_a = n["resources_total"], n["resources_available"]
            busy = any(res_a.get(k, 0.0) < v - 1e-9 for k, v in res_t.items()
                       if k != "node") or n.get("queued_leases", 0) > 0
            if busy:
                self._idle_since.pop(nid, None)
                continue
            first = self._idle_since.setdefault(nid, now)
            if now - first >= cfg.idle_timeout_s:
                # terminate exactly the node observed idle; one per pass
                self.provider.terminate_node(provider_id)
                self._launched.remove(provider_id)
                self._idle_since.pop(nid, None)
                self.events.append({"ts": time.time(), "action": "down",
                                    "node": provider_id})
                break
