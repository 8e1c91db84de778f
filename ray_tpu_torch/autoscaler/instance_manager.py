"""v2-style instance lifecycle tracking for autoscaled nodes.

The port's copy of ``ray_tpu/autoscaler/instance_manager.py``, the
counterpart of the reference's autoscaler v2 instance manager
(ref: python/ray/autoscaler/v2/instance_manager/{instance_manager,
reconciler,instance_storage}.py + instance_manager.proto states): every
node the autoscaler launches is an :class:`Instance` advancing through

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING
                 |              |            |
                 v              v            v
        ALLOCATION_FAILED   TERMINATING -> TERMINATED
                              (RAY_STOPPING first when draining a live
                               ray node)

The :class:`InstanceManager` wraps any NodeProvider: the reconciler keeps
calling the familiar create/terminate/non_terminated surface, while the
manager records transitions (with timestamps, for observability and
stuck-instance detection) and advances cloud-side state on
``reconcile(gcs_nodes)`` — REQUESTED instances whose cloud resource
materialized become ALLOCATED, ALLOCATED instances whose raylet
registered become RAY_RUNNING, TERMINATING instances whose cloud
resource vanished become TERMINATED.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
RAY_STOPPING = "RAY_STOPPING"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"
ALLOCATION_FAILED = "ALLOCATION_FAILED"

_LIVE_STATES = (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING, RAY_STOPPING)


@dataclass
class Instance:
    instance_id: str
    resources: dict
    state: str = QUEUED
    created_at: float = field(default_factory=time.time)
    state_since: float = field(default_factory=time.monotonic)
    transitions: list = field(default_factory=list)  # (ts, from, to)
    error: str | None = None

    def to(self, state: str) -> None:
        self.transitions.append((time.time(), self.state, state))
        self.state = state
        self.state_since = time.monotonic()


class InstanceManager:
    """NodeProvider facade + lifecycle ledger over a real provider."""

    #: REQUESTED instances whose cloud resource never appears within this
    #: window fail (async create errors surface as an absent resource)
    ALLOCATE_TIMEOUT_S = 300.0
    #: terminal instances kept for observability before eviction (the
    #: reference's instance_storage GCs terminal records the same way)
    KEEP_TERMINAL = 64

    def __init__(self, provider):
        self.provider = provider
        self.instances: dict[str, Instance] = {}

    # ----------------------------------------------- NodeProvider surface
    def create_node(self, resources: dict | None = None) -> str:
        inst = Instance("pending", dict(resources or {}))
        inst.to(REQUESTED)
        try:
            iid = self.provider.create_node(resources)
        except Exception as e:
            inst.instance_id = f"failed-{time.time_ns()}"
            inst.error = repr(e)
            inst.to(ALLOCATION_FAILED)
            self.instances[inst.instance_id] = inst
            raise
        inst.instance_id = iid
        self.instances[iid] = inst
        return iid

    def terminate_node(self, instance_id: str) -> None:
        inst = self.instances.get(instance_id)
        if inst is not None and inst.state not in (TERMINATING, TERMINATED):
            if inst.state == RAY_RUNNING:
                inst.to(RAY_STOPPING)
            inst.to(TERMINATING)
        self.provider.terminate_node(instance_id)

    def non_terminated_nodes(self) -> list[str]:
        return self.provider.non_terminated_nodes()

    def matches(self, instance_id: str, gcs_node: dict) -> bool:
        return self.provider.matches(instance_id, gcs_node)

    # --------------------------------------------------- state advancement
    def reconcile(self, gcs_nodes: list[dict]) -> set[str]:
        """Advance instance states from observed cloud + GCS reality.
        Returns the live provider-node set so the caller need not list
        the cloud a second time in the same pass."""
        if hasattr(self.provider, "reconcile"):
            self.provider.reconcile(gcs_nodes)
        live = set(self.provider.non_terminated_nodes())
        now = time.monotonic()
        for iid, inst in self.instances.items():
            if inst.state == REQUESTED and iid in live:
                inst.to(ALLOCATED)
            if inst.state in (REQUESTED, ALLOCATED) and any(
                    self.provider.matches(iid, n) for n in gcs_nodes):
                if inst.state == REQUESTED:
                    inst.to(ALLOCATED)
                inst.to(RAY_RUNNING)
            elif (inst.state == REQUESTED
                    and now - inst.state_since > self.ALLOCATE_TIMEOUT_S):
                # async create failure: the cloud resource never appeared
                inst.error = inst.error or "allocation timed out"
                inst.to(ALLOCATION_FAILED)
            elif inst.state in (RAY_STOPPING, TERMINATING) and iid not in live:
                inst.to(TERMINATED)
            elif (inst.state in (ALLOCATED, RAY_RUNNING)
                    and iid not in live):
                # cloud resource vanished under us (preemption, manual
                # delete): terminal, the reconciler may relaunch on demand
                inst.error = inst.error or "instance disappeared"
                inst.to(TERMINATED)
        self._evict_terminal()
        return live

    def _evict_terminal(self) -> None:
        terminal = [iid for iid, i in self.instances.items()
                    if i.state in (TERMINATED, ALLOCATION_FAILED)]
        for iid in terminal[:-self.KEEP_TERMINAL or None]:
            del self.instances[iid]

    # ------------------------------------------------------- observability
    def live_instances(self) -> list[Instance]:
        return [i for i in self.instances.values()
                if i.state in _LIVE_STATES]

    def summary(self) -> dict:
        out: dict[str, int] = {}
        for inst in self.instances.values():
            out[inst.state] = out.get(inst.state, 0) + 1
        return out
