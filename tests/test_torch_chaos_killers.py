"""The port's process killers (``ray_tpu_torch.devtools.chaos.killers``)
and churn harness (``ray_tpu_torch.devtools.churn``) on the CPU, against
the JAX package's.

- ``tests/test_chaos.py``'s worker killer: SIGKILLed workers under a
  running runtime, retries absorbing every loss; each strike also lands in
  the chaos event log when the controller is armed.
- ``tests/test_resilience.py``'s interval raylet killer with restore:
  non-head raylets hard-killed while a retryable workload runs; here the
  killed nodes hold a card (``GPU`` 1), and each restored node comes back
  with the victim's totals, the card included.
- ``tests/test_pg_ft.py``'s seeded churn plan (``tests/plans/pg_churn.json``)
  on the port's ``ChurnHarness``: every persistent placement group
  re-converges, every simulated actor comes back ALIVE, and the audit
  finds zero leaked or missing bundle reservations.
- Parity: for one seed and one cluster shape, JAX's and the port's killers
  strike the same raylet and worker indices in the same order.

Strikes are paced by progress (``strike_once`` per wave), not by the
clock: a wall-clock cadence lands more kills per task on a loaded host
(``tests/test_resilience.py`` says why).
"""

import os
import signal
import subprocess
import time
import types

import pytest

import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

_module_limit, _test_limit = time_limits(module_s=150, test_s=100)


# ---------------------------------------------- tests/test_chaos.py, translated
def test_worker_killer_workload_completes(tmp_path):
    """chaos.killers worker target: SIGKILL live worker processes under
    a running runtime; retries absorb every loss without losing a node,
    and every strike is in the armed controller's event log."""
    from ray_tpu_torch.core import api as _api
    from ray_tpu_torch.devtools import chaos
    from ray_tpu_torch.devtools.chaos.cli import read_events
    from ray_tpu_torch.devtools.chaos.killers import ProcessKiller
    from ray_tpu_torch.devtools.chaos.plan import ChaosPlan

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    ray_tpu_torch.init(num_cpus=4)
    log_dir = str(tmp_path / "chaos")
    chaos.enable(ChaosPlan(seed=0, rules=[]), log_dir=log_dir)
    try:
        @ray_tpu_torch.remote(max_retries=6)
        def work(i):
            time.sleep(0.15)
            return i + 100

        # warm the pool so the killer has victims from the start
        assert ray_tpu_torch.get(work.remote(0), timeout=60) == 100
        killer = ProcessKiller(_api._owned_cluster, seed=1, target="worker")
        results = []
        for wave in range(4):
            refs = [work.remote(wave * 6 + j) for j in range(6)]
            killer.strike_once()  # with the wave in flight
            results.extend(ray_tpu_torch.get(refs, timeout=120))
        assert sorted(results) == [i + 100 for i in range(24)]
        assert killer.kills, "worker killer never struck"
        assert all(k["target"] == "worker" for k in killer.kills)
        logged = [e for e in read_events(log_dir) if e["point"] == "killer.worker"]
        assert sorted(e["ctx"]["pid"] for e in logged) == sorted(k["pid"] for k in killer.kills)
    finally:
        chaos.disable()
        ray_tpu_torch.shutdown()


# ------------------------------------------ tests/test_resilience.py, translated
def test_chaos_interval_killer_workload_completes():
    """A 3-node cluster loses a non-head raylet at each wave — hard kill,
    no goodbyes — while a retryable task workload runs to completion.
    Retries + lease spillback absorb every loss; each replacement takes
    its victim's totals (4 CPUs and a card)."""
    from ray_tpu_torch.core import api as _api
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.core.core_client import CoreClient
    from ray_tpu_torch.devtools.chaos.killers import IntervalKiller
    from ray_tpu_torch.utils import rpc as _rpc

    ray_tpu_torch.shutdown()
    io = _rpc.EventLoopThread()
    cluster = Cluster(io=io)
    head = cluster.add_node(num_cpus=4.0)
    for _ in range(2):
        cluster.add_node(resources={"CPU": 4.0, "GPU": 1.0})
    core = CoreClient(loop=io.loop)
    io.run(core.connect(cluster.gcs_address, head.server.address))
    old = _api._core
    _api._core = core
    killer = IntervalKiller(cluster, seed=0, interval_s=2.0, restore=True)
    try:
        @ray_tpu_torch.remote(max_retries=8, num_cpus=1.0)
        def work(i):
            import time as _t

            _t.sleep(0.3)  # long enough that kills land mid-task
            return i * 2

        results = []
        for wave in range(6):
            refs = [work.remote(wave * 8 + j) for j in range(8)]
            if wave:  # strike with the wave in flight: kills land
                killer.strike_once()  # mid-task, victims still seeded
            results.extend(ray_tpu_torch.get(refs, timeout=120))
        assert sorted(results) == [i * 2 for i in range(48)]
        assert len(killer.kills) >= 2, f"chaos never struck (kills={len(killer.kills)})"
        assert all(k["target"] == "raylet" for k in killer.kills)
        assert len(cluster.raylets) == 3 and cluster.raylets[0] is head
        for r in cluster.raylets[1:]:
            assert r.ledger.total["GPU"] == 1.0 and r.ledger.total["CPU"] == 4.0
    finally:
        killer.stop()
        _api._core = old
        try:
            io.run(core.close(), timeout=10)
        except Exception:
            pass  # links already torn by the last kill
        cluster.shutdown()
        io.stop()


# ---------------------------------------------- tests/test_pg_ft.py, translated
def test_seeded_churn_plan_zero_leaks():
    """The checked-in seeded churn plan (tests/plans/pg_churn.json:
    injected 2PC prepare/commit faults) over seeded node join/leave:
    every persistent PG re-converges, every simulated PG-bound actor
    comes back ALIVE, and the post-settle audit finds ZERO leaked
    bundle reservations across all surviving nodes."""
    from ray_tpu_torch.devtools import chaos
    from ray_tpu_torch.devtools.chaos.plan import ChaosPlan
    from ray_tpu_torch.devtools.churn import ChurnHarness

    plan = ChaosPlan.load(os.path.join(os.path.dirname(__file__), "plans", "pg_churn.json"))
    ctrl = chaos.enable(plan)
    h = ChurnHarness(nodes=12, seed=3)
    try:
        h.start()
        metrics = h.run(duration_s=5.0, pg_cyclers=2, persistent_pgs=4,
                        bundles_per_pg=2, actors_per_pg=1,
                        kill_every_s=0.7, min_nodes=5)
        audit = h.audit()
        assert audit["leaked"] == [], audit
        assert audit["missing"] == [], audit
        assert metrics["unsettled_pgs"] == 0, metrics
        assert metrics["actors_alive"] == metrics["actors_total"], metrics
        assert metrics["node_kills"] >= 2, metrics
        assert metrics["pg_cycles"] > 0, metrics
        # the plan actually struck: injected 2PC faults were absorbed
        fired = {e["point"] for e in ctrl.events}
        assert fired & {"gcs.pg_prepare", "gcs.pg_commit"}, fired
    finally:
        chaos.disable()
        h.stop()


# ------------------------------------------------- victim parity with JAX
class _Raylet:
    def __init__(self, index: int, total: dict):
        self.index = index
        self.ledger = types.SimpleNamespace(total=dict(total))
        self.node_id = types.SimpleNamespace(hex=lambda: f"{index:032x}")
        self.all_workers: dict = {}


class _Cluster:
    """``raylets``, ``kill_node`` and ``add_node`` as a killer uses them;
    ``killed`` holds each victim's index in ``raylets`` when struck."""

    def __init__(self, n: int):
        self.raylets = [_Raylet(i, {"CPU": 4.0, "GPU": 1.0, "node": 1.0}) for i in range(n)]
        self.killed: list[int] = []
        self._next = n

    def kill_node(self, raylet):
        self.killed.append(self.raylets.index(raylet))
        self.raylets.remove(raylet)

    def add_node(self, num_cpus=None, resources=None):
        self.raylets.append(_Raylet(self._next, resources or {"CPU": num_cpus}))
        self._next += 1


def _raylet_victims(killers_mod, cls, seed) -> tuple[list, list]:
    cluster = _Cluster(5)
    killer = getattr(killers_mod, cls)(cluster, seed=seed, target="raylet", restore=True)
    for _ in range(6):
        killer.strike_once()
    return cluster.killed, [r.ledger.total for r in cluster.raylets]


def _worker_victims(killers_mod, seed) -> list:
    """(raylet, worker) indices of each struck worker over 3 raylets of 3
    workers each (one never READY), real ``sleep`` processes."""
    cluster = _Cluster(3)
    procs = []
    where = {}
    for ri, r in enumerate(cluster.raylets):
        for wi in range(3):
            p = subprocess.Popen(["sleep", "60"])
            procs.append(p)
            where[p.pid] = (ri, wi)
            r.all_workers[wi] = types.SimpleNamespace(
                proc=p, address=None if wi == 2 else ("127.0.0.1", 1000 + wi),
                worker_id=types.SimpleNamespace(hex=lambda wi=wi: f"w{wi}"))
    killer = killers_mod.ProcessKiller(cluster, seed=seed, target="worker")
    try:
        for _ in range(4):
            killer.strike_once()
            for k in killer.kills:  # reaped, so the next strike sees it gone
                procs[[p.pid for p in procs].index(k["pid"])].wait(timeout=10)
        return [where[k["pid"]] for k in killer.kills]
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
                p.wait(timeout=10)


@pytest.mark.parametrize("seed", [0, 7])
def test_killers_choose_the_victims_jax_chooses(seed):
    from ray_tpu.devtools.chaos import killers as jax_killers

    from ray_tpu_torch.devtools.chaos import killers

    for cls in ("IntervalKiller", "BurstKiller"):
        ours, totals = _raylet_victims(killers, cls, seed)
        theirs, _ = _raylet_victims(jax_killers, cls, seed)
        assert ours == theirs and len(ours) == (6 if cls == "IntervalKiller" else 12)
        # the port's restored nodes keep the victims' cards
        assert all(t.get("GPU") == 1.0 for t in totals)
    ours = _worker_victims(killers, seed)
    assert ours == _worker_victims(jax_killers, seed) and len(ours) == 4
    assert all(wi != 2 for _, wi in ours)  # a worker not yet READY is never struck
