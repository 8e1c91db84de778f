"""The port's autoscaler (``ray_tpu_torch.autoscaler``) on the CPU, against
the JAX package's ``ray_tpu.autoscaler``.

- Every case of ``tests/test_autoscaler_gke.py``, on ``GKEGPUNodeProvider``
  against a fake GKE that checks each GPU node pool's body (machine type,
  ``accelerators``, the ``instance`` label; no ``tpuTopology``).
- Parity: one scripted sequence of GCS cluster views and clock readings
  through JAX's ``Autoscaler._reconcile`` and the port's, each over an
  ``InstanceManager`` of a recording fake provider, gives the same
  ``(action, node)`` events, the same instance states and the same
  ``summary()``. JAX's autoscaler modules load no JAX, so both run here.
- A parked lease: a lease the head can never hold (it has no ``GPU``)
  parks there, and moves to a node that joins and can hold it, while a
  feasible-but-busy lease and a ``no_spill`` one stay parked.
- The autoscaler case of ``tests/test_cluster_tools.py`` with
  ``LocalSubprocessProvider`` raylets: queued CPU demand scales up, and a
  ``num_gpus=1`` task queued on a card-less head scales a node up and runs
  there; each scales back down once idle. The tasks hold until the test
  has seen the node (a file appears), where JAX's sleep 3 s.
- ``start --head --num-gpus 0 --autoscale 1:2`` through the CLI: a card
  task runs on the node the monitor started, and after ``stop`` none of the
  session's processes, nor that raylet, is left. The stand-in card is
  ``CUDA_VISIBLE_DEVICES=0``, which the autoscaled raylet counts.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import pytest

import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse
from ray_tpu_torch.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    GKEGPUNodeProvider,
    InstanceManager,
    LocalSubprocessProvider,
)
from ray_tpu_torch.autoscaler import gke
from ray_tpu_torch.autoscaler import instance_manager as im

# the slowest case (a runtime, a raylet subprocess up and down) ~10 s alone
_module_limit, _test_limit = time_limits(module_s=150, test_s=90)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------ tests/test_autoscaler_gke.py
class FakeGKE:
    """In-memory container-API surface: node pools provision after one
    poll, delete after one poll. Every created pool's body must be a GPU
    node pool of a known type."""

    def __init__(self):
        self.pools: dict[str, dict] = {}
        self.calls: list[tuple[str, str]] = []

    def __call__(self, method, path, body=None):
        self.calls.append((method, path))
        if method == "POST":
            pool = dict(body["nodePool"], status="PROVISIONING")
            cfg = pool["config"]
            known = {(m, a, str(n)) for m, a, n in gke.GPU_NODE_TYPES.values()}
            (acc,) = cfg["accelerators"]
            assert (cfg["machineType"], acc["acceleratorType"], acc["acceleratorCount"]) in known
            assert cfg["labels"] == {"instance": pool["name"]}
            assert pool["initialNodeCount"] == 1 and "placementPolicy" not in pool
            self.pools[pool["name"]] = pool
            return {"name": f"op-create-{pool['name']}"}
        if method == "DELETE":
            name = path.rsplit("/", 1)[1]
            if name in self.pools:
                self.pools[name]["status"] = "STOPPING"
            return {"name": f"op-delete-{name}"}
        # GET: advance the fake cloud one step per poll
        for pool in list(self.pools.values()):
            if pool["status"] == "PROVISIONING":
                pool["status"] = "RUNNING"
            elif pool["status"] == "STOPPING":
                del self.pools[pool["name"]]
        return {"nodePools": list(self.pools.values())}


def _gcs_node(pool_name, queued=0, busy=False):
    class _Nid:
        def hex(self):
            return f"node-{pool_name}"

    return {
        "node_id": _Nid(),
        "alive": True,
        "pid": 0,
        "labels": {"instance": pool_name},
        "queued_leases": queued,
        "resources_total": {"CPU": 208.0, "GPU": 8.0, "node": 1.0},
        "resources_available": (
            {"CPU": 207.0, "GPU": 7.0, "node": 1.0} if busy
            else {"CPU": 208.0, "GPU": 8.0, "node": 1.0}),
    }


def test_node_pool_scale_up_and_drain():
    """Demand scales a fake GPU node pool up (full lifecycle to
    RAY_RUNNING); idleness drains it back down (to TERMINATED)."""
    fake = FakeGKE()
    mgr = InstanceManager(GKEGPUNodeProvider(
        "proj", "us-central1-a", "cluster", node_type="h100-80gb-8", transport=fake))
    scaler = Autoscaler(
        ("127.0.0.1", 0), mgr,
        AutoscalerConfig(min_nodes=1, max_nodes=3, upscale_delay_s=0.05,
                         idle_timeout_s=0.2))
    # head node busy with queued card demand -> launch a pool
    head = _gcs_node("head", queued=3, busy=True)
    head["labels"] = {}
    scaler._reconcile([head])  # records demand
    time.sleep(0.06)
    scaler._reconcile([head])  # past upscale_delay: creates the pool
    assert any(a == ("POST", mgr.provider.parent + "/nodePools") for a in fake.calls)
    (pool_name,) = [p for p in fake.pools]
    assert pool_name.startswith("rt-gpu-")
    pool = fake.pools[pool_name]
    assert pool["config"]["machineType"] == "a3-highgpu-8g"
    assert pool["config"]["accelerators"] == [{"acceleratorType": "nvidia-h100-80gb",
                                               "acceleratorCount": "8"}]
    inst = mgr.instances[pool_name]
    assert inst.state == im.REQUESTED

    # next pass: fake cloud advances PROVISIONING->RUNNING => ALLOCATED
    scaler._reconcile([head])
    assert inst.state == im.ALLOCATED
    # no second launch while this one is pending registration
    assert len(fake.pools) == 1

    # the node's raylet registers with the instance label => RAY_RUNNING
    gpu_node = _gcs_node(pool_name, busy=True)
    scaler._reconcile([head, gpu_node])
    assert inst.state == im.RAY_RUNNING

    # demand gone, node idle past the timeout => drained
    head_idle = _gcs_node("head")
    head_idle["labels"] = {}
    idle = _gcs_node(pool_name)
    scaler._reconcile([head_idle, idle])
    time.sleep(0.25)
    scaler._reconcile([head_idle, idle])
    assert inst.state in (im.RAY_STOPPING, im.TERMINATING)
    # cloud completes the delete => TERMINATED, pool gone
    scaler._reconcile([head_idle])
    scaler._reconcile([head_idle])
    assert inst.state == im.TERMINATED
    assert fake.pools == {}
    assert [e["action"] for e in scaler.events] == ["up", "down"]
    assert mgr.summary() == {im.TERMINATED: 1}


def test_allocation_failure_recorded():
    def broken(method, path, body=None):
        if method == "POST":
            raise RuntimeError("quota exceeded")
        return {"nodePools": []}

    mgr = InstanceManager(GKEGPUNodeProvider("proj", "us-central1-a", "c", transport=broken))
    with pytest.raises(RuntimeError):
        mgr.create_node(None)
    (inst,) = mgr.instances.values()
    assert inst.state == im.ALLOCATION_FAILED
    assert "quota" in inst.error


def test_unknown_node_type_rejected():
    with pytest.raises(ValueError):
        GKEGPUNodeProvider("p", "l", "c", node_type="v5litepod-16")


def test_provider_ignores_foreign_pools():
    fake = FakeGKE()
    fake.pools["user-pool"] = {"name": "user-pool", "status": "RUNNING"}
    prov = GKEGPUNodeProvider("p", "l", "c", transport=fake)
    assert prov.non_terminated_nodes() == []
    name = prov.create_node(None)
    assert sorted(prov.non_terminated_nodes()) == [name]
    prov.terminate_node(name)
    # terminating never touches pools it does not own
    assert "user-pool" in fake.pools and fake.pools["user-pool"]["status"] == "RUNNING"


@pytest.mark.parametrize("node_type, machine, accelerator, cards", [
    ("h100-80gb-1", "a3-highgpu-1g", "nvidia-h100-80gb", 1),
    ("h100-80gb-8", "a3-highgpu-8g", "nvidia-h100-80gb", 8),
    ("h100-mega-80gb-8", "a3-megagpu-8g", "nvidia-h100-mega-80gb", 8),
    ("a100-80gb-1", "a2-ultragpu-1g", "nvidia-a100-80gb", 1),
    ("a100-40gb-1", "a2-highgpu-1g", "nvidia-tesla-a100", 1),
    ("l4-1", "g2-standard-8", "nvidia-l4", 1)])
def test_gpu_node_types_are_gke_machine_types(node_type, machine, accelerator, cards):
    assert gke.GPU_NODE_TYPES[node_type] == (machine, accelerator, cards)
    fake = FakeGKE()
    name = GKEGPUNodeProvider("p", "l", "c", node_type=node_type,
                              transport=fake).create_node(None)
    assert fake.pools[name]["config"]["accelerators"] == [
        {"acceleratorType": accelerator, "acceleratorCount": str(cards)}]


# ------------------------------------------------- parity with JAX's reconciler
class RecordingProvider:
    """Instances ``n1, n2, ...`` that exist from their create; a GCS row
    belongs to one through its ``instance`` label."""

    def __init__(self):
        self.live: list[str] = []
        self.calls: list[tuple[str, str]] = []
        self._n = 0

    def create_node(self, resources=None):
        self._n += 1
        name = f"n{self._n}"
        self.live.append(name)
        self.calls.append(("create", name))
        return name

    def terminate_node(self, name):
        self.calls.append(("terminate", name))
        if name in self.live:
            self.live.remove(name)

    def non_terminated_nodes(self):
        return list(self.live)

    def matches(self, name, gcs_node):
        return (gcs_node.get("labels") or {}).get("instance") == name


def _view(name, queued=0, busy=False):
    row = _gcs_node(name, queued, busy)
    row["node_id"] = f"id-{name}"  # a plain string id (no hex method)
    if name == "head":
        row["labels"] = {}
    return row


# (clock seconds, the alive rows the GCS returns): demand, a launch, a
# pending registration, a second launch, one node never registering
# (reclaimed past pending_timeout_s), busy then idle nodes, a drain
SCRIPT = [
    (0.0, [("head", 3, True)]),
    (0.6, [("head", 3, True)]),
    (1.2, [("head", 3, True)]),
    (2.0, [("head", 2, True), ("n1", 0, True)]),
    (2.5, [("head", 2, True), ("n1", 1, True)]),
    (3.8, [("head", 2, True), ("n1", 1, True)]),
    (4.5, [("head", 0, True), ("n1", 0, True)]),
    (9.0, [("head", 0, False), ("n1", 0, False)]),
    (16.0, [("head", 0, False), ("n1", 0, False)]),
    (20.0, [("head", 0, False), ("n1", 0, False)]),
    (25.0, [("head", 0, False)]),
    (26.0, [("head", 4, True)]),
    (28.0, [("head", 4, True)]),
    (29.0, [("head", 4, True), ("n3", 0, False)]),
    (40.0, [("head", 0, False), ("n3", 0, False)]),
    (41.0, [("head", 0, False)]),
]


def _run_script(autoscaler_mod, instance_manager_mod) -> tuple[list, dict, dict, list]:
    clock = [0.0]
    fake_time = types.SimpleNamespace(monotonic=lambda: clock[0], time=lambda: 1e9 + clock[0])
    saved = autoscaler_mod.time, instance_manager_mod.time
    autoscaler_mod.time = instance_manager_mod.time = fake_time
    try:
        mgr = instance_manager_mod.InstanceManager(RecordingProvider())
        scaler = autoscaler_mod.Autoscaler(("127.0.0.1", 0), mgr, autoscaler_mod.AutoscalerConfig(
            min_nodes=1, max_nodes=3, upscale_delay_s=1.0, idle_timeout_s=5.0,
            pending_timeout_s=8.0))
        for t, rows in SCRIPT:
            clock[0] = t
            scaler._reconcile([_view(*r) for r in rows])
        events = [(e["action"], e["node"], e.get("queued")) for e in scaler.events]
        states = {iid: [(a, b) for _, a, b in inst.transitions]
                  for iid, inst in mgr.instances.items()}
        return events, states, mgr.summary(), mgr.provider.calls
    finally:
        autoscaler_mod.time, instance_manager_mod.time = saved


def test_reconciler_matches_jax():
    from ray_tpu.autoscaler import autoscaler as jax_autoscaler
    from ray_tpu.autoscaler import instance_manager as jax_im

    from ray_tpu_torch.autoscaler import autoscaler as torch_autoscaler

    ours = _run_script(torch_autoscaler, im)
    theirs = _run_script(jax_autoscaler, jax_im)
    assert ours == theirs
    events, states, summary, calls = ours
    # the script reaches every decision: two launches, a reclaim, a drain
    assert [a for a, _, _ in events] == ["up", "up", "reclaim", "down", "up", "down"], events
    assert summary == {im.TERMINATED: 3}, (summary, states)


# ------------------------------------------------------------ the parked lease
def test_parked_lease_moves_to_a_node_that_joins():
    """A card lease on a card-less head parks; when a node with a card
    joins, the head answers it with that node's spillback reply. A
    feasible-but-busy CPU lease and a ``no_spill`` card lease stay parked.
    (Before the fix the card lease waited on the head for good.)"""
    import asyncio

    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.utils import rpc

    io = rpc.EventLoopThread()
    cluster = Cluster(io=io)
    leases = []
    try:
        head = cluster.add_node(num_cpus=2.0)

        class Requester:  # a lease requester's connection, as the raylet sees it
            _closed = False

        conn = Requester()

        def lease(resources, **p):
            f = asyncio.run_coroutine_threadsafe(
                head.rpc_lease_worker(conn, {"resources": resources, **p}), io.loop)
            leases.append(f)
            return f

        assert io.run(_call(head._try_allocate, {"CPU": 2.0}, None))  # the head is busy
        card = lease({"GPU": 1.0, "CPU": 1.0})
        pinned = lease({"GPU": 1.0}, no_spill=True)
        busy = lease({"CPU": 1.0})
        _wait(lambda: len(head._lease_waiters) == 3, "three leases parked")
        assert not card.done()
        joined = cluster.add_node(resources={"CPU": 4.0, "GPU": 1.0})
        reply = card.result(timeout=30)
        assert reply == {"granted": False, "spill_to": tuple(joined.server.address)}
        time.sleep(0.3)  # further pushes (heartbeats) move nothing else
        assert not pinned.done() and not busy.done()
        parked = [w[0] for w in head._lease_waiters]
        assert parked == [{"GPU": 1.0}, {"CPU": 1.0}]
    finally:
        for f in leases:
            f.cancel()
        cluster.shutdown()
        io.stop()


async def _call(fn, *args):
    return fn(*args)


def _wait(pred, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out: {what}")
        time.sleep(0.02)


# --------------------------------- tests/test_cluster_tools.py's autoscaler case
def _hold(path, value):
    while not os.path.exists(path):
        time.sleep(0.02)
    return value


def _where(path):
    _hold(path, None)
    return os.environ["RT_NODE_ID"], os.getpid()


@pytest.fixture()
def own_runtime():
    from ray_tpu_torch import config

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    # a finished task's lease goes back after 0.3 s, so the node is idle soon
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=0.3))
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)


@pytest.mark.parametrize("demand", ["cpu_backlog", "card_task"])
def test_autoscaler_scales_up_and_down(own_runtime, demand, tmp_path):
    """Demand-driven scale-up past the head, idle scale-down after: six
    1-CPU tasks on a 2-CPU head, or one num_gpus=1 task on a head with no
    card, which must run on the node the autoscaler started."""
    from ray_tpu_torch.core import api as _api

    rt = own_runtime
    host, port = _api._owned_cluster.gcs_address
    node_res = {"CPU": 2.0} if demand == "cpu_backlog" else {"CPU": 1.0, "GPU": 1.0}
    provider = LocalSubprocessProvider(f"{host}:{port}", node_res)
    # max 2 nodes, as `start --autoscale 1:2`: the head's queued demand
    # reaches the GCS on its next heartbeat (1 s) after the node joins, so
    # with room for a third node the reconciler could launch it meanwhile
    scaler = Autoscaler((host, port), provider, AutoscalerConfig(
        min_nodes=1, max_nodes=2, upscale_delay_s=0.2, idle_timeout_s=1.0,
        poll_interval_s=0.1)).start()
    release = str(tmp_path / "release")
    try:
        if demand == "cpu_backlog":
            hold = rt.remote(max_retries=0)(_hold)
            refs = [hold.remote(release, i) for i in range(6)]
        else:
            refs = [rt.remote(num_gpus=1, max_retries=0)(_where).remote(release)]
        _wait(lambda: len([n for n in rt.nodes() if n["alive"]]) > 1,
              f"no scale-up: events={scaler.events}", timeout=60)
        open(release, "w").close()
        out = rt.get(refs, timeout=60)
        assert [e["action"] for e in scaler.events] == ["up"]
        launched = scaler.events[0]["node"]
        if demand == "cpu_backlog":
            assert out == list(range(6))
        else:
            ((node_hex, task_pid),) = out
            (row,) = [n for n in rt.nodes() if n["node_id"].hex() == node_hex]
            assert provider.matches(launched, row), (row["pid"], launched)
            assert row["resources_total"].get("GPU") == 1.0 and task_pid != os.getpid()
        # idle: back down to the head
        _wait(lambda: any(e["action"] == "down" for e in scaler.events),
              f"no scale-down: events={scaler.events}", timeout=60)
        _wait(lambda: len([n for n in rt.nodes() if n["alive"]]) == 1,
              "the drained node still alive", timeout=30)
        assert provider.non_terminated_nodes() == []
    finally:
        scaler.stop()
        provider.shutdown()


# ------------------------------------------------------------ the CLI
AUTOSCALE_DRIVER = """\
import json, os, sys
import ray_tpu_torch as rt

def where():
    return os.environ["RT_NODE_ID"], os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

rt.init(address=sys.argv[1])
node_hex, pid, visible = rt.get(rt.remote(num_gpus=1)(where).remote(), timeout=90)
rows = [dict(node=n["node_id"].hex(), pid=n["pid"], alive=n["alive"],
             resources=n["resources_total"]) for n in rt.nodes()]
print(json.dumps({"node": node_hex, "task_pid": pid, "visible": visible, "nodes": rows}))
rt.shutdown()
"""


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def test_cli_start_autoscale_runs_a_card_task_and_stop_ends_every_process(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("RT_ADDRESS", "PYTHONPATH")}
    env.update(PYTHONPATH=REPO, TMPDIR=str(tmp_path), CUDA_VISIBLE_DEVICES="0")
    cli = [sys.executable, "-m", "ray_tpu_torch"]
    r = subprocess.run(cli + ["start", "--head", "--num-cpus", "1", "--num-gpus", "0",
                              "--autoscale", "1:2"],
                       env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    line = [ln for ln in r.stdout.splitlines() if "started at" in ln][0]
    assert line.endswith(", autoscaler 1:2")
    address = line.split(" at ")[1].split(",")[0]
    with open(tmp_path / "ray_tpu_torch" / "session.json") as f:
        pids = json.load(f)["pids"]
    assert len(pids) == 3  # the GCS, the head's raylet and the monitor
    stopped = False
    try:
        out = subprocess.run([sys.executable, "-c", AUTOSCALE_DRIVER, address], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        by_node = {n["node"]: n for n in got["nodes"]}
        head = [n for n in got["nodes"] if n["pid"] == pids[1]]
        assert head and "GPU" not in head[0]["resources"]
        ran_on = by_node[got["node"]]
        assert ran_on["pid"] not in pids and ran_on["resources"].get("GPU") == 1.0
        assert got["visible"] == "0"
        scaled_raylet = ran_on["pid"]
        r = subprocess.run(cli + ["stop"], env=env, capture_output=True, text=True, timeout=60)
        stopped = True
        assert r.returncode == 0, r.stderr
        deadline = time.monotonic() + 15
        while any(_alive(p) for p in pids + [scaled_raylet, got["task_pid"]]):
            assert time.monotonic() < deadline, [
                p for p in pids + [scaled_raylet, got["task_pid"]] if _alive(p)]
            time.sleep(0.05)
    finally:
        if not stopped:
            subprocess.run(cli + ["stop"], env=env, capture_output=True, timeout=60)
