"""The port's durable workflows (``ray_tpu_torch.workflow``) on its runtime,
on the CPU, against the JAX package's ``ray_tpu.workflow``.

Every case of ``tests/test_workflow.py``, translated: DAG runs, replay of
checkpoints on resume, a crash mid-workflow, resume from storage alone,
parallel branches, and the KV and timer events. JAX's parallel-branches
case asserts a wall-clock bound; in its counterpart here each branch waits
for the others to check in, and the overlap is asserted from the branches'
start and end stamps. Then: ``_assign_ids`` names the
steps of a DAG as JAX's does; a step's tensors (bfloat16 among them)
round-trip through a checkpoint and ``resume`` with their dtype, shape and
values, and a checkpointed CUDA tensor read without CUDA raises; the
storage root and the GCS-KV event namespace are the port's own, never the
JAX package's.

One port runtime serves the module; every test has a storage root of its
own (``RAY_TPU_TORCH_WORKFLOW_STORAGE``).
"""

import dataclasses
import gc
import os
import tempfile
import threading
import time

import pytest
import torch

import ray_tpu.workflow as jwf
import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse
from ray_tpu_torch import workflow
from ray_tpu_torch.utils import serialization
from ray_tpu_torch.workflow import api as wf_api

# a step's worker starts in ~2 s; the event cases wait on timers
_module_limit, _test_limit = time_limits(module_s=300, test_s=120)


@pytest.fixture(autouse=True)
def wf_storage(tmp_path, monkeypatch):
    monkeypatch.setenv(wf_api.STORAGE_ENV, str(tmp_path / "wf"))
    yield str(tmp_path / "wf")


@pytest.fixture(scope="module")
def rt():
    from ray_tpu_torch import config

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers inherit it
    ray_tpu_torch.init(num_cpus=16)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = omp


@pytest.fixture(autouse=True)
def collect():
    yield
    gc.collect()


# ------------------------------------------- tests/test_workflow.py, translated
def test_basic_dag_run(rt):
    @workflow.step
    def add(a, b):
        return a + b

    @workflow.step
    def mul(a, b):
        return a * b

    # (1+2) * (3+4) = 21; the two adds are independent branches
    dag = mul.bind(add.bind(1, 2), add.bind(3, 4))
    assert workflow.run(dag, workflow_id="basic") == 21
    assert workflow.get_status("basic") == "SUCCESSFUL"
    assert workflow.get_output("basic") == 21
    assert "basic" in workflow.list_all()


def test_resume_replays_checkpoints_not_steps(rt, tmp_path):
    """After success, resume() returns the stored output without
    re-executing any step."""
    marker = str(tmp_path / "runs")

    @workflow.step
    def effect(path):
        with open(path, "a") as f:
            f.write("x")
        return 7

    assert workflow.run(effect.bind(marker), workflow_id="replay") == 7
    assert open(marker).read() == "x"
    assert workflow.resume("replay") == 7
    assert open(marker).read() == "x"  # not re-executed


def test_crash_mid_workflow_resumes_from_checkpoint(rt, tmp_path):
    """A step that fails mid-DAG keeps earlier checkpoints; resume executes
    only the remaining steps (the durable-progress property)."""
    count_a = str(tmp_path / "a_runs")
    flag = str(tmp_path / "b_ok")

    @workflow.step
    def expensive(path):
        with open(path, "a") as f:
            f.write("A")
        return 10

    @workflow.step(max_retries=0)
    def flaky(x, flag_path):
        if not os.path.exists(flag_path):
            raise RuntimeError("transient outage")
        return x * 2

    dag = flaky.bind(expensive.bind(count_a), flag)
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="crashy")
    assert workflow.get_status("crashy") == "FAILED"
    assert open(count_a).read() == "A"  # expensive step checkpointed

    open(flag, "w").close()  # outage over
    assert workflow.resume("crashy") == 20
    assert open(count_a).read() == "A"  # NOT re-executed on resume
    assert workflow.get_status("crashy") == "SUCCESSFUL"


def test_resume_from_fresh_process_state(rt, tmp_path):
    """resume() needs only the storage dir: the DAG definition itself is
    reloaded from disk (a restarted driver)."""
    marker = str(tmp_path / "m")

    @workflow.step
    def first(path):
        with open(path, "a") as f:
            f.write("1")
        return 5

    @workflow.step(max_retries=0)
    def second(x, path):
        if not os.path.exists(path + ".go"):
            raise RuntimeError("not yet")
        return x + 100

    dag = second.bind(first.bind(marker), marker)
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="fresh")

    # "new driver": no local python objects, just the workflow id
    open(marker + ".go", "w").close()
    results = workflow.resume_all()
    assert ("fresh", 105) in results
    assert open(marker).read() == "1"


def test_parallel_branches_actually_parallel(rt, tmp_path):
    """Independent branches run at once: refs flow between steps and the
    runtime's dependency resolution does the waiting. Each branch checks
    in and waits (up to 60 s) until all three have, so branches run one
    after another would time out; the stamps then show every branch
    started before any ended, in three processes. No wall-clock bound."""
    @workflow.step
    def slow(tag, rendezvous):
        t0 = time.time()
        open(os.path.join(rendezvous, str(tag)), "w").close()
        deadline = time.monotonic() + 60
        while len(os.listdir(rendezvous)) < 3:
            if time.monotonic() > deadline:
                raise TimeoutError(f"branch {tag} ran alone")
            time.sleep(0.01)
        return tag, os.getpid(), t0, time.time()

    @workflow.step
    def join(a, b, c):
        return [a, b, c]

    rendezvous = str(tmp_path / "rendezvous")
    os.makedirs(rendezvous)
    out = workflow.run(join.bind(*(slow.bind(i, rendezvous) for i in (1, 2, 3))),
                       workflow_id="par")
    assert [tag for tag, *_ in out] == [1, 2, 3]
    starts = [t0 for _, _, t0, _ in out]
    ends = [t1 for *_, t1 in out]
    assert max(starts) < min(ends), f"branches did not overlap: {out}"
    assert len({pid for _, pid, _, _ in out}) == 3  # three workers at once


# --------------------------------------------------------------------- events
def test_wait_for_event_kv(rt):
    """wait_for_event blocks a branch until send_event posts the payload."""
    @workflow.step
    def combine(ev, x):
        return (ev, x)

    @workflow.step
    def fast(v):
        return v * 2

    dag = combine.bind(
        workflow.wait_for_event(workflow.KVEventListener, "go-signal",
                                poll_interval_s=0.05, timeout_s=30),
        fast.bind(21))

    def poke():
        time.sleep(1.0)
        workflow.send_event("go-signal", {"msg": "launch"})

    t = threading.Thread(target=poke, daemon=True)
    t.start()
    out = workflow.run(dag, workflow_id="ev1")
    t.join(timeout=30)
    assert not t.is_alive()
    assert out == ({"msg": "launch"}, 42)
    # the consumed event is checkpointed: resume does NOT re-poll
    assert workflow.resume("ev1") == ({"msg": "launch"}, 42)


def test_stale_event_not_reused_across_runs(rt):
    """Consumed events are deleted once the waiting step checkpoints, so a
    LATER workflow waiting on the same key can't short-circuit on the
    stale payload."""
    @workflow.step
    def ident(v):
        return v

    def poke():
        time.sleep(0.8)
        workflow.send_event("reused-key", "first")

    t = threading.Thread(target=poke, daemon=True)
    t.start()
    out = workflow.run(
        ident.bind(workflow.wait_for_event(
            workflow.KVEventListener, "reused-key",
            poll_interval_s=0.05, timeout_s=30)),
        workflow_id="ev-stale-1")
    t.join(timeout=30)
    assert out == "first"
    # resume still short-circuits from the CHECKPOINT (not the KV entry)
    assert workflow.resume("ev-stale-1") == "first"
    # ...but a NEW workflow on the same key must wait (and here, time out)
    with pytest.raises(Exception):
        workflow.run(
            ident.bind(workflow.wait_for_event(
                workflow.KVEventListener, "reused-key",
                poll_interval_s=0.05, timeout_s=0.6)),
            workflow_id="ev-stale-2")
    assert workflow.get_status("ev-stale-2") == "FAILED"


def test_workflow_scoped_event_delivery(rt):
    """send_event(..., workflow_id=...) addresses one workflow's wait."""
    @workflow.step
    def ident(v):
        return v

    def poke():
        time.sleep(0.8)
        workflow.send_event("scoped-key", "mine", workflow_id="ev-scope-1")

    t = threading.Thread(target=poke, daemon=True)
    t.start()
    out = workflow.run(
        ident.bind(workflow.wait_for_event(
            workflow.KVEventListener, "scoped-key",
            poll_interval_s=0.05, timeout_s=30)),
        workflow_id="ev-scope-1")
    t.join(timeout=30)
    assert out == "mine"


def test_scoped_consumption_leaves_shared_event(rt):
    """A wait satisfied by its scoped key must NOT collaterally delete a
    shared-key payload another workflow is still polling for."""
    @workflow.step
    def ident(v):
        return v

    # both payloads pre-posted: timing-independent
    workflow.send_event("dual-key", "for-someone-else")
    workflow.send_event("dual-key", "mine", workflow_id="ev-dual-1")
    out = workflow.run(
        ident.bind(workflow.wait_for_event(
            workflow.KVEventListener, "dual-key",
            poll_interval_s=0.05, timeout_s=30)),
        workflow_id="ev-dual-1")
    assert out == "mine"
    from ray_tpu_torch.core import api as core_api

    core = core_api.get_core()
    assert core._run_sync(core.gcs.call(
        "kv_exists", {"ns": workflow.KVEventListener.NS, "key": "dual-key"})), (
        "shared-key payload collaterally deleted by a scoped consume")


def test_wait_for_event_timer_and_timeout(rt):
    @workflow.step
    def done(v):
        return v

    out = workflow.run(
        done.bind(workflow.wait_for_event(workflow.TimerListener, 0.2)),
        workflow_id="ev-timer")
    assert out == 0.2

    with pytest.raises(Exception):  # TimeoutError surfaces as task error
        workflow.run(
            done.bind(workflow.wait_for_event(
                workflow.KVEventListener, "never-sent",
                poll_interval_s=0.05, timeout_s=0.5)),
            workflow_id="ev-timeout")
    assert workflow.get_status("ev-timeout") == "FAILED"


# ------------------------------------------------------------ against JAX
def _dags(wf):
    """Step DAGs with shared nodes, repeated names, kwargs and event waits,
    authored with a workflow package (JAX's or the port's)."""
    def f(*a, **k):
        return a, k

    a, b = wf.step(f, name="a"), wf.step(f, name="b")
    shared = a.bind(1)
    return {
        "chain": b.bind(a.bind(a.bind(0))),
        "diamond": b.bind(shared, a.bind(shared), z=shared),
        "kwargs": b.bind(y=a.bind(2), x=b.bind(a.bind(3)), w=4),
        "events": b.bind(wf.wait_for_event(wf.TimerListener, 0.1),
                         wf.wait_for_event(wf.KVEventListener, "k", name="ev")),
        "options": a.options(name="c").bind(a.bind(), b.options(max_retries=2).bind()),
    }


def _ids(node, out=None):
    """Every node's step id, depth first (args, then kwargs by name)."""
    out = [] if out is None else out
    for v in list(node.args) + [node.kwargs[k] for k in sorted(node.kwargs)]:
        if hasattr(v, "step_id"):
            _ids(v, out)
    out.append((node.step.name, node.step_id))
    return out


@pytest.mark.parametrize("name", ["chain", "diamond", "kwargs", "events", "options"])
def test_assign_ids_match_jax(name):
    """The same DAG gets the same step ids in both packages (the ids name
    the checkpoints a resumed run replays)."""
    ours, theirs = _dags(workflow)[name], _dags(jwf)[name]
    wf_api._assign_ids(ours)
    jwf.api._assign_ids(theirs)
    assert _ids(ours) == _ids(theirs)
    assert all(sid is not None for _, sid in _ids(ours))


def test_tensor_results_round_trip_through_checkpoint_and_resume(rt, tmp_path):
    """A step's CPU tensors (bfloat16, float32, int64, a Parameter) are
    checkpointed as the runtime's wire form and come back from storage on
    resume, into the next step and as the workflow's output, with their
    dtype, shape and values."""
    flag = str(tmp_path / "go")

    @workflow.step
    def make():
        g = torch.Generator().manual_seed(0)
        return {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
                "f32": torch.randn(2, 2, 2, generator=g),
                "i64": torch.arange(7).reshape(7, 1),
                "param": torch.nn.Parameter(torch.ones(4))}

    @workflow.step(max_retries=0)
    def check(t, path):
        if not os.path.exists(path):
            raise RuntimeError("not yet")
        return t

    want = make.fn()
    with pytest.raises(Exception):
        workflow.run(check.bind(make.bind(), flag), workflow_id="tensors")
    stored = wf_api._Storage("tensors").load_step("make_1")  # the checkpoint alone
    open(flag, "w").close()
    resumed = workflow.resume("tensors")  # make replays from its checkpoint
    for got in (stored, resumed, workflow.get_output("tensors")):
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].device.type == "cpu"
            assert (got[k].dtype, got[k].shape) == (w.dtype, w.shape), k
            assert torch.equal(got[k].detach(), w.detach()), k
        assert isinstance(got["param"], torch.nn.Parameter)


class _CudaTagged:
    """Pickles as a CUDA tensor would: its bytes, restored on a card."""

    def __init__(self, t):
        self.t = t

    def __reduce__(self):
        _, args = serialization._reduce_tensor(self.t)
        return (serialization._restore_cuda_tensor, args)


def test_cuda_tensor_checkpoint_read_without_cuda_raises(wf_storage):
    """A checkpointed CUDA tensor is kept as host bytes and restored on the
    reader's card; a reader without CUDA raises, never a CPU tensor."""
    assert not torch.cuda.is_available()
    storage = wf_api._Storage("cuda-step")
    storage.save_step("score_1", {"logits": _CudaTagged(torch.arange(6.0).reshape(2, 3))})
    assert storage.has_step("score_1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        storage.load_step("score_1")


def test_storage_and_event_keys_are_the_ports_own(monkeypatch):
    """The port's workflows never share a storage directory or an event
    namespace with the JAX package's: its root lies under the port's temp
    root, and each package reads its own environment variable."""
    for var in (wf_api.STORAGE_ENV, "RAY_TPU_WORKFLOW_STORAGE"):
        monkeypatch.delenv(var, raising=False)
    ours, theirs = wf_api._storage_root(), jwf.api._storage_root()
    assert ours == os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "workflows")
    assert os.path.commonpath([ours, theirs]) not in (ours, theirs)
    assert wf_api.STORAGE_ENV != "RAY_TPU_WORKFLOW_STORAGE"
    monkeypatch.setenv("RAY_TPU_WORKFLOW_STORAGE", "/elsewhere/jax")
    assert wf_api._storage_root() == ours
    monkeypatch.setenv(wf_api.STORAGE_ENV, "/elsewhere/torch")
    assert jwf.api._storage_root() == "/elsewhere/jax"
    assert wf_api._storage_root() == "/elsewhere/torch"
    assert workflow.KVEventListener.NS != jwf.KVEventListener.NS
    # the scoped keys keep JAX's shape, under the port's namespace
    assert workflow.KVEventListener.event_keys("w", "k") == jwf.KVEventListener.event_keys(
        "w", "k")
