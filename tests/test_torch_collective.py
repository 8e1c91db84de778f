"""The port's collective API (``ray_tpu_torch.collective``) in a 2-rank
gloo world, against numpy.

The ranks are fresh interpreters (``tests/_torch_collective_rank.py``)
started with ``subprocess.Popen``, and every rank is killed after 90 s or
on the first failure; the pytest process joins no group and binds no port
of its own. They meet through a file store (``init_method``), or through
the GCS KV of a port runtime this module starts, which they join with
``ray_tpu_torch.init(address=...)``: rank 0 publishes a store's address
under ``collective:g_gcs:coordinator`` and rank 1 polls for it, as JAX's ranks
do (``tests/test_collective_distributed.py``). Every ``Communicator`` op
runs on numpy arrays and on tensors, with JAX's semantics
(``ray_tpu/collective``): allgather stacks on a new axis 0, reducescatter
gives this rank's chunk of the reduction, MEAN is a float mean, numpy in
gives numpy out.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(ROOT, "tests", "_torch_collective_rank.py")
WORLD = 2
# each world ~6 s (two interpreters import torch and join)
_module_limit, _test_limit = time_limits(module_s=240, test_s=120)


def _value(rank):
    return np.random.default_rng(rank).standard_normal((4, 3)).astype(np.float32)


def _world(work, **extra_env) -> list:
    """Run the 2-rank world in ``work``; each rank's outputs."""
    env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1",
               **extra_env)
    procs = [subprocess.Popen([sys.executable, HELPER, str(work)], env=dict(env, RANK=str(r)),
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    deadline = time.monotonic() + 90
    try:
        while time.monotonic() < deadline and any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = [p.stdout.read().decode(errors="replace")[-3000:] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    return [dict(np.load(work / f"out_{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("collective_world"))


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    ray_tpu_torch.init(num_cpus=2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module", params=["gcs", "init_method"])
def runtime_outs(request, rt, tmp_path_factory):
    """The world with the runtime up: meeting through its GCS KV (no
    init_method), or through an explicit init_method."""
    host, port = rt.get_core().gcs_address
    work = tmp_path_factory.mktemp(f"collective_{request.param}")
    return request.param, _world(work, RTT_RDZV=request.param,
                                 RTT_TEST_GCS=f"{host}:{port}")


def _expected(rank):
    x0, x1 = _value(0), _value(1)
    stack = np.stack([x0, x1])
    return {
        "allreduce_sum": x0 + x1, "allreduce_product": x0 * x1,
        "allreduce_max": np.maximum(x0, x1), "allreduce_min": np.minimum(x0, x1),
        "allreduce_mean": stack.mean(0),
        "allreduce_int_mean": np.stack([np.arange(4), np.arange(4) + 1]).mean(0),
        "allgather": stack,
        "reducescatter_sum": (x0 + x1)[rank * 2:(rank + 1) * 2],
        "reducescatter_max": np.maximum(x0, x1)[rank * 2:(rank + 1) * 2],
        "broadcast": x1,
        "reduce": x0 + x1 if rank == 0 else x1,
        "recv": np.arange(6).reshape(2, 3) if rank == 0 else x0,
        # XlaCollectiveGroup.sendrecv: dst gets src's value, the others
        # what ppermute leaves (zeros); src == dst keeps each rank's own
        "sendrecv": x1 if rank == 0 else np.zeros_like(x1),
        "sendrecv_self": x0 if rank == 0 else x1,
    }


@pytest.mark.parametrize("form", ["np", "pt"])
def test_every_op_matches_numpy(outs, form):
    for rank, got in enumerate(outs):
        for name, want in _expected(rank).items():
            np.testing.assert_allclose(got[f"{form}/{name}"], want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"rank {rank} {form} {name}")
            assert got[f"{form}/{name}"].shape == want.shape, (rank, form, name)


@pytest.mark.parametrize("form", ["np", "pt"])
def test_results_keep_their_form(outs, form):
    """numpy in gives numpy out and tensors give tensors; what a rank
    receives has the sender's form; a MEAN of ints is float."""
    for rank, got in enumerate(outs):
        for name in _expected(rank):
            assert bool(got[f"{form}/{name}/is_tensor"]) == (form == "pt"), (rank, form, name)
        assert got[f"{form}/allreduce_int_mean"].dtype.kind == "f"
        assert got[f"{form}/recv"].dtype == (np.int64 if rank == 0 else np.float32)


def test_types_mirror_jax():
    from ray_tpu.collective.types import ReduceOp as JReduceOp

    from ray_tpu_torch.collective import Backend, ReduceOp

    assert [(o.name, o.value) for o in ReduceOp] == [(o.name, o.value) for o in JReduceOp]
    assert (Backend.NCCL, Backend.GLOO) == ("nccl", "gloo")


def test_module_api_matches_jax():
    """The same public names and signatures as ray_tpu.collective,
    create_collective_group (over the port's actors) among them."""
    import inspect

    import ray_tpu.collective as jc

    import ray_tpu_torch.collective as tc

    names = [n for n in dir(jc) if not n.startswith("_") and callable(getattr(jc, n))
             and n != "ReduceOp"]
    for n in names:
        want = inspect.signature(getattr(jc, n)).parameters
        got = inspect.signature(getattr(tc, n)).parameters
        # the same parameters in order (init_collective_group adds init_method)
        assert list(got)[:len(want)] == list(want), n
    assert "create_collective_group" in names
    with pytest.raises(ValueError, match="not initialized"):
        tc.allreduce(np.zeros(2), group_name="nobody")


def test_sendrecv_needs_two_ranks():
    """XlaCollectiveGroup.sendrecv's contract at world size 1: src == dst
    gives the value back, any other pair raises RuntimeError (checked
    before any process group is touched, so no group is joined here)."""
    import torch

    from ray_tpu_torch.collective.torch_group import TorchCollectiveGroup

    group = object.__new__(TorchCollectiveGroup)
    group._world_size, group._rank = 1, 0
    x = np.arange(3.0)
    np.testing.assert_array_equal(group.sendrecv(x, 0, 0), x)
    t = torch.arange(3.0)
    assert group.sendrecv(t, 0, 0) is t
    with pytest.raises(RuntimeError, match="world_size > 1"):
        group.sendrecv(x, 0, 1)


def test_gcs_rendezvous_runs_every_op(runtime_outs):
    """Through the GCS KV, or an explicit init_method with the runtime up:
    every op gives numpy's result (allreduce, allgather, broadcast and
    reducescatter among them, JAX's distributed assertions). Only the GCS
    rendezvous starts the world on rank 0's TCPStore (the explicit
    init_method wins, with its FileStore), and its key is gone once the
    ranks have met, so a later group of the name cannot read it."""
    mode, got = runtime_outs
    for rank, out in enumerate(got):
        for form in ("np", "pt"):
            for name, want in _expected(rank).items():
                np.testing.assert_allclose(out[f"{form}/{name}"], want, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{mode} rank {rank} {form} {name}")
        assert float(out["rendezvous_s"]) >= 0
    stores = {str(out["store"]) for out in got}
    assert stores == ({"TCPStore"} if mode == "gcs" else {"FileStore"})
    assert {str(out["gcs_key"]) for out in got} == {""}


def test_rank_times_out_without_coordinator(rt):
    """A rank whose rank 0 never publishes polls the GCS KV for the given
    time and raises TimeoutError (no store is bound, no group started)."""
    import time

    import torch.distributed as dist

    from ray_tpu_torch.collective.torch_group import maybe_init_distributed

    core = rt.get_core()
    calls = []

    def gcs_call(method, payload):
        calls.append((method, payload["ns"], payload["key"]))
        return core._run_sync(core.gcs.call(method, payload))

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="never appeared"):
        maybe_init_distributed(gcs_call, "nobody_publishes", 2, 1, "gloo",
                               core.raylet_address[0], timeout_s=0.5)
    assert 0.5 <= time.monotonic() - t0 < 5
    assert not dist.is_initialized()
    assert len(calls) >= 3  # polled every 0.1 s
    assert set(calls) == {("kv_get", "collective", "collective:nobody_publishes:coordinator")}


def test_coordinator_key_goes_when_a_rank_never_joins(rt, tmp_path):
    """Rank 0 of a world of 2 whose rank 1 never connects: its wait fails
    after the timeout, it raises, and its coordinator key is gone from the
    GCS KV all the same. Rank 0 binds a store, so it runs in a process of
    its own, attached to this module's runtime."""
    from ray_tpu_torch.collective.torch_group import COORDINATOR_NS, coordinator_key

    host, port = rt.get_core().gcs_address
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch.collective.torch_group import maybe_init_distributed\n"
        f"ray_tpu_torch.init(address='{host}:{port}')\n"
        "core = ray_tpu_torch.get_core()\n"
        "gcs = lambda m, p: core._run_sync(core.gcs.call(m, p))\n"
        "t0 = time.monotonic()\n"
        "try:\n"
        "    maybe_init_distributed(gcs, 'rank1_never_joins', 2, 0, 'gloo',\n"
        "                           core.raylet_address[0], timeout_s=1.0)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, round(time.monotonic() - t0, 1), flush=True)\n"
        "ray_tpu_torch.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=90, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "raised" in out.stdout, (out.stdout, out.stderr[-3000:])
    core = rt.get_core()
    left = core._run_sync(core.gcs.call("kv_get", {
        "ns": COORDINATOR_NS, "key": coordinator_key("rank1_never_joins")}))
    assert not left, left
