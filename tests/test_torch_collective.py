"""The port's collective API (``ray_tpu_torch.collective``) in a 2-rank
gloo world, against numpy.

The ranks are fresh interpreters (``tests/_torch_collective_rank.py``)
started with ``subprocess.Popen``; they meet through a file store, so the
pytest process joins no group and binds no port, and every rank is killed
after 90 s or on the first failure. Every ``Communicator`` op runs on numpy
arrays and on tensors, with JAX's semantics (``ray_tpu/collective``):
allgather stacks on a new axis 0, reducescatter gives this rank's chunk of
the reduction, MEAN is a float mean, numpy in gives numpy out.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(ROOT, "tests", "_torch_collective_rank.py")
WORLD = 2


def _value(rank):
    return np.random.default_rng(rank).standard_normal((4, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    work = tmp_path_factory.mktemp("collective_world")
    env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1")
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
