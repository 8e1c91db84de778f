"""The port's PPO ``Learner`` group in a 2-rank gloo world on the CPU.

The ranks are fresh interpreters (``tests/_torch_rllib_rank.py``) started
with ``subprocess.Popen`` and meeting through a file store, so the pytest
process joins no group; they are killed after 90 s or on the first
failure. Rank 0 updates on a rollout and rank 1 on an empty shard, which
still joins the sync. After it both hold the mean of their params and Adam
moments, and their Adam step counts stay their own (4 and 0), as JAX's
integer counts do.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import Learner

from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

# slowest test 0.1 s, module set-up 11.3 s (the port's modules alone under -n 6);
# the limits are several times that, so one that fires names a stalled test
_module_limit, _test_limit = time_limits(module_s=120, test_s=60)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(ROOT, "tests", "_torch_rllib_rank.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
from _torch_rllib_rank import learner_state  # noqa: E402

CONFIG = {"obs_dim": 4, "n_actions": 2, "hidden": 16, "lr": 1e-2, "epochs": 2,
          "minibatches": 2, "seed": 3, "device": "cpu", "collective_backend": "gloo"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the default of one
    thread a core spins idle threads that starve the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rollout(T=16, N=2):
    rng = np.random.default_rng(0)
    return {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
            "logp": np.full((T, N), np.log(0.5), np.float32),
            "values": rng.normal(size=(T, N)).astype(np.float32),
            "rewards": np.ones((T, N), np.float32),
            "dones": rng.random((T, N)) < 0.1,
            "last_value": np.zeros(N, np.float32)}


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    work = tmp_path_factory.mktemp("rllib_learners")
    with open(work / "config.json", "w") as f:
        json.dump(CONFIG, f)
    np.savez(work / "rollout.npz", **_rollout())
    env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, HELPER, str(work)], env=dict(env, RANK=str(r)),
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
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
    return [dict(np.load(work / f"out_{r}.npz")) for r in range(2)]


def test_ranks_hold_equal_params_and_moments(outs):
    a, b = outs
    assert int(a["samples"]) == 32 and int(b["samples"]) == 0
    for k in a:
        if k.split("/")[0] in ("param", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sync_is_the_mean_and_steps_stay_local(outs):
    """The synced state is the mean of one local update and the untouched
    initial state (rank 1's empty shard), computed here in one process."""
    idle, moved = Learner(0, 1, CONFIG), Learner(0, 1, CONFIG)
    moved.update([_rollout()])
    want0, want1 = learner_state(idle), learner_state(moved)
    got = outs[0]
    for k in want0:
        kind = k.split("/")[0]
        if kind == "step":
            # 2 epochs x 2 minibatches on rank 0; none on rank 1
            assert float(outs[0][k]) == float(want1[k]) == 4.0, k
            assert float(outs[1][k]) == 0.0, k
        else:
            np.testing.assert_allclose(got[k], (want0[k] + want1[k]) / 2, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
