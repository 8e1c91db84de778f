"""The port's remote-driver client (``ray_tpu_torch.client``), on the CPU.

Every case of ``tests/test_client_mode.py``, translated: a driver with no
access to the cluster's shm arena (``connect`` = ``init(...,
_client_mode=True)``) runs tasks and actors, moves large objects both ways
(owner-served puts, results through the raylet's chunked transfer RPCs)
and sees errors and ``wait``. The cluster is a real subprocess GCS and
raylet (``init(_in_process=False)``); the three client drivers run at once,
each a fresh interpreter, and each test reads its own. Also: the module's
exports equal JAX's ``ray_tpu.client``.
"""

import dataclasses
import subprocess
import sys
import textwrap

import pytest

import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

_module_limit, _test_limit = time_limits(module_s=180, test_s=120)

_BODIES = {
    "tasks_and_actors": """
        import ray_tpu_torch

        @ray_tpu_torch.remote
        def add(a, b):
            return a + b

        assert ray_tpu_torch.get([add.remote(i, i) for i in range(20)], timeout=120) \\
            == [2 * i for i in range(20)]

        @ray_tpu_torch.remote
        class Counter:
            def __init__(self):
                self.n = 0
            def inc(self):
                self.n += 1
                return self.n

        c = Counter.remote()
        assert ray_tpu_torch.get([c.inc.remote() for _ in range(10)], timeout=120)[-1] == 10
    """,
    # large put (owner-served to workers) + large task result (fetched
    # through the raylet's chunked transfer RPCs): both sides of the no-shm path
    "large_objects": """
        import numpy as np
        import ray_tpu_torch

        core = ray_tpu_torch.core.api.get_core()
        assert core.store is None, "client mode must not attach shm"

        big = np.arange(500_000, dtype=np.int64)  # ~4 MB: above the inline cutoff
        ref = ray_tpu_torch.put(big)

        @ray_tpu_torch.remote
        def total(x):
            return int(x.sum())

        assert ray_tpu_torch.get(total.remote(ref), timeout=120) == int(big.sum())

        @ray_tpu_torch.remote
        def make_big(n):
            import numpy as np
            return np.ones(n, dtype=np.float32)

        out = ray_tpu_torch.get(make_big.remote(1_000_000), timeout=120)  # ~4 MB back
        assert out.shape == (1_000_000,) and float(out[123]) == 1.0
    """,
    "wait_and_errors": """
        import ray_tpu_torch

        @ray_tpu_torch.remote
        def boom():
            raise ValueError("client-visible failure")

        try:
            ray_tpu_torch.get(boom.remote(), timeout=120)
            raise SystemExit("error did not propagate")
        except Exception as e:
            assert "client-visible failure" in str(e)

        @ray_tpu_torch.remote
        def quick(i):
            return i

        refs = [quick.remote(i) for i in range(8)]
        done, pending = ray_tpu_torch.wait(refs, num_returns=8, timeout=120)
        assert len(done) == 8 and not pending
    """,
}


@pytest.fixture(scope="module")
def cluster():
    """A real subprocess cluster (head GCS + raylet), driver detached."""
    from ray_tpu_torch import config

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    # idle leases go back after 1 s (the daemons get the config): an
    # actor after a burst of tasks waits for their workers' CPUs
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    ray_tpu_torch.init(_in_process=False, num_cpus=8)
    host, port = ray_tpu_torch.get_runtime_context().gcs_address
    yield f"{host}:{port}"
    ray_tpu_torch.shutdown()
    config.set_config(cfg)


def _client_code(address: str, body: str) -> str:
    return textwrap.dedent(f"""
        import ray_tpu_torch.client
        ctx = ray_tpu_torch.client.connect({address!r})
        {textwrap.indent(textwrap.dedent(body), "        ").strip()}
        ctx.disconnect()
        print("CLIENT-OK")
    """)


@pytest.fixture(scope="module")
def clients(cluster):
    """Every case's client driver, started at once; {case: Popen}."""
    procs = {case: subprocess.Popen([sys.executable, "-c", _client_code(cluster, body)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for case, body in _BODIES.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _result(clients, case):
    out, err = clients[case].communicate(timeout=100)
    return clients[case].returncode, out, err


@pytest.mark.parametrize("case", list(_BODIES))
def test_client_driver(clients, case):
    rc, out, err = _result(clients, case)
    assert rc == 0 and "CLIENT-OK" in out, (out, err)


def test_client_exports_match_jax():
    import ray_tpu.client as jclient

    import ray_tpu_torch.client as client

    public = {n for n in vars(jclient) if not n.startswith("_")}
    assert public == {n for n in vars(client) if not n.startswith("_")}
    assert client.ClientContext.__enter__ and client.connect.__doc__
