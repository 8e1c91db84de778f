"""The port's ``multiprocessing.Pool`` (``ray_tpu_torch.util.multiprocessing``)
on its runtime, on the CPU, against the JAX package's.

- Both Pool cases of ``tests/test_util.py``, translated.
- An initializer that reaches a worker by value: a Pool's task function
  carries its initializer as a default argument, and a function whose
  module the workers cannot import must ship by value even when nothing
  else of that module has been shipped before. The JAX package's
  ``test_multiprocessing_pool_initializer`` fails exactly there when an
  xdist worker runs it before any other case of its module ("No module
  named 'test_util'"); the port's code shipping walks defaults too. The
  case runs in a fresh process, so no earlier test can have shipped the
  module first.
- Parity: one scripted workload (``tests/_torch_multiprocessing_jax.py``:
  map, starmap, apply, the async forms and their callbacks, imap,
  imap_unordered, imap over an unbounded generator, an initializer, a
  task's error, a closed pool) gives the same JSON on both packages, each
  in a process of its own.
"""

import dataclasses
import os
import subprocess
import sys
from itertools import count, islice

import pytest

import _torch_data_jax
import ray_tpu_torch
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

_module_limit, _test_limit = time_limits(module_s=120, test_s=90)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rt():
    from ray_tpu_torch import config

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    # each Pool method's tasks lease workers of their own: idle leases go
    # back after 0.5 s, so the next method never waits on them
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=0.5))
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)


# ------------------------------------------------------ tests/test_util.py
def test_multiprocessing_pool(rt):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=4) as p:
        assert p.map(_double, range(12)) == [2 * i for i in range(12)]
        assert p.starmap(_add2, [(1, 2), (3, 4)]) == [3, 7]
        assert p.apply(_add2, (5, 6)) == 11
        r = p.apply_async(_add2, (1, 1))
        assert r.get(timeout=120) == 2 and r.ready() and r.successful()
        assert sorted(p.imap_unordered(_double, range(6))) == [2 * i for i in range(6)]
        assert list(p.imap(_double, range(5))) == [2 * i for i in range(5)]
        # imap streams: an unbounded generator must yield without being
        # materialized (bounded submission window, not submit-everything)
        assert list(islice(p.imap(_double, count(), chunksize=2), 7)) == \
            [2 * i for i in range(7)]
        with pytest.raises(ValueError):
            next(p.imap(_double, [1, 2, 3], chunksize=0))
    with pytest.raises(ValueError):
        p.map(_double, [1])  # closed


def test_multiprocessing_pool_initializer(rt):
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=2, initializer=_set_marker, initargs=(42,)) as p:
        assert all(v == 42 for v in p.map(_read_marker, range(6)))


def _double(x):
    return 2 * x


def _add2(a, b):
    return a + b


def _set_marker(v):
    import builtins

    builtins._rt_pool_marker = v


def _read_marker(_):
    import builtins

    return getattr(builtins, "_rt_pool_marker", None)


# -------------------------------------------- the initializer ships by value
INIT_MODULE = """\
import builtins


def set_marker(v):
    builtins._rt_fresh_marker = v


def read_marker(_):
    return getattr(builtins, "_rt_fresh_marker", None)
"""

INIT_DRIVER = """\
import sys
sys.path.insert(0, sys.argv[1])  # this process's own module, on no worker's path
import fresh_init_mod
import ray_tpu_torch
from ray_tpu_torch.util.multiprocessing import Pool

ray_tpu_torch.init(num_cpus=2)
with Pool(processes=2, initializer=fresh_init_mod.set_marker, initargs=(5,)) as p:
    print(sorted(set(p.map(fresh_init_mod.read_marker, range(4)))))
ray_tpu_torch.shutdown()
"""


def test_initializer_from_a_module_the_workers_cannot_import(tmp_path):
    (tmp_path / "fresh_init_mod.py").write_text(INIT_MODULE)
    env = {k: v for k, v in os.environ.items() if k not in ("RT_ADDRESS", "PYTHONPATH")}
    env.update(PYTHONPATH=REPO, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", INIT_DRIVER, str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=80)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[5]"


# ------------------------------------------------------------ parity with JAX
def test_pool_workload_matches_jax(tmp_path_factory):
    import concurrent.futures

    packages = ("ray_tpu", "ray_tpu_torch")
    tmp_path_factory.getbasetemp()  # made at its first use, unlocked: before the threads
    with concurrent.futures.ThreadPoolExecutor(len(packages)) as pool:
        runs = [pool.submit(_torch_data_jax.run_once, tmp_path_factory,
                            "_torch_multiprocessing_jax.py", 80, (p,)) for p in packages]
        jax, ours = (r.result() for r in runs)
    assert ours == jax
    assert ours["map"] == [i * i for i in range(20)] and ours["initializer"] == [7]
    assert ours["error"] == [True, True] and ours["closed"] == "Pool not running"
