"""The JAX package's rows for the seeded and barrier pipelines of
``tests/test_torch_data.py``. Not a test module.

    python tests/_torch_data_jax.py <out.json>

Runs each case of ``pipelines(data)`` on ``ray_tpu.data`` over a fresh
``ray_tpu`` runtime in this process and writes ``{case: rows}`` (rows made
JSON-safe by ``plain``). The test runs the same cases on
``ray_tpu_torch.data`` and compares the rows exactly; the two runtimes
never share a process (``run_once`` starts this script once a session).
"""
import faulthandler
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plain(v):
    """A row value as JSON: numpy scalars and arrays as Python ones."""
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return plain(v.tolist())
    if isinstance(v, np.generic):
        return plain(v.item())
    if isinstance(v, float) and v != v:
        return "nan"
    return v


def pipelines(data):
    """{case: a function giving the case's rows} over a data package (JAX's
    or the port's): every seeded permutation and sample, and the barrier
    ops whose row order the package decides."""
    def shuffled(n, parallelism, seed):
        return lambda: data.range(n, parallelism=parallelism).random_shuffle(seed=seed).take_all()

    def sample_blocks():
        from_blocks = data.range(400, parallelism=4).random_sample(0.5, seed=3)
        return [data.BlockAccessor.for_block(b).to_batch("numpy")["id"].tolist()
                for b in from_blocks.iter_blocks()]

    def split_batches():
        """Each consumer's batches of 16 from a 2-way streaming_split of a
        from_numpy dataset of 5 blocks (a [100, 2] column and a flat one)."""
        ds = data.from_numpy({"x": np.arange(200).reshape(100, 2), "y": np.arange(100.0)},
                             parallelism=5)
        return [list(it.iter_batches(batch_size=16)) for it in ds.streaming_split(2)]

    def filtered_blocks():
        """A filter that empties the first blocks, then a map over them."""
        ds = data.range(100, parallelism=4).filter(lambda r: r["id"] >= 60)
        ds = ds.map_batches(lambda b: {"id": b["id"], "n": np.full(len(b["id"]), len(b["id"]))})
        return [data.BlockAccessor.for_block(b).num_rows() for b in ds.iter_blocks()], \
            ds.take_all()

    rows = [{"g": (i * 7) % 13, "v": float(i * i % 17), "k": i % 5} for i in range(120)]
    return {
        "split_batches": split_batches,
        "filtered_blocks": filtered_blocks,
        "iter_batches_leftover": lambda: list(data.range(250, parallelism=3).iter_batches(
            batch_size=64)),
        "shuffle_simple_7": shuffled(200, -1, 7),
        "shuffle_simple_8": shuffled(200, -1, 8),
        "shuffle_blocks_7": shuffled(300, 6, 7),
        "shuffle_push_7": shuffled(2000, 16, 7),
        "shuffle_push_11": shuffled(1000, 24, 11),
        "sample_025_1": lambda: data.range(2000).random_sample(0.25, seed=1).take_all(),
        "sample_blocks_05_3": sample_blocks,
        "sort_k": lambda: data.from_items(rows, parallelism=4).sort("k").take_all(),
        "sort_desc_v": lambda: data.from_items(rows, parallelism=3).sort(
            "v", descending=True).take_all(),
        "groupby_multi": lambda: data.from_items(rows, parallelism=6).groupby("g").aggregate(
            data.AggregateFn(lambda: 0, lambda s, r: s + 1, lambda a, b: a + b, name="n"),
            data.AggregateFn(lambda: 0.0, lambda s, r: s + r["v"], lambda a, b: a + b,
                             name="total")).take_all(),
        "groupby_std": lambda: data.from_items(rows, parallelism=6).groupby("g").std(
            "v").take_all(),
        "join_outer": lambda: data.from_items(rows[:40], parallelism=3).join(
            data.from_items([{"k": i, "w": i * 10} for i in range(3, 8)]), on="k",
            how="outer", num_partitions=3).take_all(),
        "zip": lambda: data.from_items([{"x": i} for i in range(10)], parallelism=2).zip(
            data.from_items([{"x": -i} for i in range(10)], parallelism=3)).take_all(),
        "unique": lambda: data.from_items(rows, parallelism=4).unique("g"),
        "repartition": lambda: [data.BlockAccessor.for_block(b).num_rows() for b in
                                data.range(100, parallelism=7).repartition(3).iter_blocks()],
    }


def run_once(tmp_path_factory, script: str, timeout: float, args: tuple = ()):
    """The JSON that ``tests/<script> <out.json> [args]`` writes, from one
    run per test session and ``args``: xdist workers share it through a
    lock in the session's temp directory, so each JAX runtime starts once.
    Fails the caller with the script's output if it failed."""
    import fcntl
    import subprocess

    import pytest

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):  # the session's dir, shared by the workers
        base = base.parent
    work = base / "_".join(["jax", os.path.splitext(script)[0].strip("_"), *args])
    work.mkdir(exist_ok=True)
    with open(work / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        status = work / "status.json"
        if not status.exists():
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
            try:
                proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", script),
                                       str(work / "out.json"), *args], cwd=ROOT, env=env,
                                      capture_output=True, text=True, timeout=timeout)
                report = {"ok": proc.returncode == 0,
                          "log": proc.stdout[-3000:] + proc.stderr[-3000:]}
            except subprocess.TimeoutExpired as e:
                report = {"ok": False, "log": f"timed out after {timeout} s: {e}"}
            status.write_text(json.dumps(report))
        report = json.loads(status.read_text())
    if not report["ok"]:
        pytest.fail(f"{script} failed:\n{report['log']}")
    with open(work / "out.json") as f:
        return json.load(f)


def main() -> int:
    faulthandler.dump_traceback_later(240, exit=True)
    sys.path.insert(0, ROOT)
    import dataclasses

    import ray_tpu
    import ray_tpu.data as data
    from ray_tpu import config

    # idle leases go back after 1 s, not 10: tasks of other functions
    # would queue behind them on a few CPUs
    config.set_config(dataclasses.replace(config.get_config(), worker_lease_timeout_s=1.0))
    ray_tpu.init(num_cpus=8)
    try:
        out = {name: plain(fn()) for name, fn in pipelines(data).items()}
    finally:
        ray_tpu.shutdown()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
