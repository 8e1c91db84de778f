"""ray_tpu_torch.data against ray_tpu.data, on the CPU.

Every case of ``tests/test_data.py``, translated: the streaming executor,
transforms, iteration, the reads and writes, the optimizer, and
streaming_split feeding a 2-worker gloo TorchTrainer. Then the port's
outputs against the JAX package's for the same inputs: per-block functions
(BlockAccessor, the shuffle's split and merge, the partial aggregates,
optimizer rewrites and ``explain``) directly, since JAX's modules import
without its runtime; the seeded pipelines (shuffles, samples) and the
barrier ops, end to end, against ``tests/_torch_data_jax.py`` run on a JAX
runtime in a subprocess, and again from a process whose pyarrow and
pandas are hidden (``tests/_torch_data_noarrow.py``: numpy-dict blocks, as
on the card's host). Rows are compared exactly.

One port runtime serves the module (``ray_tpu_torch.init``); idle leases go
back after 1 s.
"""

import dataclasses
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import _torch_data_jax
import _torch_train_loops as loops
import ray_tpu.data as jd
import ray_tpu.data.executor as jex
import ray_tpu.data.optimizer as jopt
import ray_tpu_torch.data as rtd
import ray_tpu_torch.data.dataset as tds
import ray_tpu_torch.data.executor as tex
import ray_tpu_torch.data.optimizer as topt
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX rows' subprocess ~30 s alone, the trainer case ~15 s
_module_limit, _test_limit = time_limits(module_s=300, test_s=120)


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch
    from ray_tpu_torch import config

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    # idle leases go back after 1 s, not 10: each op's functions lease
    # workers of their own, and 8 CPUs held idle would make the next wait
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """{case: rows} of ``_torch_data_jax.pipelines`` on ray_tpu.data, from
    a subprocess with a JAX runtime of its own (one a session)."""
    return _torch_data_jax.run_once(tmp_path_factory, "_torch_data_jax.py", timeout=240)


# ------------------------------------------------- tests/test_data.py, translated
def test_range_count_take(rt):
    ds = rtd.range(1000)
    assert ds.count() == 1000
    rows = ds.take(5)
    assert [r["id"] for r in rows] == [0, 1, 2, 3, 4]


def test_from_items_map_filter(rt):
    ds = rtd.from_items(list(range(100)))
    out = ds.map(lambda x: x * 2).filter(lambda x: x % 10 == 0).take_all()
    assert out == [x * 2 for x in range(100) if (x * 2) % 10 == 0]


def test_map_batches_numpy_format(rt):
    ds = rtd.range(100).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2}, batch_format="numpy"
    )
    rows = ds.take_all()
    assert all(r["sq"] == r["id"] ** 2 for r in rows)


def test_map_batches_pandas_and_pyarrow(rt):
    ds = rtd.range(50).map_batches(
        lambda df: df.assign(neg=-df["id"]), batch_format="pandas"
    )
    assert ds.take(3)[2]["neg"] == -2

    ds2 = rtd.range(50).map_batches(lambda t: t, batch_format="pyarrow")
    assert ds2.count() == 50


def test_flat_map_and_limit(rt):
    ds = rtd.from_items([1, 2, 3]).flat_map(lambda x: [x] * x)
    assert ds.take_all() == [1, 2, 2, 3, 3, 3]
    assert rtd.range(1000).limit(17).count() == 17


def test_repartition(rt):
    ds = rtd.range(100, parallelism=7).repartition(3)
    blocks = list(ds.iter_blocks())
    assert len(blocks) == 3
    sizes = [len(b["id"]) for b in blocks]
    assert sum(sizes) == 100
    assert max(sizes) - min(sizes) <= 1
    all_ids = np.concatenate([b["id"] for b in blocks])
    np.testing.assert_array_equal(all_ids, np.arange(100))


def test_random_shuffle_deterministic(rt):
    a = rtd.range(200).random_shuffle(seed=7).take_all()
    b = rtd.range(200).random_shuffle(seed=7).take_all()
    c = rtd.range(200).random_shuffle(seed=8).take_all()
    ids = lambda rows: [r["id"] for r in rows]  # noqa: E731
    assert ids(a) == ids(b)
    assert ids(a) != ids(c)
    assert sorted(ids(a)) == list(range(200))


def test_sort(rt):
    ds = rtd.from_items([{"k": x % 5, "v": x} for x in range(50)]).sort("k")
    ks = [r["k"] for r in ds.take_all()]
    assert ks == sorted(ks)
    desc = rtd.range(20).sort("id", descending=True).take(3)
    assert [r["id"] for r in desc] == [19, 18, 17]


def test_aggregates(rt):
    ds = rtd.range(101)
    assert ds.sum("id") == 5050
    assert ds.min("id") == 0
    assert ds.max("id") == 100
    assert ds.mean("id") == 50.0


def test_iter_batches_sizes_and_leftover(rt):
    batches = list(rtd.range(250).iter_batches(batch_size=64))
    assert [len(b["id"]) for b in batches] == [64, 64, 64, 58]
    batches = list(rtd.range(250).iter_batches(batch_size=64, drop_last=True))
    assert [len(b["id"]) for b in batches] == [64, 64, 64]


def test_iter_torch_batches(rt):
    import torch

    batch = next(iter(rtd.range(64).iter_torch_batches(batch_size=32)))
    assert isinstance(batch["id"], torch.Tensor)
    assert batch["id"].shape == (32,)
    assert batch["id"].device.type == "cpu"


def test_read_csv_json_text(rt, tmp_path):
    pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]}).to_csv(
        tmp_path / "f.csv", index=False
    )
    ds = rtd.read_csv(str(tmp_path / "f.csv"))
    assert ds.count() == 3
    assert ds.take(1)[0]["a"] == 1

    with open(tmp_path / "f.jsonl", "w") as f:
        f.write('{"x": 1}\n{"x": 2}\n')
    assert rtd.read_json(str(tmp_path / "f.jsonl")).sum("x") == 3

    with open(tmp_path / "t.txt", "w") as f:
        f.write("hello\nworld\n")
    assert [r["text"] for r in rtd.read_text(str(tmp_path / "t.txt")).take_all()] == [
        "hello", "world",
    ]


def test_read_parquet_roundtrip(rt, tmp_path):
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"v": list(range(10))}), tmp_path / "p.parquet")
    ds = rtd.read_parquet(str(tmp_path / "p.parquet"))
    assert ds.sum("v") == 45


def test_streaming_split_two_consumers(rt):
    splits = rtd.range(400, parallelism=8).streaming_split(2)
    seen = [[], []]
    for i, it in enumerate(splits):
        for batch in it.iter_batches(batch_size=50):
            seen[i].extend(batch["id"].tolist())
    assert len(seen[0]) + len(seen[1]) == 400
    assert sorted(seen[0] + seen[1]) == list(range(400))
    assert seen[0] and seen[1]  # both consumers got data


def test_streaming_split_feeds_torch_trainer(rt, tmp_path, monkeypatch):
    """Dataset -> streaming_split -> 2 data-parallel TorchTrainer workers
    (gloo), whose iterators travel in train_loop_config and whose group
    meets through the GCS KV."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "ATTEMPT_TIMEOUT_S", 90.0)
    X = np.random.RandomState(0).randn(256, 4).astype(np.float32)
    true_w = np.array([1.0, -2.0, 3.0, 0.5], dtype=np.float32)
    y = X @ true_w
    ds = rtd.from_numpy({"x": X, "y": y}, parallelism=4)
    splits = ds.streaming_split(2)
    trainer = TorchTrainer(
        loops.split_linear_loop,
        train_loop_config={"splits": splits, "eval": (X, y)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False, collective_backend="gloo"),
        run_config=RunConfig(storage_path=str(tmp_path / "ck")),
    )
    result = trainer.fit()
    assert result.error is None, result.error
    assert result.metrics["rows"] > 0
    assert result.metrics["loss"] < 8.0  # w=0 baseline ~15
    ranks = {m["world_rank"]: m for m in result.metrics_history}
    assert sum(m["rows"] for m in ranks.values()) == 256  # 4 blocks of 64, 2 each
    assert all(m["rendezvous_s"] is not None for m in ranks.values())


def test_groupby_aggregations(rt):
    ds = rtd.from_items([{"g": i % 3, "v": float(i)} for i in range(12)])
    counts = {r["g"]: r["count()"] for r in ds.groupby("g").count().take_all()}
    assert counts == {0: 4, 1: 4, 2: 4}
    sums = {r["g"]: r["sum(v)"] for r in ds.groupby("g").sum("v").take_all()}
    assert sums == {0: 0 + 3 + 6 + 9, 1: 1 + 4 + 7 + 10, 2: 2 + 5 + 8 + 11}
    means = {r["g"]: r["mean(v)"] for r in ds.groupby("g").mean("v").take_all()}
    assert means[0] == (0 + 3 + 6 + 9) / 4
    mins = {r["g"]: r["min(v)"] for r in ds.groupby("g").min("v").take_all()}
    assert mins == {0: 0.0, 1: 1.0, 2: 2.0}


def test_groupby_map_groups(rt):
    # parallelism=4 -> multi-block: exercises the hash-sharded (P>1) path
    ds = rtd.from_items([{"g": i % 2, "v": i} for i in range(8)], parallelism=4)

    def summarize(rows):
        return [{"g": rows[0]["g"], "n": len(rows),
                 "total": sum(r["v"] for r in rows)}]

    out = {r["g"]: r for r in ds.groupby("g").map_groups(summarize).take_all()}
    assert out[0] == {"g": 0, "n": 4, "total": 0 + 2 + 4 + 6}
    assert out[1] == {"g": 1, "n": 4, "total": 1 + 3 + 5 + 7}


def test_write_read_roundtrip(rt, tmp_path):
    ds = rtd.from_items([{"a": i, "b": f"s{i}"} for i in range(10)])
    pq_dir = str(tmp_path / "pq")
    files = ds.write_parquet(pq_dir)
    assert files and all(f.endswith(".parquet") for f in files)
    back = rtd.read_parquet(pq_dir + "/part-*.parquet")
    assert sorted(r["a"] for r in back.take_all()) == list(range(10))

    csv_dir = str(tmp_path / "csv")
    ds.write_csv(csv_dir)
    back_csv = rtd.read_csv(csv_dir + "/part-*.csv")
    assert sorted(r["a"] for r in back_csv.take_all()) == list(range(10))


def test_actor_pool_map_batches(rt):
    """compute=ActorPoolStrategy: a callable CLASS constructs once per
    actor and its state amortizes across blocks."""
    from ray_tpu_torch.data import ActorPoolStrategy

    class AddConst:
        def __init__(self, c):
            import os

            self.c = c
            self.pid = os.getpid()
            self.calls = 0

        def __call__(self, batch):
            self.calls += 1
            return {"id": batch["id"] + self.c, "pid": np.full(
                len(batch["id"]), self.pid)}

    ds = rtd.range(200, parallelism=10)
    out = ds.map_batches(
        AddConst, compute=ActorPoolStrategy(2), fn_constructor_args=(1000,),
        num_cpus=0.1,
    ).take_all()
    assert sorted(r["id"] for r in out) == list(range(1000, 1200))
    pids = {r["pid"] for r in out}
    assert 1 <= len(pids) <= 2  # the pool, not one task process per block


def test_push_based_shuffle_exact_permutation(rt):
    n = 2000
    ds = rtd.range(n, parallelism=16)  # 16 blocks > PUSH_THRESHOLD
    out = ds.random_shuffle(seed=7).take_all()
    ids = [r["id"] for r in out]
    assert sorted(ids) == list(range(n))
    assert ids != list(range(n))  # actually shuffled


def test_read_binary_files(rt, tmp_path):
    p1 = tmp_path / "a.bin"
    p1.write_bytes(b"\x00\x01\x02")
    p2 = tmp_path / "b.bin"
    p2.write_bytes(b"hello")
    ds = rtd.read_binary_files([str(p1), str(p2)], include_paths=True)
    rows = sorted(ds.take_all(), key=lambda r: r["path"])
    assert rows[0]["bytes"] == b"\x00\x01\x02"
    assert rows[1]["bytes"] == b"hello"
    assert os.path.basename(rows[1]["path"]) == "b.bin"


def test_actor_pool_feeds_downstream_barrier(rt):
    """Actor-pool outputs consumed by a barrier op (shuffle collects refs
    before resolving): the pool must outlive its pending tasks."""
    from ray_tpu_torch.data import ActorPoolStrategy

    class Slow:
        def __init__(self):
            import time as _t

            _t.sleep(0.5)

        def __call__(self, batch):
            return batch

    ds = rtd.range(300, parallelism=12)
    out = (ds.map_batches(Slow, compute=ActorPoolStrategy(2), num_cpus=0.1)
           .random_shuffle(seed=1).take_all())
    assert sorted(r["id"] for r in out) == list(range(300))


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_matches_pandas_merge(rt, how):
    left = pd.DataFrame({
        "k": [1, 2, 2, 3, 5, 7],
        "a": [10.0, 20.0, 21.0, 30.0, 50.0, 70.0],
    })
    right = pd.DataFrame({
        "k": [2, 2, 3, 4, 8],
        "b": ["x", "y", "z", "w", "v"],
    })
    got = pd.DataFrame(rtd.from_pandas(left).join(
        rtd.from_pandas(right), on="k", how=how, num_partitions=3).take_all())
    want = left.merge(right, on="k", how=how)
    key = ["k", "a", "b"]
    got = got.reindex(columns=key)
    want = want.reindex(columns=key)
    norm = lambda df: sorted(  # noqa: E731
        [tuple("<na>" if pd.isna(v) else v for v in row)
         for row in df.itertuples(index=False)],
        key=str)
    assert norm(got) == norm(want), (how, got, want)


def test_join_column_collision_and_empty_side(rt):
    lds = rtd.from_items([{"k": i, "v": i * 10} for i in range(4)])
    rds = rtd.from_items([{"k": i, "v": i * 100} for i in range(2, 6)])
    out = sorted(lds.join(rds, on="k").take_all(), key=lambda r: r["k"])
    assert [r["k"] for r in out] == [2, 3]
    assert [r["v"] for r in out] == [20, 30]       # left keeps its name
    assert [r["v_r"] for r in out] == [200, 300]   # right gets the suffix

    empty = rtd.from_items([])
    assert lds.join(empty, on="k").take_all() == []
    assert sorted(r["k"] for r in lds.join(empty, on="k", how="left")
                  .take_all()) == [0, 1, 2, 3]


def test_optimizer_map_fusion_and_explain(rt):
    ds = (rtd.range(100, parallelism=4)
          .limit(100)
          .map(lambda r: {"id": r["id"] * 2})
          .map(lambda r: {"id": r["id"] + 1}))
    plan = ds.explain()
    assert "map -> map" in plan.splitlines()[0]          # logical
    assert "map->map" in plan.splitlines()[1]            # fused physical
    got = sorted(r["id"] for r in ds.take_all())
    assert got == sorted(i * 2 + 1 for i in range(100))


def test_optimizer_read_map_fusion(rt):
    ds = (rtd.range(80, parallelism=4)
          .map(lambda r: {"id": r["id"] + 5})
          .map(lambda r: {"id": r["id"] * 10}))
    assert sorted(r["id"] for r in ds.take_all()) == [i * 10 for i in range(5, 85)]
    assert ds.explain().splitlines()[1].strip() == "physical: read[4 tasks]"


def test_optimizer_redundant_ops_and_limit_pushdown(rt):
    ds = rtd.range(100, parallelism=4).limit(50).limit(10)
    phys = topt.describe(topt.optimize(ds._plan))
    assert phys.count("limit") == 1
    assert len(ds.take_all()) == 10

    ds2 = rtd.range(100, parallelism=4).map(lambda r: {"id": r["id"]}).limit(7)
    phys2 = topt.describe(topt.optimize(ds2._plan))
    assert phys2.index("limit") < phys2.index("map") or "map" not in phys2
    assert len(ds2.take_all()) == 7


def test_optimizer_projection_pushdown_parquet(rt, tmp_path):
    pd.DataFrame({"a": range(10), "b": range(10), "c": range(10)}).to_parquet(
        tmp_path / "p.parquet")
    ds = rtd.read_parquet(str(tmp_path / "p.parquet")).select_columns(["a", "c"])
    phys = topt.optimize(ds._plan)
    assert phys.read_tasks[0].columns == ["a", "c"]
    assert "select_columns" not in [op.name for op in phys.ops]
    rows = ds.take_all()
    assert set(rows[0].keys()) == {"a", "c"}
    assert len(rows) == 10


def test_hash_aggregate_parallel_and_multi_agg(rt):
    from ray_tpu_torch.data import AggregateFn

    rows = [{"g": i % 7, "v": float(i)} for i in range(200)]
    out = rtd.from_items(rows, parallelism=8).groupby("g").aggregate(
        AggregateFn(lambda: 0, lambda s, r: s + 1, lambda a, b: a + b, name="n"),
        AggregateFn(lambda: 0.0, lambda s, r: s + r["v"], lambda a, b: a + b,
                    name="total"),
    ).take_all()
    want = pd.DataFrame(rows).groupby("g")["v"].agg(["count", "sum"])
    got = {r["g"]: (r["n"], r["total"]) for r in out}
    assert len(got) == 7
    for g, (n, total) in got.items():
        assert n == want.loc[g, "count"]
        assert total == pytest.approx(want.loc[g, "sum"])


def test_groupby_std(rt):
    rows = [{"g": i % 3, "v": float(i * i % 17)} for i in range(60)]
    out = rtd.from_items(rows, parallelism=6).groupby("g").std("v").take_all()
    want = pd.DataFrame(rows).groupby("g")["v"].std()
    got = {r["g"]: r["std(v)"] for r in out}
    for g, s in got.items():
        assert s == pytest.approx(want.loc[g], rel=1e-9)


def test_projection_pushdown_missing_column_still_raises(rt, tmp_path):
    pd.DataFrame({"a": range(5)}).to_parquet(tmp_path / "p.parquet")
    ds = (rtd.read_parquet(str(tmp_path / "p.parquet"), columns=["a"])
          .select_columns(["a", "nope"]))
    with pytest.raises(Exception, match="nope"):
        ds.take_all()


def test_groupby_output_globally_key_sorted(rt):
    rows = [{"g": (i * 7) % 13, "v": i} for i in range(120)]
    out = rtd.from_items(rows, parallelism=6).groupby("g").count().take_all()
    keys = [r["g"] for r in out]
    assert keys == sorted(keys, key=str), keys


def test_sort_sort_keeps_stable_tiebreak(rt):
    rows = [{"a": i % 4, "b": i % 2} for i in range(16)]
    got = rtd.from_items(rows, parallelism=4).sort("a").sort("b").take_all()
    for b in (0, 1):
        sub = [r["a"] for r in got if r["b"] == b]
        assert sub == sorted(sub), got


def test_projection_pushdown_survives_trailing_limit(rt, tmp_path):
    pd.DataFrame({"a": range(20), "b": range(20), "c": range(20)}).to_parquet(
        tmp_path / "p.parquet")
    ds = (rtd.read_parquet(str(tmp_path / "p.parquet"))
          .select_columns(["a", "c"]).limit(5))
    phys = topt.optimize(ds._plan)
    assert phys.read_tasks[0].columns == ["a", "c"], phys.read_tasks[0].columns
    rows = ds.take_all()
    assert len(rows) == 5 and set(rows[0]) == {"a", "c"}


def test_zip_unique_sample_columns(rt):
    a = rtd.from_items([{"x": i} for i in range(10)], parallelism=2)
    b = rtd.from_items([{"y": i * 10} for i in range(10)], parallelism=3)
    z = a.zip(b).take_all()
    assert [(r["x"], r["y"]) for r in z] == [(i, i * 10) for i in range(10)]
    c = rtd.from_items([{"x": -i} for i in range(10)], parallelism=2)
    zz = a.zip(c).take_all()
    assert zz[3]["x"] == 3 and zz[3]["x_1"] == -3
    with pytest.raises(ValueError, match="equal row counts"):
        a.zip(rtd.from_items([{"y": 1}]))

    ds = rtd.from_items([{"g": i % 4, "v": i} for i in range(40)], parallelism=4)
    assert ds.unique("g") == [0, 1, 2, 3]
    assert ds.columns() == ["g", "v"]

    sampled = rtd.range(2000).random_sample(0.25, seed=1)
    n = sampled.count()
    assert 350 < n < 650, n
    assert sampled.count() == n


def test_read_images_and_sql(rt, tmp_path):
    import sqlite3

    from PIL import Image

    for i in range(3):
        Image.fromarray((np.ones((8, 6, 3)) * i * 40).astype(np.uint8)).save(
            tmp_path / f"im{i}.png")
    ds = rtd.read_images(str(tmp_path / "*.png"), size=(4, 4), mode="L",
                         include_paths=True)
    rows = ds.take_all()
    assert len(rows) == 3
    assert rows[0]["image"].shape == (4, 4)
    assert rows[1]["path"].endswith("im1.png")

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (a INT, b TEXT)")
    conn.executemany("INSERT INTO t VALUES (?, ?)", [(i, f"s{i}") for i in range(5)])
    conn.commit()
    conn.close()
    out = rtd.read_sql("SELECT a, b FROM t ORDER BY a", lambda: sqlite3.connect(db)).take_all()
    assert out == [{"a": i, "b": f"s{i}"} for i in range(5)]


def test_random_sample_blocks_decorrelated(rt):
    ds = rtd.range(400, parallelism=4).random_sample(0.5, seed=3)
    sets = []
    for b in ds.iter_blocks():
        ids = np.asarray(rtd.BlockAccessor.for_block(b).column("id"))
        sets.append(set((ids % 100).tolist()))
    assert len(sets) == 4
    assert any(sets[0] != s for s in sets[1:]), "identical masks across blocks"


def test_read_sql_non_query_raises(rt, tmp_path):
    import sqlite3

    db = str(tmp_path / "x.db")
    sqlite3.connect(db).close()
    with pytest.raises(Exception, match="returns rows"):
        rtd.read_sql("CREATE TABLE t (a INT)", lambda: sqlite3.connect(db)).take_all()


# ---------------------------------------------------- against the JAX package
@pytest.mark.parametrize("case", sorted(_torch_data_jax.pipelines(None)))
def test_pipeline_rows_match_jax(rt, jax_rows, case):
    """Seeded shuffles (simple and push-based) and samples, sorts, hash
    aggregates, the hash join, zip, unique and repartition: the port's
    rows equal ray_tpu.data's, in order, for the same inputs and seeds."""
    got = _torch_data_jax.plain(_torch_data_jax.pipelines(rtd)[case]())
    assert got == jax_rows[case]


@pytest.fixture(scope="module")
def noarrow_rows(tmp_path_factory):
    """``tests/_torch_data_noarrow.py``'s output: the pipelines on the port
    in a process, and task workers, where pyarrow and pandas raise
    ImportError (a directory of both, first on PYTHONPATH)."""
    import json
    import subprocess
    import sys

    work = tmp_path_factory.mktemp("noarrow")
    for name in ("pyarrow", "pandas"):
        (work / name).mkdir()
        (work / name / "__init__.py").write_text(f"raise ImportError('{name} is hidden')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(work), ROOT, os.path.join(ROOT, "tests")]))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "_torch_data_noarrow.py"),
                           str(work / "out.json")], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=100)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads((work / "out.json").read_text())


@pytest.mark.parametrize("case", sorted(_torch_data_jax.pipelines(None)))
def test_pipeline_rows_without_arrow_match_jax(noarrow_rows, jax_rows, case):
    """Where pyarrow and pandas are missing, as on the card's host, every
    tabular block stays a numpy dict in the driver and in the task
    workers, and the pipelines give ray_tpu.data's rows all the same: the
    shuffles, samples, sorts, aggregates, zip, unique, repartition,
    streaming_split's batches and iter_batches' leftovers. The hash join,
    on Arrow in both packages, raises ImportError instead."""
    assert noarrow_rows["_driver"] == [False, False, "dict"]
    assert noarrow_rows["_worker"] == [False, "dict"]
    if case == "join_outer":
        assert noarrow_rows[case] == {"error": "ImportError"}
    else:
        assert noarrow_rows[case] == jax_rows[case]


def _blocks():
    """Blocks of every kind a BlockAccessor meets: an Arrow table, a
    numpy dict Arrow cannot hold (an object column), rows of dicts, rows of
    scalars, a 2-D tensor column, and an empty list."""
    rng = np.random.RandomState(0)
    return {
        "table": {"a": np.arange(7), "b": rng.randn(7), "s": np.array(list("abcdefg"))},
        "object_dict": {"a": np.arange(5),
                        "o": np.array([{"x": 1}, None, [1], "s", 2.0], dtype=object)},
        "dict_rows": [{"k": i % 3, "v": float(i)} for i in range(6)],
        "scalar_rows": [3, 1, 4, 1, 5],
        "tensor": {"t": rng.randint(0, 9, (4, 3)).astype(np.int64), "i": np.arange(4)},
        "empty": [],
    }


def _same(a, b):
    """Structural equality of two block ops' results across the packages."""
    if isinstance(a, pa.Table):
        assert isinstance(b, pa.Table) and a.schema == b.schema
        assert a.to_pydict() == b.to_pydict()
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        assert _torch_data_jax.plain(a) == _torch_data_jax.plain(b)
    elif isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b) and _torch_data_jax.plain(a) == _torch_data_jax.plain(b)


@pytest.mark.parametrize("kind", sorted(_blocks()))
def test_block_accessor_matches_jax(kind):
    """normalize_block, and every BlockAccessor op and batch format, give
    JAX's results on the same block."""
    from ray_tpu.data import block as jb

    from ray_tpu_torch.data import block as tb

    raw = _blocks()[kind]
    j, t = jb.BlockAccessor.for_block(raw), tb.BlockAccessor.for_block(raw)
    _same(j.block, t.block)
    n = j.num_rows()
    assert (t.num_rows(), t.size_bytes(), t.is_tabular()) == (n, j.size_bytes(),
                                                              j.is_tabular())
    assert str(t.schema()) == str(j.schema())
    idx = np.arange(n)[::-2]
    mask = np.arange(n) % 3 != 1
    for op in (lambda a: a.take(idx), lambda a: a.mask(mask), lambda a: a.slice(1, max(1, n - 1)),
               lambda a: list(a.rows())):
        _same(op(j), op(t))
    for fmt in ("numpy", "rows", "pandas", "pyarrow"):
        try:
            want = j.to_batch(fmt)
        except Exception as e:  # noqa: BLE001 — the port must raise the same
            with pytest.raises(type(e)):
                t.to_batch(fmt)
            continue
        _same(want, t.to_batch(fmt))
    if j.is_tabular():
        assert t.column_names() == j.column_names()
        _same(j.columns(), t.columns())
    _same(jb.BlockAccessor.concat([raw, [], raw]), tb.BlockAccessor.concat([raw, [], raw]))


def test_normalize_and_rows_to_columns_match_jax():
    from ray_tpu.data import block as jb

    from ray_tpu_torch.data import block as tb

    for batch in (None, np.arange(4), pd.DataFrame({"a": [1, 2], "b": ["x", "y"]}),
                  pa.table({"z": [1.5, 2.5]}), (1, 2), {"m": np.ones((2, 2))}):
        _same(jb.normalize_block(batch), tb.normalize_block(batch))
    rows = [{"a": 1, "b": [1, 2]}, {"a": 2, "b": [3, 4]}]
    _same(jb.rows_to_columns(rows), tb.rows_to_columns(rows))
    with pytest.raises(TypeError):
        tb.normalize_block(object())


@pytest.mark.parametrize("n_parts", [1, 2, 5])
def test_shuffle_split_and_merge_match_jax(n_parts):
    """The push-based shuffle's map stage (permute, cut into n_parts) and
    merge stage (concatenate, permute) give JAX's rows for one seed."""
    block = jd.BlockAccessor.for_block({"id": np.arange(23), "v": np.arange(23) * 0.5}).block
    jparts = jex._shuffle_split._fn(block, 1234, n_parts)
    tparts = tex._shuffle_split._fn(block, 1234, n_parts)
    if n_parts == 1:
        jparts, tparts = (jparts,), (tparts,)
    assert type(jparts) is type(tparts) is tuple
    _same(list(jparts), list(tparts))
    parts = list(jparts)
    _same(jex._shuffle_merge._fn(99, *parts), tex._shuffle_merge._fn(99, *parts))
    _same(jex._shuffle_rows(block, 5), tex._shuffle_rows(block, 5))


def test_key_shard_and_aggregates_match_jax():
    """Join and group keys route to JAX's partitions, and each built-in
    AggregateFn's states accumulate, merge and finalize to JAX's values."""
    from ray_tpu.data import dataset as jds

    keys = [0, 1, 1.0, True, -3, 2**70, "a", b"b", np.int64(7), np.float32(0.5), (1, 2), None]
    for P in (1, 3, 16):
        assert [tds._key_shard(k, P) for k in keys] == [jds._key_shard(k, P) for k in keys]
    rows = [{"v": float(i * i % 11)} for i in range(13)]
    for name in ("_count_agg", "_sum_agg", "_min_agg", "_max_agg", "_mean_agg", "_std_agg"):
        args = () if name == "_count_agg" else ("v",)
        ja, ta = getattr(jds, name)(*args), getattr(tds, name)(*args)
        assert ta.name == ja.name
        states = []
        for agg in (ja, ta):
            left, right = agg.init(), agg.init()
            for r in rows[:5]:
                left = agg.accumulate(left, r)
            for r in rows[5:]:
                right = agg.accumulate(right, r)
            states.append(agg.finalize(agg.merge(left, right)))
        assert states[0] == states[1], name


def _plan_cases(data, tmp):
    """Equivalent plans built with one data package (nothing executes)."""
    path = os.path.join(tmp, "p.parquet")
    return [
        data.range(100, parallelism=4).limit(50).limit(10),
        data.range(100, parallelism=4).map(lambda r: r).limit(7),
        data.range(100, parallelism=4).limit(100).map(lambda r: r).map(lambda r: r),
        data.range(80, parallelism=4).map(lambda r: r).filter(lambda r: True),
        data.range(80, parallelism=4).repartition(4).repartition(8).random_shuffle(seed=1)
        .random_shuffle(seed=2).sort("id").sort("id"),
        data.read_parquet(path).select_columns(["a", "c"]).limit(5),
        data.read_parquet(path).map(lambda r: r).select_columns(["a"]),
        data.range(10).random_sample(0.5, seed=1).map(lambda r: r),
        data.range(10).map_batches(lambda b: b, batch_format="numpy").add_column(
            "z", lambda b: b["id"]).drop_columns(["z"]),
    ]


def test_optimizer_rewrites_and_explain_match_jax(tmp_path):
    """Each rule, and the optimizer to its fixpoint, rewrites equivalent
    plans into the same physical chains; explain() prints JAX's text."""
    pd.DataFrame({"a": range(4), "b": range(4), "c": range(4)}).to_parquet(
        tmp_path / "p.parquet")
    pairs = zip(_plan_cases(jd, str(tmp_path)), _plan_cases(rtd, str(tmp_path)))
    for jds_, tds_ in pairs:
        assert tds_.explain() == jds_.explain()
        assert repr(tds_) == repr(jds_)
        for rule in ("eliminate_redundant", "projection_pushdown", "limit_pushdown",
                     "map_fusion", "read_map_fusion", "optimize"):
            jp = getattr(jopt, rule)(jds_._plan)
            tp = getattr(topt, rule)(tds_._plan)
            assert topt._signature(tp) == jopt._signature(jp), rule
            assert [getattr(op, "preserves_rows", None) for op in tp.ops] == \
                [getattr(op, "preserves_rows", None) for op in jp.ops], rule
            assert [getattr(rt_, "columns", None) for rt_ in tp.read_tasks] == \
                [getattr(rt_, "columns", None) for rt_ in jp.read_tasks], rule
