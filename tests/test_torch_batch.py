"""The port's batch inference against the JAX package, on the CPU:
``build_llm_processor`` maps ``generate`` over a ``ray_tpu_torch.data``
dataset as the data executor's remote map tasks, one task and one call per
block, and gives the tokens of JAX's ``build_llm_processor`` over
``ray_tpu.data`` (run on a JAX runtime in a subprocess,
``tests/_torch_batch_jax.py``) and of JAX ``generate`` per block. Batches
reach the mapped function in ``ray_tpu.data``'s numpy batch format.

One port runtime serves the module (``ray_tpu_torch.init``); idle leases go
back after 1 s."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_batch_jax
import _torch_data_jax
from _torch_time_limit import session_watchdog, time_limits  # noqa: F401 — autouse
from ray_tpu.data.block import BlockAccessor as JBlockAccessor
from ray_tpu.llm import generate as jgenerate
from ray_tpu.models import llama as jllama
from ray_tpu_torch.core.ref import TaskError
from ray_tpu_torch.data import BlockAccessor, from_items
from ray_tpu_torch.llm import batch as tbatch
from ray_tpu_torch.llm import build_llm_processor
from ray_tpu_torch.llm import generation as tgeneration
from ray_tpu_torch.models import llama as tllama

# the JAX processor's subprocess ~16 s alone; a case's task workers import
# torch and the model (~5 s each)
_module_limit, _test_limit = time_limits(module_s=240, test_s=120)


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch
    from ray_tpu_torch import config

    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    # one card in the ledger (no CUDA here): maps that lease it run one
    # at a time on a worker whose CUDA_VISIBLE_DEVICES names it
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, jparams, tcfg, params


@pytest.fixture(scope="module")
def jax_processor_rows(tmp_path_factory):
    return _torch_data_jax.run_once(tmp_path_factory, "_torch_batch_jax.py", timeout=200)


class _Probed:
    """A dataset whose ``map_batches`` wraps the mapped function in its
    task: the task first empties its process's ``GENERATE_BATCHES``, and
    every row it returns carries its pid and the rows of each generate
    call the task made (``generate_rows``, one entry per call)."""

    def __init__(self, ds):
        self._ds = ds

    def map_batches(self, fn, **kwargs):
        def probed(batch, _fn=fn):
            import os

            from ray_tpu_torch.llm import batch as llm_batch

            llm_batch.GENERATE_BATCHES.clear()
            out = _fn(batch)
            n = len(out["id"])
            calls = np.array(llm_batch.GENERATE_BATCHES)
            return dict(out, pid=np.full(n, os.getpid()),
                        generate_rows=np.broadcast_to(calls, (n, len(calls))).copy())

        return self._ds.map_batches(probed, **kwargs)


def test_processor_matches_jax_generate(rt, models, jax_processor_rows):
    """10 rows at batch_size 4: three map tasks over blocks of 4, 3 and 3
    rows (ray_tpu.data's repartition), each one generate call over its
    whole block, whose rows equal JAX generate's over the same block and
    JAX's processor's rows over ray_tpu.data, the other columns kept."""
    jcfg, jparams, tcfg, params = models
    rows = _torch_batch_jax.ROWS
    processor = build_llm_processor(tcfg, params=params, batch_size=_torch_batch_jax.BATCH_SIZE,
                                    max_new_tokens=_torch_batch_jax.MAX_NEW, device="cpu")
    blocks = [list(BlockAccessor.for_block(b).rows())
              for b in processor(_Probed(from_items(rows))).iter_blocks()]
    assert [len(b) for b in blocks] == [4, 3, 3]
    for b in blocks:  # each task made one generate call, over its block
        assert [r["generate_rows"].tolist() for r in b] == [[len(b)]] * len(b)
    out = [r for b in blocks for r in b]
    want = [t for b in blocks for t in jgenerate(
        jparams, jcfg, [r["prompt_tokens"].tolist() for r in b],
        max_new_tokens=_torch_batch_jax.MAX_NEW, temperature=0.0)]
    assert len(out) == 10
    for row, src, w, j in zip(out, rows, want, jax_processor_rows):
        assert row["id"] == src["id"] == j["id"]
        assert row["prompt_tokens"].tolist() == src["prompt_tokens"] == j["prompt_tokens"]
        assert row["completion_tokens"].tolist() == w == j["completion_tokens"]


@pytest.mark.parametrize("rows", [
    [{"prompt_tokens": [1, 2, 3], "id": 0}, {"prompt_tokens": [4, 5, 6], "id": 1}],
    [{"x": 1.5}, {"x": 2.5}],
    [[1, 2], [3, 4]],
])
def test_batch_format_matches_ray_tpu_data(rows):
    """A block of rows reaches the mapped function as ray_tpu.data renders
    it in numpy batch format."""
    got = BlockAccessor.for_block(rows).to_batch("numpy")
    want = JBlockAccessor.for_block(rows).to_batch("numpy")
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


def test_ragged_prompts_raise_as_in_ray_tpu_data(rt):
    """Ragged prompt columns do not fit one numpy array: both packages'
    numpy batch format raise ValueError for them (in the port's map task,
    so the driver's get raises the task's error)."""
    rows = [{"prompt_tokens": [1, 2, 3]}, {"prompt_tokens": [4, 5]}]
    with pytest.raises(ValueError):
        JBlockAccessor.for_block(rows).to_batch("numpy")
    with pytest.raises(ValueError):
        BlockAccessor.for_block(rows).to_batch("numpy")
    with pytest.raises(TaskError, match="ValueError"):
        from_items(rows).map_batches(lambda b: b, batch_size=2).take_all()


def test_map_batches_blocks(rt):
    """No batch_size: one block per from_items chunk, each one map task
    (the mapped function returns its block's size); a returned array
    becomes the column ``data``; an unknown batch format raises in the
    task."""
    ds = from_items([{"v": i} for i in range(7)], parallelism=3)
    sizes = ds.map_batches(lambda b: {"n": np.array([len(b["v"])])}).take_all()
    assert [r["n"] for r in sizes] == [3, 2, 2]
    out = ds.map_batches(lambda b: b["v"] * 2).take_all()
    assert [r["data"] for r in out] == [0, 2, 4, 6, 8, 10, 12]
    assert ds.count() == 7
    with pytest.raises(TaskError, match="unknown batch_format"):
        ds.map_batches(lambda b: b, batch_format="nope").take_all()


def test_cached_params_keyed_by_config_and_device(rt, models):
    """Without params the processor's task workers draw weights once per
    (config, device), from seed 0 with llama_init: the same weights as
    this process's cache, so the same tokens."""
    _, _, tcfg, _ = models
    tbatch._param_cache.clear()
    a = tbatch._cached_params(tcfg, "cpu")
    assert tbatch._cached_params(tcfg, torch.device("cpu")) is a
    assert list(tbatch._param_cache) == [(tcfg, "cpu")]
    want = tllama.llama_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert torch.equal(a["lm_head"]["kernel"], want["lm_head"]["kernel"])
    out = build_llm_processor(tcfg, batch_size=2, max_new_tokens=2, device="cpu")(
        from_items([{"prompt_tokens": [5, 6]}] * 2)).take_all()
    assert [r["completion_tokens"].tolist() for r in out] == \
        tgeneration.generate(a, tcfg, [[5, 6]] * 2, max_new_tokens=2)
    tbatch._param_cache.clear()


def test_card_maps_lease_a_card_each(rt, models):
    """A map of num_gpus=1 leases the runtime's one card for each task:
    the 6 blocks run one after another (the executor keeps 8 in flight,
    the lease allows one), in one worker that keeps the lease and sees
    the card as CUDA_VISIBLE_DEVICES, so a processor's weights are drawn
    once. The processor asks for this on a CUDA device, not on the CPU."""
    def _leased_span(batch):
        """The task's pid, CUDA_VISIBLE_DEVICES and the perf_counter span it
        ran for (0.3 s), on each of its rows."""
        import os
        import time

        t0 = time.perf_counter()
        time.sleep(0.3)
        n = len(batch["i"])
        return {"i": batch["i"], "pid": np.full(n, os.getpid()),
                "cards": np.full(n, os.environ.get("CUDA_VISIBLE_DEVICES", "")),
                "t0": np.full(n, t0), "t1": np.full(n, time.perf_counter())}

    ds = from_items([{"i": i} for i in range(6)], parallelism=6)
    out = ds.map_batches(_leased_span, num_gpus=1).take_all()
    assert [r["i"] for r in out] == list(range(6))
    assert {str(r["cards"]) for r in out} == {"0"}
    assert len({int(r["pid"]) for r in out}) == 1
    spans = sorted((float(r["t0"]), float(r["t1"])) for r in out)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), spans
    _, _, tcfg, _ = models
    for device, cards in ((None, 1), ("cuda", 1), ("cpu", None)):
        ds = build_llm_processor(tcfg, device=device)(from_items([{"prompt_tokens": [1]}]))
        assert ds._plan.ops[-1].num_gpus == cards
