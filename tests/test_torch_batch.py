"""The port's batch inference against the JAX package, on the CPU:
``build_llm_processor`` over the port's in-process dataset gives JAX
``generate``'s tokens, one call per batch, and the dataset hands the
mapped function ``ray_tpu.data``'s numpy batch format. No test starts the
ray_tpu runtime."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.data.block import BlockAccessor
from ray_tpu.llm import generate as jgenerate
from ray_tpu.models import llama as jllama
from ray_tpu_torch.data import from_items
from ray_tpu_torch.data.dataset import to_batch
from ray_tpu_torch.llm import batch as tbatch
from ray_tpu_torch.llm import build_llm_processor
from ray_tpu_torch.llm import generation as tgeneration
from ray_tpu_torch.models import llama as tllama


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, jparams, tcfg, params


def test_processor_matches_jax_generate(models, monkeypatch):
    """10 rows at batch_size 4: three generate calls over blocks of 4, 3
    and 3 rows (ray_tpu.data's repartition), each row's completion equal
    to JAX generate's over the same batch, the other columns kept."""
    jcfg, jparams, tcfg, params = models
    rows = [{"prompt_tokens": [1, 2, 3, 10 + i], "id": i} for i in range(10)]
    calls = []
    real = tgeneration.generate
    monkeypatch.setattr(tgeneration, "generate",
                        lambda p, c, prompts, **kw: calls.append(prompts)
                        or real(p, c, prompts, **kw))
    processor = build_llm_processor(tcfg, params=params, batch_size=4,
                                    max_new_tokens=3)
    out = processor(from_items(rows)).take_all()
    assert [len(c) for c in calls] == [4, 3, 3]
    want = [t for c in calls for t in jgenerate(jparams, jcfg, c, max_new_tokens=3,
                                                  temperature=0.0)]
    assert len(out) == 10
    for row, src, w in zip(out, rows, want):
        assert row["id"] == src["id"]
        assert row["prompt_tokens"].tolist() == src["prompt_tokens"]
        assert row["completion_tokens"].tolist() == w


@pytest.mark.parametrize("rows", [
    [{"prompt_tokens": [1, 2, 3], "id": 0}, {"prompt_tokens": [4, 5, 6], "id": 1}],
    [{"x": 1.5}, {"x": 2.5}],
    [[1, 2], [3, 4]],
])
def test_batch_format_matches_ray_tpu_data(rows):
    """A block of rows reaches the mapped function as ray_tpu.data renders
    it in numpy batch format."""
    got = to_batch(rows)
    want = BlockAccessor.for_block(rows).to_batch("numpy")
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


def test_ragged_prompts_raise_as_in_ray_tpu_data():
    """Ragged prompt columns do not fit one numpy array: both packages'
    numpy batch format raise ValueError for them."""
    rows = [{"prompt_tokens": [1, 2, 3]}, {"prompt_tokens": [4, 5]}]
    with pytest.raises(ValueError):
        BlockAccessor.for_block(rows).to_batch("numpy")
    with pytest.raises(ValueError):
        from_items(rows).map_batches(lambda b: b, batch_size=2)


def test_map_batches_blocks():
    """No batch_size: one block per from_items chunk; a returned array
    becomes the column ``data``; a batch format other than numpy raises."""
    ds = from_items([{"v": i} for i in range(7)], parallelism=3)
    seen = []

    def fn(b):
        seen.append(len(b["v"]))
        return b["v"] * 2

    out = ds.map_batches(fn).take_all()
    assert seen == [3, 2, 2]
    assert [r["data"] for r in out] == [0, 2, 4, 6, 8, 10, 12]
    assert ds.count() == 7
    with pytest.raises(ValueError):
        ds.map_batches(fn, batch_format="pandas")


def test_cached_params_keyed_by_config_and_device(models):
    """Without params the processor draws weights once per (config,
    device), from seed 0 with llama_init."""
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
