"""The port's continuous-batching engine against the JAX package, on the CPU.

Greedy engine tokens must equal the JAX ``generate`` tokens exactly in
both host loops (planned: eos_id None; reactive: with an eos_id), and the
LoRA multiplex must equal the JAX engine's on the same adapters. Weights
are the JAX tiny init carried across; float32."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import ContinuousBatchingEngine as JEngine
from ray_tpu.llm import generate as jgenerate
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import ContinuousBatchingEngine
from ray_tpu_torch.models import llama as tllama

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17],
           list(range(30, 50))]
MAX_NEW = 12


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    # greedy continuations are prefix-stable, so one JAX call serves every
    # test that needs <= MAX_NEW tokens of these prompts
    ref = jgenerate(jparams, jcfg, PROMPTS, max_new_tokens=MAX_NEW, temperature=0.0)
    return jcfg, jparams, tcfg, params, ref


def _serve(eng, calls):
    async def go():
        await eng.start()
        try:
            return await asyncio.gather(*[eng.generate(p, **kw) for p, kw in calls])
        finally:
            await eng.stop()

    return asyncio.run(go())


def _truncate_at(tokens, eos):
    return tokens[:tokens.index(eos) + 1] if eos in tokens else tokens


def test_planned_loop_matches_jax_generate(models):
    _, _, cfg, params, ref = models
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=8,
                                   n_pages=64, max_seq_len=64)
    # 4 requests on 2 slots: two are admitted while the others decode
    outs = _serve(eng, [(p, {"max_tokens": MAX_NEW}) for p in PROMPTS])
    assert outs == ref


def test_reactive_loop_matches_jax_generate(models):
    _, _, cfg, params, ref = models
    eos = ref[0][4]  # truncates request 0 (and any other that emits it)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=8,
                                   n_pages=64, max_seq_len=64, eos_id=eos)
    outs = _serve(eng, [(p, {"max_tokens": MAX_NEW}) for p in PROMPTS])
    assert outs == [_truncate_at(r, eos) for r in ref]
    assert len(outs[0]) <= 5


def test_last_page_junk_decode_in_planned_block(models):
    """A request that fills every page finishes inside an 8-step block:
    the steps past its last page gather a clamped page index and write to
    the junk page, and neither it nor its neighbour is corrupted."""
    _, _, cfg, params, ref = models
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=8,
                                   n_pages=16, max_seq_len=32,
                                   block_buckets=(8,))
    assert len(PROMPTS[3]) + MAX_NEW == eng.MAXP * eng.PS
    outs = _serve(eng, [(PROMPTS[3], {"max_tokens": MAX_NEW}),
                        (PROMPTS[0], {"max_tokens": MAX_NEW})])
    assert outs == [ref[3], ref[0]]
    assert eng.steps > MAX_NEW  # the block did run past the last page


def test_mid_decode_admission(models):
    _, _, cfg, params, _ = models

    async def go():
        eng = ContinuousBatchingEngine(params, cfg, max_batch=4, page_size=8,
                                       n_pages=64, max_seq_len=128)
        await eng.start()
        long_task = asyncio.get_running_loop().create_task(
            eng.generate([1, 2, 3], max_tokens=110))
        while eng.steps < 5:  # the long request is decoding now
            await asyncio.sleep(0.001)
        short = await eng.generate([5, 6], max_tokens=4)
        long_done = long_task.done()
        long_out = await long_task
        await eng.stop()
        return short, long_out, long_done

    short, long_out, long_done = asyncio.run(go())
    assert len(short) == 4 and len(long_out) == 110
    assert not long_done, "short request waited for the long batch to drain"


def test_streaming_reclaims_pages(models):
    _, _, cfg, params, ref = models

    async def go():
        eng = ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=8,
                                       n_pages=32, max_seq_len=64, eos_id=10**6)
        await eng.start()
        free0 = len(eng.free_pages)
        rid = eng.submit(PROMPTS[1], max_tokens=MAX_NEW)
        toks = [t async for t in eng.stream(rid)]
        for _ in range(4):  # a page leak would exhaust the pool
            await eng.generate([3, 1, 4, 1, 5], max_tokens=10)
        free1 = len(eng.free_pages)
        head = eng.headroom()
        await eng.stop()
        return toks, free0, free1, head

    toks, free0, free1, head = asyncio.run(go())
    assert toks == ref[1]
    assert free0 == free1, f"page leak: {free0} -> {free1}"
    assert head["free_slots"] == 2 and head["tokens_in_flight"] == 0


def test_lora_multiplex_matches_jax_engine(models):
    jcfg, jparams, cfg, params, _ = models
    rng = np.random.default_rng(0)
    r = 4
    D, Oq, Ov = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    adapters = {
        "alpha": {"wq_a": rng.normal(0, 0.3, (D, r)), "wq_b": rng.normal(0, 0.3, (r, Oq)),
                  "wv_a": rng.normal(0, 0.3, (D, r)), "wv_b": rng.normal(0, 0.3, (r, Ov))},
        "beta": {},  # zero adapter == base model
    }
    prompt = [5, 6, 7, 8]
    calls = [(prompt, {"max_tokens": 8}), (prompt, {"max_tokens": 8, "adapter": "alpha"}),
             (prompt, {"max_tokens": 8, "adapter": "beta"})]
    kw = dict(max_batch=4, page_size=8, n_pages=64, max_seq_len=64,
              lora_adapters=adapters, lora_rank=r)
    want = _serve(JEngine(jparams, jcfg, **kw), calls)
    got = _serve(ContinuousBatchingEngine(params, cfg, **kw), calls)
    assert got == want
    assert got[2] == got[0] and got[1] != got[0]


def test_sampled_rows_leave_greedy_rows_exact(models):
    """A sampled request in the batch draws Gumbel noise for its own row
    only: the greedy request beside it still matches JAX exactly, and the
    engine's seeded generator makes the sampled tokens repeatable."""
    _, _, cfg, params, ref = models
    calls = [(PROMPTS[0], {"max_tokens": MAX_NEW}),
             (PROMPTS[1], {"max_tokens": MAX_NEW, "temperature": 1.0})]
    runs = [_serve(ContinuousBatchingEngine(params, cfg, max_batch=2, page_size=8,
                                            n_pages=32, max_seq_len=64), calls)
            for _ in range(2)]
    assert runs[0][0] == ref[0]
    assert runs[0][1] == runs[1][1]
    assert len(runs[0][1]) == MAX_NEW
    assert all(0 <= t < cfg.vocab_size for t in runs[0][1])


def test_unsupported_options_raise(models):
    """Every engine option builds (int8 pools, speculative decoding), and
    bad inputs raise before any launch: export_pages of a request that
    holds no slot, an out-of-vocab first token or prompt, an unknown
    kv_dtype."""
    _, _, cfg, params, _ = models
    eng = ContinuousBatchingEngine(params, cfg, kv_dtype="int8", spec_enable=True)
    assert eng.kpool["q"].dtype == torch.int8 and eng.vpool["s"].dtype == torch.float32
    with pytest.raises(KeyError, match="not holding a slot"):
        eng.export_pages(1)
    with pytest.raises(ValueError, match="vocab"):
        stack = torch.zeros((cfg.n_layers, 1, 16, cfg.n_kv_heads, cfg.head_dim))
        ContinuousBatchingEngine(params, cfg).submit_prefilled(
            [1, 2], stack, stack, cfg.vocab_size)
    with pytest.raises(ValueError, match="kv_dtype"):
        ContinuousBatchingEngine(params, cfg, kv_dtype="fp4")
    eng = ContinuousBatchingEngine(params, cfg)
    with pytest.raises(ValueError, match="vocab"):
        eng.submit([cfg.vocab_size])
