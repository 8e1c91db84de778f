"""The port's batched generation against the JAX package's, on the CPU.

Greedy tokens must be equal exactly: the same weights (the JAX init
carried across), the same ragged prompts, float32."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm import generate as jgenerate
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import generate
from ray_tpu_torch.models import llama as tllama

PROMPTS = [[5, 17, 42, 7], [3, 9], [11, 2, 8, 200, 31, 4, 77]]


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.LlamaConfig.tiny()
    params = tllama.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    return jcfg, jparams, tcfg, params


def test_greedy_ragged_batch_matches_jax(models):
    jcfg, jparams, tcfg, params = models
    want = jgenerate(jparams, jcfg, PROMPTS, max_new_tokens=10, temperature=0.0)
    got = generate(params, tcfg, PROMPTS, max_new_tokens=10, temperature=0.0)
    assert got == want


def test_cached_decode_matches_full_recompute(models):
    _, _, cfg, params = models
    prompt = PROMPTS[0]
    toks = list(prompt)
    for _ in range(8):
        logits, _ = tllama.llama_forward(params, torch.tensor([toks]), cfg)
        toks.append(int(logits[0, -1].argmax()))
    assert generate(params, cfg, [prompt], max_new_tokens=8)[0] == toks[len(prompt):]


def test_sampling_is_seeded_and_in_vocab(models):
    _, _, cfg, params = models
    a = generate(params, cfg, [[1, 2, 3]], max_new_tokens=8, temperature=1.0, seed=1)
    b = generate(params, cfg, [[1, 2, 3]], max_new_tokens=8, temperature=1.0, seed=1)
    assert a == b
    assert all(0 <= t < cfg.vocab_size for t in a[0])


def test_pad_prompts_matches_jax_and_defaults_to_the_card(monkeypatch):
    from ray_tpu.llm.generation import pad_prompts as jpad

    from ray_tpu_torch.llm.generation import pad_prompts

    tokens, pad_lens = pad_prompts(PROMPTS, pad_id=1, device="cpu")
    jtokens, jpad_lens = jpad(PROMPTS, pad_id=1)
    assert tokens.device.type == "cpu"
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_array_equal(pad_lens.numpy(), np.asarray(jpad_lens))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pad_prompts(PROMPTS)
