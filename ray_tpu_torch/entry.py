"""Port entry point: the flagship Llama forward on one card.

Counterpart of ``__graft_entry__.entry()``: the same configuration and
``[2, 256]`` tokens, returning ``(fn, example_args)`` on the device.
"""
from __future__ import annotations

import torch

from ray_tpu_torch.models.llama import LlamaConfig, llama_forward, llama_init
from ray_tpu_torch.utils.device import resolve_device


def entry(device=None):
    """Forward step on the flagship Llama model, single card.

    Returns (fn, example_args): fn(params, tokens) -> logits."""
    device = resolve_device(device)
    cfg = LlamaConfig(
        vocab_size=2048,
        d_model=512,
        n_layers=4,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1408,
        max_seq_len=512,
        dtype="bfloat16",
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = llama_init(generator, cfg, device)
    tokens = torch.zeros((2, 256), dtype=torch.int64, device=device)

    @torch.inference_mode()
    def fn(params, tokens):
        logits, _ = llama_forward(params, tokens, cfg, attn_impl="auto")
        return logits

    return fn, (params, tokens)
