"""KV-cache autoregressive generation for the Llama family.

Counterpart of ``ray_tpu/llm/generation.py``: a batched prefill over
left-padded prompts, then one decode step per new token against a
static-shape cache. The JAX ``lax.scan`` is a Python loop here; the cache
is updated in place. Sampling is Gumbel-max from a ``torch.Generator``,
which draws a different stream than ``jax.random``: only greedy tokens
match the JAX package token for token.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops.basic import matmul, rms_norm, rope, rope_freqs, swiglu
from ray_tpu_torch.utils.device import resolve_device

_NEG_BIG = -1e30


def _gqa_attn(q, k, v, mask):
    """Masked multi-head attention with GQA key/value repeat.
    q: [B, Tq, H, d]; k/v: [B, Tk, KV, d]; mask: [B, Tq, Tk] (True=attend).
    Scores are divided by sqrt(f32(d)), masked with -1e30, softmaxed in
    float32 and cast to q's dtype before P·V, as in the JAX version."""
    B, Tq, H, d = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    dt = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt))
    # JAX divides by a float32 scalar array, which promotes bf16 scores
    scores = scores.float() / math.sqrt(d)
    scores = scores.masked_fill(~mask[:, None, :, :], _NEG_BIG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(w.dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(dt), v.to(dt))


def _layer_kv(layer, h, cfg):
    B, T, _ = h.shape
    hd = cfg.head_dim
    k = matmul(h, layer["wk"]["kernel"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = matmul(h, layer["wv"]["kernel"]).reshape(B, T, cfg.n_kv_heads, hd)
    return k, v


def _ffn(layer, x):
    h = rms_norm(x, layer["ffn_norm"]["scale"])
    return x + swiglu(h, layer["w_gate"]["kernel"], layer["w_up"]["kernel"],
                      layer["w_down"]["kernel"])


def _gumbel_argmax(logits, temps, generator):
    """One categorical sample per row of ``logits`` [..., V] at
    temperature ``temps`` (broadcast against the rows), by Gumbel-max."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return (logits.float() / temps + gumbel).argmax(dim=-1)


def _pick(logits, temperature: float, generator):
    """Greedy argmax, or a Gumbel-max sample at ``temperature`` > 0."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    return _gumbel_argmax(logits, max(temperature, 1e-6), generator)


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device):
    """[n_layers, B, max_len, n_kv_heads, head_dim] k/v tensors."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    k = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
    return {"k": k, "v": torch.zeros_like(k)}


def prefill(params, tokens, pad_lens, cfg: LlamaConfig, cache):
    """Process the (left-padded) prompt in one batched pass, filling the
    cache in place; returns last-position logits + cache.

    tokens: [B, Tp] integer, left-padded; pad_lens: [B] pad counts."""
    B, Tp = tokens.shape
    dev = tokens.device
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev)
    idx = torch.arange(Tp, device=dev)
    positions = (idx[None, :] - pad_lens[:, None]).clamp_min(0)
    # causal AND not-a-pad-key
    causal = idx[None, :, None] >= idx[None, None, :]
    valid_key = idx[None, None, :] >= pad_lens[:, None, None]
    mask = causal & valid_key

    x = params["tok"]["embedding"][tokens]
    for i in range(cfg.n_layers):
        layer = params[f"layers_{i}"]
        h = rms_norm(x, layer["attn_norm"]["scale"])
        q = matmul(h, layer["wq"]["kernel"]).reshape(B, Tp, cfg.n_heads, cfg.head_dim)
        k, v = _layer_kv(layer, h, cfg)
        q = rope(q, cos, sin, positions)
        k = rope(k, cos, sin, positions)
        cache["k"][i, :, :Tp] = k
        cache["v"][i, :, :Tp] = v
        att = _gqa_attn(q, k, v, mask)
        x = x + matmul(att.reshape(B, Tp, -1), layer["wo"]["kernel"])
        x = _ffn(layer, x)
    x = rms_norm(x, params["norm"]["scale"])
    logits = matmul(x[:, -1], params["lm_head"]["kernel"])
    return logits, cache


def decode_step(params, token, pos: int, pad_lens, cfg: LlamaConfig, cache):
    """One incremental step: token [B] at absolute cache position ``pos``;
    attends the whole cache through a validity mask. Updates the cache in
    place."""
    B = token.shape[0]
    dev = token.device
    max_len = cache["k"].shape[2]
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev)
    positions = (pos - pad_lens).clamp_min(0)[:, None]  # [B, 1]
    key_idx = torch.arange(max_len, device=dev)
    mask = (key_idx[None, None, :] <= pos) & (key_idx[None, None, :] >= pad_lens[:, None, None])

    x = params["tok"]["embedding"][token][:, None, :]  # [B, 1, D]
    for i in range(cfg.n_layers):
        layer = params[f"layers_{i}"]
        h = rms_norm(x, layer["attn_norm"]["scale"])
        q = matmul(h, layer["wq"]["kernel"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        k, v = _layer_kv(layer, h, cfg)
        q = rope(q, cos, sin, positions)
        k = rope(k, cos, sin, positions)
        cache["k"][i, :, pos] = k[:, 0]
        cache["v"][i, :, pos] = v[:, 0]
        att = _gqa_attn(q, cache["k"][i], cache["v"][i], mask)
        x = x + matmul(att.reshape(B, 1, -1), layer["wo"]["kernel"])
        x = _ffn(layer, x)
    x = rms_norm(x, params["norm"]["scale"])
    logits = matmul(x[:, 0], params["lm_head"]["kernel"])
    return logits, cache


@torch.inference_mode()
def generate_tokens(params, tokens, pad_lens, cfg: LlamaConfig,
                    max_new_tokens: int, temperature: float, generator=None):
    """Batched generation: prefill + a loop of decode steps.
    tokens: [B, Tp] left-padded prompts on the params' device.
    Returns [B, max_new_tokens] int64."""
    B, Tp = tokens.shape
    cache = init_cache(cfg, B, Tp + max_new_tokens, tokens.device)
    logits, cache = prefill(params, tokens, pad_lens, cfg, cache)
    out = []
    for i in range(max_new_tokens):
        tok = _pick(logits, temperature, generator)
        out.append(tok)
        logits, cache = decode_step(params, tok, Tp + i, pad_lens, cfg, cache)
    return torch.stack(out, dim=1)


def pad_prompts(prompts: list[list[int]], pad_id: int = 0, device=None):
    """Left-pad ragged prompts to one batch: (tokens [B, Tp], pad_lens [B])
    on ``device`` (``None``: the card, as JAX's lands on the default
    device)."""
    device = resolve_device(device)
    Tp = max(len(p) for p in prompts)
    B = len(prompts)
    tokens = np.full((B, Tp), pad_id, dtype=np.int64)
    pad_lens = np.zeros(B, dtype=np.int64)
    for i, p in enumerate(prompts):
        tokens[i, Tp - len(p):] = p
        pad_lens[i] = Tp - len(p)
    return (torch.tensor(tokens, device=device), torch.tensor(pad_lens, device=device))


def generate(params, cfg: LlamaConfig, prompts: list[list[int]],
             max_new_tokens: int = 32, temperature: float = 0.0,
             seed: int = 0) -> list[list[int]]:
    """User-facing batched generate over ragged token prompts, on the
    device of ``params``."""
    dev = params["tok"]["embedding"].device
    tokens, pad_lens = pad_prompts(prompts, device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    out = generate_tokens(params, tokens, pad_lens, cfg, max_new_tokens,
                          float(temperature), generator)
    return [list(map(int, row)) for row in out.cpu().numpy()]
