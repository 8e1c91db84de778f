"""Exact attention reference.

Counterpart of ``ray_tpu/parallel/ring_attention.py``. Only
``reference_attention`` is ported in this slice; ring attention itself
waits for the parallel slice (ROADMAP, PyTorch/CUDA port).
"""
from __future__ import annotations

import math

import torch

_NEG_BIG = -1e30


def reference_attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """Unsharded exact attention for testing parity. q/k/v: [B, T, H, D]."""
    B, T, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
        scores = scores.masked_fill(~mask[None, None], _NEG_BIG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
