"""Elementwise / normalization building blocks.

Counterpart of ``ray_tpu/ops/basic.py``: plain PyTorch compositions with
the same numerics (float32 statistics, rope on split halves).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.remat import checkpoint_name


def matmul(a, b):
    """``a @ b`` with JAX's dtype promotion: mixed operands (a float32
    LoRA delta meeting bf16 weights) are promoted instead of refused."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with fp32 accumulation, output in input dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale).to(x.dtype)


def rope_freqs(head_dim: int, max_len: int, theta: float = 10000.0, *,
               device=None):
    """(cos, sin), each [max_len, head_dim/2] float32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def rope(x, cos, sin, positions=None):
    """Rotary position embedding. x: [B, T, H, D]; cos/sin: [T_max, D/2];
    positions: optional [B, T] absolute positions, clamped into the table
    as JAX's gather clamps them."""
    T = x.shape[1]
    if positions is None:
        c = cos[:T][None, :, None, :]
        s = sin[:T][None, :, None, :]
    else:
        positions = positions.clamp(0, cos.shape[0] - 1)
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU FFN: (silu(x@Wg) * (x@Wu)) @ Wd.

    The gate/up products are named ``"ffn_hidden"`` for the remat policy,
    as in the JAX package."""
    gate = checkpoint_name(matmul(x, w_gate), "ffn_hidden")
    up = checkpoint_name(matmul(x, w_up), "ffn_hidden")
    return matmul(F.silu(gate) * up, w_down)
