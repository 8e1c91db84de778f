"""Flash attention forward: a hand-written Hopper kernel and its plain version.

Counterpart of ``ray_tpu/ops/flash_attention.py``. The TPU kernel
``_fwd_kernel`` becomes ``csrc/flash_attention_fwd.cu`` (CUDA C++ for
sm_90a, bound with ctypes, built at first use by ``kernels.load``);
``flash_attention_plain`` computes the same function in plain PyTorch.

A CUDA tensor always goes through the kernel (or the call raises); a CPU
tensor goes through the plain version. Nothing falls back from one to the
other.

This slice is forward only: the two backward kernels and the
``torch.autograd.Function`` that joins them wait for the training slice
(ROADMAP "PyTorch/CUDA port", training slice).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch import kernels

_NEG_BIG = -1e30
KERNEL = "flash_attention_fwd"
_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_int,
                                          ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, causal: bool = True, sm_scale: float):
    """Plain PyTorch version of the kernel: float32 scores and softmax,
    causal top-left ``row >= col`` with fill -1e30 and masked probabilities
    zeroed, ``out = acc / max(l, 1e-30)`` in q's dtype and the slim
    ``lse = m + log(l)`` as [B*H, T] float32. q/k/v: [B, T, H, D]."""
    B, T, H, D = q.shape
    Tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        s = s.masked_fill(~mask, _NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / denom.permute(0, 2, 1, 3)
    lse = (m + torch.log(denom))[..., 0].reshape(B * H, T)
    return out.to(q.dtype), lse


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q/k/v must be [B, T, H, D]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(
            f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)}: "
            "equal batch, head count and head dim required (expand GQA first)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"mixed dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v on different devices")
    if k.shape[1] < 1:
        raise ValueError("empty key sequence")


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            sm_scale: float | None = None):
    """(out [B, T, H, D], lse [B*H, T] float32) of q/k/v [B, T, H, D].

    On a CUDA tensor this launches the kernel, and counts the launch in
    ``kernels.LAUNCHES``; on a CPU tensor it runs the plain version."""
    _check_inputs(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention is forward-only in this slice: the backward "
            "kernels wait for the training slice (ROADMAP, PyTorch/CUDA port)")
    D = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, not {D}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("kernel needs the head dim contiguous (stride 1)")
    B, T, H, _ = q.shape
    Tk = k.shape[1]
    if B * H > 65535:
        raise ValueError(f"kernel grid takes B*H <= 65535, not {B * H}")
    lib = kernels.load(KERNEL)
    fn = lib.flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), B, H, T, Tk, D, _DTYPES[q.dtype],
                  q.stride(0), q.stride(1), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2),
                  v.stride(0), v.stride(1), v.stride(2),
                  float(sm_scale), int(bool(causal)), stream)
    kernels.check(lib, KERNEL, code)
    kernels.LAUNCHES[KERNEL] += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None,
                    block_q: int | None = None, block_k: int | None = None):
    """q/k/v: [B, T, H, D] with equal head counts (GQA expanded upstream).

    The signature of the JAX ``flash_attention`` without ``interpret``.
    ``block_q``/``block_k`` keep its contract (explicit blocks must divide
    the sequence lengths, or this raises) but do not size the Hopper
    kernel, whose tiles are fixed for the card's shared memory."""
    T, Tk = q.shape[1], k.shape[1]
    if (block_q is not None and T % block_q) or (block_k is not None and Tk % block_k):
        raise ValueError(f"seq lens ({T},{Tk}) must divide blocks ({block_q},{block_k})")
    out, _ = flash_attention_forward(q, k, v, causal=causal, sm_scale=sm_scale)
    return out
