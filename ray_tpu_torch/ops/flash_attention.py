"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain versions.

Counterpart of ``ray_tpu/ops/flash_attention.py``. Its three Pallas TPU
kernels become CUDA C++ for sm_90a (bound with ctypes, built at first use
by ``kernels.load``):

- ``_fwd_kernel`` -> ``csrc/flash_attention_fwd.cu``
- ``_bwd_dq_kernel`` -> ``csrc/flash_attention_bwd_dq.cu``
- ``_bwd_dkv_kernel`` -> ``csrc/flash_attention_bwd_dkv.cu``

All three kernels run bf16 on the tensor cores (``csrc/flash_tc.cuh``) and
round p (and, in the backward, ds) to bf16 before the products that consume
them; float32 stays on FMA loops, never TF32. The bf16 bodies copy rows in
16-byte pieces with cp.async, so every q/k/v/dout row must start 16-byte
aligned: ``_fit`` copies an input that is not (or whose head dim is not
contiguous) before a launch, and the C launchers refuse one.

``flash_attention_plain`` and ``flash_attention_backward_plain`` compute the
same functions in plain PyTorch.

The forward and the backward are ``torch.library`` custom ops
(``ray_tpu_torch::flash_attention_fwd`` / ``flash_attention_bwd``), each with
the plain version as its CPU implementation and the kernel as its CUDA one,
joined by ``register_autograd`` as JAX joins them with ``custom_vjp``. Being
dispatcher ops (a ctypes launch alone is invisible to the dispatcher) lets
the selective-remat policy of ``ops/remat.py`` save the forward's outputs
instead of launching the forward again in the backward pass.

A CUDA tensor always goes through the kernels (or the call raises); a CPU
tensor goes through the plain versions. Nothing falls back from one to the
other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch import kernels

_NEG_BIG = -1e30
KERNEL = "flash_attention_fwd"
KERNEL_DQ = "flash_attention_bwd_dq"
KERNEL_DKV = "flash_attention_bwd_dkv"
_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                 + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_int,
                                              ctypes.c_void_p])
# q, k, v, dout, lse, delta, then the outputs (dq; or dk, dv)
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int,
                                              ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 8 + _DQ_ARGTYPES[7:])


def _causal_mask(T, Tk, device):
    """Top-left causal mask [T, Tk]: row >= col, also when T != Tk."""
    return (torch.arange(T, device=device)[:, None]
            >= torch.arange(Tk, device=device)[None, :])


def flash_attention_plain(q, k, v, *, causal: bool = True, sm_scale: float):
    """Plain PyTorch version of the forward kernel: float32 scores and
    softmax, causal top-left ``row >= col`` with fill -1e30 and masked
    probabilities zeroed, ``out = acc / max(l, 1e-30)`` in q's dtype and the
    slim ``lse = m + log(l)`` as [B*H, T] float32. q/k/v: [B, T, H, D]."""
    B, T, H, D = q.shape
    Tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = _causal_mask(T, Tk, q.device)
        s = s.masked_fill(~mask, _NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / denom.permute(0, 2, 1, 3)
    lse = (m + torch.log(denom))[..., 0].reshape(B * H, T)
    return out.to(q.dtype).contiguous(), lse.contiguous()


def flash_attention_delta(out, dout):
    """delta = rowsum(dO * O) as [B*H, T] float32, from the saved ``out`` in
    its own dtype upcast to float32 (JAX ``_flash_backward``, line 251)."""
    B, T, H, _ = out.shape
    d = (dout.float() * out.float()).sum(dim=-1)  # [B, T, H]
    return d.permute(0, 2, 1).reshape(B * H, T).contiguous()


def flash_attention_backward_plain(q, k, v, out, lse, dout, *, causal: bool,
                                   sm_scale: float):
    """Plain PyTorch version of the two backward kernels, in float32:
    ``p = exp(s * scale - lse)`` zeroed where masked, ``dp = dO vᵀ``,
    ``ds = p (dp - delta) scale``; ``dq = ds k``, ``dk = dsᵀ q``,
    ``dv = pᵀ dO``, each in its input's dtype. q/out/dout: [B, T, H, D];
    k/v: [B, Tk, H, D]; lse: [B*H, T] float32."""
    B, T, H, D = q.shape
    Tk = k.shape[1]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    if causal:
        p = torch.where(_causal_mask(T, Tk, q.device), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = flash_attention_delta(out, dout).reshape(B, H, T, 1)
    ds = p * (dp - delta) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


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


def _rows_aligned(x) -> bool:
    """Every [.., t, h, :] row of x starts on a 16-byte boundary, as the bf16
    kernels' 16-byte cp.async copies need."""
    return (x.data_ptr() % 16 == 0
            and all(s * x.element_size() % 16 == 0 for s in x.stride()[:3]))


def _fit(x):
    """x itself where the kernels can read it through its strides (head dim
    contiguous; for bf16, every row 16-byte aligned), else a fresh
    contiguous copy."""
    ok = x.stride(-1) == 1 and (x.dtype != torch.bfloat16 or _rows_aligned(x))
    # a fresh allocation: .contiguous() keeps a contiguous but offset view
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _check_kernel_inputs(*xs):
    """What every kernel takes: CUDA tensors on one device, float32 or
    bfloat16, head dim in {64, 128, 256} and contiguous, B*H within the
    grid's y limit. The C launchers refuse bf16 rows that are not 16-byte
    aligned (``_fit`` copies them first)."""
    q = xs[0]
    if q.device.type != "cuda" or any(x.device != q.device for x in xs):
        raise ValueError("kernel takes CUDA tensors on one device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, not {q.shape[-1]}")
    if any(x.stride(-1) != 1 for x in xs):
        raise ValueError("kernel needs the head dim contiguous (stride 1)")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"kernel grid takes B*H <= 65535, not {q.shape[0] * q.shape[2]}")


def _fn(name, argtypes):
    lib = kernels.load(name)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _strides(*xs):
    return [s for x in xs for s in (x.stride(0), x.stride(1), x.stride(2))]


def _launch_fwd(q, k, v, causal, sm_scale):
    """(out, lse) from the forward kernel; q/k/v are read through their
    strides where the kernel takes them, else copied first (``_fit``)."""
    q, k, v = map(_fit, (q, k, v))
    _check_kernel_inputs(q, k, v)
    B, T, H, D = q.shape
    Tk = k.shape[1]
    lib, fn = _fn(KERNEL, _FWD_ARGTYPES)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), B, H, T, Tk, D, _DTYPES[q.dtype],
                  *_strides(q, k, v), float(sm_scale), int(bool(causal)), stream)
    kernels.check(lib, KERNEL, code)
    kernels.count_launch(KERNEL, q.dtype)
    return out, lse


def _bwd_common(q, k, v, dout, lse, delta, causal, sm_scale):
    """The arguments the two backward kernels share, checked."""
    _check_kernel_inputs(q, k, v, dout)
    if dout.dtype != q.dtype:
        raise TypeError(f"dout {dout.dtype} must be {q.dtype}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("lse and delta must be float32")
    B, T, H, D = q.shape
    if lse.shape != (B * H, T) or delta.shape != (B * H, T):
        raise ValueError(f"lse/delta must be [B*H, T] = [{B * H}, {T}]")
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("lse and delta must be contiguous")
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (B, H, T, k.shape[1], D, _DTYPES[q.dtype], *_strides(q, k, v, dout),
             float(sm_scale), int(bool(causal))))


def launch_bwd_dq(q, k, v, dout, lse, delta, *, causal, sm_scale):
    """dq [B, T, H, D] in q's dtype from the dq kernel (CUDA tensors only);
    counts the launch in ``kernels.LAUNCHES``."""
    ins, common = _bwd_common(q, k, v, dout, lse, delta, causal, sm_scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib, fn = _fn(KERNEL_DQ, _DQ_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(*ins, dq.data_ptr(), *common, stream)
    kernels.check(lib, KERNEL_DQ, code)
    kernels.count_launch(KERNEL_DQ, q.dtype)
    return dq


def launch_bwd_dkv(q, k, v, dout, lse, delta, *, causal, sm_scale):
    """(dk, dv) [B, Tk, H, D] in k's dtype from the dk/dv kernel (CUDA
    tensors only); counts the launch in ``kernels.LAUNCHES``."""
    ins, common = _bwd_common(q, k, v, dout, lse, delta, causal, sm_scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib, fn = _fn(KERNEL_DKV, _DKV_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(*ins, dk.data_ptr(), dv.data_ptr(), *common, stream)
    kernels.check(lib, KERNEL_DKV, code)
    kernels.count_launch(KERNEL_DKV, q.dtype)
    return dk, dv


def _launch_bwd(q, k, v, out, lse, dout, causal, sm_scale):
    """dq from the dq kernel, dk/dv from the dkv kernel; q/k/v/dout are read
    through their strides where the kernels take them, else copied first
    (``_fit``)."""
    q, k, v, dout = map(_fit, (q, k, v, dout))
    if out.dtype != q.dtype:
        raise TypeError(f"out {out.dtype} must be {q.dtype}")
    delta = flash_attention_delta(out, dout)
    kw = dict(causal=causal, sm_scale=sm_scale)
    lse = lse.contiguous()
    dq = launch_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = launch_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


# ------------------------------------------------------------ custom ops
# Defined through torch.library's dispatcher API, not torch.library.custom_op:
# custom_op wraps each kernel in torch._disable_dynamo, whose first call in a
# process imports torch._dynamo (seconds, in every fresh worker).
_LIB = torch.library.Library("ray_tpu_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, float sm_scale)"
            " -> (Tensor, Tensor)")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
            "Tensor dout, bool causal, float sm_scale) -> (Tensor, Tensor, Tensor)")


def _fwd_cpu(q, k, v, causal, sm_scale):
    return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)


def _fwd_cuda(q, k, v, causal, sm_scale):
    return _launch_fwd(q, k, v, causal, sm_scale)


def _bwd_cpu(q, k, v, out, lse, dout, causal, sm_scale):
    return flash_attention_backward_plain(q, k, v, out, lse, dout, causal=causal,
                                          sm_scale=sm_scale)


def _bwd_cuda(q, k, v, out, lse, dout, causal, sm_scale):
    return _launch_bwd(q, k, v, out, lse, dout, causal, sm_scale)


_LIB.impl("flash_attention_fwd", _fwd_cpu, "CPU")
_LIB.impl("flash_attention_fwd", _fwd_cuda, "CUDA")
_LIB.impl("flash_attention_bwd", _bwd_cpu, "CPU")
_LIB.impl("flash_attention_bwd", _bwd_cuda, "CUDA")
_fwd_op = torch.ops.ray_tpu_torch.flash_attention_fwd.default
_bwd_op = torch.ops.ray_tpu_torch.flash_attention_bwd.default


def _setup_context(ctx, inputs, output):
    # JAX's _flash_fwd_rule residuals: (q, k, v, out, slim lse)
    q, k, v, causal, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.mark_non_differentiable(lse)


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _bwd_op(q, k, v, out, lse, dout, ctx.causal, ctx.sm_scale)
    return dq, dk, dv, None, None


torch.library.register_autograd("ray_tpu_torch::flash_attention_fwd", _backward,
                                setup_context=_setup_context, lib=_LIB)

# the op the remat policy saves (ops/remat.py)
FLASH_FWD_OP = _fwd_op


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            sm_scale: float | None = None):
    """(out [B, T, H, D], lse [B*H, T] float32) of q/k/v [B, T, H, D],
    differentiable in q/k/v through the backward kernels.

    On a CUDA tensor this launches the kernel, and counts the launch in
    ``kernels.LAUNCHES``; on a CPU tensor it runs the plain version."""
    _check_inputs(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _fwd_op(q, k, v, bool(causal), float(sm_scale))


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                             sm_scale: float | None = None):
    """(dq, dk, dv) of the forward's residuals and the output gradient.

    On a CUDA tensor this launches the dq and the dk/dv kernels, counting
    each launch in ``kernels.LAUNCHES``; on a CPU tensor it runs
    ``flash_attention_backward_plain``."""
    _check_inputs(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _bwd_op(q, k, v, out, lse, dout, bool(causal), float(sm_scale))


def flash_attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None,
                    block_q: int | None = None, block_k: int | None = None):
    """q/k/v: [B, T, H, D] with equal head counts (GQA expanded upstream).

    The signature of the JAX ``flash_attention`` without ``interpret``.
    ``block_q``/``block_k`` keep its contract (explicit blocks must divide
    the sequence lengths, or this raises) but do not size the Hopper
    kernels, whose tiles are fixed for the card's shared memory."""
    T, Tk = q.shape[1], k.shape[1]
    if (block_q is not None and T % block_q) or (block_k is not None and Tk % block_k):
        raise ValueError(f"seq lens ({T},{Tk}) must divide blocks ({block_q},{block_k})")
    out, _ = flash_attention_forward(q, k, v, causal=causal, sm_scale=sm_scale)
    return out
