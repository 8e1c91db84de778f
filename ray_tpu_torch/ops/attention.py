"""Attention dispatch: one entry point, backend picked by shape and device.

Counterpart of ``ray_tpu/ops/attention.py``:

- plain exact attention (``parallel.ring_attention.reference_attention``)
- the hand-written flash forward kernel (``ops/flash_attention.py``) for
  long T on a CUDA tensor
- ring / ulysses sequence parallelism wait for the parallel slice
"""
from __future__ import annotations

from ray_tpu_torch.parallel.ring_attention import reference_attention


def attention(q, k, v, *, causal: bool = True, sm_scale=None, mesh=None,
              seq_axis: str | None = None, impl: str = "auto"):
    """q/k/v: [B, T, H, D] (kv may have fewer heads — GQA repeat here).

    impl: auto | plain | flash | ring | ulysses
    """
    if k.shape[2] != q.shape[2]:  # grouped-query: repeat kv heads
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    if impl == "auto":
        if mesh is not None and seq_axis and mesh.shape.get(seq_axis, 1) > 1:
            impl = "ring"
        else:
            impl = _default_local_impl(q)

    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention impl {impl!r} waits for the parallel slice "
            "(ROADMAP, PyTorch/CUDA port: MoE and the parallel variants)")
    if impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r}")
    return reference_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def _default_local_impl(q) -> str:
    B, T, H, D = q.shape
    if q.is_cuda and T >= 1024 and T % 512 == 0 and D in (64, 128, 256):
        return "flash"
    return "plain"
