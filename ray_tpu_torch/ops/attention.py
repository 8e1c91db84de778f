"""Attention dispatch: one entry point, backend picked by mesh, shape and device.

Counterpart of ``ray_tpu/ops/attention.py``:

- plain exact attention (``parallel.ring_attention.reference_attention``)
- the hand-written flash forward kernel (``ops/flash_attention.py``) for
  long T on a CUDA tensor
- ring attention over the sp mesh axis when the sequence is sharded
- the Ulysses all-to-all variant for head-divisible meshes
"""
from __future__ import annotations

from ray_tpu_torch.parallel.comm import axis_size
from ray_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
    ring_attention_local,
)
from ray_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_attention_local


def _repeat_kv(q, k, v):
    if k.shape[2] != q.shape[2]:  # grouped-query: repeat kv heads
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def attention(q, k, v, *, causal: bool = True, sm_scale=None, mesh=None,
              seq_axis: str | None = None, impl: str = "auto"):
    """q/k/v: [B, T, H, D] (kv may have fewer heads — GQA repeat here).

    impl: auto | plain | flash | ring | ulysses. ring and ulysses take the
    whole q/k/v on every rank of ``mesh`` and return the whole output.
    """
    k, v = _repeat_kv(q, k, v)

    if impl == "auto":
        if mesh is not None and seq_axis and axis_size(mesh, seq_axis) > 1:
            impl = "ring"
        else:
            impl = _default_local_impl(q)

    if impl == "ring":
        return ring_attention(q, k, v, mesh, axis_name=seq_axis or "sp",
                              causal=causal, sm_scale=sm_scale)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, mesh, axis_name=seq_axis or "sp",
                                 causal=causal, sm_scale=sm_scale)
    if impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r}")
    return reference_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def sequence_attention(q, k, v, *, mesh, seq_axis: str, causal: bool = True,
                       sm_scale=None, impl: str = "auto"):
    """Attention of this rank's sequence chunk, q/k/v [B, T/sp, H, D], over
    the whole sequence split on ``seq_axis``: ring (``auto``/``ring``) or
    Ulysses. The other impls need the whole sequence on one rank."""
    k, v = _repeat_kv(q, k, v)
    if impl in ("auto", "ring"):
        fn = ring_attention_local
    elif impl == "ulysses":
        fn = ulysses_attention_local
    else:
        raise ValueError(f"attention impl {impl!r} cannot run on a sequence shard; "
                         "use ring or ulysses")
    return fn(q, k, v, mesh=mesh, axis_name=seq_axis, causal=causal, sm_scale=sm_scale)


def _default_local_impl(q) -> str:
    B, T, H, D = q.shape
    if q.is_cuda and T >= 1024 and T % 512 == 0 and D in (64, 128, 256):
        return "flash"
    return "plain"
