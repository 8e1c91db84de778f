"""Ulysses-style sequence parallelism: all_to_all head/sequence re-sharding.

Counterpart of ``ray_tpu/parallel/ulysses.py``: inputs arrive
sequence-sharded [B, T/n, H, D]; one all_to_all re-shards them to
head-sharded full sequences [B, T, H/n, D]; exact attention runs locally per
head group; a second all_to_all restores sequence sharding.
"""
from __future__ import annotations

import torch

from ray_tpu_torch.parallel.comm import all_to_all, axis_size
from ray_tpu_torch.parallel.ring_attention import (
    gather_sequence,
    reference_attention,
    shard_sequence,
)


def ulysses_attention_local(q, k, v, *, mesh, axis_name: str = "sp", causal: bool = True,
                            sm_scale: float | None = None):
    """Per-rank body: q/k/v [B, t, H, D] this rank's sequence chunk, H % n == 0."""
    n = axis_size(mesh, axis_name)
    B, t, H, D = q.shape
    if H % n:
        raise ValueError(f"{H} heads do not split over {n} ranks of axis {axis_name!r}")

    def seq_to_heads(x):
        # [3, B, t, H, D] -> head group j to rank j -> [3, B, T, H/n, D]
        x = x.reshape(3, B, t, n, H // n, D).permute(3, 0, 1, 2, 4, 5)
        x = all_to_all(x.contiguous(), mesh, axis_name)  # [src chunk, 3, B, t, H/n, D]
        return x.permute(1, 2, 0, 3, 4, 5).reshape(3, B, n * t, H // n, D)

    def heads_to_seq(x):
        x = x.reshape(B, n, t, H // n, D).permute(1, 0, 2, 3, 4)
        x = all_to_all(x.contiguous(), mesh, axis_name)  # [src head group, B, t, H/n, D]
        return x.permute(1, 2, 0, 3, 4).reshape(B, t, H, D)

    qh, kh, vh = seq_to_heads(torch.stack([q, k, v]))  # one exchange for the three
    out = reference_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return heads_to_seq(out.to(q.dtype))


def ulysses_attention(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = True,
                      sm_scale: float | None = None):
    """Global entry point: q/k/v [B, T, H, D] the same on every rank; returns
    the whole [B, T, H, D] on every rank."""
    q, k, v = (shard_sequence(x, mesh, axis_name) for x in (q, k, v))
    out = ulysses_attention_local(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal,
                                  sm_scale=sm_scale)
    return gather_sequence(out, mesh, axis_name)
