"""Ring attention: exact attention over a sequence-sharded mesh axis.

Counterpart of ``ray_tpu/parallel/ring_attention.py``. Each rank of the
``sp`` axis holds one sequence chunk of q/k/v; the k/v chunks travel round
the ring (``comm.ppermute``, a send/recv pair whose backward sends the
gradient the other way) while each rank accumulates its queries' output by
the online softmax in float32, so no rank holds more than T/n keys.

Layout: [batch, seq, heads, head_dim], sequence sharded on sp.
"""
from __future__ import annotations

import math

import torch

from ray_tpu_torch.parallel.comm import axis_index, axis_size, gather, ppermute, shard

_NEG_BIG = -1e30
_BATCH_AXES = ("dp", "fsdp")


def ring_attention_local(q, k, v, *, mesh, axis_name: str = "sp", causal: bool = True,
                         sm_scale: float | None = None):
    """Per-rank body: q, k, v [B, t, H, D] are this rank's chunks (t = T / ring
    size) on axis ``axis_name`` of ``mesh``. Returns [B, t, H, D]."""
    n, my = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    B, t, H, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q_pos = my * t + torch.arange(t, device=q.device)  # global positions of my queries

    m = torch.full((B, H, t), _NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, t, H, D), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])  # one hop a step carries both
    for s in range(n):
        k_cur, v_cur = kv[0], kv[1]
        src = (my - s) % n  # which rank this k/v chunk started on
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cur) * scale
        if causal:
            k_pos = src * t + torch.arange(t, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]  # [1, 1, tq, tk]
            scores = scores.masked_fill(~mask, _NEG_BIG)
        m_new = torch.maximum(m, scores.amax(dim=-1).float())
        p = torch.exp(scores.float() - m_new[..., None])
        if causal:
            p = p.masked_fill(~mask, 0.0)  # kill fully-masked rows
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1)
        o = o * correction.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v_cur.float())
        m = m_new
        if s < n - 1:  # the last hop would only bring my own chunk back
            kv = ppermute(kv, mesh, axis_name)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def shard_sequence(x, mesh, axis_name):
    """[B, T, ...] global -> this rank's [B/(dp*fsdp), T/sp, ...] chunk."""
    for ax in _BATCH_AXES:
        x = shard(x, 0, mesh, ax)
    return shard(x, 1, mesh, axis_name)


def gather_sequence(x, mesh, axis_name):
    """Inverse of ``shard_sequence``: the global tensor on every rank."""
    x = gather(x, 1, mesh, axis_name)
    for ax in reversed(_BATCH_AXES):
        x = gather(x, 0, mesh, ax)
    return x


def ring_attention(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = True,
                   sm_scale: float | None = None):
    """Global entry point: q/k/v [B, T, H, D] the same on every rank; T is
    split over ``axis_name`` and the batch over the data axes (dp, fsdp).
    Returns the whole [B, T, H, D] on every rank."""
    q, k, v = (shard_sequence(x, mesh, axis_name) for x in (q, k, v))
    out = ring_attention_local(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal,
                               sm_scale=sm_scale)
    return gather_sequence(out, mesh, axis_name)


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
