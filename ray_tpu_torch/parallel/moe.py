"""Mixture-of-experts: Switch-style top-1 routing and the expert FFN.

Counterpart of ``ray_tpu/parallel/moe.py``: a capacity-bounded one-hot
dispatch tensor routes tokens to experts, and einsums dispatch and combine.
The dtypes are JAX's: the one-hots, cumsum and dispatch are float32, so
bf16 tokens meet float32 ``dispatch`` and the expert products run in
float32, and the block's output is float32.

With ``ep > 1`` each ep rank holds E/ep experts and a share of the tokens
(a sharded Llama forward also splits sequences over ``sp``). Routing keeps
the unsharded semantics: a token's place in its expert's queue counts every
earlier token in the global (batch, sequence) order, once, so the same
tokens are dropped as with ``mesh=None``. ``expert_in`` goes to
the experts' ranks by ``all_to_all`` and ``expert_out`` comes back the
same way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.comm import (
    all_to_all,
    axis_index,
    axis_size,
    gather,
    psum,
    replicate,
    shard,
)


def _einsum(eq, a, b):
    """``einsum`` with JAX's promotion of mixed float operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def top1_gating(logits, n_experts: int, capacity: int, *, queue_offset=None,
                total=None):
    """Switch-style top-1 routing with capacity dropping.

    logits: [tokens, E]. Returns (dispatch [T, E, C] one-hot float32,
    combine [T, E, C] weights, aux_loss scalar).

    For a shard of a larger batch: ``queue_offset(one_hot)`` gives [rows,
    E], the tokens routed to each expert ahead of each of ``rows`` equal,
    consecutive runs of ``logits``' tokens in the global order (default: one
    run, nothing ahead), and ``total(x)`` sums ``x`` over the ranks holding
    the other tokens (default: the identity), for the aux loss of the whole
    batch."""
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)  # the first maximum, as jnp.argmax
    gate = torch.gather(probs, -1, expert_idx[:, None])[:, 0]
    one_hot = F.one_hot(expert_idx, n_experts).float()  # [T, E]
    # position of each token within its expert's queue
    offset = queue_offset(one_hot) if queue_offset else one_hot.new_zeros(1, n_experts)
    runs = one_hot.reshape(offset.shape[0], -1, n_experts)
    pos_in_expert = (torch.cumsum(runs, dim=1) - 1.0 + offset[:, None]).reshape(one_hot.shape)
    pos_in_expert = pos_in_expert * one_hot
    keep = (pos_in_expert < capacity) & (one_hot > 0)
    pos = pos_in_expert.to(torch.int32)
    slots = torch.arange(capacity, device=logits.device, dtype=torch.int32)
    dispatch = (keep[..., None] & (pos[..., None] == slots)).float()  # [T, E, C]
    combine = dispatch * gate[:, None, None]

    # load-balancing auxiliary loss (Switch Transformer eq. 4)
    total = total or (lambda x: x)
    counts = total(one_hot.sum(dim=0))
    n = counts.sum()  # every token goes to one expert
    density, density_proxy = counts / n, total(probs.sum(dim=0)) / n
    aux_loss = (density * density_proxy).sum() * n_experts
    return dispatch, combine, aux_loss


def _experts(expert_in, w_up, w_down):
    h = F.silu(_einsum("ecd,edf->ecf", expert_in, w_up))
    return _einsum("ecf,efd->ecd", h, w_down)


def _queue_offset(one_hot, b, t, mesh, ep_axis, seq_axis):
    """[b, E]: tokens routed to each expert before each local batch row's
    sequence chunk, in the global order (batch rows split over ``ep_axis``,
    sequences over ``seq_axis``)."""
    counts = one_hot.reshape(b, t, -1).sum(dim=1)  # [b, E] per local row
    counts = gather(counts[None], 0, mesh, seq_axis)  # [S, b, E]
    counts = gather(counts[None], 0, mesh, ep_axis)  # [P, S, b, E]
    P, S, _, E = counts.shape
    ordered = counts.permute(0, 2, 1, 3).reshape(-1, E)  # global (row, chunk) order
    before = (torch.cumsum(ordered, dim=0) - ordered).reshape(P, b, S, E)
    return before[axis_index(mesh, ep_axis), :, axis_index(mesh, seq_axis)]


def moe_ffn_local(x, gate_w, w_up, w_down, *, capacity: int, mesh=None, ep_axis: str = "ep",
                  seq_axis: str | None = None):
    """Per-rank MoE FFN. x [b, t, D] is this rank's tokens: batch rows split
    over ``ep_axis`` and, with ``seq_axis``, sequences over that axis;
    w_up [E/ep, D, F] and w_down [E/ep, F, D] are this rank's experts;
    ``capacity`` is the per-expert capacity of the whole batch. Returns this
    rank's [b, t, D] output and the aux loss of the whole batch. With
    ``mesh=None`` it is the unsharded block."""
    b, t, D = x.shape
    E = gate_w.shape[-1]
    n_ep = axis_size(mesh, ep_axis)
    tokens = x.reshape(b * t, D)
    logits = _einsum("td,de->te", tokens, gate_w)
    dispatch, combine, aux = top1_gating(
        logits, E, capacity,
        queue_offset=lambda oh: _queue_offset(oh, b, t, mesh, ep_axis, seq_axis),
        total=lambda s: psum(psum(s, mesh, ep_axis), mesh, seq_axis))

    expert_in = _einsum("tec,td->ecd", dispatch, tokens)  # my tokens' share, all experts
    C = expert_in.shape[1]
    # expert group j to ep rank j; my experts' slots summed over the senders
    expert_in = all_to_all(expert_in.reshape(n_ep, E // n_ep, C, D), mesh, ep_axis).sum(0)
    expert_out = _experts(expert_in, w_up, w_down)  # [E/ep, C, D]
    # every rank gets every expert's output back
    expert_out = all_to_all(expert_out[None].expand(n_ep, *expert_out.shape).contiguous(),
                            mesh, ep_axis).reshape(E, C, D)
    out = _einsum("tec,ecd->td", combine, expert_out)
    return out.reshape(b, t, D), aux


def moe_ffn(x, gate_w, w_up, w_down, *, capacity_factor: float = 1.25,
            mesh=None, ep_axis: str = "ep"):
    """Expert FFN block.

    x: [B, T, D]; gate_w: [D, E]; w_up: [E, D, F]; w_down: [E, F, D], all
    the same on every rank. With ``ep`` > 1 on ``mesh`` the B*T tokens (in
    order) and the experts are split over the ep ranks; the result is the
    whole [B, T, D] (and aux) on every rank, equal to ``mesh=None``'s."""
    B, T, D = x.shape
    E = gate_w.shape[-1]
    capacity = max(1, int(capacity_factor * (B * T) / E))
    # one "row" per rank: its contiguous run of the flattened tokens
    out, aux = moe_ffn_local(
        shard(x.reshape(B * T, D), 0, mesh, ep_axis)[None],
        replicate(gate_w, mesh, ep_axis),
        shard(w_up, 0, mesh, ep_axis), shard(w_down, 0, mesh, ep_axis),
        capacity=capacity, mesh=mesh, ep_axis=ep_axis)
    return gather(out[0], 0, mesh, ep_axis).reshape(B, T, D), aux
