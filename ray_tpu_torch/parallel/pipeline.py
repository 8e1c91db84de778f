"""Pipeline parallelism: a GPipe schedule over the ``pp`` mesh axis.

Counterpart of ``ray_tpu/parallel/pipeline.py``. JAX writes the schedule as
one ``lax.scan`` of M + n - 1 steps with a ``ppermute`` per step and gets
the backward pipeline from autodiff. Here each pp rank runs its own stage:
at step t stage s works on microbatch t - s, sends its output to stage
s + 1 and receives stage s - 1's, and the last stage records the finished
microbatch. The schedule is one ``autograd.Function`` whose backward runs
the same steps in reverse (the gradient of a stage's input goes to the
stage before), so every send meets its receive in a fixed order whatever
autograd does around it. Stages idle in the fill and drain steps compute
nothing (JAX computes and discards them).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.comm import (
    axis_index,
    axis_size,
    gather,
    replicate,
    send_recv,
    shard,
)


def _flatten(tree):
    """(leaves, rebuild) of a nested dict of tensors (or one tensor)."""
    if not isinstance(tree, dict):
        return [tree], lambda leaves: leaves[0]
    keys, parts = list(tree), []
    for key in keys:
        parts.append(_flatten(tree[key]))

    def rebuild(leaves):
        out, i = {}, 0
        for key, (sub, sub_rebuild) in zip(keys, parts):
            out[key] = sub_rebuild(leaves[i:i + len(sub)])
            i += len(sub)
        return out

    return [leaf for sub, _ in parts for leaf in sub], rebuild


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, rebuild, mesh, axis_name, track, x_micro, *leaves):
        n, my = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
        M = x_micro.shape[0]
        ctx.meta = (mesh, axis_name, n, my, M)
        steps, outputs, state = {}, [], None
        with torch.set_grad_enabled(track):
            xs = x_micro.detach().requires_grad_(track and x_micro.requires_grad)
            params = [p.detach().requires_grad_(track and p.requires_grad) for p in leaves]
            tree = rebuild(params)
            for t in range(M + n - 1):
                m, out = t - my, None
                if 0 <= m < M:
                    # stage 0 ingests microbatch m; the others take what arrived
                    inp = xs[m] if my == 0 else state.requires_grad_(track)
                    out = stage_fn(tree, inp)
                    if out.shape != x_micro.shape[1:] or out.dtype != x_micro.dtype:
                        raise ValueError(
                            f"a stage maps {tuple(x_micro.shape[1:])} {x_micro.dtype} to "
                            f"{tuple(out.shape)} {out.dtype}: stages must keep shape and dtype")
                    steps[m] = (inp, out)
                    if my == n - 1:
                        outputs.append(out.detach())
                if n > 1:  # send to the next stage; receive from the one before
                    recv = 0 <= t - (my - 1) < M and my > 0
                    state = send_recv(out.detach() if out is not None and my < n - 1 else None,
                                      mesh, axis_name, 1, like=x_micro[0] if recv else None)
        ctx.steps, ctx.xs, ctx.params = steps, xs, params
        result = torch.stack(outputs) if my == n - 1 else torch.empty_like(x_micro)
        if n > 1:  # broadcast the last stage's outputs to every stage
            group = mesh.get_group(axis_name)
            dist.broadcast(result, dist.get_global_rank(group, n - 1), group=group)
        return result

    @staticmethod
    def backward(ctx, grad):
        mesh, axis_name, n, my, M = ctx.meta
        xs, params = ctx.xs, ctx.params
        want = [p for p in params if p.requires_grad]
        gx = torch.zeros_like(xs)
        gp = [torch.zeros_like(p) for p in want]
        carry = None  # gradient of my output at this step, from the next stage
        for t in reversed(range(M + n - 1)):
            m, g_in = t - my, None
            if 0 <= m < M:
                inp, out = ctx.steps.pop(m)
                g_out = grad[m] if my == n - 1 else carry
                wrt = [inp] + want if inp.requires_grad else want
                got = torch.autograd.grad(out, wrt, g_out, allow_unused=True) if wrt else ()
                if inp.requires_grad:
                    g_in, got = got[0], got[1:]
                    if g_in is None:  # the stage ignores its input
                        g_in = torch.zeros_like(inp)
                for acc, g in zip(gp, got):
                    if g is not None:
                        acc += g
                if my == 0 and g_in is not None:
                    gx[m] = g_in
            if n > 1:  # to the stage before; receive from the one after
                recv = 0 <= t - (my + 1) < M and my < n - 1
                carry = send_recv(g_in if my > 0 else None, mesh, axis_name, -1,
                                  like=grad[0] if recv else None)
        if n > 1 and ctx.needs_input_grad[5]:
            # the input is replicated over the stages: each gets its gradient
            group = mesh.get_group(axis_name)
            dist.broadcast(gx, dist.get_global_rank(group, 0), group=group)
        it = iter(gp)
        grads = [next(it) if p.requires_grad else None for p in params]
        return (None, None, None, None, None, gx if ctx.needs_input_grad[5] else None, *grads)


def pipeline_spmd_local(stage_fn, stage_params, x_micro, *, mesh, axis_name: str = "pp"):
    """Per-rank GPipe loop over axis ``axis_name`` of ``mesh``.

    stage_fn: (params, activation [B, ...]) -> activation of the same shape
        and dtype
    stage_params: this stage's params (a nested dict of tensors)
    x_micro: [M, B, ...] microbatched input (the same on every stage; only
        stage 0 consumes it)
    Returns [M, B, ...] outputs of the LAST stage, on every stage.
    """
    leaves, rebuild = _flatten(stage_params)
    track = torch.is_grad_enabled() and (
        x_micro.requires_grad or any(p.requires_grad for p in leaves))
    return _GPipe.apply(stage_fn, rebuild, mesh, axis_name, track, x_micro, *leaves)


def _local_param(p, spec, mesh, batch_axis):
    """This rank's part of a stacked leaf under ``spec`` (a per-dimension
    tuple of axis names); replicated over ``batch_axis``, whose ranks see
    other data."""
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                p = shard(p, dim, mesh, name)
    return replicate(p, mesh, batch_axis) if batch_axis else p


def pipeline_apply(stage_fn, stacked_params, x, mesh, *, n_microbatches: int,
                   axis_name: str = "pp", batch_axis: str | None = None,
                   param_specs=None):
    """Run a GPipe pipeline over ``mesh``'s ``axis_name``.

    stacked_params: pytree whose leaves have a leading stage axis of size
        n_stages (see stack_stage_params), the same on every rank; each
        stage takes its slice.
    x: [B_total, ...] input batch, the same on every rank.
    batch_axis: optional mesh axis to split the WITHIN-microbatch batch dim
        over (dp): pp x dp, each dp slice runs its own pipeline instance.
    param_specs: optional per-leaf spec tuples whose FIRST entry is
        ``axis_name`` — tp-sharded weight specs run tensor parallelism INSIDE
        each stage (stage_fn then makes the matching sums).
    Returns [B_total, ...] final-stage outputs on every rank; gradients reach
    every rank's whole ``stacked_params`` and ``x``.
    """
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} microbatches")
    x_micro = x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])
    if batch_axis:
        x_micro = shard(x_micro, 1, mesh, batch_axis)
    if param_specs is None:
        param_specs = _map(lambda _: (axis_name,), stacked_params)
    local = _map(lambda p, spec: _local_param(p, spec, mesh, batch_axis).squeeze(0),
                 stacked_params, param_specs)
    out = pipeline_spmd_local(stage_fn, local, x_micro, mesh=mesh, axis_name=axis_name)
    if batch_axis:
        out = gather(out, 1, mesh, batch_axis)
    return out.reshape(B, *out.shape[2:])


def stack_stage_params(per_stage_params: list):
    """[stage0_tree, stage1_tree, ...] -> one tree with leading stage axis."""
    return _map(lambda *xs: torch.stack(xs), *per_stage_params)
