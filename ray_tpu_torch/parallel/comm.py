"""Collectives over one named axis of a ``DeviceMesh``, with autograd.

The JAX package writes its parallel layer in the global view: arrays carry
a sharding and ``shard_map`` bodies call ``lax.psum``/``ppermute``/
``all_to_all`` by axis name. The port runs one process per mesh position
and calls these functions on the rank's local tensors instead.

Gradient convention: every rank of a group runs the same program, and what
follows a collective is replicated over that group's axis (each rank
computes the same loss and calls ``backward`` on it). So

- ``shard``     global -> this rank's chunk; backward all-gathers the chunk
                grads, so a replicated input gets its whole gradient;
- ``gather``    chunks -> global; backward keeps this rank's chunk;
- ``gather_sum`` chunks -> global; backward reduce-scatters (sums the
                gradient over the group, then keeps this rank's chunk): an
                fsdp weight gathered before use by ranks that hold
                different tokens;
- ``psum``      sum of per-rank partials (``lax.psum``); backward passes
                the gradient through (Megatron's "g");
- ``replicate`` identity; backward sums the gradient over the group, for a
                replicated tensor used by per-rank partial work (Megatron's
                "f", data-parallel weights);
- ``all_to_all`` and ``ppermute`` are permutations: backward runs the
                inverse permutation.

Every function is the identity on an axis of size 1 (or ``mesh=None``) and
issues no collective there. Backward collectives run in the order autograd
visits them, which is the same on every rank because every rank builds the
same graph.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(mesh, name) -> int:
    """Size of mesh axis ``name`` (1 for ``mesh=None`` or an absent axis)."""
    if mesh is None or name is None:
        return 1
    # read once per mesh: DeviceMesh.shape is recomputed on every access in
    # some torch versions, and every collective of a step asks for it
    sizes = getattr(mesh, "_rt_axis_sizes", None)
    if sizes is None:
        sizes = dict(zip(mesh.mesh_dim_names or (), mesh.shape))
        mesh._rt_axis_sizes = sizes
    return sizes.get(name, 1)


def axis_index(mesh, name) -> int:
    """This rank's coordinate on mesh axis ``name`` (``lax.axis_index``)."""
    return mesh.get_local_rank(name) if axis_size(mesh, name) > 1 else 0


def _empty(x):
    # dense, whatever x's strides (empty_like would keep a permuted layout)
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _all_gather(x, dim, mesh, name):
    parts = [_empty(x) for _ in range(axis_size(mesh, name))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(name))
    return torch.cat(parts, dim=dim)


def _chunk(x, dim, mesh, name):
    n = axis_size(mesh, name)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over "
                         f"{n} ranks of axis {name!r}")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, name) * size, size)


def _all_reduce(x, mesh, name):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=mesh.get_group(name))
    return x


def _reduce_scatter(x, dim, mesh, name):
    """The sum of ``x`` over axis ``name``, this rank's chunk of ``dim``.
    NCCL reduce-scatters; gloo (which has no reduce-scatter on CUDA
    tensors, nor on the CPU in some torch versions) all-reduces and
    keeps the chunk."""
    group = mesh.get_group(name)
    if x.is_cuda and "nccl" in str(dist.get_backend(group)):
        n = axis_size(mesh, name)
        full = x.movedim(dim, 0).contiguous()
        out = torch.empty((full.shape[0] // n, *full.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, full, group=group)
        return out.movedim(0, dim).contiguous()
    return _chunk(_all_reduce(x, mesh, name), dim, mesh, name).contiguous()


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, name):
        ctx.args = (dim, mesh, name)
        return _chunk(x, dim, mesh, name).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, name):
        ctx.args = (dim, mesh, name)
        return _all_gather(x, dim, mesh, name)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, *ctx.args).contiguous(), None, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, name):
        ctx.args = (dim, mesh, name)
        return _all_gather(x, dim, mesh, name)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name):
        return _all_reduce(x, mesh, name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.args = (mesh, name)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, *ctx.args), None, None


def _a2a(x, mesh, name):
    out = _empty(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.get_group(name))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.args = (mesh, name)
        return _a2a(x, mesh, name)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None


def send_recv(x, mesh, name, shift: int, like=None):
    """Send ``x`` (or nothing, for ``None``) to the rank ``shift`` places up
    the axis and receive from ``shift`` places down into a tensor shaped
    like ``like`` (or nothing, for ``like=None``). No autograd."""
    n, me = axis_size(mesh, name), axis_index(mesh, name)
    group = mesh.get_group(name)
    ops, out = [], None
    if x is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, (me + shift) % n), group=group))
    if like is not None:
        out = _empty(like)
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, (me - shift) % n), group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, shift):
        ctx.args = (mesh, name, shift)
        return send_recv(x, mesh, name, shift, like=x)

    @staticmethod
    def backward(ctx, g):
        mesh, name, shift = ctx.args
        return send_recv(g, mesh, name, -shift, like=g), None, None, None


def shard(x, dim: int, mesh, name):
    """This rank's contiguous chunk of ``x`` along ``dim`` over axis ``name``."""
    return x if axis_size(mesh, name) == 1 else _Shard.apply(x, dim, mesh, name)


def gather(x, dim: int, mesh, name):
    """The chunks of axis ``name`` concatenated along ``dim`` in rank order."""
    return x if axis_size(mesh, name) == 1 else _Gather.apply(x, dim, mesh, name)


def gather_sum(x, dim: int, mesh, name):
    """``gather``'s forward; its backward sums the gradient over axis
    ``name`` before keeping this rank's chunk (a reduce-scatter)."""
    return x if axis_size(mesh, name) == 1 else _GatherSum.apply(x, dim, mesh, name)


def psum(x, mesh, name):
    """Sum of ``x`` over axis ``name`` (``lax.psum``)."""
    return x if axis_size(mesh, name) == 1 else _Psum.apply(x, mesh, name)


def replicate(x, mesh, name):
    """``x`` unchanged; its gradient is summed over axis ``name``."""
    return x if axis_size(mesh, name) == 1 else _Replicate.apply(x, mesh, name)


def all_to_all(x, mesh, name):
    """``x`` [n, ...]: slice j goes to rank j of axis ``name``; the result's
    slice j came from rank j (``lax.all_to_all`` on a leading axis)."""
    return x if axis_size(mesh, name) == 1 else _AllToAll.apply(x, mesh, name)


def ppermute(x, mesh, name, shift: int = 1):
    """``x`` from the rank ``shift`` places down axis ``name`` (a ring)."""
    return x if axis_size(mesh, name) == 1 else _Ppermute.apply(x, mesh, name, shift)
