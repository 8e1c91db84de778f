"""Collectives between processes on ``torch.distributed``.

``TorchCollectiveGroup`` stands in for both of the JAX package's groups:
``XlaCollectiveGroup`` (``ray_tpu/collective/xla_group.py``: collectives
over the chips, here NCCL over the cards) and the actor-coordinated
``CpuCollectiveGroup`` (``cpu_group.py``, here gloo between CPU processes).
Its semantics are JAX's:

- ``allgather`` stacks the ranks' values on a new axis 0;
- ``reducescatter`` reduces, then returns this rank's equal chunk of axis 0;
- ``MEAN`` is the sum over the ranks divided by their count (a float
  result, as ``jnp.mean``), ``PRODUCT`` the product;
- values may be numpy arrays (or scalars) or tensors, and come back in the
  form they went in: numpy in gives numpy out.

The group joins (or starts) the process's default group. It starts one
through the caller's ``init_method`` (e.g. ``file://<dir>/rdzv``) when
given, else through the GCS KV of the port's runtime
(``maybe_init_distributed``, the counterpart of JAX's in
``xla_group.py``): rank 0 binds a ``TCPStore`` to port 0, so the kernel
picks a port no other process holds and no "free port" is probed and
bound later (a race between concurrent groups), then publishes the
store's address under ``collective:<group>:coordinator``; the other ranks
poll for it and connect, and rank 0 deletes the key once all have. Unlike
a file store, this needs no filesystem that every rank shares. NCCL
moves CUDA tensors (numpy goes through this process's card); gloo moves
host tensors, so a CUDA tensor given to a gloo group is staged through
host memory and put back on its card.
"""
from __future__ import annotations

import datetime
import functools
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.collective.communicator import Communicator
from ray_tpu_torch.collective.types import Backend, ReduceOp

_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
        ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
        ReduceOp.MEAN: dist.ReduceOp.SUM}  # MEAN: the sum, divided afterwards
# send/recv/broadcast header: [ndim, dtype code, numpy?, dims...]
_MAX_DIMS = 8
_DTYPES = [torch.float32, torch.float64, torch.int32, torch.int64, torch.uint8, torch.bool,
           torch.float16, torch.bfloat16, torch.int16, torch.int8, torch.complex64]


COORDINATOR_NS = "collective"
# a store key each rank > 0 sets once connected (init_process_group's own
# keys sit under a prefix, so these never meet them)
_JOINED = "rendezvous/joined/{}"


def coordinator_key(group_name: str) -> str:
    """The GCS KV key (in namespace ``COORDINATOR_NS``) of a group's
    coordinator address, JAX's key."""
    return f"collective:{group_name}:coordinator"


def maybe_init_distributed(gcs_call: Callable, group_name: str, world_size: int, rank: int,
                           backend: str, host: str, timeout_s: float = 60.0) -> None:
    """Start this process's default group through the GCS KV, unless one
    exists. Rank 0 binds a ``TCPStore`` on ``host`` (the address the
    runtime uses for this node) at a port the kernel picks, and publishes
    ``host:port``; the others poll the key every 0.1 s for up to
    ``timeout_s`` (``TimeoutError`` after) and connect to it. Rank 0
    deletes the key once every rank has connected (waiting up to
    ``timeout_s``), so the name can be met under again. Then
    ``torch.distributed`` starts on the store (NCCL or gloo).
    ``gcs_call(method, payload)`` is a synchronous GCS call."""
    if dist.is_initialized():
        return
    key = coordinator_key(group_name)
    connect = datetime.timedelta(seconds=timeout_s)
    if rank == 0:
        store = dist.TCPStore(host, 0, world_size, is_master=True, wait_for_workers=False,
                              timeout=connect)
        gcs_call("kv_put", {"ns": COORDINATOR_NS, "key": key,
                            "value": f"{host}:{store.port}".encode()})
        # once every rank holds the store, the address goes: a later group
        # of the same name must never read this one's (closed) port
        store.wait([_JOINED.format(r) for r in range(1, world_size)], connect)
        gcs_call("kv_del", {"ns": COORDINATOR_NS, "key": key})
    else:
        deadline = time.monotonic() + timeout_s
        addr = None
        while time.monotonic() < deadline:
            raw = gcs_call("kv_get", {"ns": COORDINATOR_NS, "key": key})
            if raw:
                addr = raw.decode()
                break
            time.sleep(0.1)
        if addr is None:
            raise TimeoutError(f"collective coordinator address of group {group_name!r} "
                               f"never appeared (waited {timeout_s} s)")
        coord_host, port = addr.rsplit(":", 1)
        store = dist.TCPStore(coord_host, int(port), world_size, is_master=False,
                              timeout=connect)
        store.set(_JOINED.format(rank), b"1")
    # connecting waits timeout_s; the group's own waits (a rank that
    # reaches its first collective late) get torch's default
    store.set_timeout(dist.default_pg_timeout)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


class TorchCollectiveGroup(Communicator):
    """One group over every rank of the world (``world_size`` processes).
    ``rendezvous_s``: the seconds ``init_collective_group`` took to start
    the default group (None when it joined one that existed)."""

    def __init__(self, world_size: int, rank: int, group_name: str,
                 backend: str = Backend.NCCL, init_method: str | None = None):
        super().__init__(world_size, rank, group_name)
        if backend not in (Backend.NCCL, Backend.GLOO):
            raise ValueError(f"unknown collective backend {backend!r}")
        self.rendezvous_s = None  # set by init_collective_group when it starts the world
        if not dist.is_initialized():
            if init_method is None:
                raise ValueError("no default process group: pass init_method "
                                 "(e.g. 'file://<dir>/rdzv') or start the runtime "
                                 "(ray_tpu_torch.init) to meet through its GCS")
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=world_size)
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise ValueError(f"rank {rank} of {world_size} asked, the process is rank "
                             f"{dist.get_rank()} of {dist.get_world_size()}")
        self._backend = backend
        self._group = (None if backend in str(dist.get_backend())
                       else dist.new_group(backend=backend))
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if backend == Backend.NCCL else torch.device("cpu"))

    # ------------------------------------------------------------------ util
    def _stage(self, value):
        """(a tensor on this group's device that the collective may
        overwrite, the function that gives a result back in ``value``'s
        form)."""
        if isinstance(value, torch.Tensor):
            return value.to(self._device, copy=True), lambda t: t.to(value.device)
        return (torch.from_numpy(np.array(value)).to(self._device),
                lambda t: t.cpu().numpy())

    def _mean(self, t, op):
        if op != ReduceOp.MEAN:
            return t
        return (t if t.is_floating_point() else t.float()) / self._world_size

    def _header(self, t=None, numpy=False):
        h = torch.zeros(3 + _MAX_DIMS, dtype=torch.int64, device=self._device)
        if t is not None:
            if t.ndim > _MAX_DIMS:
                raise ValueError(f"at most {_MAX_DIMS} dims, got {t.ndim}")
            h[:3] = torch.tensor([t.ndim, _DTYPES.index(t.dtype), int(numpy)])
            h[3:3 + t.ndim] = torch.tensor(t.shape)
        return h

    def _from_header(self, h):
        ndim, code, numpy = (int(x) for x in h[:3].tolist())
        shape = [int(x) for x in h[3:3 + ndim].tolist()]
        return torch.empty(shape, dtype=_DTYPES[code], device=self._device), bool(numpy)

    def _global(self, rank: int) -> int:
        return rank if self._group is None else dist.get_global_rank(self._group, rank)

    # ----------------------------------------------------------- collectives
    def allreduce(self, value, op: ReduceOp = ReduceOp.SUM):
        t, back = self._stage(value)
        dist.all_reduce(t, op=_OPS[op], group=self._group)
        return back(self._mean(t, op))

    def allgather(self, value):
        t, back = self._stage(value)
        parts = [torch.empty_like(t) for _ in range(self._world_size)]
        dist.all_gather(parts, t, group=self._group)
        return back(torch.stack(parts))

    def reducescatter(self, value, op: ReduceOp = ReduceOp.SUM):
        t, back = self._stage(value)
        if t.ndim == 0 or t.shape[0] % self._world_size:
            raise ValueError(f"axis 0 of a {tuple(t.shape)} value does not split over "
                             f"{self._world_size} ranks")
        n = t.shape[0] // self._world_size
        if self._backend == Backend.NCCL:
            out = torch.empty((n, *t.shape[1:]), dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(out, t.contiguous(), op=_OPS[op], group=self._group)
        else:
            # gloo: an all-reduce and this rank's chunk (no reduce-scatter on
            # CUDA tensors, nor on the CPU in some torch versions)
            dist.all_reduce(t, op=_OPS[op], group=self._group)
            out = t[self._rank * n:(self._rank + 1) * n]
        return back(self._mean(out, op))

    def broadcast(self, value, src_rank: int = 0):
        """``src_rank``'s value on every rank; the others may pass ``None``.
        The result has the source's form (numpy or tensor)."""
        src = self._global(src_rank)
        if self._rank == src_rank:
            t, _ = self._stage(value)
            header = self._header(t, numpy=not isinstance(value, torch.Tensor))
        else:
            header = self._header()
        dist.broadcast(header, src, group=self._group)
        if self._rank != src_rank:
            t, _ = self._from_header(header)
        dist.broadcast(t, src, group=self._group)
        if bool(header[2]):
            return t.cpu().numpy()
        return t.to(value.device) if isinstance(value, torch.Tensor) else t

    def reduce(self, value, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        """The reduction on ``dst_rank``; every other rank gets its own
        value back, as JAX's groups give it."""
        t, back = self._stage(value)
        dist.reduce(t, self._global(dst_rank), op=_OPS[op], group=self._group)
        if self._rank != dst_rank:
            return value if isinstance(value, torch.Tensor) else np.asarray(value)
        return back(self._mean(t, op))

    def barrier(self) -> None:
        dist.barrier(group=self._group)

    # ------------------------------------------------------------------- p2p
    def send(self, value, dst_rank: int) -> None:
        """To ``dst_rank``, which must ``recv`` from this rank: a header with
        the shape and dtype, then the payload."""
        t, _ = self._stage(value)
        dst = self._global(dst_rank)
        dist.send(self._header(t, numpy=not isinstance(value, torch.Tensor)), dst,
                  group=self._group)
        dist.send(t.contiguous(), dst, group=self._group)

    def recv(self, src_rank: int):
        """What ``src_rank`` sent, in its form (numpy, or a tensor on this
        group's device)."""
        src = self._global(src_rank)
        header = self._header()
        dist.recv(header, src, group=self._group)
        t, numpy = self._from_header(header)
        dist.recv(t, src, group=self._group)
        return t.cpu().numpy() if numpy else t

    def sendrecv(self, value, src: int, dst: int):
        """Collective point-to-point (``XlaCollectiveGroup.sendrecv``,
        ``ray_tpu/collective/xla_group.py:260``): every rank calls it with a
        value of one shape and dtype; ``dst`` gets ``src``'s value, every
        other rank zeros (what JAX's ``ppermute`` leaves where nothing
        arrives). ``src == dst`` gives each rank its own value back; at world
        size 1 it raises ``RuntimeError``."""
        if src == dst:
            return value if isinstance(value, torch.Tensor) else np.asarray(value)
        if self._world_size == 1:
            raise RuntimeError("p2p needs world_size > 1")
        t, back = self._stage(value)
        if self._rank == src:
            dist.send(t.contiguous(), self._global(dst), group=self._group)
        elif self._rank == dst:
            dist.recv(t, self._global(src), group=self._group)
            return back(t)
        return back(torch.zeros_like(t))

    def destroy(self) -> None:
        if self._group is not None:
            dist.destroy_process_group(self._group)
            self._group = None


@functools.lru_cache(maxsize=64)
def _placements_for(mesh, spec: tuple) -> tuple:
    """The target placements of ``spec`` on ``mesh``, worked out once per
    (mesh, spec), as JAX caches one respec program per pair."""
    from ray_tpu_torch.parallel.sharding import placements

    return tuple(placements(spec, mesh))


def redistribute(dtensor, mesh, new_spec):
    """Respec a ``DTensor`` to ``new_spec`` on ``mesh`` (JAX's
    ``collective/xla_group.py`` ``redistribute``): ``DTensor.redistribute``
    runs whatever collective the move needs (all-gather to de-shard a dim,
    all-to-all to move a dim between axes) over the mesh's group. Every
    rank of the mesh calls it. The sharded object plane's reshard path
    (``sharded/reshard.py``) goes through here on a ``DeviceMesh``."""
    spec = tuple(e if e is None or isinstance(e, str) else tuple(e) for e in new_spec)
    return dtensor.redistribute(mesh, _placements_for(mesh, spec))
