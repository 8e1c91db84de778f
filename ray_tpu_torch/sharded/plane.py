"""put_sharded / get_sharded: the sharded object plane's data path.

Counterpart of ``ray_tpu/sharded/plane.py``. Shards are torch tensors.

- ``put_sharded(tensor or ndarray, mesh=MeshSpec(...), spec=... |
  rules=..., path=...)`` cuts the boxes of ``partition_boxes`` out of the
  value on its own device and seals each unique box into this host's shm
  arena; replicas dedupe to one sealed copy per box.
- ``put_sharded(DTensor)`` seals this rank's local shard (when this rank is
  the first holder of its box) and the ranks exchange ``(box, ref)`` over
  the mesh's group, so every rank holds the same manifest.
- ``get_sharded(sref, mesh=MeshSpec, device=...)`` fetches each unique
  shard once and stitches the global tensor on ``device``;
  ``get_sharded(sref, mesh=device_mesh)`` gives a ``DTensor`` whose local
  tensor is this rank's box.

A CUDA shard is sealed through the runtime's tensor reducer (its bytes go
to host shm) and read back on the reader's current card; a process without
CUDA refuses to read it. Placement is partition-rule driven: a value plus
``rules=PartitionRules.llama(), path="wq/kernel"`` picks its spec with the
same ``spec_for`` table the train layer shards parameters with.

Fault story: every seal passes the ``sharded.shard_seal`` chaos point
(action ``error`` -> ObjectStoreError, ``drop`` -> the sealed copy is
deleted after landing, i.e. "the seal was lost"). A shard produced by a
task (see submit.py) recovers from loss through the task's core lineage:
only THAT shard's producing task re-runs. put_sharded shards have no
producer and surface ObjectLostError, like ``put`` values.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ray_tpu_torch.core import object_store, tiering
from ray_tpu_torch.core.ref import ObjectLostError, ObjectRef
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.sharded import telemetry
from ray_tpu_torch.sharded.manifest import (
    ShardedObjectRef,
    ShardEntry,
    ShardManifest,
    box_of_coords,
    partition_boxes,
    spec_to_tuple,
)
from ray_tpu_torch.utils.device import resolve_device


def _core():
    from ray_tpu_torch.core import api

    return api.get_core()


# cold-set tracker for put_sharded seals (core/tiering.py): the raylet's
# cooperative spill can trade cold referenced shards to tier-1 and the
# tracker stamps each entry's (tier, spill_path) leg when they land.
# Weakref-held: tracking never outlives the manifest.
_cold: tiering.ColdTracker | None = None


def _cold_tracker() -> tiering.ColdTracker:
    global _cold
    if _cold is None:
        _cold = tiering.ColdTracker("shard_plane")
    return _cold


def is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_coordinate")


def mesh_axes_of(mesh) -> dict:
    """axis name -> size of a ``MeshSpec`` or a ``DeviceMesh``."""
    if is_device_mesh(mesh):
        return {str(n): int(s) for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape)}
    return {str(n): int(s) for n, s in mesh.axes.items()}


def dtype_name(dtype) -> str:
    """The manifest's dtype string: torch's name without its prefix, which
    is numpy's for every dtype numpy has ("float32", "int64", ...)."""
    return str(dtype).removeprefix("torch.")


def manifest_nbytes(m: ShardManifest) -> int:
    """Deterministic size estimate of the wire manifest (what actually
    crosses the driver for this sharded object): fixed header + per-dim
    extents + ~(oid + owner address + box + node id) per shard. Used by
    the driver-bytes counter so a run can show O(manifest) vs O(array)
    without a side-effecting pickle of live ObjectRefs."""
    return 48 + 24 * len(m.global_shape) + 96 * len(m.shards)


def _slices(box: tuple) -> tuple:
    return tuple(slice(a, b) for a, b in box)


def _seal_shard(core, value: torch.Tensor, *, shard: int,
                phase: str) -> ObjectRef:
    """Seal one shard's bytes into the local shm arena (memory store in
    client mode) and return its owned ref. The ``sharded.shard_seal``
    fault point fires here for the put/reshard phases."""
    act = None
    if chaos.ENABLED:
        try:
            act = chaos.point("sharded.shard_seal", shard=int(shard),
                              phase=phase)
        except chaos.ChaosError as e:
            raise object_store.ObjectStoreError(
                f"shard {shard} seal: {e}") from e
    nbytes = value.numel() * value.element_size()
    t0 = time.perf_counter_ns()
    ref = core.put_value(value, prefer_shm=True)
    dur = time.perf_counter_ns() - t0
    if act is not None and act.kind == "drop" and core.store is not None:
        # "the seal was lost": the bytes landed, then vanished, exactly
        # the window a node-local eviction/crash opens. Consumers see a
        # missing local copy and go through pull -> lineage recovery.
        core.store.delete(ref.id)
    telemetry.record(telemetry.SHARD_SEAL, dur, int(nbytes))
    return ref


def _entry(core, ref: ObjectRef, box: tuple, nbytes: int, node) -> ShardEntry:
    entry = ShardEntry(box=box, ref=ref, node=node, nbytes=int(nbytes))
    if core.store is not None:
        _cold_tracker().track(ref.id.binary(), entry.nbytes, entry)
    return entry


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(value))


def spec_of_dtensor(dt) -> tuple:
    """The spec tuple of a ``DTensor``'s placements (mesh dims sharding one
    tensor dim list their axes in mesh order, as ``placements`` reads
    them back)."""
    names = dt.device_mesh.mesh_dim_names
    per_dim: list[list[str]] = [[] for _ in range(dt.ndim)]
    for name, p in zip(names, dt.placements):
        if p.is_shard():
            per_dim[p.dim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} of {name!r} has no spec form")
    spec = [None if not a else a[0] if len(a) == 1 else tuple(a) for a in per_dim]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def put_sharded(value, *, spec=None, mesh=None, rules=None,
                path: str = "") -> ShardedObjectRef:
    """Store a sharded array as a manifest of per-host shm shards.

    ``value`` may be a ``DTensor`` (mesh and spec are taken from it unless
    overridden; every rank of its mesh calls this) or a tensor / ndarray
    plus an explicit ``mesh``, a ``MeshSpec`` (JAX's ``mesh_spec``), and
    either ``spec`` or ``rules``+``path`` (``PartitionRules.spec_for``
    drives the choice). The global array is never serialized whole;
    replicas dedupe to one sealed copy per unique tile box.
    """
    core = _core()
    from torch.distributed.tensor import DTensor

    if isinstance(value, DTensor):
        if mesh is None:
            mesh = value.device_mesh
        if spec is None and rules is None:
            spec = spec_of_dtensor(value)
    if rules is not None and spec is None:
        spec = rules.spec_for(path, getattr(value, "ndim", 0))
    if mesh is None:
        raise ValueError("put_sharded needs a mesh (a MeshSpec, or a DTensor "
                         "on a DeviceMesh)")
    spec_t = spec_to_tuple(spec if spec is not None else ())
    axes = mesh_axes_of(mesh)
    global_shape = tuple(int(d) for d in value.shape)
    boxes = partition_boxes(global_shape, spec_t, axes)
    node = core.node_id.binary() if core.node_id is not None else None

    if is_device_mesh(mesh) != isinstance(value, DTensor):
        raise ValueError("a DTensor is put on its DeviceMesh, any other value "
                         "on a MeshSpec")
    if is_device_mesh(mesh):
        entries = _put_from_ranks(core, value, mesh, spec_t, axes, boxes, node)
        dtype = dtype_name(value.dtype)
    else:
        t = _as_tensor(value)
        dtype = dtype_name(t.dtype)
        entries = []
        for i, box in enumerate(boxes):
            # the cut runs on the value's own device; only the box's bytes
            # go to the arena
            sv = t[_slices(box)].contiguous()
            ref = _seal_shard(core, sv, shard=i, phase="put")
            entries.append(_entry(core, ref, box, sv.numel() * sv.element_size(), node))
    m = ShardManifest(global_shape=global_shape, dtype=dtype, spec=spec_t,
                      mesh_axes=axes, shards=entries)
    telemetry.count_driver_bytes(manifest_nbytes(m))
    return ShardedObjectRef(m)


def _coords(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _check_order(spec_t: tuple, mesh) -> None:
    """A DTensor shards one dim over several mesh dims in mesh order, so a
    multi-axis entry must list its axes in that order to mean the same
    boxes."""
    names = list(mesh.mesh_dim_names)
    for e in spec_t:
        if isinstance(e, tuple) and [names.index(a) for a in e] != sorted(
                names.index(a) for a in e):
            raise ValueError(f"spec entry {e} lists its axes out of the mesh's "
                             f"order {tuple(names)}; a DTensor cannot hold it")


def _all_coords(mesh) -> list[dict]:
    """Each global rank's mesh coordinates, rank order."""
    grid = mesh.mesh
    out: dict[int, dict] = {}
    for flat in range(grid.numel()):
        idx = np.unravel_index(flat, tuple(grid.shape))
        out[int(grid[idx])] = dict(zip(mesh.mesh_dim_names, (int(i) for i in idx)))
    return [out[r] for r in sorted(out)]


def _put_from_ranks(core, dt, mesh, spec_t, axes, boxes, node) -> list[ShardEntry]:
    """Every rank of ``mesh`` calls this with its DTensor: the first rank
    holding each box seals its local shard, and one all_gather_object over
    the mesh's group gives every rank the same (box -> entry) table."""
    import torch.distributed as dist

    _check_order(spec_t, mesh)
    shape = tuple(int(d) for d in dt.shape)
    coords = _all_coords(mesh)
    mine = box_of_coords(_coords(mesh), shape, spec_t, axes)
    first_holder = {}
    for r, c in enumerate(coords):
        first_holder.setdefault(box_of_coords(c, shape, spec_t, axes), r)
    rank = dist.get_rank()
    sealed = None
    if first_holder[mine] == rank:
        local = dt.to_local().detach().contiguous()
        want = tuple(b - a for a, b in mine)
        if tuple(local.shape) != want:
            raise ValueError(f"rank {rank}'s local shard is {tuple(local.shape)}, "
                             f"its box {mine} under spec {spec_t} is {want}")
        ref = _seal_shard(core, local, shard=boxes.index(mine), phase="put")
        sealed = (mine, ref, node, local.numel() * local.element_size())
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, sealed)
    gathered[rank] = sealed  # this rank's own ref, not its unpickled copy
    by_box = {g[0]: (r, g) for r, g in enumerate(gathered) if g is not None}
    entries = []
    for box in boxes:
        r, (_, ref, where, nbytes) = by_box[box]
        if r == rank:
            entries.append(_entry(core, ref, box, nbytes, where))
        else:
            entries.append(ShardEntry(box=box, ref=ref, node=where, nbytes=int(nbytes)))
    return entries


def fetch_shard(sref: ShardedObjectRef, i: int):
    """One shard's value, a tensor: from local shm when the bytes are on
    this node, a raylet pull otherwise. A lost task-produced shard
    re-materializes from lineage inside the get (only that shard's
    producing task re-runs); put_sharded shards have no producer."""
    _core()  # ensure the runtime is up before touching refs
    entry = sref.manifest.shards[i]
    t0 = time.perf_counter_ns()
    try:
        from ray_tpu_torch.core import api

        value = api.get(entry.ref)
    except ObjectLostError as e:
        raise ObjectLostError(
            f"shard {i} of {sref!r} is lost and could not be "
            "re-materialized (put_sharded shards have no lineage; a "
            "task-produced shard's reconstruction was exhausted)"
        ) from e
    if entry.tier == tiering.TIER_DISK:
        # the get restored it through the raylet's spill file: the bytes
        # are shm-resident again, promote the advisory tier leg back
        entry.tier = tiering.TIER_SHM
        entry.spill_path = ""
    telemetry.record(telemetry.SHARD_FETCH, time.perf_counter_ns() - t0,
                     int(entry.nbytes))
    return value


def _check_mesh(sref: ShardedObjectRef, axes: dict) -> None:
    want = partition_boxes(sref.shape, sref.spec, axes)
    if [s.box for s in sref.manifest.shards] != want:
        raise ValueError(
            f"mesh {axes} disagrees with the manifest: spec {sref.spec} tiles "
            f"it into {len(want)} boxes, the manifest holds "
            f"{sref.num_shards()} (axes {sref.mesh_axes})")


def get_sharded(sref: ShardedObjectRef, *, mesh=None, device=None):
    """The value of ``sref``: on a ``MeshSpec`` (the default), the global
    tensor stitched on ``device`` (None means the card) from each unique
    shard, fetched once; on a ``DeviceMesh``, a ``DTensor`` holding this
    rank's box."""
    if mesh is None:
        mesh = sref.build_mesh(device)
    axes = mesh_axes_of(mesh)
    _check_mesh(sref, axes)
    if is_device_mesh(mesh):
        out = _get_dtensor(sref, mesh, axes)
    else:
        dev = resolve_device(device)
        out = torch.empty(sref.shape, dtype=getattr(torch, sref.dtype), device=dev)
        for i, s in enumerate(sref.manifest.shards):
            out[_slices(s.box)] = _as_tensor(fetch_shard(sref, i)).to(dev)
    telemetry.count_driver_bytes(manifest_nbytes(sref.manifest))
    return out


def _get_dtensor(sref: ShardedObjectRef, mesh, axes: dict):
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import placements

    _check_order(sref.spec, mesh)
    box = box_of_coords(_coords(mesh), sref.shape, sref.spec, axes)
    local = _as_tensor(fetch_shard(sref, sref.manifest.box_index()[box]))
    local = local.to(torch.device(mesh.device_type, torch.cuda.current_device())
                     if mesh.device_type == "cuda" else mesh.device_type)
    return DTensor.from_local(local, mesh, placements(sref.spec, mesh),
                              run_check=False, shape=torch.Size(sref.shape),
                              stride=torch.empty(sref.shape, device="meta").stride())


def stats() -> dict:
    """Sharded-plane counters: driver metadata bytes vs shard payload
    bytes, plus op counts."""
    return telemetry.counters()
