"""ShardedObjectRef: a manifest of per-host shards, not a blob.

Counterpart of ``ray_tpu/sharded/manifest.py``, with the same pure data: a
distributed array is its partition spec plus per-position tiles, and the
global value never needs to exist in one address space. A
:class:`ShardedObjectRef` is METADATA only: global shape and dtype, the
spec as plain nested tuples (the port's spec is a tuple already, see
``parallel/sharding.py``), the mesh axes, and a shard table mapping each
unique tile box to an ordinary :class:`ObjectRef` whose bytes are sealed in
the producing host's shm arena.

A mesh is one of two kinds:

- a ``MeshSpec`` (axis sizes only): every position lives in this process,
  on one device. ``get_sharded`` stitches the global tensor on it.
- a live ``DeviceMesh`` (``MeshSpec.build``): one rank per position.
  ``get_sharded`` gives a ``DTensor`` whose local tensor is this rank's box.

Pickling a ShardedObjectRef ships the manifest; the embedded ObjectRefs
ride the normal borrower protocol, so workers and actors receiving one
hold real borrows on every shard.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ray_tpu_torch.core.ref import ObjectRef

# spec tuple form: each dim entry is None (replicated), an axis name, or a
# tuple of axis names (("dp", "fsdp") style multi-axis sharding)
SpecT = tuple


class PartitionSpec(tuple):
    """A spec marked as ONE spec: ``PartitionSpec("dp", None)`` is the tuple
    ``("dp", None)``. Only ``@remote(in_specs=...)`` needs the mark, where a
    plain tuple of specs is read as one spec per argument."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


def spec_to_tuple(spec) -> SpecT:
    """A spec (any sequence of entries) -> plain nested tuples."""
    out = []
    for e in tuple(spec):
        if e is None or isinstance(e, str):
            out.append(e)
        else:
            out.append(tuple(e))
    return tuple(out)


def tuple_to_spec(spec_t: SpecT) -> SpecT:
    """The port's spec IS the tuple (JAX builds a ``PartitionSpec`` here)."""
    return spec_to_tuple(spec_t)


def norm_spec(spec_t: SpecT, ndim: int) -> SpecT:
    """Pad a spec tuple with trailing None so ("dp",) == ("dp", None)
    comparisons are positional, the way PartitionSpec semantics are."""
    t = tuple(spec_t)[:ndim]
    return t + (None,) * (ndim - len(t))


def _dim_axes(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def tile_counts(global_shape: tuple, spec_t: SpecT,
                mesh_axes: dict) -> tuple:
    """Tiles per dimension: the product of the sizes of the mesh axes the
    spec names on that dim (1 for replicated/unspecified dims)."""
    counts = []
    for d in range(len(global_shape)):
        n = 1
        if d < len(spec_t):
            for ax in _dim_axes(spec_t[d]):
                if ax not in mesh_axes:
                    raise ValueError(
                        f"spec axis {ax!r} not in mesh axes "
                        f"{sorted(mesh_axes)}")
                n *= int(mesh_axes[ax])
        if n > 1 and global_shape[d] % n:
            raise ValueError(
                f"dim {d} of shape {global_shape} not divisible by "
                f"{n} tiles ({spec_t[d]!r})")
        counts.append(n)
    return tuple(counts)


def partition_boxes(global_shape: tuple, spec_t: SpecT,
                    mesh_axes: dict) -> list[tuple]:
    """Ordered unique tile boxes: each a tuple of (start, stop) per dim,
    in row-major order over the tile grid. Replicas share a box, so the
    box list is the DEDUPED shard table: len(boxes) can be far smaller
    than the mesh size."""
    counts = tile_counts(global_shape, spec_t, mesh_axes)
    sizes = [global_shape[d] // counts[d] for d in range(len(counts))]
    boxes: list[tuple] = []
    total = math.prod(counts) if counts else 1
    for flat in range(total):
        idx = []
        rem = flat
        for c in reversed(counts):
            idx.append(rem % c)
            rem //= c
        idx.reverse()
        boxes.append(tuple(
            (i * s, (i + 1) * s) for i, s in zip(idx, sizes)))
    return boxes


def box_of_coords(coords: dict, global_shape: tuple, spec_t: SpecT,
                  mesh_axes: dict) -> tuple:
    """The box a mesh position (axis name -> coordinate) holds under
    ``spec_t``: on a dim sharded over (a1, a2, ...) its tile is the
    row-major index of (coords[a1], coords[a2], ...), as JAX lays a
    multi-axis dim out."""
    counts = tile_counts(global_shape, spec_t, mesh_axes)
    out = []
    for d, n in enumerate(counts):
        size = global_shape[d] // n
        tile = 0
        for ax in _dim_axes(spec_t[d] if d < len(spec_t) else None):
            tile = tile * int(mesh_axes[ax]) + int(coords[ax])
        out.append((tile * size, (tile + 1) * size))
    return tuple(out)


@dataclass
class ShardEntry:
    """One unique tile: its box, the ObjectRef holding its bytes, and the
    node whose shm arena sealed it (None when unknown/memory-resident).

    ``tier``/``spill_path``/``spill_offset`` are the storage-tier leg
    (core/tiering.py): tier 0 = shm-resident, tier 1 = in the owning
    raylet's spill directory. ADVISORY: consumers never branch on it
    (``api.get``/pull restore transparently)."""

    box: tuple
    ref: ObjectRef
    node: bytes | None = None
    nbytes: int = 0
    tier: int = 0
    spill_path: str = ""
    spill_offset: int = 0


@dataclass
class ShardManifest:
    global_shape: tuple
    dtype: str
    spec: SpecT
    mesh_axes: dict  # axis name -> size, insertion-ordered
    shards: list[ShardEntry] = field(default_factory=list)

    def box_index(self) -> dict[tuple, int]:
        return {s.box: i for i, s in enumerate(self.shards)}

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)


class ShardedObjectRef:
    """First-class handle to a sharded array in the object plane.

    Holds only the manifest. ``ray_tpu_torch.get`` on it is deliberately
    NOT supported: consume it with :func:`ray_tpu_torch.get_sharded`, pass
    it to a ``@remote(in_specs=...)`` task (per-shard routing), or
    :func:`ray_tpu_torch.reshard` it.
    """

    __slots__ = ("manifest",)

    def __init__(self, manifest: ShardManifest):
        self.manifest = manifest

    # -- convenience views --------------------------------------------------
    @property
    def shape(self) -> tuple:
        return self.manifest.global_shape

    @property
    def dtype(self) -> str:
        return self.manifest.dtype

    @property
    def spec(self) -> SpecT:
        return self.manifest.spec

    @property
    def mesh_axes(self) -> dict:
        return self.manifest.mesh_axes

    @property
    def nbytes(self) -> int:
        return self.manifest.nbytes

    def partition_spec(self) -> PartitionSpec:
        return PartitionSpec(*self.manifest.spec)

    def shard_refs(self) -> list[ObjectRef]:
        return [s.ref for s in self.manifest.shards]

    def num_shards(self) -> int:
        return len(self.manifest.shards)

    def build_mesh(self, device=None):
        """The default consumer-side mesh: a ``MeshSpec`` with this
        manifest's axes, or the live ``DeviceMesh`` over the default
        process group when one of exactly the mesh's size is up."""
        import torch.distributed as dist

        from ray_tpu_torch.parallel.mesh import MeshSpec

        unknown = set(self.manifest.mesh_axes) - set(MeshSpec().axes)
        if unknown:
            raise ValueError(f"manifest mesh axes {sorted(unknown)} are not "
                             f"MeshSpec axes; pass mesh= explicitly")
        spec = MeshSpec(**self.manifest.mesh_axes)
        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() == spec.size and spec.size > 1):
            return spec.build(device)
        return spec

    def __reduce__(self):
        return (ShardedObjectRef, (self.manifest,))

    def __len__(self):
        return len(self.manifest.shards)

    def __repr__(self):
        m = self.manifest
        return (f"ShardedObjectRef(shape={m.global_shape}, dtype={m.dtype},"
                f" spec={m.spec}, shards={len(m.shards)})")
