"""Sharded object plane: distributed arrays in the object store.

Counterpart of ``ray_tpu/sharded``. A :class:`ShardedObjectRef` is a
manifest (global shape and dtype, the spec as a tuple, mesh axes,
per-shard ObjectRefs and owning node) whose shards, torch tensors, seal
directly into each host's shm arena. ``put_sharded`` never serializes the
global array; ``get_sharded`` stitches the global tensor on a device (a
``MeshSpec``) or gives this rank's ``DTensor`` (a ``DeviceMesh``);
``@ray_tpu_torch.remote(in_specs=..., out_specs=...)`` fans one task per
shard, routed to the shard's node; spec disagreements go through
``reshard`` (a device-side re-cut, or ``collective.torch_group
.redistribute`` on a ``DeviceMesh``), never through the driver.
"""

from ray_tpu_torch.sharded.manifest import (  # noqa: F401
    P,
    PartitionSpec,
    ShardedObjectRef,
    ShardEntry,
    ShardManifest,
    partition_boxes,
    spec_to_tuple,
    tuple_to_spec,
)
from ray_tpu_torch.sharded.plane import (  # noqa: F401
    fetch_shard,
    get_sharded,
    manifest_nbytes,
    put_sharded,
    stats,
)
from ray_tpu_torch.sharded.reshard import reshard  # noqa: F401
from ray_tpu_torch.sharded.submit import ShardedFunction  # noqa: F401

__all__ = [
    "P", "PartitionSpec",
    "ShardedObjectRef", "ShardEntry", "ShardManifest", "ShardedFunction",
    "put_sharded", "get_sharded", "fetch_shard", "reshard", "stats",
    "partition_boxes", "spec_to_tuple", "tuple_to_spec", "manifest_nbytes",
]
