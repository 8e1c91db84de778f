"""Resharding: spec A -> spec B without a driver hop.

Counterpart of ``ray_tpu/sharded/reshard.py``. JAX runs the move as one
XLA program whose ``out_shardings`` names the new spec. The port has two
kinds of mesh:

- on a ``MeshSpec`` every position is in this process: the shards are
  stitched into the global tensor ON THE DEVICE (``get_sharded``) and the
  new spec's boxes are cut from it there (``put_sharded``). The global
  array is never built on the host;
- on a live ``DeviceMesh`` the rank's ``DTensor`` goes through
  ``collective.torch_group.redistribute`` (``DTensor.redistribute``: the
  all-gather / all-to-all the move needs, over the mesh's group) and its
  new local shard is sealed back.

The driver sees two manifests and nothing else.
"""

from __future__ import annotations

import time

from ray_tpu_torch.sharded import telemetry
from ray_tpu_torch.sharded.manifest import (
    ShardedObjectRef,
    norm_spec,
    spec_to_tuple,
)
from ray_tpu_torch.sharded.plane import get_sharded, is_device_mesh, put_sharded


def reshard(sref: ShardedObjectRef, spec, *, mesh=None,
            device=None) -> ShardedObjectRef:
    """Redistribute ``sref`` to ``spec``, returning a new
    ShardedObjectRef. A no-op (same manifest) when the specs already
    agree, compared dim-positionally, so ("dp",) == ("dp", None).
    ``device`` is where a ``MeshSpec`` reshard stitches (None: the card).
    Records the ``reshard`` stage and the new manifest's driver bytes."""
    ndim = len(sref.shape)
    spec_t = spec_to_tuple(spec)
    if norm_spec(spec_t, ndim) == norm_spec(tuple(sref.spec), ndim):
        return sref
    if mesh is None:
        mesh = sref.build_mesh(device)
    t0 = time.perf_counter_ns()
    if is_device_mesh(mesh):
        from ray_tpu_torch.collective.torch_group import redistribute

        out = redistribute(get_sharded(sref, mesh=mesh), mesh, spec_t)
        new = put_sharded(out, mesh=mesh, spec=spec_t)
    else:
        new = put_sharded(get_sharded(sref, mesh=mesh, device=device),
                          mesh=mesh, spec=spec_t)
    telemetry.record(telemetry.RESHARD, time.perf_counter_ns() - t0,
                     int(sref.nbytes))
    return new
