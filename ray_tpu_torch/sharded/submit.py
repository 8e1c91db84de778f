"""Shard-wave task submission: ``@remote(in_specs=..., out_specs=...)``.

Counterpart of ``ray_tpu/sharded/submit.py``. A sharded function fans out ONE task PER UNIQUE SHARD instead of one
task over the gathered array: each task is routed (node-affinity) to the
node whose shm arena holds its input shards, the worker's dependency
resolution hands it the shard values zero-copy out of local shm, and
each task's return IS the corresponding output shard — sealed into the
executing node's arena by the normal result path, with the completion
record priming the owner's location cache. The driver never gathers or
scatters array bytes; it moves manifests (Pathways' dispatch shape,
Barham et al., 2022).

Spec mediation: when a consumer's ``in_spec`` disagrees with a stored
manifest's spec, the argument is redistributed FIRST through ``reshard``
(sharded/reshard.py), so disagreement costs one device-side re-cut, not a
driver funnel. ``num_gpus`` on a sharded function leases the card for each
shard task; a CUDA shard reaches the task on its card.

``in_specs`` is one spec for every argument (a ``PartitionSpec``, or a
tuple holding an axis name) or one spec per argument (a list, or a tuple
whose entries are all specs or None): ``in_specs=P("dp")`` and
``in_specs=(("dp",), ("dp",), None)`` read as JAX's ``P("dp")`` and
``(P("dp"), P("dp"), None)``.

Fault story: each shard task's core lineage (driver-side spec stash)
makes a lost output shard re-materialize by re-running ONLY that shard's
task; the ``sharded.shard_seal`` fault point fires per shard task
(phase="task"), where a ``kill`` action dies before the seal — the exact
loss window the chaos plan exercises.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.sharded import telemetry
from ray_tpu_torch.sharded.manifest import (
    PartitionSpec,
    ShardedObjectRef,
    ShardEntry,
    ShardManifest,
    _dim_axes,
    norm_spec,
    partition_boxes,
    spec_to_tuple,
)
from ray_tpu_torch.sharded.plane import dtype_name, manifest_nbytes
from ray_tpu_torch.sharded.reshard import reshard


_GPU = GPUAcceleratorManager.get_resource_name()


def _is_one_spec(specs) -> bool:
    """True when ``in_specs`` is one spec for every argument, False when it
    is a sequence of per-argument specs (see the module docstring)."""
    if isinstance(specs, PartitionSpec) or not isinstance(specs, (tuple, list)):
        return True
    if isinstance(specs, list):
        return False
    return not all(e is None or isinstance(e, (tuple, list)) for e in specs)


def _grid_axes(spec_t: tuple) -> tuple:
    """The mesh axes a spec consumes, in tile-enumeration (row-major
    dim, then intra-dim) order. Two sharded args align shard-for-shard
    iff these sequences are EQUAL: flat shard index i then decomposes
    into the same mesh coordinates for both — P("dp") rows pair with
    P(None, "dp") columns (both enumerate dp), but ("dp",) must never
    silently pair with ("tp",)."""
    return tuple(ax for e in spec_t for ax in _dim_axes(e))


def _make_shard_body(user_fn):
    """The per-shard task body (registered once per handle): runs the
    user function on the shard VALUES, tensors (the runtime resolved the
    shard refs out of local shm before entry, a CUDA shard onto this
    worker's card) and returns the output shard, which the normal result
    path seals into this node's arena."""

    def _sharded_shard_call(_rt_shard_idx, _rt_out, *vals, **kw):
        out = user_fn(*vals, **kw)
        if not isinstance(out, torch.Tensor):
            out = torch.as_tensor(out)
        if _rt_out is not None:
            shape, dtype = _rt_out
            if tuple(out.shape) != tuple(shape) or dtype_name(out.dtype) != dtype:
                # fail AT the producing task, not deep inside a later
                # get_sharded stitch with a cryptic shape error
                raise TypeError(
                    f"shard {_rt_shard_idx} returned shape {out.shape} "
                    f"dtype {out.dtype}, but out_specs/out_shape/"
                    f"out_dtype declare {tuple(shape)}/{dtype} for this "
                    "tile; fix the declaration or the function")
        if chaos.ENABLED:
            # "sharded.shard_seal", task phase: `kill` dies here — after
            # the work, before the seal — so exactly this shard is lost
            # and core lineage re-runs exactly this task
            chaos.point("sharded.shard_seal", shard=int(_rt_shard_idx),
                        phase="task")
        return out

    return _sharded_shard_call


class ShardedFunction:
    """Handle produced by ``@remote(in_specs=..., out_specs=...)``."""

    def __init__(self, fn, opts: dict):
        self._fn = fn
        self._opts = dict(opts)
        self._body = _make_shard_body(fn)
        self.__name__ = getattr(fn, "__name__", "sharded_task")

    def options(self, **opts) -> "ShardedFunction":
        return ShardedFunction(self._fn, {**self._opts, **opts})

    def __call__(self, *a, **k):
        raise TypeError("sharded remote functions cannot be called "
                        "directly; use .remote()")

    # ------------------------------------------------------------- submit
    def remote(self, *args, **kwargs) -> ShardedObjectRef:
        from ray_tpu_torch.core import api

        core = api.get_core()
        o = self._opts
        for k, v in kwargs.items():
            if isinstance(v, ShardedObjectRef):
                raise TypeError(
                    f"sharded args must be positional (kwarg {k!r} is a "
                    "ShardedObjectRef): in_specs aligns to positions")
        sharded_idx = [i for i, a in enumerate(args)
                       if isinstance(a, ShardedObjectRef)]
        if not sharded_idx:
            raise TypeError(
                "a sharded function takes at least one ShardedObjectRef "
                "argument (use plain @remote for unsharded tasks)")
        in_specs = o.get("in_specs")
        if in_specs is None:
            raise TypeError("@remote(in_specs=...) is required for "
                            "sharded submission")
        if _is_one_spec(in_specs):
            in_specs = (in_specs,) * len(args)
        if len(in_specs) < len(args):
            in_specs = tuple(in_specs) + (None,) * (len(args)
                                                    - len(in_specs))

        # spec mediation: redistribute any sharded arg whose stored spec
        # disagrees with the declared in_spec (the manifest swap is
        # invisible to the caller's handle)
        args = list(args)
        mesh = o.get("mesh")
        for i in sharded_idx:
            sref = args[i]
            want = in_specs[i]
            if want is None:
                continue
            want_t = norm_spec(spec_to_tuple(want), len(sref.shape))
            have_t = norm_spec(tuple(sref.spec), len(sref.shape))
            if want_t != have_t:
                args[i] = reshard(sref, want, mesh=mesh,
                                  device=o.get("device"))

        first = args[sharded_idx[0]]
        nshards = first.num_shards()
        axes0 = _grid_axes(tuple(first.spec))
        for i in sharded_idx[1:]:
            if args[i].num_shards() != nshards:
                raise ValueError(
                    f"sharded args disagree on shard count: "
                    f"{nshards} vs {args[i].num_shards()} (arg {i}); "
                    "declare in_specs that tile them identically")
            axes_i = _grid_axes(tuple(args[i].spec))
            if axes_i != axes0:
                raise ValueError(
                    f"sharded args tile over different mesh axes: arg 0 "
                    f"enumerates {axes0 or '(replicated)'} but arg {i} "
                    f"enumerates {axes_i or '(replicated)'} — shard i of "
                    "each would pair tiles from unrelated mesh "
                    "positions; declare in_specs over the same axes (in "
                    "the same order)")

        # node routing: each shard task goes to the raylet of the node
        # holding its (first sharded arg's) shard
        addr_of = self._node_addresses(core, args, sharded_idx)
        out_spec = o.get("out_specs")
        out_spec_t = (spec_to_tuple(out_spec) if out_spec is not None
                      else tuple(first.spec))
        out_shape = tuple(o.get("out_shape") or first.shape)
        out_dtype = str(o.get("out_dtype") or first.dtype)
        out_boxes = partition_boxes(out_shape, out_spec_t,
                                    first.mesh_axes)
        if len(out_boxes) != nshards:
            raise ValueError(
                f"out_specs {out_spec_t} tiles {out_shape} into "
                f"{len(out_boxes)} shards but the inputs have {nshards}; "
                "pick an out_spec with the same tile count or reshard "
                "the result explicitly")

        resources = dict(o.get("resources") or {})
        resources.setdefault("CPU", float(o.get("num_cpus", 1.0)))
        if o.get("num_gpus"):
            resources[_GPU] = float(o["num_gpus"])
        entries: list[ShardEntry] = []
        itemsize = torch.empty((), dtype=getattr(torch, out_dtype)).element_size()
        for i in range(nshards):
            tile_shape = tuple(b - a for a, b in out_boxes[i])
            task_args = [i, (tile_shape, out_dtype)]
            for k, a in enumerate(args):
                if isinstance(a, ShardedObjectRef):
                    task_args.append(a.manifest.shards[i].ref)
                else:
                    task_args.append(a)
            node = first.manifest.shards[i].node
            ref = core.submit_task(
                self._body, tuple(task_args), dict(kwargs),
                num_returns=1,
                resources=dict(resources),
                max_retries=o.get("max_retries"),
                scheduling_node=addr_of.get(node),
                name=f"{self.__name__}:shard{i}",
            )
            vol = 1
            for a, b in out_boxes[i]:
                vol *= (b - a)
            entries.append(ShardEntry(box=out_boxes[i], ref=ref,
                                      node=node, nbytes=vol * itemsize))
        m = ShardManifest(global_shape=out_shape, dtype=out_dtype,
                          spec=out_spec_t, mesh_axes=dict(first.mesh_axes),
                          shards=entries)
        # driver traffic for the whole wave: shard descriptors in, one
        # manifest out — O(manifest), counter-verified in bench
        telemetry.count_driver_bytes(manifest_nbytes(m) + 64 * nshards)
        return ShardedObjectRef(m)

    def _node_addresses(self, core, args, sharded_idx) -> dict:
        """node-id binary -> raylet address for every node the input
        shards live on. The local node resolves without a GCS round
        trip; remote nodes share one cluster-view call."""
        local = (core.node_id.binary()
                 if core.node_id is not None else None)
        need = set()
        first = args[sharded_idx[0]]
        for s in first.manifest.shards:
            if s.node is not None and s.node != local:
                need.add(s.node)
        out = {}
        if local is not None:
            out[local] = tuple(core.raylet_address)
        if need:
            from ray_tpu_torch.core import api

            for n in api.nodes():
                nid = n.get("node_id")
                nb = nid.binary() if hasattr(nid, "binary") else nid
                if nb in need and n.get("alive", True):
                    out[nb] = tuple(n["address"])
        return out
