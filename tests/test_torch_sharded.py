"""The port's sharded object plane (``ray_tpu_torch.sharded``) against JAX's.

- manifests: ``partition_boxes``, tile counts, spec tuples, axes, shard
  count and ``manifest_nbytes`` equal ``ray_tpu.sharded.manifest``'s, and
  each mesh position's box equals the one JAX's ``NamedSharding`` gives
  it, parametrised over specs on axes dp=4, tp=2 (pure functions, no
  runtime);
- on one module-scoped ``ray_tpu_torch.init``: put/get round trips whose
  shards hold the bytes of JAX's ``device_put`` shards, ``reshard``
  against JAX's ``collective/xla_group.redistribute`` on the 8-device CPU
  mesh, shard waves with spec mediation, routing to the owning node, one
  lost shard recovered from lineage, and the ``sharded.shard_seal`` chaos
  point;
- on a ``DeviceMesh``: two gloo ranks (``tests/_torch_sharded_rank.py``)
  join the runtime, put a ``DTensor``, and move it through
  ``redistribute`` and ``reshard``.
"""

import dataclasses
import gc
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_time_limit import time_limits
from ray_tpu.sharded import manifest as jax_manifest
from ray_tpu_torch import config
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.parallel.sharding import PartitionRules
from ray_tpu_torch.sharded import P, fetch_shard, manifest, stats

jax = pytest.importorskip("jax")
from jax.sharding import NamedSharding, PartitionSpec as JP  # noqa: E402

from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(ROOT, "tests", "_torch_sharded_rank.py")

# slowest case ~7 s alone (test_device_mesh_put_get_redistribute, two rank
# processes); set-up and tear-down (the runtime's start and shutdown) a few seconds
_module_limit, _test_limit = time_limits(module_s=60, test_s=40)

SPECS = [(), ("dp",), ("dp", "tp"), (None, "tp"), ("tp", "dp"), (("dp", "tp"),),
         (None, ("dp", "tp")), (("tp", "dp"), None)]


def _arr(rows=16, cols=8, dtype=np.float32):
    return np.random.default_rng(0).standard_normal((rows, cols)).astype(dtype)


def _jax_mesh(spec):
    return JaxMeshSpec(**spec.axes).build(jax.devices()[:spec.size])


def _jax_shards(garr) -> dict:
    """box -> bytes of every addressable shard of a jax.Array."""
    shape = tuple(garr.shape)
    return {jax_manifest.box_of_indices(s.index, shape): np.asarray(s.data)
            for s in garr.addressable_shards}


# ---------------------------------------------------------------- manifests
@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_manifest_matches_jax(spec):
    mesh = MeshSpec(dp=4, tp=2)
    shape = (16, 8)
    axes = mesh.axes
    boxes = manifest.partition_boxes(shape, spec, axes)
    assert boxes == jax_manifest.partition_boxes(shape, jax_manifest.spec_to_tuple(spec),
                                                 axes)
    assert manifest.tile_counts(shape, spec, axes) == jax_manifest.tile_counts(shape, spec,
                                                                                axes)
    assert manifest.spec_to_tuple(P(*spec)) == jax_manifest.spec_to_tuple(JP(*spec))
    # the manifest as pure data, and its wire-size estimate
    from ray_tpu.sharded.plane import manifest_nbytes as jax_nbytes
    from ray_tpu_torch.sharded.plane import manifest_nbytes

    mine = manifest.ShardManifest(shape, "float32", spec, dict(axes),
                                  [manifest.ShardEntry(b, None, nbytes=4) for b in boxes])
    ref = jax_manifest.ShardManifest(shape, "float32", jax_manifest.spec_to_tuple(JP(*spec)),
                                     dict(axes),
                                     [jax_manifest.ShardEntry(b, None, nbytes=4) for b in boxes])
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert manifest_nbytes(mine) == jax_nbytes(ref)
    # every mesh position's box is the one JAX's NamedSharding gives it
    jmesh = _jax_mesh(mesh)
    index_map = NamedSharding(jmesh, JP(*spec)).devices_indices_map(shape)
    for pos, dev in np.ndenumerate(jmesh.devices):
        coords = dict(zip(jmesh.axis_names, pos))
        assert manifest.box_of_coords(coords, shape, spec, axes) == \
            jax_manifest.box_of_indices(index_map[dev], shape)


def test_spec_of_rules_matches_jax():
    from ray_tpu.parallel.sharding import PartitionRules as JaxRules

    for path, ndim in (("tok/embedding", 2), ("layers/0/attn/wq/kernel", 2),
                       ("layers/0/mlp/w_down/kernel", 2), ("ln_f/scale", 1),
                       ("moe/w_up/kernel", 3)):
        assert PartitionRules.llama().spec_for(path, ndim) == \
            jax_manifest.spec_to_tuple(JaxRules.llama().spec_for(path, ndim))


# ---------------------------------------------------------------- runtime
@pytest.fixture(scope="module")
def rt():
    torch.set_num_threads(1)
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the workers inherit it
    ray_tpu_torch.shutdown()  # a runtime another module left in this process
    cfg = config.get_config()
    config.set_config(dataclasses.replace(cfg, worker_lease_timeout_s=1.0))
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    config.set_config(cfg)
    if saved is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = saved


MESH = MeshSpec(dp=2, tp=2, sp=2)


@pytest.mark.parametrize("spec", [("dp", "tp"), ("dp",), (None, ("dp", "tp")), ()],
                         ids=repr)
def test_put_get_round_trip(rt, spec):
    arr = _arr()
    sref = rt.put_sharded(arr, mesh=MESH, spec=spec)
    assert (sref.shape, sref.dtype, sref.mesh_axes) == ((16, 8), "float32", MESH.axes)
    oracle = _jax_shards(jax.device_put(arr, NamedSharding(_jax_mesh(MESH), JP(*spec))))
    assert [s.box for s in sref.manifest.shards] == sorted(oracle)
    assert sref.nbytes == sum(a.nbytes for a in oracle.values())
    for i, s in enumerate(sref.manifest.shards):
        shard = fetch_shard(sref, i)
        assert isinstance(shard, torch.Tensor)
        np.testing.assert_array_equal(shard.numpy(), oracle[s.box])
        assert s.nbytes == oracle[s.box].nbytes  # a tile, not the whole
    got = rt.get_sharded(sref, mesh=MESH, device="cpu")
    np.testing.assert_array_equal(got.numpy(), arr)


def test_put_bfloat16_by_rules(rt):
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    mesh = MeshSpec(fsdp=2, tp=4)
    sref = rt.put_sharded(w, mesh=mesh, rules=PartitionRules.llama(), path="tok/embedding")
    assert (sref.spec, sref.dtype, sref.num_shards()) == (("fsdp", "tp"), "bfloat16", 8)
    assert torch.equal(rt.get_sharded(sref, mesh=mesh, device="cpu"), w)
    norm = rt.put_sharded(torch.ones(8), mesh=mesh, rules=PartitionRules.llama(),
                          path="ln_f/scale")
    assert (norm.spec, norm.num_shards()) == ((), 1)


@pytest.mark.parametrize("target", [("tp",), (None, ("dp", "tp")), (("dp", "tp"),),
                                    (None, "sp")], ids=repr)
def test_reshard_matches_jax_redistribute(rt, target):
    from ray_tpu.collective.xla_group import redistribute

    arr = _arr()
    sref = rt.put_sharded(arr, mesh=MESH, spec=("dp", "tp"))
    out = rt.reshard(sref, target, mesh=MESH, device="cpu")
    assert out.spec == target
    jmesh = _jax_mesh(MESH)
    oracle = redistribute(jax.device_put(arr, NamedSharding(jmesh, JP("dp", "tp"))), jmesh,
                          JP(*target))
    shards = _jax_shards(oracle)
    assert [s.box for s in out.manifest.shards] == sorted(shards)
    for i, s in enumerate(out.manifest.shards):
        np.testing.assert_array_equal(fetch_shard(out, i).numpy(),
                                      shards[s.box])
    np.testing.assert_array_equal(rt.get_sharded(out, mesh=MESH, device="cpu").numpy(),
                                  np.asarray(oracle))


def test_reshard_same_spec_is_noop(rt):
    sref = rt.put_sharded(_arr(), mesh=MESH, spec=("dp",))
    assert rt.reshard(sref, ("dp", None), mesh=MESH) is sref


def test_shard_tasks_route_to_owning_node(rt):
    core = rt.get_core()
    sref = rt.put_sharded(_arr(), mesh=MESH, spec=("dp",))
    local = core.node_id.binary()
    assert all(s.node == local for s in sref.manifest.shards)

    @rt.remote(in_specs=P("dp"), out_specs=P("dp"))
    def f(x):
        return x

    assert f._node_addresses(core, [sref], [0])[local] == tuple(core.raylet_address)


def test_shard_wave_with_spec_mediation(rt):
    """A wave over one spec, one over a spec the stored array disagrees
    with (resharded first, bit-identical to JAX's layout), and a wave of
    two sharded args and a plain one."""
    arr = _arr()
    stored = rt.put_sharded(arr, mesh=MESH, spec=("dp", "tp"))

    @rt.remote(in_specs=P("dp", "tp"), out_specs=P("dp", "tp"))
    def triple(x):
        import sys

        assert isinstance(x, torch.Tensor)
        # a shard task started by the port loads neither package of JAX's
        assert not {"jax", "ray_tpu"} & set(sys.modules), "jax or ray_tpu loaded"
        return x * 3

    out = triple.remote(stored)
    assert out.num_shards() == stored.num_shards() == 4
    np.testing.assert_array_equal(rt.get_sharded(out, mesh=MESH, device="cpu").numpy(),
                                  arr * 3)

    before = stats()["reshards"]

    @rt.remote(in_specs=P("tp"), out_specs=P("tp"), device="cpu")
    def fn(x):
        return x * 2 + 1

    moved = fn.remote(stored)  # stored (dp, tp) != declared (tp,): reshard
    assert moved.spec == ("tp",) and stats()["reshards"] == before + 1
    oracle = np.asarray(jax.device_put(arr, NamedSharding(_jax_mesh(MESH), JP("tp")))) * 2 + 1
    np.testing.assert_array_equal(rt.get_sharded(moved, mesh=MESH, device="cpu").numpy(),
                                  oracle)

    y = np.ones_like(arr) * 10
    sx = rt.put_sharded(arr, mesh=MESH, spec=("dp",))
    sy = rt.put_sharded(y, mesh=MESH, spec=("dp",))

    @rt.remote(in_specs=(("dp",), ("dp",), None), out_specs=P("dp"))
    def axpy(a, b, k):
        return a * k + b

    got = rt.get_sharded(axpy.remote(sx, sy, 2.0), mesh=MESH, device="cpu").numpy()
    np.testing.assert_array_equal(got, arr * 2.0 + y)
    with pytest.raises(ValueError, match="different mesh axes"):
        axpy.options(in_specs=(("dp",), ("tp",), None)).remote(
            sx, rt.put_sharded(y, mesh=MESH, spec=("tp",)), 1.0)


def test_single_shard_recovery_from_lineage(rt, tmp_path):
    """Losing ONE output shard re-runs only its producing task."""
    cdir = str(tmp_path)
    arr = np.arange(4 * 80_000, dtype=np.float32).reshape(4, 80_000)
    m4 = MeshSpec(dp=4)
    sref = rt.put_sharded(arr, mesh=m4, spec=("dp",))

    @rt.remote(in_specs=P("dp"), out_specs=P("dp"))
    def work(x):
        import os as _os
        import uuid as _uuid

        open(_os.path.join(cdir, f"{float(x[0, 0]):.0f}-{_uuid.uuid4().hex[:6]}"),
             "w").close()
        return x + 1

    out = work.remote(sref)
    np.testing.assert_array_equal(rt.get_sharded(out, mesh=m4, device="cpu").numpy(), arr + 1)
    gc.collect()
    core = rt.get_core()
    lost = out.manifest.shards[2].ref
    core.store.delete(lost.id)
    assert not core.store.contains(lost.id)
    np.testing.assert_array_equal(rt.get_sharded(out, mesh=m4, device="cpu").numpy(), arr + 1)
    counts = {}
    for f in os.listdir(cdir):
        k = f.split("-")[0]
        counts[k] = counts.get(k, 0) + 1
    assert counts["160000"] == 2, counts  # the lost shard re-ran once
    assert sum(counts.values()) == 5, counts  # ...and nothing else did


@pytest.mark.parametrize("action", ["error", "drop"])
def test_shard_seal_chaos_point(rt, action):
    """``sharded.shard_seal`` at put: ``error`` fails the put typed,
    ``drop`` loses the sealed copy, which a put shard (no lineage) reports
    as lost."""
    from ray_tpu_torch.core.object_store import ObjectStoreError
    from ray_tpu_torch.core.ref import ObjectLostError
    from ray_tpu_torch.devtools import chaos
    from ray_tpu_torch.devtools.chaos.plan import ChaosPlan

    plan = ChaosPlan.from_json(
        '{"seed": 1, "rules": [{"point": "sharded.shard_seal", "match": '
        '{"phase": "put", "shard": 1}, "action": "%s"}]}' % action)
    m4 = MeshSpec(dp=4)
    chaos.enable(plan)
    try:
        if action == "error":
            with pytest.raises(ObjectStoreError, match="shard 1 seal"):
                rt.put_sharded(_arr(), mesh=m4, spec=("dp",))
            return
        sref = rt.put_sharded(_arr(), mesh=m4, spec=("dp",))
    finally:
        chaos.disable()
    with pytest.raises(ObjectLostError, match="shard 1 of"):
        rt.get_sharded(sref, mesh=m4, device="cpu")
    fetch_shard(sref, 0)  # the other shards are there


def test_telemetry_counts(rt):
    s0 = stats()
    sref = rt.put_sharded(_arr(), mesh=MESH, spec=("dp",))
    rt.reshard(sref, ("tp",), mesh=MESH, device="cpu")
    s = stats()
    assert s["shards_sealed"] - s0["shards_sealed"] == 4
    assert s["reshards"] - s0["reshards"] == 1
    assert s["driver_bytes"] > s0["driver_bytes"]
    assert s["array_bytes"] - s0["array_bytes"] == 2 * _arr().nbytes


# ----------------------------------------------------------- DeviceMesh
def test_device_mesh_put_get_redistribute(rt, tmp_path):
    """Two gloo ranks on ``MeshSpec(tp=2).build("cpu")``: each rank's
    ``get_sharded`` local tensor, ``redistribute`` and ``reshard`` equal
    the shards JAX's ``redistribute`` puts at that mesh position."""
    from ray_tpu.collective.xla_group import redistribute

    x = _arr(8, 6)
    np.savez(tmp_path / "inputs.npz", x=x)
    host, port = rt.get_core().gcs_address
    env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE="2", OMP_NUM_THREADS="1",
               RTT_TEST_GCS=f"{host}:{port}")
    procs = [subprocess.Popen([sys.executable, HELPER, str(tmp_path)],
                              env=dict(env, RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    deadline = time.monotonic() + 90
    try:
        while time.monotonic() < deadline and any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = [p.stdout.read().decode(errors="replace")[-3000:] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    outs = [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(2)]

    jmesh = _jax_mesh(MeshSpec(tp=2))
    src = jax.device_put(x, NamedSharding(jmesh, JP("tp")))
    moved = redistribute(src, jmesh, JP(None, "tp"))
    for rank, out in enumerate(outs):
        dev = jmesh.devices.flat[rank]
        assert str(out["spec"]) == "('tp',)" and str(out["reshard_spec"]) == "(None, 'tp')"
        assert out["boxes"].tolist() == [[[0, 4], [0, 6]], [[4, 8], [0, 6]]]
        np.testing.assert_array_equal(out["get_local"], np.asarray(
            [s.data for s in src.addressable_shards if s.device == dev][0]))
        want = np.asarray([s.data for s in moved.addressable_shards if s.device == dev][0])
        np.testing.assert_array_equal(out["redistribute_local"], want)
        np.testing.assert_array_equal(out["reshard_local"], want)
        np.testing.assert_array_equal(out["reshard_full"], x)
