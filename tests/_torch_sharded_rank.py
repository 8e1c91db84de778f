"""One rank of a 2-rank gloo world that drives the sharded object plane on
a ``DeviceMesh``. Not a test module.

    RANK=r WORLD_SIZE=2 RTT_TEST_GCS=host:port python tests/_torch_sharded_rank.py <dir>

It joins the test's runtime (``ray_tpu_torch.init(address=...)``) and the
group through the file ``<dir>/rdzv``, builds ``MeshSpec(tp=2)`` on the CPU,
and for the array ``<dir>/inputs.npz`` (``x``) writes ``<dir>/out_<rank>.npz``:
the manifest of ``put_sharded(DTensor)``, the local tensors of
``get_sharded(mesh=device_mesh)``, of ``collective.torch_group.redistribute``
and of ``reshard`` to ``(None, "tp")``, and the global tensor stitched from
both ranks' shards. ``tests/test_torch_sharded.py`` checks them against JAX.
"""
import faulthandler
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.collective.torch_group import redistribute  # noqa: E402
from ray_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from ray_tpu_torch.parallel.sharding import placements  # noqa: E402


def main() -> int:
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    work = sys.argv[1]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    faulthandler.dump_traceback_later(90, exit=True)
    torch.set_num_threads(1)
    ray_tpu_torch.init(address=os.environ["RTT_TEST_GCS"])
    dist.init_process_group("gloo", init_method=f"file://{work}/rdzv", rank=rank,
                            world_size=world)
    dm = MeshSpec(tp=2).build("cpu")
    x = torch.from_numpy(np.load(os.path.join(work, "inputs.npz"))["x"])
    dt = distribute_tensor(x, dm, placements(("tp",), dm))
    sref = ray_tpu_torch.put_sharded(dt)
    out = {
        "spec": np.array(repr(sref.spec)),
        "boxes": np.array([s.box for s in sref.manifest.shards]),
        "get_local": ray_tpu_torch.get_sharded(sref, mesh=dm).to_local().numpy(),
        "redistribute_local": redistribute(dt, dm, (None, "tp")).to_local().numpy(),
    }
    moved = ray_tpu_torch.reshard(sref, (None, "tp"), mesh=dm)
    out["reshard_spec"] = np.array(repr(moved.spec))
    out["reshard_local"] = ray_tpu_torch.get_sharded(moved, mesh=dm).to_local().numpy()
    # both ranks' shards, stitched here: the other rank's refs were borrowed
    out["reshard_full"] = ray_tpu_torch.get_sharded(moved, mesh=MeshSpec(tp=2),
                                                    device="cpu").numpy()
    dist.barrier()  # each rank's shards stay alive until the other has read them
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()
    ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
