"""One rank of a gloo world that runs every collective op for the tests.

    RANK=r WORLD_SIZE=n [RTT_RDZV=file|gcs|init_method RTT_TEST_GCS=host:port] \
        python tests/_torch_collective_rank.py <dir>

Not a test module. It joins the group ``g`` (``g_<mode>`` with a runtime) by
``collective.init_collective_group``: through the file ``<dir>/rdzv`` given
as ``init_method`` (``file``, the default: no runtime), through the GCS KV
of the test's runtime, which it joins with ``ray_tpu_torch.init(address=
...)`` (``gcs``: no ``init_method``), or through the file with that
runtime up (``init_method``: the explicit rendezvous wins). It runs every
``Communicator`` op (and the group's ``sendrecv``) on numpy arrays and on
tensors, and writes ``<dir>/out_<rank>.npz``; ``tests/test_torch_collective.py``
checks them against numpy. With a runtime it also writes the seconds of
the rendezvous, the kind of store the world started on, and what the
group's coordinator key holds in the GCS KV after the collectives.
"""
import faulthandler
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ray_tpu_torch import collective  # noqa: E402
from ray_tpu_torch.collective import ReduceOp  # noqa: E402


def value(rank):
    return np.random.default_rng(rank).standard_normal((4, 3)).astype(np.float32)


def main() -> int:
    work = sys.argv[1]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    faulthandler.dump_traceback_later(60, exit=True)
    torch.set_num_threads(1)
    mode = os.environ.get("RTT_RDZV", "file")
    # a group name per mode: keys of groups met through one runtime's GCS stay
    G = "g" if mode == "file" else f"g_{mode}"
    out = {}
    if mode != "file":
        import ray_tpu_torch

        ray_tpu_torch.init(address=os.environ["RTT_TEST_GCS"])
    group = collective.init_collective_group(
        world, rank, backend="gloo", group_name=G,
        init_method=None if mode == "gcs" else f"file://{work}/rdzv")
    if mode != "file":
        import torch.distributed as dist

        out["rendezvous_s"] = np.array(group.rendezvous_s)
        # the store the world started on: a TCPStore through the GCS, the
        # FileStore of an init_method
        store = dist.distributed_c10d._get_default_store()
        while isinstance(store, dist.PrefixStore):
            store = store.underlying_store
        out["store"] = np.array(type(store).__name__)
    for form, wrap in (("np", lambda a: a), ("pt", torch.from_numpy)):
        x = value(rank)

        def put(name, got):
            out[f"{form}/{name}"] = got.numpy() if isinstance(got, torch.Tensor) else got
            out[f"{form}/{name}/is_tensor"] = np.array(isinstance(got, torch.Tensor))

        for op in ReduceOp:
            put(f"allreduce_{op.value}", collective.allreduce(wrap(x), G, op))
        put("allreduce_int_mean", collective.allreduce(wrap(np.arange(4) + rank), G,
                                                       ReduceOp.MEAN))
        put("allgather", collective.allgather(wrap(x), G))
        put("reducescatter_sum", collective.reducescatter(wrap(x), G))
        put("reducescatter_max", collective.reducescatter(wrap(x), G, ReduceOp.MAX))
        put("broadcast", collective.broadcast(wrap(x) if rank == 1 else None, 1, G))
        put("reduce", collective.reduce(wrap(x), 0, G))
        collective.barrier(G)
        group = collective.get_group_handle(G)
        put("sendrecv", group.sendrecv(wrap(x), 1, 0))
        put("sendrecv_self", group.sendrecv(wrap(x), 1, 1))
        if rank == 0:
            collective.send(wrap(x), 1, G)
            put("recv", collective.recv(1, G))
        else:
            put("recv", collective.recv(0, G))
            collective.send(wrap(np.arange(6, dtype=np.int64).reshape(2, 3)), 0, G)
    if mode != "file":
        # read after collectives that rank 0 joined: it returned from the
        # rendezvous, and took the key out on the way
        from ray_tpu_torch.collective.torch_group import COORDINATOR_NS, coordinator_key
        from ray_tpu_torch.core import api

        core = api.get_core()
        key = core._run_sync(core.gcs.call("kv_get", {"ns": COORDINATOR_NS,
                                                      "key": coordinator_key(G)}))
        out["gcs_key"] = np.array(key.decode() if key else "")
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    collective.destroy_collective_group(G)
    if mode != "file":
        ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
