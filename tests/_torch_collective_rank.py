"""One rank of a gloo world that runs every collective op for the tests.

    RANK=r WORLD_SIZE=n python tests/_torch_collective_rank.py <dir>

Not a test module. It joins the group through the file ``<dir>/rdzv`` by
``collective.init_collective_group(..., init_method=...)``, runs every
``Communicator`` op (and the group's ``sendrecv``) on numpy arrays and on
tensors, and writes
``<dir>/out_<rank>.npz``; ``tests/test_torch_collective.py`` checks them
against numpy.
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
    collective.init_collective_group(world, rank, backend="gloo", group_name="g",
                                     init_method=f"file://{work}/rdzv")
    out = {}
    for form, wrap in (("np", lambda a: a), ("pt", torch.from_numpy)):
        x = value(rank)

        def put(name, got):
            out[f"{form}/{name}"] = got.numpy() if isinstance(got, torch.Tensor) else got
            out[f"{form}/{name}/is_tensor"] = np.array(isinstance(got, torch.Tensor))

        for op in ReduceOp:
            put(f"allreduce_{op.value}", collective.allreduce(wrap(x), "g", op))
        put("allreduce_int_mean", collective.allreduce(wrap(np.arange(4) + rank), "g",
                                                       ReduceOp.MEAN))
        put("allgather", collective.allgather(wrap(x), "g"))
        put("reducescatter_sum", collective.reducescatter(wrap(x), "g"))
        put("reducescatter_max", collective.reducescatter(wrap(x), "g", ReduceOp.MAX))
        put("broadcast", collective.broadcast(wrap(x) if rank == 1 else None, 1, "g"))
        put("reduce", collective.reduce(wrap(x), 0, "g"))
        collective.barrier("g")
        group = collective.get_group_handle("g")
        put("sendrecv", group.sendrecv(wrap(x), 1, 0))
        put("sendrecv_self", group.sendrecv(wrap(x), 1, 1))
        if rank == 0:
            collective.send(wrap(x), 1, "g")
            put("recv", collective.recv(1, "g"))
        else:
            put("recv", collective.recv(0, "g"))
            collective.send(wrap(np.arange(6, dtype=np.int64).reshape(2, 3)), 0, "g")
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    collective.destroy_collective_group("g")
    return 0


if __name__ == "__main__":
    sys.exit(main())
