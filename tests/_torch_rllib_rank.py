"""One rank of a 2-rank gloo world of the port's PPO ``Learner``.

    RANK=r WORLD_SIZE=2 python tests/_torch_rllib_rank.py <dir>

Not a test module. The rank joins the learner group through the file
``<dir>/rdzv``. Rank 0 updates on the rollout in ``<dir>/rollout.npz``,
rank 1 on an empty shard; both then average params and Adam moments. Each
writes its params, moments and Adam step counts to ``<dir>/out_<rank>.npz``
for ``tests/test_torch_rllib_learners.py``.
"""
import faulthandler
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ray_tpu_torch.rllib import Learner  # noqa: E402


def learner_state(ln) -> dict:
    """Params, Adam moments and step counts by parameter name."""
    out = {}
    for name, p in ln.module.named_parameters():
        st = ln.opt.state[p]
        out[f"param/{name}"] = p.detach().cpu().numpy()
        out[f"exp_avg/{name}"] = st["exp_avg"].cpu().numpy()
        out[f"exp_avg_sq/{name}"] = st["exp_avg_sq"].cpu().numpy()
        out[f"step/{name}"] = st["step"].cpu().numpy()
    return out


def main() -> int:
    work = sys.argv[1]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    faulthandler.dump_traceback_later(60, exit=True)
    torch.set_num_threads(1)
    with open(os.path.join(work, "config.json")) as f:
        config = json.load(f)
    config["init_method"] = f"file://{work}/rdzv"
    ln = Learner(rank, world, config, group_name="learners")
    rollout = dict(np.load(os.path.join(work, "rollout.npz")))
    result = ln.update([rollout] if rank == 0 else [])
    np.savez(os.path.join(work, f"out_{rank}.npz"), samples=result["samples"],
             **learner_state(ln))
    return 0


if __name__ == "__main__":
    sys.exit(main())
