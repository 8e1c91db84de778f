"""One training worker process: the counterpart of ``TrainWorker``
(``ray_tpu/train/trainer.py``), run by ``TorchTrainer`` as

    python -m ray_tpu_torch.train.worker <spec.pkl>

The spec (written by the controller) names the rank, the world, the
collective backend and its file rendezvous, the visible cards, the loop
(``"module:qualname"``, with the directories to import it from), its
config, the checkpoint to start from and the channel for reports. The
worker sets its visible card and ``torch.cuda.set_device``, joins the
process group and the collective group, opens the session, imports and
runs the loop, and sends its reports, then its result or its traceback,
to the controller.
"""

from __future__ import annotations

import importlib
import pickle
import sys
import traceback


def _import(ref: str):
    module, _, qualname = ref.partition(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def main(argv: list[str]) -> int:
    with open(argv[1], "rb") as f:
        spec = pickle.load(f)
    sys.path[:0] = spec["sys_path"]

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import collective
    from ray_tpu_torch.accelerators import GPUAcceleratorManager
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.session import Channel, TrainContext, init_session

    channel = Channel(spec["channel"])
    try:
        if spec["gpu_ids"] is not None:
            # before CUDA's first call in this process
            GPUAcceleratorManager.set_current_process_visible_accelerator_ids(spec["gpu_ids"])
            torch.cuda.set_device(0)
            device = torch.device("cuda", 0)
        else:
            device = torch.device("cpu")
        rank, world = spec["rank"], spec["world_size"]
        dist.init_process_group(spec["backend"], init_method=spec["init_method"], rank=rank,
                                world_size=world)
        collective.init_collective_group(world, rank, spec["backend"], spec["group_name"])
        start = Checkpoint.from_directory(spec["checkpoint"]) if spec["checkpoint"] else None
        init_session(TrainContext(world_rank=rank, world_size=world, local_rank=rank,
                                  trial_name=spec["trial_name"],
                                  collective_group=spec["group_name"]),
                     start, channel, spec["staging_dir"], device)
        loop = _import(spec["loop"])
        config = spec["config"]
        result = loop(config) if config is not None else loop()
        dist.destroy_process_group()
        channel.put(("done", result))
    except Exception as e:  # the controller reports it and ends the group
        channel.put(("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
        return 1
    return 0


if __name__ == "__main__":
    sys.stdout.reconfigure(line_buffering=True)
    sys.exit(main(sys.argv))
