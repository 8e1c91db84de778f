"""The training worker actor: the counterpart of ``TrainWorker``
(``ray_tpu/train/trainer.py:46-111``).

``TorchTrainer`` creates one ``TrainWorker`` actor per rank in a placement
group and calls ``setup`` on every rank at once, then ``run``, and drains
the reports with ``poll`` while ``run`` blocks (the actor runs two methods
at a time). ``setup`` sets the worker's card, joins the collective group
(NCCL on the cards, gloo otherwise) and with it the ``torch.distributed``
world, meeting the other ranks through the runtime's GCS KV under the
attempt's group name (``collective.init_collective_group``, as JAX's
``setup`` does), and opens the session; ``run`` imports the loop by name
and runs it.

A worker's card: a whole card is pinned by the runtime's lease
(``CUDA_VISIBLE_DEVICES``, set before any user code runs); a share of one
pins none, so the controller names the card in ``setup``'s spec and the
worker sets it here, before CUDA's first call in the process. Either way
the worker sees one card, ``cuda:0``.
"""

from __future__ import annotations

import importlib
import os
import sys
import traceback
from typing import Any


def _import(ref: str):
    module, _, qualname = ref.partition(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


class TrainWorker:
    """Actor hosting one training rank."""

    def __init__(self, rank: int, world_size: int, trial_name: str, backend: str,
                 group_name: str):
        self.rank = rank
        self.world_size = world_size
        self.trial_name = trial_name
        self.backend = backend
        self.group_name = group_name
        self._done = False
        self._result: Any = None
        self._error: str | None = None
        self._session = None

    def setup(self, spec: dict) -> bool:
        """``spec``: ``use_gpu``, the card of a fractional share
        (``gpu_ids``, else ``None``), the checkpoint to start from, the
        staging directory and the directories to import the loop from."""
        for path in reversed(spec["sys_path"]):
            if path not in sys.path:
                sys.path.insert(0, path)
        from ray_tpu_torch.accelerators import GPUAcceleratorManager

        if spec["gpu_ids"] is not None:
            # before CUDA's first call in this process
            GPUAcceleratorManager.set_current_process_visible_accelerator_ids(spec["gpu_ids"])
        import torch

        from ray_tpu_torch import collective
        from ray_tpu_torch.train.checkpoint import Checkpoint
        from ray_tpu_torch.train.session import TrainContext, init_session

        if self.world_size > 1 and "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(1)  # as torchrun does, not n x all the cores
        if spec["use_gpu"]:
            torch.cuda.set_device(0)
            device = torch.device("cuda", 0)
        else:
            device = torch.device("cpu")
        collective.init_collective_group(self.world_size, self.rank, self.backend,
                                         self.group_name)
        start = Checkpoint.from_directory(spec["checkpoint"]) if spec["checkpoint"] else None
        self._session = init_session(
            TrainContext(world_rank=self.rank, world_size=self.world_size,
                         local_rank=self.rank, trial_name=self.trial_name,
                         collective_group=self.group_name),
            start, spec["staging_dir"], device)
        return True

    def run(self, loop_ref: str, config: dict | None) -> dict:
        """Blocking execution of the user loop (on the actor's executor
        thread; ``poll`` is served meanwhile on the other)."""
        try:
            import torch
            import torch.distributed as dist

            if self._session.device.type == "cuda":
                torch.cuda.set_device(0)  # the current device is per thread
            loop = _import(loop_ref)
            self._result = loop(config) if config is not None else loop()
            dist.destroy_process_group()
            return {"ok": True}
        except Exception as e:  # noqa: BLE001 — reported to the controller
            self._error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            return {"ok": False, "error": self._error}
        finally:
            self._done = True

    def poll(self) -> dict:
        """Drain the session's outbox. ``_done`` is read BEFORE draining: a
        report enqueued between the drain and the done-check would otherwise
        be lost on the final poll."""
        done = self._done
        out = []
        if self._session is not None:
            while not self._session.outbox.empty():
                metrics, ckpt = self._session.outbox.get_nowait()
                out.append((metrics, ckpt.path if ckpt else None))
        return {"reports": out, "done": done, "error": self._error}
