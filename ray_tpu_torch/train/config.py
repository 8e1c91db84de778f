"""Training configs: a copy of ``ray_tpu/train/config.py`` (Ray AIR's
ScalingConfig/RunConfig/CheckpointConfig/FailureConfig) with GPUs in place
of TPUs: ``use_gpu`` for ``use_tpu``, backends ``"nccl"``/``"gloo"``, and
no ``topology`` (TPU slices have no GPU counterpart).

As everywhere in the port, the workers run on the card unless the caller
asks for the CPU: ``use_gpu=None`` (the default) means the card and raises
without CUDA; only ``use_gpu=False`` gives CPU workers on gloo."""

from __future__ import annotations

import dataclasses

from ray_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    #: None: the card (raises without CUDA); False: the CPU
    use_gpu: bool | None = None
    #: resources per worker actor, e.g. {"GPU": 0.5} (two workers a card)
    resources_per_worker: dict[str, float] | None = None
    #: the placement group's strategy
    placement_strategy: str = "PACK"
    #: per-worker collective backend: "nccl" on the cards, "gloo" otherwise
    collective_backend: str | None = None

    def worker_resources(self) -> dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.gpu():
            res.setdefault("GPU", 1.0)
        return res

    def backend(self) -> str:
        if self.collective_backend:
            return self.collective_backend
        return "nccl" if self.gpu() else "gloo"

    def gpu(self) -> bool:
        """Whether the workers run on cards: ``use_gpu`` resolved as an
        entry point's device is (``None`` is the card)."""
        want = None if self.use_gpu is None else ("cuda" if self.use_gpu else "cpu")
        return resolve_device(want).type == "cuda"


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: int | None = None
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class FailureConfig:
    #: worker-group restarts before giving up (-1 = unlimited)
    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
