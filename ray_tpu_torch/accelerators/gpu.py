"""NVIDIA GPUs as a scheduling resource.

Counterpart of ``ray_tpu/accelerators/tpu.py`` (``TPUAcceleratorManager``)
for CUDA cards: the visible card ids come from ``CUDA_VISIBLE_DEVICES``
(the environment variable the CUDA runtime reads at its first call), the
node's card count from them or from ``torch.cuda.device_count()``, and the
accelerator type from the device name ("NVIDIA H100 80GB HBM3" -> "H100").

TPU slice topology has no GPU counterpart, so nothing of it is ported:
there is no ``slice_shape``, ``slice_placement_group`` or
``pod_head_resource``, no pod labels, and ``train.ScalingConfig`` has no
``topology``. A card can be shared: a fraction below 1 is a valid request,
so two workers may run on one card.

Node resources produced for a host with one H100:
    {"GPU": 1, "accelerator_type:H100": 1}
"""
from __future__ import annotations

import os
import re

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
NOSET_CUDA_VISIBLE_DEVICES_ENV = "RT_NOSET_CUDA_VISIBLE_DEVICES"
# the model after the vendor: "NVIDIA H100 80GB HBM3" -> "H100",
# "Tesla V100-SXM2-16GB" -> "V100"
_NAME_PATTERN = re.compile(r"\w+\s+([A-Z0-9]+)")


class GPUAcceleratorManager:
    """Static environment and device introspection (one per process)."""

    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    # ---------------------------------------------------------- detection
    @staticmethod
    def get_current_process_visible_accelerator_ids() -> list[str] | None:
        """The ids ``CUDA_VISIBLE_DEVICES`` names; ``None`` when it is unset,
        ``[]`` when it is empty (no card visible)."""
        visible = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if visible is None:
            return None
        if visible == "":
            return []
        return visible.split(",")

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        """Cards this process may use: the visible ids, else what CUDA
        counts."""
        visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        if visible is not None:
            return len(visible)
        import torch

        return torch.cuda.device_count()

    @staticmethod
    def get_current_node_accelerator_type() -> str | None:
        """The card's model, e.g. "H100"; ``None`` without a card, or where
        this process's torch cannot name it (no CUDA)."""
        if GPUAcceleratorManager.get_current_node_num_accelerators() == 0:
            return None
        import torch

        if not torch.cuda.is_available():
            return None
        match = _NAME_PATTERN.match(torch.cuda.get_device_name(0))
        return match.group(1) if match else None

    # ---------------------------------------------------------- resources
    @staticmethod
    def get_current_node_resources() -> dict[str, float]:
        """Resource dict for node registration: the card count and the
        accelerator-type marker."""
        n = GPUAcceleratorManager.get_current_node_num_accelerators()
        if n <= 0:
            return {}
        resources: dict[str, float] = {"GPU": float(n)}
        kind = GPUAcceleratorManager.get_current_node_accelerator_type()
        if kind:
            resources[f"accelerator_type:{kind}"] = 1.0
        return resources

    # ---------------------------------------------------------- isolation
    @staticmethod
    def validate_resource_request_quantity(quantity: float) -> tuple[bool, str | None]:
        """A share of one card (0 < q < 1) or a whole number of cards."""
        if quantity <= 0:
            return False, f"requested GPU={quantity}: must be positive"
        if quantity > 1 and quantity != int(quantity):
            return (False, f"requested GPU={quantity}: above 1 only whole cards can be "
                    "requested")
        return True, None

    @staticmethod
    def set_current_process_visible_accelerator_ids(visible_ids: list[str]) -> None:
        """Restrict this process to ``visible_ids`` through
        ``CUDA_VISIBLE_DEVICES`` (before CUDA's first call in the process),
        unless ``RT_NOSET_CUDA_VISIBLE_DEVICES`` is set."""
        if os.environ.get(NOSET_CUDA_VISIBLE_DEVICES_ENV):
            return
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(i) for i in visible_ids)
