"""NVIDIA GPUs as a scheduling resource.

Counterpart of ``ray_tpu/accelerators/tpu.py`` (``TPUAcceleratorManager``)
for CUDA cards: the visible card ids come from ``CUDA_VISIBLE_DEVICES``
(the environment variable the CUDA runtime reads at its first call), the
node's card count from them or from NVML, and the accelerator type from
the device name NVML gives ("NVIDIA H100 80GB HBM3" -> "H100").

NVML (``libnvidia-ml.so.1``, loaded through ``ctypes``) names and counts
the cards without torch and without a CUDA context, so a raylet (and
``start``) imports no torch to register its node. A host where the library
does not load has no card.

TPU slice topology has no GPU counterpart, so nothing of it is ported:
there is no ``slice_shape``, ``slice_placement_group`` or
``pod_head_resource``, no pod labels, and ``train.ScalingConfig`` has no
``topology``. A card can be shared: a fraction below 1 is a valid request,
so two workers may run on one card.

Node resources produced for a host with one H100:
    {"GPU": 1, "accelerator_type:H100": 1}
"""
from __future__ import annotations

import ctypes
import os
import re

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
NOSET_CUDA_VISIBLE_DEVICES_ENV = "RT_NOSET_CUDA_VISIBLE_DEVICES"
# the model after the vendor: "NVIDIA H100 80GB HBM3" -> "H100",
# "Tesla V100-SXM2-16GB" -> "V100"
_NAME_PATTERN = re.compile(r"\w+\s+([A-Z0-9]+)")
NVML_LIBRARY = "libnvidia-ml.so.1"
_NVML_NAME_BYTES = 96  # NVML_DEVICE_NAME_V2_BUFFER_SIZE


def nvml_device_names() -> list[str]:
    """Every card's name on this host, in NVML's order (which CUDA's
    default order follows: both sort by PCI bus id); ``[]`` where
    ``NVML_LIBRARY`` does not load or does not initialise."""
    try:
        nvml = ctypes.CDLL(NVML_LIBRARY)
    except OSError:
        return []
    for fn, argtypes in (
            ("nvmlInit_v2", []), ("nvmlShutdown", []),
            ("nvmlDeviceGetCount_v2", [ctypes.POINTER(ctypes.c_uint)]),
            ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]),
            ("nvmlDeviceGetName", [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint])):
        getattr(nvml, fn).argtypes = argtypes
        getattr(nvml, fn).restype = ctypes.c_int  # nvmlReturn_t: 0 is NVML_SUCCESS
    if nvml.nvmlInit_v2() != 0:
        return []
    try:
        count = ctypes.c_uint(0)
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return []
        names = []
        for i in range(count.value):
            handle = ctypes.c_void_p()
            name = ctypes.create_string_buffer(_NVML_NAME_BYTES)
            if (nvml.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(handle)) != 0
                    or nvml.nvmlDeviceGetName(handle, name, _NVML_NAME_BYTES) != 0):
                names.append("")
            else:
                names.append(name.value.decode(errors="replace"))
        return names
    finally:
        nvml.nvmlShutdown()


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
        """Cards this process may use: the visible ids, else what NVML
        counts."""
        visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        if visible is not None:
            return len(visible)
        return len(nvml_device_names())

    @staticmethod
    def get_current_node_accelerator_type() -> str | None:
        """The model of this process's first card, e.g. "H100"; ``None``
        without a card, or where NVML cannot name it."""
        visible = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        if visible == []:
            return None
        names = nvml_device_names()
        first = 0
        if visible and visible[0].strip().isdigit():
            first = int(visible[0])  # a UUID names no index: take NVML's first
        if first >= len(names):
            return None
        match = _NAME_PATTERN.match(names[first])
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
