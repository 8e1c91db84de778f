"""Accelerator managers: NVIDIA GPUs (``ray_tpu/accelerators`` has TPUs)."""
from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager  # noqa: F401
