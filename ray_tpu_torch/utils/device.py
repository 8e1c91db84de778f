"""Device selection for the port.

Counterpart of ``ray_tpu/utils/device.py`` (``is_tpu``, ``devices``,
``local_device_count``). The port's entry points run on the CUDA card
unless the caller asks for the CPU: with no CUDA device,
``resolve_device(None)`` raises instead of falling back. JAX's
``configure_jax`` (``RT_FORCE_CPU_DEVICES``) has no counterpart: a CPU
world of N ranks is N gloo processes, one device each.
"""
from __future__ import annotations

import torch


def is_cuda() -> bool:
    """True when PyTorch sees a CUDA device."""
    return torch.cuda.is_available()


def is_sm90(index: int = 0) -> bool:
    """True when CUDA device ``index`` is a Hopper part (compute 9.0), the
    target the port's kernels are compiled for."""
    return is_cuda() and torch.cuda.get_device_capability(index) == (9, 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``. Asking
    for CUDA without a CUDA device raises; pass ``device="cpu"`` to run on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not is_cuda():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; "
            "pass device='cpu' to run on the CPU")
    return dev


def devices() -> list[torch.device]:
    """This process's CUDA devices (``jax.devices()``): the visible cards,
    none without CUDA."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_device_count() -> int:
    """``len(devices())``."""
    return len(devices())
