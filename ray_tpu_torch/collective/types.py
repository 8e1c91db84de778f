"""Collective op types (counterpart of ``ray_tpu/collective/types.py``)."""

from __future__ import annotations

import enum


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MAX = "max"
    MIN = "min"
    MEAN = "mean"


class Backend:
    NCCL = "nccl"  # CUDA tensors over NVLink/PCIe (JAX's XLA collectives)
    GLOO = "gloo"  # host tensors; the CPU worlds of the tests (JAX's CPU fake)
