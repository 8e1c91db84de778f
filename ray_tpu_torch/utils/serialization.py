"""Tensors carried as host numpy.

Counterpart of the jax.Array path of ``ray_tpu/utils/serialization.py``
(``:152-207``: a device array travels as host numpy and is put back on a
device when it is read). ``to_host`` copies every tensor of a tree (dicts,
lists, tuples) to numpy and ``from_host`` puts every array back as a tensor
on a device; other leaves pass through. numpy has no bfloat16, so a
bfloat16 tensor travels as its uint16 bit pattern inside a ``HostTensor``
that names the dtype, as the KV pages of ``llm/disagg/kv_plane.py`` do. A
``DTensor`` travels whole (``full_tensor()``, a collective every rank of
its mesh must join).

Nothing else of that file is ported: the shm wire format, cloudpickle
shipping of functions and the Arrow path ride on the JAX package's runtime.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class HostTensor:
    """A tensor whose dtype numpy lacks: its bits and the torch dtype name."""

    bits: np.ndarray
    dtype: str

    def to_tensor(self, device) -> torch.Tensor:
        return _tensor(self.bits.view(np.int16)).view(getattr(torch, self.dtype)).to(device)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a`` (over a copy where ``a`` is read-only)."""
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _tensor_to_host(t: torch.Tensor):
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return HostTensor(t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16")
    return t.cpu().numpy()


def to_host(tree):
    """``tree`` with every tensor copied to host numpy (bfloat16 as a
    ``HostTensor``)."""
    if isinstance(tree, torch.Tensor):
        return _tensor_to_host(tree)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def from_host(tree, device):
    """``tree`` with every numpy array and ``HostTensor`` made a tensor on
    ``device`` (the inverse of ``to_host``; other leaves as they are)."""
    if isinstance(tree, HostTensor):
        return tree.to_tensor(device)
    if isinstance(tree, np.ndarray):
        return _tensor(tree).to(device)
    if isinstance(tree, dict):
        return {k: from_host(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_host(v, device) for v in tree)
    return tree
