"""Device meshes with named parallelism axes.

Counterpart of ``ray_tpu/parallel/mesh.py``: the same six axes in the same
order (innermost last), as a ``torch.distributed.device_mesh.DeviceMesh``
over the processes of the default group, one process per mesh position.

    dp    data parallel (gradient sum)
    fsdp  fully-sharded parameter axis
    pp    pipeline stages (send/recv hops)
    tp    tensor parallel (Megatron column/row splits)
    sp    sequence/context parallel (ring attention / Ulysses)
    ep    expert parallel (MoE all_to_all)

The caller starts the default group (``torch.distributed.init_process_group``
with its own rendezvous): NCCL for the card, gloo for the CPU (or for two
data-parallel ranks sharing one card, which NCCL refuses).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from ray_tpu_torch.utils.device import resolve_device

AXIS_ORDER = ("dp", "fsdp", "pp", "tp", "sp", "ep")


@dataclass
class MeshSpec:
    """Declarative mesh: axis name -> size; 1-sized axes are kept so specs
    stay valid across scaling changes."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def axes(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_ORDER}

    @property
    def size(self) -> int:
        out = 1
        for v in self.axes.values():
            out *= v
        return out

    def build(self, device=None):
        """A ``DeviceMesh`` over the default group's ranks, in row-major
        ``AXIS_ORDER`` as JAX reshapes its devices. ``device``: ``None``
        means cuda (an NCCL group, or gloo for dp alone); ``"cpu"`` needs
        gloo. The world must hold exactly ``size`` ranks."""
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < self.size:
            raise ValueError(f"mesh needs {self.size} ranks ({self.axes}), have {world}")
        if not dist.is_initialized():
            raise RuntimeError("MeshSpec.build needs torch.distributed.init_process_group first")
        if world != self.size:
            raise ValueError(f"mesh covers {self.size} ranks ({self.axes}); the world has "
                             f"{world}: meshes over part of the world are not supported")
        dev = resolve_device(device)
        # gloo moves CUDA tensors too, but only by broadcast and all-reduce:
        # enough for a mesh whose only split axis is dp (two ranks on one card)
        want = ("nccl", "gloo") if dev.type == "cuda" else ("gloo",)
        if not any(b in str(dist.get_backend()) for b in want):
            raise RuntimeError(f"a {dev.type} mesh needs a {' or '.join(want)} process "
                               f"group, have {dist.get_backend()!r}")
        return init_device_mesh(dev.type, tuple(self.axes.values()),
                                mesh_dim_names=AXIS_ORDER)

    @classmethod
    def infer(cls, n_devices: int, *, tp: int = 1, pp: int = 1, sp: int = 1,
              ep: int = 1, fsdp: int = 1) -> "MeshSpec":
        """Fill the dp axis with whatever devices remain."""
        denom = tp * pp * sp * ep * fsdp
        if n_devices % denom:
            raise ValueError(f"{n_devices} devices not divisible by {denom}")
        return cls(dp=n_devices // denom, fsdp=fsdp, pp=pp, tp=tp, sp=sp, ep=ep)


def get_abstract_mesh(spec: MeshSpec) -> np.ndarray:
    """The mesh's layout with no devices and no process group (tests/dryrun):
    the global rank at each position, shaped by the axes in ``AXIS_ORDER``,
    row-major as ``build`` lays the ranks out."""
    return np.arange(spec.size).reshape(tuple(spec.axes.values()))
