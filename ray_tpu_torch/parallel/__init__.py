"""Parallelism library: meshes, sharding recipes, SP/PP/TP/EP modules.

Counterpart of ``ray_tpu/parallel``: a ``DeviceMesh`` with named axes and
partition-spec rules (DP/FSDP/TP), ring attention and Ulysses over a
sequence axis, a GPipe pipeline, and expert-parallel MoE — in PyTorch's
local view, one process per mesh position with explicit collectives
(``parallel/comm.py``) and autograd through them.
"""

from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec, get_abstract_mesh  # noqa: F401
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    PartitionRules,
    shard_pytree,
    specs_for_pytree,
)
