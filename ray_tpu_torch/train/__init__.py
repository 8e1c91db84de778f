"""Distributed training: TorchTrainer over a group of worker actors.

Counterpart of ``ray_tpu/train``: a controller drives one actor of the
port's runtime per rank, the ranks meet in one ``torch.distributed``
world, and the training step shards itself over the mesh (``models.llama.make_train_step`` with a
``MeshSpec`` mesh; DDP/FSDP/TP are the mesh's dp/fsdp/tp axes and
``shard_pytree``'s placements, not wrapper modules).
"""

from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager  # noqa: F401
from ray_tpu_torch.train.session import (  # noqa: F401
    get_checkpoint,
    get_context,
    get_device,
    report,
)
from ray_tpu_torch.train.trainer import Result, TorchTrainer, TrainingFailedError  # noqa: F401
