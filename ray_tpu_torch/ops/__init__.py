"""Core tensor ops: norms, rotary embeddings, attention dispatch, the flash
kernels and the remat names."""

from ray_tpu_torch.ops.basic import rms_norm, rope, swiglu  # noqa: F401
from ray_tpu_torch.ops.attention import attention  # noqa: F401
from ray_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_plain,
)
from ray_tpu_torch.ops.remat import checkpoint_name, save_only_these_names  # noqa: F401
