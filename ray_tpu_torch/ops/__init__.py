"""Core tensor ops: norms, rotary embeddings, attention dispatch, the flash kernel."""

from ray_tpu_torch.ops.basic import rms_norm, rope, swiglu  # noqa: F401
from ray_tpu_torch.ops.attention import attention  # noqa: F401
from ray_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_plain,
)
