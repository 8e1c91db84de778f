"""Model zoo: the Llama-family transformer (dense, forward)."""

from ray_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    llama_forward,
    llama_init,
    llama_loss,
    params_from_numpy,
)
