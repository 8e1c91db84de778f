"""Model zoo: the Llama-family transformer (dense: forward, loss, training)."""

from ray_tpu_torch.models.llama import (  # noqa: F401
    AdamW,
    LlamaConfig,
    llama_forward,
    llama_init,
    llama_loss,
    make_train_step,
    params_from_numpy,
)
