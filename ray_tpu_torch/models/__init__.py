"""Model zoo: the Llama-family transformer (dense or MoE; forward, loss,
training; the pipelined and tensor-parallel variant)."""

from ray_tpu_torch.models.llama import (  # noqa: F401
    AdamW,
    LlamaConfig,
    llama_forward,
    llama_init,
    llama_loss,
    llama_pp_init,
    llama_pp_loss,
    make_train_step,
    params_from_numpy,
    pp_stage_param_specs,
    stack_pp_params,
)
