"""ray_tpu_torch.llm — batched generation and the continuous-batching engine.

- generation: prefill/decode_step/generate with left-padded ragged batches
- engine: ContinuousBatchingEngine — paged KV (native, bf16 or int8 pools),
  decode-block admission, token streaming, LoRA multiplexing, page
  adoption (submit_prefilled, scatter_pages, paged_prefill_suffix) and
  speculative decoding (n-gram drafter or a spec_drafter hook)
"""
from ray_tpu_torch.llm.engine import ContinuousBatchingEngine, EngineFull
from ray_tpu_torch.llm.generation import generate, generate_tokens, pad_prompts

__all__ = [
    "ContinuousBatchingEngine",
    "EngineFull",
    "generate",
    "generate_tokens",
    "pad_prompts",
]
