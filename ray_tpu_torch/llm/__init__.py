"""ray_tpu_torch.llm — batched generation and the continuous-batching engine.

- generation: prefill/decode_step/generate with left-padded ragged batches
- engine: ContinuousBatchingEngine — paged KV, decode-block admission,
  token streaming, LoRA multiplexing
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
