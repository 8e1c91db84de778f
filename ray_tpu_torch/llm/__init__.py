"""ray_tpu_torch.llm — LLM batch inference and serving.

- generation: prefill/decode_step/generate with left-padded ragged batches
- engine: ContinuousBatchingEngine — paged KV (native, bf16 or int8 pools),
  decode-block admission, token streaming, LoRA multiplexing, page
  adoption (submit_prefilled, scatter_pages, paged_prefill_suffix), page
  export (export_pages) and speculative decoding (n-gram drafter or a
  spec_drafter hook)
- serving: LLMServer (serve.batch coalescing) and LLMEngineServer
  (continuous batching + streaming)
- batch: build_llm_processor over ray_tpu_torch.data datasets
- disagg: disaggregated serving, prefill/decode pools over the KV-page
  plane with a cross-request prefix cache (DisaggLLMServer)
"""
from ray_tpu_torch.llm.engine import ContinuousBatchingEngine, EngineFull
from ray_tpu_torch.llm.generation import generate, generate_tokens, pad_prompts
from ray_tpu_torch.llm.serving import (
    LLMEngineServer,
    LLMServer,
    build_llm_deployment,
    build_llm_engine_deployment,
)
from ray_tpu_torch.llm.batch import build_llm_processor
from ray_tpu_torch.llm.disagg import (
    DecodeWorker,
    DisaggLLMServer,
    KVPageManifest,
    PrefillWorker,
    PrefixCache,
    build_disagg_deployment,
    prefix_hint,
)

__all__ = [
    "ContinuousBatchingEngine",
    "DecodeWorker",
    "DisaggLLMServer",
    "EngineFull",
    "KVPageManifest",
    "LLMEngineServer",
    "LLMServer",
    "PrefillWorker",
    "PrefixCache",
    "build_disagg_deployment",
    "build_llm_deployment",
    "build_llm_engine_deployment",
    "build_llm_processor",
    "generate",
    "generate_tokens",
    "pad_prompts",
]
