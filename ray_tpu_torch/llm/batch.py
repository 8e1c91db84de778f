"""Batch LLM inference over ``ray_tpu_torch.data`` datasets.

Counterpart of ``ray_tpu/llm/batch.py``: a processor maps batched
``generate`` over a dataset with ``map_batches``, one call per batch.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.llm import generation as _generation
from ray_tpu_torch.models.llama import llama_init
from ray_tpu_torch.utils.device import resolve_device


def build_llm_processor(model_config, *, params=None, batch_size: int = 8,
                        max_new_tokens: int = 32, temperature: float = 0.0,
                        input_column: str = "prompt_tokens",
                        output_column: str = "completion_tokens",
                        device=None) -> Callable:
    """Returns dataset -> dataset applying batched generation. Without
    ``params``, weights are a random init from seed 0 on ``device`` (None
    means cuda), made once per config and device."""

    def apply(dataset):
        def infer_batch(batch: dict[str, Any]) -> dict[str, Any]:
            p = params
            if p is None:
                p = _cached_params(model_config, device)
            prompts = [list(map(int, row)) for row in batch[input_column]]
            outs = _generation.generate(p, model_config, prompts,
                                        max_new_tokens=max_new_tokens,
                                        temperature=temperature)
            out = dict(batch)
            out[output_column] = outs
            return out

        return dataset.map_batches(infer_batch, batch_size=batch_size)

    return apply


_param_cache: dict = {}


def _cached_params(cfg, device=None):
    """Random-init weights once per (config, device) (testing and
    benchmarking path; real weights arrive via the params argument)."""
    dev = resolve_device(device)
    key = (cfg, str(dev))  # LlamaConfig is a frozen (hashable) dataclass
    if key not in _param_cache:
        _param_cache[key] = llama_init(
            torch.Generator(device=dev).manual_seed(0), cfg, dev)
    return _param_cache[key]
