"""Batch LLM inference over ``ray_tpu_torch.data`` datasets.

Counterpart of ``ray_tpu/llm/batch.py``: a processor maps batched
``generate`` over a dataset with ``map_batches``, so each batch is one map
task of the data executor on the runtime's workers, one ``generate`` call
per task. On the card each task leases a whole card from the runtime, so
no more tasks hold weights at once than there are cards (the executor
keeps up to 8 in flight), and a task worker keeps its lease, and its
weights, from block to block.
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
    ``params``, each task worker draws the weights itself, a random init
    from seed 0 on ``device`` (None means cuda), once per config and
    device. Given ``params`` travel with every task by value: each task's
    copy is sealed into the caller's shm arena and read from there. On a CUDA
    ``device`` each task leases one card."""
    on_card = torch.device("cuda" if device is None else device).type == "cuda"

    def apply(dataset):
        def infer_batch(batch: dict[str, Any]) -> dict[str, Any]:
            p = params
            if p is None:
                p = _cached_params(model_config, device)
            prompts = [list(map(int, row)) for row in batch[input_column]]
            outs = _generation.generate(p, model_config, prompts,
                                        max_new_tokens=max_new_tokens,
                                        temperature=temperature)
            _record_batch(len(prompts))
            out = dict(batch)
            out[output_column] = outs
            return out

        return dataset.map_batches(infer_batch, batch_size=batch_size,
                                   num_gpus=1 if on_card else None)

    return apply


_param_cache: dict = {}
# the rows of each generate call this process's processors made, in order
GENERATE_BATCHES: list[int] = []


def _record_batch(n: int) -> None:
    # a module function, so the map (which travels by value, with copies
    # of the globals it names) appends to this process's list
    GENERATE_BATCHES.append(n)


def _cached_params(cfg, device=None):
    """Random-init weights once per (config, device) in this process
    (testing and benchmarking path; real weights arrive via the params
    argument)."""
    dev = resolve_device(device)
    key = (cfg, str(dev))  # LlamaConfig is a frozen (hashable) dataclass
    if key not in _param_cache:
        _param_cache[key] = llama_init(
            torch.Generator(device=dev).manual_seed(0), cfg, dev)
    return _param_cache[key]
