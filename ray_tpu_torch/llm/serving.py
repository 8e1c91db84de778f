"""LLM serving deployments: batched generate and the continuous-batching
engine behind the serve layer.

Counterpart of ``ray_tpu/llm/serving.py``. ``LLMServer`` coalesces
concurrent requests into ONE ``generate`` call per distinct temperature
through ``serve.batch`` (the card wants batch-N decode, not N batch-1
loops); ``LLMEngineServer`` fronts the continuous-batching engine, whose
requests join the running decode batch at block granularity and can
stream. Both speak the same OpenAI-completions-shaped dict protocol:
``{prompt_tokens, max_tokens?, temperature?, model?}`` in,
``{completion_tokens, usage}`` out. The build functions return a bound
``Application``; the port has no ``serve.run`` to deploy it (it rides on
the JAX package's actor runtime), so a caller builds the class in
process.
"""
from __future__ import annotations

import time

import torch

from ray_tpu_torch.llm import engine as _engine
from ray_tpu_torch.llm import generation as _generation
from ray_tpu_torch.models.llama import llama_init
from ray_tpu_torch.serve import batch as _serve_batch
from ray_tpu_torch.serve import deployment as _deployment
from ray_tpu_torch.serve.exceptions import BackPressureError
from ray_tpu_torch.utils.device import resolve_device


def resolve_params(model_config, params=None, params_fn=None, device=None):
    """The weights a server or worker runs: ``params``, else
    ``params_fn()``, else a random init from seed 0 on ``device`` (None
    means cuda, and raises without a card)."""
    if params is None:
        params = params_fn() if params_fn is not None else None
    if params is None:
        dev = resolve_device(device)
        params = llama_init(torch.Generator(device=dev).manual_seed(0),
                            model_config, dev)
    return params


class LLMServer:
    """Deployment class; bind with a model config and a params source."""

    def __init__(self, model_config, params=None, params_fn=None,
                 max_batch_size: int = 8, batch_wait_timeout_s: float = 0.02,
                 default_max_tokens: int = 32, device=None):
        self.cfg = model_config
        self.params = resolve_params(model_config, params, params_fn, device)
        self.default_max_tokens = default_max_tokens
        self._batched = _serve_batch(
            max_batch_size=max_batch_size,
            batch_wait_timeout_s=batch_wait_timeout_s,
        )(self._generate_batch)

    async def _generate_batch(self, requests: list[dict]) -> list[dict]:
        t0 = time.monotonic()
        max_new = max(
            int(r.get("max_tokens", self.default_max_tokens)) for r in requests
        )
        # sampling settings are per request: decode one sub-batch per
        # distinct temperature so no request's settings are overridden
        by_temp: dict[float, list[int]] = {}
        for i, r in enumerate(requests):
            by_temp.setdefault(float(r.get("temperature", 0.0)), []).append(i)
        outs: list = [None] * len(requests)
        for temp, idxs in by_temp.items():
            sub = _generation.generate(
                self.params, self.cfg,
                [list(requests[i]["prompt_tokens"]) for i in idxs],
                max_new_tokens=max_new, temperature=temp,
            )
            for i, o in zip(idxs, sub):
                outs[i] = o
        dt = time.monotonic() - t0
        results = []
        for r, out in zip(requests, outs):
            want = int(r.get("max_tokens", self.default_max_tokens))
            results.append({
                "completion_tokens": out[:want],
                "usage": {
                    "prompt_tokens": len(r["prompt_tokens"]),
                    "completion_tokens": want,
                    "batch_size": len(requests),
                    "latency_s": dt,
                },
            })
        return results

    async def __call__(self, request: dict) -> dict:
        """request: {prompt_tokens: [...], max_tokens?, temperature?}"""
        return await self._batched(request)


class LLMEngineServer:
    """Deployment around the continuous-batching engine. Requests join the
    running decode batch at block granularity; responses can stream;
    "model" selects a LoRA adapter."""

    def __init__(self, model_config, params=None, params_fn=None, *,
                 max_batch: int = 8, page_size: int = 16, n_pages: int = 512,
                 max_seq_len: int = 512, eos_id: int | None = None,
                 lora_adapters: dict | None = None, lora_rank: int = 8,
                 default_max_tokens: int = 32, kv_dtype: str | None = None,
                 device=None):
        params = resolve_params(model_config, params, params_fn, device)
        self.engine = _engine.ContinuousBatchingEngine(
            params, model_config, max_batch=max_batch, page_size=page_size,
            n_pages=n_pages, max_seq_len=max_seq_len, eos_id=eos_id,
            lora_adapters=lora_adapters, lora_rank=lora_rank,
            kv_dtype=kv_dtype)
        self.default_max_tokens = default_max_tokens

    async def _ensure_started(self):
        await self.engine.start()

    def _submit(self, request: dict) -> int:
        """Queue the request on the engine. ``EngineFull`` becomes the
        typed, never-dispatched ``BackPressureError`` that callers retry;
        a bad request (empty prompt, out-of-vocab ids) stays a
        ``ValueError``."""
        try:
            return self.engine.submit(
                list(request["prompt_tokens"]),
                max_tokens=int(request.get("max_tokens",
                                           self.default_max_tokens)),
                temperature=float(request.get("temperature", 0.0)),
                adapter=request.get("model"),
            )
        except _engine.EngineFull as e:
            raise BackPressureError(
                f"LLM engine full: {e}",
                # a waiting slot frees at decode-block granularity; queue
                # depth is the best local estimate of the drain time
                retry_after_s=min(2.0,
                                  0.02 * (1 + len(self.engine.waiting))),
            ) from None

    async def __call__(self, request: dict) -> dict:
        """Full completion: {prompt_tokens, max_tokens?, temperature?,
        model?} -> {completion_tokens, usage}."""
        await self._ensure_started()
        t0 = time.monotonic()
        rid = self._submit(request)
        # block-granular drain: one loop wake per decode block, not per token
        out: list[int] = []
        async for blk in self.engine.stream_blocks(rid):
            out.extend(blk)
        return {
            "completion_tokens": out,
            "usage": {
                "prompt_tokens": len(request["prompt_tokens"]),
                "completion_tokens": len(out),
                "latency_s": time.monotonic() - t0,
            },
        }

    async def stream(self, request: dict):
        """Async generator of token ids. An abandoned consumer cancels the
        request: the decode slot and its KV pages free at the next block
        boundary, not when the generation would have finished."""
        await self._ensure_started()
        rid = self._submit(request)
        try:
            async for tok in self.engine.stream(rid):
                yield tok
        finally:
            self.engine.cancel(rid)  # no-op once finished

    async def stream_deltas(self, request: dict):
        """One ``{"tokens": [...]}`` delta per fused decode block, then a
        terminal ``{"tokens": [], "done": True, "usage": ...}``.
        Token-identical to ``__call__``'s completion_tokens. Closing the
        stream mid-generation cancels the engine request."""
        await self._ensure_started()
        t0 = time.monotonic()
        rid = self._submit(request)
        n = 0
        try:
            async for blk in self.engine.stream_blocks(rid):
                n += len(blk)
                yield {"tokens": blk}
            yield {
                "tokens": [],
                "done": True,
                "usage": {
                    "prompt_tokens": len(request["prompt_tokens"]),
                    "completion_tokens": n,
                    "latency_s": time.monotonic() - t0,
                },
            }
        finally:
            self.engine.cancel(rid)  # no-op once finished

    def engine_stats(self) -> dict:
        return {"steps": self.engine.steps, "tokens_out": self.engine.tokens_out,
                "waiting": len(self.engine.waiting),
                "free_pages": len(self.engine.free_pages)}


def build_llm_engine_deployment(model_config, *, params=None, params_fn=None,
                                num_replicas: int = 1, num_gpus: float = 0.0,
                                name: str = "LLMEngineServer", **engine_kw):
    """Bound application around the continuous-batching engine."""
    opts: dict = {}
    if num_gpus:
        opts["num_gpus"] = num_gpus
    dep = _deployment(
        LLMEngineServer,
        name=name,
        num_replicas=num_replicas,
        max_ongoing_requests=64,
        ray_actor_options=opts,
    )
    return dep.bind(model_config, params, params_fn, **engine_kw)


def build_llm_deployment(model_config, *, params=None, params_fn=None,
                         num_replicas: int = 1, max_batch_size: int = 8,
                         num_gpus: float = 0.0, name: str = "LLMServer"):
    """Bound application for a Llama config around ``LLMServer``."""
    opts: dict = {}
    if num_gpus:
        opts["num_gpus"] = num_gpus
    dep = _deployment(
        LLMServer,
        name=name,
        num_replicas=num_replicas,
        max_ongoing_requests=max_batch_size * 2,
        ray_actor_options=opts,
    )
    return dep.bind(model_config, params, params_fn, max_batch_size)
