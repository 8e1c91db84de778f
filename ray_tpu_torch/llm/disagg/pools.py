"""Prefill/decode worker pools: the two halves of disaggregated serving.

Counterpart of ``ray_tpu/llm/disagg/pools.py``. Prefill is a
throughput-bound batch of products, decode a latency-bound loop over
memory; run together, each becomes the other's tail (DistServe, Zhong et
al., OSDI'24). Here the two phases run in separate workers joined only by
the KV-page plane. The scheduler (scheduler.py) runs each as an async
actor of the port's runtime and awaits its methods; the classes also work
as plain objects on one event loop.

- :class:`PrefillWorker` owns a staging paged pool. Concurrent ``prefill``
  calls accumulate into padded waves (one ``paged_prefill_batch`` dispatch
  per pad bucket, the engine's own admission-wave shape, run standalone);
  each prompt's pages are then sealed into the local shm arena
  (:func:`ship_pages`) and the pool rows are freed at once: the pool is a
  staging buffer, the arena is the KV's home. A ``prefix`` manifest
  switches the call onto ``paged_prefill_suffix``: the cached prefix pages
  are adopted into the staging pool as they are and only the suffix runs
  through the model.
- :class:`DecodeWorker` wraps the continuous-batching engine and admits
  requests ONLY with adopted KV (``submit_prefilled``), so its decode
  never runs a prefill.

A worker builds on ``device``: weights given by value move there, and
without them it draws its own seed-0 weights there (``resolve_params``).
``device=None`` keeps given weights where they lie and draws missing ones
on the card; the scheduler passes the card explicitly unless told
``device="cpu"``, and asking for the card without a CUDA device raises.
Queue-time telemetry: every prefill job records
``prefill_queue`` (enqueue -> wave dispatch), every adopted request
``decode_queue`` (submit -> first token); ``kv_ship`` is recorded by the
plane.
"""
from __future__ import annotations

import asyncio
import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch.accelerators import GPUAcceleratorManager
from ray_tpu_torch.core.ref import ObjectLostError
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.llm import engine as _engine
from ray_tpu_torch.llm.disagg import telemetry
from ray_tpu_torch.llm.disagg.kv_plane import (
    KVPageManifest,
    KVShipError,
    adopt_pages,
    ship_pages,
)
from ray_tpu_torch.llm.serving import resolve_params
from ray_tpu_torch.serve.exceptions import BackPressureError
from ray_tpu_torch.utils.device import resolve_device


def _worker_params(model_config, params, params_fn, device, gpu_ids):
    """The weights a pool worker runs: ``resolve_params``'s, moved to
    ``device`` when one is given (None keeps given weights where they
    are, and draws missing ones on the card). ``gpu_ids`` names the card
    of a worker that leases a share of one, which the runtime's lease does
    not pin: set here, before CUDA's first call in the process, so the
    worker sees that card as ``cuda:0``."""
    if gpu_ids is not None:
        GPUAcceleratorManager.set_current_process_visible_accelerator_ids(gpu_ids)
    params = resolve_params(model_config, params, params_fn, device)
    if device is None:
        return params
    return _moved(params, resolve_device(device))


def _moved(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _moved(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_moved(v, dev) for v in tree)
    return tree


@dataclass
class _Job:
    tokens: list[int]
    temperature: float
    aid: int
    prefix: KVPageManifest | None
    fut: asyncio.Future
    t_enq: int = field(default_factory=time.perf_counter_ns)
    # owning request's (trace_id, span_id), captured ONCE at enqueue: the
    # wave loop runs outside the request's context, so batch-stamped
    # telemetry (queue span, page-seal span) carries this instead
    tctx: tuple | None = None


class PrefillWorker:
    """Stateless-per-request prefill worker: prompts in, manifests out.
    Run as an actor with ``max_concurrency > 1`` (the scheduler does), so
    concurrent calls coalesce into one padded wave."""

    #: wave padding buckets, the engine's shape discipline
    _WAVE_BUCKETS = _engine.ContinuousBatchingEngine._WAVE_BUCKETS

    def __init__(self, model_config, params=None, params_fn=None, *,
                 page_size: int = 16, n_pages: int = 256,
                 max_wave: int = 8, wave_wait_s: float = 0.004,
                 kv_dtype: str | None = None,
                 lora_adapters: dict | None = None, lora_rank: int = 8,
                 seed: int = 0, device=None, gpu_ids: list | None = None):
        self.cfg = model_config
        self.params = _worker_params(model_config, params, params_fn, device,
                                     gpu_ids)
        self.device = self.params["tok"]["embedding"].device
        self.PS = page_size
        self.n_pages = n_pages
        self.kv_dtype = kv_dtype or "native"
        self.kpool, self.vpool = _engine.make_kv_pools(
            model_config, page_size, n_pages, kv_dtype, self.device)
        self.free_pages = list(range(1, n_pages))  # page 0 = junk page
        self.loras = None
        self.lora_index = {"__base__": 0}
        if lora_adapters:
            self.loras, self.lora_index = _engine.make_lora_stack(
                model_config, lora_adapters, lora_rank, self.device)
        self.max_wave = max_wave
        self.wave_wait_s = wave_wait_s
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._pending: list[_Job] = []
        self._arrived: asyncio.Event | None = None
        self._task = None
        self.waves = 0

    # ------------------------------------------------------------- public
    async def prefill(self, token_ids, *, temperature: float = 0.0,
                      adapter: str | None = None,
                      prefix: KVPageManifest | None = None):
        """Prefill one prompt (or, with ``prefix``, only its suffix over the
        cached prefix pages) and return ``(manifest, first_token)``. The
        manifest covers exactly the pages THIS call produced (the suffix
        pages when ``prefix`` is given); adoption appends them to the
        prefix's. Concurrent calls batch into one padded wave."""
        aid = self.lora_index.get(adapter or "__base__")
        if aid is None:
            raise ValueError(f"unknown LoRA adapter {adapter!r} "
                             f"(loaded: {sorted(self.lora_index)})")
        tokens = [int(t) for t in token_ids]
        if not tokens:
            raise ValueError("empty prompt" if prefix is None
                             else "suffix prefill needs >= 1 suffix token")
        if min(tokens) < 0 or max(tokens) >= self.cfg.vocab_size:
            # JAX clamps an out-of-vocab id; a CUDA gather would fault
            raise ValueError(f"prompt token outside the vocab "
                             f"[0, {self.cfg.vocab_size})")
        if prefix is not None:
            if prefix.n_tokens % self.PS:
                raise ValueError(
                    f"prefix must be page-aligned, got {prefix.n_tokens} "
                    f"tokens at page_size {self.PS}")
            if prefix.kv_dtype != self.kv_dtype:
                raise ValueError(
                    f"prefix kv_dtype {prefix.kv_dtype!r} != pool "
                    f"{self.kv_dtype!r}")
        need = self._pages_needed(tokens, prefix)
        if need > self.n_pages - 1:
            raise ValueError(
                f"prompt needs {need} staging pages but the prefill pool "
                f"only has {self.n_pages - 1}")
        loop = asyncio.get_running_loop()
        if self._arrived is None:
            self._arrived = asyncio.Event()
        if self._task is None or self._task.done():
            self._task = loop.create_task(self._wave_loop())
        job = _Job(tokens, float(temperature), aid, prefix,
                   loop.create_future(),
                   tctx=telemetry.capture_trace_ctx())
        self._pending.append(job)
        self._arrived.set()
        return await job.fut

    def headroom(self) -> dict:
        return {"free_pages": len(self.free_pages),
                "pending": len(self._pending),
                "page_size": self.PS, "kv_dtype": self.kv_dtype}

    def disagg_counters(self) -> dict:
        """This process's KV-plane byte/op ledger (the scheduler sums these
        across the pool)."""
        return telemetry.counters()

    # ---------------------------------------------------------- internals
    def _pages_needed(self, tokens: list[int], prefix) -> int:
        if prefix is None:
            return -(-len(tokens) // self.PS)
        return prefix.n_pages + -(-len(tokens) // self.PS)

    async def _wave_loop(self):
        while True:
            while not self._pending:
                self._arrived.clear()
                await self._arrived.wait()
            # let a wave accumulate: concurrent callers land within this
            # window and share one dispatch
            await asyncio.sleep(self.wave_wait_s)
            wave: list[_Job] = []
            free = len(self.free_pages)
            while self._pending and len(wave) < self.max_wave:
                need = self._pages_needed(self._pending[0].tokens,
                                          self._pending[0].prefix)
                if need > free and wave:
                    break  # next wave, once these pages are freed
                job = self._pending.pop(0)
                free -= need
                wave.append(job)
            try:
                await self._dispatch_wave(wave)
            except Exception as e:  # noqa: BLE001 — fail the wave's callers
                for job in wave:
                    if not job.fut.done():
                        job.fut.set_exception(e)

    def _alloc(self, n: int) -> list[int]:
        if n > len(self.free_pages):
            # only if pages leaked: a short allocation would leave table
            # entries at 0 and write KV into the shared junk page
            raise RuntimeError(
                f"staging pool exhausted: need {n} pages, "
                f"{len(self.free_pages)} free")
        out = self.free_pages[:n]
        del self.free_pages[:n]
        return out

    def _h2d(self, arr):
        return torch.tensor(arr, device=self.device)

    async def _dispatch_wave(self, wave: list[_Job]):
        t_dispatch = time.perf_counter_ns()
        full: dict[int, list[_Job]] = {}
        sfx: dict[tuple[int, int], list[_Job]] = {}
        for job in wave:
            telemetry.record(telemetry.PREFILL_QUEUE,
                             t_dispatch - job.t_enq, trace_ctx=job.tctx)
            if job.prefix is None:
                Tp_pad = -(-len(job.tokens) // self.PS) * self.PS
                full.setdefault(Tp_pad, []).append(job)
            else:
                Ts_pad = -(-len(job.tokens) // self.PS) * self.PS
                W = job.prefix.n_pages + Ts_pad // self.PS
                sfx.setdefault((Ts_pad, W), []).append(job)
        self.waves += bool(wave)
        for Tp_pad, jobs in full.items():
            self._dispatch_full(Tp_pad, jobs)
        for (Ts_pad, W), jobs in sfx.items():
            await self._dispatch_suffix(Ts_pad, W, jobs)

    def _bucket(self, n: int) -> int:
        return (next(b for b in self._WAVE_BUCKETS if b >= n)
                if n <= self._WAVE_BUCKETS[-1] else n)

    def _finish(self, jobs, first, pages_of):
        """Ship each job's freshly written pages, free the staging rows,
        resolve the futures."""
        first = first.cpu().numpy()  # ONE sync for the whole group
        for j, job in enumerate(jobs):
            try:
                m = ship_pages(self.kpool, self.vpool, pages_of[j],
                               job.tokens, page_size=self.PS,
                               kv_dtype=self.kv_dtype, trace_ctx=job.tctx)
            except Exception as e:  # noqa: BLE001 — per-job failure
                job.fut.set_exception(e)
                continue
            finally:
                self.free_pages.extend(pages_of[j])
            telemetry.count(
                **{"prefills" if job.prefix is None else "suffix_prefills":
                   1})
            job.fut.set_result((m, int(first[j])))

    def _dispatch_full(self, Tp_pad: int, jobs: list[_Job]):
        npages = Tp_pad // self.PS
        nb = self._bucket(len(jobs))
        toks = np.zeros((nb, Tp_pad), np.int64)
        pages = np.zeros((nb, npages), np.int64)  # dummy rows: junk page
        aids = np.zeros(nb, np.int64)
        true_lens = np.ones(nb, np.int64)
        temps = np.zeros(nb, np.float32)
        pages_of = []
        try:
            for j, job in enumerate(jobs):
                mine = self._alloc(-(-len(job.tokens) // self.PS))
                pages_of.append(mine)
                toks[j, :len(job.tokens)] = job.tokens
                pages[j, :len(mine)] = mine
                aids[j] = job.aid
                true_lens[j] = len(job.tokens)
                temps[j] = job.temperature
            first = _engine.paged_prefill_batch(
                self.params, self.loras, self._h2d(aids), self._h2d(toks),
                self._h2d(pages), self.kpool, self.vpool,
                self._h2d(true_lens), self._h2d(temps), self._gen, self.cfg,
                sample=bool((temps > 0).any()))
        except BaseException:
            # a failed dispatch must not leak staging rows: _finish (which
            # normally frees them per job) never ran
            for rows in pages_of:
                self.free_pages.extend(rows)
            raise
        self._finish(jobs, first, pages_of)

    async def _dispatch_suffix(self, Ts_pad: int, W: int, jobs: list[_Job]):
        """Suffix wave: adopt each job's cached prefix pages into the
        staging pool (zero-copy out of shm when the cache lives on this
        node), then run ONLY the suffix through the model.

        Adoption runs off the event loop: with >1 prefill worker a suffix
        prefix may be sealed by a sibling whose loop is likewise inside a
        suffix wave, and a blocking fetch here would deadlock both."""
        loop = asyncio.get_running_loop()
        nb = self._bucket(len(jobs))
        toks = np.zeros((nb, Ts_pad), np.int64)
        pages = np.zeros((nb, W), np.int64)
        aids = np.zeros(nb, np.int64)
        prefix_lens = np.zeros(nb, np.int64)
        true_lens = np.ones(nb, np.int64)
        temps = np.zeros(nb, np.float32)
        pages_of = []   # suffix pages: shipped then freed
        adopted_of = []  # prefix staging pages: freed, never shipped
        try:
            stacks = await asyncio.gather(*(
                loop.run_in_executor(
                    None, functools.partial(adopt_pages, job.prefix,
                                            role="prefill"))
                for job in jobs))
            for j, job in enumerate(jobs):
                k = job.prefix.n_pages
                prows = self._alloc(k)
                adopted_of.append(prows)
                k_stack, v_stack = stacks[j]
                _engine.scatter_pages(self.kpool, prows, k_stack)
                _engine.scatter_pages(self.vpool, prows, v_stack)
                mine = self._alloc(-(-len(job.tokens) // self.PS))
                pages_of.append(mine)
                toks[j, :len(job.tokens)] = job.tokens
                pages[j, :k] = prows
                pages[j, k:k + len(mine)] = mine
                aids[j] = job.aid
                prefix_lens[j] = job.prefix.n_tokens
                true_lens[j] = len(job.tokens)
                temps[j] = job.temperature
            first = _engine.paged_prefill_suffix(
                self.params, self.loras, self._h2d(aids), self._h2d(toks),
                self._h2d(pages), self.kpool, self.vpool,
                self._h2d(prefix_lens), self._h2d(true_lens),
                self._h2d(temps), self._gen, self.cfg,
                sample=bool((temps > 0).any()))
        except BaseException:
            for rows in (*adopted_of, *pages_of):
                self.free_pages.extend(rows)
            raise
        try:
            self._finish(jobs, first, pages_of)
        finally:
            for prows in adopted_of:
                self.free_pages.extend(prows)


class DecodeWorker:
    """Decode worker: the continuous-batching engine, admitting requests
    only with adopted KV. ``EngineFull`` becomes the serve layer's typed
    :class:`BackPressureError` here, so an overloaded decode worker reads
    as backpressure, never as an untyped failure."""

    def __init__(self, model_config, params=None, params_fn=None, *,
                 max_batch: int = 8, page_size: int = 16,
                 n_pages: int = 256, max_seq_len: int = 512,
                 eos_id: int | None = None, kv_dtype: str | None = None,
                 lora_adapters: dict | None = None, lora_rank: int = 8,
                 max_waiting: int = 256, spec_enable: bool = False,
                 spec_k: int = 4, spec_ngram: int = 2, spec_drafter=None,
                 device=None, gpu_ids: list | None = None):
        params = _worker_params(model_config, params, params_fn, device,
                                gpu_ids)
        self.engine = _engine.ContinuousBatchingEngine(
            params, model_config, max_batch=max_batch, page_size=page_size,
            n_pages=n_pages, max_seq_len=max_seq_len, eos_id=eos_id,
            lora_adapters=lora_adapters, lora_rank=lora_rank,
            max_waiting=max_waiting, kv_dtype=kv_dtype,
            spec_enable=spec_enable, spec_k=spec_k, spec_ngram=spec_ngram,
            spec_drafter=spec_drafter)
        # live streaming decodes by the caller's key, for cancel_decode
        self._stream_rids: dict[str, int] = {}

    async def _adopt_submit(self, token_ids, manifest, extra, first_token,
                            max_tokens, temperature, adapter) -> int:
        """Adopt the pages (fetched on a pool thread, so resident decodes
        never stall behind a cross-node page pull) and submit the request;
        ``EngineFull`` becomes ``BackPressureError``, lost pages
        ``KVShipError``."""
        await self.engine.start()
        loop = asyncio.get_running_loop()
        try:
            k_stack, v_stack = await loop.run_in_executor(
                None, adopt_pages, manifest, extra)
        except ObjectLostError as e:
            # onto the plane's typed failure (passthrough-marked): the
            # scheduler re-prefills on it either way
            raise KVShipError(f"adopt: sealed pages lost: {e}") from None
        try:
            return self.engine.submit_prefilled(
                [int(t) for t in token_ids], k_stack, v_stack,
                int(first_token), max_tokens=max_tokens,
                temperature=temperature, adapter=adapter)
        except _engine.EngineFull as e:
            raise BackPressureError(
                f"decode engine full: {e}",
                retry_after_s=0.05 * (1 + len(self.engine.waiting)),
            ) from None

    async def decode_adopted(self, token_ids, manifest: KVPageManifest,
                             extra: KVPageManifest | None = None,
                             first_token: int = 0, *, max_tokens: int = 32,
                             temperature: float = 0.0,
                             adapter: str | None = None) -> list[int]:
        """Adopt a prompt's KV pages and decode: returns the full token list
        (``first_token`` first, as the aggregated engine emits its prefill
        token itself)."""
        rid = await self._adopt_submit(token_ids, manifest, extra,
                                       first_token, max_tokens, temperature,
                                       adapter)
        t_submit = time.perf_counter_ns()
        out: list[int] = []
        async for tok in self.engine.stream(rid):
            if not out:
                # first emission == slot grant: the decode-queue leg
                telemetry.record(telemetry.DECODE_QUEUE,
                                 time.perf_counter_ns() - t_submit)
            out.append(tok)
        # refresh the decode-plane signals (tokens-in-flight gauge, spec
        # windows) on the way out: every completed request keeps the
        # scheduler's and the dashboard's numbers fresh
        telemetry.publish_decode_signals(self.engine)
        return out

    async def decode_adopted_stream(self, token_ids,
                                    manifest: KVPageManifest,
                                    extra: KVPageManifest | None = None,
                                    first_token: int = 0, *,
                                    max_tokens: int = 32,
                                    temperature: float = 0.0,
                                    adapter: str | None = None,
                                    cancel_key: str = ""):
        """Streaming twin of :meth:`decode_adopted`: yields token-id DELTAS,
        one list per fused decode block, concatenating to exactly what
        ``decode_adopted`` returns. Closing the stream, or
        :meth:`cancel_decode` with ``cancel_key``, cancels the engine
        request: its slot and KV pages free at the next block boundary."""
        rid = await self._adopt_submit(token_ids, manifest, extra,
                                       first_token, max_tokens, temperature,
                                       adapter)
        if cancel_key:
            self._stream_rids[cancel_key] = rid
        t_submit = time.perf_counter_ns()
        first = True
        try:
            async for blk in self.engine.stream_blocks(rid):
                if chaos.ENABLED:
                    chaos.point("llm.decode_block", n_tokens=len(blk))
                if first:
                    first = False
                    telemetry.record(telemetry.DECODE_QUEUE,
                                     time.perf_counter_ns() - t_submit)
                yield blk
        finally:
            self.engine.cancel(rid)  # no-op once finished
            if cancel_key:
                self._stream_rids.pop(cancel_key, None)
            telemetry.publish_decode_signals(self.engine)

    def cancel_decode(self, cancel_key: str) -> bool:
        """Cancel a live streaming decode by the caller's key."""
        rid = self._stream_rids.get(cancel_key)
        if rid is None:
            return False
        self.engine.cancel(rid)
        return True

    def headroom(self) -> dict:
        telemetry.publish_decode_signals(self.engine)
        return self.engine.headroom()

    def engine_stats(self) -> dict:
        return {"steps": self.engine.steps,
                "tokens_out": self.engine.tokens_out,
                "waiting": len(self.engine.waiting),
                "free_pages": len(self.engine.free_pages),
                "tokens_in_flight": self.engine.tokens_in_flight(),
                **{k: v for k, v in self.engine.spec_stats().items()
                   if k != "blocks"}}

    def disagg_counters(self) -> dict:
        return telemetry.counters()

    async def stop(self):
        await self.engine.stop()
