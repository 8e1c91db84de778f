"""Continuous-batching LLM engine with a paged KV cache and LoRA multiplex.

Counterpart of ``ray_tpu/llm/engine.py`` in PyTorch. The design is the
JAX engine's:

* **Fixed decode slots.** One decode step advances ALL ``max_batch``
  slots; inactive slots are masked. Admission writes a new request's
  prompt KV into a free slot's pages between decode blocks, so a request
  never waits for the running batch to drain.
* **Paged KV.** One pool ``[layers, n_pages, page_size, kv, hd]`` per K
  and V; each slot owns a page table. Page 0 is the junk page: it is
  never allocated, dummy prefill rows and out-of-range writes land there,
  and it is never read unmasked. The pools are updated IN PLACE on the
  device's current stream (JAX donates them and gets new ones); every
  write and read is ordered by that one stream.
* **int8 pools** (``kv_dtype="int8"``): a pool is a ``{"q": int8, "s":
  float32}`` dict, quantized symmetrically per (token, kv-head) and read
  back through dequantization.
* **Page adoption and export.** ``submit_prefilled`` admits a request
  whose prompt KV was computed elsewhere: ``scatter_pages`` writes the
  adopted stacks into the slot's fresh pages, and no prefill runs.
  ``paged_prefill_suffix`` prefills a prompt's suffix over prefix pages
  already in the pool. ``export_pages`` copies a live request's prompt
  pages out as a ``KVPageManifest`` (``llm/disagg/kv_plane.py``).
* **Fused decode blocks.** ``paged_decode_multi`` runs K steps with the
  (token, position) carry kept on the device and no host sync inside a
  block; the host reads a block's tokens through an asynchronous copy
  while the next block is already queued.
* **Speculative decoding** (``spec_enable``): greedy rows draft ``spec_k``
  tokens from their own history (``_ngram_propose``) or a host
  ``spec_drafter``, and one forward over ``k+1`` positions verifies them;
  the emitted tokens equal the plain engine's greedy tokens.
* **LoRA multiplex**: stacked low-rank adapters on the q/v projections,
  selected per slot (adapter 0 = base model).
"""
from __future__ import annotations

import asyncio
import collections
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch.llm.generation import _ffn, _gqa_attn, _gumbel_argmax
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops.basic import matmul, rms_norm, rope, rope_freqs


def _lora_delta(h, loras, name, aid):
    """Per-slot low-rank delta: h[B,T,D] x A[aid][D,r] x Bm[aid][r,O]."""
    if loras is None:
        return 0.0
    a = loras[name + "_a"][aid]  # [B, D, r]
    b = loras[name + "_b"][aid]  # [B, r, O]
    dt = torch.promote_types(h.dtype, a.dtype)
    return torch.einsum("btd,bdr->btr", h.to(dt), a.to(dt)) @ b.to(dt)


def _kv_shape(pool):
    return (pool["q"] if isinstance(pool, dict) else pool).shape


def _kv_write(pool, i, row, off, val):
    """Store new K/V rows of layer ``i`` in place. val: [..., KV, hd];
    row/off index pool pages and in-page offsets. An int8 pool ({"q":
    int8, "s": float32}) gets one scale per (token, kv-head) vector,
    computed in val's dtype as JAX does: max|val| / 127, the quotient
    rounded half to even and clipped to +-127 BEFORE the int8 cast (a bf16
    scale can put the largest element's quotient at 128)."""
    if not isinstance(pool, dict):
        pool[i][row, off] = val.to(pool.dtype)
        return
    s = val.abs().amax(dim=-1) / 127.0  # [..., KV]
    q = torch.round(val / s.clamp_min(1e-8)[..., None]).clamp(-127, 127)
    pool["q"][i][row, off] = q.to(torch.int8)
    pool["s"][i][row, off] = s.float()


def _kv_read(pool, i, page_tables, dtype):
    """Gather the attention window [B, W*PS, KV, hd] of layer ``i``
    through the page tables [B, W]; an int8 pool is dequantized as
    ``q.to(dtype) * s.to(dtype)``, in the model's dtype."""
    if not isinstance(pool, dict):
        return pool[i][page_tables].flatten(1, 2)
    q = pool["q"][i][page_tables].flatten(1, 2)
    s = pool["s"][i][page_tables].flatten(1, 2)[..., None]
    return q.to(dtype) * s.to(dtype)


def _as_pool_tensor(x, like):
    """A numpy array (ml_dtypes' bfloat16 included) or tensor as a tensor
    on ``like``'s device, in its dtype."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":  # a JAX bf16 array; numpy has no bf16
            x = torch.tensor(x.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.tensor(x)
    return x.to(device=like.device, dtype=like.dtype)


def scatter_pages(pool, page_ids, stack):
    """Write an adopted page stack into pool rows ``page_ids`` in place
    and return the pool, so callers written as ``pool = scatter_pages(
    pool, ...)`` work unchanged. ``stack`` is a bare ``[L, n, PS, KV,
    hd]`` array for plain pools or a ``{"q", "s"}`` dict for int8 pools,
    numpy or torch; it is cast to the pool's dtype."""
    parts = pool if isinstance(pool, dict) else {"": pool}
    stacks = stack if isinstance(pool, dict) else {"": stack}
    for key, t in parts.items():
        idx = torch.as_tensor(np.asarray(page_ids, np.int64), device=t.device)
        t[:, idx] = _as_pool_tensor(stacks[key], t)
    return pool


def _choose(logits, temps, generator, sample: bool):
    """Greedy tokens, with rows whose temperature is > 0 sampled when
    ``sample`` (the host knows whether any live row samples, so the
    Gumbel noise is drawn only then; JAX decides with ``lax.cond``)."""
    greedy = logits.argmax(dim=-1)
    if not sample:
        return greedy
    s = _gumbel_argmax(logits, temps.clamp_min(1e-6)[:, None], generator)
    return torch.where(temps > 0, s, greedy)


def _paged_forward(params, loras, aids, inputs, positions, page_tables,
                   kpool, vpool, cfg: LlamaConfig, cos, sin):
    """The model over T new tokens per row whose K/V live in the paged
    pools: decode (T=1), speculative verify (T=k+1) and suffix prefill.

    inputs/positions: [B, T]; page_tables: [B, W], in position order. Each
    token's K/V is written at its position through the page table, then
    every token attends the window gathered through the table up to and
    including its own position (the window index IS the position). The
    pools are written in place; returns the final-normed hidden [B, T, D].

    JAX's take_along_axis fills an out-of-range page index with INT_MIN and
    its .at[].set then drops the write; in torch both would fault. A
    position past the table (a slot decoding junk past its last page, a
    verify window near max_seq_len, a suffix bucket's padded tail) gathers
    a clamped index and writes to the junk page 0."""
    B, T = inputs.shape
    L, P, PS, KV, hd = _kv_shape(kpool)
    W = page_tables.shape[1]
    pidx = positions // PS
    rows = torch.gather(page_tables, 1, pidx.clamp(max=W - 1))
    rows = torch.where(pidx < W, rows, torch.zeros_like(rows))
    offs = positions % PS
    key_idx = torch.arange(W * PS, device=inputs.device)
    mask = key_idx[None, None, :] <= positions[:, :, None]

    x = params["tok"]["embedding"][inputs]  # [B, T, D]
    for i in range(cfg.n_layers):
        layer = params[f"layers_{i}"]
        h = rms_norm(x, layer["attn_norm"]["scale"])
        q = (matmul(h, layer["wq"]["kernel"]) + _lora_delta(h, loras, "wq", aids)
             ).reshape(B, T, cfg.n_heads, hd)
        k = matmul(h, layer["wk"]["kernel"]).reshape(B, T, KV, hd)
        v = (matmul(h, layer["wv"]["kernel"]) + _lora_delta(h, loras, "wv", aids)
             ).reshape(B, T, KV, hd)
        q = rope(q, cos, sin, positions)
        k = rope(k, cos, sin, positions)
        _kv_write(kpool, i, rows, offs, k)
        _kv_write(vpool, i, rows, offs, v)
        kb = _kv_read(kpool, i, page_tables, k.dtype)
        vb = _kv_read(vpool, i, page_tables, v.dtype)
        att = _gqa_attn(q, kb, vb, mask)
        x = x + matmul(att.reshape(B, T, -1), layer["wo"]["kernel"])
        x = _ffn(layer, x)
    return rms_norm(x, params["norm"]["scale"])


def _decode_body(params, loras, aids, tokens, pos, page_tables, kpool, vpool,
                 active, temps, generator, cfg: LlamaConfig, cos, sin,
                 sample: bool):
    """One decode step for every slot (masked where inactive).

    tokens: [B] current input token; pos: [B] tokens already cached (the
    new token lands at that position); page_tables: [B, MAXP]; aids: [B]
    adapter ids; temps: [B]. Returns next_tok [B]; the pools are written
    in place."""
    x = _paged_forward(params, loras, aids, tokens[:, None], pos[:, None],
                       page_tables, kpool, vpool, cfg, cos, sin)
    logits = matmul(x[:, 0], params["lm_head"]["kernel"])
    nxt = _choose(logits, temps, generator, sample)
    return torch.where(active, nxt, torch.zeros_like(nxt))


@torch.inference_mode()
def paged_decode_multi(params, loras, aids, tokens, seq_lens, page_tables,
                       kpool, vpool, active, temps, generator, cfg: LlamaConfig,
                       n_steps: int, sample: bool = False):
    """``n_steps`` decode steps as one block: a Python loop with the
    (tokens, positions) carry on the device and no host sync inside.

    Returns (toks [n_steps, B], tok, pos); the final carry stays on the
    device so consecutive blocks chain without a host round trip. Slots
    that finish mid-block keep decoding junk: their gathers clamp, their
    out-of-range writes go to the junk page, future-position writes are
    masked until legitimately overwritten, and the host discards the
    extra tokens."""
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                          device=tokens.device)
    tok, pos = tokens, seq_lens
    out = []
    for _ in range(n_steps):
        tok = _decode_body(params, loras, aids, tok, pos, page_tables, kpool,
                           vpool, active, temps, generator, cfg, cos, sin, sample)
        pos = pos + 1
        out.append(tok)
    return torch.stack(out), tok, pos


@torch.inference_mode()
def paged_prefill_batch(params, loras, aids, tokens, pages, kpool, vpool,
                        true_lens, temps, generator, cfg: LlamaConfig,
                        sample: bool = False):
    """Prefill a whole admission wave as ONE batched forward.

    tokens: [N, Tp_pad] right-padded prompts (same pad bucket); pages:
    [N, n_pages] pool pages per request (dummy rows use the junk page 0);
    true_lens/temps: [N]. Writes the prompt KV into the pools in place and
    returns the first tokens [N]."""
    N, Tp = tokens.shape
    L, P, PS, KV, hd = _kv_shape(kpool)
    dev = tokens.device
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev)
    idx = torch.arange(Tp, device=dev)
    positions = idx[None, :]
    mask = idx[None, :, None] >= idx[None, None, :]  # causal
    rows = pages[:, idx // PS]  # [N, Tp] pool row per prompt position
    offs = (idx % PS).expand(N, Tp)
    x = params["tok"]["embedding"][tokens]  # [N, Tp, D]
    for i in range(cfg.n_layers):
        layer = params[f"layers_{i}"]
        h = rms_norm(x, layer["attn_norm"]["scale"])
        q = (matmul(h, layer["wq"]["kernel"]) + _lora_delta(h, loras, "wq", aids)
             ).reshape(N, Tp, cfg.n_heads, hd)
        k = matmul(h, layer["wk"]["kernel"]).reshape(N, Tp, KV, hd)
        v = (matmul(h, layer["wv"]["kernel"]) + _lora_delta(h, loras, "wv", aids)
             ).reshape(N, Tp, KV, hd)
        q = rope(q, cos, sin, positions)
        k = rope(k, cos, sin, positions)
        _kv_write(kpool, i, rows, offs, k)
        _kv_write(vpool, i, rows, offs, v)
        att = _gqa_attn(q, k, v, mask)  # prefill attends the FRESH k/v:
        # quantization only affects what later decode steps read back
        x = x + matmul(att.reshape(N, Tp, -1), layer["wo"]["kernel"])
        x = _ffn(layer, x)
    x = rms_norm(x, params["norm"]["scale"])
    last = x[torch.arange(N, device=dev), true_lens - 1]
    logits = matmul(last, params["lm_head"]["kernel"])  # [N, V]
    return _choose(logits, temps, generator, sample)


@torch.inference_mode()
def paged_prefill_suffix(params, loras, aids, tokens, pages, kpool, vpool,
                         prefix_lens, true_lens, temps, generator,
                         cfg: LlamaConfig, sample: bool = False):
    """Prefill only a prompt's SUFFIX over prefix KV already in the pool
    (a cached prefix of whole pages is adopted verbatim, never recomputed).

    tokens: [N, Ts_pad] right-padded suffix tokens; pages: [N, W] page
    table covering prefix AND suffix positions in prompt order (junk page
    0 beyond); prefix_lens: [N] PAGE-ALIGNED token counts already in the
    pool; true_lens: [N] real suffix lengths. Suffix token j sits at
    absolute position prefix_len + j; its attention window, gathered
    through the table as in decode, covers the prefix (mask: key index <=
    position). An int8 pool is read back through dequantization, where
    full prefill attends the fresh K/V. Writes the pools in place and
    returns the first tokens [N]."""
    N, Ts = tokens.shape
    dev = tokens.device
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev)
    positions = prefix_lens[:, None] + torch.arange(Ts, device=dev)[None, :]
    x = _paged_forward(params, loras, aids, tokens, positions, pages, kpool,
                       vpool, cfg, cos, sin)
    last = x[torch.arange(N, device=dev), true_lens - 1]
    logits = matmul(last, params["lm_head"]["kernel"])
    return _choose(logits, temps, generator, sample)


# --------------------------------------------------------------- speculative
def _ngram_propose(hist, pos, k: int, m: int):
    """Self-drafting prompt lookup: find the most recent earlier
    occurrence of the trailing ``m``-gram in ``hist`` and propose the
    ``k`` tokens that followed it, on the device.

    hist: [B, H] token history; positions ``0..pos`` are valid and
    ``hist[b, pos[b]]`` is the pending input token. Returns (drafts
    [B, k], draft_len [B]) with draft_len 0 where no match."""
    B, H = hist.shape
    dev = hist.device
    n_win = H - m + 1
    gidx = pos[:, None] - (m - 1) + torch.arange(m, device=dev)[None, :]
    pattern = torch.gather(hist, 1, gidx.clamp(0, H - 1))
    # all H-m+1 windows of width m as m shifted views: wins[b, i, t] =
    # hist[b, i + t] — one [B, n_win, m] compare finds every candidate
    wins = torch.stack([hist[:, t:t + n_win] for t in range(m)], dim=-1)
    match = (wins == pattern[:, None, :]).all(dim=-1)          # [B, n_win]
    ends = (torch.arange(n_win, device=dev) + (m - 1))[None, :]  # window end j
    valid = (ends < pos[:, None]) & (pos[:, None] >= m)
    # a match at j proposes the pos-j tokens that FOLLOWED it, capped at
    # k: prefer the most recent match with a full k followers (on periodic
    # text the nearest match sits at pos-1 and would draft ONE token),
    # falling back to the nearest match otherwise
    hit = match & valid
    none = torch.full_like(ends, -1)
    j_full = torch.where(hit & (ends <= pos[:, None] - k), ends, none).amax(dim=1)
    j_any = torch.where(hit, ends, none).amax(dim=1)
    j = torch.where(j_full >= 0, j_full, j_any)
    dl = torch.where(j >= 0, (pos - j).clamp(max=k), torch.zeros_like(j))
    didx = j[:, None] + 1 + torch.arange(k, device=dev)[None, :]
    drafts = torch.gather(hist, 1, didx.clamp(0, H - 1))
    return drafts, dl


def _spec_verify_accept(params, loras, aids, tok, pos, drafts, dl,
                        page_tables, kpool, vpool, active, temps, generator,
                        cfg: LlamaConfig, cos, sin, sample: bool):
    """Verify ``drafts`` [B, k] in ONE forward over the k+1 positions
    ``pos..pos+k`` (token j attends drafts before it, written this step)
    and apply the greedy accept rule: the longest draft prefix the target
    agrees with, then the target's own token at the first disagreement (or
    the bonus token after a full accept). Only position 0 is sampled, for
    rows with temperature > 0 (their dl is 0). Rejected positions hold
    junk KV that the next step's inputs overwrite before any read, so
    rollback is position arithmetic.

    Returns (out [B, k+1] emission candidates, n_emit [B], n_acc [B],
    new_tok [B], new_pos [B])."""
    B, k = drafts.shape
    ar = torch.arange(k + 1, device=tok.device)
    inputs = torch.cat([tok[:, None], drafts], dim=1)
    positions = pos[:, None] + ar[None, :]
    x = _paged_forward(params, loras, aids, inputs, positions, page_tables,
                       kpool, vpool, cfg, cos, sin)
    logits = matmul(x, params["lm_head"]["kernel"])  # [B, k+1, V]
    greedy = logits.argmax(dim=-1)
    next0 = _choose(logits[:, 0], temps, generator, sample)
    okm = (drafts == greedy[:, :-1]) & (ar[None, :k] < dl[:, None])
    n_acc = torch.cumprod(okm.long(), dim=1).sum(dim=1)
    out = torch.cat([next0[:, None], greedy[:, 1:]], dim=1)
    zero = torch.zeros_like(n_acc)
    n_emit = torch.where(active, n_acc + 1, zero)
    new_tok = torch.where(active, torch.gather(out, 1, n_acc[:, None])[:, 0], zero)
    return out, n_emit, n_acc, new_tok, pos + n_acc + 1


@torch.inference_mode()
def paged_decode_spec(params, loras, aids, tokens, seq_lens, hist,
                      page_tables, kpool, vpool, active, spec_ok, temps,
                      generator, cfg: LlamaConfig, n_steps: int, k: int,
                      ngram: int, sample: bool = False):
    """``n_steps`` SPECULATIVE decode steps as one block: each step drafts
    ``k`` tokens per slot with the on-device n-gram matcher, verifies them
    in one forward, and advances each slot by ``n_acc + 1`` positions. The
    (token, position, history) carry stays on the device between blocks,
    as ``paged_decode_multi``'s does; rows where ``spec_ok`` is False
    (sampled rows, per-request opt-out) run with draft_len 0, i.e. plain
    one-token decode.

    Returns (toks [S, B, k+1], n_emit [S, B], n_prop [S, B], tok, pos,
    hist); the host emits the first ``n_emit[s, b]`` tokens of each row
    and discards the rest (the rollback)."""
    dev = tokens.device
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev)
    H = hist.shape[1]
    cols = torch.arange(H, device=dev)[None, :]
    tok, pos = tokens, seq_lens
    toks, emits, props = [], [], []
    for _ in range(n_steps):
        drafts, dl = _ngram_propose(hist, pos, k, ngram)
        dl = torch.where(spec_ok, dl, torch.zeros_like(dl))
        out, n_emit, n_acc, new_tok, new_pos = _spec_verify_accept(
            params, loras, aids, tok, pos, drafts, dl, page_tables, kpool,
            vpool, active, temps, generator, cfg, cos, sin, sample)
        # record out[0..n_acc] at positions pos+1.. so the NEXT step's
        # drafter sees them; positions past H fall outside the mask (JAX
        # drops those writes with mode="drop")
        j = cols - (pos + 1)[:, None]
        write = (j >= 0) & (j <= n_acc[:, None])
        hist = torch.where(write, torch.gather(out, 1, j.clamp(0, k)), hist)
        tok, pos = new_tok, new_pos
        toks.append(out)
        emits.append(n_emit)
        props.append(dl)
    return (torch.stack(toks), torch.stack(emits), torch.stack(props), tok,
            pos, hist)


@torch.inference_mode()
def paged_decode_verify(params, loras, aids, tokens, seq_lens, drafts,
                        page_tables, kpool, vpool, draft_lens, active, temps,
                        generator, cfg: LlamaConfig, sample: bool = False):
    """One speculative step with HOST-provided drafts [B, k] (the
    ``spec_drafter`` hook): the same verify/accept as the fused block, one
    step per dispatch since the host drafter needs the accepted tokens
    back before proposing the next window. Returns (toks [B, k+1], n_emit
    [B], n_prop [B], tok, pos)."""
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                          device=tokens.device)
    out, n_emit, _, tok, pos = _spec_verify_accept(
        params, loras, aids, tokens, seq_lens, drafts, draft_lens,
        page_tables, kpool, vpool, active, temps, generator, cfg, cos, sin,
        sample)
    return out, n_emit, draft_lens, tok, pos


def make_lora_stack(cfg: LlamaConfig, adapters: dict[str, dict], rank: int,
                    device):
    """Stack named adapters into gatherable float32 tensors. Index 0 is the
    base model (zero delta). adapters: name -> {"wq_a": [D,r], "wq_b":
    [r,O], "wv_a": ..., "wv_b": ...}. Returns (stack dict, name->index)."""
    D = cfg.d_model
    O_q = cfg.n_heads * cfg.head_dim
    O_v = cfg.n_kv_heads * cfg.head_dim
    names = ["__base__"] + sorted(adapters)
    idx = {n: i for i, n in enumerate(names)}
    stack = {
        "wq_a": np.zeros((len(names), D, rank), np.float32),
        "wq_b": np.zeros((len(names), rank, O_q), np.float32),
        "wv_a": np.zeros((len(names), D, rank), np.float32),
        "wv_b": np.zeros((len(names), rank, O_v), np.float32),
    }
    for name, ad in adapters.items():
        i = idx[name]
        for k in stack:
            if k in ad:
                stack[k][i] = np.asarray(ad[k], np.float32)
    return {k: torch.tensor(v, device=device) for k, v in stack.items()}, idx


def make_kv_pools(cfg: LlamaConfig, page_size: int, n_pages: int,
                  kv_dtype: str | None, device):
    """One (kpool, vpool) pair: ``[L, P, PS, KV, hd]`` tensors in the
    model's dtype for ``None``/"native" and bfloat16 for "bf16", or
    ``{"q": int8 [L, P, PS, KV, hd], "s": float32 [L, P, PS, KV]}`` dicts
    for "int8"."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        def make_pool():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}

        return make_pool(), make_pool()
    if kv_dtype in (None, "native"):
        dtype = cfg.torch_dtype
    elif kv_dtype == "bf16":
        dtype = torch.bfloat16
    else:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    kpool = torch.zeros(shape, dtype=dtype, device=device)
    return kpool, torch.zeros_like(kpool)


class _HostCopy:
    """Device tensors' copies to host memory, started when made, with one
    event after the last copy, waited for in ``numpy()``: the host's only
    sync point for a block's results, so the next block can be queued
    before this one is read."""

    def __init__(self, *ts):
        self._event = None
        if ts[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in ts]
            for h, t in zip(self._host, ts):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(ts)

    def numpy(self):
        """The array, or a list of arrays when several tensors were copied."""
        if self._event is not None:
            self._event.synchronize()
        out = [h.numpy() for h in self._host]
        return out[0] if len(out) == 1 else out


@torch.inference_mode()
def _merge_carry(tok_d, lens_d, slots, first, lens):
    """Device-side carry merge of a prefill wave: no host sync."""
    tok_d, lens_d = tok_d.clone(), lens_d.clone()
    tok_d[slots] = first[:len(slots)]
    lens_d[slots] = lens
    return tok_d, lens_d


@dataclass
class _Request:
    req_id: int
    prompt: list[int]
    max_tokens: int
    temperature: float
    adapter: int
    out: asyncio.Queue = field(default_factory=asyncio.Queue)
    slot: int = -1
    emitted: int = 0
    planned: int = 0  # tokens scheduled on-device (planned mode)
    cancelled: bool = False
    finished: bool = False  # completed normally (max_tokens or eos)
    # adopted admission: (k_stack, v_stack, first_tok) computed elsewhere;
    # admission scatters the stacks into this engine's pool, no prefill
    prefilled: tuple | None = None
    # speculative decoding opt-in (greedy only: sampled rows decode plain)
    spec: bool = False


class EngineFull(Exception):
    """No free slot/pages and the waiting queue is at capacity."""


class ContinuousBatchingEngine:
    """Single-process engine on the device of ``params``; drive with
    ``await engine.start()`` then ``submit`` / ``stream`` from the same
    event loop."""

    def __init__(self, params, cfg: LlamaConfig, *, max_batch: int = 8,
                 page_size: int = 16, n_pages: int = 256,
                 max_seq_len: int = 512, eos_id: int | None = None,
                 lora_adapters: dict[str, dict] | None = None,
                 lora_rank: int = 8, max_waiting: int = 256,
                 block_buckets: tuple[int, ...] = (4, 8, 16, 32, 64),
                 kv_dtype: str | None = None, spec_enable: bool = False,
                 spec_k: int = 4, spec_ngram: int = 2, spec_drafter=None):
        if cfg.n_experts:
            # the JAX engine's decode body reads dense w_gate/w_up/w_down
            raise NotImplementedError("the engine serves dense Llama layers only "
                                      f"(cfg has n_experts={cfg.n_experts})")
        self.params = params
        self.cfg = cfg
        self.device = params["tok"]["embedding"].device
        self.B = max_batch
        self.PS = page_size
        self.MAXP = -(-max_seq_len // page_size)
        self.eos_id = eos_id
        self.max_waiting = max_waiting
        # fused-decode block sizes; the loop picks the smallest bucket
        # covering the longest remaining request
        self.block_buckets = tuple(sorted(block_buckets))
        self.kpool, self.vpool = make_kv_pools(cfg, page_size, n_pages,
                                               kv_dtype, self.device)
        self.kv_dtype = kv_dtype or "native"
        self.n_pages = n_pages
        self.free_pages = list(range(1, n_pages))  # page 0 = junk page
        self.loras = None
        self.lora_index = {"__base__": 0}
        if lora_adapters:
            self.loras, self.lora_index = make_lora_stack(
                cfg, lora_adapters, lora_rank, self.device)
        # slot state (host side)
        self.slot_req: list[_Request | None] = [None] * self.B
        self.page_tables = np.zeros((self.B, self.MAXP), np.int64)
        self.seq_lens = np.zeros(self.B, np.int64)
        self.next_tok = np.zeros(self.B, np.int64)
        self.temps = np.zeros(self.B, np.float32)
        self.aids = np.zeros(self.B, np.int64)
        self.waiting: list[_Request] = []
        self._req_ids = itertools.count(1)
        self._reqs: dict[int, _Request] = {}
        # finished requests not yet drained by a stream() consumer; bounded
        # LRU so fire-and-forget submitters can't leak token queues forever
        self._done: collections.OrderedDict[int, _Request] = (
            collections.OrderedDict())
        self._done_cap = 4 * self.B + max_waiting
        self._wake = asyncio.Event()
        self._running = False
        self._task = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self.error: BaseException | None = None  # fatal loop failure
        # speculative decoding: greedy requests draft spec_k tokens per step
        # (the on-device n-gram matcher over spec_ngram-grams, or the
        # spec_drafter hook) and the target verifies them in one forward
        self.spec_enable = bool(spec_enable)
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.spec_drafter = spec_drafter
        # token-history mirror [B, MAXP*PS]: hist[i, :seq_lens[i]+1] holds
        # slot i's known tokens (prompt + emitted + pending input), the
        # drafter's context and the source of the device-side carry
        self.hist = np.zeros((self.B, self.MAXP * page_size), np.int64)
        # counters for benchmarks / tests
        self.steps = 0
        self.tokens_out = 0
        self.spec_steps = 0      # speculative verify steps run
        self.spec_proposed = 0   # draft tokens proposed (live spec rows)
        self.spec_accepted = 0   # draft tokens the target accepted
        # bounded per-block log: (n_steps, emitted, proposed, accepted)
        self._block_log: collections.deque = collections.deque(maxlen=256)

    def _h2d(self, arr):
        """Host array -> device tensor. ``torch.tensor`` copies, so the loop
        may mutate its host arrays while the device still reads the copy."""
        return torch.tensor(arr, device=self.device)

    # ----------------------------------------------------------- public API
    async def start(self):
        if self._task is None:
            self._running = True
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self):
        self._running = False
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        # nothing will produce more tokens: unblock every live consumer
        self._terminate_all_streams()

    def _terminate_all_streams(self):
        for req in list(self._reqs.values()):
            req.out.put_nowait(None)
        self._reqs.clear()
        self._done.clear()
        self.waiting.clear()
        self.slot_req = [None] * self.B

    def _new_request(self, prompt_tokens, max_tokens, temperature, adapter,
                     spec) -> _Request:
        """Validate a request against this engine and build it."""
        if self.error is not None:
            raise RuntimeError("engine loop died") from self.error
        if len(self.waiting) >= self.max_waiting:
            raise EngineFull(f"{len(self.waiting)} requests already waiting")
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if min(prompt_tokens) < 0 or max(prompt_tokens) >= self.cfg.vocab_size:
            # JAX clamps an out-of-vocab id; a CUDA gather would fault
            raise ValueError(f"prompt token outside the vocab "
                             f"[0, {self.cfg.vocab_size})")
        if len(prompt_tokens) + max_tokens > self.MAXP * self.PS:
            raise ValueError(
                f"prompt ({len(prompt_tokens)}) + max_tokens ({max_tokens}) "
                f"exceeds the engine's max_seq_len ({self.MAXP * self.PS})")
        n_need = -(-(len(prompt_tokens) + max_tokens) // self.PS)
        if n_need > self.n_pages - 1:
            raise ValueError(
                f"request needs {n_need} KV pages but the pool only has "
                f"{self.n_pages - 1}")
        aid = self.lora_index.get(adapter or "__base__")
        if aid is None:
            raise ValueError(f"unknown LoRA adapter {adapter!r} "
                             f"(loaded: {sorted(self.lora_index)})")
        return _Request(next(self._req_ids), list(prompt_tokens),
                        int(max_tokens), float(temperature), aid,
                        spec=self.spec_enable if spec is None else bool(spec))

    def _enqueue(self, req: _Request) -> int:
        self._reqs[req.req_id] = req
        self.waiting.append(req)
        self._wake.set()
        return req.req_id

    def submit(self, prompt_tokens: list[int], *, max_tokens: int = 32,
               temperature: float = 0.0, adapter: str | None = None,
               spec: bool | None = None) -> int:
        """Queue a request; returns its id. Tokens arrive on stream().
        ``spec`` overrides the engine's ``spec_enable`` default for this
        request (greedy requests only; sampled rows decode plain either
        way, and an engine built without ``spec_enable`` never drafts)."""
        return self._enqueue(self._new_request(prompt_tokens, max_tokens,
                                               temperature, adapter, spec))

    def submit_prefilled(self, prompt_tokens: list[int], k_stack, v_stack,
                         first_token: int, *, max_tokens: int = 32,
                         temperature: float = 0.0,
                         adapter: str | None = None,
                         spec: bool | None = None) -> int:
        """Queue a request whose prompt KV was ALREADY computed elsewhere:
        admission scatters the adopted page stacks (``[L, n_pages, PS, KV,
        hd]`` arrays or tensors, or ``{"q","s"}`` dicts for int8 pools)
        into this engine's pool and starts decoding at position
        ``len(prompt_tokens)`` with ``first_token``: no prefill runs. The
        stacks must cover ``ceil(len(prompt)/PS)`` pages of a pool with this
        engine's page_size and kv_dtype."""
        req = self._new_request(prompt_tokens, max_tokens, temperature,
                                adapter, spec)
        if not 0 <= int(first_token) < self.cfg.vocab_size:
            raise ValueError(f"first token outside the vocab "
                             f"[0, {self.cfg.vocab_size})")
        L, _, PS, KV, hd = _kv_shape(self.kpool)
        for stack in (k_stack, v_stack):
            shape = _kv_shape(stack)
            if (isinstance(stack, dict) != isinstance(self.kpool, dict)
                    or len(shape) != 5 or (shape[0], *shape[2:]) != (L, PS, KV, hd)):
                raise ValueError(
                    f"adopted stack of shape {tuple(shape)} does not fit this "
                    f"engine's {self.kv_dtype} pool of pages [{L}, n, {PS}, {KV}, {hd}]")
        n_cover = -(-len(prompt_tokens) // self.PS)
        n_got = _kv_shape(k_stack)[1]
        if n_got < n_cover:
            raise ValueError(
                f"adopted stacks cover {n_got} pages but the prompt "
                f"needs {n_cover}")
        req.prefilled = (k_stack, v_stack, int(first_token))
        return self._enqueue(req)

    def export_pages(self, req_id: int):
        """Copy a LIVE request's prompt KV pages to host memory and return
        their ``KVPageManifest``: how an aggregated engine donates a prefix
        to the cross-request cache. Must be called while the request still
        holds its slot (prompt positions are stable once prefilled; decode
        writes land past them, and the copy is queued after them on the
        pool's stream). Raises ``KeyError`` for a request holding no slot."""
        from ray_tpu_torch.llm.disagg.kv_plane import ship_pages

        req = self._reqs.get(req_id)
        if req is None or req.slot < 0:
            raise KeyError(f"request {req_id} is not holding a slot")
        n_cover = -(-len(req.prompt) // self.PS)
        page_ids = [int(p) for p in self.page_tables[req.slot, :n_cover]]
        return ship_pages(self.kpool, self.vpool, page_ids, req.prompt,
                          page_size=self.PS, kv_dtype=self.kv_dtype)

    def tokens_in_flight(self) -> int:
        """Decode tokens this engine still owes: remaining scheduled
        tokens of resident requests plus everything waiting."""
        live = sum(max(0, r.max_tokens - r.emitted)
                   for r in self.slot_req if r is not None and not r.cancelled)
        return live + sum(max(0, r.max_tokens - r.emitted)
                          for r in self.waiting if not r.cancelled)

    def spec_stats(self, drain: bool = False) -> dict:
        """Speculative-decoding counters and the per-block log. With
        ``drain`` the log is consumed; without it this is a pure read."""
        blocks = list(self._block_log)
        if drain:
            self._block_log.clear()
        return {"spec_steps": self.spec_steps,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "spec_accept_rate": (self.spec_accepted
                                     / max(1, self.spec_proposed)),
                "blocks": blocks}

    def headroom(self) -> dict:
        """Admission-control snapshot: free KV pages and decode slots,
        queue depth, and the decode tokens-in-flight signal."""
        return {"free_pages": len(self.free_pages),
                "free_slots": sum(r is None for r in self.slot_req),
                "waiting": len(self.waiting),
                "tokens_in_flight": self.tokens_in_flight(),
                "n_pages": self.n_pages, "page_size": self.PS,
                "max_batch": self.B, "kv_dtype": self.kv_dtype}

    async def stream(self, req_id: int):
        """Async iterator of generated token ids for one request. Raises
        if the engine died before the request finished. The request stays
        registered until its consumer drains the terminal None here."""
        req = self._reqs.get(req_id)
        if req is None:
            req = self._done[req_id]
        try:
            while True:
                item = await req.out.get()
                if item is None:
                    if self.error is not None and not req.finished:
                        raise RuntimeError("engine loop died") from self.error
                    break
                yield item
        finally:
            # only unregister finished requests: a consumer erroring out
            # mid-stream must not make cancel() a no-op on a live request
            self._done.pop(req_id, None)

    async def stream_blocks(self, req_id: int):
        """Block-coalesced stream: lists of token ids, one per wake.
        ``_emit_block`` pushes a whole decode block's tokens in one
        synchronous burst, so draining the queue greedily after the first
        await yields one delta per block — token-identical to stream()."""
        req = self._reqs.get(req_id)
        if req is None:
            req = self._done[req_id]
        try:
            while True:
                item = await req.out.get()
                if item is None:
                    if self.error is not None and not req.finished:
                        raise RuntimeError("engine loop died") from self.error
                    return
                blk = [item]
                while True:
                    try:
                        nxt = req.out.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if nxt is None:
                        # terminal already queued behind the block
                        yield blk
                        if self.error is not None and not req.finished:
                            raise RuntimeError(
                                "engine loop died") from self.error
                        return
                    blk.append(nxt)
                yield blk
        finally:
            self._done.pop(req_id, None)

    async def generate(self, prompt_tokens: list[int], **kw) -> list[int]:
        rid = self.submit(prompt_tokens, **kw)
        out: list[int] = []
        async for blk in self.stream_blocks(rid):
            out.extend(blk)
        return out

    def cancel(self, req_id: int):
        req = self._reqs.get(req_id)
        if req is not None:
            req.cancelled = True
            self._wake.set()

    # ------------------------------------------------------------ internals
    def _alloc_pages(self, n: int) -> list[int] | None:
        if len(self.free_pages) < n:
            return None
        out = self.free_pages[:n]
        del self.free_pages[:n]
        return out

    def _release_slot(self, slot: int):
        """Free a slot's pages (every page allocated at admission, not only
        the ones reached) and reset its host state."""
        self.slot_req[slot] = None
        self.free_pages.extend(int(p) for p in self.page_tables[slot] if p != 0)
        self.page_tables[slot, :] = 0
        self.seq_lens[slot] = 0

    def _free_slot(self, slot: int):
        req = self.slot_req[slot]
        self._release_slot(slot)
        if req is not None:
            self._finish_stream(req)

    def _finish_stream(self, req: _Request) -> None:
        """Unregister a request and close its token stream: live -> the
        bounded finished-awaiting-drain map."""
        self._reqs.pop(req.req_id, None)
        self._done[req.req_id] = req
        while len(self._done) > self._done_cap:
            self._done.popitem(last=False)
        req.out.put_nowait(None)

    def _reserve_slot(self, req: _Request) -> int | None:
        """Claim a slot + pages for one waiting request (host bookkeeping
        only; the prefill itself is dispatched per wave)."""
        slot = next((i for i, r in enumerate(self.slot_req) if r is None), -1)
        if slot < 0:
            return None
        Tp = len(req.prompt)
        n_need = -(-(Tp + req.max_tokens) // self.PS)
        pages = self._alloc_pages(n_need)
        if pages is None:
            return None
        req.slot = slot
        self.slot_req[slot] = req
        self.page_tables[slot, :] = 0
        self.page_tables[slot, :n_need] = pages
        self.seq_lens[slot] = Tp
        self.temps[slot] = req.temperature
        self.aids[slot] = req.adapter
        if self.spec_enable:
            # drafter context: the prompt (the first token lands at
            # _admit_wave's emission, generated tokens at spec emission)
            self.hist[slot, :] = 0
            self.hist[slot, :Tp] = req.prompt
        return slot

    _WAVE_BUCKETS = (1, 2, 4, 8, 16)

    def _admit_wave(self) -> bool:
        """Admit every waiting request that fits and emit each one's first
        token (one host sync per pad-bucket group). Returns True if
        anything was admitted."""
        groups = self._admit_dispatch()
        for reqs, first in groups:
            first = first.cpu().numpy()
            for j, req in enumerate(reqs):
                self.next_tok[req.slot] = int(first[j])
                if self.spec_enable:
                    self.hist[req.slot, len(req.prompt)] = int(first[j])
                self._emit(req, int(first[j]))
        return bool(groups)

    def _admit_dispatch(self) -> list[tuple[list[_Request], torch.Tensor]]:
        """Reserve slots and DISPATCH batched prefills (or page adoptions)
        for every waiting request that fits; no host sync — returns
        [(requests, first-token device tensor)] per group."""
        groups: dict[int, list[_Request]] = {}
        adopted: list[_Request] = []
        while self.waiting:
            nxt = self.waiting[0]
            if nxt.cancelled:
                self.waiting.pop(0)
                self._finish_stream(nxt)
                continue
            if self._reserve_slot(nxt) is None:
                break
            self.waiting.pop(0)
            if nxt.prefilled is not None:
                adopted.append(nxt)
                continue
            Tp_pad = -(-len(nxt.prompt) // self.PS) * self.PS
            groups.setdefault(Tp_pad, []).append(nxt)
        out = []
        for req in adopted:
            # the prompt KV was computed elsewhere: scatter it into the
            # slot's fresh pages, on the same stream and at the same point
            # as a prefill dispatch, then drop the host copies
            k_stack, v_stack, first = req.prefilled
            req.prefilled = None
            n_cover = -(-len(req.prompt) // self.PS)
            rows = self.page_tables[req.slot, :n_cover].copy()
            for pool, stack in ((self.kpool, k_stack), (self.vpool, v_stack)):
                if isinstance(stack, dict):
                    stack = {key: s[:, :n_cover] for key, s in stack.items()}
                else:
                    stack = stack[:, :n_cover]
                scatter_pages(pool, rows, stack)
            out.append(([req], self._h2d([first])))
        for Tp_pad, reqs in groups.items():
            npages = Tp_pad // self.PS
            nb = next(b for b in self._WAVE_BUCKETS if b >= len(reqs)) \
                if len(reqs) <= self._WAVE_BUCKETS[-1] else len(reqs)
            toks = np.zeros((nb, Tp_pad), np.int64)
            pages = np.zeros((nb, npages), np.int64)  # dummy rows: junk page
            aids = np.zeros(nb, np.int64)
            true_lens = np.ones(nb, np.int64)
            temps = np.zeros(nb, np.float32)
            for j, req in enumerate(reqs):
                toks[j, :len(req.prompt)] = req.prompt
                pages[j] = self.page_tables[req.slot, :npages]
                aids[j] = req.adapter
                true_lens[j] = len(req.prompt)
                temps[j] = req.temperature
            first = paged_prefill_batch(
                self.params, self.loras, self._h2d(aids), self._h2d(toks),
                self._h2d(pages), self.kpool, self.vpool, self._h2d(true_lens),
                self._h2d(temps), self._gen, self.cfg,
                sample=bool((temps > 0).any()))
            out.append((reqs, first))
        return out

    def _emit(self, req: _Request, tok: int):
        req.emitted += 1
        self.tokens_out += 1
        req.out.put_nowait(tok)
        if req.emitted >= req.max_tokens or (
                self.eos_id is not None and tok == self.eos_id):
            req.finished = True
            req.cancelled = True  # finished: reclaim on the next sweep
            if req.slot < 0:
                # planned mode already retired the slot; close the stream
                self._finish_stream(req)

    async def _loop(self):
        """Engine driver. Any exception here is fatal for the engine:
        record it, fail every live stream, and exit."""
        try:
            if self.spec_enable:
                # accepted counts depend on the data, so completion steps
                # are unknowable at dispatch: spec mode always drives the
                # reactive-shaped loop (planned mode needs a schedule)
                await self._loop_spec()
            elif self.eos_id is None:
                await self._loop_planned()
            else:
                await self._loop_reactive()
        except Exception as e:  # noqa: BLE001 — the loop's boundary
            self.error = e
            self._running = False
            self._terminate_all_streams()
            import traceback

            traceback.print_exc()

    @staticmethod
    def _ramp(emitted: int) -> int:
        # per-request fusion ramp: fresh requests decode in small blocks
        # (first-token latency, bounded admission latency for newcomers),
        # deep ones amortize dispatch with bigger ones; the 64 bucket is
        # reserved for full batches
        if emitted < 8:
            return 8
        if emitted < 24:
            return 16
        return 32

    def _pick_block(self, planned: bool = False) -> int:
        """Fused-steps bucket for this dispatch: the smallest bucket
        covering every active request's ramp, each capped by its exact
        remaining count, so a request about to finish caps the block and
        frees its slot for waiting admissions. At high occupancy the ramp
        is skipped. ``planned`` counts dispatch-scheduled tokens instead
        of emitted ones."""
        live = [r for r in self.slot_req
                if r is not None and not r.cancelled]
        if not live:
            return 1

        def done_count(r):
            return r.planned if planned else r.emitted

        if 2 * len(live) >= self.B:
            want = min(r.max_tokens - done_count(r) for r in live)
        else:
            want = min(min(self._ramp(done_count(r)),
                           r.max_tokens - done_count(r)) for r in live)
        want = max(1, want)
        for b in self.block_buckets:
            if want <= b:
                return b
        return self.block_buckets[-1]

    def _emit_block(self, entry) -> None:
        """Host-side emission of one synced decode block."""
        K, toks, slot_snapshot = entry
        toks = toks.numpy()  # [K, B]; waits for this block only
        self.steps += K
        for i, req in enumerate(slot_snapshot):
            if req is None:
                continue
            if self.slot_req[i] is req:
                # planned mode may have retired + re-admitted this slot
                # while the block was in flight; host per-slot state then
                # belongs to the newcomer
                self.seq_lens[i] += K
            for k in range(K):
                if req.cancelled:
                    break  # finished/cancelled mid-block: discard rest
                tok = int(toks[k, i])
                if self.slot_req[i] is req:
                    self.next_tok[i] = tok
                self._emit(req, tok)

    def _dispatch_block(self, K: int, carry):
        """Queue one decode block of K steps; returns (toks copy, carry)."""
        if carry is None:
            carry = (self._h2d(self.next_tok), self._h2d(self.seq_lens))
        tok_d, lens_d = carry
        active = np.array([r is not None for r in self.slot_req])
        toks, tok_d, lens_d = paged_decode_multi(
            self.params, self.loras, self._h2d(self.aids), tok_d, lens_d,
            self._h2d(self.page_tables), self.kpool, self.vpool,
            self._h2d(active), self._h2d(self.temps), self._gen, self.cfg, K,
            sample=bool((self.temps[active] > 0).any()))
        return _HostCopy(toks), (tok_d, lens_d)

    async def _loop_planned(self):
        """Fully pipelined driver for length-deterministic generation (no
        EOS): every request's completion step is known at dispatch time,
        so slots are retired and re-admitted ON SCHEDULE without draining
        the pipeline — prefills, carry merges and decode blocks queue
        back to back, and the only host syncs are the trailing token
        emissions riding two blocks behind."""
        pending: list = []  # dispatch-ordered: ("prefill",...)|("block",...)
        carry = None

        def sync_oldest():
            kind, *rest = pending.pop(0)
            if kind == "prefill":
                reqs, first = rest
                first = first.numpy()
                for j, req in enumerate(reqs):
                    if not req.cancelled:  # user-cancelled: stream closed
                        self._emit(req, int(first[j]))
            else:
                self._emit_block(rest)

        while self._running:
            # retire slots whose scheduled tokens are all dispatched; their
            # in-flight junk writes are queued BEFORE any new prefill on the
            # same stream, so immediate page reuse is safe
            for i, req in enumerate(self.slot_req):
                if req is not None and (req.planned >= req.max_tokens
                                        or req.cancelled):
                    req.slot = -1  # emission closes the stream at finish
                    self._release_slot(i)
                    if req.cancelled and not req.finished:
                        # user-cancelled: no finish emission will ever
                        # close this stream — close it here
                        self._finish_stream(req)
            if self.waiting and any(r is None for r in self.slot_req):
                groups = self._admit_dispatch()
                if groups:
                    if carry is None:
                        carry = (self._h2d(self.next_tok),
                                 self._h2d(self.seq_lens))
                    tok_d, lens_d = carry
                    for reqs, first in groups:
                        tok_d, lens_d = _merge_carry(
                            tok_d, lens_d, self._h2d([r.slot for r in reqs]),
                            first, self._h2d([len(r.prompt) for r in reqs]))
                        for r in reqs:
                            r.planned = 1
                        pending.append(("prefill", reqs, _HostCopy(first)))
                    carry = (tok_d, lens_d)
            live = [r for r in self.slot_req if r is not None]
            if not live:
                while pending:
                    sync_oldest()
                    # yield between blocks: consumers must observe tokens
                    # in emission order, not one burst after the drain
                    await asyncio.sleep(0)
                carry = None
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
                continue
            # pace dispatch to emission + 2 entries: enough run-ahead to
            # hide the dispatch under device compute, little enough that a
            # newly arriving request interleaves within a couple of blocks
            while len(pending) >= 2:
                sync_oldest()
                await asyncio.sleep(0)
            K = self._pick_block(planned=True)
            toks, carry = self._dispatch_block(K, carry)
            for r in live:
                r.planned = min(r.max_tokens, r.planned + K)
            pending.append(("block", K, toks, list(self.slot_req)))
            await asyncio.sleep(0)

    async def _loop_reactive(self):
        """Driver with an EOS: completion is known only from the tokens.
        Blocks pipeline 2 deep with the (tok, pos) carry chained on the
        device; it is rebuilt from host state after the pipeline drains at
        admission points (a new slot changes the page tables)."""
        pending: list = []
        carry = None  # (tok_dev, lens_dev) device-resident between blocks

        def drain():
            while pending:
                self._emit_block(pending.pop(0))

        while self._running:
            for i, req in enumerate(self.slot_req):
                if req is not None and req.cancelled and req.slot >= 0:
                    if pending:
                        break  # free only with no block in flight
                    self._free_slot(i)
            if self.waiting and any(r is None for r in self.slot_req):
                drain()  # admission changes device-visible state
                for i, req in enumerate(self.slot_req):
                    if req is not None and req.cancelled:
                        self._free_slot(i)
                if self._admit_wave():
                    carry = None
                    # let consumers flush the prefill tokens before the
                    # next decode dispatch occupies the loop thread
                    await asyncio.sleep(0)
            if not any(r is not None for r in self.slot_req):
                drain()
                # idle, OR the head-of-queue request can't be admitted yet:
                # either way yield, never spin
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
                continue
            K = self._pick_block()
            toks, carry = self._dispatch_block(K, carry)
            pending.append((K, toks, list(self.slot_req)))
            if len(pending) >= 2:
                self._emit_block(pending.pop(0))
            # a finished request must stop the pipeline at the next
            # admission point rather than over-decoding forever
            if any(r is not None and r.cancelled for r in self.slot_req):
                drain()
                carry = None
            await asyncio.sleep(0)

    # ------------------------------------------------------- speculative loop
    _SPEC_BUCKETS = (1, 2, 4)

    def _spec_inflight_steps(self, pending) -> list[int]:
        """Per-slot spec steps already dispatched but not yet synced."""
        steps = [0] * self.B
        for S, _, snap, _ in pending:
            for i, rq in enumerate(snap):
                if rq is not None and self.slot_req[i] is rq:
                    steps[i] += S
        return steps

    def _pick_spec_block(self, deficits: list[int]) -> int:
        """Fused spec-steps bucket: sized to the smallest GUARANTEED
        remaining need (each step advances >= 1 token), so a finishing
        request frees its slot without riding out a long block. Buckets
        stop at 4: a step can emit up to k+1 tokens, and the optimistic
        dispatch gate stops issuing blocks once in-flight steps COULD
        satisfy every request — a coarser bucket would turn that
        possibility into up to a whole wasted block of verifies."""
        want = max(1, min(deficits))
        for b in self._SPEC_BUCKETS:
            if want <= b:
                return b
        return self._SPEC_BUCKETS[-1]

    def _host_drafts(self, spec_ok):
        """Drafter-hook path: ask ``spec_drafter(context, pos, k)`` for up
        to k draft tokens per live greedy slot. ``context`` is the slot's
        token history through the pending input (a numpy view), ``pos``
        its length minus one."""
        k = self.spec_k
        drafts = np.zeros((self.B, k), np.int64)
        dlens = np.zeros(self.B, np.int64)
        for i, req in enumerate(self.slot_req):
            if req is None or not spec_ok[i]:
                continue
            n = int(self.seq_lens[i])
            got = list(self.spec_drafter(self.hist[i, :n + 1], n, k))[:k]
            if got and (min(got) < 0 or max(got) >= self.cfg.vocab_size):
                # a CUDA embedding gather would fault on it
                raise ValueError(f"spec_drafter proposed a token outside the "
                                 f"vocab [0, {self.cfg.vocab_size}): {got}")
            drafts[i, :len(got)] = got
            dlens[i] = len(got)
        return drafts, dlens

    def _emit_spec_block(self, entry) -> None:
        """Host-side emission of one synced speculative block: per step
        and slot, emit the first ``n_emit`` candidate tokens (the accepted
        drafts plus the target's correction/bonus token) and discard the
        rest — the rejected tail's rollback is this truncation plus the
        seq_lens arithmetic."""
        S, copy, snapshot, spec_snap = entry
        toks, n_emit, n_prop = copy.numpy()  # [S, B, k+1], [S, B], [S, B]
        self.steps += S
        self.spec_steps += S
        emitted = proposed = accepted = 0
        H = self.hist.shape[1]
        for s in range(S):
            for i, req in enumerate(snapshot):
                if req is None:
                    continue
                ne = int(n_emit[s, i])
                if ne <= 0:
                    continue
                live = self.slot_req[i] is req
                if live:
                    base = int(self.seq_lens[i])
                    self.seq_lens[i] += ne
                if spec_snap[i] and not req.cancelled:
                    proposed += int(n_prop[s, i])
                    accepted += ne - 1
                for j in range(ne):
                    if req.cancelled:
                        break  # finished/cancelled mid-block: discard
                    tok = int(toks[s, i, j])
                    if live:
                        self.next_tok[i] = tok
                        if base + j + 1 < H:
                            self.hist[i, base + j + 1] = tok
                    emitted += 1
                    self._emit(req, tok)
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self._block_log.append((S, emitted, proposed, accepted))

    async def _loop_spec(self):
        """The speculative loop (reactive shape): with the on-device n-gram
        drafter the draft, verify and accept cycle lives inside
        ``paged_decode_spec``'s block, the (token, position, history)
        carry chains on the device, and blocks pipeline 2 deep as in
        ``_loop_reactive``. With a host ``spec_drafter`` each dispatch is
        one verify step and syncs at once: the drafter needs the accepted
        tokens before it can propose the next window."""
        pending: list = []
        carry = None  # (tok_dev, lens_dev, hist_dev) between blocks
        # the per-slot tables change only at admission/free points, exactly
        # where the carry resets: upload them once per carry
        statics = None
        k = self.spec_k
        host_draft = callable(self.spec_drafter)

        def drain():
            while pending:
                self._emit_spec_block(pending.pop(0))

        while self._running:
            for i, req in enumerate(self.slot_req):
                if req is not None and req.cancelled and req.slot >= 0:
                    if pending:
                        break  # free only with no block in flight
                    self._free_slot(i)
            if self.waiting and any(r is None for r in self.slot_req):
                drain()  # admission changes device-visible state
                for i, req in enumerate(self.slot_req):
                    if req is not None and req.cancelled:
                        self._free_slot(i)
                if self._admit_wave():
                    carry = None
                    # flush the just-emitted prefill tokens before the next
                    # spec dispatch occupies the loop thread
                    await asyncio.sleep(0)
            active = np.array([r is not None for r in self.slot_req])
            if not active.any():
                drain()
                carry = None
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
                continue
            # optimistic dispatch gate: a spec step emits 1..k+1 tokens, so
            # in-flight blocks COULD already satisfy a request. Once every
            # live request's optimistic bound (emitted + (k+1) x in-flight
            # steps) covers its budget, SYNC the oldest block instead of
            # dispatching; the sync corrects the bound from real emissions.
            inflight = self._spec_inflight_steps(pending)
            deficits = [r.max_tokens - r.emitted - (k + 1) * inflight[i]
                        for i, r in enumerate(self.slot_req)
                        if r is not None and not r.cancelled]
            if not deficits or max(deficits) <= 0:
                if pending:
                    self._emit_spec_block(pending.pop(0))
                else:
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(), timeout=0.05)
                    except asyncio.TimeoutError:
                        pass
                if any(r is not None and r.cancelled for r in self.slot_req):
                    drain()
                    carry = None
                await asyncio.sleep(0)
                continue
            if carry is None:
                # rebuilt from COPIES of the host mirrors: they keep
                # changing while a block is in flight
                carry = (self._h2d(self.next_tok), self._h2d(self.seq_lens),
                         self._h2d(self.hist))
                statics = None
            if statics is None:
                spec_ok = np.array([
                    r is not None and not r.cancelled and r.spec
                    and r.temperature <= 0 for r in self.slot_req])
                statics = (self._h2d(self.aids), self._h2d(self.page_tables),
                           self._h2d(active), self._h2d(spec_ok),
                           self._h2d(self.temps), spec_ok,
                           bool((self.temps[active] > 0).any()))
            aids_d, pt_d, act_d, sok_d, tmp_d, spec_ok, sample = statics
            tok_d, lens_d, hist_d = carry
            if host_draft:
                drafts, dlens = self._host_drafts(spec_ok)
                toks, n_emit, n_prop, tok_d, lens_d = paged_decode_verify(
                    self.params, self.loras, aids_d, tok_d, lens_d,
                    self._h2d(drafts), pt_d, self.kpool, self.vpool,
                    self._h2d(dlens), act_d, tmp_d, self._gen, self.cfg,
                    sample=sample)
                self._emit_spec_block((1, _HostCopy(toks[None], n_emit[None],
                                                    n_prop[None]),
                                       list(self.slot_req), spec_ok))
                carry = None  # host state is authoritative per step
            else:
                S = self._pick_spec_block([d for d in deficits if d > 0])
                toks, n_emit, n_prop, tok_d, lens_d, hist_d = paged_decode_spec(
                    self.params, self.loras, aids_d, tok_d, lens_d, hist_d,
                    pt_d, self.kpool, self.vpool, act_d, sok_d, tmp_d,
                    self._gen, self.cfg, S, k, self.spec_ngram, sample=sample)
                carry = (tok_d, lens_d, hist_d)
                pending.append((S, _HostCopy(toks, n_emit, n_prop),
                                list(self.slot_req), spec_ok))
                if len(pending) >= 2:
                    self._emit_spec_block(pending.pop(0))
            if any(r is not None and r.cancelled for r in self.slot_req):
                drain()
                carry = None
            await asyncio.sleep(0)
