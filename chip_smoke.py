#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and exits non-zero:

1. build    — compile every hand-written kernel with nvcc (in parallel), and
              print ptxas's report for each kernel instantiation: registers,
              spill bytes, static and dynamic shared memory.
2. kernels  — each kernel's wrapper against its plain PyTorch version on the
              card, at small shapes, ragged ones, T != Tk at full width and
              the main path's shape, with times, achieved TFLOP/s and share
              of the bound: the flash forward beside SDPA (its bf16 bound
              must reject two known-wrong kernels; and an unaligned
              bf16 input: copied by the wrapper, refused by the C launcher),
              and the backward pair (dq; dk/dv) against
              flash_attention_backward_plain, beside SDPA's backward and the
              delta pass.
3. forward  — Llama-3-8B width (32 layers, bf16, random weights from a seed):
              tokens [2, 2048] through llama_forward(attn_impl="auto") and
              llama_loss; the flash kernel must launch once per layer; logits
              against attn_impl="plain" (relative L2 <= 3e-2), and a 2-layer
              float32 run at full width (<= 1e-4).
4. serving  — ContinuousBatchingEngine at the same width answers 6 concurrent
              requests in the planned loop (eos_id None) and the reactive loop
              (an eos_id); in float32 at 2 layers its greedy tokens must equal
              generate()'s exactly.
   serving_int8  — the same, with kv_dtype="int8": both loops, the pools int8
              and float32 on the card, the dequantized prompt K/V of every
              (token, kv-head) vector within 1.5e-2 of its max of the native
              engine's pool; at 2 layers, float32, per-token greedy agreement
              with the native engine >= 85%, each token predicted on the
              native engine's prefix.
   serving_spec  — speculative decoding (spec_k 4, spec_ngram 2) over the
              prompts and two repetitive ones, with the n-gram drafter and an
              oracle spec_drafter (the plain engine's continuation); at 2
              layers, float32, the n-gram, oracle and wrong drafters must emit
              the plain engine's tokens exactly, the oracle accepted in full,
              the wrong drafter never; at 32 layers, bf16, the verify forward
              (paged_decode_verify) fed the plain engine's continuation must
              predict decode's token on the same prefix at >= 95% of positions
              (teacher-forced), each flip reported with its logit margins.
   serving_adopt — a live request's prompt pages submit_prefilled into a
              second engine (no prefill may run there), and paged_prefill_suffix
              over a page-aligned prefix scattered into a fresh pool; at 2
              layers, float32, the continuation and the suffix's first token
              must equal the first engine's.
   serving_server — the serving layer: LLMEngineServer answers the 6 prompts
              through __call__ and stream_deltas together; LLMServer batches 8
              concurrent requests at two temperatures into one batch and one
              generate call per temperature; build_llm_processor maps generate
              over an 8-row dataset in 2 calls. At 2 layers, float32, __call__,
              stream, stream_deltas, LLMServer and the processor must give the
              engine's or generate's tokens exactly.
   serving_disagg — PrefillWorker -> KV-page manifest -> DecodeWorker for the
              6 prompts, then again through the prefix cache (export_pages of
              live requests, insert, lookup, a suffix prefill, adoption of
              prefix + suffix); at 2 layers, float32, both legs must give the
              aggregated engine's tokens, and every shipped page and adopted
              stack must equal its pool rows bit for bit (native, bf16 and
              int8 pools; the bf16 native pool at 32 layers too).
5. train    — with the earlier weights and pools freed: Llama-3-8B width cut
              to 8 layers, bf16, remat on, tokens [2, 2049]; one step's
              gradients with attn_impl="auto" against "plain" (loss within
              3e-2, flattened gradient relative L2 <= 3e-2), then
              make_train_step with AdamW (lr 1e-4): one warm-up step and
              TRAIN_STEPS (20) timed steps, each launching the flash
              forward, dq and dk/dv kernels once per layer (8/8/8), the loss
              finite and falling;
              and a 2-layer float32 model at full width, T=2048, whose
              per-leaf gradients agree with plain attention (<= 1e-3).
6. moe_forward — with the dense weights freed: llama3_8b_switch8 (Llama-3-8B
              widths, 8 top-1 experts in every second layer, capacity factor
              1.25), all 32 layers, bf16, tokens [2, 2048]: the flash forward
              must launch once per layer (layers 0-1 bf16, 2-31 float32 after
              the MoE promotion, as in JAX), the logits must be float32, aux
              finite and > 0; peak memory and launches are read on that
              forward alone. A second forward records its routing (Routing),
              and attn_impl="plain" replaying it must give logits within
              relative L2 3e-2. Printed beside: plain on its own routing, and
              a second correct attention (SDPA) against plain, free-running
              and on its own routing replayed; median forward ms against
              plain, the share of tokens each MoE layer drops at capacity;
              and a 2-layer float32 MoE model at full width within 1e-4 of
              plain.
7. moe_train — llama3_8b_switch8 cut to 8 layers, bf16, remat, AdamW (lr
              1e-4): one step's gradients with "auto" against "plain" on the
              same routing (loss within 3e-2, every leaf's relative L2 <=
              3e-2; SDPA against plain printed beside, as in moe_forward),
              then one warm-up step and TRAIN_STEPS (20) timed steps
              launching 8/8/8 kernels each, the loss finite and falling.
8. parallel — one NCCL process group of world size 1 in this process (file
              rendezvous in a temp dir) and its DeviceMesh: ring_attention,
              ulysses_attention, pipeline_apply, moe_ffn (ep=1) and
              llama_pp_loss (pp=1) each equal their local counterpart on the
              card within 2e-5 at float32; the group is destroyed.
9. trainer  — TorchTrainer(num_workers=1), NCCL at world size 1: the train
              phase's step (8 layers, B=2, T=2048, bf16, remat, AdamW 1e-4)
              in a worker process, params placed by shard_pytree on the
              one-rank mesh; 3 warm-up and TRAIN_STEPS (20) timed steps,
              8/8/8 launches each read in the worker, the step-1 loss within
              3e-2 of the train phase's, the loss finite and falling; the
              seconds from fit() to the first report.
10. trainer_checkpoint — 2 layers at full width: fit 1 runs 4 steps and
              saves params and AdamW state at step 2 (Checkpoint.
              from_state_dict), fit 2 resumes from it and runs steps 3-4,
              whose losses must equal fit 1's within 1e-6 relative (printed:
              whether exactly); the bytes and the save and load GB/s.
11. trainer_dp2 — two workers sharing the card (GPU 0.5 each, gloo) take one
              float32 step at MeshSpec(dp=2) (d_model 1024, 2 layers, B=4,
              T=2048, so the float32 kernels run in both); loss within 1e-5
              (relative) and every updated leaf within 1e-4 of the one-
              process step on the whole batch, and a collective.allreduce of
              numpy giving the sum on both ranks.
12. dryrun  — ray_tpu_torch.entry.dryrun_multichip(1): NCCL at world size 1,
              then the trainer arm's two workers.
13. rllib_parity — ray_tpu_torch.rllib on the card, float32, TF32 off: one
              update of each of PPO (minibatches 1), IMPALA, APPO, DQN, SAC,
              BC and CQL from weights drawn once and a fixed batch, against
              the same update on the CPU, each leaf's max error over its
              largest value within 1e-5: in float32 the loss and every
              gradient leaf, in float64 every updated leaf (target critics
              too; Adam carries float32's rounding of cancellation-small
              gradients into whole steps); ms per float32 update on the card
              and on the host CPU. The port's CartPole-v1, 2000 random-action
              steps of 8 envs, twice from one seed, must give equal bytes.
14. rllib_ppo — PPO on the port's CartPole-v1 at test_ppo_learns_cartpole's
              settings (2 runners x 4 envs x 128 steps, lr 1e-3, 4 epochs x
              4 minibatches, hidden 64), 8 iterations: best mean return >
              max(60, 1.5 x first), params on cuda; per iteration sample ms,
              update ms and env steps/s.
15. rllib_offpolicy — DQN, IMPALA, APPO and SAC at their JAX tests'
              settings and iteration counts, each held to its test's bar,
              and the two-agent runner (TwoAgentTag) with per-policy PPO.
16. rllib_offline — collect_rollouts -> OfflineData -> BC (agreement with
              the expert > 0.8) and CQL (prefers the logged action on > 0.9).
17. rllib_learners — two Learner ranks in two processes sharing the card
              over gloo, one with an empty shard: equal params and Adam
              moments after the sync (the mean of the update and the initial
              state), step counts 16 and 0.
              Each rllib phase reads the flash kernels' launches: 0.

Then the {"kernels": [...]} line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Without a CUDA device, or without the
ray_tpu_torch package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12    # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
SEED = 0
TRAIN_STEPS = 20  # timed train steps: their median is the step time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() by CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops, nbytes, itemsize) -> tuple[float, str, float]:
    """(least ms on an H100, what bounds it, the operations): ``ops`` at the
    type's peak against ``nbytes`` at the memory rate."""
    peak = H100_BF16_FLOPS if itemsize == 2 else H100_F32_FLOPS
    t_ops, t_bytes = ops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations", ops) if t_ops >= t_bytes else (t_bytes, "bytes", ops)


def attention_bound_ms(B, T, Tk, H, D, itemsize, causal) -> tuple[float, str, float]:
    """Least time for the flash forward's work on an H100: the products over
    the (row, key) pairs this mask keeps, against each input read once and
    each output (out and the float32 lse) written once."""
    pairs = sum(min(r + 1, Tk) for r in range(T)) if causal else T * Tk
    nbytes = (2 * B * T * H * D + 2 * B * Tk * H * D) * itemsize + 4 * B * H * T
    return bound(4 * B * H * D * pairs, nbytes, itemsize)


def backward_bound_ms(B, T, Tk, H, D, itemsize, causal,
                      products) -> tuple[float, str, float]:
    """Least time for one backward kernel's work on an H100: ``products``
    matrix products (dq: 3, dk/dv: 4) over the kept (row, key) pairs, against
    q, k, v, dO and lse/delta read once and the kernel's outputs (dq: one
    [B, T, H, D]; dk/dv: two [B, Tk, H, D]) written once."""
    pairs = sum(min(r + 1, Tk) for r in range(T)) if causal else T * Tk
    outs = B * T * H * D if products == 3 else 2 * B * Tk * H * D
    nbytes = (2 * B * T * H * D + 2 * B * Tk * H * D + outs) * itemsize + 2 * 4 * B * H * T
    return bound(2 * products * B * H * D * pairs, nbytes, itemsize)


def rate(ms, bound_ms, ops) -> dict:
    """Achieved TFLOP/s and share of the bound of a kernel that took ms."""
    return {"tflops": ops / (ms * 1e-3) / 1e12, "bound_share": bound_ms / ms}


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def tree_numel(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


def rel_l2(a, b) -> float:
    num = den = 0.0
    for i in range(a.shape[0]):  # row by row: the logits are GBs in float32
        x, y = a[i].float(), b[i].float()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return math.sqrt(num / den)


def check_fwd_alignment(g) -> None:
    """An unaligned bf16 view: the wrapper copies it first and gives what
    the aligned copy gives; the C launcher itself refuses it
    (cudaErrorInvalidValue) without launching."""
    import importlib

    import torch

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    B, T, H, D = 1, 256, 2, 128
    flat = torch.randn(B * T * H * D + 1, generator=g, device="cuda").to(torch.bfloat16)
    q = flat[1:].view(B, T, H, D)  # 2 bytes off
    k, v = (torch.randn((B, T, H, D), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    same = torch.equal(fa.flash_attention_forward(q, k, v)[0],
                       fa.flash_attention_forward(q.clone(), k, v)[0])
    lib, fn = fa._fn(fa.KERNEL, fa._FWD_ARGTYPES)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device="cuda")
    lse = torch.empty((B * H, T), dtype=torch.float32, device="cuda")
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
              B, H, T, T, D, 1, *fa._strides(q, k, v), D ** -0.5, 1,
              torch.cuda.current_stream().cuda_stream)
    row = {"phase": "kernel_check", "kernel": "flash_attention_fwd",
           "check": "unaligned bf16 q", "copied_result_equal": same,
           "launcher_code": code, "want_code": 1}
    emit(row)
    if not (same and code == 1):
        raise AssertionError(f"flash_attention_fwd alignment handling: {row}")


def fwd_within(out, ref, tol) -> tuple[bool, dict]:
    """Whether a forward output is within ``tol`` = (atol, rtol, row_tol) of
    the plain version: |out - plain| <= atol + rtol |plain| everywhere and,
    where row_tol is set, every (b, t, h) row's relative L2 <= row_tol."""
    atol, rtol, row_tol = tol
    diff = out.float() - ref
    elementwise = bool((diff.abs() <= atol + rtol * ref.abs()).all())
    row_rel = float((diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max())
    ok = elementwise and (row_tol is None or row_rel <= row_tol)
    return ok, {"max_abs_err": float(diff.abs().max()), "row_rel_l2_max": row_rel,
                "elementwise_within": elementwise}


def dropped_keys_forward(q, k, v, causal, drop):
    """What a forward kernel that leaves out the (row, key) pairs where
    ``drop`` [T, Tk] is true gives: the plain forward in float32 over the
    rest, rounded to q's dtype. Every row must keep one key."""
    import torch

    T, Tk, D = q.shape[1], k.shape[1], q.shape[3]
    keep = ~drop
    if causal:
        keep &= torch.arange(T, device=q.device)[:, None] >= torch.arange(Tk, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    s = s.masked_fill(~keep, -1e30)
    p = (s - s.amax(-1, keepdim=True)).exp() * keep
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / p.sum(-1).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# Known-wrong forward kernels the bf16 bound must reject, by the shape
# (B, T, Tk, H, D, dtype, causal) each is tried at: a name and the pairs it
# leaves out, as a function of the row and key indices [T, 1], [1, Tk].
FWD_FAULTS = {
    # in the last 64-row query tile, each row skips the 16-key group that
    # holds its diagonal (1 to 16 of ~2000 keys): late rows only
    (2, 2048, 2048, 32, 128, "bfloat16", True):
        ("last query tile drops each row's diagonal 16-key group",
         lambda r, c: (r >= r.shape[0] - 64) & (c >= r // 16 * 16)),
    # the ragged end of the keys (517 = 8 x 64 + 5) is left out
    (1, 333, 517, 2, 128, "bfloat16", False):
        ("ragged key end dropped", lambda r, c: (c >= c.shape[-1] // 64 * 64) & (r >= 0)),
}


def phase_kernels(card: str) -> dict:
    """The forward kernel against flash_attention_plain on the float32
    upcasts of its inputs, over small, ragged (T not a multiple of any tile)
    and T != Tk shapes, T != Tk at full width and the main shape; then its
    time at the main shape. Bounds: float32 |out - plain| <= 2e-5; bf16
    <= 1.5e-2 + 5e-2 |plain| and every row's relative L2 <= 1e-2 (inside the
    JAX package's 5e-2 + 5e-2 |plain|, tests/test_flash_attention.py:77-85,
    which is set at T=128: at T=2048 the mean |out| is about 0.05, and a
    kernel that drops keys from late rows stays within 5e-2); lse <= 1e-3.
    The bf16 bound must reject the known-wrong kernels of ``FWD_FAULTS``."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(B, T, Tk, H, D, dtype, causal)
             for dtype in (torch.float32, torch.bfloat16) for causal in (True, False)
             for (B, T, Tk, H, D) in ((2, 256, 256, 4, 64), (1, 384, 640, 3, 128),
                                      (1, 640, 384, 2, 128), (1, 200, 200, 2, 256),
                                      (2, 333, 333, 3, 128), (1, 333, 517, 2, 128),
                                      (1, 517, 333, 2, 64))]
    # T != Tk at the main width
    cases += [(1, 1024, 2048, 32, 128, torch.bfloat16, causal) for causal in (True, False)]
    main = (2, 2048, 2048, 32, 128, torch.bfloat16, True)
    cases.append(main)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_row = {torch.float32: 0.0, torch.bfloat16: 0.0}
    tol = {torch.float32: (2e-5, 0.0, None), torch.bfloat16: (1.5e-2, 5e-2, 1e-2)}
    for (B, T, Tk, H, D, dtype, causal) in cases:
        q = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, Tk, H, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, Tk, H, D), generator=g, device="cuda").to(dtype)
        out, lse = flash_attention_forward(q, k, v, causal=causal)
        ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                             causal=causal, sm_scale=D ** -0.5)
        torch.cuda.synchronize()
        ok, errs = fwd_within(out, ref, tol[dtype])
        lse_err = float((lse - ref_lse).abs().max())
        ok = ok and lse_err <= 1e-3
        worst[dtype] = max(worst[dtype], errs["max_abs_err"])
        worst_row[dtype] = max(worst_row[dtype], errs["row_rel_l2_max"])
        shape = (B, T, Tk, H, D, str(dtype).split(".")[1], causal)
        row = {"phase": "kernel_check", "kernel": "flash_attention_fwd",
               **dict(zip(("B", "T", "Tk", "H", "D", "dtype", "causal"), shape)), **errs,
               "lse_max_abs_err": lse_err, "atol_rtol_row_tol": tol[dtype], "lse_tol": 1e-3,
               "within": ok}
        emit(row)
        if not ok:
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version: {row}")
        if shape in FWD_FAULTS:
            name, dropped = FWD_FAULTS[shape]
            rows, cols = torch.arange(T, device="cuda")[:, None], torch.arange(Tk, device="cuda")
            wrong = dropped_keys_forward(q, k, v, causal, dropped(rows, cols))
            passes, wrong_errs = fwd_within(wrong, ref, tol[dtype])
            row = {"phase": "bound_check", "kernel": "flash_attention_fwd", "fault": name,
                   "shape": shape, **wrong_errs, "passes_bound": passes,
                   "passes_jax_bound": fwd_within(wrong, ref, (5e-2, 5e-2, None))[0]}
            emit(row)
            if passes:
                raise AssertionError(f"the bf16 forward bound lets a wrong kernel pass: {row}")
            del wrong
        if (B, T, Tk, H, D, dtype, causal) == main:
            main_err = errs["max_abs_err"]
            main_qkv = (q, k, v)
        else:
            del q, k, v, out, ref
    check_fwd_alignment(g)
    q, k, v = main_qkv
    B, T, Tk, H, D = main[:5]
    ms = cuda_ms(lambda: flash_attention_forward(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True, sm_scale=D ** -0.5),
                       iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound_ms, bound_by, ops = attention_bound_ms(B, T, Tk, H, D, 2, True)
    res = {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           **rate(ms, bound_ms, ops)}
    emit({"phase": "kernel_time", "kernel": "flash_attention_fwd",
          "shape": [B, T, H, D], "dtype": "bfloat16", "causal": True, **res,
          "max_abs_err_f32": worst[torch.float32],
          "max_abs_err_bf16": worst[torch.bfloat16],
          "row_rel_l2_max_f32": worst_row[torch.float32],
          "row_rel_l2_max_bf16": worst_row[torch.bfloat16], "card": card})
    return res


def phase_backward_kernels(card: str) -> dict:
    """The dq and dk/dv kernels against flash_attention_backward_plain on
    the forward's shape set, ragged sequences (T not a multiple of any tile)
    and T != Tk at full width, then their times at the main shape. Bounds
    (the JAX package's): float32 |d - plain| <= 5e-5 + 5e-4 |plain|; bf16
    inputs against the plain version on their float32 upcasts
    <= 5e-2 + 5e-2 |plain|."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain, flash_attention_delta,
        flash_attention_forward, launch_bwd_dkv, launch_bwd_dq)

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tol = {torch.float32: (5e-5, 5e-4), torch.bfloat16: (5e-2, 5e-2)}
    cases = [(B, T, Tk, H, D, dtype, causal)
             for dtype in (torch.float32, torch.bfloat16) for causal in (True, False)
             for (B, T, Tk, H, D) in ((2, 256, 256, 4, 64), (1, 384, 640, 3, 128),
                                      (1, 640, 384, 2, 128), (1, 200, 200, 2, 256),
                                      (2, 333, 333, 3, 128), (1, 333, 517, 2, 128),
                                      (1, 517, 333, 2, 64))]
    # T != Tk at the main width
    cases += [(1, 1024, 2048, 32, 128, torch.bfloat16, causal) for causal in (True, False)]
    main = (2, 2048, 2048, 32, 128, torch.bfloat16, True)
    cases.append(main)
    main_err = {}
    for (B, T, Tk, H, D, dtype, causal) in cases:
        q = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, Tk, H, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, Tk, H, D), generator=g, device="cuda").to(dtype)
        do = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
        out, lse = flash_attention_forward(q, k, v, causal=causal)
        got = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
        want = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(),
                                              lse, do.float(), causal=causal,
                                              sm_scale=D ** -0.5)
        torch.cuda.synchronize()
        atol, rtol = tol[dtype]
        errs, ok = {}, True
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            diff = (a.float() - b).abs()
            errs[name] = float(diff.max())
            ok = ok and bool((diff <= atol + rtol * b.abs()).all())
        row = {"phase": "kernel_check", "kernel": "flash_attention_bwd_dq+dkv", "B": B,
               "T": T, "Tk": Tk, "H": H, "D": D, "dtype": str(dtype).split(".")[1],
               "causal": causal, "max_abs_err": errs, "atol": atol, "rtol": rtol,
               "within": ok}
        emit(row)
        if not ok:
            raise AssertionError(f"flash backward disagrees with its plain version: {row}")
        if (B, T, Tk, H, D, dtype, causal) == main:
            main_err = errs
            main_args = (q, k, v, out, lse, do)
        else:
            del q, k, v, do, out, got, want
    q, k, v, out, lse, do = main_args
    B, T, Tk, H, D = main[:5]
    kw = dict(causal=True, sm_scale=D ** -0.5)
    delta = flash_attention_delta(out, do)
    dq_ms = cuda_ms(lambda: launch_bwd_dq(q, k, v, do, lse, delta, **kw))
    dkv_ms = cuda_ms(lambda: launch_bwd_dkv(q, k, v, do, lse, delta, **kw))
    # the torch pass before the pair: SDPA's backward includes its own
    delta_ms = cuda_ms(lambda: flash_attention_delta(out, do))
    # the plain version computes the pair (its p and ds are shared)
    plain_ms = cuda_ms(lambda: flash_attention_backward_plain(q, k, v, out, lse, do, **kw),
                       iters=3)
    # yardstick: SDPA's backward alone (the forward outside the timed region);
    # one call computes dq, dk and dv together, so it is recorded for the pair
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), do.transpose(1, 2),
                                                     retain_graph=True))
    res = {}
    for name, ms, products, err in (
            ("flash_attention_bwd_dq", dq_ms, 3, {"dq": main_err["dq"]}),
            ("flash_attention_bwd_dkv", dkv_ms, 4,
             {"dk": main_err["dk"], "dv": main_err["dv"]})):
        bound_ms, bound_by, ops = backward_bound_ms(B, T, Tk, H, D, 2, True, products)
        res[name] = {"max_abs_err": max(err.values()), "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     **rate(ms, bound_ms, ops)}
        emit({"phase": "kernel_time", "kernel": name, "shape": [B, T, H, D],
              "dtype": "bfloat16", "causal": True, **res[name], "delta_ms": delta_ms,
              "pair_plus_delta_ms": dq_ms + dkv_ms + delta_ms,
              "plain_and_library_cover": "dq+dkv", "card": card})
    return res


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_forward(card: str, kernels, cfg, params, tokens):
    """Returns (flash launches on the main path, the 2-layer float32 config
    and weights)."""
    import torch

    from ray_tpu_torch.models.llama import llama_forward, llama_init, llama_loss

    K = "flash_attention_fwd"
    inputs = tokens[:, :-1]
    with torch.inference_mode():
        llama_forward(params, inputs[:, :1024], cfg)  # warm-up (cuBLAS, allocator)
        kernels.LAUNCHES.clear()  # the main path starts here
        logits, _ = llama_forward(params, inputs, cfg, attn_impl="auto")
        fwd_launches = kernels.launches()[K]
        loss, loss_ms = timed(lambda: llama_loss(params, {"tokens": tokens}, cfg))
        launches = kernels.launches()[K]
        if fwd_launches != cfg.n_layers or launches != 2 * cfg.n_layers:
            raise AssertionError(f"flash kernel launches {fwd_launches}/{launches}, "
                                 f"want {cfg.n_layers} per forward")
        plain, _ = llama_forward(params, inputs, cfg, attn_impl="plain")
        plain_loss = llama_loss(params, {"tokens": tokens}, cfg, attn_impl="plain")
        if tuple(logits.shape) != (*inputs.shape, cfg.vocab_size):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()) or not math.isfinite(float(loss)):
            raise AssertionError("non-finite logits or loss")
        err = rel_l2(logits, plain)
        del logits, plain
        fwd_ms = {"auto": [], "plain": []}
        for impl in ("plain", "auto", "auto", "plain"):  # in turns, one card
            _, ms = timed(lambda: llama_forward(params, inputs, cfg, attn_impl=impl)[0].sum())
            fwd_ms[impl].append(ms)
        # least time of the forward's matrix products (every weight but the
        # embedding, 2 operations per weight per token) at the bf16 peak
        matmul_ops = 2 * inputs.numel() * (tree_numel(params) - params["tok"]["embedding"].numel())
        emit({"phase": "forward", "config": "llama3_8b", "layers": cfg.n_layers,
              "dtype": cfg.dtype, "tokens": list(inputs.shape), "flash_launches": launches,
              "logits_rel_l2_vs_plain": err, "tol": 3e-2, "loss": float(loss),
              "loss_plain": float(plain_loss), "forward_ms": fwd_ms["auto"],
              "forward_plain_ms": fwd_ms["plain"], "loss_ms": loss_ms,
              "matmul_bound_ms": matmul_ops / H100_BF16_FLOPS * 1e3, "card": card})
        if not err <= 3e-2 or abs(float(loss) - float(plain_loss)) > 3e-2:
            raise AssertionError(f"bf16 forward disagrees with plain attention: {err}")

        cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        params32 = llama_init(g, cfg32, "cuda")
        a, _ = llama_forward(params32, inputs, cfg32, attn_impl="auto")
        b, _ = llama_forward(params32, inputs, cfg32, attn_impl="plain")
        err32 = rel_l2(a, b)
        del a, b
        emit({"phase": "forward_f32", "layers": 2, "logits_rel_l2_vs_plain": err32,
              "tol": 1e-4})
        if not err32 <= 1e-4:
            raise AssertionError(f"f32 forward disagrees with plain attention: {err32}")
    return launches, cfg32, params32


def serve(params, cfg, prompts, max_tokens, **engine_kw):
    """Run every prompt through one engine concurrently; returns (outputs,
    per-request time to first token in ms, wall seconds, the engine)."""
    import torch

    from ray_tpu_torch.llm import ContinuousBatchingEngine

    async def go():
        eng = ContinuousBatchingEngine(params, cfg, max_batch=4, page_size=16,
                                       n_pages=512, max_seq_len=2048, **engine_kw)
        await eng.start()
        t0 = time.perf_counter()

        async def one(p):
            rid = eng.submit(p, max_tokens=max_tokens)
            t_sub = time.perf_counter()
            out, first = [], None
            async for blk in eng.stream_blocks(rid):
                if first is None:
                    first = (time.perf_counter() - t_sub) * 1e3
                out.extend(blk)
            return out, first

        try:
            res = await asyncio.gather(*[one(p) for p in prompts])
        finally:
            await eng.stop()
        if eng.error is not None:
            raise RuntimeError("engine loop died") from eng.error
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, eng

    res, wall, eng = asyncio.run(go())
    return [r[0] for r in res], [r[1] for r in res], wall, eng


def check_completions(phase, prompts, outs, cfg, max_tokens, eos=None) -> None:
    """Every completion is max_tokens long (or ends at the eos) and in the
    vocab."""
    for p, o in zip(prompts, outs):
        ok_len = len(o) == max_tokens or (eos is not None and 0 < len(o) and o[-1] == eos)
        if not ok_len or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"{phase}: bad completion for a {len(p)}-token prompt: {o}")


def agreement(outs, ref) -> float:
    """Share of token positions where two runs' greedy tokens agree."""
    pairs = [(a, b) for o, r in zip(outs, ref) for a, b in zip(o, r)]
    return sum(a == b for a, b in pairs) / max(1, len(pairs))


def phase_serving(card: str, kernels, cfg, params, cfg32, params32):
    """Returns (the kernel launch counts of the serving runs, the prompts,
    the bf16 planned loop's tokens and TTFTs, generate's float32 tokens)."""
    import numpy as np

    from ray_tpu_torch.llm import generate

    rng = np.random.default_rng(SEED)
    lens = (16, 100, 257, 512, 1000, 1500)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    max_tokens = 32
    kernels.LAUNCHES.clear()
    planned = planned_ttft = None
    for loop in ("planned", "reactive"):
        eos = None if loop == "planned" else planned[0][max_tokens // 2]
        outs, ttft, wall, _ = serve(params, cfg, prompts, max_tokens, eos_id=eos)
        check_completions(loop, prompts, outs, cfg, max_tokens, eos)
        planned, planned_ttft = planned or outs, planned_ttft or ttft
        n_tok = sum(len(o) for o in outs)
        emit({"phase": "serving", "loop": loop, "layers": cfg.n_layers, "dtype": cfg.dtype,
              "eos_id": eos, "requests": len(prompts), "prompt_lens": list(lens),
              "completion_lens": [len(o) for o in outs], "ttft_ms": ttft,
              "tokens_per_s": n_tok / wall, "wall_s": wall, "card": card})
    serve_launches = dict(kernels.launches())

    ref = generate(params32, cfg32, prompts, max_new_tokens=max_tokens)
    for loop, eos in (("planned", None), ("reactive", -1)):
        outs, _, _, _ = serve(params32, cfg32, prompts, max_tokens, eos_id=eos)
        same = [o == r for o, r in zip(outs, ref)]
        emit({"phase": "serving_f32_parity", "loop": loop, "layers": 2,
              "equal_to_generate": same})
        if not all(same):
            raise AssertionError(f"f32 engine ({loop}) differs from generate: {outs} vs {ref}")
    return serve_launches, prompts, planned, planned_ttft, ref


def prefill_pages(cfg, params, prompts, kv_dtype):
    """Admit ``prompts`` into a fresh engine (one prefill wave, no decode)
    and return (the engine, each prompt's pool pages)."""
    from ray_tpu_torch.llm import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(params, cfg, max_batch=len(prompts), page_size=16,
                                   n_pages=512, max_seq_len=2048, kv_dtype=kv_dtype)
    for p in prompts:
        eng.submit(p, max_tokens=1)
    eng._admit_wave()
    pages = [eng.page_tables[r.slot, :-(-len(r.prompt) // 16)].tolist()
             for r in eng.slot_req]
    return eng, pages


def phase_serving_int8(card: str, cfg, params, cfg32, params32, prompts, planned, ref32):
    """The engine with kv_dtype="int8" at 32 layers, bf16: both loops, the
    pools' dtypes and device, the dequantized prompt K/V against the native
    engine's pool; at 2 layers, float32: greedy agreement with the native
    engine >= 85% (the JAX package's bound, tests/test_llm.py)."""
    import torch

    from ray_tpu_torch.llm.engine import _kv_read

    max_tokens = 32
    first = None
    for loop in ("planned", "reactive"):
        eos = None if loop == "planned" else first[0][max_tokens // 2]
        outs, ttft, wall, eng = serve(params, cfg, prompts, max_tokens, eos_id=eos,
                                      kv_dtype="int8")
        check_completions(f"serving_int8 {loop}", prompts, outs, cfg, max_tokens, eos)
        pools = {name: (pool["q"].dtype, pool["q"].device.type, pool["s"].dtype,
                        pool["s"].device.type)
                 for name, pool in (("k", eng.kpool), ("v", eng.vpool))}
        del eng
        first = first or outs
        n_tok = sum(len(o) for o in outs)
        emit({"phase": "serving_int8", "loop": loop, "layers": cfg.n_layers,
              "dtype": cfg.dtype, "kv_dtype": "int8", "eos_id": eos,
              "completion_lens": [len(o) for o in outs], "ttft_ms": ttft,
              "tokens_per_s": n_tok / wall, "wall_s": wall,
              "pools": {k: [str(x) for x in v] for k, v in pools.items()},
              "greedy_agreement_vs_bf16_pool": agreement(outs, planned) if loop == "planned"
              else None, "card": card})
        want = (torch.int8, "cuda", torch.float32, "cuda")
        if any(v != want for v in pools.values()):
            raise AssertionError(f"int8 pools are not int8/float32 on cuda: {pools}")

    # the prompt K/V, dequantized, against the native engine's pool
    native, pages = prefill_pages(cfg, params, prompts, None)
    q8, pages8 = prefill_pages(cfg, params, prompts, "int8")
    if pages != pages8:
        raise AssertionError("the two engines admitted into different pages")
    worst = 0.0
    for pg, p in zip(pages, prompts):
        idx = torch.tensor([pg], device="cuda")
        for i in range(cfg.n_layers):
            for a, b in ((native.kpool, q8.kpool), (native.vpool, q8.vpool)):
                want = _kv_read(a, i, idx, cfg.torch_dtype)[0, :len(p)].float()
                got = _kv_read(b, i, idx, cfg.torch_dtype)[0, :len(p)].float()
                ratio = (got - want).abs().amax(-1) / want.abs().amax(-1).clamp_min(1e-30)
                worst = max(worst, float(ratio.max()))
    del native, q8
    emit({"phase": "serving_int8_pool", "layers": cfg.n_layers, "dtype": cfg.dtype,
          "positions": sum(len(p) for p in prompts),
          "worst_err_over_vector_max": worst, "tol": 1.5e-2, "card": card})
    if not worst <= 1.5e-2:
        raise AssertionError(f"int8 pool off the native pool by {worst} of max|val|")

    # float32: greedy agreement with the native engine. Free-running, one
    # flip changes every later input of its request, so at full width with
    # random weights (near-ties every few dozen tokens) the share says little;
    # the check is per token, each prediction made on the native engine's
    # own prefix (teacher-forced), against the native pool's as a control
    outs, _, _, _ = serve(params32, cfg32, prompts, max_tokens, kv_dtype="int8")
    forced = {kv: agreement(teacher_forced(cfg32, params32, prompts, ref32, kv), ref32)
              for kv in (None, "int8")}
    forced_bf16 = {kv: agreement(teacher_forced(cfg, params, prompts, planned, kv), planned)
                   for kv in (None, "int8")}
    agree = forced["int8"]
    emit({"phase": "serving_int8_f32", "layers": 2,
          "free_running_agreement_vs_native": agreement(outs, ref32),
          "per_token_agreement_vs_native": agree,
          "per_token_agreement_native_pool": forced[None], "tol": 0.85,
          "bf16_32_layers_per_token_agreement": forced_bf16["int8"],
          "bf16_32_layers_per_token_agreement_native_pool": forced_bf16[None]})
    if not agree >= 0.85:
        raise AssertionError(f"int8 f32 engine agrees with the native one on {agree}")


def teacher_forced(cfg, params, prompts, conts, kv_dtype):
    """The engine's greedy prediction at every position of ``conts`` (each
    prompt's continuation), each made on the prompt and conts' own tokens
    before it: the prompts are prefilled into a fresh pool, then the
    continuation is fed one decode step at a time."""
    import torch

    from ray_tpu_torch.llm.engine import make_kv_pools, paged_decode_multi, paged_prefill_batch

    PS, B, T = 16, len(prompts), len(conts[0])
    n_pages = [-(-(len(p) + T) // PS) for p in prompts]
    kpool, vpool = make_kv_pools(cfg, PS, sum(n_pages) + 1, kv_dtype, "cuda")
    table = torch.zeros((B, max(n_pages)), dtype=torch.long, device="cuda")
    zeros = torch.zeros(1, dtype=torch.long, device="cuda")
    preds, first = [[] for _ in prompts], 1
    for b, p in enumerate(prompts):
        table[b, :n_pages[b]] = torch.arange(first, first + n_pages[b])
        first += n_pages[b]
        n = -(-len(p) // PS)
        toks = torch.zeros((1, n * PS), dtype=torch.long, device="cuda")
        toks[0, :len(p)] = torch.tensor(p)
        preds[b].append(int(paged_prefill_batch(
            params, None, zeros, toks, table[b:b + 1, :n], kpool, vpool,
            torch.tensor([len(p)], device="cuda"), zeros.float(), None, cfg)[0]))
    fed = torch.tensor(conts, device="cuda")
    pos = torch.tensor([len(p) for p in prompts], device="cuda")
    every = torch.ones(B, dtype=torch.bool, device="cuda")
    for j in range(T - 1):
        toks, _, _ = paged_decode_multi(params, None, zeros.expand(B), fed[:, j], pos + j,
                                        table, kpool, vpool, every, zeros.expand(B).float(),
                                        None, cfg, 1)
        for b, t in enumerate(toks[0].tolist()):
            preds[b].append(t)
    return preds


def teacher_forced_verify(cfg, params, prompts, conts, dec, k):
    """The verify forward's greedy predictions on ``conts`` (each prompt's
    continuation) as ``teacher_forced`` lays them out: the prompts are
    prefilled, then the continuation is fed k+1 positions at a time
    through paged_decode_verify, its own next k tokens as the drafts, so
    each position is predicted on the continuation's own prefix, as
    decode's are in ``dec`` (``teacher_forced``'s). Returns (predictions,
    one row per position where they differ from ``dec``: the verify
    logits' top-2 margin and the gap between its token's logit and
    decode's token's, beside one bf16 step at that logit)."""
    import torch

    from ray_tpu_torch.llm.engine import (
        _paged_forward, make_kv_pools, paged_decode_verify, paged_prefill_batch)
    from ray_tpu_torch.ops.basic import matmul, rope_freqs

    PS, B, T = 16, len(prompts), len(conts[0])
    n_pages = [-(-(len(p) + T + k) // PS) for p in prompts]
    kpool, vpool = make_kv_pools(cfg, PS, sum(n_pages) + 1, None, "cuda")
    table = torch.zeros((B, max(n_pages)), dtype=torch.long, device="cuda")
    zeros = torch.zeros(1, dtype=torch.long, device="cuda")
    preds, first = [[] for _ in prompts], 1
    for b, p in enumerate(prompts):
        table[b, :n_pages[b]] = torch.arange(first, first + n_pages[b])
        first += n_pages[b]
        n = -(-len(p) // PS)
        toks = torch.zeros((1, n * PS), dtype=torch.long, device="cuda")
        toks[0, :len(p)] = torch.tensor(p)
        preds[b].append(int(paged_prefill_batch(
            params, None, zeros, toks, table[b:b + 1, :n], kpool, vpool,
            torch.tensor([len(p)], device="cuda"), zeros.float(), None, cfg)[0]))
    fed = torch.tensor(conts, device="cuda")
    fed = torch.cat([fed, torch.zeros((B, k), dtype=torch.long, device="cuda")], 1)
    pos = torch.tensor([len(p) for p in prompts], device="cuda")
    aids, every = zeros.expand(B), torch.ones(B, dtype=torch.bool, device="cuda")
    cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device="cuda")
    ar = torch.arange(k + 1, device="cuda")
    flips = []
    for j in range(0, T - 1, k + 1):
        n = min(k, T - 2 - j)  # the window predicts positions j+1 .. j+n+1
        drafts = fed[:, j + 1:j + 1 + k]
        out, _, _, _, _ = paged_decode_verify(
            params, None, aids, fed[:, j], pos + j, drafts, table, kpool, vpool,
            torch.full((B,), n, device="cuda"), every, aids.float(), None, cfg)
        with torch.inference_mode():  # the same forward, for its logits
            x = _paged_forward(params, None, aids, fed[:, j:j + k + 1],
                               (pos + j)[:, None] + ar[None, :], table, kpool, vpool,
                               cfg, cos, sin)
            logits = matmul(x, params["lm_head"]["kernel"]).float()
        if not torch.equal(logits.argmax(-1), out):
            raise AssertionError("paged_decode_verify's tokens are not its forward's argmax")
        top2 = logits.topk(2, dim=-1).values
        out = out.tolist()
        for b in range(B):
            for i in range(n + 1):
                v, d = out[b][i], dec[b][j + i + 1]
                preds[b].append(v)
                if v != d:
                    lv = float(logits[b, i, v])
                    flips.append({"request": b, "position": j + i + 1,
                                  "verify_token": v, "decode_token": d,
                                  "top2_margin": float(top2[b, i, 0] - top2[b, i, 1]),
                                  "logit_gap": lv - float(logits[b, i, d]),
                                  "bf16_step_at_logit": 2.0 ** (math.floor(
                                      math.log2(max(abs(lv), 1e-30))) - 7)})
    del kpool, vpool
    return preds, flips


def repetitive_prompt(n, seed):
    """A 6-token motif repeated to n tokens (tests/test_spec_decode.py)."""
    import numpy as np

    pat = list(map(int, np.random.default_rng(seed).integers(1, 512, 6)))
    return (pat * (n // len(pat) + 1))[:n]


def drafter(prompts, conts, vocab, wrong=False):
    """A spec_drafter that proposes each request's continuation from
    ``conts`` (or (token + 1) % vocab of it): the request is the one with
    the longest prompt that its context starts with."""
    import numpy as np

    seqs = sorted(((np.asarray(p), list(p) + list(c)) for p, c in zip(prompts, conts)),
                  key=lambda pc: -len(pc[0]))

    def propose(context, pos, k):
        seq = next(s for p, s in seqs
                   if len(p) <= len(context) and np.array_equal(context[:len(p)], p))
        got = seq[pos + 1:pos + 1 + k]
        return [(t + 1) % vocab for t in got] if wrong else got

    return propose


def phase_serving_spec(card: str, cfg, params, cfg32, params32, prompts):
    """Speculative decoding (spec_k 4, spec_ngram 2) over the prompts and
    two repetitive ones. 32 layers, bf16: tokens/s, TTFT, counters and the
    agreement with the plain engine, as information (random weights), and
    the oracle drafter's ceiling; 2 layers, float32: the fused n-gram path
    and the oracle and wrong drafters emit the plain engine's tokens, the
    oracle is accepted in full and the wrong one never."""
    from ray_tpu_torch.llm import generate

    prompts = prompts + [repetitive_prompt(256, 0), repetitive_prompt(1024, 1)]
    max_tokens = 32
    spec_kw = dict(spec_enable=True, spec_k=4, spec_ngram=2)

    def stats_row(eng):
        st = eng.spec_stats()
        return {k: st[k] for k in ("spec_steps", "spec_proposed", "spec_accepted",
                                   "spec_accept_rate")}

    # at bf16 the verify forward ([B, k+1, D] products) can flip a greedy
    # near-tie that plain decode ([B, 1, D]) does not, so the oracle runs
    # twice: on the plain engine's continuation (asked for), and on the spec
    # engine's own (the n-gram run's tokens), whose acceptance is the
    # verify path's real ceiling
    plain, _, plain_wall, _ = serve(params, cfg, prompts, max_tokens)
    spec_outs = None
    for name in ("ngram", "oracle", "oracle_own"):
        extra = {} if name == "ngram" else {"spec_drafter": drafter(
            prompts, plain if name == "oracle" else spec_outs, cfg.vocab_size)}
        outs, ttft, wall, eng = serve(params, cfg, prompts, max_tokens, **spec_kw, **extra)
        spec_outs = spec_outs or outs
        check_completions(f"serving_spec {name}", prompts, outs, cfg, max_tokens)
        n_tok = sum(len(o) for o in outs)
        emit({"phase": "serving_spec", "drafter": name, "layers": cfg.n_layers,
              "dtype": cfg.dtype, "prompt_lens": [len(p) for p in prompts],
              "ttft_ms": ttft, "tokens_per_s": n_tok / wall, "wall_s": wall,
              "plain_tokens_per_s": n_tok / plain_wall, **stats_row(eng),
              "agreement_vs_plain": agreement(outs, plain),
              "agreement_vs_ngram_run": agreement(outs, spec_outs), "card": card})
        del eng

    # teacher-forced on the plain engine's bf16 continuation: decode's
    # prediction ([B, 1] products) against the verify forward's ([B, k+1]),
    # each on the same prefix, so one near-tie flip cannot derail the rest
    dec = teacher_forced(cfg, params, prompts, plain, None)
    ver, flips = teacher_forced_verify(cfg, params, prompts, plain, dec, spec_kw["spec_k"])
    forced = agreement([v[1:] for v in ver], [d[1:] for d in dec])
    emit({"phase": "serving_spec_forced", "layers": cfg.n_layers, "dtype": cfg.dtype,
          "positions": sum(len(d) - 1 for d in dec), "verify_vs_decode_agreement": forced,
          "tol": 0.95, "free_running_spec_vs_plain": agreement(spec_outs, plain),
          "flips": flips, "card": card})
    if not forced >= 0.95:
        raise AssertionError(f"bf16 verify forward agrees with decode on {forced} of "
                             f"teacher-forced positions: {flips}")

    ref = generate(params32, cfg32, prompts, max_new_tokens=max_tokens)
    for name, extra in (("ngram", {}),
                        ("oracle", {"spec_drafter": drafter(prompts, ref, cfg.vocab_size)}),
                        ("wrong", {"spec_drafter": drafter(prompts, ref, cfg.vocab_size,
                                                           wrong=True)})):
        outs, _, _, eng = serve(params32, cfg32, prompts, max_tokens, **spec_kw, **extra)
        st = stats_row(eng)
        del eng
        same = [o == r for o, r in zip(outs, ref)]
        emit({"phase": "serving_spec_f32", "drafter": name, "layers": 2, **st,
              "equal_to_plain": same})
        if not all(same):
            raise AssertionError(f"f32 spec engine ({name}) differs from plain: {outs} vs {ref}")
        if name == "oracle" and not st["spec_accepted"] == st["spec_proposed"] > 0:
            raise AssertionError(f"the oracle drafter was not accepted in full: {st}")
        if name == "wrong" and not (st["spec_accepted"] == 0 and st["spec_proposed"] > 0):
            raise AssertionError(f"the wrong drafter was accepted: {st}")


def phase_serving_adopt(card: str, cfg, params, cfg32, params32, prompts) -> None:
    """Page adoption: a live request's prompt pages (kpool[:, rows]) from
    one engine are submit_prefilled into a second with the first token; no
    prefill may run there, and at float32 the continuation must equal the
    first engine's. Then paged_prefill_suffix over a page-aligned prefix
    scattered into a fresh pool: at float32 its first token must equal the
    full prefill's."""
    import importlib

    import torch

    from ray_tpu_torch.llm import ContinuousBatchingEngine

    em = importlib.import_module("ray_tpu_torch.llm.engine")
    max_tokens, PS = 32, 16
    prompt = prompts[-1]  # the longest
    n_cover = -(-len(prompt) // PS)

    def engine(c, p):
        # an eos outside the vocab: the reactive loop, never cut short
        return ContinuousBatchingEngine(p, c, max_batch=4, page_size=PS, n_pages=512,
                                        max_seq_len=2048, eos_id=c.vocab_size)

    async def source(c, p):
        """(tokens, k_stack, v_stack, first token, TTFT ms) of the prompt
        in a first engine, the stacks taken while the request is live."""
        eng = engine(c, p)
        await eng.start()
        t0 = time.perf_counter()
        rid = eng.submit(prompt, max_tokens=max_tokens)
        out, stacks, ttft = [], None, None
        async for blk in eng.stream_blocks(rid):
            if stacks is None:
                ttft = (time.perf_counter() - t0) * 1e3
                rows = torch.tensor(eng.page_tables[eng._reqs[rid].slot, :n_cover],
                                    device="cuda")
                stacks = (eng.kpool[:, rows], eng.vpool[:, rows])
            out.extend(blk)
        await eng.stop()
        return out, *stacks, out[0], ttft

    async def adopt(c, p, k_stack, v_stack, first):
        eng = engine(c, p)
        await eng.start()
        t0 = time.perf_counter()
        rid = eng.submit_prefilled(prompt, k_stack, v_stack, first, max_tokens=max_tokens)
        out, ttft = [], None
        async for blk in eng.stream_blocks(rid):
            if ttft is None:
                ttft = (time.perf_counter() - t0) * 1e3
            out.extend(blk)
        await eng.stop()
        return out, ttft

    real, calls = em.paged_prefill_batch, []
    for c, p in ((cfg, params), (cfg32, params32)):
        out, k_stack, v_stack, first, src_ttft = asyncio.run(source(c, p))
        em.paged_prefill_batch = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        try:
            got, ttft = asyncio.run(adopt(c, p, k_stack, v_stack, first))
        finally:
            em.paged_prefill_batch = real

        # suffix prefill over the first n_cover - 1 pages, scattered into
        # pages of a fresh pool; the suffix's pages follow them
        kpool, vpool = em.make_kv_pools(c, PS, n_cover + 8, None, "cuda")
        n_pre = n_cover - 1
        pre = list(range(1, n_cover))
        em.scatter_pages(kpool, pre, k_stack[:, :n_pre])
        em.scatter_pages(vpool, pre, v_stack[:, :n_pre])
        suffix = prompt[n_pre * PS:]
        Ts = 64  # a padded bucket: its tail passes the table's last page
        toks = torch.zeros((1, Ts), dtype=torch.long, device="cuda")
        toks[0, :len(suffix)] = torch.tensor(suffix)
        table = torch.tensor([pre + [n_cover]], device="cuda")
        aids, prefix_lens, true_lens, temps = (
            torch.tensor(x, device="cuda") for x in ([0], [n_pre * PS], [len(suffix)], [0.0]))
        suffix_first, suffix_ms = timed(lambda: em.paged_prefill_suffix(
            p, None, aids, toks, table, kpool, vpool, prefix_lens, true_lens, temps,
            None, c))
        del kpool, vpool, k_stack, v_stack
        row = {"phase": "serving_adopt", "layers": c.n_layers, "dtype": c.dtype,
               "prompt_len": len(prompt), "pages": n_cover, "prefills_in_adopting_engine":
               len(calls), "source_ttft_ms": src_ttft, "adopted_ttft_ms": ttft,
               "continuation_equal": got == out, "suffix_prefix_tokens": n_pre * PS,
               "suffix_tokens": len(suffix), "suffix_prefill_ms": suffix_ms,
               "suffix_first_equal": int(suffix_first[0]) == first, "card": card}
        emit(row)
        if calls:
            raise AssertionError(f"the adopting engine ran {len(calls)} prefills")
        if c.dtype == "float32" and not (row["continuation_equal"]
                                         and row["suffix_first_equal"]):
            raise AssertionError(f"f32 adoption or suffix prefill differs: {row}")
        if len(got) != max_tokens:
            raise AssertionError(f"adopted request gave {len(got)} tokens")


def count_generate_calls():
    """Wrap ``ray_tpu_torch.llm.generation.generate`` (the servers and the
    processor call it by module attribute): returns (the list of batch
    sizes it was called with, a function that restores it)."""
    import importlib

    gen = importlib.import_module("ray_tpu_torch.llm.generation")
    real, calls = gen.generate, []

    def counting(params, cfg, prompts, **kw):
        calls.append(len(prompts))
        return real(params, cfg, prompts, **kw)

    gen.generate = counting
    return calls, lambda: setattr(gen, "generate", real)


def phase_serving_server(card: str, kernels, cfg, params, cfg32, params32, prompts,
                         ref32) -> dict:
    """The serving layer above the engine. LLMEngineServer answers the 6
    prompts (32 new tokens, max_batch 4) through __call__ and
    stream_deltas together; LLMServer takes 8 concurrent requests at two
    temperatures in one batch (exactly one generate call per temperature);
    build_llm_processor maps generate over an 8-row dataset in batches of
    4 (2 calls). 32 layers, bf16: TTFT, tokens/s and deltas per request,
    as information. 2 layers, float32: __call__, stream and stream_deltas
    give the aggregated engine's tokens (generate's, phase serving), and
    LLMServer and the processor give generate's on the same batches.
    Returns the kernel launches of the bf16 runs."""
    import numpy as np

    from ray_tpu_torch.data import from_items
    from ray_tpu_torch.llm import LLMEngineServer, LLMServer, build_llm_processor, generate

    max_tokens = 32
    rng = np.random.default_rng(SEED + 5)
    # LLMServer: 8 requests, greedy and sampled in turns
    server_prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
                      for n in (24, 60, 130, 200, 256, 333, 400, 512)]
    temps = [0.0, 0.8] * 4
    # the processor's rows: ray_tpu.data's numpy batch format needs equal lengths
    rows = [{"prompt_tokens": rng.integers(0, cfg.vocab_size, size=64).tolist(), "id": i}
            for i in range(8)]

    async def engine_server(c, p, paths):
        """Each prompt through one path; returns ([(tokens, first-item ms,
        deltas)] per prompt, wall s, the server's engine_stats)."""
        srv = LLMEngineServer(c, p, max_batch=4, page_size=16, n_pages=512,
                              max_seq_len=2048)

        async def one(q, path):
            req = {"prompt_tokens": q, "max_tokens": max_tokens}
            t0, first, toks, n = time.perf_counter(), None, [], 0
            if path == "__call__":
                res = await srv(req)
                if res["usage"]["completion_tokens"] != len(res["completion_tokens"]):
                    raise AssertionError(f"__call__ usage {res['usage']}")
                return res["completion_tokens"], None, None
            if path == "stream":
                async for tok in srv.stream(req):
                    first = first or (time.perf_counter() - t0) * 1e3
                    toks.append(tok)
                return toks, first, None
            async for d in srv.stream_deltas(req):
                if d.get("done"):
                    if d["tokens"] or d["usage"]["completion_tokens"] != len(toks):
                        raise AssertionError(f"stream_deltas terminal delta {d}")
                    continue
                first = first or (time.perf_counter() - t0) * 1e3
                toks.extend(d["tokens"])
                n += 1
            return toks, first, n

        t0 = time.perf_counter()
        try:
            res = await asyncio.gather(*[one(q, path) for q, path in zip(prompts, paths)])
        finally:
            await srv.engine.stop()
        return res, time.perf_counter() - t0, srv.engine_stats()

    async def llm_server(c, p):
        srv = LLMServer(c, p, max_batch_size=8)
        t0 = time.perf_counter()
        res = await asyncio.gather(*[
            srv({"prompt_tokens": q, "max_tokens": max_tokens, "temperature": t})
            for q, t in zip(server_prompts, temps)])
        return res, time.perf_counter() - t0

    def processor(c, p):
        t0 = time.perf_counter()
        out = build_llm_processor(c, params=p, batch_size=4, max_new_tokens=max_tokens)(
            from_items(rows)).take_all()
        return out, time.perf_counter() - t0

    calls, restore = count_generate_calls()
    try:
        kernels.LAUNCHES.clear()  # the bf16 serving layer's runs start here
        paths = ["__call__", "stream_deltas"] * 3
        res, wall, stats = asyncio.run(engine_server(cfg, params, paths))
        check_completions("serving_server", prompts, [r[0] for r in res], cfg, max_tokens)
        emit({"phase": "serving_server", "server": "LLMEngineServer", "layers": cfg.n_layers,
              "dtype": cfg.dtype, "requests": len(prompts), "paths": paths,
              "prompt_lens": [len(q) for q in prompts],
              "ttft_ms": [r[1] for r in res], "deltas": [r[2] for r in res],
              "tokens_per_s": sum(len(r[0]) for r in res) / wall, "wall_s": wall,
              "engine_stats": stats, "card": card})
        calls.clear()
        res, wall = asyncio.run(llm_server(cfg, params))
        server_calls = list(calls)
        check_completions("serving_server LLMServer", server_prompts,
                          [r["completion_tokens"] for r in res], cfg, max_tokens)
        batch_sizes = [r["usage"]["batch_size"] for r in res]
        emit({"phase": "serving_server", "server": "LLMServer", "layers": cfg.n_layers,
              "dtype": cfg.dtype, "requests": len(res), "temperatures": temps,
              "batch_sizes": batch_sizes, "generate_calls": server_calls,
              "latency_s": [r["usage"]["latency_s"] for r in res],
              "tokens_per_s": len(res) * max_tokens / wall, "wall_s": wall, "card": card})
        if not (min(batch_sizes) > 1 and sorted(server_calls) == [4, 4]):
            raise AssertionError(f"LLMServer batches {batch_sizes}, generate calls "
                                 f"{server_calls}; want one batch, one call per temperature")
        calls.clear()
        out, wall = processor(cfg, params)
        proc_calls = list(calls)
        check_completions("serving_server processor", [r["prompt_tokens"] for r in rows],
                          [r["completion_tokens"].tolist() for r in out], cfg, max_tokens)
        emit({"phase": "serving_server", "server": "build_llm_processor",
              "layers": cfg.n_layers, "dtype": cfg.dtype, "rows": len(out),
              "batch_size": 4, "generate_calls": proc_calls,
              "tokens_per_s": len(out) * max_tokens / wall, "wall_s": wall, "card": card})
        if proc_calls != [4, 4] or [int(r["id"]) for r in out] != list(range(8)):
            raise AssertionError(f"processor generate calls {proc_calls}")
        launches = dict(kernels.launches())

        # float32, 2 layers: token identity
        same = {}
        for path in ("__call__", "stream", "stream_deltas"):
            res, _, _ = asyncio.run(engine_server(cfg32, params32, [path] * len(prompts)))
            same[path] = [r[0] == want for r, want in zip(res, ref32)]
        res, _ = asyncio.run(llm_server(cfg32, params32))
        greedy = [i for i, t in enumerate(temps) if t == 0.0]
        want = generate(params32, cfg32, [server_prompts[i] for i in greedy],
                        max_new_tokens=max_tokens)
        same["LLMServer"] = [res[i]["completion_tokens"] == w for i, w in zip(greedy, want)]
        out, _ = processor(cfg32, params32)
        want = [t for b in (rows[:4], rows[4:])
                for t in generate(params32, cfg32, [r["prompt_tokens"] for r in b],
                                  max_new_tokens=max_tokens)]
        same["processor"] = [r["completion_tokens"].tolist() == w for r, w in zip(out, want)]
    finally:
        restore()
    emit({"phase": "serving_server_f32", "layers": 2, "equal": same})
    if not all(all(v) for v in same.values()):
        raise AssertionError(f"f32 serving layer differs from the engine/generate: {same}")
    return launches


def check_shipped_pages(cfg, params, prompts, kv_dtypes) -> list:
    """Admit ``prompts`` into an engine per kv_dtype, export every live
    request's pages and hold each shipped page, and each adopted stack,
    against the pool rows bit for bit. Returns one row per kv_dtype."""
    import torch

    from ray_tpu_torch.llm.disagg import adopt_pages
    from ray_tpu_torch.llm.disagg.kv_plane import _from_host

    rows = []
    for kv in kv_dtypes:
        eng, pages = prefill_pages(cfg, params, prompts, kv)
        same, n = True, 0
        for req, pg in zip(eng.slot_req, pages):
            m = eng.export_pages(req.req_id)
            stacks = adopt_pages(m)
            for side, pool, stack in (("k", eng.kpool, stacks[0]), ("v", eng.vpool, stacks[1])):
                parts = pool if isinstance(pool, dict) else {"": pool}
                for name, t in parts.items():
                    want = t[:, torch.tensor(pg, device="cuda")].cpu()
                    got = stack[name] if name else stack
                    same = same and torch.equal(got, want)
                    for i in range(len(pg)):
                        arr = m.pages[i].refs[side if not name else f"{side}.{name}"]
                        same = same and torch.equal(_from_host(arr), want[:, i])
            n += len(pg)
        del eng
        rows.append({"layers": cfg.n_layers, "dtype": cfg.dtype, "kv_dtype": kv or "native",
                     "pages": n, "bit_exact": same})
    return rows


def phase_serving_disagg(card: str, kernels, cfg, params, cfg32, params32, prompts, ref32,
                         agg_ttft) -> dict:
    """In-process disaggregated serving. PrefillWorker prefills the 6
    prompts in one wave, each manifest is adopted by a DecodeWorker
    (decode_adopted; the same workers share the weights); then the cache
    leg: an aggregated engine's export_pages of each live request,
    PrefixCache.insert, lookup, a suffix prefill over the cached pages and
    decode_adopted(prefix, suffix). 2 layers, float32: both legs give the
    aggregated engine's tokens; shipped pages and adopted stacks equal
    their pool rows bit for bit for native, bf16 and int8 pools (and the
    bf16 native pool at 32 layers). 32 layers, bf16: the wave's ms, the
    ship and adopt ms and bytes from the telemetry, adopted TTFT (through
    decode_adopted_stream, the 6 together and each alone) against the
    aggregated engine's TTFT (phase serving), decode tokens/s, and the
    cached leg's suffix wave timed apart from its decodes. Returns the
    kernel launches of the bf16 runs."""
    from ray_tpu_torch.llm import ContinuousBatchingEngine
    from ray_tpu_torch.llm.disagg import DecodeWorker, PrefillWorker, PrefixCache, telemetry

    max_tokens, PS = 32, 16

    async def run(c, p, info):
        pf = PrefillWorker(c, p, page_size=PS, n_pages=512, max_wave=8)
        dw = DecodeWorker(c, p, max_batch=4, page_size=PS, n_pages=512, max_seq_len=2048)
        telemetry.reset_counters()
        ship0 = len(telemetry.stage_window(telemetry.KV_SHIP))
        queue0 = len(telemetry.stage_window(telemetry.DECODE_QUEUE))

        def window_ms(stage, start):
            return [x / 1e6 for x in telemetry.stage_window(stage)[start:]]

        row = {}
        try:
            t0 = time.perf_counter()
            res = await asyncio.gather(*[pf.prefill(q) for q in prompts])
            row["prefill_wave_ms"] = (time.perf_counter() - t0) * 1e3
            row["waves"] = pf.waves
            row["ship_ms"] = window_ms(telemetry.KV_SHIP, ship0)
            shipped = telemetry.counters()
            row["ship_bytes"], row["pages_shipped"] = (shipped["kv_array_bytes"],
                                                       shipped["pages_shipped"])
            t0 = time.perf_counter()
            full = await asyncio.gather(*[
                dw.decode_adopted(q, m, None, first, max_tokens=max_tokens)
                for q, (m, first) in zip(prompts, res)])
            wall = time.perf_counter() - t0
            row["adopt_ms"] = window_ms(telemetry.KV_SHIP, ship0 + len(prompts))
            row["adopt_bytes"] = telemetry.counters()["kv_array_bytes"] - row["ship_bytes"]
            row["pages_adopted"] = telemetry.counters()["pages_adopted"]
            row["decode_queue_ms"] = window_ms(telemetry.DECODE_QUEUE, queue0)
            row["decode_tokens_per_s"] = sum(len(o) for o in full) / wall
            if info:  # adopted TTFT: call to first delta, the same manifests again
                async def stream_ttft(q, m, first):
                    t0, ttft = time.perf_counter(), None
                    async for _ in dw.decode_adopted_stream(q, m, None, first,
                                                            max_tokens=max_tokens):
                        ttft = ttft or (time.perf_counter() - t0) * 1e3
                    return ttft

                row["adopted_ttft_ms"] = await asyncio.gather(*[
                    stream_ttft(q, m, first) for q, (m, first) in zip(prompts, res)])
                # one request at a time into an idle engine: adoption's own cost
                row["adopted_ttft_alone_ms"] = [await stream_ttft(q, m, first)
                                                for q, (m, first) in zip(prompts, res)]
            del res

            # the cache leg: pages exported from a live aggregated request
            eng = ContinuousBatchingEngine(p, c, max_batch=4, page_size=PS, n_pages=512,
                                           max_seq_len=2048, eos_id=c.vocab_size)
            cache = PrefixCache(PS, capacity_bytes=1 << 34)
            await eng.start()

            async def source(q):
                rid, out = eng.submit(q, max_tokens=max_tokens), []
                async for blk in eng.stream_blocks(rid):
                    if not out:
                        cache.insert(eng.export_pages(rid))
                    out.extend(blk)
                return out

            try:
                agg = await asyncio.gather(*[source(q) for q in prompts])
            finally:
                await eng.stop()
            del eng

            async def cached_prefill(q):
                """(the cached prefix or None, the manifest this call
                produced, the first token, the call's ms)."""
                pre = cache.lookup(q, max_tokens=len(q) - 1)
                t0 = time.perf_counter()
                if pre is None:  # under one full page to share
                    m, first = await pf.prefill(q)
                else:
                    m, first = await pf.prefill(q[pre.n_tokens:], prefix=pre)
                return pre, m, first, (time.perf_counter() - t0) * 1e3

            # the suffix wave alone, then the decodes: a decode block holds the
            # event loop, so timing the two interleaved would time the decode
            waves0, t0 = pf.waves, time.perf_counter()
            legs = await asyncio.gather(*[cached_prefill(q) for q in prompts])
            row["suffix_wave_ms"] = (time.perf_counter() - t0) * 1e3
            row["suffix_waves"] = pf.waves - waves0
            row["suffix_prefill_ms"] = [ms if pre else None for pre, _, _, ms in legs]
            try:
                via_cache = await asyncio.gather(*[
                    dw.decode_adopted(q, pre or m, m if pre else None, first,
                                      max_tokens=max_tokens)
                    for q, (pre, m, first, _) in zip(prompts, legs)])
            finally:
                for pre, *_ in legs:
                    cache.release(pre)
            row["cache"] = cache.stats()
            row["free_staging_pages"] = len(pf.free_pages)
        finally:
            await dw.stop()
        return full, via_cache, agg, row

    kernels.LAUNCHES.clear()  # the bf16 disagg runs start here
    full, cached, agg, row = asyncio.run(run(cfg, params, True))
    launches = dict(kernels.launches())
    check_completions("serving_disagg", prompts, full + cached, cfg, max_tokens)
    emit({"phase": "serving_disagg", "layers": cfg.n_layers, "dtype": cfg.dtype,
          "prompt_lens": [len(q) for q in prompts], **row,
          "aggregated_ttft_ms": agg_ttft,
          "agreement_full_vs_aggregated": agreement(full, agg),
          "agreement_cached_vs_aggregated": agreement(cached, agg), "card": card})
    pages = check_shipped_pages(cfg, params, prompts, [None])

    full32, cached32, agg32, row32 = asyncio.run(run(cfg32, params32, False))
    pages += check_shipped_pages(cfg32, params32, prompts, [None, "bf16", "int8"])
    same = {"full": [o == r for o, r in zip(full32, ref32)],
            "cached": [o == r for o, r in zip(cached32, ref32)],
            "source": [o == r for o, r in zip(agg32, ref32)]}
    emit({"phase": "serving_disagg_f32", "layers": 2, "equal_to_aggregated": same,
          "cache": row32["cache"], "shipped_pages": pages})
    if not all(all(v) for v in same.values()):
        raise AssertionError(f"f32 disagg differs from the aggregated engine: {same}")
    if not all(r["bit_exact"] for r in pages):
        raise AssertionError(f"shipped pages differ from their pool rows: {pages}")
    if row32["cache"]["hits"] < len(prompts) - 1 or row32["free_staging_pages"] != 511:
        raise AssertionError(f"cache leg: {row32['cache']}, staging pages free "
                             f"{row32['free_staging_pages']}")
    return launches


def profile_step(fn, card: str) -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel group
    (flash kernels, matrix products, the rest), each flash kernel's time, the
    top kernels, and the device's busy and idle share of the host-clock wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms = timed(fn)
    kern = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        # user annotations (Optimizer.step#...) span kernels: not kernels themselves
        if (us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            kern.append((e.key, us / 1e3, e.count))
    kern.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kern)
    groups = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    flash = []
    for name, ms, count in kern:
        low = name.lower()
        grp = ("flash" if "flash_" in low and "kernel" in low else
               "matmul" if any(w in low for w in ("gemm", "nvjet", "cutlass", "sm90_xmma"))
               else "other")
        groups[grp] += ms
        if grp == "flash":
            flash.append([name[:80], ms, count])
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "group_ms": groups, "flash_kernels": flash,
            "top": [[n[:80], ms, c] for n, ms, c in kern[:12]], "card": card}


def grads(params, cfg, batch, attn_impl):
    """(loss, gradients of every leaf) of one forward and backward."""
    import torch

    from ray_tpu_torch.models.llama import llama_loss

    ts = list(leaves(params))
    loss = llama_loss(params, batch, cfg, attn_impl=attn_impl)
    return loss.detach(), torch.autograd.grad(loss, ts)


def phase_train(card: str, kernels, k: dict) -> tuple[dict, list]:
    """make_train_step at Llama-3-8B width cut to 8 layers. Returns the
    kernel launches of the timed steps and every step's loss (the warm-up
    and the timed steps)."""
    import statistics

    import torch

    from ray_tpu_torch.models.llama import AdamW, LlamaConfig, llama_init, make_train_step

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=8)  # remat on, bf16
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    params = llama_init(g, cfg, "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2049), generator=g,
                                     device="cuda")}
    opt = AdamW(1e-4)  # optax.adamw's defaults otherwise, passed explicitly
    state = opt.init(params)

    # one step's gradients, flash kernels against plain attention, same weights
    loss_a, ga = grads(params, cfg, batch, "auto")
    loss_p, gp = grads(params, cfg, batch, "plain")
    num = sum(float(((a.float() - b.float()) ** 2).sum()) for a, b in zip(ga, gp))
    den = sum(float((b.float() ** 2).sum()) for b in gp)
    grad_rel = math.sqrt(num / den)
    # per leaf, as the MoE train phase checks (information here)
    worst, worst_leaf = leaf_rel_l2([n for n, _ in _named_leaves(params)], ga, gp)
    del ga, gp
    emit({"phase": "train_grads", "layers": cfg.n_layers, "dtype": cfg.dtype,
          "loss_auto": float(loss_a), "loss_plain": float(loss_p),
          "grad_rel_l2_vs_plain": grad_rel, "tol": 3e-2,
          "worst_leaf_rel_l2_vs_plain": worst, "worst_leaf": worst_leaf})
    if not (abs(float(loss_a) - float(loss_p)) <= 3e-2 and grad_rel <= 3e-2):
        raise AssertionError(f"bf16 gradients disagree with plain attention: {grad_rel}")

    step = make_train_step(cfg, opt, attn_impl="auto")
    params, state, loss = step(params, state, batch)  # warm-up
    losses, step_ms, per_step = [float(loss)], [], []
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()  # the main path starts here
    for _ in range(TRAIN_STEPS):
        before = kernels.launches()
        (params, state, loss), ms = timed(lambda: step(params, state, batch))
        now = kernels.launches()
        per_step.append({n: now[n] - before[n] for n in kernels.KERNELS})
        losses.append(float(loss))
        step_ms.append(ms)
    launches = dict(kernels.launches())
    peak = torch.cuda.max_memory_allocated()
    want = {n: cfg.n_layers for n in kernels.KERNELS}
    if any(c != want for c in per_step):
        raise AssertionError(f"kernel launches per step {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}")

    tokens = batch["tokens"][:, :-1].numel()
    B, T = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
    H, D = cfg.n_heads, cfg.head_dim
    pairs = T * (T + 1) // 2
    n_dense = tree_numel(params) - params["tok"]["embedding"].numel()
    # forward 2 products, dq 3, dk/dv 4 (two operations each) per kept pair
    attn_ops = cfg.n_layers * 2 * (2 + 3 + 4) * B * H * D * pairs
    bound_ms = (6 * n_dense * tokens + attn_ops) / H100_BF16_FLOPS * 1e3
    med = statistics.median(step_ms)
    flash_ms = cfg.n_layers * (k["flash_attention_fwd"]["ms"]
                               + k["flash_attention_bwd_dq"]["ms"]
                               + k["flash_attention_bwd_dkv"]["ms"])
    profile = profile_step(lambda: step(params, state, batch), card)

    # the cost of the remat names: each is a copy (a custom op may not return
    # its input); per layer q, k, v, the attention output and gate/up
    from ray_tpu_torch.ops.remat import NAME_OP

    shapes = [(B, T, H, D), (B, T, cfg.n_kv_heads, D), (B, T, cfg.n_kv_heads, D),
              (B, T, H, D), (B, T, cfg.d_ff), (B, T, cfg.d_ff)]
    named = [torch.randn(sh, generator=g, device="cuda").to(cfg.torch_dtype) for sh in shapes]
    copy_ms = cfg.n_layers * cuda_ms(lambda: [NAME_OP(x, "attn_qkv") for x in named])
    copy_bytes = cfg.n_layers * 2 * sum(x.numel() * x.element_size() for x in named)
    emit({"phase": "train", "config": "llama3_8b", "layers": cfg.n_layers,
          "dtype": cfg.dtype, "remat": cfg.remat, "tokens": [B, T + 1],
          "losses": losses, "step_ms": step_ms, "step_ms_median": med,
          "step_ms_spread": max(step_ms) - min(step_ms), "tokens_per_s": tokens / med * 1e3,
          "bound_ms": bound_ms, "bound_share": bound_ms / med,
          "max_memory_allocated": peak, "launches_per_step": per_step[0],
          "flash_kernels_ms": flash_ms, "flash_share": flash_ms / med,
          "name_copies_ms": copy_ms, "name_copy_bytes": copy_bytes, "card": card})
    emit({"phase": "train_profile", **profile})
    del params, state, opt, step, batch, loss, named
    torch.cuda.empty_cache()

    # float32, 2 layers at full width: per-leaf gradients against plain attention
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params32 = llama_init(g, cfg32, "cuda")
    for t in leaves(params32):
        t.requires_grad_(True)
    batch32 = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2049), generator=g,
                                       device="cuda")}
    _, ga = grads(params32, cfg32, batch32, "auto")
    _, gp = grads(params32, cfg32, batch32, "plain")
    worst = max(float((a - b).norm() / b.norm()) for a, b in zip(ga, gp))
    emit({"phase": "train_grads_f32", "layers": 2, "worst_leaf_rel_l2_vs_plain": worst,
          "tol": 1e-3})
    if not worst <= 1e-3:
        raise AssertionError(f"f32 gradients disagree with plain attention: {worst}")
    return launches, losses


class Routing:
    """Records what every ``top1_gating`` call routes, or replays a record.

    With random weights a bf16 MoE model routes chaotically: a token whose
    top two gate probabilities tie in bf16 can go to another expert when the
    attention before it changes in its last bits, and at capacity that
    shifts which later tokens are dropped, which moves every later layer.
    So the comparison of the flash kernel with plain attention replays the
    kernel run's routing in the plain run: each call's dispatch and density
    are the recorded ones, combine is dispatch times this run's gate
    probabilities. Runs must make the same calls in the same order (a
    remat backward's recompute included)."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay

    def __enter__(self):
        import torch
        import torch.nn.functional as F

        import ray_tpu_torch.parallel.moe as moe

        self._moe, self._orig = moe, moe.top1_gating
        orig = self._orig

        def gating(logits, n_experts, capacity, **kw):
            dispatch, combine, aux = orig(logits, n_experts, capacity, **kw)
            probs = torch.softmax(logits, dim=-1)
            if self.replay is not None:
                dispatch, density = self.replay.calls[len(self.calls)]
                combine = dispatch * probs[..., None]
                aux = (density * probs.mean(dim=0)).sum() * n_experts
            else:
                density = F.one_hot(probs.argmax(-1), n_experts).float().mean(dim=0)
            self.calls.append((dispatch.detach(), density))
            return dispatch, combine, aux

        moe.top1_gating = gating
        return self

    def __exit__(self, *exc):
        self._moe.top1_gating = self._orig

    def kept(self) -> list:
        """Tokens each call kept."""
        return [float(d.sum()) for d, _ in self.calls]

    def agreement(self, other) -> list:
        """Per call, the share of tokens routed alike (same expert, or
        dropped in both)."""
        out = []
        for (a, _), (b, _) in zip(self.calls, other.calls):
            out.append(float((a.sum(-1) == b.sum(-1)).all(-1).float().mean()))
        return out


class SdpaAsPlain:
    """Runs ``attn_impl="plain"`` through PyTorch's SDPA: a second correct
    attention, to show how far two correct attentions drift apart in a
    random-weight bf16 MoE model, free-running and with routing replayed."""

    def __enter__(self):
        import importlib

        import torch.nn.functional as F

        # the module, which ray_tpu_torch.ops shadows with its function
        att = importlib.import_module("ray_tpu_torch.ops.attention")
        self._att, self._orig = att, att.reference_attention

        def sdpa(q, k, v, *, causal=True, sm_scale=None):
            out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                 v.transpose(1, 2), is_causal=causal,
                                                 scale=sm_scale)
            return out.transpose(1, 2).contiguous()

        att.reference_attention = sdpa
        return self

    def __exit__(self, *exc):
        self._att.reference_attention = self._orig


def phase_moe_forward(card: str, kernels) -> dict:
    """llama3_8b_switch8, 32 layers, bf16. Returns the flash forward's
    launches on the main path, by dtype."""
    import statistics

    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, llama_forward, llama_init

    K = "flash_attention_fwd"
    cfg = LlamaConfig.llama3_8b_switch8()
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    params, init_ms = timed(lambda: llama_init(g, cfg, "cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=g, device="cuda")
    n_tok = tokens.numel()

    with torch.inference_mode():
        llama_forward(params, tokens, cfg)  # warm-up (cuBLAS, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.LAUNCHES.clear()  # the main path starts here
        (logits, aux), main_ms = timed(lambda: llama_forward(params, tokens, cfg))
        launches = dict(kernels.launches())
        by_dtype = {f"{n}:{dt}": c for (n, dt), c in kernels.LAUNCHES.items()}
        peak = torch.cuda.max_memory_allocated()
        if launches.get(K) != cfg.n_layers or len(launches) != 1:
            raise AssertionError(f"kernel launches {launches}, want {cfg.n_layers} of {K}")
        if by_dtype != {f"{K}:bfloat16": 2, f"{K}:float32": cfg.n_layers - 2}:
            raise AssertionError(f"flash launches by dtype {by_dtype}: want layers 0-1 "
                                 "bf16 and the rest float32 after the MoE promotion")
        if logits.dtype != torch.float32 or tuple(logits.shape) != (*tokens.shape,
                                                                   cfg.vocab_size):
            raise AssertionError(f"logits {logits.dtype} {tuple(logits.shape)}")
        if not bool(torch.isfinite(logits).all()) or not (math.isfinite(float(aux))
                                                          and float(aux) > 0):
            raise AssertionError(f"non-finite logits or aux {float(aux)}")
        # the routing of the same forward, recorded apart from the main path
        with Routing() as auto_routes:
            recorded, _ = llama_forward(params, tokens, cfg)
        recorded_err = rel_l2(recorded, logits)
        del recorded
        with Routing() as free_routes:  # plain attention, its own routing
            plain, plain_aux = llama_forward(params, tokens, cfg, attn_impl="plain")
        free_err = rel_l2(logits, plain)
        # a second correct attention, free-running and on its own routing replayed
        with SdpaAsPlain(), Routing() as sdpa_routes:
            sdpa, _ = llama_forward(params, tokens, cfg, attn_impl="plain")
        sdpa_free_err = rel_l2(sdpa, plain)
        del plain
        with Routing(replay=sdpa_routes):
            plain, _ = llama_forward(params, tokens, cfg, attn_impl="plain")
        sdpa_err = rel_l2(sdpa, plain)
        del sdpa, plain
        with Routing(replay=auto_routes):  # plain attention, the kernel run's routing
            plain, forced_aux = llama_forward(params, tokens, cfg, attn_impl="plain")
        err = rel_l2(logits, plain)
        del logits, plain
        fwd_ms = {"auto": [], "plain": []}
        for impl in ("plain", "auto", "auto", "plain", "plain", "auto"):  # in turns
            _, ms = timed(lambda: llama_forward(params, tokens, cfg, attn_impl=impl)[0].sum())
            fwd_ms[impl].append(ms)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    C = max(1, int(cfg.capacity_factor * n_tok / E))
    n_moe = cfg.n_layers // cfg.moe_every
    # float32 products of the MoE layers: the dispatch and combine einsums
    # and the two expert products, 2 operations per multiply-add
    moe_ops = n_moe * (2 * 2 * n_tok * E * C * D + 2 * 2 * E * C * D * F)
    emit({"phase": "moe_forward", "config": "llama3_8b_switch8", "layers": cfg.n_layers,
          "dtype": cfg.dtype, "tokens": list(tokens.shape), "params": tree_numel(params),
          "init_s": init_ms / 1e3, "main_path_ms": main_ms,
          "forward_ms": fwd_ms["auto"], "forward_plain_ms": fwd_ms["plain"],
          "forward_ms_median": statistics.median(fwd_ms["auto"]),
          "forward_plain_ms_median": statistics.median(fwd_ms["plain"]),
          "flash_launches": launches.get(K), "flash_launches_by_dtype": by_dtype,
          "aux": float(aux), "aux_plain_forced_routing": float(forced_aux),
          "aux_plain_free": float(plain_aux), "capacity": C,
          "dropped_share_per_moe_layer": [1 - k / n_tok for k in auto_routes.kept()],
          "logits_dtype": "float32",
          "logits_rel_l2_vs_plain_same_routing": err, "tol": 3e-2,
          "logits_rel_l2_vs_plain_free": free_err,
          "routing_agreement_free_per_moe_layer": auto_routes.agreement(free_routes),
          "logits_rel_l2_recorded_vs_main": recorded_err,
          "sdpa_logits_rel_l2_vs_plain_free": sdpa_free_err,
          "sdpa_logits_rel_l2_vs_plain_same_routing": sdpa_err,
          "sdpa_routing_agreement_free_per_moe_layer": sdpa_routes.agreement(free_routes),
          "max_memory_allocated": peak, "moe_f32_ops": moe_ops,
          "moe_f32_bound_ms": moe_ops / H100_F32_FLOPS * 1e3, "card": card})
    if not err <= 3e-2:
        raise AssertionError(f"bf16 MoE forward disagrees with plain attention: {err}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    params32 = llama_init(g, cfg32, "cuda")
    with torch.inference_mode():
        a, aux_a = llama_forward(params32, tokens, cfg32, attn_impl="auto")
        b, aux_b = llama_forward(params32, tokens, cfg32, attn_impl="plain")
        err32 = rel_l2(a, b)
    emit({"phase": "moe_forward_f32", "layers": 2, "logits_rel_l2_vs_plain": err32,
          "aux": float(aux_a), "aux_plain": float(aux_b), "tol": 1e-4})
    del a, b, params32
    torch.cuda.empty_cache()
    if not err32 <= 1e-4:
        raise AssertionError(f"f32 MoE forward disagrees with plain attention: {err32}")
    return by_dtype


def leaf_rel_l2(names, ga, gp) -> tuple[float, str]:
    """The largest per-leaf relative L2 of ga against gp, and its leaf."""
    worst, worst_leaf = 0.0, None
    for name, a, b in zip(names, ga, gp):
        den = float(b.float().norm())
        rel = float((a.float() - b.float()).norm()) / den if den else float(a.float().norm())
        if rel > worst:
            worst, worst_leaf = rel, name
    return worst, worst_leaf


def phase_moe_train(card: str, kernels) -> tuple[dict, dict]:
    """make_train_step on llama3_8b_switch8 cut to 8 layers. Returns the
    launches of the timed steps and of one step."""
    import statistics

    import torch

    from ray_tpu_torch.models.llama import AdamW, LlamaConfig, llama_init, make_train_step

    cfg = dataclasses.replace(LlamaConfig.llama3_8b_switch8(), n_layers=8)  # remat, bf16
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    params = llama_init(g, cfg, "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2049), generator=g,
                                     device="cuda")}
    opt = AdamW(1e-4)
    state = opt.init(params)

    names = [n for n, _ in _named_leaves(params)]
    with Routing() as routes:
        loss_a, ga = grads(params, cfg, batch, "auto")
    with Routing() as free_routes:
        loss_free, gp = grads(params, cfg, batch, "plain")
    free_worst, free_leaf = leaf_rel_l2(names, ga, gp)
    # a second correct attention (SDPA), free-running and on its own routing replayed
    with SdpaAsPlain(), Routing() as sdpa_routes:
        _, gs = grads(params, cfg, batch, "plain")
    sdpa_free_worst, sdpa_free_leaf = leaf_rel_l2(names, gs, gp)
    del gp
    with Routing(replay=sdpa_routes):
        _, gp = grads(params, cfg, batch, "plain")
    sdpa_worst, sdpa_leaf = leaf_rel_l2(names, gs, gp)
    del gs, gp
    with Routing(replay=routes):
        loss_p, gp = grads(params, cfg, batch, "plain")
    worst, worst_leaf = leaf_rel_l2(names, ga, gp)
    del ga, gp
    emit({"phase": "moe_train_grads", "layers": cfg.n_layers, "dtype": cfg.dtype,
          "loss_auto": float(loss_a), "loss_plain_same_routing": float(loss_p),
          "worst_leaf_rel_l2_vs_plain_same_routing": worst, "worst_leaf": worst_leaf,
          "tol": 3e-2, "loss_plain_free": float(loss_free),
          "worst_leaf_rel_l2_vs_plain_free": free_worst, "worst_leaf_free": free_leaf,
          "routing_agreement_free_per_call": routes.agreement(free_routes),
          "sdpa_worst_leaf_rel_l2_vs_plain_free": sdpa_free_worst,
          "sdpa_worst_leaf_free": sdpa_free_leaf,
          "sdpa_worst_leaf_rel_l2_vs_plain_same_routing": sdpa_worst,
          "sdpa_worst_leaf": sdpa_leaf,
          "sdpa_routing_agreement_free_per_call": sdpa_routes.agreement(free_routes)})
    if not (abs(float(loss_a) - float(loss_p)) <= 3e-2 and worst <= 3e-2):
        raise AssertionError(f"bf16 MoE gradients disagree with plain attention: "
                             f"{worst} at {worst_leaf}")
    del routes, free_routes, sdpa_routes  # the check's dispatch records, off the main path

    step = make_train_step(cfg, opt, attn_impl="auto")
    params, state, loss = step(params, state, batch)  # warm-up
    losses, step_ms, per_step = [float(loss)], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.LAUNCHES.clear()  # the main path starts here
    for _ in range(TRAIN_STEPS):
        before = kernels.launches()
        (params, state, loss), ms = timed(lambda: step(params, state, batch))
        now = kernels.launches()
        per_step.append({n: now[n] - before[n] for n in kernels.KERNELS})
        losses.append(float(loss))
        step_ms.append(ms)
    now = kernels.launches()
    launches = {n: now[n] for n in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = {n: cfg.n_layers for n in kernels.KERNELS}
    if any(c != want for c in per_step):
        raise AssertionError(f"kernel launches per step {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE training losses {losses}")
    med = statistics.median(step_ms)
    tokens = batch["tokens"][:, :-1].numel()
    emit({"phase": "moe_train", "config": "llama3_8b_switch8", "layers": cfg.n_layers,
          "dtype": cfg.dtype, "remat": cfg.remat, "tokens": list(batch["tokens"].shape),
          "params": tree_numel(params), "losses": losses, "step_ms": step_ms,
          "step_ms_median": med, "step_ms_spread": max(step_ms) - min(step_ms),
          "tokens_per_s": tokens / med * 1e3, "max_memory_allocated": peak,
          "launches_per_step": per_step[0], "card": card})
    del params, state, opt, step, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return launches, per_step[0]


def _named_leaves(tree, prefix=""):
    """(``"a/b/0/w"``, leaf) of every leaf of nested dicts and lists."""
    items = enumerate(tree) if isinstance(tree, list) else (
        tree.items() if isinstance(tree, dict) else None)
    if items is None:
        yield prefix, tree
        return
    for k, v in items:
        yield from _named_leaves(v, f"{prefix}/{k}" if prefix else str(k))


def phase_parallel(card: str) -> None:
    """The parallel layer on an NCCL group of world size 1, each entry point
    against its local counterpart at float32."""
    import tempfile

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import (
        LlamaConfig,
        llama_init,
        llama_loss,
        llama_pp_loss,
        stack_pp_params,
    )
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.moe import moe_ffn
    from ray_tpu_torch.parallel.pipeline import pipeline_apply
    from ray_tpu_torch.parallel.ring_attention import reference_attention, ring_attention
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    errs, t0 = {}, time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv", rank=0,
                                world_size=1)
        try:
            mesh = MeshSpec().build()
            backend = str(dist.get_backend())
            with torch.no_grad():
                q, k, v = (randn(2, 2048, 8, 128) for _ in range(3))
                ref = reference_attention(q, k, v)
                errs["ring_attention"] = float((ring_attention(q, k, v, mesh) - ref).abs().max())
                errs["ulysses_attention"] = float(
                    (ulysses_attention(q, k, v, mesh) - ref).abs().max())
                stacked = {"w": randn(1, 512, 512, scale=0.05), "b": randn(1, 512, scale=0.1)}
                x = randn(64, 512)

                def stage_fn(p, h):
                    return torch.tanh(h @ p["w"] + p["b"])

                want = stage_fn({"w": stacked["w"][0], "b": stacked["b"][0]}, x)
                got = pipeline_apply(stage_fn, stacked, x, mesh, n_microbatches=4)
                errs["pipeline_apply"] = float((got - want).abs().max())
                margs = (randn(2, 256, 1024), randn(1024, 8, scale=0.05),
                         randn(8, 1024, 2048, scale=0.02), randn(8, 2048, 1024, scale=0.02))
                (o1, a1), (o2, a2) = moe_ffn(*margs, mesh=mesh), moe_ffn(*margs)
                errs["moe_ffn"] = max(float((o1 - o2).abs().max()), abs(float(a1 - a2)))
                cfg = LlamaConfig(vocab_size=1024, d_model=256, n_layers=2, n_heads=4,
                                  n_kv_heads=4, d_ff=512, max_seq_len=512, dtype="float32",
                                  remat=False)
                params = llama_init(g, cfg, "cuda")
                batch = {"tokens": torch.randint(0, 1024, (4, 257), generator=g,
                                                 device="cuda")}
                pp = llama_pp_loss(stack_pp_params(params, cfg, 1), batch, cfg, mesh,
                                   n_microbatches=2)
                errs["llama_pp_loss"] = abs(float(pp) - float(
                    llama_loss(params, batch, cfg, attn_impl="plain")))
        finally:
            dist.destroy_process_group()
    emit({"phase": "parallel", "world_size": 1, "backend": backend,
          "mesh_shape": list(mesh.shape), "max_abs_err": errs, "tol": 2e-5,
          "seconds": time.perf_counter() - t0, "card": card})
    bad = {n: e for n, e in errs.items() if not e <= 2e-5}
    if bad:
        raise AssertionError(f"parallel entry points differ from their local versions: {bad}")


# ------------------------------------------------------------ the trainer
# The loops below run inside TorchTrainer's worker processes, which import
# this script as a module by name (a loop must be importable).
TRAINER_WARMUP = 3
ATTRIBUTION_STEPS = 20  # trainer: mesh and no-mesh steps, alternating
HYPER = dict(learning_rate=1e-2, b1=0.9, b2=0.99, eps=1e-6, weight_decay=1e-2)
DP2_CFG = dict(vocab_size=32000, d_model=1024, n_layers=2, n_heads=8, n_kv_heads=8, d_ff=2816,
               max_seq_len=2048, dtype="float32")


def _no_tf32():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def trainer_loop(config):
    """The train phase's step in a worker: Llama-3-8B width cut to
    ``layers``, bf16, remat, AdamW lr 1e-4, params placed by
    shard_pytree on the (one-rank) mesh; warm-up and timed steps, the flash
    launches of each step read here, in the worker."""
    import torch

    from ray_tpu_torch import kernels, train
    from ray_tpu_torch.models.llama import AdamW, LlamaConfig, llama_init, make_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import PartitionRules, shard_pytree

    _no_tf32()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=config["layers"])
    g = torch.Generator(device="cuda").manual_seed(config["seed"])
    params = llama_init(g, cfg, "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2049), generator=g,
                                     device="cuda")}
    mesh = MeshSpec().build()
    params = shard_pytree(params, PartitionRules.llama(), mesh)
    opt = AdamW(1e-4)
    state = opt.init(params)
    step = make_train_step(cfg, opt, mesh=mesh)
    losses, step_ms, per_step = [], [], []
    for i in range(TRAINER_WARMUP + config["steps"]):
        if i == TRAINER_WARMUP:  # the timed steps start here
            torch.cuda.reset_peak_memory_stats()
            kernels.LAUNCHES.clear()
        before = kernels.launches()
        (params, state, loss), ms = timed(lambda: step(params, state, batch))
        now = kernels.launches()
        losses.append(float(loss))
        if i >= TRAINER_WARMUP:
            step_ms.append(ms)
            per_step.append({n: now[n] - before[n] for n in kernels.KERNELS})
        if i == 0:
            train.report({"step": 1, "loss": losses[0], "t": time.time()})
    launches = dict(kernels.launches())
    peak = torch.cuda.max_memory_allocated()
    # attribution: the same step on the same local tensors without the
    # mesh, alternating with the mesh step, in one process: each step's
    # host time until it returns (its enqueue) and its wall time
    from ray_tpu_torch.models.llama import _map_tree, _shard_leaf

    local = _map_tree(_shard_leaf, params)
    plain = make_train_step(cfg, opt)
    arms = {"mesh": [], "no_mesh": []}
    enqueue = {"mesh": [], "no_mesh": []}
    for _ in range(ATTRIBUTION_STEPS):
        for arm, fn, p in (("mesh", step, params), ("no_mesh", plain, local)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(p, state, batch)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue[arm].append((t1 - t0) * 1e3)
            arms[arm].append((time.perf_counter() - t0) * 1e3)
    # the collective API on the worker's NCCL group (world size 1): numpy
    # goes through the card and comes back numpy, tensors stay on the card
    import numpy as np

    from ray_tpu_torch import collective

    group = train.get_context().collective_group
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    cx = torch.from_numpy(x).cuda()
    checks = {
        "allreduce": np.array_equal(collective.allreduce(x, group), x),
        "allgather": torch.equal(collective.allgather(cx, group), cx[None]),
        "reducescatter": np.array_equal(collective.reducescatter(x, group), x),
        "broadcast": np.array_equal(collective.broadcast(x, 0, group), x),
        "mean_is_float": collective.allreduce(np.arange(3), group,
                                              collective.ReduceOp.MEAN).dtype.kind == "f",
    }
    train.report({"losses": losses, "step_ms": step_ms, "launches_per_step": per_step,
                  "launches": launches, "max_memory_allocated": peak, "attribution_ms": arms,
                  "attribution_enqueue_ms": enqueue,
                  "collective_nccl": checks, "device": torch.cuda.get_device_name(0)})


def _ckpt_batch(cfg, i):
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 100 + i)
    return {"tokens": torch.randint(0, cfg.vocab_size, (2, 2049), generator=g, device="cuda")}


def checkpoint_loop(config):
    """Steps ``first``..``steps`` at Llama-3-8B width cut to 2 layers (whole
    params), saving params and AdamW state at ``save_at``; from the
    trainer's checkpoint when there is one. Each step's batch is drawn from
    its own seed, so a resumed run sees the same data."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import AdamW, LlamaConfig, llama_init, make_train_step
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.utils.serialization import from_host

    _no_tf32()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    opt = AdamW(1e-4)
    start, load = train.get_checkpoint(), {}
    if start is None:
        params = llama_init(torch.Generator(device="cuda").manual_seed(SEED + 5), cfg, "cuda")
        state = opt.init(params)
        first = 1
    else:
        t0 = time.perf_counter()
        host = start.to_dict()
        params = from_host(host["params"], "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = opt.init(params)
        t2 = time.perf_counter()
        state.load_state_dict(from_host(host["opt"], "cpu"))  # moved to the params' card
        torch.cuda.synchronize()
        load = {"load_s": t1 - t0 + time.perf_counter() - t2,
                "bytes": os.path.getsize(os.path.join(start.path, "state.pkl"))}
        first = host["step"] + 1
    step = make_train_step(cfg, opt)
    for i in range(first, config["steps"] + 1):
        params, state, loss = step(params, state, _ckpt_batch(cfg, i))
        metrics, ckpt = {"step": i, "loss": float(loss), **load}, None
        load = {}
        if i == config.get("save_at"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt = Checkpoint.from_state_dict({"params": params, "opt": state.state_dict(),
                                               "step": i})
            metrics["save_s"] = time.perf_counter() - t0
            metrics["bytes"] = os.path.getsize(os.path.join(ckpt.path, "state.pkl"))
        train.report(metrics, checkpoint=ckpt)


def _dp2_inputs():
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    cfg = LlamaConfig(**DP2_CFG)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    params = llama_init(g, cfg, "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2049), generator=g, device="cuda")}
    return cfg, params, batch


def dp2_loop(config):
    """One AdamW step of the float32 model over MeshSpec(dp=2): two ranks
    on one card, gloo; rank 0 checkpoints the updated params. And a
    collective.allreduce of a numpy array."""
    import numpy as np
    import torch

    from ray_tpu_torch import collective, kernels, train
    from ray_tpu_torch.models.llama import AdamW, make_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.train import Checkpoint

    _no_tf32()
    ctx = train.get_context()
    cfg, params, batch = _dp2_inputs()
    mesh = MeshSpec(dp=2).build()
    opt = AdamW(**HYPER)
    kernels.LAUNCHES.clear()
    params, _, loss = make_train_step(cfg, opt, mesh=mesh)(params, opt.init(params), batch)
    torch.cuda.synchronize()
    total = collective.allreduce(np.array([ctx.get_world_rank() + 1.0]),
                                 group_name=ctx.collective_group)
    metrics = {"loss": float(loss), "allreduce": total.tolist(),
               "launches": dict(kernels.launches())}
    ckpt = Checkpoint.from_dict({"params": params}) if ctx.get_world_rank() == 0 else None
    train.report(metrics, checkpoint=ckpt)


def _fit(loop, config, storage, resume=None, **scaling):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    t0 = time.time()
    result = TorchTrainer(loop, train_loop_config=config,
                          scaling_config=ScalingConfig(use_gpu=True, **scaling),
                          run_config=RunConfig(storage_path=storage),
                          resume_from_checkpoint=resume).fit()
    if result.error is not None:
        raise result.error
    return result, t0


def phase_trainer(card: str, train_losses: list) -> dict:
    """TorchTrainer(num_workers=1), NCCL at world size 1, running the train
    phase's step in its worker on shard_pytree's DTensors. Its losses must
    follow the train phase's step by step (same seed, batch and lr):
    exactly, or within 1e-6 relative; printed which. Returns the worker's
    kernel launches over the timed steps."""
    import statistics
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        result, t0 = _fit(trainer_loop, {"layers": 8, "seed": SEED + 2, "steps": TRAIN_STEPS},
                          tmp, num_workers=1)
    first, final = result.metrics_history[0], result.metrics_history[-1]
    losses, step_ms = final["losses"], final["step_ms"]
    med = statistics.median(step_ms)
    want = {n: 8 for n in final["launches"]}
    pairs = list(zip(losses, train_losses))
    traj_rel = max(abs(a - b) / abs(b) for a, b in pairs)
    arms = {arm: statistics.median(ms) for arm, ms in final["attribution_ms"].items()}
    enqueue = {arm: statistics.median(ms)
               for arm, ms in final["attribution_enqueue_ms"].items()}
    emit({"phase": "trainer", "workers": 1, "backend": "nccl", "layers": 8,
          "params": "shard_pytree (DTensor)", "tokens": [2, 2049], "losses": losses,
          "step_ms": step_ms, "step_ms_median": med,
          "step_ms_spread": max(step_ms) - min(step_ms), "tokens_per_s": 2 * 2048 / med * 1e3,
          "max_memory_allocated": final["max_memory_allocated"],
          "launches_per_step": final["launches_per_step"][0],
          "seconds_fit_to_first_report": first["t"] - t0,
          "step1_loss": first["loss"], "train_phase_step1_loss": train_losses[0],
          "train_phase_losses": train_losses, "steps_compared": len(pairs),
          "trajectory_exact": traj_rel == 0.0, "trajectory_max_rel_diff": traj_rel,
          "trajectory_tol": 1e-6, "attribution_ms_median": arms,
          "attribution_enqueue_ms_median": enqueue, "attribution_ms": final["attribution_ms"],
          "attribution_enqueue_ms": final["attribution_enqueue_ms"],
          "collective_nccl": final["collective_nccl"], "worker_device": final["device"],
          "card": card})
    if not all(final["collective_nccl"].values()):
        raise AssertionError(f"collective ops on NCCL: {final['collective_nccl']}")
    if any(c != want for c in final["launches_per_step"]) or len(want) != 3:
        raise AssertionError(f"trainer kernel launches {final['launches_per_step']}")
    if len(pairs) != len(train_losses) or not traj_rel <= 1e-6:
        raise AssertionError(f"trainer losses {losses} do not follow the train phase's "
                             f"{train_losses}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"trainer losses {losses}")
    return final["launches"]


def phase_trainer_checkpoint(card: str) -> None:
    """Fit 1: 4 steps, params and AdamW state saved at step 2; fit 2 resumes
    from that checkpoint and runs steps 3-4, whose losses must equal fit
    1's (exactly, or within 1e-6 relative; printed which)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        one, _ = _fit(checkpoint_loop, {"steps": 4, "save_at": 2}, os.path.join(tmp, "a"),
                      num_workers=1)
        saved = [m for m in one.metrics_history if "save_s" in m][0]
        two, _ = _fit(checkpoint_loop, {"steps": 4}, os.path.join(tmp, "b"),
                      resume=one.checkpoint, num_workers=1)
    a = {m["step"]: m["loss"] for m in one.metrics_history}
    b = {m["step"]: m["loss"] for m in two.metrics_history}
    loaded = [m for m in two.metrics_history if "load_s" in m]
    rel = max(abs(b[i] - a[i]) / abs(a[i]) for i in (3, 4)) if set(b) == {3, 4} else None
    emit({"phase": "trainer_checkpoint", "layers": 2, "fit1_losses": a, "fit2_losses": b,
          "exact": rel == 0.0, "max_rel_diff": rel, "tol": 1e-6, "bytes": saved["bytes"],
          "save_s": saved["save_s"], "save_gb_per_s": saved["bytes"] / saved["save_s"] / 1e9,
          "load_s": loaded[0]["load_s"] if loaded else None,
          "load_gb_per_s": loaded[0]["bytes"] / loaded[0]["load_s"] / 1e9 if loaded else None,
          "card": card})
    if rel is None or not loaded or not rel <= 1e-6:
        raise AssertionError(f"resumed losses {b} differ from {a}")


def phase_trainer_dp2(card: str) -> None:
    """TorchTrainer(num_workers=2, GPU 0.5 each, gloo): one step at
    MeshSpec(dp=2) against the world-size-1 step on the whole batch here,
    loss within 1e-5 (relative) and every updated leaf within 1e-4; and a
    collective.allreduce of numpy on both ranks."""
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import AdamW, make_train_step

    with tempfile.TemporaryDirectory() as tmp:
        result, t0 = _fit(dp2_loop, {}, tmp, num_workers=2,
                          resources_per_worker={"GPU": 0.5}, collective_backend="gloo")
        seconds = time.time() - t0
        got = result.checkpoint.to_dict()["params"]
    ranks = sorted(result.metrics_history, key=lambda m: m["world_rank"])
    cfg, params, batch = _dp2_inputs()
    opt = AdamW(**HYPER)
    params, _, loss = make_train_step(cfg, opt)(params, opt.init(params), batch)
    want, worst, worst_leaf = float(loss), 0.0, None
    for name, leaf in _named_leaves(params):
        node = got
        for part in name.split("/"):
            node = node[part]
        err = float(np.abs(node - leaf.detach().cpu().numpy()).max())
        if err >= worst:
            worst, worst_leaf = err, name
    loss_rel = max(abs(m["loss"] - want) / abs(want) for m in ranks)
    emit({"phase": "trainer_dp2", "workers": 2, "backend": "gloo", "gpu_per_worker": 0.5,
          "config": DP2_CFG, "tokens": [4, 2049], "loss_ranks": [m["loss"] for m in ranks],
          "loss_world1": want, "loss_rel_diff": loss_rel, "loss_tol": 1e-5,
          "worst_leaf_abs_diff": worst, "worst_leaf": worst_leaf, "leaf_tol": 1e-4,
          "allreduce": [m["allreduce"] for m in ranks],
          "launches_ranks": [m["launches"] for m in ranks], "seconds": seconds, "card": card})
    del params
    torch.cuda.empty_cache()
    if not (loss_rel <= 1e-5 and worst <= 1e-4):
        raise AssertionError(f"dp=2 step differs from world size 1: {loss_rel}, {worst}")
    if any(m["allreduce"] != [3.0] for m in ranks):
        raise AssertionError(f"allreduce gave {[m['allreduce'] for m in ranks]}")
    if any(set(m["launches"].values()) != {cfg.n_layers} for m in ranks):
        raise AssertionError(f"flash launches in the workers {[m['launches'] for m in ranks]}")


def phase_dryrun(card: str) -> None:
    """entry.dryrun_multichip(1) on the card: NCCL at world size 1 for
    configuration A, then the trainer arm's two workers sharing it."""
    from ray_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(1)
    emit({"phase": "dryrun", "n_devices": 1, "seconds": time.perf_counter() - t0,
          "card": card})


# --------------------------------------------------------------------- rllib
# ray_tpu_torch.rllib in process on the card: float32, TF32 off, no flash
# kernel on the path (small MLPs; the launches are read to be 0).
# Card against CPU, each leaf's max |diff| over its max |value|: in float32
# (the drivers' dtype) the loss and every gradient leaf; in float64 every
# updated leaf. Adam normalises each element's step by its own gradient
# history (lr * m / (sqrt(v) + 1e-8)), so an element whose gradient is a
# cancellation far below its leaf's largest carries float32's summation-order
# noise into its step at up to a few percent of lr, so zero-initialised
# biases, whose values are a few steps of lr, can miss 1e-5 in float32
# between two correct devices (the phase prints the float32 reading beside).
# In float64 that noise is ~1e-9 times smaller.
RL_TOL = 1e-5
RL_HIDDEN = 64


def _rl_update_cases():
    """name -> (update, optimizer, weights, target weights or None, batch):
    one update of each algorithm from weights drawn once (JAX-layout numpy
    trees) and a fixed batch at the shape the main path gives it (PPO: the
    1024 samples of an iteration, minibatches=1; IMPALA/APPO: a [64, 4]
    fragment; the rest: a 128-row replay or offline minibatch)."""
    import numpy as np

    from ray_tpu_torch.rllib import appo, core, dqn, impala, learner, offline, sac

    g = core.seeded(SEED + 20, "cpu")
    pol = core.params_to_numpy(core.policy_init(g, 4, 2, RL_HIDDEN, "cpu"))
    q, q_target = (core.params_to_numpy(dqn.q_init(g, 4, 2, RL_HIDDEN, "cpu"))
                   for _ in range(2))
    soft = core.params_to_numpy(sac.sac_init(g, 4, 2, RL_HIDDEN, 0.5, "cpu"))
    soft_target = {k: core.params_to_numpy(sac.sac_init(g, 4, 2, RL_HIDDEN, 0.5, "cpu"))[k]
                   for k in ("q1", "q2")}
    rng = np.random.default_rng(SEED + 21)
    n, T, N = 1024, 64, 4
    ppo_batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, n).astype(np.int32),
                 "logp_old": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
                 "advantages": rng.normal(size=n).astype(np.float32),
                 "returns": rng.normal(size=n).astype(np.float32)}
    vtrace_batch = {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
                    "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
                    "logp": np.log(rng.uniform(0.3, 0.7, (T, N))).astype(np.float32),
                    "rewards": np.ones((T, N), np.float32),
                    "dones": rng.random((T, N)) < 0.05,
                    "last_obs": rng.normal(size=(N, 4)).astype(np.float32)}
    m = 128
    trans = {"obs": rng.normal(size=(m, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, m).astype(np.int32),
             "rewards": (rng.normal(size=m) * 2).astype(np.float32),
             "next_obs": rng.normal(size=(m, 4)).astype(np.float32),
             "dones": (rng.random(m) < 0.1).astype(np.float32)}
    vt = dict(lr=1e-3, gamma=0.99, vf_coeff=0.5, entropy_coeff=0.01, rho_bar=1.0, c_bar=1.0)
    return {
        "ppo": (*learner.make_ppo_update(0.2, 0.5, 0.01, 1e-3, 2, 1), pol, None, ppo_batch),
        "impala": (*impala.make_impala_update(**vt), pol, None, vtrace_batch),
        "appo": (*appo.make_appo_update(**vt, clip=0.3), pol, None, vtrace_batch),
        "dqn": (*dqn.make_dqn_update(1e-3, 0.99), q, q_target,
                {**trans, "weights": rng.uniform(0.2, 1.0, m).astype(np.float32)}),
        "sac": (*sac.make_sac_update(1e-3, 0.99, 0.01, 0.6), soft, soft_target, trans),
        "bc": (*offline.make_bc_update(1e-3), pol, None,
               {"obs": trans["obs"], "actions": trans["actions"]}),
        "cql": (*offline.make_cql_update(1e-3, 0.99, 0.005, 0.6, 1.0), soft, soft_target,
                trans),
    }


def _rl_update(name, case, device, dtype):
    """(module, target, outputs, step): one update of ``case`` on ``device``
    in ``dtype``, and a function that takes another."""
    from ray_tpu_torch.rllib import core, learner

    update, optimizer, weights, target_weights, batch = case
    module = core.params_from_numpy(weights, device).to(dtype)
    target = (None if target_weights is None
              else core.params_from_numpy(target_weights, device).to(dtype))
    opt = optimizer.init(module)
    tb = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in learner.to_tensors(batch, device).items()}
    if name == "ppo":
        def step():
            return update(module, opt, tb, core.seeded(SEED, device))
    elif target is None:
        def step():
            return update(module, opt, tb)
    else:
        def step():
            return update(module, target, opt, tb)
    out = step()
    return module, target, out, step


def _rl_leaf_errors(got, want) -> dict:
    """name -> (max |got - want| over max |want|, |got - want| / |want| in
    L2) of each leaf of two JAX-layout trees."""
    import numpy as np

    out = {}
    for name, g in _named_leaves(got):
        w = _lookup(want, name)
        d = np.asarray(g, np.float64) - w
        out[name] = (float(np.abs(d).max() / max(float(np.abs(w).max()), 1e-30)),
                     float(np.linalg.norm(d) / max(float(np.linalg.norm(w)), 1e-30)))
    return out


def _rl_grad_errors(a, b) -> dict:
    """name -> max |grad_a - grad_b| over max |grad_b| of the gradients the
    last optimizer step of two modules used."""
    out = {}
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        if pa.grad is None and pb.grad is None:  # a head the loss does not use (BC's vf)
            continue
        ga, gb = pa.grad.detach().cpu().double(), pb.grad.detach().cpu().double()
        out[name] = float((ga - gb).abs().max() / max(float(gb.abs().max()), 1e-30))
    return out


def _lookup(tree, name):
    for part in name.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def rl_cartpole(venv, seed: int, steps: int):
    """(observations, rewards and flags as bytes, episodes ended, seconds):
    ``steps`` random-action steps of ``venv`` after ``reset(seed)``."""
    import numpy as np

    obs, _ = venv.reset(seed=seed)
    rng = np.random.default_rng(seed)
    parts, ended = [obs.tobytes()], 0
    t0 = time.perf_counter()
    for _ in range(steps):
        obs, rew, term, trunc, _ = venv.step(rng.integers(0, 2, venv.num_envs))
        parts += [obs.tobytes(), rew.tobytes(), term.tobytes(), trunc.tobytes()]
        ended += int((term | trunc).sum())
    return b"".join(parts), ended, time.perf_counter() - t0


def phase_rllib_parity(card: str) -> None:
    """One update of PPO, IMPALA, APPO, DQN, SAC, BC and CQL on the card
    against the same update on the CPU from the same weights and batch:
    in float32 the loss and every gradient leaf, in float64 every updated
    leaf (target critics too), within RL_TOL (see there); the card's and
    the host CPU's ms per float32 update. The port's CartPole-v1, 2000
    random-action steps of 8 envs, twice from one seed: equal bytes."""
    import statistics

    import torch

    from ray_tpu_torch import kernels
    from ray_tpu_torch.rllib import core, envs

    kernels.LAUNCHES.clear()
    rows = {}
    for name, case in _rl_update_cases().items():
        mod_c, tgt_c, out_c, step_c = _rl_update(name, case, "cuda", torch.float32)
        mod_h, tgt_h, out_h, step_h = _rl_update(name, case, "cpu", torch.float32)
        grads = _rl_grad_errors(mod_c, mod_h)
        f32 = _rl_leaf_errors(core.params_to_numpy(mod_c), core.params_to_numpy(mod_h))
        loss_c = float((out_c if isinstance(out_c, tuple) else (out_c,))[0])
        loss_h = float((out_h if isinstance(out_h, tuple) else (out_h,))[0])
        pairs = [(m, t) for m, t, _, _ in (_rl_update(name, case, dev, torch.float64)
                                            for dev in ("cuda", "cpu"))]
        errs = _rl_leaf_errors(*(core.params_to_numpy(m) for m, _ in pairs))
        if tgt_c is not None:
            errs.update({f"target/{k}": v for k, v in _rl_leaf_errors(
                *(core.params_to_numpy(t) for _, t in pairs)).items()})
        worst = max(errs, key=lambda k: errs[k][0])
        worst_grad = max(grads, key=grads.get)
        worst_f32 = max(f32, key=lambda k: f32[k][0])
        card_ms = cuda_ms(step_c, iters=20, warmup=3)
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            step_h()
            host.append((time.perf_counter() - t0) * 1e3)
        rows[name] = {"loss_cuda": loss_c, "loss_cpu": loss_h,
                      "loss_rel_diff": abs(loss_c - loss_h) / max(abs(loss_h), 1e-30),
                      "grad_max_rel_err": grads[worst_grad], "worst_grad": worst_grad,
                      "f64_leaf_max_rel_err": errs[worst][0], "f64_worst_leaf": worst,
                      "f32_leaf_max_rel_err": f32[worst_f32][0], "f32_worst_leaf": worst_f32,
                      "f32_leaf_rel_l2": max(v[1] for v in f32.values()),
                      "leaves": len(errs), "update_ms_cuda": card_ms,
                      "update_ms_host_cpu": statistics.median(host)}
        if not (rows[name]["loss_rel_diff"] <= RL_TOL and grads[worst_grad] <= RL_TOL
                and errs[worst][0] <= RL_TOL):
            raise AssertionError(f"rllib_parity {name}: {rows[name]}")
        if next(mod_c.parameters()).device.type != "cuda":
            raise AssertionError(f"rllib_parity {name}: the module left the card")
    venv = envs.make_vec("CartPole-v1", 8)
    first, ended, secs = rl_cartpole(venv, SEED, 2000)
    again, ended2, _ = rl_cartpole(venv, SEED, 2000)
    flash = sum(kernels.launches().values())
    emit({"phase": "rllib_parity", "tol": RL_TOL, "hidden": RL_HIDDEN, "updates": rows,
          "cartpole": {"envs": 8, "steps": 2000, "episodes_ended": ended,
                       "host_env_steps_per_s": 8 * 2000 / secs, "reseed_equal": first == again},
          "flash_launches": flash, "tf32": torch.backends.cuda.matmul.allow_tf32,
          "card": card})
    if first != again or ended != ended2 or ended < 100:
        raise AssertionError(f"CartPole copy is not deterministic ({ended}, {ended2})")
    if flash:
        raise AssertionError(f"rllib_parity launched flash kernels: {kernels.launches()}")


def rl_instrument(algo) -> dict:
    """Record the host ms of each runner's ``sample`` (it ends in a copy to
    the host, so the device work is inside); the caller times ``train()``
    around it. Wraps instance attributes only."""
    times = {"sample_ms": []}

    def wrap(fn):
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times["sample_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        return inner

    for r in algo.runners:
        r.sample = wrap(r.sample)
    return times


def rl_curve(algo, iters: int, steps_per_sample: int) -> dict:
    """``iters`` train() calls: per iteration the mean return, the sample
    ms, the rest of train() (updates, replay, weight copies) as update ms,
    and the env steps per second of sampling."""
    import numpy as np
    import torch

    times = rl_instrument(algo)
    rets, sample_ms, update_ms, rates = [], [], [], []
    for _ in range(iters):
        n0 = len(times["sample_ms"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ret = algo.train()["episode_return_mean"]
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        s = sum(times["sample_ms"][n0:])
        rets.append(ret)
        sample_ms.append(s)
        update_ms.append(total - s)
        rates.append(steps_per_sample * (len(times["sample_ms"]) - n0) / s * 1e3)
    finite = [r for r in rets if not np.isnan(r)]
    return {"returns": rets, "first": finite[0] if finite else None,
            "best": max(finite) if finite else 0.0, "sample_ms": sample_ms,
            "update_ms": update_ms, "env_steps_per_s": rates,
            "device": next(algo.get_weights().parameters()).device.type}


def phase_rllib_ppo(card: str) -> dict:
    """PPO on the port's CartPole-v1 at test_ppo_learns_cartpole's settings
    (2 runners x 4 envs x 128 steps, lr 1e-3, 4 epochs x 4 minibatches,
    hidden 64), 8 iterations on the card: best > max(60, 1.5 x first),
    params on cuda, no flash launch."""
    from ray_tpu_torch import kernels
    from ray_tpu_torch.rllib import PPOConfig

    kernels.LAUNCHES.clear()
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=128)
            .training(lr=1e-3, minibatches=4, epochs=4, hidden=64).build())
    run = rl_curve(algo, 8, 4 * 128)
    flash = dict(kernels.launches())
    emit({"phase": "rllib_ppo", "iterations": 8, **run, "flash_launches": flash,
          "bar": "best > max(60, 1.5 x first)", "card": card})
    if run["device"] != "cuda" or sum(flash.values()):
        raise AssertionError(f"rllib_ppo ran on {run['device']}, flash {flash}")
    if run["first"] is None or not run["best"] > max(60.0, 1.5 * run["first"]):
        raise AssertionError(f"PPO did not learn: first {run['first']}, best {run['best']}")
    return flash


class TwoAgentTag:
    """The two-agent env of test_multi_agent_env_runner_learns_per_policy:
    each agent sees [own_state, other_state] and is rewarded for matching
    (agent a) / mismatching (agent b) the other's last action."""

    agents = ["a", "b"]

    def reset(self, seed=None):
        import numpy as np

        self._state = np.random.default_rng(seed).integers(0, 2, size=2).astype(np.float32)
        self._t = 0
        return self._obs()

    def _obs(self):
        import numpy as np

        s = self._state
        return {"a": np.array([s[0], s[1]], np.float32), "b": np.array([s[1], s[0]], np.float32)}

    def step(self, action_dict):
        import numpy as np

        self._t += 1
        a, b = action_dict["a"], action_dict["b"]
        rew = {"a": 1.0 if a == int(self._state[1]) else 0.0,
               "b": 1.0 if b != int(self._state[0]) else 0.0}
        self._state = np.array([a, b], np.float32)
        return self._obs(), rew, {"a": False, "b": False, "__all__": self._t >= 16}, \
            {"__all__": False}, {}

    def observation_space_shape(self, agent_id):
        return (2,)

    def n_actions(self, agent_id):
        return 2


def rl_multi_agent() -> dict:
    """The two-agent runners of test_multi_agent_env_runner_learns_per_policy
    on the card: 2 runners, one policy per agent, 12 iterations of 64 steps
    and per-policy PPO updates (lr 5e-3, 4 epochs x 2 minibatches)."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib import MultiAgentEnvRunner, compute_gae, core, make_ppo_update
    from ray_tpu_torch.rllib.learner import to_tensors

    runners = [MultiAgentEnvRunner(TwoAgentTag, policy_mapping_fn=lambda aid: aid, seed=i)
               for i in range(2)]
    spaces = runners[0].spaces()
    params = {pid: core.policy_init(core.seeded(i, "cpu"), *spaces[pid], hidden=32)
              for i, pid in enumerate(sorted(spaces))}
    update, opt = make_ppo_update(clip=0.2, vf_coeff=0.5, entropy_coeff=0.01, lr=5e-3,
                                  epochs=4, minibatches=2)
    states = {pid: opt.init(p) for pid, p in params.items()}
    first, last, sample_ms, update_ms = {}, {}, [], []
    for it in range(12):
        for r in runners:
            r.set_weights(params)
        t0 = time.perf_counter()
        rollouts = [r.sample(64) for r in runners]
        t1 = time.perf_counter()
        for pid in params:
            batches = [compute_gae(ro[pid], 0.99, 0.95) for ro in rollouts]
            batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
            update(params[pid], states[pid], to_tensors(batch, "cuda"), core.seeded(it, "cuda"))
        torch.cuda.synchronize()
        sample_ms.append((t1 - t0) * 1e3)
        update_ms.append((time.perf_counter() - t1) * 1e3)
        metrics = [r.episode_metrics() for r in runners]
        for agent in ("a", "b"):
            vals = [m[agent]["episode_return_mean"] for m in metrics if agent in m]
            if vals:
                first.setdefault(agent, float(np.mean(vals)))
                last[agent] = float(np.mean(vals))
    return {"first": first, "last": last, "sample_ms": sample_ms, "update_ms": update_ms,
            "device": next(params["a"].parameters()).device.type,
            "passed": all(last.get(a, 0.0) > max(first.get(a, 0.0) + 2.0, 12.0)
                          for a in ("a", "b"))}


def phase_rllib_offpolicy(card: str) -> dict:
    """DQN (14 iterations), IMPALA and APPO (10), SAC (12) at their JAX
    tests' settings on the port's CartPole-v1 on the card, each held to its
    test's bar; then the two-agent runner (12 iterations)."""
    from ray_tpu_torch import kernels
    from ray_tpu_torch.rllib import APPOConfig, DQNConfig, IMPALAConfig, SACConfig

    kernels.LAUNCHES.clear()
    runners = dict(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=64)
    algos = {
        "dqn": (lambda: DQNConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                             rollout_fragment_length=128)
                .training(lr=2e-3, batch_size=128, train_batches_per_iter=64,
                          target_update_freq=100, epsilon_decay_iters=6,
                          learning_starts=500, prioritized=True, hidden=64), 14, 8 * 128,
                lambda first, best: best > 60.0),
        "impala": (lambda: IMPALAConfig().environment("CartPole-v1").env_runners(**runners)
                   .training(lr=1e-3, batches_per_iter=8, entropy_coeff=0.01), 10, 4 * 64,
                   None),
        "appo": (lambda: APPOConfig().environment("CartPole-v1").env_runners(**runners)
                 .training(clip=0.3, lr=1e-3, batches_per_iter=8, entropy_coeff=0.01), 10,
                 4 * 64, None),
        "sac": (lambda: SACConfig().environment("CartPole-v1").env_runners(**runners)
                .training(lr=2e-3, batch_size=128, learning_starts=400,
                          train_batches_per_iter=24, tau=0.02, target_entropy=0.25,
                          initial_alpha=0.3), 12, 4 * 64, None),
    }
    out, failed = {}, []
    for name, (config, iters, steps, bar) in algos.items():
        run = rl_curve(config().build(), iters, steps)
        bar = bar or (lambda first, best: best > max(60.0, 1.5 * first))
        run["passed"] = run["first"] is not None and bar(run["first"], run["best"])
        out[name] = run
        if not run["passed"] or run["device"] != "cuda":
            failed.append(name)
    out["multi_agent"] = rl_multi_agent()
    if not out["multi_agent"]["passed"] or out["multi_agent"]["device"] != "cuda":
        failed.append("multi_agent")
    flash = dict(kernels.launches())
    emit({"phase": "rllib_offpolicy", **out, "flash_launches": flash, "card": card})
    if failed or sum(flash.values()):
        raise AssertionError(f"rllib_offpolicy: {failed} missed their bars; flash {flash}")
    return flash


def phase_rllib_offline(card: str) -> dict:
    """collect_rollouts of a fixed policy on the card -> OfflineData -> BC
    (agreement with the expert's greedy actions > 0.8) and CQL on
    action-0-only data (Q prefers the logged action on > 0.9 of states),
    as test_offline_roundtrip_and_bc_clones_expert and
    test_cql_penalty_suppresses_unlogged_actions."""
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch import kernels
    from ray_tpu_torch.rllib import BCConfig, CQLConfig, OfflineData, collect_rollouts, core
    from ray_tpu_torch.rllib import write_rollouts

    kernels.LAUNCHES.clear()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "exp", "rollouts.jsonl")
        expert = core.policy_init(core.seeded(7, "cpu"), 4, 2, hidden=32)
        t0 = time.perf_counter()
        n = collect_rollouts("CartPole-v1", path, num_steps=384, num_envs=2, seed=0,
                             policy_params=expert, hidden=32)
        collect_s = time.perf_counter() - t0
        data = OfflineData(path)
        bc = BCConfig().offline_data(path).training(lr=3e-3, batch_size=128,
                                                    updates_per_iter=80, hidden=32).build()
        bc_ms = []
        for _ in range(4):
            result = bc.train()
            bc_ms.append(result["time_this_iter_s"] * 1e3)
        obs = torch.as_tensor(data.table["obs"][:256], dtype=torch.float32, device="cuda")
        with torch.no_grad():
            agree = float((core.policy_logits(expert, obs).argmax(-1)
                           == core.policy_logits(bc.get_weights(), obs).argmax(-1)).float().mean())
        rng = np.random.default_rng(0)
        cobs = rng.normal(size=(512, 4)).astype(np.float32)
        write_rollouts(os.path.join(tmp, "d.jsonl"), [{
            "obs": cobs, "actions": np.zeros(512, np.int64), "rewards": np.ones(512, np.float32),
            "dones": np.zeros(512, np.float32),
            "next_obs": rng.normal(size=(512, 4)).astype(np.float32)}])
        cql = CQLConfig().offline_data(os.path.join(tmp, "d.jsonl")).training(
            lr=3e-3, cql_alpha=5.0, batch_size=128, updates_per_iter=60, hidden=32,
            n_actions=2).build()
        cql_ms = []
        for _ in range(3):
            cresult = cql.train()
            cql_ms.append(cresult["time_this_iter_s"] * 1e3)
        with torch.no_grad():
            q1 = cql.get_weights()["q1"](torch.as_tensor(cobs[:128], device="cuda")).cpu().numpy()
        prefer = float((q1[:, 0] > q1[:, 1]).mean())
    flash = dict(kernels.launches())
    emit({"phase": "rllib_offline", "transitions": n, "collect_s": collect_s,
          "bc_loss": result["loss"], "bc_agreement": agree, "bc_iter_ms": bc_ms,
          "bc_update_ms": [t / 80 for t in bc_ms], "cql_penalty": cresult["cql_penalty"],
          "cql_prefers_logged": prefer, "cql_iter_ms": cql_ms,
          "cql_update_ms": [t / 60 for t in cql_ms],
          "device": next(bc.get_weights().parameters()).device.type,
          "flash_launches": flash, "card": card})
    if not (n >= 384 and result["loss"] < 0.6 and agree > 0.8):
        raise AssertionError(f"BC: {n} transitions, loss {result['loss']}, agreement {agree}")
    if not (cresult["cql_penalty"] < 0.35 and prefer > 0.9):
        raise AssertionError(f"CQL: penalty {cresult['cql_penalty']}, prefers {prefer}")
    if sum(flash.values()):
        raise AssertionError(f"rllib_offline launched flash kernels: {flash}")
    return flash


RL_LEARNER = {"obs_dim": 4, "n_actions": 2, "hidden": 64, "lr": 1e-3, "epochs": 4,
              "minibatches": 4, "seed": SEED + 22, "collective_backend": "gloo"}


def _rl_learner_rollout():
    import numpy as np

    rng = np.random.default_rng(SEED + 23)
    T, N = 128, 4
    return {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
            "logp": np.full((T, N), np.log(0.5), np.float32),
            "values": rng.normal(size=(T, N)).astype(np.float32),
            "rewards": np.ones((T, N), np.float32), "dones": rng.random((T, N)) < 0.05,
            "last_value": np.zeros(N, np.float32)}


def _rl_learner_state(ln) -> dict:
    out = {}
    for name, p in ln.module.named_parameters():
        st = ln.opt.state[p]
        out[f"param/{name}"] = p.detach().cpu().numpy()
        out[f"exp_avg/{name}"] = st["exp_avg"].cpu().numpy()
        out[f"exp_avg_sq/{name}"] = st["exp_avg_sq"].cpu().numpy()
        out[f"step/{name}"] = st["step"].cpu().numpy()
    return out


def rl_learner_rank(rank: int, work: str) -> None:
    """One of the rllib_learners phase's two ranks (run by
    ``python -c "import chip_smoke; chip_smoke.rl_learner_rank(r, dir)"``):
    a Learner on the card in a gloo group of 2; rank 0 updates on the
    rollout, rank 1 on an empty shard; writes its state to
    ``<work>/out_<rank>.npz``."""
    import numpy as np

    from ray_tpu_torch.rllib import Learner

    _no_tf32()
    config = dict(RL_LEARNER, device="cuda", init_method=f"file://{work}/rdzv")
    ln = Learner(rank, 2, config, group_name="rl_learners")
    result = ln.update([_rl_learner_rollout()] if rank == 0 else [])
    np.savez(os.path.join(work, f"out_{rank}.npz"), samples=result["samples"],
             device=next(ln.module.parameters()).device.type, **_rl_learner_state(ln))


def phase_rllib_learners(card: str) -> None:
    """Two Learner ranks in two processes sharing the card over gloo (NCCL
    refuses two ranks on one card); rank 1 has an empty shard. After the
    sync both hold equal params and Adam moments, equal to the mean of one
    local update and the initial state computed here (1e-6), and their
    step counts differ (16 and 0)."""
    import tempfile

    import numpy as np

    from ray_tpu_torch.rllib import Learner

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.rl_learner_rank({r}, {work!r})"],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
        try:
            logs = [p.communicate(timeout=240)[0].decode(errors="replace")[-3000:]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"rllib_learners ranks failed: {logs}")
        outs = [dict(np.load(os.path.join(work, f"out_{r}.npz"))) for r in range(2)]
    config = dict(RL_LEARNER, device="cuda")
    idle, moved = Learner(0, 1, config), Learner(0, 1, config)
    moved.update([_rl_learner_rollout()])
    want0, want1 = _rl_learner_state(idle), _rl_learner_state(moved)
    unequal, worst, steps = [], 0.0, {}
    for k in want0:
        kind = k.split("/")[0]
        if kind == "step":
            steps[k] = (float(outs[0][k]), float(outs[1][k]))
            continue
        if not np.array_equal(outs[0][k], outs[1][k]):
            unequal.append(k)
        worst = max(worst, float(np.abs(outs[0][k] - (want0[k] + want1[k]) / 2).max()))
    emit({"phase": "rllib_learners", "ranks": 2, "backend": "gloo",
          "samples": [int(o["samples"]) for o in outs], "devices": [str(o["device"]) for o in outs],
          "unequal_leaves": unequal, "max_abs_diff_from_mean": worst, "tol": 1e-6,
          "steps": sorted(set(steps.values())), "seconds": seconds, "card": card})
    if unequal or not worst <= 1e-6:
        raise AssertionError(f"learner sync: unequal {unequal}, diff from the mean {worst}")
    if set(steps.values()) != {(16.0, 0.0)} or any(str(o["device"]) != "cuda" for o in outs):
        raise AssertionError(f"learner steps {set(steps.values())}, devices "
                             f"{[o['device'] for o in outs]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ray_tpu_torch")):
        print("chip_smoke: the ray_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from ray_tpu_torch import kernels
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    t0 = time.perf_counter()
    secs = kernels.build()
    emit({"phase": "build", "nvcc_seconds": secs, "seconds": time.perf_counter() - t0,
          "ptxas": {name: kernels.build_report(name) for name in kernels.KERNELS}})

    k = {"flash_attention_fwd": phase_kernels(card), **phase_backward_kernels(card)}

    cfg = LlamaConfig.llama3_8b()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params, init_ms = timed(lambda: llama_init(g, cfg, "cuda"))
    emit({"phase": "init", "config": "llama3_8b", "seconds": init_ms / 1e3,
          "params": tree_numel(params)})
    tokens = torch.randint(0, cfg.vocab_size, (2, 2049), generator=g, device="cuda")
    launches, cfg32, params32 = phase_forward(card, kernels, cfg, params, tokens)
    serve_launches, prompts, planned, planned_ttft, ref32 = phase_serving(
        card, kernels, cfg, params, cfg32, params32)
    phase_serving_int8(card, cfg, params, cfg32, params32, prompts, planned, ref32)
    phase_serving_spec(card, cfg, params, cfg32, params32, prompts)
    phase_serving_adopt(card, cfg, params, cfg32, params32, prompts)
    layer_launches = phase_serving_server(card, kernels, cfg, params, cfg32, params32,
                                          prompts, ref32)
    disagg_launches = phase_serving_disagg(card, kernels, cfg, params, cfg32, params32,
                                           prompts, ref32, planned_ttft)
    del params, params32, tokens
    # LLMServer (its batch queue holds its bound method) and PrefillWorker
    # sit in reference cycles that hold the weights until a collection
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_losses = phase_train(card, kernels, k)
    gc.collect()
    torch.cuda.empty_cache()
    moe_fwd_launches = phase_moe_forward(card, kernels)
    moe_train_launches, moe_step_launches = phase_moe_train(card, kernels)
    phase_parallel(card)
    gc.collect()
    torch.cuda.empty_cache()
    # the trainer's worker processes take the card from here
    trainer_launches = phase_trainer(card, train_losses)
    phase_trainer_checkpoint(card)
    phase_trainer_dp2(card)
    phase_dryrun(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_rllib_parity(card)
    rl_launches = collections.Counter()
    rl_launches.update(phase_rllib_ppo(card))
    rl_launches.update(phase_rllib_offpolicy(card))
    rl_launches.update(phase_rllib_offline(card))
    phase_rllib_learners(card)

    replaces = {"flash_attention_fwd": "ray_tpu/ops/flash_attention.py:49",
                "flash_attention_bwd_dq": "ray_tpu/ops/flash_attention.py:144",
                "flash_attention_bwd_dkv": "ray_tpu/ops/flash_attention.py:191"}
    rows = []
    for name in kernels.KERNELS:
        row = {"name": name, "route": "cuda", "source": f"ray_tpu_torch/csrc/{name}.cu",
               "replaces": replaces[name],
               # the forward's main path is the forward phase; the backward's, training
               "launches": launches if name == "flash_attention_fwd" else train_launches[name],
               "train_launches": train_launches[name],
               "trainer_launches": trainer_launches[name],
               "serving_launches": serve_launches.get(name, 0),
               "serving_layer_launches": layer_launches.get(name, 0)
               + disagg_launches.get(name, 0),
               "moe_forward_launches": sum(c for key, c in moe_fwd_launches.items()
                                           if key.startswith(name + ":")),
               "moe_forward_launches_by_dtype": {
                   key.split(":")[1]: c for key, c in moe_fwd_launches.items()
                   if key.startswith(name + ":")},
               "moe_train_launches": moe_train_launches[name],
               "moe_train_launches_per_step": moe_step_launches[name],
               "rllib_launches": rl_launches[name], **k[name]}
        if name != "flash_attention_fwd":
            row["plain_and_library_cover"] = "dq+dkv"
        rows.append(row)
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
