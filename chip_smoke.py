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
   dag_pipeline — compiled graphs (ray_tpu_torch.dag) on the port's runtime:
              two stage actors sharing the card (num_gpus=0.5 each) draw
              that model's seed-0 weights and keep their halves (stage 0 the
              embedding and layers 0-15, stage 1 layers 16-31, the norm and
              the head); InputNode -> stage0.forward -> stage1.forward,
              compiled with 64 MiB channels, takes the tokens [2, 2048] and
              passes the bf16 hidden state [2, 2048, 4096] (32 MiB) between
              the stages to float32 logits [2, 128256] at the last position.
              Each stage must launch the flash forward 16 times per execute
              (counted in the stage from 0), the logits must agree with the
              driver's llama_forward within 1e-6 relative L2 (the same ops
              on the same weights; printed: the forward phase's bound 3e-2
              and whether bitwise), and a CollectiveNode (allreduce_bind
              over a float32 CUDA tensor in a gloo group met through the
              GCS KV) must give the sum on both stages. Printed: ms per
              iteration over 4 executes with overlap on and off and through
              a chain of .remote calls; each stage's period, input wait,
              compute and forward from its loop's timeline; the hidden
              state's hop (stage 0's write + stage 1's read, sequential
              run) in ms and GB/s; the stages' and the card's memory; the
              phase's seconds, by part.
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
              generate call per temperature. At 2 layers, float32, __call__,
              stream, stream_deltas and LLMServer must give the engine's or
              generate's tokens exactly. (The processor: phase 18.)
   serving_disagg — PrefillWorker -> KV-page manifest -> DecodeWorker for the
              6 prompts, then again through the prefix cache (export_pages of
              live requests, insert, lookup, a suffix prefill, adoption of
              prefix + suffix); at 2 layers, float32, both legs must give the
              aggregated engine's tokens, and every shipped page and adopted
              stack must equal its pool rows bit for bit (native, bf16 and
              int8 pools; the bf16 native pool at 32 layers too). The plane
              seals pages into the port's runtime's shm arena: the phase
              starts the runtime and shuts it down.
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
              then one warm-up step and MOE_TRAIN_STEPS (5) timed steps
              launching 8/8/8 kernels each, the loss finite and falling.
8. parallel — one NCCL process group of world size 1 in this process (file
              rendezvous in a temp dir) and its DeviceMesh: ring_attention,
              ulysses_attention, pipeline_apply, moe_ffn (ep=1) and
              llama_pp_loss (pp=1) each equal their local counterpart on the
              card within 2e-5 at float32; the group is destroyed.
9. runtime  — the port's task/actor runtime (ray_tpu_torch.init with an
              8 GiB shm arena, idle leases returned after 1 s):
              cluster_resources() reports GPU 1.0; a 256 MiB bf16 tensor on
              the card and a 256 MiB float32 CPU tensor each go through put/get,
              into a num_gpus=1 actor as a task argument (restored on its
              card, or on its host) and back out of it as a return, bytes
              equal each time, with put, get, argument and round-trip GB/s
              (host clock, once each) and the actor's start and first-tensor
              seconds; then a num_gpus=1 task sees CUDA_VISIBLE_DEVICES "0"
              and the card's name; no worker loads jax or ray_tpu. The
              runtime stays up for phases 10-18 (tune_trainer and workflow
              included), and is shut down after them.
10. sharded — the sharded object plane on that runtime: the Llama-3-8B
              embedding [128256, 4096] bf16 on the card, put_sharded by
              PartitionRules.llama() at tok/embedding on MeshSpec(fsdp=2,
              tp=4) (8 shards of [64128, 1024]); a num_gpus=1 shard wave
              (x2) twice, a reshard to (None, "tp") and back, get_sharded
              on the card: bytes equal to the whole tensor's x2; driver
              bytes against shard bytes, put/get/reshard GB/s and the
              waves' seconds; 0 flash launches.
11. serve_run — serve.run on that runtime, replicas of num_gpus=1 that
              make their own seed-0 weights on the card: at 2 layers,
              float32, full width, 8 concurrent greedy requests through a
              handle give the in-process LLMServer's tokens; at 32 layers,
              bf16, serving_server's 8 LLMServer requests through a handle
              (tokens/s and latencies beside the in-process ones), then
              build_llm_engine_deployment answers stream_deltas (TTFT
              beside the in-process engine's); serve.status() shows each
              replica RUNNING with GPU 1, its worker sees
              CUDA_VISIBLE_DEVICES "0", loads neither jax nor ray_tpu and
              launches no flash kernel. Serve is shut down after it.
12. serve_disagg — build_disagg_deployment through serve.run on that
              runtime: one replica (no card of its own) fronting one prefill
              and two decode workers, actors leasing a third of the card
              each and drawing their own seed-0 weights there; KV pages move
              between them as refs into the shm arena. At 2 layers, float32,
              full width, the 6 serving prompts through a handle and through
              handle.stream give the in-process aggregated engine's tokens
              exactly. At 32 layers, bf16: the 6 prompts and 8 prompts
              sharing a 256-token prefix, concurrently with prefix_hint
              routing: TTFT, tokens/s, ship and adopt GB/s; each completion
              in range, 0 duplicate prefills, a cache hit on over half of
              the shared-prefix requests, kv_array_bytes > 50 x
              kv_driver_bytes; each pool worker sees CUDA_VISIBLE_DEVICES
              "0", holds its weights on cuda:0 and loads neither jax nor
              ray_tpu. Serve is shut down after it.
13. trainer — TorchTrainer(num_workers=1), NCCL at world size 1: the train
              phase's step (8 layers, B=2, T=2048, bf16, remat, AdamW 1e-4)
              in a TrainWorker actor of the runtime, its card pinned by the
              placement group's lease, params placed by shard_pytree on the
              one-rank mesh; 3 warm-up and TRAIN_STEPS (20) timed steps,
              8/8/8 launches each read in the actor, its 21 losses equal to
              the train phase's (within 1e-6 relative; printed whether
              exactly), the loss finite and falling; the seconds from fit()
              to the first report.
14. trainer_checkpoint — 2 layers at full width: fit 1 runs 4 steps and
              saves params and AdamW state at step 2 (Checkpoint.
              from_state_dict), fit 2 resumes from it and runs steps 3-4,
              whose losses must equal fit 1's within 1e-6 relative (printed:
              whether exactly); the bytes and the save and load GB/s.
15. trainer_dp2 — two worker actors sharing the card (GPU 0.5 each, gloo)
              take one float32 step at MeshSpec(dp=2) (d_model 1024, 2 layers, B=4,
              T=2048, so the float32 kernels run in both); loss within 1e-5
              (relative) and every updated leaf within 1e-4 of the one-
              process step on the whole batch, and a collective.allreduce of
              numpy giving the sum on both ranks.
16. dryrun  — ray_tpu_torch.entry.dryrun_multichip(1): NCCL at world size 1,
              then the trainer arm's two workers and the sharded arm.
              Every TorchTrainer group (phases 13-17 and tune_trainer) meets
              through the runtime's GCS KV (rank 0 publishes its store's
              address).
17. data_trainer — ray_tpu_torch.data feeding TorchTrainer(num_workers=1),
              NCCL: a from_numpy dataset of the train phase's token rows
              [2, 2049] (int64) repeated 21 times (42 rows in 7 blocks),
              streaming_split(1)[0] in train_loop_config, the worker's loop
              pulling iter_batches(batch_size=2) and running the train
              phase's step (8 layers, bf16, remat, AdamW 1e-4, weights from
              its seed) on each: its 21 losses equal the train phase's
              (within 1e-6 relative), 8/8/8 launches a step read in the
              worker; rows received, batch bytes, step ms, the wait for each
              batch, seconds from fit() to the first report and the
              rendezvous's seconds.
   tune_trainer — ray_tpu_torch.tune: Tuner over a TorchTrainer of the
              trainer phase's step (8 layers, bf16, remat) with
              param_space {"train_loop_config": {"lr": grid_search([1e-4,
              3e-4])}}, max_concurrent_trials=2: each trial an actor
              holding no card (CPU 0.5) whose fit() runs one worker leasing
              GPU 0.5, so both trials' workers share the card; 2 warm-up
              and 4 timed steps each, the workers checking in before their
              timed steps. Both trials TERMINATED, 8/8/8 launches every
              timed step read in each worker, equal step-1 losses, the 1e-4
              trial's losses equal to the train phase's (within 1e-6
              relative), the 3e-4 trial's later losses different,
              get_best_result() the trial with the lower final loss, the
              timed windows overlapping (the workers' stamps). Printed: each
              trial's step median, fit() to its first step, peak memory, and
              the card's least free memory while both stepped.
   workflow — ray_tpu_torch.workflow on that runtime: make_tokens (host
              CPU: the forward phase's token rows) -> score (leases the
              card: its task worker draws the seed-0 Llama-3-8B weights and
              runs the 32-layer bf16 llama_forward on [2, 2048], returning
              the last position's logits as a CUDA tensor) -> summarize
              (argmax and a checksum on the host, leasing a tenth of the
              card to read that tensor). score must launch the flash
              forward 32 times, counted in its task; the logits must be
              within 1e-6 relative L2 of the forward phase's last position;
              resume() must return the same output from the checkpoints
              (the CUDA tensor kept as host bytes, restored on the card)
              running no step and launching nothing; a second workflow
              whose score's first worker dies (max_retries=1) must give
              the same output.
18. data_batch — build_llm_processor(cfg, params=None, batch_size=8) as the
              data executor's map tasks on the runtime's task workers, each
              drawing its own seed-0 weights on the card: at 2 layers,
              float32, full width, 8 equal-length prompts (one block): every
              row's completion_tokens equal the driver's generate with the
              same init; at 32 layers, bf16, those prompts 3 times (24
              rows, 3 blocks of 8): rows, tokens/s, seconds to the first
              block, the task workers' pids; then the same map as a
              callable class on ActorPoolStrategy(size=1): its tokens equal
              the task run's, one pid on every row. Each task and the
              actor lease the card (num_gpus=1), so one holds weights at a
              time. Every block: 8 rows from one generate call over them,
              in one process, and 0 flash launches, counted in its task
              from 0. The card's free memory before and after. The
              runtime is shut down after it.
   job_cli — the operator's path, with no runtime of the script's own:
              `python -m ray_tpu_torch start --head --num-cpus 8` (no
              --num-gpus: the raylet counts the card) under a fresh TMPDIR,
              `status` showing GPU 1/1 and accelerator_type:H100, the
              `dashboard` command on a free port, and a job sent through
              JobSubmissionClient over its REST API: the job's driver joins
              through RT_ADDRESS and runs job_cli_score as a num_gpus=1
              task (the seed-0 weights drawn in it, the 32-layer bf16
              llama_forward of the forward phase's tokens, the last
              position's logits back as host numpy). The job SUCCEEDED,
              32 flash forward launches counted in the task, its logits
              within 1e-6 relative L2 of the forward phase's, no CUDA in
              the driver; read back through `job list`, `list actors`
              (its supervisor), the job's logs over REST, /api/tasks,
              /api/timeline and /metrics; a sleeping job stopped over REST
              ends STOPPED; `stop` leaves none of the session's processes
              and the card's free memory within 1 GiB of its reading
              before `start`. Printed: each step's seconds, the free-memory
              readings, the task's weight draw and first forward.
   autoscale — a GPU cluster that grows on demand, with no runtime of the
              script's own: `python -m ray_tpu_torch start --head
              --num-cpus 4 --num-gpus 0 --autoscale 1:2` under a fresh
              TMPDIR (`status`: one node, no GPU); this process joins with
              init(address=...) and submits job_cli_score as a num_gpus=1
              task, which the head parks as queued demand; the autoscaler's
              monitor starts a local raylet that counts the card through
              NVML (GPU 1, accelerator_type:H100), the parked lease moves
              there and the task runs there (its node id and pid returned).
              After the result this process shuts its runtime down, and
              the idle node must be scaled down within 90 s; then `stop`.
              32 flash forward launches counted in the task, its logits
              within 1e-6 relative L2 of the forward phase's, no process of
              the cluster left (the session's, the monitor's raylet, the
              task's worker), the card's free memory after the scale-down
              and after `stop` within 1 GiB of its reading before `start`.
              Printed: demand to node registered, to the task's start,
              weight draw, first forward, result to node gone, `stop`.
   chaos_worker — ray_tpu_torch.init(num_cpus=2), no worker started, one
              num_gpus=1, max_retries=1 task (chaos_card_task) that starts
              CUDA and waits; ProcessKiller(_owned_cluster, seed=0,
              target="worker", max_kills=1).strike_once() with the chaos
              controller armed must strike that worker (the only READY
              one), the card's free memory once it exited must be within
              1 GiB of the reading before the task, and the retry, released
              then, must return from a new pid with 32 forward launches and
              logits within 1e-6 relative L2 of the forward phase's;
              killer.kills and state.list_chaos_events() hold the strike.
19. rllib_parity — ray_tpu_torch.rllib on the card, float32, TF32 off: one
              update of each of PPO (minibatches 1), IMPALA, APPO, DQN, SAC,
              BC and CQL from weights drawn once and a fixed batch, against
              the same update on the CPU, each leaf's max error over its
              largest value within 1e-5: in float32 the loss and every
              gradient leaf, in float64 every updated leaf (target critics
              too; Adam carries float32's rounding of cancellation-small
              gradients into whole steps); ms per float32 update on the card
              and on the host CPU. The port's CartPole-v1, 2000 random-action
              steps of 8 envs, twice from one seed, must give equal bytes.
    The rllib phases 20-23 run on a runtime the script starts after phase
    19: each algorithm's env runners are actors of it (num_cpus=0.5, no
    card: they sample on the host CPU, one intra-op thread), each must
    run in a process other than the driver's; PPO's learners are actors
    leasing the card (1/num_learners of it); the other algorithms learn
    in the driver, on the card.
20. rllib_ppo — PPO on the port's CartPole-v1 at test_ppo_learns_cartpole's
              settings (2 runners x 4 envs x 128 steps, lr 1e-3, 4 epochs x
              4 minibatches, hidden 64), 8 iterations: best mean return >
              max(60, 1.5 x first), params on cuda; per iteration sample ms
              (the slowest runner's, read in the runners), update ms (the
              rest of train()) and env steps/s.
   tune_rllib — Tuner over PPO.as_trainable(rllib_ppo's config,
              stop_iters=3), param_space {"lr": grid_search([1e-3, 3e-3])},
              two trials at once on the RL runtime (each an actor holding no
              card; runner actors on the host CPU, a learner actor leasing
              the whole card, so the second waits for the first's): both TERMINATED with 3 reports, the 1e-3 trial's
              per-iteration return and loss equal to rllib_ppo's first 3,
              and 0 flash launches read in every learner actor.
21. rllib_offpolicy — DQN, IMPALA (standing sample requests), APPO and SAC
              at their JAX tests' settings and iteration counts, each held
              to its test's bar, and the two-agent runner (TwoAgentTag, in
              process) with per-policy PPO.
22. rllib_offline — collect_rollouts -> OfflineData (its shard read by a
              task of the runtime) -> BC (agreement with the expert > 0.8)
              and CQL (prefers the logged action on > 0.9).
23. rllib_learners — PPO with num_learners=2: two Learner actors sharing
              the card (GPU 0.5 each) in a gloo group met through the GCS
              KV; driven directly, one updates on a fixed rollout and one on
              an empty shard: equal params and Adam moments after the sync
              (the mean of the update and the initial state), step counts
              16 and 0; then one train() through both.
              Each rllib phase reads the flash kernels' launches where its
              updates run, counted there from 0 (the driver's, and in
              rllib_ppo and rllib_learners each learner actor's): 0.
24. lint    — the port's linter (ray_tpu_torch/devtools/lint), static, on the
              card's host: `python -m ray_tpu_torch lint --flow` over the
              package in a subprocess must exit 0 with 0 findings and
              import no torch (its seconds printed); RT017's flagged
              functions of LINT_SYNC_SOURCE (a loop per sync leg over a
              CUDA tensor, and the clean shapes) against those that raise
              under torch.cuda.set_sync_debug_mode("error"): each that
              raises must be flagged, each leg flagged, no clean shape
              flagged or raising, and the legs the detector does not see
              printed with what the card did; then, as information, the
              syncs the detector warns of in one paged_decode_multi call
              (8 steps) of the serving phases' 2-layer float32 engine,
              beside the flow pass's verdict on that root.

The script and every process it starts share one bytecode cache under the
git-ignored ray_tpu_torch/_build/pycache (keep_bytecode).

Then the script's wall seconds, the {"kernels": [...]} line, the card's name
and power limit, and as the last line {"ok": true, "device": {...}}. Without a CUDA device, or without the
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
MOE_TRAIN_STEPS = 5  # moe_train's timed steps (each over a second)


_STARTED = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t``, the seconds since the
    script started, so consecutive lines give each phase's time."""
    if "phase" in obj:
        obj = {**obj, "t": round(time.perf_counter() - _STARTED, 3)}
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
    and weights, the float32 logits of the last position)."""
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
        last = logits[:, -1].float().clone()  # the workflow phase's reference
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
    return launches, cfg32, params32, last


DAG_STORE_BYTES = 2 << 30  # a closed channel keeps its cell: two graphs of 64 MiB cells
DAG_ITERS = 4  # timed executes per mode
DAG_BUFFER = 64 << 20  # the hidden state is 32 MiB
DAG_TOL = 3e-2  # the forward phase's bf16 bound, printed as the phase's tol
# the stages run the in-process forward's ops on the same weights and
# shapes: anything above rounding noise is a dropped or repeated layer or a
# damaged hop
DAG_EXACT_TOL = 1e-6


class LlamaStage:
    """One stage actor of dag_pipeline: it draws the forward phase's seed-0
    weights on its card (the same generator, so the same draws) and keeps
    its half (llama_stage_params). forward() counts the flash launches of
    each call and times it (synchronised, on the host clock); scaled()
    feeds the collective check."""

    def __init__(self, stage: int, n_stages: int):
        import torch

        from ray_tpu_torch.models.llama import LlamaConfig, llama_init, llama_stage_params

        if not torch.cuda.is_available():
            raise RuntimeError("a dag_pipeline stage has no CUDA device")
        _no_tf32()
        self.cfg = LlamaConfig.llama3_8b()
        g = torch.Generator(device="cuda").manual_seed(SEED)
        params = llama_init(g, self.cfg, "cuda")
        self.part = llama_stage_params(params, self.cfg, stage, n_stages)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        self.last = stage == n_stages - 1
        self.per_forward: list[int] = []
        self.forward_ms: list[float] = []

    def forward(self, x):
        """Tokens or the previous stage's hidden state in; the hidden state
        out, or (the last stage) the float32 logits at the last position."""
        import torch

        from ray_tpu_torch import kernels
        from ray_tpu_torch.models.llama import llama_stage_forward

        n0 = kernels.launches().get("flash_attention_fwd", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = llama_stage_forward(self.part, x, self.cfg, attn_impl="auto",
                                      last_only=self.last)
            out = out[:, 0].float() if self.last else out
        torch.cuda.synchronize()
        self.forward_ms.append((time.perf_counter() - t0) * 1e3)
        self.per_forward.append(kernels.launches().get("flash_attention_fwd", 0) - n0)
        return out

    def reset_launches(self) -> bool:
        from ray_tpu_torch import kernels

        kernels.LAUNCHES.clear()
        self.per_forward, self.forward_ms = [], []
        return True

    def launches(self) -> list:
        return list(self.per_forward)

    def forward_times(self) -> list:
        return list(self.forward_ms)

    def info(self) -> dict:
        import torch

        return {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "name": torch.cuda.get_device_name(0),
                "allocated_gb": torch.cuda.memory_allocated() / 2**30,
                "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
                "foreign": _foreign_modules()}

    def setup_group(self, world: int, rank: int, group: str) -> bool:
        from ray_tpu_torch import collective

        # no init_method: the stages meet through the runtime's GCS KV
        collective.init_collective_group(world, rank, backend="gloo", group_name=group)
        return True

    def scaled(self, x, k):
        import torch

        return torch.full((1024,), float(x) * k, dtype=torch.float32, device="cuda")


def _dag_run(compiled, tokens, iters: int) -> tuple[list, float]:
    """``iters`` executes with two in flight: (the results, ms per
    iteration on the host clock)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refs = [compiled.execute(tokens) for _ in range(min(2, iters))]
    outs = []
    for _ in range(iters - len(refs)):
        refs.append(compiled.execute(tokens))
        outs.append(refs.pop(0).get(timeout=300))
    outs += [r.get(timeout=300) for r in refs]
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t0) * 1e3 / iters


def _dag_loop_times(compiled, stages, forward_ms, overlap: bool) -> dict:
    """Per stage, from its loop's timeline (its first iteration, the
    warm-up, left out) and its forward()'s own times: medians in ms of the
    iteration period, the wait for its inputs (from the previous
    iteration's end to the inputs in hand), the compute (method call, and
    sequentially the channel write) and the forward alone. Sequentially,
    the 32 MiB hop: stage 0's write (its compute less its forward) plus
    stage 1's read (from the later of its iteration's start and stage 0's
    write ending to the value in hand; both loops stamp the host's one
    monotonic clock)."""
    import statistics

    med = statistics.median
    lines = [compiled.loop_results[s.actor_id.binary().hex()]["timeline"][1:1 + DAG_ITERS]
             for s in stages]
    out = {}
    for i, (line, fwd) in enumerate(zip(lines, forward_ms)):
        ready = [max(start, read) for read, start, _ in line]
        out[f"stage{i}"] = {
            "period_ms": med((b[2] - a[2]) * 1e3 for a, b in zip(line, line[1:])),
            "input_wait_ms": med((r - a[2]) * 1e3 for a, r in zip(line, ready[1:])),
            "compute_ms": med((t[2] - r) * 1e3 for t, r in zip(line, ready)),
            "forward_ms": med(fwd)}
    if not overlap:
        (l0, l1), (f0, _) = lines, forward_ms
        write = med((end - max(read, start)) * 1e3 - f for (read, start, end), f in zip(l0, f0))
        read = med((b[0] - max(b[1], a[2])) * 1e3 for a, b in zip(l0, l1))
        out["hop"] = {"write_ms": write, "read_ms": read, "ms": write + read}
    return out


def phase_dag_pipeline(card: str, cfg, params, tokens) -> dict:
    """Compiled graphs on the card: two LlamaStage actors of the port's
    runtime sharing the card (num_gpus=0.5 each), stage 0 the embedding and
    layers 0-15, stage 1 layers 16-31, the norm and the head of the forward
    phase's Llama-3-8B-width bf16 model. InputNode -> stage0.forward ->
    stage1.forward, compiled with 64 MiB channels: tokens [2, 2048] in, the
    bf16 hidden state [2, 2048, 4096] (32 MiB) between the stages, float32
    logits [2, 128256] at the last position out. Each stage must launch the
    flash forward 16 times per execute; the logits must agree with the
    driver's llama_forward within DAG_EXACT_TOL (relative L2; the same
    ops on the same weights; printed: DAG_TOL, the forward phase's bound,
    and whether bitwise equal). Printed: ms per iteration over DAG_ITERS
    executes with overlap on and off and through a chain of .remote calls;
    each stage's iteration period, input wait, compute and forward from
    its loop's timeline (_dag_loop_times), and from the sequential run the
    hop of the hidden state (write + read) and its GB/s; the card's
    memory; the seconds of each part. Then a CollectiveNode: both stages
    allreduce a float32 CUDA tensor in a gloo group met through the GCS KV;
    both outputs must equal the sum. Returns the flash launches of the
    timed overlap run, by stage."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce_bind
    from ray_tpu_torch.models.llama import llama_forward

    t_phase = time.perf_counter()
    parts = {}

    def part(name):  # seconds since the last part ended
        now = time.perf_counter()
        parts[name] = now - part.t
        part.t = now
    part.t = t_phase
    inputs = tokens[:, :-1]
    with torch.inference_mode():
        ref = llama_forward(params, inputs, cfg, attn_impl="auto")[0][:, -1].float()
    rt.init(object_store_memory=DAG_STORE_BYTES)
    part("reference_and_init")
    try:
        Stage = rt.remote(LlamaStage).options(num_gpus=0.5, num_cpus=1)
        t0 = time.perf_counter()
        stages = [Stage.remote(s, 2) for s in range(2)]
        infos = rt.get([s.info.remote() for s in stages], timeout=600)
        start_s = time.perf_counter() - t0
        part("stage_start")
        card_used_gb = (torch.cuda.mem_get_info()[1] - torch.cuda.mem_get_info()[0]) / 2**30
        with InputNode() as inp:
            dag = stages[1].forward.bind(stages[0].forward.bind(inp))
        runs, per_execute, outs, loops = {}, {}, {}, {}
        for overlap in (True, False):
            compiled = dag.experimental_compile(buffer_size_bytes=DAG_BUFFER, overlap=overlap)
            try:
                first = compiled.execute(inputs).get(timeout=600)  # warm (cuBLAS, allocator)
                rt.get([s.reset_launches.remote() for s in stages])
                # the main path: the counts are read just after it
                outs[overlap], runs[overlap] = _dag_run(compiled, inputs, DAG_ITERS)
                per_execute[overlap] = rt.get([s.launches.remote() for s in stages])
                forward_ms = rt.get([s.forward_times.remote() for s in stages])
            finally:
                compiled.teardown()
            loops[overlap] = _dag_loop_times(compiled, stages, forward_ms, overlap)
            part(f"graph_{'overlap' if overlap else 'sequential'}")
        rt.get([s.reset_launches.remote() for s in stages])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain = [stages[1].forward.remote(stages[0].forward.remote(inputs))
                 for _ in range(DAG_ITERS)]
        chain_outs = rt.get(chain, timeout=600)
        torch.cuda.synchronize()
        chain_ms = (time.perf_counter() - t0) * 1e3 / DAG_ITERS
        chain_launches = rt.get([s.launches.remote() for s in stages])
        peak = rt.get([s.info.remote() for s in stages])
        card_peak_gb = (torch.cuda.mem_get_info()[1] - torch.cuda.mem_get_info()[0]) / 2**30
        part("remote_chain")

        group = f"dag_stages_{os.getpid()}"
        assert rt.get([s.setup_group.remote(2, r, group) for r, s in enumerate(stages)],
                      timeout=300) == [True, True]
        with InputNode() as inp:
            r0, r1 = allreduce_bind([stages[0].scaled.bind(inp, 1.0),
                                     stages[1].scaled.bind(inp, 10.0)], group_name=group)
            col_dag = MultiOutputNode([r0, r1])
        compiled = col_dag.experimental_compile()
        try:
            col = []
            for i in range(3):
                a, b = compiled.execute(float(i + 1)).get(timeout=120)
                want = torch.full_like(a, (i + 1) * 11.0)
                col.append(a.device.type == b.device.type == "cuda"
                           and torch.equal(a, want) and torch.equal(b, want))
        finally:
            compiled.teardown()
        part("collective")
        del stages
        gc.collect()
    finally:
        rt.shutdown()
    part("shutdown")
    logits = [first] + outs[True] + outs[False] + chain_outs
    errs = [rel_l2(x, ref) for x in logits]
    bitwise = all(torch.equal(x, ref) for x in logits)
    hidden_bytes = inputs.shape[0] * inputs.shape[1] * cfg.d_model * 2
    chan_bytes = hidden_bytes + inputs.numel() * inputs.element_size() + ref.numel() * 4
    want_launches = cfg.n_layers // 2
    launch_ok = all(per == [want_launches] * DAG_ITERS
                    for runs_ in (per_execute[True], per_execute[False], chain_launches)
                    for per in runs_)
    out = {"phase": "dag_pipeline", "stages": 2, "layers_per_stage": want_launches,
           "tokens": list(inputs.shape), "hidden_bytes": hidden_bytes,
           "channel_bytes_per_iter": chan_bytes, "buffer_size_bytes": DAG_BUFFER,
           "ms_per_iter_overlap": runs[True], "ms_per_iter_sequential": runs[False],
           "ms_per_iter_remote_chain": chain_ms,
           "loop_overlap": loops[True], "loop_sequential": loops[False],
           "hop_ms": loops[False]["hop"]["ms"],
           "hop_gb_per_s": hidden_bytes / loops[False]["hop"]["ms"] / 1e6,
           "flash_launches_per_execute": {"overlap": per_execute[True],
                                          "sequential": per_execute[False],
                                          "remote_chain": chain_launches},
           "logits_rel_l2_max": max(errs), "tol": DAG_TOL, "exact_tol": DAG_EXACT_TOL,
           "bitwise_equal": bitwise,
           "allreduce_sum_ok": col, "stage_start_s": start_s,
           "stage_procs": [{k: i[k] for k in ("pid", "visible", "allocated_gb", "foreign")}
                           for i in infos],
           "stage_peak_gb": [i["peak_gb"] for i in peak],
           "card_used_gb_after_start": card_used_gb, "card_used_gb_after_runs": card_peak_gb,
           "driver_peak_gb": torch.cuda.max_memory_allocated() / 2**30,
           "seconds": time.perf_counter() - t_phase, "seconds_by_part": parts, "card": card}
    emit(out)
    if not launch_ok:
        raise AssertionError(f"dag_pipeline launches {out['flash_launches_per_execute']}, "
                             f"want {want_launches} per stage per execute")
    if not max(errs) <= DAG_EXACT_TOL or not all(tuple(x.shape) == tuple(ref.shape)
                                                 for x in logits):
        raise AssertionError(f"dag_pipeline logits disagree with the forward: {errs}")
    if not all(col) or len(col) != 3:
        raise AssertionError(f"dag_pipeline allreduce: {col}")
    if any(i["foreign"] for i in infos) or len({i["pid"] for i in infos}) != 2:
        raise AssertionError(f"dag_pipeline stages: {infos}")
    return {"stage0": sum(per_execute[True][0]), "stage1": sum(per_execute[True][1])}


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
    temperatures in one batch (exactly one generate call per temperature).
    32 layers, bf16: TTFT, tokens/s and deltas per request, as
    information. 2 layers, float32: __call__, stream and stream_deltas give
    the aggregated engine's tokens (generate's, phase serving), and
    LLMServer gives generate's on the same batch. (build_llm_processor maps
    over the data executor's task workers: phase data_batch.)
    Returns the kernel launches of the bf16 runs, and the bf16 readings
    (with LLMServer's prompts and temperatures) that serve_run repeats
    through a handle."""
    import numpy as np

    from ray_tpu_torch.llm import LLMEngineServer, LLMServer, generate

    max_tokens = 32
    rng = np.random.default_rng(SEED + 5)
    # LLMServer: 8 requests, greedy and sampled in turns
    server_prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
                      for n in (24, 60, 130, 200, 256, 333, 400, 512)]
    temps = [0.0, 0.8] * 4

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

    calls, restore = count_generate_calls()
    try:
        kernels.LAUNCHES.clear()  # the bf16 serving layer's runs start here
        paths = ["__call__", "stream_deltas"] * 3
        res, wall, stats = asyncio.run(engine_server(cfg, params, paths))
        check_completions("serving_server", prompts, [r[0] for r in res], cfg, max_tokens)
        inproc = {"LLMEngineServer": {"ttft_ms": [r[1] for r in res],
                                      "tokens_per_s": sum(len(r[0]) for r in res) / wall}}
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
        inproc["LLMServer"] = {"latency_s": [r["usage"]["latency_s"] for r in res],
                               "tokens_per_s": len(res) * max_tokens / wall, "wall_s": wall,
                               "prompts": server_prompts, "temperatures": temps,
                               "max_tokens": max_tokens}
        if not (min(batch_sizes) > 1 and sorted(server_calls) == [4, 4]):
            raise AssertionError(f"LLMServer batches {batch_sizes}, generate calls "
                                 f"{server_calls}; want one batch, one call per temperature")
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
    finally:
        restore()
    emit({"phase": "serving_server_f32", "layers": 2, "equal": same})
    if not all(all(v) for v in same.values()):
        raise AssertionError(f"f32 serving layer differs from the engine/generate: {same}")
    return launches, inproc


def check_shipped_pages(cfg, params, prompts, kv_dtypes) -> list:
    """Admit ``prompts`` into an engine per kv_dtype, export every live
    request's pages and hold each shipped page, and each adopted stack,
    against the pool rows bit for bit. Returns one row per kv_dtype."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
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
                        ref = m.pages[i].refs[side if not name else f"{side}.{name}"]
                        arr = np.array(rt.get(ref))  # the sealed bytes
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

    import ray_tpu_torch as rt

    # the KV-page plane seals every page into the runtime's shm arena: the
    # runtime lives for this phase (phase runtime starts its own later)
    rt.init(object_store_memory=RUNTIME_STORE_BYTES)
    try:
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
    finally:
        rt.shutdown()
    return launches, row["decode_tokens_per_s"]


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
    kernel launches of the timed steps, every step's loss (the warm-up and
    the timed steps) and the batch's tokens (numpy, int64)."""
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
    train_tokens = batch["tokens"].cpu().numpy()  # data_trainer streams these rows
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
    return launches, losses, train_tokens


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
        last = logits[:, -1].float().clone()  # the workflow phase's reference
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
    for _ in range(MOE_TRAIN_STEPS):
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
ATTRIBUTION_STEPS = 5  # trainer: mesh and no-mesh steps, alternating
HYPER = dict(learning_rate=1e-2, b1=0.9, b2=0.99, eps=1e-6, weight_decay=1e-2)
DP2_CFG = dict(vocab_size=32000, d_model=1024, n_layers=2, n_heads=8, n_kv_heads=8, d_ff=2816,
               max_seq_len=2048, dtype="float32")


# ------------------------------------------------------------------ runtime
# one tensor through put/get, an argument and a return; a by-value argument
# above max_inline_object_size is sealed into the caller's shm arena and
# read from there, as a put of it would be, and the phase fails if this
# one was not
RUNTIME_TENSOR_BYTES = 256 << 20
RUNTIME_STORE_BYTES = 8 << 30  # the shm arena: a few such objects alive at once
RUNTIME_REPS = 1  # each transfer once, into a cold arena


def _foreign_modules() -> list:
    """The JAX package's modules (and jax's) loaded in this process."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")})


def _runtime_task_probe():
    """A num_gpus=1 task's view: its pinned card, and what it imported."""
    import torch

    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "foreign": _foreign_modules()}


class RuntimeEcho:
    """A GPU actor of the port's runtime: describes or returns what it got."""

    def describe(self, x):
        import torch

        torch.cuda.synchronize()
        return {"device": str(x.device), "dtype": str(x.dtype), "shape": list(x.shape)}

    def echo(self, x):
        return x

    def modules(self):
        return _foreign_modules()


def _same_bytes(a, b) -> bool:
    import torch

    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(bits), b.to(a.device).view(bits))


def _runtime_transfers(rt, actor, x, want_device: str, reps: int = RUNTIME_REPS) -> dict:
    """put, get, a task argument (into ``actor``, a RuntimeEcho, which
    synchronises and describes it) and a round trip (the actor returns it),
    each timed ``reps`` times on the host clock; the bytes checked equal, and the
    argument checked to have gone through the arena (the driver's count of
    sealed arguments rises by one), not the RPC socket."""
    import torch

    core = rt.get_core()
    nbytes = x.numel() * x.element_size()
    sync = torch.cuda.synchronize
    out = {"put_s": [], "get_s": [], "arg_s": [], "round_trip_s": []}
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        ref = rt.put(x)
        out["put_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        y = rt.get(ref)
        sync()
        out["get_s"].append(time.perf_counter() - t0)
        if not _same_bytes(x, y) or str(y.device) != str(x.device):
            raise AssertionError(f"get of a {x.dtype} {x.device} tensor: {y.device}, bytes differ")
        del ref, y
        sealed = core.sealed_args
        t0 = time.perf_counter()
        info = rt.get(actor.describe.remote(x))
        out["arg_s"].append(time.perf_counter() - t0)
        if core.sealed_args != sealed + 1:
            raise AssertionError(f"the {nbytes}-byte argument did not go through the arena")
        if info != {"device": want_device, "dtype": str(x.dtype), "shape": list(x.shape)}:
            raise AssertionError(f"the actor got {info}")
        t0 = time.perf_counter()
        z = rt.get(actor.echo.remote(x))
        sync()
        out["round_trip_s"].append(time.perf_counter() - t0)
        if not _same_bytes(x, z) or str(z.device) != str(x.device):
            raise AssertionError(f"round trip of a {x.dtype} {x.device} tensor: bytes differ")
        del z
        gc.collect()
    rates = {k.replace("_s", "_gb_per_s"): [nbytes / t / 1e9 for t in v] for k, v in out.items()}
    # the round trip moves the bytes twice, into the actor and back
    rates["round_trip_gb_per_s"] = [2 * r for r in rates["round_trip_gb_per_s"]]
    return {"bytes": nbytes, "dtype": str(x.dtype), "device": str(x.device),
            "arg_through_arena": True, **out, **rates}


def phase_runtime(card: str) -> None:
    """The port's task/actor runtime on the card's host: init reports the
    card, RUNTIME_TENSOR_BYTES tensors (bf16 on the card, float32 on the host) go into a
    GPU actor and back with their bytes equal, a num_gpus=1 task is pinned
    to the card, and no worker loads jax or ray_tpu. The runtime stays up
    for the trainer phases."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import config

    # the one card goes from the actor to the task to the trainer's
    # placement group: a task's idle lease would hold it the default 10 s
    config.set_config(dataclasses.replace(config.get_config(), worker_lease_timeout_s=1.0))
    t0 = time.perf_counter()
    rt.init(object_store_memory=RUNTIME_STORE_BYTES)
    init_s = time.perf_counter() - t0
    resources = rt.cluster_resources()
    if resources.get("GPU") != 1.0:
        raise AssertionError(f"cluster_resources() {resources}: want GPU 1.0")
    # an actor's start (a worker's spawn, its runtime's connect) apart from
    # its first tensors (the torch import and the CUDA context)
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1)(RuntimeEcho).remote()
    foreign = rt.get(actor.modules.remote(), timeout=300)
    actor_start_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt.get([actor.describe.remote(torch.zeros(1, device=d)) for d in ("cuda", "cpu")],
           timeout=300)
    actor_first_tensors_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    n16, n32 = RUNTIME_TENSOR_BYTES // 2, RUNTIME_TENSOR_BYTES // 4
    on_card = torch.randn(n16 // 4096, 4096, generator=g, device="cuda").to(torch.bfloat16)
    cuda = _runtime_transfers(rt, actor, on_card, "cuda:0")
    del on_card
    host = torch.randn(n32 // 4096, 4096, generator=g, device="cuda").cpu()
    cpu = _runtime_transfers(rt, actor, host, "cpu")
    del host
    foreign += rt.get(actor.modules.remote(), timeout=60)
    rt.kill(actor)
    # the task waits for the actor's worker to exit and give the card back
    t0 = time.perf_counter()
    task = rt.get(rt.remote(num_gpus=1)(_runtime_task_probe).remote(), timeout=300)
    task_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "runtime", "init_s": init_s, "cluster_resources": resources,
          "actor_start_s": actor_start_s, "actor_first_tensors_s": actor_first_tensors_s,
          "gpu_task": task, "gpu_task_s": task_s, "worker_foreign_modules": foreign,
          "store_bytes": RUNTIME_STORE_BYTES, "cuda_tensor": cuda, "cpu_tensor": cpu,
          "gb_per_s": {t["device"].split(":")[0]: {
              k.removesuffix("_gb_per_s"): t[k][0] for k in (
                  "put_gb_per_s", "get_gb_per_s", "arg_gb_per_s", "round_trip_gb_per_s")}
              for t in (cuda, cpu)},
          "card": card})
    if task["visible"] != "0" or task["name"] != torch.cuda.get_device_name(0) or task["foreign"]:
        raise AssertionError(f"a num_gpus=1 task saw {task}")
    if foreign:
        raise AssertionError(f"a worker loaded {foreign}")


# ------------------------------------------------------------ sharded plane
SHARDED_MESH = {"fsdp": 2, "tp": 4}  # 8 unique shards of the embedding


def _sharded_double(x):
    """The shard wave's body: runs in a shard task that leases the card."""
    if not x.is_cuda:
        raise AssertionError(f"a shard task got its shard on {x.device}")
    return x * 2


def phase_sharded(card: str) -> dict:
    """The sharded object plane on the runtime of phase runtime: the
    Llama-3-8B embedding [128256, 4096] bf16 on the card, put by
    PartitionRules.llama() at tok/embedding on MeshSpec(fsdp=2, tp=4)
    (8 shards of [64128, 1024]); a num_gpus=1 shard wave (x2) twice, a
    reshard to (None, tp) and back, get_sharded on the card; the bytes must
    equal the whole tensor's x2 (exact in bf16). Prints the driver's bytes
    against the shards', the put, get and reshard GB/s and the waves'
    seconds (host clock). Returns the flash launches of the phase (0)."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import kernels
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import PartitionRules
    from ray_tpu_torch.sharded import P, stats, telemetry

    cfg = LlamaConfig.llama3_8b()
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    emb = torch.randn(cfg.vocab_size, cfg.d_model, generator=g, device="cuda").to(torch.bfloat16)
    nbytes = emb.numel() * emb.element_size()
    want = emb * 2
    mesh = MeshSpec(**SHARDED_MESH)
    sync = torch.cuda.synchronize
    telemetry.reset_counters()
    kernels.LAUNCHES.clear()  # the sharded plane's runs start here

    def timed_s(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    sref, put_s = timed_s(lambda: rt.put_sharded(emb, mesh=mesh, rules=PartitionRules.llama(),
                                                 path="tok/embedding"))
    boxes = [[b - a for a, b in s.box] for s in sref.manifest.shards]
    if sref.spec != ("fsdp", "tp") or boxes != [[64128, 1024]] * 8:
        raise AssertionError(f"put_sharded: spec {sref.spec}, boxes {boxes}")
    double = rt.remote(in_specs=P("fsdp", "tp"), out_specs=P("fsdp", "tp"),
                       num_gpus=1)(_sharded_double)
    wave_s = []
    for _ in range(2):  # the first wave starts the shard tasks' worker
        t0 = time.perf_counter()
        out = double.remote(sref)
        ready, _ = rt.wait(out.shard_refs(), num_returns=out.num_shards(), timeout=600)
        wave_s.append(time.perf_counter() - t0)
        if len(ready) != out.num_shards():
            raise AssertionError(f"shard wave: {len(ready)} of {out.num_shards()} shards")
    del sref
    gc.collect()
    moved, reshard_s = timed_s(lambda: rt.reshard(out, (None, "tp"), mesh=mesh, device="cuda"))
    back, reshard_back_s = timed_s(lambda: rt.reshard(moved, ("fsdp", "tp"), mesh=mesh,
                                                             device="cuda"))
    del out, moved
    gc.collect()
    got, get_s = timed_s(lambda: rt.get_sharded(back, mesh=mesh, device="cuda"))
    equal = bool(torch.equal(got.view(torch.int16), want.view(torch.int16)))
    counters = stats()
    launches = dict(kernels.launches())
    emit({"phase": "sharded", "tensor": [cfg.vocab_size, cfg.d_model], "dtype": "bfloat16",
          "bytes": nbytes, "mesh": SHARDED_MESH, "spec": list(back.spec),
          "shards": back.num_shards(), "shard_shape": boxes[0], "equal": equal,
          "driver_bytes": counters["driver_bytes"], "array_bytes": counters["array_bytes"],
          "counters": counters, "put_s": put_s, "put_gb_per_s": nbytes / put_s / 1e9,
          "wave_s": wave_s, "reshard_s": [reshard_s, reshard_back_s],
          "reshard_gb_per_s": [nbytes / reshard_s / 1e9, nbytes / reshard_back_s / 1e9],
          "get_s": get_s, "get_gb_per_s": nbytes / get_s / 1e9, "launches": launches,
          "card": card})
    del got, back, emb, want
    gc.collect()
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError("get_sharded of the doubled, resharded embedding differs")
    if not counters["driver_bytes"] < counters["array_bytes"] / 1000:
        raise AssertionError(f"the driver moved {counters['driver_bytes']} bytes")
    return launches


# ----------------------------------------------------------------- serve_run
def _llm_probe_class():
    """LLMServer with one method more, ``probe``: what its replica's worker
    sees (its card, the modules it loaded, the flash launches it made). The
    deployment is build_llm_deployment's, config and arguments unchanged."""
    from ray_tpu_torch.llm import LLMServer

    class ProbedLLMServer(LLMServer):
        def probe(self):
            import torch

            from ray_tpu_torch import kernels

            leaf = self.params["tok"]["embedding"]
            return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "count": torch.cuda.device_count(), "weights_device": str(leaf.device),
                    "weights_dtype": str(leaf.dtype).removeprefix("torch."),
                    "foreign": _foreign_modules(), "launches": dict(kernels.launches())}

    return ProbedLLMServer


def _probed(app, probe_cls):
    """``app`` with its deployment's class replaced by ``probe_cls`` (a
    subclass of it), config and arguments unchanged."""
    from ray_tpu_torch.serve import Application, Deployment

    dep = app.deployment
    return Application(Deployment(probe_cls, dep.name, dep.config), app.init_args,
                       app.init_kwargs)


def phase_serve_run(card: str, inproc: dict) -> dict:
    """serve.run on the runtime of phase runtime, each replica a num_gpus=1
    actor that makes its own seed-0 weights on its card. At 2 layers,
    float32, full width: 8 concurrent greedy requests through a handle
    give the in-process LLMServer's tokens on the same weights. At 32
    layers, bf16: serving_server's 8 LLMServer requests through a handle
    (a warm-up round, then a timed one), tokens/s and latencies beside the
    in-process readings; then build_llm_engine_deployment answers a
    stream_deltas request twice (the second's TTFT beside the in-process
    engine's; the first starts the replica's engine loop).
    serve.status() shows each replica RUNNING with GPU 1, and its worker
    sees CUDA_VISIBLE_DEVICES "0" and loads neither jax nor ray_tpu.
    Serve is shut down at the end. Returns the replicas' flash launches and
    the 32-layer LLMServer's tokens/s through the handle."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import kernels, serve
    from ray_tpu_torch.llm import LLMServer, build_llm_deployment, build_llm_engine_deployment
    from ray_tpu_torch.models.llama import LlamaConfig

    ls = inproc["LLMServer"]
    prompts, temps, max_tokens = ls["prompts"], ls["temperatures"], ls["max_tokens"]
    kernels.LAUNCHES.clear()  # the serve_run phase starts here
    launches: collections.Counter = collections.Counter()

    def replica_of(app_name, dep):
        (rep,) = serve.status()[app_name][dep]["replicas"]
        return rep

    def run(app_name, cfg, temps_):
        app = _probed(build_llm_deployment(cfg, num_gpus=1, max_batch_size=8),
                      _llm_probe_class())
        t0 = time.perf_counter()
        handle = serve.run(app, name=app_name)
        start_s = time.perf_counter() - t0
        reqs = [{"prompt_tokens": q, "max_tokens": max_tokens, "temperature": t}
                for q, t in zip(prompts, temps_)]
        rounds = []
        for _ in range(2):
            t0 = time.perf_counter()
            refs = [handle.remote(r) for r in reqs]
            res = rt.get(refs, timeout=600)
            rounds.append((res, time.perf_counter() - t0))
        probe = rt.get(handle.probe.remote(), timeout=120)
        launches.update(probe["launches"])
        return rounds, probe, replica_of(app_name, "LLMServer"), start_s

    def check_replica(name, rep, probe, dtype):
        if rep["state"] != "RUNNING" or rep["resources"].get("GPU") != 1.0:
            raise AssertionError(f"{name} replica {rep}")
        if (probe["visible"] != "0" or probe["count"] != 1 or probe["foreign"]
                or probe["weights_device"] != "cuda:0" or probe["weights_dtype"] != dtype):
            raise AssertionError(f"{name} replica's worker: {probe}")

    # 2 layers, float32, full width: token identity with the in-process server
    cfg32 = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype="float32")
    greedy = [0.0] * len(prompts)
    rounds, probe32, rep32, start32 = run("serve_run_f32", cfg32, greedy)
    got = [r["completion_tokens"] for r in rounds[-1][0]]
    srv = LLMServer(cfg32, max_batch_size=8)  # the seed-0 weights, on this process's card

    async def in_process():
        return await asyncio.gather(*[srv({"prompt_tokens": q, "max_tokens": max_tokens})
                                      for q in prompts])

    want = [r["completion_tokens"] for r in asyncio.run(in_process())]
    del srv
    serve.delete("serve_run_f32")
    gc.collect()
    torch.cuda.empty_cache()
    equal = [a == b for a, b in zip(got, want)]
    check_replica("float32", rep32, probe32, "float32")

    # 32 layers, bf16: serving_server's requests through a handle
    cfg = LlamaConfig.llama3_8b()
    rounds, probe, rep, start_s = run("serve_run", cfg, temps)
    res, wall = rounds[-1]
    check_completions("serve_run", prompts, [r["completion_tokens"] for r in res], cfg,
                      max_tokens)
    check_replica("bf16", rep, probe, "bfloat16")
    batch_sizes = [r["usage"]["batch_size"] for r in res]
    serve.delete("serve_run")

    # the engine deployment: one stream_deltas request through a handle
    app = build_llm_engine_deployment(cfg, num_gpus=1, max_batch=4, page_size=16,
                                      n_pages=512, max_seq_len=2048)
    t0 = time.perf_counter()
    serve.run(app, name="serve_run_engine")
    engine_start_s = time.perf_counter() - t0
    handle = serve.get_deployment_handle("LLMEngineServer", "serve_run_engine")
    req = {"prompt_tokens": prompts[3], "max_tokens": max_tokens}
    first_call = []
    for _ in range(2):  # the first call starts the replica's engine loop
        deltas, ttft_ms = [], None
        t0 = time.perf_counter()
        for d in handle.stream_deltas.stream_chunks(dict(req)):
            ttft_ms = ttft_ms or (time.perf_counter() - t0) * 1e3
            deltas.append(d)
        stream_s = time.perf_counter() - t0
        first_call = first_call or [ttft_ms, stream_s]
    toks = [t for d in deltas for t in d["tokens"]]
    erep = replica_of("serve_run_engine", "LLMEngineServer")
    serve.shutdown()  # every replica goes, and its card with it
    emit({"phase": "serve_run", "f32_layers": 2, "f32_equal": equal,
          "f32_replica_start_s": start32, "replica": rep, "replica_worker": probe,
          "layers": cfg.n_layers, "dtype": cfg.dtype, "requests": len(res),
          "temperatures": temps, "batch_sizes": batch_sizes, "replica_start_s": start_s,
          "handle_wall_s": wall, "handle_tokens_per_s": len(res) * max_tokens / wall,
          "warmup_wall_s": rounds[0][1],
          "replica_latency_s": [r["usage"]["latency_s"] for r in res],
          "in_process_tokens_per_s": ls["tokens_per_s"], "in_process_wall_s": ls["wall_s"],
          "in_process_latency_s": ls["latency_s"],
          "engine_replica": erep, "engine_start_s": engine_start_s,
          "engine_stream_deltas": len(deltas) - 1, "engine_stream_tokens": len(toks),
          "engine_ttft_ms": ttft_ms, "engine_stream_s": stream_s,
          "engine_first_call_ttft_ms_and_s": first_call,
          "in_process_engine_ttft_ms": [t for t in inproc["LLMEngineServer"]["ttft_ms"]
                                        if t is not None],
          "in_process_engine_tokens_per_s": inproc["LLMEngineServer"]["tokens_per_s"],
          "replica_flash_launches": dict(launches), "card": card})
    if not all(equal):
        raise AssertionError(f"float32 replica tokens differ from the in-process server: {equal}")
    if min(batch_sizes) < 2:
        raise AssertionError(f"the replica's LLMServer did not batch: {batch_sizes}")
    if not (deltas and deltas[-1].get("done") and len(toks) == max_tokens
            and all(0 <= t < cfg.vocab_size for t in toks)):
        raise AssertionError(f"stream_deltas through the handle: {deltas[-1:]}, {len(toks)}")
    if erep["state"] != "RUNNING" or erep["resources"].get("GPU") != 1.0:
        raise AssertionError(f"engine replica {erep}")
    return dict(launches), len(res) * max_tokens / wall


# -------------------------------------------------------------- serve_disagg
SHARED_PREFIX = 256  # tokens the shared-prefix requests have in common
SHARED_SUFFIX = 32   # tokens each of them adds
N_SHARED = 8


def _disagg_probe_class():
    """DisaggLLMServer whose pool workers have one method more, ``probe``
    (what the worker sees: its card, its weights' device and dtype, the
    modules it loaded, its flash launches), and a replica method that
    probes every pool worker. build_disagg_deployment's config and
    arguments stay as they are."""
    from ray_tpu_torch.llm.disagg import DecodeWorker, DisaggLLMServer, PrefillWorker

    def probe(self):
        import torch

        from ray_tpu_torch import kernels

        params = self.params if isinstance(self, PrefillWorker) else self.engine.params
        leaf = params["tok"]["embedding"]
        return {"role": type(self).__name__, "pid": os.getpid(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "count": torch.cuda.device_count(), "weights_device": str(leaf.device),
                "weights_dtype": str(leaf.dtype).removeprefix("torch."),
                "foreign": _foreign_modules(), "launches": dict(kernels.launches())}

    class ProbedPrefillWorker(PrefillWorker):
        pass

    class ProbedDecodeWorker(DecodeWorker):
        pass

    ProbedPrefillWorker.probe = ProbedDecodeWorker.probe = probe

    class ProbedDisaggLLMServer(DisaggLLMServer):
        prefill_worker_cls = ProbedPrefillWorker
        decode_worker_cls = ProbedDecodeWorker

        async def probe(self):
            return await asyncio.gather(*[self._pool_call(w, "probe", (), {})
                                          for w in (*self.prefill_pool, *self.decode_pool)])

    return ProbedDisaggLLMServer


def phase_serve_disagg(card: str, prompts: list, readings: dict) -> dict:
    """build_disagg_deployment through serve.run on the runtime of phase
    runtime: one replica (it holds no card) fronting one prefill and two
    decode workers, each an actor leasing a third of the card and drawing
    its own seed-0 weights there. At 2 layers, float32, full width: the 6
    serving prompts, greedy, 32 tokens, through a handle and then through
    handle.stream (the second pass hits the prefix cache) give exactly the
    tokens of an in-process aggregated engine on the same weights. At 32
    layers, bf16: one warm-up request with the shared 256-token prefix,
    then the 6 prompts and 8 shared-prefix prompts (distinct 32-token
    suffixes) concurrently with routing_hint=prefix_hint(...): TTFT per
    request, wall time, tokens/s, the ship and adopt ms, bytes and GB/s
    and the prefix cache from stats(). Each pool worker must see
    CUDA_VISIBLE_DEVICES "0", hold its weights on cuda:0 in the model's
    dtype and load neither jax nor ray_tpu; every completion must be in
    range, with 0 duplicate prefills, a hit on more than half of the
    shared-prefix requests and kv_array_bytes > 50 x kv_driver_bytes.
    Serve is shut down at the end. Returns the pool workers' flash
    launches."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as serve_lib
    from ray_tpu_torch.llm.disagg import build_disagg_deployment, prefix_hint
    from ray_tpu_torch.llm.serving import resolve_params
    from ray_tpu_torch.models.llama import LlamaConfig

    max_tokens, PS = 32, 16
    kw = dict(n_prefill=1, n_decode=2, max_batch=4, page_size=PS, n_pages=512,
              max_seq_len=2048, prefix_cache_bytes=4 << 30)
    launches: collections.Counter = collections.Counter()

    def start(app_name, cfg):
        # num_gpus=0: the scheduler runs no model; each pool worker leases
        # 1/3 of the card (build_disagg_deployment's default on the card)
        app = _probed(build_disagg_deployment(cfg, num_gpus=0, **kw),
                      _disagg_probe_class())
        t0 = time.perf_counter()
        handle = serve_lib.run(app, name=app_name)
        return handle, time.perf_counter() - t0

    def check_workers(name, probes, dtype):
        roles = sorted(p["role"] for p in probes)
        if roles != ["ProbedDecodeWorker", "ProbedDecodeWorker", "ProbedPrefillWorker"]:
            raise AssertionError(f"{name} pool workers: {roles}")
        for p in probes:
            if (p["visible"] != "0" or p["count"] != 1 or p["foreign"]
                    or p["weights_device"] != "cuda:0" or p["weights_dtype"] != dtype):
                raise AssertionError(f"{name} pool worker: {p}")
            launches.update(p["launches"])

    def stop(app_name, handle):
        rt.get(handle.shutdown.remote(), timeout=120)  # the pools' leases go now
        serve_lib.delete(app_name)

    # 2 layers, float32, full width: token identity with the aggregated engine
    cfg32 = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype="float32")
    handle, start32 = start("serve_disagg_f32", cfg32)
    reqs = [{"prompt_tokens": q, "max_tokens": max_tokens} for q in prompts]
    t0 = time.perf_counter()
    got = [r["completion_tokens"] for r in rt.get([handle.remote(r) for r in reqs],
                                                   timeout=900)]
    first_call_s = time.perf_counter() - t0
    streamed, stream_cached = [], []
    for r in reqs:
        deltas = list(handle.stream.stream_chunks(dict(r)))
        streamed.append([t for d in deltas for t in d["tokens"]])
        stream_cached.append(deltas[-1]["usage"]["cached_prefix_tokens"]
                             if deltas and deltas[-1].get("done") else None)
    probes32 = rt.get(handle.probe.remote(), timeout=120)
    stats32 = rt.get(handle.stats.remote(), timeout=120)
    stop("serve_disagg_f32", handle)
    params32 = resolve_params(cfg32, device="cuda")  # the same seed-0 weights, here
    want, _, _, _ = serve(params32, cfg32, prompts, max_tokens)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    equal = {"call": [a == b for a, b in zip(got, want)],
             "stream": [a == b for a, b in zip(streamed, want)]}
    check_workers("float32", probes32, "float32")

    # 32 layers, bf16: the serving prompts and the shared-prefix set together
    cfg = LlamaConfig.llama3_8b()
    rng = np.random.default_rng(SEED + 13)
    shared = rng.integers(0, cfg.vocab_size, size=SHARED_PREFIX).tolist()
    suffixes = rng.integers(0, cfg.vocab_size, size=(N_SHARED + 1, SHARED_SUFFIX)).tolist()
    group = [shared + sfx for sfx in suffixes]
    handle, start_s = start("serve_disagg", cfg)

    def ask(qs):
        refs = [handle.options(routing_hint=prefix_hint(q, page_size=PS)).remote(
            {"prompt_tokens": q, "max_tokens": max_tokens}) for q in qs]
        return rt.get(refs, timeout=900)

    t0 = time.perf_counter()
    warm = ask(group[-1:])  # starts the pools' CUDA contexts, caches the prefix
    warm_s = time.perf_counter() - t0
    before = rt.get(handle.stats.remote(), timeout=120)
    mixed = prompts + group[:N_SHARED]
    t0 = time.perf_counter()
    res = ask(mixed)
    wall = time.perf_counter() - t0
    after = rt.get(handle.stats.remote(), timeout=120)
    probes = rt.get(handle.probe.remote(), timeout=120)
    stop("serve_disagg", handle)
    serve_lib.shutdown()
    gc.collect()
    torch.cuda.empty_cache()

    outs = [r["completion_tokens"] for r in res]
    kv0, kv1 = before["kv_plane"], after["kv_plane"]

    def delta(key):
        return kv1.get(key, 0) - kv0.get(key, 0)

    ships = delta("prefills") + delta("suffix_prefills")
    shared_hits = [r["usage"]["cached_prefix_tokens"] > 0 for r in res[len(prompts):]]
    n_tok = sum(len(o) for o in outs)
    emit({"phase": "serve_disagg", "f32_layers": 2, "f32_equal": equal,
          "f32_stream_cached_prefix_tokens": stream_cached, "f32_replica_start_s": start32,
          "f32_first_call_s": first_call_s, "f32_workers": probes32,
          "f32_duplicate_prefills": stats32["duplicate_prefills"],
          "layers": cfg.n_layers, "dtype": cfg.dtype, "pool": kw,
          "prompt_lens": [len(q) for q in mixed], "replica_start_s": start_s,
          "warmup_s": warm_s, "warmup_ttft_s": warm[0]["usage"]["ttft_s"],
          "requests": len(res), "wall_s": wall, "tokens_per_s": n_tok / wall,
          "ttft_s": [r["usage"]["ttft_s"] for r in res],
          "latency_s": [r["usage"]["latency_s"] for r in res],
          "cached_prefix_tokens": [r["usage"]["cached_prefix_tokens"] for r in res],
          "decode_worker": [r["usage"]["decode_worker"] for r in res],
          "shared_hit_rate": sum(shared_hits) / len(shared_hits),
          "ships": ships, "ship_ms": delta("ship_ns") / 1e6 / max(1, ships),
          "ship_bytes": delta("ship_bytes"),
          "ship_gb_per_s": delta("ship_bytes") / max(1, delta("ship_ns")),
          "adoptions": delta("adoptions"),
          "adopt_ms": delta("adopt_ns") / 1e6 / max(1, delta("adoptions")),
          "adopt_bytes": delta("adopt_bytes"),
          "adopt_gb_per_s": delta("adopt_bytes") / max(1, delta("adopt_ns")),
          "kv_array_bytes": kv1["kv_array_bytes"], "kv_driver_bytes": kv1["kv_driver_bytes"],
          "kv_plane": kv1, "prefix_cache": after["prefix_cache"],
          "duplicate_prefills": after["duplicate_prefills"],
          "decode_retries": after["decode_retries"], "backpressured": after["backpressured"],
          "decode_tokens": after["decode_tokens"], "workers": probes,
          "serve_run_handle_tokens_per_s": readings["serve_run_handle_tokens_per_s"],
          "serving_disagg_decode_tokens_per_s": readings["serving_disagg_decode_tokens_per_s"],
          "pool_flash_launches": dict(launches), "card": card})
    if not all(all(v) for v in equal.values()):
        raise AssertionError(f"float32 disagg through serve differs from the engine: {equal}")
    check_completions("serve_disagg", mixed, outs, cfg, max_tokens)
    check_workers("bf16", probes, "bfloat16")
    if after["duplicate_prefills"] != 0 or stats32["duplicate_prefills"] != 0:
        raise AssertionError(f"duplicate prefills: {after['duplicate_prefills']}, "
                             f"{stats32['duplicate_prefills']} (float32)")
    if not sum(shared_hits) / len(shared_hits) > 0.5:
        raise AssertionError(f"shared-prefix hits {shared_hits}")
    if not kv1["kv_array_bytes"] > 50 * kv1["kv_driver_bytes"]:
        raise AssertionError(f"kv bytes: array {kv1['kv_array_bytes']}, "
                             f"RPC {kv1['kv_driver_bytes']}")
    return dict(launches)


def _no_tf32():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _trainer_step(config, lr):
    """The train phase's step in a worker: Llama-3-8B width cut to
    ``config["layers"]``, bf16, remat, AdamW at ``lr``, weights and batch
    drawn from ``config["seed"]``, params placed by shard_pytree on the
    (one-rank) mesh. Returns (cfg, optimizer, params, state, step, batch)."""
    import torch

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
    opt = AdamW(lr)
    return cfg, opt, params, opt.init(params), make_train_step(cfg, opt, mesh=mesh), batch


def _run_steps(step, params, state, batch, warmup: int, steps: int, after_first=None,
               before_timed=None) -> dict:
    """``warmup`` then ``steps`` timed steps: every step's loss, each timed
    step's ms and flash launches (read here, from 0 at the first timed
    step), the launches over the timed steps, the peak memory from there,
    and the timed window's wall stamps. ``after_first(loss)`` runs after
    step 1, ``before_timed()`` before the first timed step."""
    import torch

    from ray_tpu_torch import kernels

    losses, step_ms, per_step = [], [], []
    start = None
    for i in range(warmup + steps):
        if i == warmup:  # the timed steps start here
            if before_timed is not None:
                before_timed()
            torch.cuda.reset_peak_memory_stats()
            kernels.LAUNCHES.clear()
            start = time.time()
        before = kernels.launches()
        (params, state, loss), ms = timed(lambda: step(params, state, batch))
        now = kernels.launches()
        losses.append(float(loss))
        if i >= warmup:
            step_ms.append(ms)
            per_step.append({n: now[n] - before[n] for n in kernels.KERNELS})
        if i == 0 and after_first is not None:
            after_first(losses[0])
    return {"losses": losses, "step_ms": step_ms, "launches_per_step": per_step,
            "launches": dict(kernels.launches()),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "window": [start, time.time()], "params": params, "state": state}


def trainer_loop(config):
    """The train phase's step in a worker (``_trainer_step``, lr 1e-4):
    warm-up and timed steps, the flash launches of each step read here, in
    the worker; then the step with and without the mesh, and the collective
    API on the worker's NCCL group."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.llama import make_train_step

    cfg, opt, params, state, step, batch = _trainer_step(config, 1e-4)
    run = _run_steps(step, params, state, batch, TRAINER_WARMUP, config["steps"],
                     after_first=lambda loss: train.report({"step": 1, "loss": loss,
                                                            "t": time.time()}))
    params, state = run.pop("params"), run.pop("state")
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
    train.report({**run, "attribution_ms": arms, "attribution_enqueue_ms": enqueue,
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
    configuration A, then the trainer arm's two workers sharing it, then the
    sharded arm."""
    from ray_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(1)
    emit({"phase": "dryrun", "n_devices": 1, "seconds": time.perf_counter() - t0,
          "card": card})


# --------------------------------------------------------------------- data
DATA_BLOCKS = 7  # blocks of the data_trainer dataset
DATA_MAX_TOKENS = 32  # data_batch: new tokens a row


def data_trainer_loop(config):
    """The train phase's step (8 layers, bf16, remat, AdamW lr 1e-4, weights
    drawn from the train phase's seed) on each batch this rank pulls from
    its streaming_split iterator; the flash launches of each step, the
    wait for each batch and the group's rendezvous seconds, read here, in
    the worker."""
    import torch

    from ray_tpu_torch import collective, kernels, train
    from ray_tpu_torch.models.llama import AdamW, LlamaConfig, llama_init, make_train_step

    _no_tf32()
    ctx = train.get_context()
    it = config["splits"][ctx.get_world_rank()]
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=config["layers"])
    params = llama_init(torch.Generator(device="cuda").manual_seed(config["seed"]), cfg, "cuda")
    opt = AdamW(1e-4)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    losses, step_ms, wait_ms, per_step, batch_bytes, rows = [], [], [], [], [], 0
    kernels.LAUNCHES.clear()
    batches = iter(it.iter_batches(batch_size=2))
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(batches)["data"]
        except StopIteration:
            break
        tokens = torch.from_numpy(batch).cuda()
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        rows += batch.shape[0]
        batch_bytes.append(batch.nbytes)
        before = kernels.launches()
        (params, state, loss), ms = timed(lambda: step(params, state, {"tokens": tokens}))
        now = kernels.launches()
        per_step.append({n: now[n] - before[n] for n in kernels.KERNELS})
        losses.append(float(loss))
        step_ms.append(ms)
        if len(losses) == 1:
            train.report({"step": 1, "loss": losses[0], "t": time.time()})
    group = collective.get_group_handle(ctx.collective_group)
    train.report({"losses": losses, "step_ms": step_ms, "batch_wait_ms": wait_ms,
                  "launches_per_step": per_step, "launches": dict(kernels.launches()),
                  "rows": rows, "batch_bytes": batch_bytes, "dtype": str(batch.dtype),
                  "rendezvous_s": group.rendezvous_s,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "device": torch.cuda.get_device_name(0)})


def phase_data_trainer(card: str, train_losses: list, train_tokens) -> dict:
    """ray_tpu_torch.data feeding a TorchTrainer: the train phase's batch
    repeated once per train phase step (warm-up and timed), streamed to one
    NCCL worker through streaming_split(1); its losses must follow the train
    phase's step by step (exactly, or within 1e-6 relative; printed which),
    8/8/8 launches each step. Returns the worker's launches."""
    import statistics
    import tempfile

    import numpy as np

    import ray_tpu_torch.data as rtd

    rows = np.tile(train_tokens, (len(train_losses), 1))  # int64 [42, 2049]
    ds = rtd.from_numpy(rows, parallelism=DATA_BLOCKS)
    splits = ds.streaming_split(1)
    with tempfile.TemporaryDirectory() as tmp:
        result, t0 = _fit(data_trainer_loop, {"layers": 8, "seed": SEED + 2, "splits": splits},
                          tmp, num_workers=1)
    first, final = result.metrics_history[0], result.metrics_history[-1]
    losses, step_ms = final["losses"], final["step_ms"]
    pairs = list(zip(losses, train_losses))
    rel = max(abs(a - b) / abs(b) for a, b in pairs)
    want = {n: 8 for n in final["launches"]}
    emit({"phase": "data_trainer", "workers": 1, "backend": "nccl", "layers": 8,
          "dataset": {"rows": list(rows.shape), "dtype": str(rows.dtype), "blocks": DATA_BLOCKS,
                      "bytes": rows.nbytes},
          "rows_received": final["rows"], "batch_bytes": final["batch_bytes"][0],
          "batch_bytes_against_dataset": final["batch_bytes"][0] / rows.nbytes,
          "batches": len(final["batch_bytes"]), "batch_dtype": final["dtype"],
          "losses": losses, "train_phase_losses": train_losses, "steps_compared": len(pairs),
          "trajectory_exact": rel == 0.0, "trajectory_max_rel_diff": rel,
          "trajectory_tol": 1e-6, "step_ms": step_ms,
          "step_ms_median": statistics.median(step_ms[1:]),
          "batch_wait_ms": final["batch_wait_ms"],
          "batch_wait_ms_median": statistics.median(final["batch_wait_ms"]),
          "launches_per_step": final["launches_per_step"][0],
          "seconds_fit_to_first_report": first["t"] - t0,
          "rendezvous_s": final["rendezvous_s"],
          "max_memory_allocated": final["max_memory_allocated"],
          "worker_device": final["device"], "card": card})
    if final["rows"] != rows.shape[0] or final["dtype"] != "int64":
        raise AssertionError(f"the worker got {final['rows']} {final['dtype']} rows of "
                             f"{rows.shape[0]}")
    if any(c != want for c in final["launches_per_step"]) or len(want) != 3:
        raise AssertionError(f"data_trainer kernel launches {final['launches_per_step']}")
    if len(pairs) != len(train_losses) or not rel <= 1e-6:
        raise AssertionError(f"data_trainer losses {losses} do not follow the train phase's "
                             f"{train_losses}")
    if final["rendezvous_s"] is None:
        raise AssertionError("the worker's group did not meet through the GCS KV")
    return final["launches"]


# ------------------------------------------------------------------ tune
TUNE_LRS = (1e-4, 3e-4)  # tune_trainer's grid: the train phase's lr and 3x
TUNE_WARMUP = 2
TUNE_STEPS = 4  # timed steps a trial, both trials' workers stepping at once
TUNE_MEET_S = 300  # a trial's worker waits this long for the other's


def tune_trainer_loop(config):
    """The trainer phase's step (``_trainer_step``) at the trial's lr, in
    the trial's worker: TUNE_WARMUP warm-up and TUNE_STEPS timed steps,
    each timed step's flash launches read here. Before its timed steps the
    worker checks in under ``config["rendezvous"]`` and waits until every
    trial's worker has, so the timed windows are of trials sharing the
    card (trials run one after another would time out)."""
    import torch

    from ray_tpu_torch import train

    def meet():
        open(os.path.join(config["rendezvous"], f"{config['lr']!r}"), "w").close()
        deadline = time.monotonic() + TUNE_MEET_S
        while len(os.listdir(config["rendezvous"])) < config["trials"]:
            if time.monotonic() > deadline:
                raise TimeoutError("the other trial's worker never reached its timed steps")
            time.sleep(0.01)

    first = {}
    _, _, params, state, step, batch = _trainer_step(config, config["lr"])
    run = _run_steps(step, params, state, batch, TUNE_WARMUP, TUNE_STEPS,
                     after_first=lambda loss: first.setdefault("t", time.time()),
                     before_timed=meet)
    del run["params"], run["state"]
    train.report({**run, "loss": run["losses"][-1], "t_first": first["t"],
                  "pid": os.getpid(), "device": torch.cuda.get_device_name(0)})


def _sample_free_memory(samples: list, stop):
    """(wall time, the card's free bytes) every 0.25 s until ``stop`` is set."""
    import torch

    while not stop.wait(0.25):
        samples.append((time.time(), torch.cuda.mem_get_info()[0]))


def phase_tune_trainer(card: str, train_losses: list) -> dict:
    """Tuner over a TorchTrainer on the runtime: a grid of two learning
    rates (TUNE_LRS), two trials at once, each a trial actor (no card) whose
    fit() runs one worker leasing half the card (GPU 0.5, NCCL at world
    size 1). Both trials must end TERMINATED with 8/8/8 launches every
    timed step in their workers and equal step-1 losses; the 1e-4 trial's
    losses must follow the train phase's (exactly, or within 1e-6
    relative), the 3e-4 trial's later losses must differ; the best result
    is the trial with the lower final loss; the timed windows overlap.
    Returns both workers' launches over their timed steps."""
    import statistics
    import tempfile
    import threading
    import types

    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=_sample_free_memory, args=(samples, stop), daemon=True)
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        os.makedirs(rendezvous)
        trainer = TorchTrainer(
            tune_trainer_loop,
            train_loop_config={"layers": 8, "seed": SEED + 2, "rendezvous": rendezvous,
                               "trials": len(TUNE_LRS)},
            scaling_config=ScalingConfig(use_gpu=True, resources_per_worker={"GPU": 0.5}),
            run_config=RunConfig(storage_path=os.path.join(tmp, "runs")))
        sampler.start()
        t0 = time.time()
        try:
            grid = tune.Tuner(
                trainer,
                param_space={"train_loop_config": {"lr": tune.grid_search(list(TUNE_LRS))}},
                tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=2),
                run_config=types.SimpleNamespace(storage_path=os.path.join(tmp, "tune"),
                                                 name="tune_trainer")).fit()
        finally:
            stop.set()
            sampler.join(timeout=5)
        seconds = time.time() - t0
    trials = {r.config["train_loop_config"]["lr"]: r for r in grid}
    errors = {lr: r.error for lr, r in trials.items() if r.error}
    if errors or sorted(trials) != sorted(TUNE_LRS):
        raise AssertionError(f"tune_trainer trials failed: {errors or list(trials)}")
    m = {lr: r.metrics for lr, r in trials.items()}
    lo, hi = (m[lr] for lr in TUNE_LRS)
    windows = [m[lr]["window"] for lr in TUNE_LRS]
    both_up = [max(w[0] for w in windows), min(w[1] for w in windows)]
    free_both = [f for t, f in samples if both_up[0] <= t <= both_up[1]]
    pairs = list(zip(lo["losses"], train_losses))
    rel = max(abs(a - b) / abs(b) for a, b in pairs)
    best = grid.get_best_result()
    want = {n: 8 for n in lo["launches_per_step"][0]}
    emit({"phase": "tune_trainer", "trials": len(grid), "lrs": list(TUNE_LRS),
          "statuses": {lr: r.status for lr, r in trials.items()},
          "gpu_per_worker": 0.5, "layers": 8, "tokens": [2, 2049],
          "warmup": TUNE_WARMUP, "timed_steps": TUNE_STEPS,
          "losses": {lr: m[lr]["losses"] for lr in TUNE_LRS},
          "train_phase_losses": train_losses[:len(lo["losses"])],
          "trajectory_exact": rel == 0.0, "trajectory_max_rel_diff": rel, "trajectory_tol": 1e-6,
          "step_ms": {lr: m[lr]["step_ms"] for lr in TUNE_LRS},
          "step_ms_median": {lr: statistics.median(m[lr]["step_ms"]) for lr in TUNE_LRS},
          "seconds_fit_to_first_report": {lr: m[lr]["t_first"] - t0 for lr in TUNE_LRS},
          "max_memory_allocated": {lr: m[lr]["max_memory_allocated"] for lr in TUNE_LRS},
          "mem_free_both_trials_min": min(free_both) if free_both else None,
          "mem_free_samples_both_up": len(free_both),
          "timed_windows": windows, "both_up_s": both_up[1] - both_up[0],
          "launches_per_step": {lr: m[lr]["launches_per_step"] for lr in TUNE_LRS},
          "worker_pids": {lr: m[lr]["pid"] for lr in TUNE_LRS},
          "best_lr": best.config["train_loop_config"]["lr"], "seconds": seconds,
          "worker_device": lo["device"], "card": card})
    if any(r.status != "TERMINATED" for r in grid):
        raise AssertionError(f"tune_trainer statuses {[r.status for r in grid]}")
    for lr in TUNE_LRS:
        steps = m[lr]["launches_per_step"]
        if len(steps) != TUNE_STEPS or any(c != want for c in steps) or len(want) != 3:
            raise AssertionError(f"tune_trainer lr {lr}: kernel launches {steps}")
    if lo["losses"][0] != hi["losses"][0]:
        raise AssertionError(f"step-1 losses differ: {lo['losses'][0]} {hi['losses'][0]}")
    if not rel <= 1e-6:
        raise AssertionError(f"the lr {TUNE_LRS[0]} trial's losses {lo['losses']} do not "
                             f"follow the train phase's {train_losses[:len(pairs)]}")
    if any(a == b for a, b in zip(lo["losses"][1:], hi["losses"][1:])):
        raise AssertionError(f"the lr {TUNE_LRS[1]} trial's later losses equal the lr "
                             f"{TUNE_LRS[0]} trial's: {hi['losses']}")
    if best.metrics["loss"] != min(lo["loss"], hi["loss"]) or best.status != "TERMINATED":
        raise AssertionError(f"get_best_result() gave {best}")
    if not both_up[0] < both_up[1]:
        raise AssertionError(f"the trials' timed windows do not overlap: {windows}")
    total = collections.Counter()
    for lr in TUNE_LRS:
        total.update(m[lr]["launches"])
    return dict(total)


# ---------------------------------------------------------------- workflow
def _wf_ran(log_dir: str, step: str) -> None:
    """Mark one run of a workflow step (a file a run, named by step and pid)."""
    open(os.path.join(log_dir, f"{step}-{os.getpid()}-{time.time_ns()}"), "w").close()


def wf_make_tokens(rows, log_dir):
    """The workflow's first step, on the host CPU: the forward phase's token
    rows (host int64 [2, 2049]) as the model's inputs [2, 2048], a CPU
    tensor. (Their draw needs the card's generator after the weights'
    draw, so the rows come in as the step's argument.)"""
    import torch

    _wf_ran(log_dir, "make_tokens")
    return torch.from_numpy(rows[:, :-1].copy())


def wf_score(tokens, log_dir, marker=None):
    """The workflow's card step (it leases the whole card): in this task's
    worker, the seed-0 Llama-3-8B weights drawn here and one 32-layer bf16
    llama_forward of ``tokens`` through the flash forward kernel, its
    launches counted here from 0. Returns the last position's logits as a
    CUDA tensor, with the launches and this process's pid. With a
    ``marker`` that does not exist yet, the first attempt's worker dies
    (after creating it): the runtime runs the step again."""
    if marker is not None and not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(1)
    import torch

    from ray_tpu_torch import kernels
    from ray_tpu_torch.models.llama import LlamaConfig, llama_forward, llama_init

    _wf_ran(log_dir, "score")
    _no_tf32()
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama_init(torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kernels.LAUNCHES.clear()
    with torch.inference_mode():
        (logits, _), ms = timed(lambda: llama_forward(params, tokens.cuda(), cfg,
                                                      attn_impl="auto"))
        last = logits[:, -1].float().clone()
    return {"logits": last, "launches": dict(kernels.launches()), "pid": os.getpid(),
            "init_s": init_s, "forward_ms": ms}


def wf_summarize(scored, log_dir):
    """The workflow's last step: host arithmetic on the logits (each row's
    argmax and a float64 checksum). Its argument holds a CUDA tensor, which
    the runtime restores on this process's card, so the step leases a
    tenth of the card to cover that read. Passes the logits and the score
    step's readings on as the workflow's output."""
    _wf_ran(log_dir, "summarize")
    host = scored["logits"].cpu()
    return {"tokens": host.argmax(-1).tolist(), "checksum": float(host.double().sum()),
            "logits": scored["logits"], "score": {k: v for k, v in scored.items()
                                                  if k != "logits"}}


def _wf_dag(workflow, rows, log_dir, marker=None):
    make = workflow.step(wf_make_tokens, name="make_tokens")
    score = workflow.step(wf_score, name="score", resources={"GPU": 1.0}, max_retries=1)
    summarize = workflow.step(wf_summarize, name="summarize", resources={"GPU": 0.1})
    return summarize.bind(score.bind(make.bind(rows, log_dir), log_dir, marker), log_dir)


def phase_workflow(card: str, forward_rows, forward_last) -> dict:
    """A three-step durable workflow on the runtime (make_tokens on the
    host CPU, score leasing the card, summarize leasing a tenth of it to
    read score's CUDA tensor): score's 32 flash launches,
    counted in its task; the logits within 1e-6 relative L2 of the forward
    phase's last position (the same ops, weights and card); resume()
    returning the same output from storage with no step run and no launch;
    and a second workflow whose score's first worker dies, run again
    (max_retries=1), giving the same output. Returns score's launches."""
    import tempfile

    import torch

    from ray_tpu_torch import kernels, workflow

    def runs(log_dir):
        return collections.Counter(f.split("-")[0] for f in os.listdir(log_dir))

    def same(a, b):
        return (a["tokens"] == b["tokens"] and a["checksum"] == b["checksum"]
                and torch.equal(a["logits"], b["logits"]))

    with tempfile.TemporaryDirectory() as tmp:
        saved = os.environ.get(workflow.api.STORAGE_ENV)
        os.environ[workflow.api.STORAGE_ENV] = os.path.join(tmp, "workflows")
        logs = {name: os.path.join(tmp, name) for name in ("first", "retry")}
        for d in logs.values():
            os.makedirs(d)
        try:
            t0 = time.perf_counter()
            out = workflow.run(_wf_dag(workflow, forward_rows, logs["first"]),
                               workflow_id="score")
            run_s = time.perf_counter() - t0
            before = runs(logs["first"])
            kernels.LAUNCHES.clear()
            t0 = time.perf_counter()
            again = workflow.resume("score")
            resume_s = time.perf_counter() - t0
            resume_launches = dict(kernels.launches())
            after = runs(logs["first"])
            t0 = time.perf_counter()
            retried = workflow.run(_wf_dag(workflow, forward_rows, logs["retry"],
                                           os.path.join(tmp, "marker")),
                                   workflow_id="score_retry")
            retry_s = time.perf_counter() - t0
            retry_runs = runs(logs["retry"])
            first_attempt_died = os.path.exists(os.path.join(tmp, "marker"))
            status = {w: workflow.get_status(w) for w in ("score", "score_retry")}
        finally:
            if saved is None:
                os.environ.pop(workflow.api.STORAGE_ENV, None)
            else:
                os.environ[workflow.api.STORAGE_ENV] = saved
    rel = rel_l2(out["logits"], forward_last)
    launches = out["score"]["launches"]
    emit({"phase": "workflow", "steps": ["make_tokens", "score", "summarize"],
          "layers": 32, "dtype": "bfloat16", "tokens": list(forward_rows[:, :-1].shape),
          "score_launches": launches, "logits": list(out["logits"].shape),
          "logits_device": str(out["logits"].device),
          "logits_rel_l2_vs_forward": rel, "tol": 1e-6, "bitwise": rel == 0.0,
          "argmax": out["tokens"], "checksum": out["checksum"],
          "score_init_s": out["score"]["init_s"], "score_forward_ms": out["score"]["forward_ms"],
          "run_s": run_s, "step_runs": dict(before), "resume_s": resume_s,
          "resume_step_runs": dict(after - before), "resume_launches": resume_launches,
          "resume_same_output": same(out, again),
          "retry_s": retry_s, "retry_step_runs": dict(retry_runs),
          "retry_first_attempt_died": first_attempt_died,
          "retry_score_pid": retried["score"]["pid"], "retry_launches": retried["score"]["launches"],
          "retry_same_output": same(out, retried), "statuses": status, "card": card})
    if launches.get("flash_attention_fwd") != 32 or sum(launches.values()) != 32:
        raise AssertionError(f"score's flash launches {launches}, want 32 forward")
    if out["logits"].device.type != "cuda" or not rel <= 1e-6:
        raise AssertionError(f"score's logits on {out['logits'].device}, rel L2 {rel} against "
                             "the forward phase's")
    if after != before or any(resume_launches.values()) or not same(out, again):
        raise AssertionError(f"resume ran steps {dict(after - before)}, launched "
                             f"{resume_launches}, or changed the output")
    if not first_attempt_died or retry_runs["score"] != 1 or not same(out, retried) or \
            set(status.values()) != {"SUCCESSFUL"}:
        raise AssertionError(f"the retried workflow: runs {dict(retry_runs)}, statuses {status}")
    return launches


def processor_rows(vocab: int) -> list:
    """8 rows of 64-token prompts (the processor's numpy batch format needs
    equal lengths), drawn from serving_server's generator after its
    LLMServer prompts."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    for n in (24, 60, 130, 200, 256, 333, 400, 512):
        rng.integers(0, vocab, size=n)
    return [{"prompt_tokens": rng.integers(0, vocab, size=64).tolist(), "id": i}
            for i in range(8)]


def worker_probe(batch: dict, generate_rows: list) -> dict:
    """The task's or actor's pid, the rows of each generate call it made
    for this block, and the flash launches it made for it, on every row
    of its output."""
    import numpy as np

    from ray_tpu_torch import kernels

    n = len(batch["id"])
    calls = np.asarray(generate_rows, dtype=np.int64)
    out = dict(batch, pid=np.full(n, os.getpid()),
               generate_rows=np.broadcast_to(calls, (n, len(calls))).copy())
    for name, c in kernels.launches().items():
        out[f"launches_{name}"] = np.full(n, c)
    return out


class ProbedDataset:
    """A dataset whose map_batches wraps the mapped function (the
    processor's map) in its own task: the task first clears its process's
    flash launch counts and generate calls, then runs the map, then
    stamps what that block took on its rows (worker_probe)."""

    def __init__(self, ds):
        self.ds = ds

    def map_batches(self, fn, **kwargs):
        def probed(batch, _fn=fn):
            from ray_tpu_torch import kernels
            from ray_tpu_torch.llm import batch as llm_batch

            kernels.LAUNCHES.clear()
            llm_batch.GENERATE_BATCHES.clear()
            out = _fn(batch)
            return worker_probe(out, list(llm_batch.GENERATE_BATCHES))

        return self.ds.map_batches(probed, **kwargs)


class ProcessorMap:
    """build_llm_processor's map as a callable class for an actor pool: the
    worker draws the seed-0 weights once (the processor's cache) and runs
    one generate call on each batch, whose rows carry what worker_probe
    reads for the block."""

    def __init__(self, cfg, max_new_tokens):
        self.cfg = cfg
        self.max_new_tokens = max_new_tokens

    def __call__(self, batch):
        from ray_tpu_torch import kernels
        from ray_tpu_torch.llm import batch as llm_batch
        from ray_tpu_torch.llm import generation

        params = llm_batch._cached_params(self.cfg)
        kernels.LAUNCHES.clear()
        prompts = [list(map(int, row)) for row in batch["prompt_tokens"]]
        outs = generation.generate(params, self.cfg, prompts,
                                   max_new_tokens=self.max_new_tokens, temperature=0.0)
        return worker_probe(dict(batch, completion_tokens=outs), [len(prompts)])


DATA_BATCH_COPIES = 3  # data_batch: the 8 prompts 3 times at 32 layers (3 blocks of 8)


def phase_data_batch(card: str) -> dict:
    """build_llm_processor over ray_tpu_torch.data on the runtime's task
    workers (params=None: the worker draws its seed-0 weights on the card;
    each task leases the card, so one runs at a time). At 2 layers,
    float32, one block of 8 rows whose tokens equal the driver's generate
    with the same init; at 32 layers, bf16, 24 rows in 3 blocks, then the
    same map on an actor pool of 1 whose tokens equal the tasks'. Every
    block must come from one generate call over its 8 rows. Returns the
    flash launches the blocks' tasks made (0), each block's read in its
    task after clearing the counts at its start."""
    import numpy as np
    import torch

    import ray_tpu_torch.data as rtd
    from ray_tpu_torch.llm import build_llm_processor, generate
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    def stream(ds):
        """(the blocks' rows, seconds to the first block, wall seconds)."""
        t0, first, blocks = time.perf_counter(), None, []
        for block in ds.iter_blocks():
            first = first if first is not None else time.perf_counter() - t0
            blocks.append(list(rtd.BlockAccessor.for_block(block).rows()))
        return blocks, first, time.perf_counter() - t0

    def check_blocks(what, blocks, n_blocks):
        """Every block holds 8 rows, made by one generate call over them
        in one process; each kernel's launches summed over the blocks."""
        sizes = [len(b) for b in blocks]
        calls = [sorted({tuple(int(x) for x in r["generate_rows"]) for r in b}) for b in blocks]
        if sizes != [8] * n_blocks or calls != [[(8,)]] * n_blocks:
            raise AssertionError(f"{what}: blocks of {sizes} rows from generate calls {calls}")
        if any(len({int(r["pid"]) for r in b}) != 1 for b in blocks):
            raise AssertionError(f"{what}: a block's rows come from more than one process")
        total = collections.Counter()
        for b in blocks:
            total.update({n.removeprefix("launches_"): int(b[0][n])
                          for n in b[0] if n.startswith("launches_")})
        return dict(total)

    # this process's cached blocks go back first, so that the card's free
    # memory shows what the data workers take
    driver_reserved = torch.cuda.memory_reserved()
    gc.collect()
    torch.cuda.empty_cache()
    driver_kept = torch.cuda.memory_reserved()
    free_before, total_mem = torch.cuda.mem_get_info()
    cfg = LlamaConfig.llama3_8b()
    rows = processor_rows(cfg.vocab_size)
    prompts = [r["prompt_tokens"] for r in rows]

    # float32, 2 layers at full width: the task's tokens against the driver's
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    proc32 = build_llm_processor(cfg32, batch_size=8, max_new_tokens=DATA_MAX_TOKENS)
    blocks32, _, wall32 = stream(proc32(ProbedDataset(rtd.from_items(rows))))
    out32 = [r for b in blocks32 for r in b]
    params32 = llama_init(torch.Generator(device="cuda").manual_seed(0), cfg32, "cuda")
    want32 = generate(params32, cfg32, prompts, max_new_tokens=DATA_MAX_TOKENS)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    same32 = [r["completion_tokens"].tolist() == w for r, w in zip(out32, want32)]

    # bf16, 32 layers: 24 rows in 3 blocks on task workers, then an actor pool
    rows_n = [dict(r, id=i) for i, r in enumerate(rows * DATA_BATCH_COPIES)]
    n_blocks = len(rows_n) // 8
    proc = build_llm_processor(cfg, batch_size=8, max_new_tokens=DATA_MAX_TOKENS)
    blocks, first_s, wall = stream(proc(ProbedDataset(rtd.from_items(rows_n))))
    out = [r for b in blocks for r in b]
    free_mid = torch.cuda.mem_get_info()[0]
    pool_blocks, pool_first_s, pool_wall = stream(rtd.from_items(rows_n).map_batches(
        ProcessorMap, batch_size=8, compute=rtd.ActorPoolStrategy(size=1), num_gpus=1,
        fn_constructor_args=(cfg, DATA_MAX_TOKENS)))
    pooled = [r for b in pool_blocks for r in b]
    free_after = torch.cuda.mem_get_info()[0]
    task_tokens = [r["completion_tokens"].tolist() for r in out]
    pool_tokens = [r["completion_tokens"].tolist() for r in pooled]
    task_pids = sorted({int(r["pid"]) for r in out})
    pool_pids = sorted({int(r["pid"]) for r in pooled})
    n_tokens = sum(len(t) for t in task_tokens)
    readings = {"phase": "data_batch", "rows_f32": len(out32), "f32_equal_generate": same32,
                "f32_wall_s": wall32, "f32_blocks": [len(b) for b in blocks32],
                "rows": len(out), "blocks": [len(b) for b in blocks],
                "generate_calls": [sorted({tuple(int(x) for x in r["generate_rows"])
                                           for r in b}) for b in blocks],
                "layers": cfg.n_layers, "dtype": cfg.dtype,
                "max_new_tokens": DATA_MAX_TOKENS, "tokens": n_tokens,
                "tokens_per_s": n_tokens / wall, "seconds_to_first_block": first_s,
                "wall_s": wall, "task_worker_pids": task_pids,
                "f32_worker_pids": sorted({int(r["pid"]) for r in out32}),
                "pool_rows": len(pooled), "pool_blocks": [len(b) for b in pool_blocks],
                "pool_tokens_per_s": n_tokens / pool_wall,
                "pool_seconds_to_first_block": pool_first_s, "pool_wall_s": pool_wall,
                "pool_worker_pids": pool_pids, "pool_equal_tasks": pool_tokens == task_tokens,
                "driver_reserved_before": driver_reserved,
                "driver_reserved_after_release": driver_kept,
                "mem_free_before": free_before, "mem_free_after_tasks": free_mid,
                "mem_free_after_pool": free_after, "mem_total": total_mem, "card": card}
    try:
        flash = {"f32": check_blocks("f32 tasks", blocks32, 1),
                 "tasks": check_blocks("bf16 tasks", blocks, n_blocks),
                 "pool": check_blocks("actor pool", pool_blocks, n_blocks)}
    finally:
        emit(readings)
    total = collections.Counter()
    for c in flash.values():
        total.update(c)
    emit({"phase": "data_batch", "flash_launches": flash})
    if len(out32) != len(rows) or not all(same32):
        raise AssertionError(f"f32 processor tokens differ from generate: {same32}")
    if [int(r["id"]) for r in out] != list(range(len(rows_n))):
        raise AssertionError(f"the bf16 processor returned {len(out)} rows")
    check_completions("data_batch", [r["prompt_tokens"] for r in out], task_tokens, cfg,
                      DATA_MAX_TOKENS)
    if pool_tokens != task_tokens or len(pool_pids) != 1:
        raise AssertionError(f"the actor pool's rows differ from the tasks' (pids {pool_pids})")
    if any(total.values()):
        raise AssertionError(f"flash launches in the data workers: {flash}")
    return dict(total)


# ------------------------------------------------------------------ job_cli
# The operator's path: a cluster started by `python -m ray_tpu_torch start
# --head` (the raylet counts the card itself), the `dashboard` command, a
# job sent through JobSubmissionClient over its REST API, read back through
# the CLI and the dashboard, a second job stopped over REST, and `stop`.
JOB_CLI_WAIT_S = 300  # the card job: a worker's start, a 16 GB draw, one forward

JOB_CLI_DRIVER = """\
import json, os, sys

import numpy as np

import chip_smoke
import ray_tpu_torch

ray_tpu_torch.init()  # joins the job's cluster through RT_ADDRESS
score = ray_tpu_torch.remote(num_gpus=1)(chip_smoke.job_cli_score)
out = ray_tpu_torch.get(score.remote(sys.argv[1]), timeout=600)
logits = out.pop("logits")
np.save(sys.argv[2], logits)
torch = sys.modules.get("torch")
print(json.dumps({**out, "checksum": float(logits.astype(np.float64).sum()),
                  "driver_pid": os.getpid(), "driver_torch_imported": torch is not None,
                  "driver_cuda_initialized": bool(torch is not None
                                                  and torch.cuda.is_initialized()),
                  "driver_libcuda_mapped": chip_smoke._libcuda_mapped(os.getpid())}),
      flush=True)
ray_tpu_torch.shutdown()
"""


def job_cli_score(rows_path: str) -> dict:
    """The job's card task (it leases the whole card): the seed-0 Llama-3-8B
    weights drawn in this task's worker and one 32-layer bf16 llama_forward
    of the forward phase's tokens through the flash forward kernel, its
    launches counted here from 0. Returns the last position's logits as host
    float32 numpy, the launches, this worker's pid, node and card, the
    task's start (host clock), the weight draw's seconds and the forward's
    ms."""
    started_at = time.time()
    import numpy as np
    import torch

    from ray_tpu_torch import kernels
    from ray_tpu_torch.models.llama import LlamaConfig, llama_forward, llama_init

    _no_tf32()
    tokens = torch.from_numpy(np.load(rows_path)[:, :-1].copy())
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama_init(torch.Generator(device="cuda").manual_seed(SEED), cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kernels.LAUNCHES.clear()
    with torch.inference_mode():
        (logits, _), ms = timed(lambda: llama_forward(params, tokens.cuda(), cfg,
                                                      attn_impl="auto"))
        last = logits[:, -1].float().cpu().numpy()
    return {"logits": last, "launches": dict(kernels.launches()), "task_pid": os.getpid(),
            "node_id": os.environ.get("RT_NODE_ID"), "started_at": started_at,
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "init_s": init_s,
            "forward_ms": ms, "foreign": _foreign_modules()}


def _free_card_bytes() -> int:
    import torch

    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def _libcuda_mapped(pid: int, lib: str = "libcuda.so") -> bool:
    """Whether the CUDA driver library (or ``lib``) is mapped into process
    ``pid``."""
    with open(f"/proc/{pid}/maps") as f:
        return lib in f.read()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def phase_job_cli(card: str, forward_rows, forward_last) -> dict:
    """The operator's path on the card, with no runtime of the script's own:
    `start --head` (no --num-gpus) under a fresh TMPDIR, `status` showing
    GPU 1/1 and accelerator_type:H100, the `dashboard` command, a job through
    JobSubmissionClient whose driver runs job_cli_score as a num_gpus=1
    task, read back through REST, `job list`, `list actors`, the job's logs,
    /api/tasks, /api/timeline and /metrics; a sleeping job stopped over
    REST; `stop`. The job SUCCEEDED with 32 forward launches in its task,
    logits within 1e-6 relative L2 of the forward phase's last position
    (``forward_last``, host float32), no CUDA in the driver, the second job
    STOPPED, the session's processes gone and the card's free memory back
    within 1 GiB. Returns the task's launches."""
    import shutil
    import socket
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from ray_tpu_torch.job import JobSubmissionClient

    here = os.path.dirname(os.path.abspath(__file__))
    secs, free = {}, {}
    tmp = tempfile.mkdtemp(prefix="rtt_job_cli_")
    env = {k: v for k, v in os.environ.items() if k not in ("RT_ADDRESS", "PYTHONPATH")}
    env.update(TMPDIR=tmp, PYTHONPATH=here)

    def cli(*args, timeout=120, check=True):
        out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], cwd=here, env=env,
                             capture_output=True, text=True, timeout=timeout)
        if check and out.returncode != 0:
            raise AssertionError(f"`{' '.join(args)}` exited {out.returncode}: {out.stderr}")
        return out.stdout

    def until(what, fn, timeout):
        deadline = time.monotonic() + timeout
        while True:
            v = fn()
            if v:
                return v
            if time.monotonic() > deadline:
                raise AssertionError(f"job_cli: {what} after {timeout} s")
            time.sleep(0.1)

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.read()

    def step(name, t0):
        secs[name] = time.perf_counter() - t0
        return time.perf_counter()

    rows_path, logits_path = os.path.join(tmp, "tokens.npy"), os.path.join(tmp, "logits.npy")
    np.save(rows_path, forward_rows)
    driver = os.path.join(tmp, "driver.py")
    with open(driver, "w") as f:
        f.write(JOB_CLI_DRIVER)
    free["before_start"] = _free_card_bytes()
    dash, pids = None, []
    t = t_phase = time.perf_counter()
    try:
        out = cli("start", "--head", "--num-cpus", "8")
        address = [ln for ln in out.splitlines() if "started at" in ln][0].split()[-1]
        with open(os.path.join(tmp, "ray_tpu_torch", "session.json")) as f:
            pids = json.load(f)["pids"]
        t = step("start", t)
        # `status` waits up to 30 s for a raylet to register (the raylet
        # imports torch to count the cards first); past that it fails and
        # is asked again
        status = until("status never showed the node", lambda: (
            lambda s: s if "nodes: 1" in s else None)(
            cli("status", "--address", address, check=False)), 120)
        t = step("status", t)
        free["node_registered"] = _free_card_bytes()
        libcuda = {pid: _libcuda_mapped(pid) for pid in pids}  # the GCS's and the raylet's
        libtorch = {pid: _libcuda_mapped(pid, "libtorch") for pid in pids}  # NVML, no torch
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        dash_log = open(os.path.join(tmp, "dashboard.log"), "wb")
        dash = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", "dashboard", "--address",
                                 address, "--port", str(port)], cwd=here, env=env,
                                stdout=dash_log, stderr=subprocess.STDOUT)

        def page():
            if dash.poll() is not None:
                raise AssertionError(f"the dashboard exited {dash.returncode}")
            try:
                return get("/")
            except OSError:
                return None

        until("the dashboard never answered", page, 60)
        t = step("dashboard", t)
        client = JobSubmissionClient(base)
        jid = client.submit_job(entrypoint=f"{sys.executable} {driver} {rows_path} {logits_path}")
        info = until("the card job never ended", lambda: (lambda i: i if i["status"] in (
            "SUCCEEDED", "FAILED", "STOPPED") else None)(client.get_job_info(jid)),
            JOB_CLI_WAIT_S)
        t = step("card_job", t)
        logs = client.get_job_logs(jid)
        if info["status"] != "SUCCEEDED":
            raise AssertionError(f"the card job ended {info}: {logs[-3000:]}")
        line = [ln for ln in logs.splitlines() if ln.startswith("{")][-1]
        job = json.loads(line)
        rest_logs = json.loads(get(f"/api/jobs/{jid}/logs"))["logs"]
        listed = json.loads(cli("job", "list", "--address", address))
        actors = json.loads(cli("list", "actors", "--address", address))
        tasks = until("/api/tasks never showed the card task FINISHED", lambda: [
            r for r in json.loads(get("/api/tasks"))
            if r.get("name") == "job_cli_score" and r.get("state") == "FINISHED"], 30)
        events = until("/api/timeline has no card task", lambda: [
            e for e in json.loads(get("/api/timeline")) if e.get("name") == "job_cli_score"], 30)
        prom = get("/metrics").decode()
        t = step("read_back", t)
        free["after_job"] = _free_card_bytes()
        sleeper = client.submit_job(entrypoint=f"{sys.executable} -c 'import time; "
                                               "time.sleep(600)'")
        until("the sleeping job never ran", lambda: client.get_job_status(sleeper) == "RUNNING",
              60)
        req = urllib.request.Request(f"{base}/api/jobs/{sleeper}/stop", method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            stop_reply = json.loads(r.read())
        sleeper_status = until("the stopped job never ended", lambda: (
            lambda s: s if s in ("SUCCEEDED", "FAILED", "STOPPED") else None)(
            client.get_job_status(sleeper)), 60)
        t = step("stopped_job", t)
    finally:
        if dash is not None:
            dash.terminate()
            dash.wait(timeout=30)
        cli("stop")
        deadline = time.monotonic() + 30
        while any(_pid_alive(p) for p in pids) and time.monotonic() < deadline:
            time.sleep(0.1)
        gone = not any(_pid_alive(p) for p in pids)
    t = step("stop", t)
    # the card task's worker ends with its raylet: wait for its memory
    deadline = time.monotonic() + 60
    while _free_card_bytes() < free["before_start"] - (1 << 30) and time.monotonic() < deadline:
        time.sleep(0.2)
    free["after_stop"] = _free_card_bytes()
    secs["memory_back"] = time.perf_counter() - t
    secs["phase"] = time.perf_counter() - t_phase
    rel = rel_l2(torch.from_numpy(np.load(logits_path)), torch.from_numpy(forward_last))
    shutil.rmtree(tmp, ignore_errors=True)  # the cluster's session, logs and the job's files
    launches = job["launches"]
    gpu_line = [ln.strip() for ln in status.splitlines() if ln.strip().startswith("GPU:")]
    marker = [ln.strip() for ln in status.splitlines() if "accelerator_type:" in ln]
    emit({"phase": "job_cli", "address": address, "status_gpu": gpu_line,
          "status_accelerator": marker, "job_id": jid, "job_status": info["status"],
          "task_launches": launches, "logits_rel_l2_vs_forward": rel, "tol": 1e-6,
          "bitwise": rel == 0.0, "checksum": job["checksum"], "task_pid": job["task_pid"],
          "task_visible": job["visible"], "task_foreign": job["foreign"],
          "driver_pid": job["driver_pid"], "driver_torch_imported": job["driver_torch_imported"],
          "driver_cuda_initialized": job["driver_cuda_initialized"],
          "driver_libcuda_mapped": job["driver_libcuda_mapped"],
          "task_init_s": job["init_s"], "task_forward_ms": job["forward_ms"],
          "rest_logs_have_line": line in rest_logs,
          "job_listed": any(r["job_id"] == jid for r in listed),
          "supervisor_listed": any(a.get("name") == f"_job_supervisor_{jid}" for a in actors),
          "task_rows": len(tasks), "timeline_events": len(events),
          "prometheus_type_line": "# TYPE rt_tasks_submitted counter" in prom,
          "stop_reply": stop_reply, "stopped_job_status": sleeper_status,
          "session_pids": pids, "session_pids_gone": gone, "daemons_libcuda_mapped": libcuda,
          "daemons_libtorch_mapped": libtorch,
          "free_bytes": free,
          "seconds": secs, "card": card})
    if launches.get("flash_attention_fwd") != 32 or sum(launches.values()) != 32:
        raise AssertionError(f"the card task's flash launches {launches}, want 32 forward")
    if not rel <= 1e-6:
        raise AssertionError(f"the card task's logits: rel L2 {rel} against the forward phase's")
    if job["driver_cuda_initialized"] or job["visible"] != "0" or job["foreign"]:
        raise AssertionError(f"the job's driver started CUDA, or its task saw "
                             f"{job['visible']!r} and loaded {job['foreign']}")
    if gpu_line != ["GPU: 1/1"] or not any(m.startswith("accelerator_type:H100") for m in marker):
        raise AssertionError(f"status showed {gpu_line} {marker}")
    if not (line in rest_logs and any(r["job_id"] == jid for r in listed)
            and any(a.get("name") == f"_job_supervisor_{jid}" for a in actors)
            and "# TYPE rt_tasks_submitted counter" in prom):
        raise AssertionError("the job was not read back through every way in")
    if stop_reply != {"stopped": True} or sleeper_status != "STOPPED":
        raise AssertionError(f"the second job: {stop_reply}, {sleeper_status}")
    if not gone or free["after_stop"] < free["before_start"] - (1 << 30):
        raise AssertionError(f"after stop: processes gone {gone}, free bytes {free}")
    return launches


# ---------------------------------------------------------------- autoscale
# An operator's GPU cluster that grows on demand: a head started with no card
# (`start --head --num-gpus 0 --autoscale 1:2`), a num_gpus=1 task queued
# there, the autoscaler's local raylet (which counts the card) taking it, and
# the idle node scaled back down before `stop`.
AUTOSCALE_UP_S = 120  # demand to a second node registered: the upscale delay, a raylet's start
AUTOSCALE_DOWN_S = 90  # the result to the node gone: the idle timeout (10 s) and a poll


def _alive_nodes(rt) -> list:
    return [n for n in rt.nodes() if n["alive"]]


def phase_autoscale(card: str, forward_rows, forward_last) -> dict:
    """`python -m ray_tpu_torch start --head --num-cpus 4 --num-gpus 0
    --autoscale 1:2` under a fresh TMPDIR (`status` shows one node and no
    GPU); this process joins with init(address=...) and submits
    job_cli_score as a num_gpus=1 task, which the head parks as queued
    demand; the autoscaler's monitor starts a local raylet that counts the
    card (GPU 1, accelerator_type:H100), the parked lease moves there and
    the task runs the 32-layer forward. After the result this process
    shuts its runtime down (its lease goes at once) and, from a fresh
    init, waits for the idle node to be scaled down; then `stop`. Fails
    unless the task ran on the autoscaled node with 32 forward launches,
    its logits are within 1e-6 relative L2 of ``forward_last``, the node
    was gone within AUTOSCALE_DOWN_S, no process of the cluster is left
    (the session's, the monitor's raylet, the task's worker) and the card's
    free memory after the scale-down and after `stop` is within 1 GiB of
    its reading before `start`. Returns the task's launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import chip_smoke  # by reference: the task workers import it from the cluster's PYTHONPATH
    import ray_tpu_torch as rt

    here = os.path.dirname(os.path.abspath(__file__))
    secs, free = {}, {}
    tmp = tempfile.mkdtemp(prefix="rtt_autoscale_")
    env = {k: v for k, v in os.environ.items() if k not in ("RT_ADDRESS", "PYTHONPATH")}
    env.update(TMPDIR=tmp, PYTHONPATH=here)

    def cli(*args, timeout=120):
        out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], cwd=here, env=env,
                             capture_output=True, text=True, timeout=timeout)
        if out.returncode != 0:
            raise AssertionError(f"`{' '.join(args)}` exited {out.returncode}: {out.stderr}")
        return out.stdout

    def until(what, fn, timeout):
        deadline = time.monotonic() + timeout
        while True:
            v = fn()
            if v:
                return v
            if time.monotonic() > deadline:
                raise AssertionError(f"autoscale: {what} after {timeout} s")
            time.sleep(0.1)

    rows_path = os.path.join(tmp, "tokens.npy")
    np.save(rows_path, forward_rows)
    free["before_start"] = _free_card_bytes()
    pids, scaled, joined = [], None, False
    t = t_phase = time.perf_counter()
    try:
        out = cli("start", "--head", "--num-cpus", "4", "--num-gpus", "0", "--autoscale", "1:2")
        line = [ln for ln in out.splitlines() if "started at" in ln][0]
        address = line.split(" at ")[1].split(",")[0]
        with open(os.path.join(tmp, "ray_tpu_torch", "session.json")) as f:
            pids = json.load(f)["pids"]  # the GCS, the head's raylet, the monitor
        status = until("status never showed the head", lambda: (
            lambda st: st if "nodes: 1" in st else None)(cli("status", "--address", address)), 60)
        secs["start_status"] = time.perf_counter() - t
        head_gpu = [ln.strip() for ln in status.splitlines() if ln.strip().startswith("GPU:")]
        rt.init(address=address)
        joined = True
        score = rt.remote(num_gpus=1)(chip_smoke.job_cli_score)
        t_demand, wall_demand = time.perf_counter(), time.time()
        ref = score.remote(rows_path)
        node = until("no card node came up", lambda: ([
            n for n in _alive_nodes(rt) if n["resources_total"].get("GPU") == 1.0] or [None])[0],
            AUTOSCALE_UP_S)
        secs["demand_to_node_registered"] = time.perf_counter() - t_demand
        scaled = {"node": node["node_id"].hex(), "pid": int(node["pid"]),
                  "resources": dict(node["resources_total"])}
        # it counted the card through NVML: no torch in the raylet
        scaled["libtorch_mapped"] = _libcuda_mapped(scaled["pid"], "libtorch")
        res = rt.get(ref, timeout=600)
        t = time.perf_counter()
        secs["demand_to_result"] = t - t_demand
        secs["demand_to_task_start"] = res["started_at"] - wall_demand
        rt.shutdown()  # the head reaps this process's lease now, not after its idle timeout
        joined = False
        rt.init(address=address)
        joined = True
        until("the idle card node was never scaled down", lambda: len(_alive_nodes(rt)) == 1,
              AUTOSCALE_DOWN_S)
        secs["result_to_node_gone"] = time.perf_counter() - t
        t = time.perf_counter()
        rt.shutdown()
        joined = False
        deadline = time.monotonic() + 15  # every byte back, or the reading as it stands
        while _free_card_bytes() < free["before_start"] and time.monotonic() < deadline:
            time.sleep(0.1)
        free["after_scale_down"] = _free_card_bytes()
        secs["node_gone_to_memory_back"] = time.perf_counter() - t
        if free["after_scale_down"] < free["before_start"]:
            # which processes hold the card's memory then (information)
            apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                                   "--format=csv,noheader"], capture_output=True, text=True)
            free["holders_after_scale_down"] = apps.stdout.strip() or apps.stderr.strip()
    finally:
        if joined:
            rt.shutdown()
        t = time.perf_counter()
        cli("stop")
        watched = pids + ([scaled["pid"]] if scaled else [])
        deadline = time.monotonic() + 30
        while any(_pid_alive(p) for p in watched) and time.monotonic() < deadline:
            time.sleep(0.1)
        left = [p for p in watched if _pid_alive(p)]
        secs["stop"] = time.perf_counter() - t
    deadline = time.monotonic() + 30
    while _free_card_bytes() < free["before_start"] - (1 << 30) and time.monotonic() < deadline:
        time.sleep(0.2)
    free["after_stop"] = _free_card_bytes()
    secs["task_init_s"] = res["init_s"]
    secs["task_forward_ms"] = res["forward_ms"]
    secs["phase"] = time.perf_counter() - t_phase
    task_left = _pid_alive(res["task_pid"])
    rel = rel_l2(torch.from_numpy(res["logits"]), torch.from_numpy(forward_last))
    shutil.rmtree(tmp, ignore_errors=True)
    launches = res["launches"]
    emit({"phase": "autoscale", "address": address, "head_status_gpu": head_gpu,
          "autoscaled_node": scaled, "task_node": res["node_id"], "task_pid": res["task_pid"],
          "task_visible": res["visible"], "task_foreign": res["foreign"],
          "task_launches": launches, "logits_rel_l2_vs_forward": rel, "tol": 1e-6,
          "bitwise": rel == 0.0, "session_pids": pids, "processes_left": left,
          "task_worker_left": task_left, "free_bytes": free, "seconds": secs, "card": card})
    if head_gpu:
        raise AssertionError(f"the head offered a card: {head_gpu}")
    if res["node_id"] != scaled["node"] or scaled["pid"] in pids:
        raise AssertionError(f"the task ran on {res['node_id']}, the autoscaled node is {scaled}")
    if (not any(k.startswith("accelerator_type:H100") for k in scaled["resources"])
            or scaled["libtorch_mapped"]):
        raise AssertionError(f"the autoscaled raylet: {scaled} (it must count the card "
                             "through NVML, without torch)")
    if launches.get("flash_attention_fwd") != 32 or sum(launches.values()) != 32:
        raise AssertionError(f"the card task's flash launches {launches}, want 32 forward")
    if not rel <= 1e-6:
        raise AssertionError(f"the card task's logits: rel L2 {rel} against the forward phase's")
    if left or task_left or res["foreign"]:
        raise AssertionError(f"after stop: processes {left} and the task's worker "
                             f"({task_left}) left; the task loaded {res['foreign']}")
    if min(free["after_scale_down"], free["after_stop"]) < free["before_start"] - (1 << 30):
        raise AssertionError(f"the card's free memory did not come back: {free}")
    return launches


# ------------------------------------------------------------- chaos_worker
# A card worker SIGKILLed by the port's ProcessKiller mid-task: the runtime
# retries the task (max_retries=1) in a new worker, which must give the same
# logits; the victim's CUDA context must be gone with it.
def chaos_card_task(rows_path: str, work_dir: str) -> dict:
    """The chaos_worker phase's card task. Its first attempt starts CUDA,
    says it is ready (``ready-<pid>``) and waits to be killed; the retry
    (``struck`` exists) waits for ``go`` before it touches the card, then
    runs job_cli_score."""
    pid = os.getpid()
    struck = os.path.join(work_dir, "struck")
    if not os.path.exists(struck):
        import torch

        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()  # this worker now holds a context on the card
        open(os.path.join(work_dir, f"ready-{pid}"), "w").close()
    go = os.path.join(work_dir, "go")
    while not os.path.exists(go):
        time.sleep(0.02)
    return {**job_cli_score(rows_path), "retried": os.path.exists(struck)}


def phase_chaos_worker(card: str, forward_rows, forward_last) -> dict:
    """ray_tpu_torch.init(num_cpus=2) with no worker started, then one
    num_gpus=1, max_retries=1 task (chaos_card_task); once its worker
    holds a CUDA context and waits, ProcessKiller(_owned_cluster, seed=0,
    target="worker", max_kills=1).strike_once() with the chaos controller
    armed. The victim must be the task's worker (the only READY one); the
    card's free memory once it has exited must be within 1 GiB of the
    reading before the task; the retry, released then, must return from a
    new pid with 32 forward launches and logits within 1e-6 relative L2 of
    ``forward_last``; killer.kills and state.list_chaos_events() must hold
    the one strike. Returns the retry's launches."""
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    import chip_smoke  # by reference: the workers import it from this script's directory
    import ray_tpu_torch as rt
    from ray_tpu_torch import state
    from ray_tpu_torch.core import api as _api
    from ray_tpu_torch.devtools import chaos
    from ray_tpu_torch.devtools.chaos.killers import ProcessKiller
    from ray_tpu_torch.devtools.chaos.plan import ChaosPlan

    secs, free = {}, {}
    tmp = tempfile.mkdtemp(prefix="rtt_chaos_worker_")
    rows_path, log_dir = os.path.join(tmp, "tokens.npy"), os.path.join(tmp, "chaos")
    np.save(rows_path, forward_rows)
    t = t_phase = time.perf_counter()
    rt.init(num_cpus=2)
    chaos.enable(ChaosPlan(seed=0, rules=[]), log_dir=log_dir)
    try:
        secs["init"] = time.perf_counter() - t
        cluster = _api._owned_cluster
        free["before_task"] = _free_card_bytes()
        task = rt.remote(num_gpus=1, max_retries=1)(chip_smoke.chaos_card_task)
        t = time.perf_counter()
        ref = task.remote(rows_path, tmp)

        def ready():
            return glob.glob(os.path.join(tmp, "ready-*"))

        deadline = time.monotonic() + JOB_CLI_WAIT_S
        while not ready():
            if time.monotonic() > deadline:
                raise AssertionError("chaos_worker: the card task never started CUDA")
            time.sleep(0.05)
        victim = int(ready()[0].rsplit("-", 1)[1])
        secs["task_ready"] = time.perf_counter() - t
        free["victim_holding_context"] = _free_card_bytes()
        ready_workers = [w.proc.pid for r in cluster.raylets for w in r.all_workers.values()
                         if w.proc.poll() is None and w.address is not None]
        if ready_workers != [victim]:
            raise AssertionError(f"chaos_worker: READY workers {ready_workers}, want only "
                                 f"the card task's {victim}")
        open(os.path.join(tmp, "struck"), "w").close()  # before the strike: the retry waits
        killer = ProcessKiller(cluster, seed=0, target="worker", max_kills=1)
        t = time.perf_counter()
        killer.strike_once()
        killer.strike_once()  # max_kills=1: no second strike
        deadline = time.monotonic() + 30
        while _pid_alive(victim) and time.monotonic() < deadline:
            time.sleep(0.02)
        secs["kill_to_victim_exit"] = time.perf_counter() - t
        deadline = time.monotonic() + 30
        while (_free_card_bytes() < free["before_task"] - (1 << 30)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        free["after_victim_exit"] = _free_card_bytes()
        secs["victim_exit_to_memory_back"] = time.perf_counter() - t - secs["kill_to_victim_exit"]
        open(os.path.join(tmp, "go"), "w").close()
        t = time.perf_counter()
        res = rt.get(ref, timeout=600)
        secs["release_to_result"] = time.perf_counter() - t
        events = [e for e in state.list_chaos_events(log_dir=log_dir)
                  if e.get("point") == "killer.worker"]
    finally:
        chaos.disable()
        rt.shutdown()
    secs["task_init_s"] = res["init_s"]
    secs["task_forward_ms"] = res["forward_ms"]
    secs["phase"] = time.perf_counter() - t_phase
    rel = rel_l2(torch.from_numpy(res["logits"]), torch.from_numpy(forward_last))
    shutil.rmtree(tmp, ignore_errors=True)
    launches = res["launches"]
    kills = [{k: v for k, v in kill.items() if k != "ts"} for kill in killer.kills]
    emit({"phase": "chaos_worker", "victim_pid": victim, "kills": kills,
          "logged_kills": [e.get("ctx") for e in events], "retry_pid": res["task_pid"],
          "retried": res["retried"], "retry_visible": res["visible"],
          "retry_foreign": res["foreign"], "retry_launches": launches,
          "logits_rel_l2_vs_forward": rel, "tol": 1e-6, "bitwise": rel == 0.0,
          "free_bytes": free, "seconds": secs, "card": card})
    if len(kills) != 1 or kills[0]["pid"] != victim or kills[0]["target"] != "worker":
        raise AssertionError(f"the killer's strikes {kills}, want one at the card worker {victim}")
    if [e.get("ctx", {}).get("pid") for e in events] != [victim]:
        raise AssertionError(f"the chaos event log's kills {events}")
    if res["task_pid"] == victim or not res["retried"]:
        raise AssertionError(f"the task was not retried in a new worker: {res['task_pid']}")
    if launches.get("flash_attention_fwd") != 32 or sum(launches.values()) != 32:
        raise AssertionError(f"the retry's flash launches {launches}, want 32 forward")
    if not rel <= 1e-6:
        raise AssertionError(f"the retry's logits: rel L2 {rel} against the forward phase's")
    if free["after_victim_exit"] < free["before_task"] - (1 << 30) or res["foreign"]:
        raise AssertionError(f"the victim's context was not released: {free}; "
                             f"the retry loaded {res['foreign']}")
    return launches


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


def rl_runner_stats(algo) -> list:
    """Each runner actor's ``runner_stats`` (its pid and device, and the
    seconds of its sample calls since the last read)."""
    import ray_tpu_torch as rt

    return rt.get([r.runner_stats.remote() for r in algo.runners], timeout=120)


def rl_curve(algo, iters: int, steps_per_sample: int) -> dict:
    """``iters`` train() calls: per iteration the mean return, the loss,
    the sample ms (the slowest runner's; the runners sample in parallel), the rest of
    train() (updates, replay, weight broadcasts) as update ms, and the env
    steps per second of all runners; the runners' pids (each must differ
    from this process's) and devices."""
    import numpy as np
    import torch

    stats = rl_runner_stats(algo)  # reset the runners' clocks
    rets, losses, sample_ms, update_ms, rates = [], [], [], [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = algo.train()
        ret = result["episode_return_mean"]
        losses.append(result["loss"])
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        stats = rl_runner_stats(algo)
        slowest = max(st["sample_s"] for st in stats) * 1e3
        rets.append(ret)
        sample_ms.append(slowest)
        update_ms.append(total - slowest)
        rates.append(sum(steps_per_sample * st["samples"] / st["sample_s"]
                         for st in stats if st["sample_s"] > 0))
    finite = [r for r in rets if not np.isnan(r)]
    pids = [st["pid"] for st in stats]
    return {"returns": rets, "losses": losses, "first": finite[0] if finite else None,
            "best": max(finite) if finite else 0.0, "sample_ms": sample_ms,
            "update_ms": update_ms, "env_steps_per_s": rates,
            "device": next(algo.get_weights().parameters()).device.type,
            "runner_pids": pids, "runner_devices": [st["device"] for st in stats],
            "runners_apart": os.getpid() not in pids and len(set(pids)) == len(pids)}


def _rl_learner_probe():
    """rllib's Learner with two methods more: reset_launches() sets its
    process's kernel launch counts to 0, launches() reads them."""
    from ray_tpu_torch.rllib.learner import Learner

    class ProbedLearner(Learner):
        def reset_launches(self) -> bool:
            from ray_tpu_torch import kernels

            kernels.LAUNCHES.clear()
            return True

        def launches(self) -> dict:
            from ray_tpu_torch import kernels

            return dict(kernels.launches())

    return ProbedLearner


def rl_build_probed(config, algo_cls=None):
    """``config.build()`` (as ``algo_cls``, PPO by default) with PPO's
    learner actors made from _rl_learner_probe's class, config and
    arguments unchanged."""
    from ray_tpu_torch.rllib import ppo

    saved = ppo.Learner
    ppo.Learner = _rl_learner_probe()
    try:
        return (algo_cls or ppo.PPO)(config)
    finally:
        ppo.Learner = saved


def rl_learner_launches(algo, reset: bool = False) -> list:
    """Each learner actor's kernel launches (after setting them to 0)."""
    import ray_tpu_torch as rt

    if reset:
        rt.get([ln.reset_launches.remote() for ln in algo.learners], timeout=120)
    return rt.get([ln.launches.remote() for ln in algo.learners], timeout=120)


def rl_ppo_config(cls=None):
    """rllib_ppo's config (test_ppo_learns_cartpole's settings, seed 0), as
    a ``cls`` (PPOConfig by default)."""
    from ray_tpu_torch.rllib import PPOConfig

    return ((cls or PPOConfig)().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=128)
            .training(lr=1e-3, minibatches=4, epochs=4, hidden=64))


def phase_rllib_ppo(card: str) -> tuple[dict, dict]:
    """PPO on the port's CartPole-v1 at test_ppo_learns_cartpole's settings
    (2 runners x 4 envs x 128 steps, lr 1e-3, 4 epochs x 4 minibatches,
    hidden 64), 8 iterations on the card: best > max(60, 1.5 x first),
    params on cuda, no flash launch in the driver or in the learner actor
    (the runners sample on the host CPU, where no kernel launches).
    Returns the launches and the run (rl_curve's readings)."""
    from ray_tpu_torch import kernels

    algo = rl_build_probed(rl_ppo_config())
    rl_learner_launches(algo, reset=True)
    kernels.LAUNCHES.clear()  # the main path starts here
    run = rl_curve(algo, 8, 4 * 128)
    learners = rl_learner_launches(algo)
    algo.stop()
    flash = collections.Counter(kernels.launches())
    for counts in learners:
        flash.update(counts)
    flash = dict(flash)
    emit({"phase": "rllib_ppo", "iterations": 8, **run, "flash_launches": flash,
          "learner_flash_launches": learners,
          "bar": "best > max(60, 1.5 x first)", "card": card})
    if run["device"] != "cuda" or sum(flash.values()) or not run["runners_apart"]:
        raise AssertionError(f"rllib_ppo ran on {run['device']}, runners {run['runner_pids']} "
                             f"(driver {os.getpid()}), flash {flash}")
    if run["first"] is None or not run["best"] > max(60.0, 1.5 * run["first"]):
        raise AssertionError(f"PPO did not learn: first {run['first']}, best {run['best']}")
    return flash, run


TUNE_RL_ITERS = 3  # tune_rllib: train() calls a trial


def _rl_tune_config_class():
    """PPOConfig whose build() gives a PPO with _rl_learner_probe's learner
    actors (their launch counts set to 0 at the build), each train() result
    carrying every learner's flash launches since then: the counts travel
    with the trial's reports, read where the updates run."""
    from ray_tpu_torch.rllib import ppo

    class ProbedPPO(ppo.PPO):
        def train(self):
            return {**super().train(), "learner_flash_launches": rl_learner_launches(self)}

    class ProbedPPOConfig(ppo.PPOConfig):
        def build(self):
            algo = rl_build_probed(self, ProbedPPO)
            rl_learner_launches(algo, reset=True)
            return algo

    return ProbedPPOConfig


def phase_tune_rllib(card: str, direct: dict) -> dict:
    """Tuner over PPO.as_trainable(rllib_ppo's config, stop_iters=3) on the
    RL runtime, a grid of rllib_ppo's lr and 3x: two trial actors (no card)
    at once, each building PPO with runner actors on the host CPU and a
    learner actor leasing the whole card, so the learners run one after
    the other. Both trials must end TERMINATED with
    3 reports; the trial at rllib_ppo's lr must report rllib_ppo's
    episode_return_mean and loss of the same iterations (``direct``: the
    same config and seed); 0 flash launches in every learner actor.
    Returns the learners' launches."""
    import tempfile
    import types

    from ray_tpu_torch import rllib, tune

    cfg = rl_ppo_config(_rl_tune_config_class())
    lrs = [cfg.lr, 3 * cfg.lr]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        grid = tune.Tuner(
            rllib.PPO.as_trainable(cfg, stop_iters=TUNE_RL_ITERS),
            param_space={"lr": tune.grid_search(lrs)},
            # two trials at once: the second trial's learner waits for the
            # first's card lease (RL_ACTOR_WAIT_S)
            tune_config=tune.TuneConfig(metric="episode_return_mean", mode="max",
                                        max_concurrent_trials=2),
            run_config=types.SimpleNamespace(storage_path=tmp, name="tune_rllib")).fit()
    seconds = time.perf_counter() - t0
    trials = {r.config["lr"]: r for r in grid}
    hist = {lr: r.metrics_history for lr, r in trials.items()}
    errors = {lr: r.error for lr, r in trials.items() if r.error}
    if errors or sorted(trials) != sorted(lrs):
        raise AssertionError(f"tune_rllib trials failed: {errors or list(trials)}")
    got = [(m["episode_return_mean"], m["loss"]) for m in hist[lrs[0]]]
    want = list(zip(direct["returns"], direct["losses"]))[:TUNE_RL_ITERS]
    equal = len(got) == len(want) and all(
        a == b or (math.isnan(a) and math.isnan(b))
        for pair in zip(got, want) for a, b in zip(*pair))
    flash = collections.Counter()
    for h in hist.values():
        for counts in h[-1]["learner_flash_launches"]:  # each learner's, since the build
            flash.update(counts)
    flash = dict(flash)
    emit({"phase": "tune_rllib", "trials": len(grid), "lrs": lrs,
          "statuses": {lr: r.status for lr, r in trials.items()},
          "reports": {lr: len(h) for lr, h in hist.items()},
          "returns": {lr: [m["episode_return_mean"] for m in h] for lr, h in hist.items()},
          "losses": {lr: [m["loss"] for m in h] for lr, h in hist.items()},
          "rllib_ppo_returns_losses": want, "equal_to_rllib_ppo": equal,
          "iteration_ms": {lr: [m["time_this_iter_s"] * 1e3 for m in h]
                           for lr, h in hist.items()},
          "learner_flash_launches": flash, "seconds": seconds, "card": card})
    if any(r.status != "TERMINATED" for r in grid) or \
            any(len(h) != TUNE_RL_ITERS for h in hist.values()):
        raise AssertionError(f"tune_rllib: statuses {[r.status for r in grid]}, "
                             f"reports {[len(h) for h in hist.values()]}")
    if not equal:
        raise AssertionError(f"the tuned trial reported {got}, rllib_ppo {want}")
    if sum(flash.values()):
        raise AssertionError(f"flash launches in the tuned learners: {flash}")
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
        algo = config().build()
        run = rl_curve(algo, iters, steps)
        algo.stop()
        bar = bar or (lambda first, best: best > max(60.0, 1.5 * first))
        run["passed"] = run["first"] is not None and bar(run["first"], run["best"])
        out[name] = run
        if not run["passed"] or run["device"] != "cuda" or not run["runners_apart"]:
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
    from ray_tpu_torch.core.ref import ObjectRef
    from ray_tpu_torch.rllib import BCConfig, CQLConfig, OfflineData, collect_rollouts, core
    from ray_tpu_torch.rllib import offline, write_rollouts

    kernels.LAUNCHES.clear()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "exp", "rollouts.jsonl")
        expert = core.policy_init(core.seeded(7, "cpu"), 4, 2, hidden=32)
        t0 = time.perf_counter()
        n = collect_rollouts("CartPole-v1", path, num_steps=384, num_envs=2, seed=0,
                             policy_params=expert, hidden=32)
        collect_s = time.perf_counter() - t0
        shard_refs = []
        task = offline._read_shard

        class ShardProbe:  # OfflineData's shard reads, as the runtime's tasks
            def remote(self, p):
                shard_refs.append(task.remote(p))
                return shard_refs[-1]

        offline._read_shard = ShardProbe()
        try:
            t0 = time.perf_counter()
            data = OfflineData(path)
            read_s = time.perf_counter() - t0
        finally:
            offline._read_shard = task
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
    tasks = len(shard_refs) == 1 and isinstance(shard_refs[0], ObjectRef)
    emit({"phase": "rllib_offline", "transitions": n, "collect_s": collect_s,
          "shard_tasks": len(shard_refs), "read_s": read_s,
          "bc_loss": result["loss"], "bc_agreement": agree, "bc_iter_ms": bc_ms,
          "bc_update_ms": [t / 80 for t in bc_ms], "cql_penalty": cresult["cql_penalty"],
          "cql_prefers_logged": prefer, "cql_iter_ms": cql_ms,
          "cql_update_ms": [t / 60 for t in cql_ms],
          "device": next(bc.get_weights().parameters()).device.type,
          "flash_launches": flash, "card": card})
    if not tasks:
        raise AssertionError(f"OfflineData read its shard through {shard_refs}, not a task")
    if not (n >= 384 and result["loss"] < 0.6 and agree > 0.8):
        raise AssertionError(f"BC: {n} transitions, loss {result['loss']}, agreement {agree}")
    if not (cresult["cql_penalty"] < 0.35 and prefer > 0.9):
        raise AssertionError(f"CQL: penalty {cresult['cql_penalty']}, prefers {prefer}")
    if sum(flash.values()):
        raise AssertionError(f"rllib_offline launched flash kernels: {flash}")
    return flash


RL_STORE_BYTES = 1 << 30  # rollouts, weight trees and offline shards
# a call on an actor still waiting for its lease fails after the runtime's
# worker_start_timeout_s (ROADMAP Queue 3, 8): a tuned PPO trial's learner
# waits for the other trial's whole-card lease, ~30-50 s
RL_ACTOR_WAIT_S = 300.0

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


def phase_rllib_learners(card: str) -> dict:
    """PPO with num_learners=2: two Learner actors of the runtime sharing
    the card (num_gpus=0.5 each) in a gloo group met through the GCS KV
    (NCCL refuses two ranks on one card). Driven directly, rank 0 updates on
    a fixed rollout and rank 1 on an empty shard: after the sync both hold
    equal params and Adam moments, equal to the mean of one local update
    and the initial state computed here (1e-6), and their step counts
    differ (16 and 0). Then one train() of the algorithm through both (its
    one runner's rollout goes to rank 0, rank 1 joins the sync with none):
    a finite loss, the learners still equal. The flash launches of both
    learner actors over these runs, counted in each from 0: none. Returns
    them, summed."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import Learner, PPOConfig

    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=4, rollout_fragment_length=128)
           .learners(num_learners=2)
           .training(lr=RL_LEARNER["lr"], epochs=RL_LEARNER["epochs"],
                     minibatches=RL_LEARNER["minibatches"], hidden=RL_LEARNER["hidden"]))
    cfg.seed = RL_LEARNER["seed"]
    t0 = time.perf_counter()
    algo = rl_build_probed(cfg)
    build_s = time.perf_counter() - t0
    rl_learner_launches(algo, reset=True)
    t0 = time.perf_counter()
    results = rt.get([algo.learners[0].update.remote([_rl_learner_rollout()]),
                      algo.learners[1].update.remote([])], timeout=300)
    update_s = time.perf_counter() - t0
    states = rt.get([ln.get_state.remote() for ln in algo.learners], timeout=120)
    outs = [st["tensors"] for st in states]
    train = algo.train()
    after = [st["tensors"] for st in rt.get([ln.get_state.remote() for ln in algo.learners],
                                            timeout=120)]
    learner_flash = rl_learner_launches(algo)
    algo.stop()
    flash = collections.Counter()
    for counts in learner_flash:
        flash.update(counts)
    config = dict(RL_LEARNER, device="cuda")
    idle, moved = Learner(0, 1, config), Learner(0, 1, config)
    moved.update([_rl_learner_rollout()])
    want0, want1 = idle.get_state()["tensors"], moved.get_state()["tensors"]
    unequal, worst, steps = [], 0.0, {}
    for k in want0:
        kind = k.split("/")[0]
        if kind == "step":
            steps[k] = (float(outs[0][k]), float(outs[1][k]))
            continue
        if not np.array_equal(outs[0][k], outs[1][k]):
            unequal.append(k)
        if not np.array_equal(after[0][k], after[1][k]):
            unequal.append(f"after train: {k}")
        worst = max(worst, float(np.abs(outs[0][k] - (want0[k] + want1[k]) / 2).max()))
    emit({"phase": "rllib_learners", "ranks": 2, "backend": "gloo",
          "samples": [r["samples"] for r in results],
          "learners": [{"pid": st["pid"], "device": st["device"]} for st in states],
          "unequal_leaves": unequal, "max_abs_diff_from_mean": worst, "tol": 1e-6,
          "steps": sorted(set(steps.values())), "train_loss": train["loss"],
          "train_ms": train["time_this_iter_s"] * 1e3, "build_s": build_s,
          "update_s": update_s, "learner_flash_launches": learner_flash, "card": card})
    if unequal or not worst <= 1e-6:
        raise AssertionError(f"learner sync: unequal {unequal}, diff from the mean {worst}")
    if set(steps.values()) != {(16.0, 0.0)} or any(st["device"] != "cuda" for st in states):
        raise AssertionError(f"learner steps {set(steps.values())}, learners {states}")
    pids = {st["pid"] for st in states}
    if len(pids) != 2 or os.getpid() in pids or not math.isfinite(train["loss"]):
        raise AssertionError(f"learners {pids} (driver {os.getpid()}), loss {train['loss']}")
    if sum(flash.values()):
        raise AssertionError(f"rllib_learners' learner actors launched flash kernels: {flash}")
    return dict(flash)


# The lint phase's sync cross-check: one function per RT017 leg (leg_*),
# each looping over a CUDA tensor, and the clean shapes (clean_*). RT017
# flags a set F of them; the card's own detector
# (torch.cuda.set_sync_debug_mode("error")) raises in a set S.
LINT_SYNC_SOURCE = """\
import numpy as np
import torch


def leg_item(x):
    y = torch.mul(x, 2)
    return [y[i].sum().item() for i in range(y.shape[0])]


def leg_tolist(x):
    y = torch.mul(x, 2)
    out = []
    for i in range(y.shape[0]):
        out.append(y[i].tolist())
    return out


def leg_cpu(x):
    y = torch.mul(x, 2)
    out = []
    for i in range(y.shape[0]):
        out.append(y[i].cpu())
    return out


def leg_numpy(x):
    y = torch.mul(x, 2)
    out = []
    for i in range(y.shape[0]):
        out.append(y[i].numpy(force=True))
    return out


def leg_to_cpu(x):
    y = torch.mul(x, 2)
    out = []
    for i in range(y.shape[0]):
        out.append(y[i].to("cpu"))
    return out


def leg_to_device_cpu(x):
    y = torch.mul(x, 2)
    out = []
    for i in range(y.shape[0]):
        out.append(y[i].to(device="cpu"))
    return out


def leg_float(x):
    y = torch.mul(x, 2)
    total = 0.0
    for row in y:
        total += float(row.sum())
    return total


def leg_int(x):
    y = torch.argmax(x, dim=-1)
    out = []
    for i in range(y.shape[0]):
        out.append(int(y[i]))
    return out


def leg_bool(x):
    y = torch.mul(x, 2)
    n = 0
    for i in range(y.shape[0]):
        if bool(y[i].sum() > 0):
            n += 1
    return n


def leg_np_asarray(x):
    y = torch.mul(x, 2)
    out = []
    for i in range(y.shape[0]):
        out.append(np.asarray(y[i]))
    return out


def leg_np_array(x):
    y = torch.mul(x, 2)
    out = []
    for i in range(y.shape[0]):
        out.append(np.array(y[i]))
    return out


def leg_cuda_synchronize(x):
    y = x
    for _ in range(4):
        y = torch.mul(y, 2)
        torch.cuda.synchronize()
    return y


def leg_stream_synchronize(x):
    stream = torch.cuda.current_stream()
    y = x
    for _ in range(4):
        y = torch.mul(y, 2)
        stream.synchronize()
    return y


def leg_event_synchronize(x):
    y = x
    for _ in range(4):
        y = torch.mul(y, 2)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return y


def clean_copy_after_loop(x):
    # the engine's shape: queue the block, then ONE non-blocking copy to
    # pinned memory and an event; the host waits on it outside (_HostCopy)
    blocks = []
    for i in range(x.shape[0]):
        blocks.append(torch.mul(x[i], 2))
    stacked = torch.stack(blocks)
    host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
    host.copy_(stacked, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def clean_queue_only(x):
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + torch.mul(x[i], i)
    return acc


def clean_metadata(x):
    y = torch.mul(x, 2)
    out = []
    for i in range(y.shape[0]):
        n = y.size(1)
        out.append(int(n) + i)
    return out


def clean_host_tensor(x):
    h = torch.ones(x.shape[0], device="cpu")
    total = 0.0
    for i in range(x.shape[0]):
        total += float(h[i])
    return total


def clean_rebound(x):
    out = []
    for i in range(x.shape[0]):
        r = torch.mul(x[i], 2)
        r = [i, i + 1]
        out.append(np.asarray(r))
    return out


def clean_deferred(x):
    y = torch.mul(x, 2)
    fns = []
    for i in range(y.shape[0]):
        fns.append(lambda i=i: y[i].item())
    return fns
"""


def _sync_outcome(fn, x) -> str:
    """'sync' when the card's detector raised, 'ok' when fn returned, else
    the other exception's type and message."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(x)
    except RuntimeError as e:
        if "synchronizing CUDA operation" not in str(e):
            return f"RuntimeError: {e}"
        return "sync"
    except Exception as e:  # noqa: BLE001 — reported beside the leg
        return f"{type(e).__name__}: {e}"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], torch.cuda.Event):
        out[1].synchronize()  # clean_copy_after_loop's wait, outside the detector
    return "ok"


def phase_lint(card: str, here: str) -> None:
    """The port's linter on the card's host: (a) `python -m ray_tpu_torch
    lint --flow` over the package in a subprocess, which must exit 0 with
    0 findings and import no torch; (b) RT017's flagged functions F of
    LINT_SYNC_SOURCE against the functions S that raise under
    set_sync_debug_mode("error"): every function in S must be in F, every
    leg in F, no clean shape in F or S, and the legs in F but not in S
    (the detector does not see the sync the rule names) are printed with
    what the card did; (c) as information, the syncs the detector warns
    of in one paged_decode_multi call of the serving phases' 2-layer
    float32 engine, beside the flow pass's verdict on that root."""
    import ast
    import warnings

    import numpy as np
    import torch

    started = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": here}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m", "ray_tpu_torch", "lint",
                           "--flow"], capture_output=True, text=True, cwd=here, env=env,
                          timeout=300)
    self_lint_s = time.perf_counter() - t0
    imported = {line.rsplit("|", 1)[1].strip().split(".")[0]
                for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    foreign = sorted(imported & {"torch", "jax", "jaxlib", "ray_tpu"})
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    emit({"phase": "lint", "part": "self_lint", "rc": proc.returncode, "summary": summary,
          "seconds": self_lint_s, "modules_imported": len(imported),
          "foreign_imports": foreign, "card": card})
    if proc.returncode != 0 or summary != "raylint: 0 findings" or foreign:
        raise AssertionError(f"lint: self-lint failed (rc {proc.returncode}, {foreign}):\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")

    from ray_tpu_torch.devtools.lint import flow, lint_source

    tree = ast.parse(LINT_SYNC_SOURCE)
    spans = {f.name: (f.lineno, f.end_lineno) for f in tree.body
             if isinstance(f, ast.FunctionDef)}
    names = [n for n in spans if n.startswith(("leg_", "clean_"))]
    t0 = time.perf_counter()
    found = lint_source(LINT_SYNC_SOURCE, "lint_sync.py", select=["RT017"])
    flagged = {n for f in found for n, (a, b) in spans.items() if a <= f.line <= b}
    ns: dict = {}
    exec(compile(LINT_SYNC_SOURCE, "lint_sync.py", "exec"), ns)
    x = torch.randn(4, 8, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    warm = {}
    for n in names:  # outside the detector: lazy allocations and loads
        try:
            ns[n](x)
        except TypeError as e:  # numpy of a CUDA tensor: reported below
            warm[n] = f"TypeError: {e}"
    torch.cuda.synchronize()
    outcome = {n: _sync_outcome(ns[n], x) for n in names}
    raised = {n for n, o in outcome.items() if o == "sync"}
    legs = {n for n in names if n.startswith("leg_")}
    clean = set(names) - legs
    blind = {n: outcome[n] for n in sorted(flagged - raised)}
    emit({"phase": "lint", "part": "sync_cross_check", "rule": "RT017",
          "flagged": sorted(flagged), "raised": sorted(raised),
          "detector_blind": blind, "clean": sorted(clean), "warm_up_errors": warm,
          "seconds": time.perf_counter() - t0, "card": card})
    bad = {"raised_not_flagged": sorted(raised - flagged),
           "legs_not_flagged": sorted(legs - flagged),
           "clean_flagged": sorted(clean & flagged),
           "clean_not_ok": {n: outcome[n] for n in sorted(clean) if outcome[n] != "ok"}}
    if any(bad.values()):
        raise AssertionError(f"lint: RT017 disagrees with the card's sync detector: {bad}")

    from ray_tpu_torch.llm import ContinuousBatchingEngine
    from ray_tpu_torch.llm.engine import paged_decode_multi
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params32 = llama_init(g, cfg32, "cuda")  # the serving phases' 2-layer float32 weights
    eng = ContinuousBatchingEngine(params32, cfg32, max_batch=4, page_size=16,
                                   n_pages=512, max_seq_len=2048)
    lens = np.array([16, 100, 257, 512], np.int64)
    nxt = np.random.default_rng(SEED).integers(0, cfg32.vocab_size, size=4)
    K = 8  # a block bucket
    first = 1  # page 0 is the junk page
    for i, n in enumerate(lens):
        need = -(-(int(n) + K) // eng.PS)
        eng.page_tables[i, :need] = np.arange(first, first + need)
        first += need
    # the engine's own argument construction (_dispatch_block); the
    # host-to-card copies are made before the detector is on
    args = (eng.params, eng.loras, eng._h2d(eng.aids), eng._h2d(nxt), eng._h2d(lens),
            eng._h2d(eng.page_tables), eng.kpool, eng.vpool, eng._h2d(np.ones(4, bool)),
            eng._h2d(eng.temps), eng._gen, eng.cfg, K)
    paged_decode_multi(*args)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            toks, _, _ = paged_decode_multi(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    sources = collections.Counter(f"{os.path.relpath(w.filename, here)}:{w.lineno}"
                                  for w in syncs)
    toks = toks.cpu()
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = flow.CallGraph.build([os.path.join(here, "ray_tpu_torch")])
    root = graph.functions["ray_tpu_torch.llm.engine:paged_decode_multi"]
    under_root = [f for f in flow.analyze_paths([], graph=graph)
                  if f.rule_id == "RT022" and f.chain[0].startswith(root.qualname + " ")]
    emit({"phase": "lint", "part": "decode_syncs", "call": "paged_decode_multi",
          "layers": cfg32.n_layers, "dtype": cfg32.dtype, "batch": 4, "n_steps": K,
          "seq_lens": lens.tolist(), "detector_syncs": len(syncs),
          "detector_sources": dict(sources), "flow_root_kind": root.root_kind,
          "flow_root_cause": root.root_cause, "flow_host_sync_findings": len(under_root),
          "agree": (len(syncs) == 0) == (not under_root),
          "tokens_in_vocab": bool(((toks >= 0) & (toks < cfg32.vocab_size)).all()),
          "seconds": decode_s, "flow_graph_seconds": time.perf_counter() - t0, "card": card})
    if root.root_kind != "device-region":
        raise AssertionError(f"lint: paged_decode_multi is not a device region: {root.root_kind}")
    del eng, params32, args
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lint", "part": "total", "seconds": time.perf_counter() - started,
          "card": card})


def keep_bytecode(here: str) -> str:
    """Give this process and every process it starts (the runtime's
    workers, the CLI's daemons, jobs' drivers) one bytecode cache under the
    git-ignored ``ray_tpu_torch/_build/pycache``. The card's host sets
    PYTHONDONTWRITEBYTECODE=1 and its torch carries no ``__pycache__``, so
    without a cache every fresh process compiles torch's Python sources at
    ``import torch``; with it, only the first does (chip_import_probe.py
    times both)."""
    prefix = os.path.join(here, "ray_tpu_torch", "_build", "pycache")
    os.makedirs(prefix, exist_ok=True)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    return prefix


def main() -> int:
    started = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ray_tpu_torch")):
        print("chip_smoke: the ray_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    keep_bytecode(here)  # before the first import of torch
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
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
    launches, cfg32, params32, forward_last = phase_forward(card, kernels, cfg, params, tokens)
    forward_rows = tokens.cpu().numpy()  # the workflow phase's make_tokens step takes these
    dag_launches = phase_dag_pipeline(card, cfg, params, tokens)
    serve_launches, prompts, planned, planned_ttft, ref32 = phase_serving(
        card, kernels, cfg, params, cfg32, params32)
    phase_serving_int8(card, cfg, params, cfg32, params32, prompts, planned, ref32)
    phase_serving_spec(card, cfg, params, cfg32, params32, prompts)
    phase_serving_adopt(card, cfg, params, cfg32, params32, prompts)
    layer_launches, inproc = phase_serving_server(card, kernels, cfg, params, cfg32,
                                                  params32, prompts, ref32)
    disagg_launches, disagg_tokens_per_s = phase_serving_disagg(
        card, kernels, cfg, params, cfg32, params32, prompts, ref32, planned_ttft)
    del params, params32, tokens
    # LLMServer (its batch queue holds its bound method) and PrefillWorker
    # sit in reference cycles that hold the weights until a collection
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, train_losses, train_tokens = phase_train(card, kernels, k)
    gc.collect()
    torch.cuda.empty_cache()
    moe_fwd_launches = phase_moe_forward(card, kernels)
    moe_train_launches, moe_step_launches = phase_moe_train(card, kernels)
    phase_parallel(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_runtime(card)
    sharded_launches = phase_sharded(card)
    serve_launches_replicas, handle_tokens_per_s = phase_serve_run(card, inproc)
    serve_disagg_launches = phase_serve_disagg(
        card, prompts, {"serve_run_handle_tokens_per_s": handle_tokens_per_s,
                        "serving_disagg_decode_tokens_per_s": disagg_tokens_per_s})
    # the trainer's worker actors take the card from here
    trainer_launches = phase_trainer(card, train_losses)
    phase_trainer_checkpoint(card)
    phase_trainer_dp2(card)
    phase_dryrun(card)
    data_trainer_launches = phase_data_trainer(card, train_losses, train_tokens)
    tune_trainer_launches = phase_tune_trainer(card, train_losses)
    workflow_launches = phase_workflow(card, forward_rows, forward_last)
    forward_last = forward_last.cpu().numpy()  # ~1 MB on the host, for job_cli
    # after every phase that needs the card: its workers lease the card
    data_batch_launches = phase_data_batch(card)
    import ray_tpu_torch

    ray_tpu_torch.shutdown()  # every worker and the shm arena go with it
    gc.collect()
    torch.cuda.empty_cache()
    # a cluster of its own, started and stopped through the CLI
    job_cli_launches = phase_job_cli(card, forward_rows, forward_last)
    # a card node brought up by queued demand, and a card worker killed mid-task
    autoscale_launches = phase_autoscale(card, forward_rows, forward_last)
    chaos_worker_launches = phase_chaos_worker(card, forward_rows, forward_last)
    phase_rllib_parity(card)
    # the RL drivers' runner actors, PPO's learner actors and the offline
    # shard tasks run on a runtime of their own
    from ray_tpu_torch import config

    config.set_config(dataclasses.replace(config.get_config(),
                                          worker_start_timeout_s=RL_ACTOR_WAIT_S))
    ray_tpu_torch.init(object_store_memory=RL_STORE_BYTES)
    rl_launches = collections.Counter()
    ppo_launches, ppo_run = phase_rllib_ppo(card)
    rl_launches.update(ppo_launches)
    tune_rllib_launches = phase_tune_rllib(card, ppo_run)
    rl_launches.update(phase_rllib_offpolicy(card))
    rl_launches.update(phase_rllib_offline(card))
    rl_launches.update(phase_rllib_learners(card))
    ray_tpu_torch.shutdown()
    phase_lint(card, here)

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
               "sharded_launches": sharded_launches.get(name, 0),
               "serve_run_launches": serve_launches_replicas.get(name, 0),
               "serve_disagg_launches": serve_disagg_launches.get(name, 0),
               "data_trainer_launches": data_trainer_launches[name],
               "data_batch_launches": data_batch_launches.get(name, 0),
               # both trials' workers over their timed steps (8 a step each)
               "tune_trainer_launches": tune_trainer_launches.get(name, 0),
               # read in the tuned PPO trials' learner actors
               "tune_rllib_launches": tune_rllib_launches.get(name, 0),
               # the workflow's score step, counted in its task
               "workflow_launches": workflow_launches.get(name, 0),
               # the job_cli job's card task, counted in it
               "job_cli_launches": job_cli_launches.get(name, 0),
               # the autoscaled node's card task, counted in it
               "autoscale_launches": autoscale_launches.get(name, 0),
               # the killed card task's retry, counted in it
               "chaos_worker_launches": chaos_worker_launches.get(name, 0),
               # both stages' launches over dag_pipeline's timed overlap executes
               "dag_pipeline_launches": sum(dag_launches.values())
               if name == "flash_attention_fwd" else 0,
               "rllib_launches": rl_launches[name], **k[name]}
        if name != "flash_attention_fwd":
            row["plain_and_library_cover"] = "dq+dkv"
        rows.append(row)
    emit({"phase": "wall", "seconds": time.perf_counter() - started, "card": card})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
