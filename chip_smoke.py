#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tony_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc, then runs these phases
and exits non-zero if any of them fails:

1. card: the GPU's name and power limit, the kernels' build time, ptxas's
   registers and spills for each kernel, and a check of the compiled SASS:
   every bf16 attention kernel must run on the tensor cores (HMMA);
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the flagship's shapes and at the edge cases, with its time beside the
   plain version's, a PyTorch library call's and the card's bound (the
   decode kernel at four shapes: bf16 at 2081 of 4160 and 16384 positions,
   int8 at 16384, batch 1 at 4097; its float32 partials and its in-launch
   combine each against their own plain version, and two launches on the
   same inputs bit-equal); the decode kernel against the plain einsum
   decode path at M in {1024, 4096, 16384}; every attention kernel at
   head_dim 32 too (a draft model's: K1, K3-K5 and K6), timed at the
   draft's shapes;
3. main path, generation: tony_tpu_torch.examples.lm_generate at the
   flagship's full width (vocab 32768, d_model 1024, 12 layers, 8 heads,
   d_ff 4096, bf16, random weights from a seed) answering five requests,
   the fifth on int8 decode weights (--weight-dtype int8), with every
   kernel's launch count checked against the count the requests need;
   then w8a16's resident weights and decode step's device time against
   native, and one step's logits against native (reported);
4. main path, training: tony_tpu_torch.examples.lm_train at the same width,
   batch 8 x 2048 tokens, TRAIN_STEPS steps on synthetic data, with the
   flash forward and both flash backward kernels launched once per layer
   per step, every loss finite and the last below the first; then remat:
   lm_train --remat for REMAT_STEPS steps under each policy, losses
   bit-equal to the training run's first steps, the flash forward
   launched twice a layer a step under "full" and "dots" and once under
   "attn", peak memory; chunked_reference_attention against the plain
   attention at float32;
5. main path, serving: tony_tpu_torch.cli.serve's own build_argparser and
   build_app at the flagship's width with the CLI's slot-pool defaults (8
   slots x 2048 positions, blocks of 16 steps, prefill chunks of 128),
   answering 24 concurrent POST /generate requests on 127.0.0.1 (run A,
   predictive mode: no kernel launched, no stream synchronisation inside a
   decode block's dispatch, the admissions' synchronisations counted), then
   a direct SlotServer with a stop token that fires (run B, EOS mode), and
   one decode block's wall time against its device time;
6. main path, checkpoints: lm_train at the training path's width and
   batch saving every CKPT_EVERY steps, run CKPT_STEPS steps straight and
   again as CKPT_SPLIT steps plus a resumed run in a fresh directory (the
   resumed losses must repeat the straight run's, to the bit when two
   straight runs agree to the bit); lm_generate and serve's app restored
   from that directory against generate on the parameters the run held
   at its last step; the checkpoint's bytes, the loop's stall inside
   save_async, the writer's time and the restore time;
7. main path, prefix cache: serve's app at the flagship width with the
   CLI's defaults and --prefix-cache-blocks PREFIX_BLOCKS, 16 requests
   sharing a 1024-token prefix posted cold, then again (every full chunk
   hits the second time), cold and warm TTFT and admission time; the
   cache's completions against a server without it at float32 (2 layers,
   native and int8 KV), up to the first near-tie of the cacheless logits;
8. main path, replay: the request journal through injected crashes: (a)
   8 requests through 3 slots at float32 (2 layers) with two crashes at
   decode-block ordinals (TONY_TEST_SERVING_CRASH_AT_BLOCKS), reset() as
   ServeApp calls it, token-identical to the crashless server up to its
   first near-tie (native KV; int8 KV: the journaled prefixes verbatim,
   half the streams equal); (b) serve's app at the flagship width with the
   CLI's defaults, 16 concurrent greedy HTTP requests without and with two
   crashes: 16 of 16 complete, 2 loop restarts, every stream as long as
   the crashless run's and beginning with its journaled prefixes, the
   re-prefilled and re-decoded tokens and the burst's wall times
   reported; (c) a serve process (python -m tony_tpu_torch.cli.serve,
   --trace-dir under build/) SIGKILLed at a decode block
   (TONY_TEST_SERVING_SIGKILL_AT_BLOCK) and restarted: it resumes the
   journaled requests, finishes them and compacts the journal; (d)
   checkpoint_progress with blocks in flight returns without waiting for
   the newest block;
9. main path, streaming: serve's app (its build_argparser, build_app and
   make_httpd, --text-codec ids) answering Server-Sent Events: (a) at
   float32 (2 layers) 8 greedy prompts each posted buffered, streamed on
   /generate and streamed on /v1/completions, every stream equal to its
   own completion and, with the buffered answer, to solo generate up to
   its first near-tie, and /v1/chat/completions streams ending in [DONE];
   (b) serving run A's 24 requests all streamed at the flagship width
   with serve's defaults, at journal checkpoints every 1.0 s and 0.25 s:
   every stream done with strictly increasing cursors, the time to the
   first frame, frames a request, tokens a frame, the gaps between
   frames, no synchronisation in dispatch, a block's host dispatch
   beside run A's, and a block's device time with 8 streams attached
   within 1% of the serving phase's; (c) a float32 stream cut after its
   first frame: cancelled within a 0.25 s wait beat and a block, then
   resumed with Last-Event-ID, no token twice and none missing; (d) 16
   streams across two loop crashes at float32 (equal to a crashless
   server up to a near-tie) and at bf16 (how many equal reported);
10. main path, paged KV (SlotServer(paged=True), serve's --paged-kv
   flags): (a) at float32 and bf16 (2 layers) 8 requests through 3 slots
   on the paged engine (blocks of 16) token-identical to the ring engine
   admitting slot by slot, in predictive, EOS, int8-KV and prefix-cache
   modes, and with --prefill-interleave 64 (held at float32; at bf16 its
   ring layout is rotated by design, reported beside the ring engine
   against itself one block on); (b) run A's 24 requests at float32 (4
   layers) through both engines, equal up to the ring's first near-tie,
   then at bf16 through serve's app with --paged-kv: every
   request done, throughput, latency, a block's dispatch, wall and device
   time, the gather's and the scatter's device time against their bytes
   bound, no synchronisation in dispatch, peak device memory; (c) 16
   slots on the same pool: deferred admissions and the pool's peak; (d)
   --max-queue 8 with a batch budget: every shed is batch, no interactive
   request refused while a batch one is queued; a burst of 8 prompts of
   1536 tokens while 8 streams decode, --prefill-interleave 0 and 256:
   the streams' delivery gaps; (e) --prefix-cache-blocks 512: a warm
   request maps the shared prefix's trie blocks and copies none, an
   admission burst beside the ring prefix cache's, warm against cold at
   float32; (f) replay through two crashes at float32 against a
   crashless paged server; the allocator's invariant after every drain
   and no kernel launched;
11. main path, telemetry (serve's app at the flagship width with its
   defaults, bf16): (a) run A's 24 requests with --trace-dir, without a
   scrape and then with GET /metrics scraped every TELEMETRY_SCRAPE_S,
   each scrape through a small exposition check written here (the line
   grammar, cumulative buckets, +Inf equal to _count); then /metrics
   against /stats, the TTFT count,
   requests.trace.jsonl's 24 records with one terminal each, no
   synchronisation in dispatch or admission, a block's host dispatch
   beside the serving phase's and its device time within 1% of it; (b)
   --max-queue 8 under a burst of 48 (every third request batch): every
   429's Retry-After the estimate its shed carried, the estimator's value
   for the queue's depth and EWMA at the shed, never falling with the
   depth, reported against the measured service time; after POST
   /autoscale/hint of 20 s the next 429s say at least 19; (c) serve
   --paged-kv on run A: the serving_kv_pool_* families equal /stats'
   paged_kv; (d) serve restarted on (a)'s --trace-dir resumes its
   histograms from telemetry.state.json. Device time in (a) and (c): the
   dispatch tracker counted every dispatch the engine made, by kind,
   dropped none, raised no reap error and had none in flight after its
   drain; the five dispatch families equal /stats' device; a device lag
   for every decode block (p50 and p99 printed, and a block's dispatch ->
   ready beside its device time); in (c) a GET /debug/profile?seconds=2
   during the run, its Chrome-trace JSON parsed (its CUDA kernel events
   counted, the serving loop's gemv, direct_copy and paged-gather kernels
   looked for). Then the reaper's cost to the host: a Python loop timed
   while the reaper waits on a second-long kernel against the loop alone,
   and the process's CPU share while it waits (beside a spinning event);
12. main path, disaggregated serving: (a) at float32 (2 layers) 8
   requests of 64-512 tokens, 48 new, from a prefill-role engine (one
   slot on one request's blocks, so every prefill reuses the blocks the
   one before freed, and the whole pool overwritten before any payload is
   encoded) to a decode-role engine, token-identical to a solo paged
   engine up to its first near-tie with native KV (int8 KV reported);
   (b) serve's apps at the flagship width: run A's first 8 prompts, 48
   greedy new tokens, POST /generate on --role prefill and its handoff
   verbatim to /kv/import on --role decode (half streamed), beside
   --role both in turn: payload MB, the export's encoding, the import's
   decode and verify and its hold of the serving lock, TTFT of the legs
   against --role both, tokens equal (bf16, reported), a torn payload
   answered 400, a full decode pool 429, the transfer counters equal on
   /stats and /metrics, no synchronisation in any role's dispatch;
13. parity: the flagship width at 2 layers on the card (kernels, bf16)
   against the CPU's plain path in float32, from the same weights, for the
   generation logits and for the training loss and every gradient; and the
   SlotServer in float32 on the card (8 requests through 3 slots, batched
   and per-slot admission) against the port's generate run solo on the
   card, token for token up to the first near-tie of solo's logits;
14. HF checkpoint: HF_CONFIG (meta-llama/Llama-3.1-8B's published widths,
   cut to HF_LAYERS layers) written in HF's layout as two safetensors
   shards and an index from a seeded generator, then lm_generate
   --hf-checkpoint native and --weight-dtype int8; at float32 the kernels
   against the plain path up to its first near-tie; serve --hf-checkpoint
   --weight-dtype int8 at float32 on the ring and --paged-kv against solo
   int8 decoding in the server's order up to its first near-tie; a bf16
   engine reported;
15. Mixture-of-Experts: the flagship's widths with MOE_EXPERTS experts
   (top-2, capacity factor 1.25): (a) lm_train --n-experts, the flash
   kernels once a layer a step, one step profiled and a layer's forward
   split into routing, dispatch, experts, combine and attention; (b) at
   float32 the kernels against the plain path on the loss, every
   gradient and each layer's dispatch and combine; (c) lm_generate
   --n-experts native and with int8 experts, the prefill's and a decode
   step's device time, and at float32 generate's tokens against the
   plain path's up to a near-tie; (d) the SlotServer on the ring, the
   paged engine and the ring with a self-draft against solo generate;
16. mesh: (a) lm_train as a child launched by the port's own launcher, a
   one-worker TonY job (TonyClient -> driver -> executor -> the torch
   runtime, which hands the child rank 0's registered address as
   TONY_COORDINATOR_ADDRESS): the job SUCCEEDED, train.init joins an NCCL
   group and build_mesh makes the six-axis DeviceMesh, then
   MESH_STEPS steps at the flagship width and training's shape with --mesh
   fsdp=-1 (the sharded step) and --mesh seq=-1 (the flash ring at n = 1),
   the flash kernels once a layer a step, the losses against the training
   phase's first steps; (b) the flash ring's block schedule replayed in one
   process (every rank's steps: full, diag or skip, the merge, the
   backward with the dK/dV sums) at n = 2 and 4, bf16 at B8 H8 L2048 D128
   and float32 at B2 H8 L1024 D128, held against the whole-sequence K1 and
   K3-K5 and the plain versions, K1, dK/dV and dQ launched once a visible
   step. Two ranks cannot share the card under NCCL, so no multi-rank
   collective runs here;
17. tp (tensor-parallel decode and serving): (a) a child launched as a
   one-worker TonY job (as mesh (a)) at world 1 over an NCCL group of one:
   lm_generate --tensor-parallel 1 on generation's request 0 (bf16, 12
   layers) against that request's tokens, float32 generate(mesh=) against
   generate without a mesh, serve --mesh tensor=1 on run A's greedy
   requests (float32, SERVE_CUT_LAYERS) against the meshless serve up to
   its first near tie, with no synchronisation in dispatch or admission,
   and the turn exchange's host time; (b) a tensor
   axis of t = 2 and 4 replayed in one process (every rank's forward, the
   collectives in memory) at the flagship's widths, float32, its logits
   against the whole model's kernels and plain path (TP_LOGITS_ATOL), K1
   and K6 on each rank's heads at t times the whole's launches; K6 timed
   at 8, 4 and 2 kv heads, each beside its plain version and SDPA;
18. pipeline (pipeline schedules and expert sharding): (a)
   create_pipeline_train_step's GPipe, 1F1B and circular schedules with
   their stages replayed in one process (every stage's own code, the
   ring's sends in memory) at the flagship's widths, bf16, 12 layers, B8
   x 2048: GPipe and 1F1B at S = 2 and 4, circular at S = 2, V = 2 and S =
   4, V = 3, one step each against the one-device step (loss within
   PIPE_BF16_LOSS_ATOL), K1 launched L·M times over the stages (2·L·M
   under 1F1B's recompute) and K3-K5 L·M times, wall and device ms; (b)
   the same at float32, 4 layers, B2 x 1024: loss within
   PIPE_F32_LOSS_RTOL, parameters after the step within
   PIPE_F32_PARAM_ATOL; (c) MoE (8 experts, top-2, capacity factor 1.25)
   at float32, 2 layers: the training step's loss and gradients replayed
   at expert=2 and at data=2 (the routing the global batch's) against one
   device, and decode replayed at tensor=2,expert=2 (K1 and K6 on each
   rank's heads) up to the first near tie; (d) an NCCL group of one in
   this process: the pipelined step at pipe=1 and a MoE step at expert=1
   against one device. PIPE_CUTS lists the depth cuts;
19. launch (the port's launch path: TonyClient -> driver -> executor ->
   runtime): (a) mnist_cuda.json, examples/mnist.py as a one-worker job:
   SUCCEEDED, its final loss and accuracy, an NCCL group of one, and the
   executor's TaskMonitor push carrying the card's utilisation and memory
   (nvidia-smi); (b) serve_cuda.json at SERVE_CUT_LAYERS layers, float32:
   the replica's published serve_port answers paged (a)'s 8 prompts (48
   new) token-equal to an in-process serve app up to its first near tie,
   then client.stop() leaves no process behind; (c) a worker exiting 1
   fails its job, and one past tony.task.executor.execution-timeout-ms is
   killed; (d) elastic training: two world-1 lm_train workers on the card
   (the flagship's widths at ELASTIC_CUT_LAYERS layers, B8 x 2048, a
   checkpoint every ELASTIC_SAVE_EVERY steps, each worker its own
   directory) through the driver's chaos preemption at step
   ELASTIC_PREEMPT_AT (the child drains into a budget-free relaunch), a
   SIGKILL of worker:1's child past its restart budget of 0 (detach,
   worker:0 drained by the executor's SIGTERM relay, generation 1) and its
   rejoin after the retry (generation 2, the checkpoint prestaged): the
   job SUCCEEDS, no step log skips a step, recomputed steps repeat their
   losses to the bit (when the two workers' first steps agree to the bit),
   /metrics reads 2 resizes and 1 preemption, the journal and the traces
   hold their records, the prestaged bytes are the checkpoint's, K1 and
   K3-K5 launch ELASTIC_CUT_LAYERS times a step, and no process is left;
   beside them the elastic_train drill: preempted by its flag file and
   relaunched, continuous steps, the straight run's final value; (d) is
   submitted before the tp phase and runs beside it, the pipeline phase
   and (a)-(c) and the drill, which run at once; the phase's seconds,
   the driver's start-up (submit -> driver.json) and the executors'
   (launched -> registered);
20. profile: a flagship decode step's and a flagship training step's
   (remat off and under each policy) host wall time against the device
   time torch.profiler records.

The serve apps of phases 8-12 (replay's HTTP and SIGKILL parts,
streaming's (b) and (d), paged (b)-(d), telemetry, disaggregation (b))
run the flagship's widths at SERVE_CUT_LAYERS layers: they check the
engine and the host, and the script's budget is 700 s (every phase prints
its seconds; a "phase_seconds" JSON line gathers them). The last four
lines of standard output are the kernels' JSON record, that line, the
card's name and power limit as nvidia-smi gives them, and the result
line. Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import re
import shlex
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
FLAGSHIP = ["--vocab", "32768", "--d-model", "1024", "--n-layers", "12",
            "--n-heads", "8", "--d-ff", "4096", "--dtype", "bfloat16"]
N_LAYERS = 12
# the serve apps of the replay, streaming, paged (b)-(d), telemetry and
# disaggregation phases: the flagship's widths at SERVE_CUT_LAYERS layers.
# They check the engine and the host (replay, streams, the pool, the
# counters), not the model's depth; the serving phase keeps all 12 (4
# until the tp phase needed the time: their blocks are host-bound, and the
# host's dispatch grows with the layers)
SERVE_CUT_LAYERS = 2
MAX_NEW = 64
MAX_LEN = 4160                # the longest prompt (4096) + MAX_NEW
SHALLOW = FLAGSHIP + ["--n-layers", str(SERVE_CUT_LAYERS)]
# (batch, prompt_len, extra flags) of the main path's requests
REQUESTS = [(8, 1024, []), (8, 2048, []), (1, 4096, []),
            (8, 1024, ["--kv-dtype", "int8"]),
            (8, 1024, ["--weight-dtype", "int8"])]
# bf16 outputs: the kernel and the plain version both sum in float32 and
# round once to bf16, so they may differ by one bf16 ulp (2^-8 relative)
BF16_TOL = (1e-2, 1e-2)       # (atol, rtol)
F32_TOL = (1e-4, 1e-4)        # float32: summation order over up to 8192 keys
LSE_TOL = (1e-3, 1e-5)        # float32 lse from bf16 or f32 inputs
PART_TOL = (1e-4, 1e-4)       # float32 partials of the decode's chunks
# bf16 weights and activations against float32 through 2 layers and a
# 1024-term unembed sum, for logits of standard deviation about 1: a bf16
# rounding is 2^-9 relative, and a 512-wide model showed 0.06
PARITY_LOGITS_ATOL = 0.25
# the card's kernel path against its plain path, both bf16: they differ only
# where an attention output rounds to the neighbouring bf16 value
KERNEL_PATH_ATOL = 0.1
# flash backward, kernel against plain version on the same inputs: both
# compute in float32 and round once; bf16 outputs may differ by one bf16 ulp
# (2^-7 relative), float32 ones by the order of sums over up to 2048 products
# of magnitude up to about 10
BWD_BF16_TOL = (1e-2, 1e-2)
BWD_F32_TOL = (1e-3, 1e-4)
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
# remat: lm_train --remat under each policy for REMAT_STEPS steps at the
# training path's shape, against the training phase's first steps
REMAT_STEPS, REMAT_POLICIES = 5, ("full", "dots", "attn")
# serving run A: requests posted at once, prompt lengths and new tokens
# drawn uniformly from these ranges, SERVE_SAMPLED of them at temperature
# 0.8 and top-k 50, the others greedy
SERVE_REQUESTS, SERVE_SAMPLED = 24, 4
SERVE_PROMPT, SERVE_NEW = (64, 1536), (32, 128)
# serving parity: tokens must agree up to the first step whose greedy
# top-2 logit gap (solo, float32) is below this; past it float32 summation
# order (the einsum path against the kernels) may pick the other token
PARITY_NEAR_TIE = 1e-3
# checkpoints: lm_train saves every CKPT_EVERY steps; a straight run of
# CKPT_STEPS steps against CKPT_SPLIT steps and a resumed run of the rest
CKPT_STEPS, CKPT_EVERY, CKPT_SPLIT = 11, 5, 6
CKPT_ROOT = REPO / "build" / "chip_smoke" / "checkpoints"
# speculative decoding: solo at the flagship's full width, float32, batch 1,
# a SPEC_PROMPT-token prompt and SPEC_NEW new tokens (64 until PR 21, cut
# for the observability checks' time), gamma SPEC_GAMMA; lm_generate's
# default draft dims (head_dim 32: K1 and K6 at D = 32)
SPEC_PROMPT, SPEC_NEW, SPEC_GAMMA = 1024, 32, 4
SPEC_DRAFT = dict(d_model=128, n_layers=2, n_heads=4, d_ff=512)
# the CLI's own-trained draft at lm_generate's default draft dims (head_dim
# 32: its training runs K3-K5 at D = 32)
SPEC_TRAIN_DRAFT = ["--d-model", "128", "--n-layers", "2", "--n-heads", "4",
                    "--d-ff", "512"]
SPEC_CLI_NEW = 32
# spec serving: the paged (a) cell's prompts at SERVE_CUT_LAYERS, 48 new;
# multi-model at the checkpoint's depth, 16 new
SPEC_SERVE_NEW, MULTI_NEW = 48, 16
# the MoE phase: the flagship's widths with MOE_EXPERTS experts (top-2,
# capacity factor 1.25: the JAX package's defaults, transformer.py:50-53).
# (a) lm_train at MOE_TRAIN_LAYERS layers, batch MOE_BATCH x MOE_SEQ,
# MOE_STEPS steps; (b) float32 parity at 2 layers; (c) lm_generate at
# MOE_GEN_LAYERS layers, then float32 at MOE_GEN_F32_LAYERS; (d) serving at
# SERVE_CUT_LAYERS. MOE_CUTS lists the depth cuts made for the script's
# budget: widths, shapes and checks are the flagship's
MOE_EXPERTS = 8
MOE_FLAGS = FLAGSHIP + ["--n-experts", str(MOE_EXPERTS)]
MOE_TRAIN_LAYERS, MOE_BATCH, MOE_SEQ, MOE_STEPS = 4, 4, 1024, 6
MOE_GEN_LAYERS, MOE_GEN_F32_LAYERS = 2, 2
MOE_CUTS = ["(a) training: 12 -> 6 -> 4 layers",
            "(c) generation: 12 -> 4 -> 2 layers"]
# (b): a token whose top-3 router probabilities lie closer than this may
# route differently on the two paths (float32 summation order)
MOE_ROUTE_NEAR_TIE = 1e-4
MOE_PARITY_LOSS_ATOL, MOE_PARITY_GRAD_RTOL = 1e-4, 1e-4
# the elastic drill on the card: steps, and the step after which the
# preemption flag file is dropped
ELASTIC_STEPS, ELASTIC_FLAG_AT = 15, 10
# the prefix-cache cell: the pool's blocks (prefill chunks of 128), the
# shared prefix, requests, their suffixes' length range and new tokens
PREFIX_BLOCKS = 64
PREFIX_LEN, PREFIX_REQUESTS, PREFIX_SUFFIX, PREFIX_NEW = 1024, 16, (32, 256), 32
# the replay phase: (a) REPLAY_F32 requests of REPLAY_F32_NEW new tokens
# (6 blocks) through 3 slots at float32 (2 layers), crashes at decode
# blocks REPLAY_F32_CRASH: the 5th is the first wave's, the 13th the
# second's, each with two blocks journaled by checkpoint_progress; (b)
# REPLAY_REQUESTS concurrent HTTP requests through serve's app, prompts and
# new tokens uniform over these ranges, without and with two crashes; (c)
# REPLAY_KILL requests of REPLAY_KILL_NEW new tokens to a serve process
# that SIGKILLs itself REPLAY_KILL_BLOCK decode blocks after a warm-up
REPLAY_F32, REPLAY_F32_NEW, REPLAY_F32_CRASH = 8, 96, "5,13"
REPLAY_REQUESTS, REPLAY_PROMPT, REPLAY_NEW = 16, (64, 1536), (64, 128)
REPLAY_KILL, REPLAY_KILL_NEW, REPLAY_KILL_BLOCK = 8, 128, 6
# the streaming phase: (a) STREAM_F32 greedy prompts of 64-512 tokens and
# STREAM_F32_NEW new at float32 (2 layers), each posted buffered, streamed on
# /generate and streamed on /v1/completions; (b) run A's requests buffered
# and streamed, and STREAM_UNIFORM's streams (the same budget each, so no
# completion comes before the last block), at each journal checkpoint
# cadence of STREAM_CADENCES; (c) a
# stream of STREAM_CUT_NEW new tokens cut after its first frame and resumed
# with Last-Event-ID; (d) STREAM_CRASH greedy streams of STREAM_CRASH_NEW
# new across crashes at decode blocks STREAM_CRASH_F32 (float32), and at
# 30% and 65% of a crashless burst's blocks (the flagship at bf16)
STREAM_F32, STREAM_F32_NEW = 8, 32
STREAM_CADENCES = (1.0, 0.25)
STREAM_UNIFORM = (8, 512, 256)      # requests, prompt tokens, new tokens
STREAM_CUT_NEW = 384
STREAM_CRASH, STREAM_CRASH_NEW, STREAM_CRASH_F32 = 16, 128, "5,13"
# the paged phase: (a) PAGED_ID requests of 64-512 tokens (the prefix mode:
# the prefix-cache cell's prompts) and PAGED_ID_NEW new through 3 slots,
# paged (kv_block PAGED_KV_BLOCK) against the ring, at 2 layers; (b) run A
# on serve's defaults with --paged-kv; (c) the same with PAGED_OVER_SLOTS
# slots on the ring's pool; (d) PAGED_TIER requests a class against
# --max-queue 8 and a batch budget of PAGED_TIER_BUDGET blocks, then a
# burst of PAGED_BURST prompts of PAGED_BURST_LEN tokens arriving while
# PAGED_STREAMS streams decode, at each of PAGED_INTERLEAVES; (e) the
# prefix-cache cell with --prefix-cache-blocks PAGED_TRIE_BLOCKS
PAGED_ID, PAGED_ID_NEW, PAGED_KV_BLOCK = 8, 48, 16
PAGED_OVER_SLOTS = 16
PAGED_TIER, PAGED_TIER_BUDGET = 12, 256
PAGED_BURST, PAGED_BURST_LEN, PAGED_INTERLEAVES = 8, 1536, (0, 256)
PAGED_STREAMS, PAGED_STREAM_LEN, PAGED_STREAM_NEW = 8, 256, 384
PAGED_TRIE_BLOCKS = 512
# (b)'s float32 run A through both engines: the flagship's widths at this
# depth (12 until the disaggregation phase needed the time, 4 until the tp
# phase did)
PAGED_F32_LAYERS = 2
# telemetry: /metrics scraped every TELEMETRY_SCRAPE_S seconds during run A;
# a burst of TELEMETRY_BURST against --max-queue TELEMETRY_MAX_QUEUE; an
# autoscale hint of TELEMETRY_HINT_S seconds
TELEMETRY_SCRAPE_S, TELEMETRY_BURST = 0.5, 48
TELEMETRY_MAX_QUEUE, TELEMETRY_HINT_S = 8, 20
# a GET /debug/profile of TELEMETRY_PROFILE_S seconds, sent
# TELEMETRY_PROFILE_AT_S seconds into (c)'s run A
TELEMETRY_PROFILE_S, TELEMETRY_PROFILE_AT_S = 2, 1.5
# the disaggregation phase: (a) DISAGG_F32 requests of 64-512 tokens and
# DISAGG_NEW new at float32 (2 layers) from a prefill replica to a decode
# replica, against a solo paged engine, native and int8 KV; (b) run A's
# first DISAGG_HTTP prompts with DISAGG_NEW greedy new tokens through
# serve's apps at the flagship width, --role prefill then /kv/import on
# --role decode (a pool of DISAGG_DECODE_BLOCKS blocks: DISAGG_FULL
# imports of a 1536-token prompt with DISAGG_FULL_NEW new fill it), beside
# --role both in turn
DISAGG_F32, DISAGG_HTTP, DISAGG_NEW = 8, 8, 48
DISAGG_DECODE_BLOCKS, DISAGG_FULL, DISAGG_FULL_NEW = 896, 7, 512
# the HF phase: meta-llama/Llama-3.1-8B's published config.json widths,
# depth cut from 32 layers to HF_LAYERS; written as two safetensors shards
# and an index from a seeded generator. HF_REQUESTS prompts of 64-512
# tokens, HF_NEW greedy new tokens each
HF_CONFIG = dict(
    architectures=["LlamaForCausalLM"], model_type="llama",
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=131072, rope_theta=500000.0,
    rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                      high_freq_factor=4.0,
                      original_max_position_embeddings=8192),
    rms_norm_eps=1e-5, tie_word_embeddings=False, attention_bias=False,
    mlp_bias=False, hidden_act="silu", torch_dtype="bfloat16",
    bos_token_id=128000, eos_token_id=128001)
HF_LAYERS, HF_REQUESTS, HF_NEW = 2, 8, 32
# training parity at flagship width and 2 layers, bf16 on the card against
# float32 on the CPU: weights and activations round to bf16 (2^-9 relative)
# at every cast of a two-layer forward and backward, so a gradient may move
# by a few percent of its norm; the loss is a mean over 512 tokens of a
# logsumexp near 10.4, which averages the rounding out
TRAIN_PARITY_LOSS_ATOL = 0.05
TRAIN_PARITY_GRAD_RTOL = 0.1
# the bf16 attention kernels (the tensor-core route) and their designs
# the training profiles' depth under a remat policy (12 until PR 21, cut
# for the observability checks' time; remat off stays at 12)
TRAIN_PROFILE_REMAT_LAYERS = 6
MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dkdv_mma_kernel",
               "flash_bwd_dq_mma_kernel")
DESIGNS = {
    "flash_fwd": "bf16: mma.sync m16n8k16 bf16 (f32 accumulate), ldmatrix "
                 "from padded bf16 tiles, cp.async x2 stages of 32-key K/V "
                 "tiles; 128 q rows a CTA, 4 warps; P kept in registers. "
                 "f32: FMA on the FP32 pipes",
    "flash_bwd_dkdv": "bf16: mma.sync m16n8k16 bf16, keys as M (S^T = K Q^T, "
                      "dP^T = V dO^T), P^T and dS^T kept in registers as A "
                      "operands, cp.async x2 Q/dO/lse/delta stages; 64 keys "
                      "a CTA, 4 warps. f32: FMA on the FP32 pipes",
    "flash_bwd_dq": "bf16: mma.sync m16n8k16 bf16, dS kept in registers as "
                    "the A operand of dS K, cp.async x2 K/V stages; 64 q rows "
                    "a CTA, 4 warps. f32: FMA on the FP32 pipes",
    "flash_decode": "one launch: chunks split evenly over the SMs, one CTA "
                    "(8 warps) each, two an SM; 2-stage ring of 16 KB K + 16 "
                    "KB V tiles by 16-byte cp.async; online softmax "
                    "per group of D/8 lanes (FMA, p in float32); the last "
                    "CTA of a head combines the partials in chunk order",
}


def fail(msg: str):
    raise RuntimeError(msg)


# seconds of each phase of main(), in order, printed as phase_seconds
PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args):
    """fn(*args), its wall seconds printed and kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    secs = time.perf_counter() - t0
    PHASE_SECONDS[name] = round(secs, 1)
    print(f"{name}: the phase {secs:.1f} s", flush=True)
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn over ``iters`` back-to-back calls, by CUDA
    events. The timed calls are queued behind a device-side sleep that
    outlasts their enqueueing, so the host's per-call overhead (Python,
    ctypes) leaves no gaps on the device inside the timed window."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the enqueue of one warm call (the warm-up's first calls pay one-time
    # costs that would size the sleep far beyond the timed calls)
    t0 = time.perf_counter()
    fn()
    host_s = (time.perf_counter() - t0) * iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at 2 GHz, above the H100's boost clock: the sleep lasts at
    # least 1.5x the measured enqueue time plus 2 ms
    torch.cuda._sleep(int((1.5 * host_s + 2e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, tol) -> float:
    """max |got - want|; raises unless |got - want| <= atol + rtol |want|
    everywhere."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values from the kernel")
    err = (got - want).abs()
    atol, rtol = tol
    worst = float((err - rtol * want.abs()).max())
    if worst > atol:
        fail(f"{name}: max |kernel - plain| = {float(err.max()):.3g} beyond "
             f"atol {atol} + rtol {rtol}")
    return float(err.max())


def visible_pairs(lq: int, lk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, for one (batch, head)."""
    total = 0
    for r in range(lq):
        hi = min(r, lk - 1) if causal else lk - 1
        lo = max(0, r - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def train_flops_per_token(d, n_layers, d_ff, vocab, seq) -> float:
    """Model FLOPs of one training token (bench_transformer.py's count):
    projections, SwiGLU, causal attention at L/2 average context and the
    unembed, times 3 for forward plus backward."""
    per_layer = 2 * d * 3 * d + 2 * d * d + 6 * d * d_ff + 2 * d * seq
    return 3.0 * (n_layers * per_layer + 2 * d * vocab)


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------------ phases

def _kernel_label(mangled: str) -> str:
    """flash_fwd_mma_kernel<128>, flash_fwd_kernel<float,128>,
    flash_decode_kernel<bf16,int8,128,1> and the like from a mangled kernel
    name."""
    ident = re.search(r"\d+((?:flash|decode)\w*?kernel)", mangled)
    name = ident.group(1) if ident else mangled
    dims = re.findall(r"Li(\d+)E", mangled)
    if "decode" in name:   # q's and the cache's types, then D and REP
        types = re.search(r"kernelI(.*?)Li", mangled)
        codes = re.findall(r"13__nv_bfloat16|S\d*_|f|a",
                           types.group(1) if types else "")
        names = ["int8" if c == "a" else "float" if c == "f" else "bf16"
                 for c in codes]
        return f"{name}<{','.join(names + dims)}>"
    dtype = ("float," if "IfLi" in mangled else
             "bf16," if "bfloat16" in mangled and "mma" not in name else "")
    return f"{name}<{dtype}{','.join(dims)}>"


def ptxas_report(log: str) -> dict:
    """{kernel label: (registers, spill stores, spill loads)} from nvcc's
    -Xptxas -v output."""
    out, fn, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = _kernel_label(m.group(1)), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)), *spills)
    return out


def sass_hmma(lib: Path) -> dict:
    """{kernel label: HMMA instructions in its SASS} for one built library,
    by cuobjdump --dump-sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = _kernel_label(m.group(1))
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


def phase_card(build) -> dict:
    """Build the kernels; check that every bf16 attention kernel is on the
    tensor cores -> {kernel label: (registers, spill stores, spill loads,
    HMMA count)}."""
    print("== card")
    print(f"card: {nvidia_smi_line()}")
    secs = build.build_all()
    PHASE_SECONDS["build"] = round(secs, 1)
    print(f"kernels built in {secs:.1f} s (nvcc, one process per source, "
          "in parallel)")
    report = {}
    # one cuobjdump a library, all at once
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(build.SOURCES)) as pool:
        sass = dict(zip(build.SOURCES, pool.map(
            lambda name: sass_hmma(build._lib_path(name)), build.SOURCES)))
    for name in build.SOURCES:
        regs = ptxas_report(build.build_log(name))
        hmma = sass[name]
        for fn, (n_regs, st, ld) in sorted(regs.items()):
            report[fn] = (n_regs, st, ld, hmma.get(fn, 0))
            print(f"ptxas {name}: {fn}: {n_regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B; SASS HMMA {hmma.get(fn, 0)}")
    for kern in MMA_KERNELS:
        found = {fn: r for fn, r in report.items() if fn.startswith(kern + "<")}
        # every one at head_dim 32 (a draft's heads), 64 and 128
        n_dims = 3
        if len(found) != n_dims or not all(r[3] > 0 for r in found.values()):
            fail(f"{kern}: expected HMMA instructions in all {n_dims} head "
                 f"dims' SASS, found {found}")
    return report


def phase_kernels(torch, A) -> list:
    """The flash forward kernel against its plain version at the edge
    cases; its timings at the main path's shapes -> its record."""
    print("== kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    errs = {"flash_fwd": 0.0}

    # ---- flash forward: out and lse against _flash_fwd_reference
    fwd_cases = [
        # (label, B, H, Lq, Lk, D, dtype, causal, window, plain on rows)
        ("causal L300", 8, 8, 300, 300, 128, torch.bfloat16, True, None, 8),
        ("causal L1024", 8, 8, 1024, 1024, 128, torch.bfloat16, True, None, 8),
        ("causal L2048", 8, 8, 2048, 2048, 128, torch.bfloat16, True, None, 8),
        ("causal L8192", 8, 8, 8192, 8192, 128, torch.bfloat16, True, None, 1),
        ("cross ragged Lq1024 Lk700", 2, 8, 1024, 700, 128, torch.bfloat16,
         False, None, 2),
        ("causal cross Lq300 Lk1000", 2, 8, 300, 1000, 128, torch.bfloat16,
         True, None, 2),
        ("window 256 L2048", 2, 8, 2048, 2048, 128, torch.bfloat16, True,
         256, 2),
        ("empty rows Lq1024 Lk300 w128", 1, 4, 1024, 300, 128,
         torch.bfloat16, True, 128, 1),
        ("f32 causal L1024", 2, 4, 1024, 1024, 128, torch.float32, True,
         None, 2),
        ("f32 D64 non-causal L777", 2, 4, 777, 777, 64, torch.float32, False,
         None, 2),
        ("bf16 D64 causal L512", 2, 4, 512, 512, 64, torch.bfloat16, True,
         None, 2),
        # head_dim 32: a draft model's (lm_generate's default draft dims)
        ("bf16 D32 causal L1024", 1, 4, 1024, 1024, 32, torch.bfloat16, True,
         None, 1),
        ("bf16 D32 window 128 ragged L300", 2, 4, 300, 300, 32,
         torch.bfloat16, True, 128, 2),
        ("f32 D32 causal L1024", 1, 4, 1024, 1024, 32, torch.float32, True,
         None, 1),
        ("f32 D32 cross ragged Lq777 Lk500", 2, 4, 777, 500, 32,
         torch.float32, False, None, 2),
    ]
    for label, b, h, lq, lk, d, dt, causal, window, rows in fwd_cases:
        q, k, v = randn(b, h, lq, d, dtype=dt), randn(b, h, lk, d, dtype=dt), \
            randn(b, h, lk, d, dtype=dt)
        out, lse = A.flash_attention_with_lse(q, k, v, causal=causal,
                                              window=window)
        torch.cuda.synchronize()
        p_out, p_lse = A._flash_fwd_reference(q[:rows], k[:rows], v[:rows],
                                              causal, None, window)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        e = compare(f"flash_fwd {label} out", out[:rows], p_out, tol)
        compare(f"flash_fwd {label} lse", lse[:rows], p_lse, LSE_TOL)
        if label.startswith("empty rows"):
            empty = torch.arange(lq, device=dev) >= lk + window - 1
            if not ((out[:, :, empty] == 0).all()
                    and (lse[:, :, empty] == A.NEG_INF).all()):
                fail("flash_fwd: a row with no visible key must give out 0 "
                     "and lse NEG_INF")
        errs["flash_fwd"] = max(errs["flash_fwd"], e)
        print(f"flash_fwd {label} {str(dt)[6:]}: max|err| {e:.3g}")
        del q, k, v, out, lse, p_out, p_lse

    # the model's layout: [B, L, H, D] views of a packed projection, read
    # through their strides, written into a [B, L, H, D] buffer
    qkv = randn(2, 1024, 3, 8, 128)
    q, k, v = qkv.unbind(2)
    out = A.attention_blhd(q, k, v, causal=True)
    want = A._flash_fwd_reference(*(t.transpose(1, 2) for t in (q, k, v)),
                                  True, None, None)[0].transpose(1, 2)
    e = compare("attention_blhd strided", out, want, BF16_TOL)
    errs["flash_fwd"] = max(errs["flash_fwd"], e)
    print(f"flash_fwd attention_blhd strided views: max|err| {e:.3g}")

    # ---- timings at the main path's shapes
    records = []
    # prefill of the main path's second request: B8 H8 L2048 D128 causal
    for b, l in ((8, 2048), (8, 1024), (1, 4096)):
        q, k, v = randn(b, 8, l, 128), randn(b, 8, l, 128), randn(b, 8, l, 128)
        ms = cuda_ms(lambda: A.flash_attention_with_lse(q, k, v, True), 10)
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10)
        plain = cuda_ms(lambda: A._flash_fwd_reference(q, k, v, True, None,
                                                       None), 3, warmup=1)
        flops = 4 * 128 * visible_pairs(l, l, True, None) * b * 8
        nbytes = 4 * b * 8 * l * 128 * 2 + b * 8 * l * 4
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        print(f"time flash_fwd B{b} H8 L{l} D128 bf16 causal: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {flops / ms / 1e9:.1f} TFLOP/s")
        if (b, l) == (8, 2048):
            records.append(dict(
                name="flash_fwd", route="cuda", design=DESIGNS["flash_fwd"],
                d32=_fwd_d32_times(torch, A, randn),
                tflops=flops / ms / 1e9,
                source="tony_tpu_torch/csrc/flash_fwd.cu",
                replaces="tony_tpu/ops/attention.py:241 (_fwd_kernel) and "
                         "tony_tpu/ops/attention.py:484 (_fwd_kernel_resident)",
                shape="B8 H8 L2048 D128 bf16 causal",
                max_abs_err=errs["flash_fwd"],
                tolerance="bf16 out: atol 1e-2 + rtol 1e-2; f32 out: 1e-4 + "
                          "1e-4; lse: 1e-3 + 1e-5",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib))
        del q, k, v

    return records


def _fwd_d32_times(torch, A, randn) -> dict:
    """K1 at head_dim 32, the speculative phase's draft prefill shape (B1
    H4 L1024 causal, bf16 and float32): kernel, plain, SDPA, bound."""
    out = {}
    for dt, peak in ((torch.bfloat16, PEAK_BF16_FLOPS),
                     (torch.float32, PEAK_F32_FLOPS)):
        b, h, l, d = 1, 4, 1024, 32
        q, k, v = (randn(b, h, l, d, dtype=dt) for _ in range(3))
        ms = cuda_ms(lambda: A.flash_attention_with_lse(q, k, v, True), 20)
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), 20)
        plain = cuda_ms(lambda: A._flash_fwd_reference(q, k, v, True, None,
                                                       None), 5, warmup=1)
        flops = 4 * d * visible_pairs(l, l, True, None) * b * h
        nbytes = 4 * b * h * l * d * q.element_size() + b * h * l * 4
        b_ms, b_by = bound(flops, nbytes, peak)
        name = str(dt)[6:]
        out[name] = dict(shape=f"B{b} H{h} L{l} D{d} {name} causal", ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by)
        print(f"time flash_fwd B{b} H{h} L{l} D{d} {name} causal: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
        del q, k, v
    return out


def phase_decode(torch, DA, G, T) -> list:
    """The decode kernel against its plain versions at the edge cases, its
    timings at four shapes, and the crossover against the einsum decode
    path -> its record."""
    print("== decode kernel")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2345)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    errs = {"flash_decode": 0.0}
    records = []
    # ---- flash decode: the whole function, its partials and its combine
    dec_cases = [
        # (label, Ly, B, kvH, rep, M, length, window, cache, layer, D)
        ("M1024 full", 1, 8, 8, 1, 1024, 1023, 0, "bf16", None, 128),
        ("M4096 full", 1, 8, 8, 1, 4096, 4095, 0, "bf16", None, 128),
        ("M4000 mid", 1, 8, 8, 1, 4000, 2500, 0, "bf16", None, 128),
        ("M16384 full", 1, 8, 8, 1, 16384, 16383, 0, "bf16", None, 128),
        ("length 0", 1, 8, 8, 1, 4096, 0, 0, "bf16", None, 128),
        ("GQA kvH2 rep4", 1, 8, 2, 4, 4096, 3000, 0, "bf16", None, 128),
        ("int8 M4096", 1, 8, 8, 1, 4096, 4000, 0, "int8", None, 128),
        ("window 1000", 1, 8, 8, 1, 4096, 3000, 1000, "bf16", None, 128),
        ("int8 window GQA", 1, 4, 4, 2, 4000, 3999, 700, "int8", None, 128),
        ("layer 2 of 3", 3, 8, 8, 1, 4096, 2049, 0, "bf16", 2, 128),
        ("int8 layer 1 of 3", 3, 8, 8, 1, 4096, 1500, 0, "int8", 1, 128),
        ("window 777 unaligned lo", 1, 8, 8, 1, 4096, 3000, 777, "bf16",
         None, 128),
        ("length M-1, M not a tile multiple", 1, 4, 8, 1, 4100, 4099, 0,
         "bf16", None, 128),
        ("rep 8", 1, 2, 2, 8, 4096, 3001, 0, "bf16", None, 128),
        ("D64 bf16", 1, 4, 8, 2, 3000, 2999, 0, "bf16", None, 64),
        ("float32 q and cache", 1, 2, 4, 2, 2000, 1500, 0, "f32", None, 128),
        # head_dim 32: the speculative phase's draft (B1 kvH4)
        ("D32 bf16 draft layer 1 of 2", 2, 1, 4, 1, 1093, 1060, 0, "bf16",
         1, 32),
        ("D32 f32 draft", 1, 1, 4, 1, 1093, 1087, 0, "f32", None, 32),
        ("D32 int8 GQA rep4", 1, 2, 2, 4, 3000, 2999, 0, "int8", None, 32),
        ("D32 f32 window 300", 1, 2, 4, 2, 2000, 1999, 300, "f32", None, 32),
    ]
    for label, ly, b, kvh, rep, m, length, window, cache, layer, d in \
            dec_cases:
        dt = torch.float32 if cache == "f32" else torch.bfloat16
        shape = (ly, b, kvh, m, d) if layer is not None else (b, kvh, m, d)
        q = randn(b, kvh, rep, d, dtype=dt)
        ck, cv, ks, vs = randn(*shape, dtype=dt), randn(*shape, dtype=dt), \
            None, None
        if cache == "int8":
            (ck, ks), (cv, vs) = G._quantize_kv(ck), G._quantize_kv(cv)
        out = DA.flash_decode(q, ck, cv, length, ks, vs, window=window,
                              layer=layer)
        torch.cuda.synchronize()
        want = DA._flash_decode_reference(q, ck, cv, length, ks, vs,
                                          window=window, layer=layer)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        e_all = compare(f"flash_decode {label}", out, want, tol)
        # the kernel's two stages: the chunks' partials in its scratch, and
        # its combine of them, each against its own plain version
        lo, hi = DA._valid_range(length, window)
        chunk, n_chunks = DA._kernel_split(hi - lo + 1, b * kvh, rep, d,
                                           ck.dtype)
        got, *parts = DA._decode_cuda(q, ck, cv, ks, vs, lo, length, chunk,
                                      n_chunks, layer)
        p_parts = DA._decode_partial_reference(q, ck, cv, ks, vs, lo, length,
                                               chunk, n_chunks, layer)
        e_p = max(compare(f"flash_decode {label} part_{nm}", g, w, PART_TOL)
                  for nm, g, w in zip("oml", parts, p_parts))
        e_c = compare(f"flash_decode {label} combine", got,
                      DA._decode_combine_reference(*parts, q.dtype), tol)
        # the in-kernel combine reads the partials in chunk order, whichever
        # CTA arrives last: the same inputs give the same bits
        again = DA._decode_cuda(q, ck, cv, ks, vs, lo, length, chunk,
                                n_chunks, layer)[0]
        if not torch.equal(got, again):
            fail(f"flash_decode {label}: two launches on the same inputs "
                 "differ")
        errs["flash_decode"] = max(errs["flash_decode"], e_all, e_c)
        print(f"flash_decode {label}: chunks {n_chunks}x{chunk}, max|err| "
              f"whole {e_all:.3g} partials {e_p:.3g} combine {e_c:.3g}; "
              "bit-equal on repeat")
        del q, ck, cv, ks, vs, out, want, got, parts, p_parts, again

    # decode timings, each over a stack of layers taken in turn, so that
    # every timed call finds its layer cold in L2 (50 MB), as the main path
    # does: (label, B, cached positions valid, capacity M, layers, int8)
    dec_shapes = [
        ("B8 kvH8 rep1 D128 bf16, 2081 of 4160", 8, 2081, MAX_LEN, N_LAYERS,
         False),
        ("B8 kvH8 rep1 D128 bf16, 16384 of 16384", 8, 16384, 16384, 2,
         False),
        ("B8 kvH8 rep1 D128 int8, 16384 of 16384", 8, 16384, 16384, 2, True),
        ("B1 kvH8 rep1 D128 bf16, 4097 of 4160", 1, 4097, MAX_LEN, N_LAYERS,
         False),
    ]
    kvh, d = 8, 128
    dec_rows = []
    for label, b, n_valid, m, ly, int8 in dec_shapes:
        q = randn(b, kvh, 1, d)
        ck, cv = randn(ly, b, kvh, m, d), randn(ly, b, kvh, m, d)
        ks = vs = None
        if int8:
            (ck, ks), (cv, vs) = G._quantize_kv(ck), G._quantize_kv(cv)
        length = n_valid - 1
        it = iter(range(10 ** 9))
        ms = cuda_ms(lambda: DA.flash_decode(q, ck, cv, length, ks, vs,
                                             layer=next(it) % ly), 48)
        plain = cuda_ms(lambda: DA._flash_decode_reference(
            q, ck, cv, length, ks, vs, layer=next(it) % ly), 6, warmup=1)
        lib = None
        if not int8:   # no one PyTorch call reads an int8 cache with scales
            def sdpa():
                i = next(it) % ly
                return torch.nn.functional.scaled_dot_product_attention(
                    q, ck[i, :, :, :n_valid], cv[i, :, :, :n_valid])
            lib = cuda_ms(sdpa, 48)
        # each valid K and V row read once (int8: with its two bf16 scales),
        # q read and the output written once
        row = d + 2 if int8 else 2 * d
        nbytes = 2 * b * kvh * n_valid * row + 2 * q.numel() * 2
        fl = 4 * d * n_valid * b * kvh
        b_ms, b_by = bound(fl, nbytes, PEAK_F32_FLOPS)
        chunk, n_chunks = DA._kernel_split(n_valid, b * kvh, 1, d, ck.dtype)
        dec_rows.append(dict(shape=label, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                             bytes=nbytes, chunks=n_chunks, chunk=chunk,
                             share_of_bound=b_ms / ms))
        print(f"time flash_decode {label} ({n_chunks} chunks of {chunk}): "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB), "
              f"{nbytes / ms / 1e6:.1f} GB/s = {b_ms / ms:.3f} of the bound")
        del q, ck, cv, ks, vs
    print("decode_times " + json.dumps(dec_rows))
    # the split's host cost: the wrapper searches it once a decode step (the
    # step's 12 layers share it; the next step's length is new)
    n_calls = 2000
    t0 = time.perf_counter()
    for n in range(2000, 2000 + n_calls):
        DA._kernel_split(n, 64, 1, 128, torch.bfloat16)
    split_us = (time.perf_counter() - t0) * 1e6 / n_calls
    print(f"decode split: {split_us:.2f} us a new length on the host (B8 "
          f"kvH8 rep1 D128 bf16); geometry (tile positions, CTAs an SM) "
          f"bf16 D128 rep1 {DA._geometry(128, torch.bfloat16, 1)}, int8 "
          f"{DA._geometry(128, torch.int8, 1)}, rep8 "
          f"{DA._geometry(128, torch.bfloat16, 8)}")
    first = dec_rows[0]
    records.append(dict(
        name="flash_decode", route="cuda",
        source="tony_tpu_torch/csrc/flash_decode.cu",
        replaces="tony_tpu/ops/decode_attention.py:43 (_decode_kernel; :118 "
                 "_kernel_no_scale)",
        design=DESIGNS["flash_decode"], shape=first["shape"],
        max_abs_err=errs["flash_decode"],
        tolerance="bf16 out: atol 1e-2 + rtol 1e-2; f32 out: 1e-4 + 1e-4; "
                  "f32 partials: 1e-4 + 1e-4",
        ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        library_ms=first["library_ms"],
        library="scaled_dot_product_attention over the valid positions",
        d32=_decode_d32_times(torch, DA, randn)))

    # ---- decode crossover: kernel against the plain einsum decode path
    b, kvh = 8, 8
    cfg = T.TransformerConfig(d_model=1024, n_heads=8, n_kv_heads=8,
                              n_layers=1, dtype=torch.bfloat16)
    rows = []
    for m in (1024, 4096, 16384):
        ly = max(1, min(N_LAYERS, math.ceil(200e6 / (2 * b * kvh * m * 256))))
        ck, cv = randn(ly, b, kvh, m, 128), randn(ly, b, kvh, m, 128)
        qm = randn(b, 1, 8, 128)
        it = iter(range(10 ** 9))
        kern = cuda_ms(lambda: G._cached_attention(
            cfg, qm, ck, cv, m - 1, 1, layer_idx=next(it) % ly), 24)
        eins = cuda_ms(lambda: G._cached_attention(
            cfg, qm, ck, cv, m - 1, 1, allow_kernel=False,
            layer_idx=next(it) % ly), 12)
        rows.append(dict(M=m, kernel_ms=kern, einsum_ms=eins,
                         kernel_faster=kern < eins))
        del ck, cv
    print("decode_crossover " + json.dumps(rows))
    return records


def _decode_d32_times(torch, DA, randn) -> dict:
    """K6 at head_dim 32, the speculative phase's draft steps (B1 kvH4
    rep1, 1057 of 1093 positions: mid-decode, a 1024-token prompt, 64 new
    and gamma 4), bf16 and float32, over the draft's 2 layers in turn (the
    cache is 0.56 MB: it stays in L2, as on the main path)."""
    out = {}
    b, kvh, d, m, n_valid, ly = 1, 4, 32, 1093, 1057, 2
    for dt in (torch.bfloat16, torch.float32):
        q = randn(b, kvh, 1, d, dtype=dt)
        ck, cv = randn(ly, b, kvh, m, d, dtype=dt), randn(ly, b, kvh, m, d,
                                                          dtype=dt)
        it = iter(range(10 ** 9))
        ms = cuda_ms(lambda: DA.flash_decode(q, ck, cv, n_valid - 1,
                                             layer=next(it) % ly), 48)
        plain = cuda_ms(lambda: DA._flash_decode_reference(
            q, ck, cv, n_valid - 1, layer=next(it) % ly), 12, warmup=1)

        def sdpa():
            i = next(it) % ly
            return torch.nn.functional.scaled_dot_product_attention(
                q, ck[i, :, :, :n_valid], cv[i, :, :, :n_valid])
        lib = cuda_ms(sdpa, 48)
        nbytes = 2 * b * kvh * n_valid * d * q.element_size() \
            + 2 * q.numel() * q.element_size()
        b_ms, b_by = bound(4 * d * n_valid * b * kvh, nbytes, PEAK_F32_FLOPS)
        name = str(dt)[6:]
        out[name] = dict(shape=f"B{b} kvH{kvh} rep1 D{d} {name}, {n_valid} "
                         f"of {m}", ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by)
        print(f"time flash_decode B{b} kvH{kvh} rep1 D{d} {name}, {n_valid} "
              f"of {m} (L2 warm): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        del q, ck, cv
    return out


def phase_bwd_kernels(torch, A) -> list:
    """The two flash backward kernels against _flash_bwd_reference on the
    card, then their timings at the training shape -> their records."""
    print("== backward kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    errs = {"flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    bf16 = torch.bfloat16
    cases = [
        # (label, B, H, Lq, Lk, D, dtype, causal, window, g_lse, plain rows)
        ("causal L300", 8, 8, 300, 300, 128, bf16, True, None, False, 8),
        ("causal L1024", 8, 8, 1024, 1024, 128, bf16, True, None, False, 8),
        ("causal L2048", 8, 8, 2048, 2048, 128, bf16, True, None, False, 4),
        ("window 256 L2048", 2, 8, 2048, 2048, 128, bf16, True, 256, False,
         2),
        ("causal cross Lq300 Lk1000", 2, 8, 300, 1000, 128, bf16, True, None,
         False, 2),
        ("cross ragged Lq1024 Lk700", 2, 8, 1024, 700, 128, bf16, False,
         None, False, 2),
        ("empty rows Lq1024 Lk300 w128", 1, 4, 1024, 300, 128, bf16, True,
         128, True, 1),
        ("f32 D64 non-causal L777", 2, 4, 777, 777, 64, torch.float32,
         False, None, False, 2),
        ("g_lse causal L1024", 2, 8, 1024, 1024, 128, bf16, True, None, True,
         2),
        ("bf16 D64 causal L512", 2, 4, 512, 512, 64, bf16, True, None, False,
         2),
        # head_dim 32: lm_generate's default draft (d128, 4 heads)
        ("bf16 D32 causal L1024", 1, 4, 1024, 1024, 32, bf16, True, None,
         False, 1),
        ("f32 D32 non-causal ragged L777", 2, 4, 777, 777, 32, torch.float32,
         False, None, False, 2),
    ]
    for label, b, h, lq, lk, d, dt, causal, window, with_glse, rows in cases:
        q, k, v = randn(b, h, lq, d, dtype=dt), randn(b, h, lk, d, dtype=dt), \
            randn(b, h, lk, d, dtype=dt)
        g = randn(b, h, lq, d, dtype=dt)
        g_lse = randn(b, h, lq, dtype=torch.float32) if with_glse else None
        out, lse = A._flash_fwd_cuda(q, k, v, causal, None, window)
        dq, dk, dv = A._flash_bwd_cuda(q, k, v, out, lse, g, g_lse, causal,
                                       None, window)
        torch.cuda.synchronize()
        want = A._flash_bwd_reference(
            q[:rows], k[:rows], v[:rows], out[:rows], lse[:rows], g[:rows],
            None if g_lse is None else g_lse[:rows], causal, None, window)
        tol = BWD_BF16_TOL if dt == bf16 else BWD_F32_TOL
        e_dq = compare(f"flash_bwd_dq {label} dq", dq[:rows], want[0], tol)
        e_kv = max(compare(f"flash_bwd_dkdv {label} dk", dk[:rows], want[1],
                           tol),
                   compare(f"flash_bwd_dkdv {label} dv", dv[:rows], want[2],
                           tol))
        if label.startswith("empty rows"):
            # query rows past the last key's window see no key
            empty = torch.arange(lq, device=dev) >= lk + window - 1
            if not (dq[:, :, empty] == 0).all():
                fail("flash_bwd_dq: a row with no visible key must get dq 0")
        if label.startswith("causal cross"):
            # keys past the last query row are seen by no query
            if not ((dk[:, :, lq:] == 0).all() and (dv[:, :, lq:] == 0).all()):
                fail("flash_bwd_dkdv: a key no query sees must get dk = dv = 0")
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e_dq)
        errs["flash_bwd_dkdv"] = max(errs["flash_bwd_dkdv"], e_kv)
        print(f"flash_bwd {label} {str(dt)[6:]}: max|err| dq {e_dq:.3g}, "
              f"dk/dv {e_kv:.3g}")
        del q, k, v, g, g_lse, out, lse, dq, dk, dv, want

    # the model's layout through autograd: [B, L, H, D] views of a packed
    # projection, and the expanded all-zero-stride cotangent of out.sum()
    with torch.enable_grad():
        qkv = randn(2, 1024, 3, 8, 128).requires_grad_()
        A.attention_blhd(*qkv.unbind(2), causal=True).sum().backward()
    qt, kt, vt = (t.transpose(1, 2) for t in qkv.detach().unbind(2))
    out, lse = A._flash_fwd_reference(qt, kt, vt, True, None, None)
    want = A._flash_bwd_reference(qt, kt, vt, out, lse, torch.ones_like(out),
                                  None, True, None, None)
    for i, (nm, w) in enumerate(zip(("dq", "dk", "dv"), want)):
        e = compare(f"flash_bwd attention_blhd {nm}", qkv.grad[:, :, i],
                    w.transpose(1, 2), BWD_BF16_TOL)
        key = "flash_bwd_dq" if nm == "dq" else "flash_bwd_dkdv"
        errs[key] = max(errs[key], e)
    print("flash_bwd attention_blhd strided views, out.sum() cotangent: ok")
    del qkv, out, lse, want

    # ---- timings at the training shape: B8 H8 L2048 D128 bf16 causal
    b, h, l, d = TRAIN_BATCH, 8, TRAIN_SEQ, 128
    q, k, v, g = (randn(b, h, l, d) for _ in range(4))
    out, lse = A._flash_fwd_cuda(q, k, v, True, None, None)
    delta = A._delta(out, g, None).contiguous()
    ms_kv = cuda_ms(lambda: A._flash_bwd_dkdv_cuda(q, k, v, g, lse, delta,
                                                   True, None, None), 10)
    ms_dq = cuda_ms(lambda: A._flash_bwd_dq_cuda(q, k, v, g, lse, delta,
                                                 True, None, None), 10)
    ms_whole = cuda_ms(lambda: A._flash_bwd_cuda(q, k, v, out, lse, g, None,
                                                 True, None, None), 10)
    plain = cuda_ms(lambda: A._flash_bwd_reference(q, k, v, out, lse, g, None,
                                                   True, None, None), 3,
                    warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        lib_fb = cuda_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), g), 10)
        lib_f = cuda_ms(lambda: sdpa(qg, kg, vg, is_causal=True), 10)
    lib = lib_fb - lib_f
    pairs = visible_pairs(l, l, True, None) * b * h
    x = b * h * l * d * 2            # one bf16 [B, H, L, D] tensor
    rowf = b * h * l * 4             # one float32 [B, H, L] tensor
    b_kv, by_kv = bound(8 * d * pairs, 4 * x + 2 * rowf + 2 * x,
                        PEAK_BF16_FLOPS)
    b_dq, by_dq = bound(6 * d * pairs, 4 * x + 2 * rowf + x, PEAK_BF16_FLOPS)
    # the whole backward: K3's work, five products per visible pair, on
    # q, k, v, out, dO and lse in and dq, dk, dv out
    b_w, by_w = bound(10 * d * pairs, 5 * x + rowf + 3 * x, PEAK_BF16_FLOPS)
    print(f"time flash_bwd B{b} H{h} L{l} D{d} bf16 causal: dkdv {ms_kv:.4f} "
          f"ms (bound {b_kv:.4f} {by_kv}), dq {ms_dq:.4f} ms (bound "
          f"{b_dq:.4f} {by_dq}), whole {ms_whole:.4f} ms (plain {plain:.4f}, "
          f"sdpa backward {lib:.4f} = {lib_fb:.4f} fwd+bwd - {lib_f:.4f} fwd, "
          f"bound {b_w:.4f} {by_w}), "
          f"{10 * d * pairs / ms_whole / 1e9:.1f} TFLOP/s of K3's work; dkdv "
          f"{8 * d * pairs / ms_kv / 1e9:.1f}, dq {6 * d * pairs / ms_dq / 1e9:.1f}"
          " TFLOP/s of their functions' work")
    print("bwd_whole " + json.dumps(dict(
        shape=f"B{b} H{h} L{l} D{d} bf16 causal", ms=ms_whole,
        dkdv_ms=ms_kv, dq_ms=ms_dq, plain_ms=plain, library_ms=lib,
        library_fwd_bwd_ms=lib_fb, library_fwd_ms=lib_f, bound_ms=b_w,
        bound_by=by_w)))
    del q, k, v, g, out, lse, delta, qg, kg, vg
    d32 = _bwd_d32_times(torch, A, randn)
    records = []
    for name, ms, bms, bby, flops, replaces in (
            ("flash_bwd_dkdv", ms_kv, b_kv, by_kv, 8 * d * pairs,
             "tony_tpu/ops/attention.py:524 (_bwd_kernel_resident, dK/dV) and "
             "tony_tpu/ops/attention.py:342 (_kv_sweep_kernel)"),
            ("flash_bwd_dq", ms_dq, b_dq, by_dq, 6 * d * pairs,
             "tony_tpu/ops/attention.py:297 (_dq_kernel) and the dQ of "
             "tony_tpu/ops/attention.py:524 (_bwd_kernel_resident)")):
        records.append(dict(
            name=name, route="cuda", design=DESIGNS[name],
            tflops=flops / ms / 1e9, d32=d32[name],
            source="tony_tpu_torch/csrc/flash_bwd.cu",
            replaces=replaces, shape=f"B{b} H{h} L{l} D{d} bf16 causal",
            max_abs_err=errs[name],
            tolerance="bf16: atol 1e-2 + rtol 1e-2; f32: atol 1e-3 + rtol "
                      "1e-4",
            ms=ms, plain_ms=plain, bound_ms=bms, bound_by=bby,
            library_ms=lib,
            library="scaled_dot_product_attention backward (forward+backward "
                    "minus forward), the whole backward; plain_ms is the "
                    "whole plain backward too"))
    return records


def _bwd_d32_times(torch, A, randn) -> dict:
    """K3-K5 at head_dim 32, the draft-training shape (B8 H4 L512 causal:
    lm_train at lm_generate's default draft dims, batch 8 x 512), bf16 and
    the float32 route: each kernel and the whole backward against the bound
    (worked out as at D = 128, float32 products on the FP32 pipes), the
    plain backward and SDPA's (fwd+bwd - fwd) -> {kernel name: {dtype
    name: its row}}."""
    b, h, l, d = 8, 4, 512, 32
    out_rows = {"flash_bwd_dkdv": {}, "flash_bwd_dq": {}}
    for dt, peak in ((torch.bfloat16, PEAK_BF16_FLOPS),
                     (torch.float32, PEAK_F32_FLOPS)):
        q, k, v, g = (randn(b, h, l, d, dtype=dt) for _ in range(4))
        out, lse = A._flash_fwd_cuda(q, k, v, True, None, None)
        delta = A._delta(out, g, None).contiguous()
        ms_kv = cuda_ms(lambda: A._flash_bwd_dkdv_cuda(
            q, k, v, g, lse, delta, True, None, None), 20)
        ms_dq = cuda_ms(lambda: A._flash_bwd_dq_cuda(
            q, k, v, g, lse, delta, True, None, None), 20)
        ms_whole = cuda_ms(lambda: A._flash_bwd_cuda(
            q, k, v, out, lse, g, None, True, None, None), 20)
        plain = cuda_ms(lambda: A._flash_bwd_reference(
            q, k, v, out, lse, g, None, True, None, None), 5, warmup=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.enable_grad():
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            lib_fb = cuda_ms(lambda: torch.autograd.grad(
                sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), g), 20)
            lib_f = cuda_ms(lambda: sdpa(qg, kg, vg, is_causal=True), 20)
        lib = lib_fb - lib_f
        pairs = visible_pairs(l, l, True, None) * b * h
        x, rowf = b * h * l * d * q.element_size(), b * h * l * 4
        b_kv, by_kv = bound(8 * d * pairs, 4 * x + 2 * rowf + 2 * x, peak)
        b_dq, by_dq = bound(6 * d * pairs, 4 * x + 2 * rowf + x, peak)
        b_w, by_w = bound(10 * d * pairs, 5 * x + rowf + 3 * x, peak)
        name = str(dt)[6:]
        shape = f"B{b} H{h} L{l} D{d} {name} causal"
        print(f"time flash_bwd {shape}: dkdv {ms_kv:.4f} ms (bound "
              f"{b_kv:.4f} {by_kv}), dq {ms_dq:.4f} ms (bound {b_dq:.4f} "
              f"{by_dq}), whole {ms_whole:.4f} ms (plain {plain:.4f}, sdpa "
              f"backward {lib:.4f} = {lib_fb:.4f} fwd+bwd - {lib_f:.4f} fwd, "
              f"bound {b_w:.4f} {by_w})")
        common = dict(shape=shape, whole_ms=ms_whole, whole_bound_ms=b_w,
                      whole_bound_by=by_w, plain_ms=plain, library_ms=lib,
                      library_fwd_bwd_ms=lib_fb, library_fwd_ms=lib_f)
        out_rows["flash_bwd_dkdv"][name] = dict(common, ms=ms_kv,
                                                bound_ms=b_kv, bound_by=by_kv)
        out_rows["flash_bwd_dq"][name] = dict(common, ms=ms_dq, bound_ms=b_dq,
                                              bound_by=by_dq)
        del q, k, v, g, out, lse, delta, qg, kg, vg
    return out_rows


def _tree_bytes(tree) -> int:
    """Bytes of the distinct storages under a (nested) dict of tensors."""
    seen, total = set(), 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif node.untyped_storage().data_ptr() not in seen:
            seen.add(node.untyped_storage().data_ptr())
            total += node.untyped_storage().nbytes()
    return total


def _w8a16_costs(torch, G, T, n_experts: int = 0,
                 n_layers: int = N_LAYERS) -> dict:
    """w8a16 at the flagship width (``n_experts`` > 0: its MoE model, routed
    drop-free as generate routes it): the weights a decode holds (cast
    params and fused matrices, the float32 masters dropped), native
    against int8; a decode step's device time at B8 with 1024 cached; the
    logits of one decode step from the same cache and token, int8 against
    native; for MoE also the B8 x 1024 prefill's device time."""
    dev = torch.device("cuda")
    cfg = G.moe_dropfree(T.TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=n_layers, n_heads=8,
        n_kv_heads=8, d_ff=4096, n_experts=n_experts))
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(4), dev)
    prompt = torch.randint(0, 32768, (8, 1024), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    native = G.prepare_decode(params, cfg)
    cache0 = G.init_cache(cfg, 8, 1024 + MAX_NEW, device=dev)
    logits, cache = G._forward_with_cache(native.params, cfg, prompt, cache0,
                                          native.fused, prefill=True)
    tok = logits.argmax(-1)[:, None]
    out = {"masters_gb": _tree_bytes(params) / 1e9}
    step_logits = {}
    for name in ("native", "int8"):
        w = native if name == "native" else G.prepare_decode(
            params, cfg, weight_dtype="int8")
        c = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone())
        step_logits[name] = G._forward_with_cache(w.params, cfg, tok, c,
                                                  w.fused)[0]
        # a step is hundreds of launches, enqueued slower than the card
        # runs them: its device time is the profiler's sum of its kernels
        ms, _ = _profiled_ms(torch, lambda: [G._forward_with_cache(
            w.params, cfg, tok, c, w.fused) for _ in range(4)])
        if ms is None:
            fail("w8a16: the profiler recorded no device time")
        ms /= 4
        out[name] = dict(resident_gb=(_tree_bytes(w.params)
                                      + _tree_bytes(w.fused)) / 1e9,
                         decode_step_device_ms=ms)
        if n_experts:
            out[name]["prefill_device_ms"] = cuda_ms(
                lambda: G._forward_with_cache(w.params, cfg, prompt, cache0,
                                              w.fused, prefill=True), 2,
                warmup=1)
        del c
    diff = (step_logits["int8"] - step_logits["native"]).abs().max()
    ref = step_logits["native"]
    out.update(step_logits_max_diff=float(diff),
               native_logits_range=float(ref.max() - ref.min()))
    return out


def phase_main_path(torch, ops, lm_generate, G, T) -> dict:
    """The flagship generation path through its user entry point; returns
    the launches of each kernel over all requests. The last request decodes
    on int8 weights (w8a16); its costs against native are measured in
    process after the requests."""
    print("== main path: generation")
    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    totals = dict.fromkeys(ops.launch_counts(), 0)
    for i, (b, lp, extra) in enumerate(REQUESTS):
        metrics = out_dir / f"request{i}.json"
        argv = FLAGSHIP + ["--batch", str(b), "--prompt-len", str(lp),
                           "--max-new", str(MAX_NEW), "--max-len",
                           str(MAX_LEN), "--seed", str(i),
                           "--metrics-out", str(metrics)] + extra
        ops.reset_launch_counts()
        rc = lm_generate.main(argv)
        counts = ops.launch_counts()
        if rc != 0:
            fail(f"lm_generate exited {rc} on request {i}")
        m = json.loads(metrics.read_text())
        # lm_generate runs generate three times: warm-up, timed, and a
        # prefill-only run (max_new_tokens=1)
        want = {"flash_fwd": 3 * N_LAYERS,
                "flash_decode": 2 * N_LAYERS * (MAX_NEW - 1),
                "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
        if counts != want:
            fail(f"request {i}: launches {counts}, expected {want}")
        toks = m["tokens"]
        if (len(toks) != MAX_NEW or m["decode_steps"] != MAX_NEW - 1
                or not all(0 <= t < 32768 for t in toks)):
            fail(f"request {i}: bad output {m}")
        for name, n in counts.items():
            totals[name] += n
        print(f"request {i}: batch {b} prompt {lp} "
              f"{m['kv_dtype']} kv, {m['weight_dtype']} weights: prefill {m['prefill_ms']:.2f} ms, decode "
              f"{m['decode_step_ms']:.3f} ms/step, "
              f"{m['batch_decode_tokens_per_sec']:.1f} tok/s "
              f"(batch), {m['decode_tokens_per_sec']:.1f} tok/s (per row, "
              f"with prefill); launches {counts}")
        print("request " + json.dumps(dict(
            request=i, batch=b, prompt_len=lp, kv_dtype=m["kv_dtype"],
            weight_dtype=m["weight_dtype"],
            prefill_ms=m["prefill_ms"], decode_step_ms=m["decode_step_ms"],
            batch_decode_tokens_per_sec=m["batch_decode_tokens_per_sec"],
            decode_tokens_per_sec=m["decode_tokens_per_sec"],
            launches=counts)))
    torch.cuda.empty_cache()
    with torch.no_grad():
        w8 = _w8a16_costs(torch, G, T)
    torch.cuda.empty_cache()
    print(f"w8a16: resident weights {w8['int8']['resident_gb']:.3f} GB "
          f"against native {w8['native']['resident_gb']:.3f} (float32 "
          f"masters {w8['masters_gb']:.3f}, dropped); a decode step B8 with "
          f"1024 cached {w8['int8']['decode_step_device_ms']:.4f} ms on the "
          f"device against native {w8['native']['decode_step_device_ms']:.4f}"
          f"; the step's logits max |int8 - native| "
          f"{w8['step_logits_max_diff']:.4f} (native range "
          f"{w8['native_logits_range']:.3f}); {nvidia_smi_line()}")
    print("w8a16 " + json.dumps(w8))
    return totals


def phase_train_path(torch, ops, lm_train) -> tuple:
    """The flagship training path through its user entry point; returns the
    launches of each kernel over the run, its losses, its peak device
    memory (GB) and its step's wall ms."""
    print("== main path: training")
    metrics = REPO / "build" / "chip_smoke" / "train.json"
    metrics.parent.mkdir(parents=True, exist_ok=True)
    argv = FLAGSHIP + ["--batch-size", str(TRAIN_BATCH), "--seq-len",
                       str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
                       "--metrics-out", str(metrics)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rc = lm_train.main(argv)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        fail(f"lm_train exited {rc}")
    per_step = TRAIN_STEPS * N_LAYERS
    want = {"flash_fwd": per_step, "flash_bwd_dkdv": per_step,
            "flash_bwd_dq": per_step, "flash_decode": 0}
    if counts != want:
        fail(f"training: launches {counts}, expected {want}")
    m = json.loads(metrics.read_text())
    losses = m["losses"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"training: losses not all finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training: loss did not fall: {losses[0]} -> {losses[-1]}")
    flops_step = train_flops_per_token(1024, N_LAYERS, 4096, 32768,
                                       TRAIN_SEQ) * TRAIN_BATCH * TRAIN_SEQ
    achieved = flops_step * m["steps_per_sec"]
    print(f"training B{TRAIN_BATCH} L{TRAIN_SEQ}, {TRAIN_STEPS} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {m['steps_per_sec']:.3f} "
          f"steps/s, {m['tokens_per_sec']:.1f} tokens/s, model FLOPs "
          f"{flops_step / 1e12:.2f} TFLOP/step = {achieved / 1e12:.1f} TFLOP/s"
          f", {achieved / PEAK_BF16_FLOPS:.4f} of the bf16 peak; launches "
          f"{counts}")
    print("train " + json.dumps(dict(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        first_loss=losses[0], final_loss=losses[-1], losses=losses,
        steps_per_sec=m["steps_per_sec"], tokens_per_sec=m["tokens_per_sec"],
        step_ms=1e3 / m["steps_per_sec"], model_flops_per_step=flops_step,
        model_flops_share_of_bf16_peak=achieved / PEAK_BF16_FLOPS,
        n_params=m["n_params"], peak_gb=peak_gb, launches=counts)))
    return counts, losses, peak_gb, 1e3 / m["steps_per_sec"]


def phase_remat(torch, ops, lm_train, A, train) -> dict:
    """lm_train --remat at the training path's shape, REMAT_STEPS steps
    under each policy: losses bit-equal to the training phase's first
    steps (remat off), the flash forward launched twice a layer a step
    under "full" and "dots" and once under "attn", the backward kernels
    once; peak device memory. Then chunked_reference_attention against the
    plain attention at float32. -> the launches over the runs."""
    print("== remat")
    from tony_tpu_torch.parallel.ring_attention import reference_attention

    losses_off, peak_off, step_ms_off = train
    rows = {"off": dict(losses=losses_off[:REMAT_STEPS], peak_gb=peak_off,
                        step_ms_wall=step_ms_off)}
    totals = dict.fromkeys(ops.launch_counts(), 0)
    per_step = REMAT_STEPS * N_LAYERS
    for policy in REMAT_POLICIES:
        metrics = REPO / "build" / "chip_smoke" / f"remat_{policy}.json"
        argv = FLAGSHIP + ["--batch-size", str(TRAIN_BATCH), "--seq-len",
                           str(TRAIN_SEQ), "--steps", str(REMAT_STEPS),
                           "--remat", "--remat-policy", policy,
                           "--metrics-out", str(metrics)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rc = lm_train.main(argv)
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if rc != 0:
            fail(f"remat {policy}: lm_train exited {rc}")
        forwards = 1 if policy == "attn" else 2
        want = {"flash_fwd": forwards * per_step, "flash_bwd_dkdv": per_step,
                "flash_bwd_dq": per_step, "flash_decode": 0}
        if counts != want:
            fail(f"remat {policy}: launches {counts}, expected {want}")
        m = json.loads(metrics.read_text())
        if m["losses"] != losses_off[:REMAT_STEPS]:
            fail(f"remat {policy}: losses {m['losses']} differ from remat "
                 f"off's {losses_off[:REMAT_STEPS]}")
        rows[policy] = dict(losses=m["losses"], losses_bit_equal_to_off=True,
                            peak_gb=peak_gb,
                            step_ms_wall=1e3 / m["steps_per_sec"],
                            flash_fwd_a_step=counts["flash_fwd"]
                            / REMAT_STEPS,
                            flash_bwd_a_step=counts["flash_bwd_dq"]
                            / REMAT_STEPS)
        for name, n in counts.items():
            totals[name] += n
        print(f"remat {policy}: {REMAT_STEPS} steps, losses bit-equal to "
              f"remat off's; peak {peak_gb:.2f} GB (off {peak_off:.2f}); "
              f"{rows[policy]['step_ms_wall']:.1f} ms a step wall (off "
              f"{step_ms_off:.1f}); flash forward {counts['flash_fwd']} "
              f"launches, backward {counts['flash_bwd_dq']} + "
              f"{counts['flash_bwd_dkdv']}")
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(1, 8, TRAIN_SEQ, 128, device="cuda", generator=g,
                           requires_grad=True) for _ in range(3))
    t0 = time.perf_counter()
    out = A.chunked_reference_attention(q, k, v, causal=True, q_block=512)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    want = reference_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                               causal=True).transpose(1, 2)
    want_grads = torch.autograd.grad(want.sum(), (q, k, v))
    err = compare("chunked_reference_attention", out, want, F32_TOL)
    grad_err = max(compare(f"chunked_reference_attention d{n}", a, b,
                           BWD_F32_TOL)
                   for n, a, b in zip("qkv", grads, want_grads))
    rows["chunked_reference_attention"] = dict(
        shape=f"B1 H8 L{TRAIN_SEQ} D128 float32 causal, q_block 512",
        max_abs_err=err, grad_max_abs_err=grad_err, seconds=chunked_s)
    print(f"remat: chunked_reference_attention B1 H8 L{TRAIN_SEQ} D128 "
          f"float32 against the plain attention: max |diff| {err:.3g} "
          f"(tolerance {F32_TOL}), gradients {grad_err:.3g} "
          f"({BWD_F32_TOL}); {nvidia_smi_line()}")
    print("remat " + json.dumps(dict(rows=rows, launches=totals)))
    return totals


def _quantiles(xs) -> dict:
    xs = sorted(xs)
    return dict(p50=xs[len(xs) // 2], max=xs[-1])


def _post(url: str, payload: dict) -> tuple:
    """(HTTP status, body, seconds) of one POST /generate; status None
    when the connection failed."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, data=json.dumps(payload).encode(),
                                    timeout=600) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0
    except OSError as e:
        return None, repr(e), time.perf_counter() - t0


def phase_serving(torch, ops) -> tuple:
    """The serving path through its user entry point: the serve CLI's
    build_argparser, build_app and make_httpd on 127.0.0.1, 24 concurrent
    POST /generate (run A, predictive mode); a direct SlotServer with a
    stop token (run B, EOS mode); one decode block's wall and device time.
    Returns the kernels' launches over runs A and B (all must be 0: the
    serving path runs the einsum attention, as the JAX package's does) and
    run A's record."""
    print("== main path: serving")
    import threading

    from tony_tpu_torch.cli import serve
    from tony_tpu_torch.models import generate as G
    from tony_tpu_torch.models import serving as S

    torch.cuda.empty_cache()
    args = serve.build_argparser().parse_args(FLAGSHIP + ["--seed", "21"])
    app = serve.build_app(args)
    srv = app.server
    print(f"serving: {srv.slots} slots x {srv.max_len} positions, blocks of "
          f"{srv.block_size} steps, prefill chunks of {srv.prefill_chunk} "
          f"(the CLI's defaults), on {srv.device}")
    # a synchronisation inside a decode block's dispatch raises (and fails
    # the run's requests); the admissions' ones are counted, by source line
    syncs = _checked_dispatch(torch, srv)
    rng, lens, news, sampled, payloads = _serve_payloads()
    httpd = serve.make_httpd(app, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    app.start()
    results = [None] * SERVE_REQUESTS
    try:
        ops.reset_launch_counts()
        warm = _post(url, dict(prompt=list(range(1, 300)), max_new_tokens=40))
        if warm[0] != 200:
            fail(f"serving: warm-up request answered {warm[0]}: {warm[1]}")
        syncs["admission"] = 0
        syncs["sites"].clear()
        before = (srv.admission_dispatches, srv.blocks_dispatched,
                  len(srv.block_dispatch_s))

        def post(i):
            results[i] = _post(url, payloads[i])

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(SERVE_REQUESTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        health = app.health()
        builds = _build_families(app)
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.shutdown()
    del srv._dispatch_block, srv._admit
    for i, (res, pl) in enumerate(zip(results, payloads)):
        if res is None or res[0] != 200:
            fail(f"serving run A: request {i} answered {res}")
        body = res[1]
        toks = body["tokens"]
        if (body["finish_reason"] != "length"
                or len(toks) != pl["max_new_tokens"]
                or not all(0 <= t < 32768 for t in toks)):
            fail(f"serving run A: request {i}: bad completion "
                 f"{body['finish_reason']}, {len(toks)} tokens of "
                 f"{pl['max_new_tokens']}")
    if any(counts.values()):
        fail(f"serving run A: kernels launched {counts}, expected none")
    if app.loop_failures or not health["healthy"]:
        fail(f"serving run A: the loop failed: {health}")
    out_tokens = int(news.sum())
    lat = _quantiles([r[2] for r in results])
    disp = [s * 1e3 for s in list(srv.block_dispatch_s)[before[2]:]]
    run_a = dict(
        requests=SERVE_REQUESTS, sampled=sorted(sampled),
        prompt_tokens=int(lens.sum()), output_tokens=out_tokens,
        wall_s=wall, requests_per_s=SERVE_REQUESTS / wall,
        output_tokens_per_s=out_tokens / wall,
        latency_s_p50=lat["p50"], latency_s_max=lat["max"],
        admission_dispatches=srv.admission_dispatches - before[0],
        decode_blocks=srv.blocks_dispatched - before[1],
        block_dispatch_ms_p50=_quantiles(disp)["p50"],
        admission_syncs=syncs["admission"], launches=counts,
        kernel_builds=builds)
    print(f"serving run A: {SERVE_REQUESTS} requests ({SERVE_SAMPLED} "
          f"sampled), {run_a['prompt_tokens']} prompt and {out_tokens} output "
          f"tokens in {wall:.3f} s: {run_a['requests_per_s']:.3f} requests/s, "
          f"{run_a['output_tokens_per_s']:.1f} output tokens/s; latency p50 "
          f"{lat['p50']:.3f} s, max {lat['max']:.3f} s; "
          f"{run_a['admission_dispatches']} prefill calls, "
          f"{run_a['decode_blocks']} decode blocks, a block's host dispatch "
          f"{run_a['block_dispatch_ms_p50']:.2f} ms (median); "
          f"synchronisations: 0 in the blocks' dispatch, "
          f"{syncs['admission']} in admission "
          f"{dict(syncs['sites'])}; launches {counts}")
    print(f"serving run A /metrics: serving_kernel_builds_total "
          f"{builds['total']} (this process's libraries {builds['noted']}, "
          f"{builds['seconds']:.3f} s of nvcc and loads), "
          f"serving_kernel_builds_post_warm_total {builds['post_warm']} "
          f"after the warm-up line")

    # ---- one decode block: wall time against device time, 8 busy slots
    blk = _profile_block(torch, S, srv, rng, "serving")
    run_a.update(block_wall_ms=blk["wall_ms"], block_walls_ms=blk["walls_ms"],
                 block_device_ms=blk["device_ms"],
                 block_busy_share=blk["busy_share"])

    # ---- run B: EOS mode, a stop token taken from run 0's stream
    prepared = G.DecodeWeights(srv._params, srv._fused)
    cfg = srv.cfg
    del app, srv
    torch.cuda.empty_cache()
    prompts = [rng.integers(0, 32768, int(n)).tolist()
               for n in rng.integers(64, 513, 8)]

    def run(stop_tokens):
        eng = S.SlotServer(prepared, cfg, stop_tokens=stop_tokens, seed=3)
        reqs = [S.Request(prompt=p, max_new_tokens=48) for p in prompts]
        for r in reqs:
            eng.submit(r)
        got = eng.run_until_drained()
        return [got[r.id] for r in reqs]

    free = run(())
    stop = free[0].tokens[3]
    ops.reset_launch_counts()
    eos = run((stop,))
    counts_b = ops.launch_counts()
    if any(counts_b.values()):
        fail(f"serving run B: kernels launched {counts_b}, expected none")
    n_stop = 0
    for i, c in enumerate(eos):
        if c.finish_reason == "stop":
            n_stop += 1
            ok = c.tokens[-1] == stop and stop not in c.tokens[:-1]
        else:
            ok = (c.finish_reason == "length" and len(c.tokens) == 48
                  and stop not in c.tokens)
        if not ok:
            fail(f"serving run B: request {i} ended {c.finish_reason} with "
                 f"{len(c.tokens)} tokens, stop token {stop}")
    if n_stop == 0:
        fail("serving run B: the stop token never fired")
    same = sum(c.tokens == f.tokens[:len(c.tokens)] for c, f in zip(eos, free))
    print(f"serving run B (EOS mode, stop token {stop}): {n_stop} of 8 ended "
          f"on it, the others on their budget of 48; {same} of 8 streams "
          f"equal the stop-free run's up to their end; launches {counts_b}")
    run_b = dict(stop=stop, stopped=n_stop, prefix_of_free_run=same,
                 launches=counts_b)
    print("serving " + json.dumps(dict(run_a=run_a, run_b=run_b)))
    return {k: counts[k] + counts_b[k] for k in counts}, run_a


def _build_families(app) -> dict:
    """(c) of the observability hooks: run A's /metrics build families
    after warm-up. Every kernel library this process built or loaded is
    counted, none after the warm-up line (training's first measured step
    or the first delivered completion, whichever came first), and /stats'
    ``compile`` says the same."""
    from tony_tpu_torch.ops import _build

    _, samples = _exposition(app.prometheus_metrics())
    total = samples["serving_kernel_builds_total"]
    post = samples["serving_kernel_builds_post_warm_total"]
    count = samples["serving_kernel_build_seconds_count"]
    comp = app.stats()["compile"]
    noted = _build.noted()
    if (post != 0 or total != len(noted) or not comp["warm"]
            or comp["kernel_builds"] != total or count != total):
        fail(f"serving run A /metrics: kernel builds {total} (libraries "
             f"{noted}), {post} after warm-up, the histogram's count "
             f"{count}, /stats {comp}: expected every library once and "
             "none after warm-up")
    return dict(total=int(total), post_warm=int(post), noted=noted,
                seconds=comp["kernel_build_time_s"])


def _serve_payloads():
    """Run A's requests: (the generator, prompt lengths, new tokens, the
    sampled ones, the POST /generate bodies), drawn from seed 21."""
    import numpy as np

    rng = np.random.default_rng(21)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    news = rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1, SERVE_REQUESTS)
    sampled = set(rng.choice(SERVE_REQUESTS, SERVE_SAMPLED, replace=False)
                  .tolist())
    payloads = [dict(prompt=rng.integers(0, 32768, int(n)).tolist(),
                     max_new_tokens=int(m), timeout_s=600.0,
                     **(dict(temperature=0.8, top_k=50) if i in sampled
                        else {}))
                for i, (n, m) in enumerate(zip(lens, news))]
    return rng, lens, news, sampled, payloads


def _device_time_check(name, got, base, base_name):
    """Streams and telemetry may add no device time: a block's device time
    fails when it is more than 1% above its baseline block's, at the same
    depth; a faster block breaks no promise. The signed difference is
    printed either way -> it (None when either time was not measured)."""
    if got is None or base is None:
        print(f"{name}: a block's device time against {base_name}: not "
              "measured (the profiler recorded no device activity)")
        return None
    diff = (got - base) / base
    print(f"{name}: a block's device time {got:.3f} ms against {base_name} "
          f"{base:.3f} ms: {diff:+.2%} (limit +1%)")
    if got > 1.01 * base:
        fail(f"{name}: a block's device time {got:.3f} ms, more than 1% "
             f"above {base_name} {base:.3f} ms")
    return diff


def _profile_block(torch, S, srv, rng, name, streams=False) -> dict:
    """One decode block of 8 busy slots (1024-token prompts, 128 new, about
    1030-1140 positions cached): its wall time over 5 blocks and its device
    time under torch.profiler, the profiled block queued behind a 20 ms
    device sleep (left out of the sum), as ``_profiled_ms`` does: the
    profiler can miss the first kernels of a region. With ``streams``,
    each request has a TokenStream attached, which must deliver its
    completion."""
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.api.stream import TokenStream

    reqs = [S.Request(prompt=rng.integers(0, 32768, 1024).tolist(),
                      max_new_tokens=128) for _ in range(8)]
    attached = {}
    for r in reqs:
        srv.submit(r)
        if streams:
            attached[r.id] = TokenStream()
            srv.attach_stream(r.id, attached[r.id])
    srv.step()                      # admits all 8, dispatches a block
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        srv._dispatch_block()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(0.02 * 2e9))
        srv._dispatch_block()
        torch.cuda.synchronize()
    done = srv.run_until_drained()
    if sorted(len(done[r.id].tokens) for r in reqs) != [128] * 8:
        fail(f"{name}: the profiled requests did not complete")
    for rid, ts in attached.items():
        if ts.drain_all(timeout=60) != (done[rid].tokens, "length", None):
            fail(f"{name}: request {rid}'s stream is not its completion")
    block_ms = _quantiles(walls)["p50"]
    dev_ms, top, _ = _profile_rows(prof, 1)
    print(f"{name}: decode block (8 slots, ~1030-1140 cached, 16 steps"
          + (", 8 streams attached" if streams else "") + ") wall ms over "
          "5 blocks: " + " ".join(f"{w:.2f}" for w in walls)
          + f" (median {block_ms:.2f})")
    if top:
        print(f"{name}: decode block {block_ms:.3f} ms wall, {dev_ms:.3f} ms "
              f"on the device, busy share {dev_ms / block_ms:.3f}")
        print(f"{name}_profile_top " + json.dumps(top))
    else:
        print(f"{name}: decode block device time not measured (the profiler "
              "recorded no device activity)")
    return dict(wall_ms=block_ms, walls_ms=walls,
                device_ms=dev_ms if top else None,
                busy_share=dev_ms / block_ms if top else None)


def _near_tie_check(name, got, want, gaps, n) -> dict:
    """Tokens must equal the reference's up to its first step whose top-2
    logit gap is below PARITY_NEAR_TIE; past it float32 summation order
    may pick the other token. -> the row for the record."""
    near = [j for j, g in enumerate(gaps) if g < PARITY_NEAR_TIE]
    first_near = near[0] if near else n
    diverge = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                   None)
    if len(got) != n or (diverge is not None and diverge < first_near):
        fail(f"{name}: diverges from its reference at step {diverge}, the "
             f"reference's first near-tie at {first_near}")
    return dict(diverge=diverge, near_ties=[(j, gaps[j]) for j in near])


def _clone_tree(torch, tree):
    return {k: _clone_tree(torch, v) if isinstance(v, dict)
            else v.detach().clone() for k, v in tree.items()}


def _trees_equal(torch, a, b) -> bool:
    return all(_trees_equal(torch, v, b[k]) if isinstance(v, dict)
               else torch.equal(v, b[k]) for k, v in a.items())


def _post_all(url, payloads) -> list:
    """POST every payload at once -> (status, body, seconds) each."""
    import threading

    results = [None] * len(payloads)

    def post(i):
        results[i] = _post(url, payloads[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    for i, res in enumerate(results):
        if res is None or res[0] != 200:
            fail(f"request {i} answered {res}")
    return results


def _serve_app(serve, argv):
    """serve's app from its own argparser on 127.0.0.1, with the codec its
    --text-codec names -> (app, httpd, the /generate URL), started."""
    import threading

    from tony_tpu_torch.api.openai import TokenCodec

    args = serve.build_argparser().parse_args(argv)
    app = serve.build_app(args)
    httpd = serve.make_httpd(app, "127.0.0.1", 0,
                             TokenCodec(args.text_codec, vocab_size=args.vocab))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    app.start()
    return app, httpd, f"http://127.0.0.1:{httpd.server_address[1]}/generate"


def _stop_app(app, httpd) -> None:
    httpd.shutdown()
    httpd.server_close()
    app.shutdown()


def _elastic_drill(out_dir: Path) -> dict:
    """The elastic-training drill on the card, each attempt a process of
    its own: a straight run, and a run preempted by the executor's flag
    file once its step log passes ELASTIC_FLAG_AT, then relaunched. The
    relaunch must resume at the last kept checkpoint + 1, log every step,
    recompute at most the save interval and end at the straight run's
    final value."""
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    procs = []

    def launch(name, extra_env=None):
        env = {**os.environ, "PYTHONPATH": str(REPO),
               "TONY_STEP_LOG": str(out_dir / f"{name}.jsonl"),
               **(extra_env or {})}
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.examples.elastic_train",
             "--ckpt-dir", str(out_dir / name), "--steps",
             str(ELASTIC_STEPS), "--save-interval", "5", "--dim", "1024"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        return proc

    def finish(proc, want_rc):
        out, err = proc.communicate(timeout=300)
        if proc.returncode != want_rc:
            fail(f"elastic drill exited {proc.returncode}, expected "
                 f"{want_rc}:\n{err[-2000:]}")
        return out

    def steps(name):
        log = out_dir / f"{name}.jsonl"
        if not log.exists():
            return []
        return [json.loads(x)["train_step"]
                for x in log.read_text().splitlines() if x.strip()]

    try:
        t0 = time.perf_counter()
        straight = launch("straight")
        # steps of 50 ms: the flag's poll (every 0.25 s) lands well before
        # the run's end
        slow = {"ELASTIC_TRAIN_STEP_MS": "50"}
        pre = launch("preempted", slow)
        deadline = time.monotonic() + 240
        while not any(s >= ELASTIC_FLAG_AT for s in steps("preempted")):
            if time.monotonic() > deadline or pre.poll() is not None:
                fail("elastic drill: the preempted run never reached step "
                     f"{ELASTIC_FLAG_AT}")
            time.sleep(0.01)
        (out_dir / "preempted.jsonl.preempt").write_text("{}")
        out = finish(pre, 79)
        drained = int(out.split("checkpointed step ")[1].split(",")[0])
        kept = sorted(int(p.name) for p in (out_dir / "preempted").iterdir()
                      if p.name.isdigit())
        want = json.loads(finish(straight, 0).strip().splitlines()[-1])
        out = finish(launch("preempted", slow), 0)
        got = json.loads(out.strip().splitlines()[-1])
        wall = time.perf_counter() - t0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logged = steps("preempted")
    if f"resumed from checkpoint step {kept[-1]}" not in out:
        fail(f"elastic drill: the relaunch did not resume at {kept[-1]}")
    if (sorted(set(logged)) != list(range(ELASTIC_STEPS))
            or len(logged) - ELASTIC_STEPS > 5):
        fail(f"elastic drill: steps logged {logged}")
    if got != want:
        fail(f"elastic drill: relaunched run ended {got}, straight {want}")
    return dict(drained_at=drained, kept=kept, resumed_at=kept[-1] + 1,
                recomputed=len(logged) - ELASTIC_STEPS, final=got,
                wall_s=wall)


def phase_checkpoint(torch, ops, lm_train, lm_generate, train_losses) -> dict:
    """Checkpoints join training to serving, at the training path's width
    and batch: lm_train straight and split by a resume (losses equal to
    the bit when the card repeats a run to the bit; else within the
    run-to-run spread measured here), lm_generate and serve's app
    restored from the resumed run's directory against generate on the
    parameters held at its last step, the elastic drill preempted and
    relaunched. Returns the kernels' launches over these runs."""
    print("== main path: checkpoints")
    import numpy as np

    from tony_tpu_torch.cli import serve
    from tony_tpu_torch.models import generate as G
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.train import checkpoint as C
    from tony_tpu_torch.train.step import make_optimizer

    root = CKPT_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    managers, stalls, held = [], [], []
    real_save_async = C.CheckpointManager.save_async

    def timed_save_async(self, step, state):
        t0 = time.perf_counter()
        ok = real_save_async(self, step, state)
        stalls.append((step, time.perf_counter() - t0, ok))
        if self not in managers:
            managers.append(self)
        if step == CKPT_STEPS - 1 and ok:
            held.append(_clone_tree(torch, state["params"]))
        return ok

    totals = dict.fromkeys(ops.launch_counts(), 0)

    def train(name, steps, ckpt_dir):
        metrics = root / f"{name}.json"
        argv = FLAGSHIP + ["--batch-size", str(TRAIN_BATCH), "--seq-len",
                           str(TRAIN_SEQ), "--steps", str(steps),
                           "--checkpoint-dir", str(ckpt_dir),
                           "--checkpoint-every", str(CKPT_EVERY),
                           "--metrics-out", str(metrics)]
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        rc = lm_train.main(argv)
        counts = ops.launch_counts()
        if rc != 0:
            fail(f"lm_train ({name}) exited {rc}")
        want = {"flash_fwd": steps * N_LAYERS, "flash_bwd_dkdv":
                steps * N_LAYERS, "flash_bwd_dq": steps * N_LAYERS,
                "flash_decode": 0}
        if counts != want:
            fail(f"lm_train ({name}): launches {counts}, expected {want}")
        for k, n in counts.items():
            totals[k] += n
        kept = sorted(int(p.name) for p in ckpt_dir.iterdir()
                      if p.name.isdigit())
        return json.loads(metrics.read_text())["losses"], kept

    C.CheckpointManager.save_async = timed_save_async
    try:
        straight, kept_a = train("straight", CKPT_STEPS, root / "a")
        shutil.rmtree(root / "a")
        first, kept_b1 = train("first", CKPT_SPLIT, root / "b")
        resumed, kept_b = train("resumed", CKPT_STEPS - CKPT_SPLIT,
                                root / "b")
    finally:
        C.CheckpointManager.save_async = real_save_async
    keep_want = [s for s in range(CKPT_EVERY, CKPT_STEPS, CKPT_EVERY)]
    if (kept_a != keep_want or kept_b != keep_want
            or kept_b1 != [s for s in keep_want if s < CKPT_SPLIT]):
        fail(f"checkpoints kept: straight {kept_a}, split {kept_b1} then "
             f"{kept_b}; expected {keep_want}")
    # two straight runs: the training path's and this one
    repeat_spread = max(abs(a - b) for a, b in zip(straight, train_losses))
    bitwise = straight == train_losses[:CKPT_STEPS]
    resume_err = max(abs(a - b) for a, b in
                     zip(first + resumed, straight))
    same_params = len(held) == 2 and _trees_equal(torch, held[0], held[1])
    if len(resumed) != CKPT_STEPS - CKPT_SPLIT or not all(
            map(math.isfinite, first + resumed)):
        fail(f"checkpoints: resumed losses {resumed}")
    if bitwise and (first + resumed != straight or not same_params):
        fail("checkpoints: the card repeats a straight run to the bit, but "
             f"the resumed run differs (max |loss diff| {resume_err}, "
             f"parameters at step {CKPT_STEPS - 1} equal: {same_params})")
    if not bitwise and resume_err > repeat_spread:
        fail(f"checkpoints: the resumed losses differ by {resume_err}, "
             f"beyond two straight runs' spread {repeat_spread}")
    print(f"checkpoints: straight {CKPT_STEPS} steps kept {kept_a}; "
          f"{CKPT_SPLIT} steps kept {kept_b1}, resumed at {CKPT_SPLIT} for "
          f"{CKPT_STEPS - CKPT_SPLIT} steps kept {kept_b}; two straight runs "
          f"{'agree to the bit' if bitwise else f'differ by {repeat_spread}'}"
          f"; resumed losses against straight: max |diff| {resume_err} "
          f"(parameters at step {CKPT_STEPS - 1} bit-equal: {same_params})")
    saves = [dict(rec) for m in managers for rec in m.saves]
    ckpt_bytes = saves[0]["bytes"]
    stall_ms = [s * 1e3 for _, s, ok in stalls if ok]
    write_s = [rec["write_s"] for rec in saves]
    params = held[-1]
    template = {"params": params,
                "opt_state": make_optimizer().init(params)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = C.CheckpointManager(str(root / "b")).restore(template=template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if not _trees_equal(torch, restored["params"], params):
        fail("checkpoints: restored parameters differ from the run's")
    del restored, template
    print(f"checkpoints: {ckpt_bytes} bytes a checkpoint (parameters and "
          f"both AdamW moments, float32); {len(stall_ms)} saves, the loop "
          f"inside save_async " + " ".join(f"{x:.1f}" for x in stall_ms)
          + " ms; the writer " + " ".join(f"{x:.2f}" for x in write_s)
          + f" s; restore on the card {restore_s:.2f} s; "
          f"{nvidia_smi_line()}")

    # ---- lm_generate from the checkpoint, bf16 kernels, against generate
    # on the parameters held at the last step
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, 32768, 300).tolist()
    metrics = root / "generate.json"
    n_new = 32
    ops.reset_launch_counts()
    rc = lm_generate.main(FLAGSHIP + [
        "--checkpoint-dir", str(root / "b"), "--prompt",
        " ".join(map(str, prompt)), "--max-new", str(n_new),
        "--metrics-out", str(metrics)])
    counts = ops.launch_counts()
    if rc != 0:
        fail(f"lm_generate --checkpoint-dir exited {rc}")
    want = {"flash_fwd": 3 * N_LAYERS, "flash_decode":
            2 * N_LAYERS * (n_new - 1), "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    if counts != want:
        fail(f"lm_generate --checkpoint-dir: launches {counts}, expected "
             f"{want}")
    for k, n in counts.items():
        totals[k] += n
    bcfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=12,
                               n_heads=8, n_kv_heads=8, d_ff=4096)
    mem = G.generate(G.prepare_decode(params, bcfg), bcfg,
                     torch.tensor([prompt], device="cuda"), n_new)
    gen_tokens = json.loads(metrics.read_text())["tokens"]
    if gen_tokens != mem[0].tolist():
        fail("lm_generate --checkpoint-dir: tokens differ from generate on "
             "the parameters held in memory")
    print(f"checkpoints: lm_generate --checkpoint-dir (bf16, kernels): "
          f"{n_new} tokens equal generate on the held parameters; launches "
          f"{counts}")

    # ---- serve's app from the checkpoint, float32, against solo generate
    # (kernels) on the held parameters, up to the first near-tie
    fcfg = dataclasses.replace(bcfg, dtype=torch.float32)
    w32 = G.prepare_decode(params, fcfg)
    prompts = [rng.integers(0, 32768, int(n)).tolist()
               for n in rng.integers(64, 301, 4)]
    n_serve = 24
    ops.reset_launch_counts()
    app, httpd, url = _serve_app(serve, FLAGSHIP + [
        "--dtype", "float32", "--checkpoint-dir", str(root / "b"),
        "--slots", "4", "--max-len", "1024"])
    try:
        results = _post_all(url, [dict(prompt=p, max_new_tokens=n_serve)
                                  for p in prompts])
    finally:
        _stop_app(app, httpd)
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"serve --checkpoint-dir: kernels launched {counts}")
    rows = []
    for i, (p, res) in enumerate(zip(prompts, results)):
        toks, gaps = _solo_greedy(torch, G, w32, fcfg, p, n_serve)
        rows.append(_near_tie_check(f"serve --checkpoint-dir request {i}",
                                    res[1]["tokens"], toks, gaps, n_serve))
    agree = sum(r["diverge"] is None for r in rows)
    print(f"checkpoints: serve --checkpoint-dir (float32, 4 requests over "
          f"HTTP): {agree} of 4 token-identical to solo generate on the held "
          f"parameters, the others only at or after a near-tie")
    del app, w32, params, held
    torch.cuda.empty_cache()

    # the resumed run's directory stays for the speculative phase, which
    # serves and drafts against it and then deletes the tree
    for sub in root.iterdir():
        if sub.name != "b":
            shutil.rmtree(sub) if sub.is_dir() else sub.unlink()
    print("checkpoint " + json.dumps(dict(
        straight_losses=straight, first_losses=first,
        resumed_losses=resumed, kept=dict(straight=kept_a, first=kept_b1,
                                          resumed=kept_b),
        straight_runs_bitwise=bitwise, straight_runs_spread=repeat_spread,
        resume_max_abs_diff=resume_err, params_bit_equal=same_params,
        checkpoint_bytes=ckpt_bytes, save_async_stall_ms=stall_ms,
        writer_s=write_s, snapshot_s=[r["snapshot_s"] for r in saves],
        restore_s=restore_s, generate_tokens_equal=True,
        serve_parity=rows, launches=totals,
        card=nvidia_smi_line())))
    return totals


def _prefix_prompts(seed: int) -> list:
    """PREFIX_REQUESTS prompts: one shared PREFIX_LEN-token prefix, each
    with its own suffix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 32768, PREFIX_LEN)
    lens = rng.integers(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1,
                        PREFIX_REQUESTS)
    return [np.concatenate([prefix, rng.integers(0, 32768, int(n))]).tolist()
            for n in lens]


def phase_prefix_cache(torch, ops) -> dict:
    """The serving prefix cache at the flagship width through serve's app
    (the CLI's defaults and --prefix-cache-blocks PREFIX_BLOCKS): a cold
    pass and a warm pass of the shared-prefix traffic, cold and warm TTFT
    (one-token requests, a burst of 8) and an admission burst's wall time;
    then the cache's completions against a cacheless server's at float32
    (2 layers, native and int8 KV). Returns the kernels' launches (none:
    the serving path runs the einsum attention) and the admission bursts'
    record."""
    print("== main path: prefix cache")
    from tony_tpu_torch.cli import serve
    from tony_tpu_torch.models import generate as G
    from tony_tpu_torch.models import serving as S
    from tony_tpu_torch.models import transformer as T

    torch.cuda.empty_cache()
    prompts = _prefix_prompts(31)
    chunk = 128
    # every full chunk of a body (the prompt less its last token) is in the
    # pool after the cold pass, so the warm pass copies them all
    reuse_want = sum((len(p) - 1) // chunk * chunk for p in prompts)
    ops.reset_launch_counts()
    app, httpd, url = _serve_app(serve, FLAGSHIP + [
        "--seed", "31", "--prefix-cache-blocks", str(PREFIX_BLOCKS)])
    srv = app.server
    pool = srv._pool
    pool_bytes = sum(t.numel() * t.element_size() for t in (pool.k, pool.v))
    if pool_bytes != PREFIX_BLOCKS * chunk * N_LAYERS * 8 * 128 * 2 * 2:
        fail(f"prefix cache: pool of {pool_bytes} bytes")

    def stats():
        with app.lock:
            return srv.stats()

    def requests(n_new, subset):
        return [dict(prompt=p, max_new_tokens=n_new) for p in subset]

    try:
        s0 = stats()
        t0 = time.perf_counter()
        cold = _post_all(url, requests(PREFIX_NEW, prompts))
        cold_wall = time.perf_counter() - t0
        s1 = stats()
        t0 = time.perf_counter()
        warm = _post_all(url, requests(PREFIX_NEW, prompts))
        warm_wall = time.perf_counter() - t0
        s2 = stats()
        with app.lock:
            srv.reset()                 # an empty pool and trie
        ttft_cold = _post_all(url, requests(1, prompts[:8]))
        ttft_warm = _post_all(url, requests(1, prompts[:8]))
        s3 = stats()
    finally:
        _stop_app(app, httpd)
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"prefix cache: kernels launched {counts}, expected none")
    for name, res in (("cold", cold), ("warm", warm)):
        for i, (_, body, _) in enumerate(res):
            toks = body["tokens"]
            if (body["finish_reason"] != "length" or len(toks) != PREFIX_NEW
                    or not all(0 <= t < 32768 for t in toks)):
                fail(f"prefix cache {name} pass: request {i}: {body}")

    def delta(a, b, key):
        return b["prefix_cache"][key] - a["prefix_cache"][key]

    reused_warm = s2["prefill_tokens_reused"] - s1["prefill_tokens_reused"]
    if (delta(s1, s2, "hits") != PREFIX_REQUESTS
            or delta(s1, s2, "misses") != 0 or reused_warm != reuse_want):
        fail(f"prefix cache warm pass: hits {delta(s1, s2, 'hits')}, "
             f"misses {delta(s1, s2, 'misses')}, reused {reused_warm} "
             f"tokens (expected {PREFIX_REQUESTS}, 0, {reuse_want})")
    same = sum(c[1]["tokens"] == w[1]["tokens"] for c, w in zip(cold, warm))
    lat_cold = _quantiles([r[2] for r in cold])
    lat_warm = _quantiles([r[2] for r in warm])
    q_cold = _quantiles([r[2] for r in ttft_cold])
    q_warm = _quantiles([r[2] for r in ttft_warm])

    # ---- one admission burst of 8, cold (every request misses, as on a
    # cacheless server) then warm (every request hits), to the device's
    # end; their bf16 completions, with the cold run's top-2 logit gap
    # where they part
    srv.reset()
    admit, burst = {}, {}
    for name in ("cold", "warm"):
        before = srv.stats()
        reqs = [S.Request(prompt=p, max_new_tokens=PREFIX_NEW,
                          logprobs=2 if name == "cold" else 0)
                for p in prompts[:8]]
        for r in reqs:
            srv.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv._admit()
        torch.cuda.synchronize()
        after = srv.stats()
        admit[name] = dict(
            ms=(time.perf_counter() - t0) * 1e3,
            computed=after["prefill_tokens_computed"]
            - before["prefill_tokens_computed"],
            reused=after["prefill_tokens_reused"]
            - before["prefill_tokens_reused"],
            prefill_calls=after["admission_dispatches"]
            - before["admission_dispatches"])
        done = srv.run_until_drained()
        burst[name] = [done[r.id] for r in reqs]
    parted = []
    for i, (c, w) in enumerate(zip(burst["cold"], burst["warm"])):
        j = next((j for j, (a, b) in enumerate(zip(c.tokens, w.tokens))
                  if a != b), None)
        if j is not None:
            top = c.logprobs[j]["top"][1]
            parted.append(dict(request=i, step=j, cold_gap=top[0] - top[1]))
    print(f"prefix cache: {PREFIX_REQUESTS} requests sharing a {PREFIX_LEN}"
          f"-token prefix, suffixes {PREFIX_SUFFIX[0]}-{PREFIX_SUFFIX[1]}, "
          f"{PREFIX_NEW} new each; pool {PREFIX_BLOCKS} blocks = {pool_bytes}"
          f" bytes; cold pass {cold_wall:.3f} s (hits "
          f"{delta(s0, s1, 'hits')}, misses {delta(s0, s1, 'misses')}, "
          f"reused {s1['prefill_tokens_reused'] - s0['prefill_tokens_reused']}"
          f" tokens), warm pass {warm_wall:.3f} s (hits "
          f"{delta(s1, s2, 'hits')}, reused {reused_warm} tokens = "
          f"{PREFIX_REQUESTS} x {PREFIX_LEN} + "
          f"{reused_warm - PREFIX_REQUESTS * PREFIX_LEN} of the suffixes' "
          f"full chunks); latency p50 cold {lat_cold['p50']:.3f} s, warm "
          f"{lat_warm['p50']:.3f} s; {same} of {PREFIX_REQUESTS} warm "
          f"completions equal the cold ones (bf16)")
    print(f"prefix cache: TTFT (one-token requests, 8 at once) p50 cold "
          f"{q_cold['p50'] * 1e3:.1f} ms, warm {q_warm['p50'] * 1e3:.1f} ms;"
          f" an admission burst of 8 to the device's end: cold "
          f"{admit['cold']['ms']:.1f} ms ({admit['cold']['computed']} tokens "
          f"prefilled, {admit['cold']['prefill_calls']} prefill calls), warm "
          f"{admit['warm']['ms']:.1f} ms ({admit['warm']['computed']} "
          f"prefilled, {admit['warm']['reused']} copied, "
          f"{admit['warm']['prefill_calls']} calls); {nvidia_smi_line()}")
    print(f"prefix cache: the bursts' bf16 completions: "
          f"{8 - len(parted)} of 8 warm (hit) equal the cold (miss) ones; "
          f"the others part at (request, step, the cold stream's top-2 logit "
          f"gap) " + ", ".join(f"({r['request']}, {r['step']}, "
                               f"{r['cold_gap']:.4f})" for r in parted))
    prepared = G.DecodeWeights(srv._params, srv._fused)
    del app, srv, pool, prepared
    torch.cuda.empty_cache()

    # ---- completions with and without the cache, float32, 2 layers
    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    w = G.prepare_decode(T.init(cfg, torch.Generator(device=dev)
                                .manual_seed(33), dev), cfg)
    pprompts = _prefix_prompts(33)
    rows = []
    for kv in ("native", "int8"):
        ref = S.SlotServer(w, cfg, kv_dtype=kv)
        reqs = [S.Request(prompt=p, max_new_tokens=PREFIX_NEW, logprobs=2)
                for p in pprompts]
        for r in reqs:
            ref.submit(r)
        done = ref.run_until_drained()
        want = [done[r.id] for r in reqs]
        hit = S.SlotServer(w, cfg, kv_dtype=kv,
                           prefix_cache_blocks=PREFIX_BLOCKS)
        for pass_ in ("cold", "warm"):
            reqs = [S.Request(prompt=p, max_new_tokens=PREFIX_NEW)
                    for p in pprompts]
            for r in reqs:
                hit.submit(r)
            done = hit.run_until_drained()
            for i, (r, c) in enumerate(zip(reqs, want)):
                gaps = [e["top"][1][0] - e["top"][1][1] for e in c.logprobs]
                rows.append(dict(kv=kv, pass_=pass_, request=i,
                                 **_near_tie_check(
                                     f"prefix cache parity ({kv}, {pass_})",
                                     done[r.id].tokens, c.tokens, gaps,
                                     PREFIX_NEW)))
        st = hit.stats()
        if st["prefix_cache"]["hits"] < PREFIX_REQUESTS:
            fail(f"prefix cache parity ({kv}): {st['prefix_cache']}")
        del ref, hit
    agree = sum(r["diverge"] is None for r in rows)
    print(f"prefix cache parity (float32, 2 layers, cold and warm passes, "
          f"native and int8 KV): {agree} of {len(rows)} streams "
          f"token-identical to the cacheless server, every other one only "
          f"at or after a near-tie (gap < {PARITY_NEAR_TIE})")
    print("prefix_cache " + json.dumps(dict(
        requests=PREFIX_REQUESTS, prefix=PREFIX_LEN, new=PREFIX_NEW,
        pool_blocks=PREFIX_BLOCKS, pool_bytes=pool_bytes,
        cold=dict(wall_s=cold_wall, latency_s_p50=lat_cold["p50"],
                  hits=delta(s0, s1, "hits"),
                  misses=delta(s0, s1, "misses"),
                  reused=s1["prefill_tokens_reused"]
                  - s0["prefill_tokens_reused"]),
        warm=dict(wall_s=warm_wall, latency_s_p50=lat_warm["p50"],
                  hits=delta(s1, s2, "hits"),
                  misses=delta(s1, s2, "misses"), reused=reused_warm),
        warm_equal_cold_bf16=same, ttft_ms_p50=dict(
            cold=q_cold["p50"] * 1e3, warm=q_warm["p50"] * 1e3),
        ttft_stats=s3["prefix_cache"], admission=admit,
        burst_bf16_parted=parted,
        parity=[r for r in rows if r["diverge"] is not None or r["near_ties"]],
        parity_identical=agree, parity_streams=len(rows), launches=counts,
        card=nvidia_smi_line())))
    return counts, admit


def _crash_harness(srv, reqs) -> tuple:
    """Drive a SlotServer as ServeApp's loop does (checkpoint_progress when
    no completion is ready; reset() after a step's exception) to the end
    -> (completions by id, the journaled prefix each replay resumed from,
    by id). Only the chaos hook's exceptions are expected."""
    for r in reqs:
        srv.submit(r)
    done, prefixes = {}, collections.defaultdict(list)
    while not srv.idle:
        try:
            srv.step()
            if srv.completions_ready:
                done.update(srv.drain_completed())
            else:
                srv.checkpoint_progress()
        except RuntimeError as e:
            if "chaos" not in str(e):
                raise
            lost = srv.reset()
            if lost:
                fail(f"replay: reset() lost {lost}")
            for r in srv._queue:
                if r.resume_tokens is not None:
                    prefixes[r.id].append(list(r.resume_tokens))
    done.update(srv.drain_completed())
    return done, prefixes


def _check_prefixes(name, tokens, prefixes) -> None:
    """Every completion begins with each journaled prefix it resumed from."""
    for p in prefixes:
        if tokens[:len(p)] != p:
            fail(f"{name}: a completion does not begin with its journaled "
                 f"prefix of {len(p)} tokens")


def _replay_direct(torch, G, T, S) -> list:
    """(a): the flagship widths at 2 layers in float32, REPLAY_F32 requests
    through 3 slots, TONY_TEST_SERVING_CRASH_AT_BLOCKS at two mid-decode
    ordinals, against the same server without a crash: token-identical up
    to the crashless run's first near-tie (native KV); the journaled
    prefixes verbatim and at least half the streams equal (int8 KV, the
    reference's carve-out)."""
    import numpy as np

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    w = G.prepare_decode(T.init(cfg, torch.Generator(device=dev)
                                .manual_seed(43), dev), cfg)
    rng = np.random.default_rng(43)
    prompts = [rng.integers(0, 32768, int(n)).tolist()
               for n in rng.integers(64, 513, REPLAY_F32)]
    rows = []
    for kv in ("native", "int8"):
        ref = S.SlotServer(w, cfg, slots=3, max_len=1024, kv_dtype=kv)
        reqs = [S.Request(prompt=p, max_new_tokens=REPLAY_F32_NEW,
                          logprobs=2) for p in prompts]
        for r in reqs:
            ref.submit(r)
        got = ref.run_until_drained()
        want = [got[r.id] for r in reqs]
        os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"] = REPLAY_F32_CRASH
        try:
            srv = S.SlotServer(w, cfg, slots=3, max_len=1024, kv_dtype=kv)
        finally:
            del os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"]
        reqs = [S.Request(prompt=p, max_new_tokens=REPLAY_F32_NEW)
                for p in prompts]
        done, prefixes = _crash_harness(srv, reqs)
        if srv.chaos_faults_injected != 2 or srv.replays < 1:
            fail(f"replay (a, {kv}): {srv.chaos_faults_injected} crashes, "
                 f"{srv.replays} replays")
        equal = 0
        for i, (r, c) in enumerate(zip(reqs, want)):
            toks = done[r.id].tokens
            _check_prefixes(f"replay (a, {kv})", toks, prefixes[r.id])
            equal += toks == c.tokens
            row = dict(kv=kv, request=i,
                       resumed_from=[len(p) for p in prefixes[r.id]])
            if kv == "native":
                gaps = [e["top"][1][0] - e["top"][1][1] for e in c.logprobs]
                row.update(_near_tie_check(f"replay (a, {kv})", toks,
                                           c.tokens, gaps, REPLAY_F32_NEW))
            elif len(toks) != REPLAY_F32_NEW:
                fail(f"replay (a, {kv}): request {i} has {len(toks)} tokens")
            rows.append(row)
        if kv == "int8" and equal * 2 < REPLAY_F32:
            fail(f"replay (a, int8): {equal} of {REPLAY_F32} streams equal "
                 "the crashless run's")
        print(f"replay (a, float32, 2 layers, {kv} KV): {REPLAY_F32} "
              f"requests through 3 slots, crashes at decode blocks "
              f"{REPLAY_F32_CRASH}, "
              f"{srv.replays} replays ({srv.replayed_tokens} journaled "
              f"tokens); {equal} of {REPLAY_F32} streams token-identical to "
              f"the crashless server"
              + ("" if kv == "int8" else ", every other one only at or after"
                 f" a near-tie (gap < {PARITY_NEAR_TIE})"))
        del ref, srv
    del w
    torch.cuda.empty_cache()
    return rows


def _replay_http(torch, serve, payloads, crash_blocks) -> dict:
    """(b), one burst: serve's app at the flagship width with the CLI's
    defaults, a one-block warm-up request, then every payload at once;
    with ``crash_blocks`` set, TONY_TEST_SERVING_CRASH_AT_BLOCKS is those
    ordinals. Every block's dispatch runs under sync debug mode "error".
    -> the burst's record (completions in payload order)."""
    if crash_blocks:
        os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"] = ",".join(
            str(b) for b in crash_blocks)
    try:
        app, httpd, url = _serve_app(serve, SHALLOW + ["--seed", "41"])
    finally:
        os.environ.pop("TONY_TEST_SERVING_CRASH_AT_BLOCKS", None)
    srv = app.server
    rec = dict(decoded=0, inflight_at_crash=[], replay_bound=0, prefixes={})
    dispatch, reset = srv._dispatch_block, srv.reset

    def checked_dispatch():
        before = srv._model_len.copy()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            rec["decoded"] += int((srv._model_len - before).sum())

    def counted_reset():
        rec["inflight_at_crash"].append(len(srv._inflight))
        lost = reset()
        for r in srv._queue:
            if r.resume_tokens is not None:
                rec["prefixes"].setdefault(r.id, []).append(
                    list(r.resume_tokens))
                rec["replay_bound"] += len(r.prompt) + len(
                    r.resume_tokens) - 1
        return lost

    srv._dispatch_block, srv.reset = checked_dispatch, counted_reset
    try:
        warm = _post(url, dict(prompt=list(range(1, 300)), max_new_tokens=16))
        if warm[0] != 200:
            fail(f"replay (b): warm-up answered {warm[0]}: {warm[1]}")
        with app.lock:
            s0 = srv.stats()
        rec["decoded"] = 0
        t0 = time.perf_counter()
        results = _post_all(url, payloads)
        rec["wall_s"] = time.perf_counter() - t0
        with app.lock:
            s1 = srv.stats()
        health = app.health()
        rec.update(loop_restarts=app.loop_restarts,
                   failures=app.loop_failures)
    finally:
        _stop_app(app, httpd)
        del srv._dispatch_block, srv.reset
    rec.update(
        warm_blocks=s0["blocks_dispatched"],
        blocks=s1["blocks_dispatched"] - s0["blocks_dispatched"],
        prefill_computed=s1["prefill_tokens_computed"]
        - s0["prefill_tokens_computed"],
        replays=s1["replays"] - s0["replays"],
        replayed_tokens=s1["replayed_tokens"] - s0["replayed_tokens"],
        crashes=s1["chaos_faults_injected"], healthy=health["healthy"],
        completions=[(r[1]["id"], r[1]["tokens"], r[1]["finish_reason"])
                     for r in results])
    del app
    torch.cuda.empty_cache()
    return rec


def _replay_sigkill(torch) -> dict:
    """(c): ``python -m tony_tpu_torch.cli.serve`` at the flagship width
    with --trace-dir under build/, REPLAY_KILL requests posted at once, the
    process SIGKILLed by TONY_TEST_SERVING_SIGKILL_AT_BLOCK; then the same
    command without the hook. It must print the resumed count (>= 1),
    reach idle with replays >= that count, and compact the journal to no
    live entry. -> the restart's times: to the journal line (imports and
    the model's load), to the serving line, to idle."""
    import threading
    import urllib.request

    import numpy as np

    from tony_tpu_torch.events import JOURNAL_FILE, read_journal

    trace = REPO / "build" / "replay_trace"
    shutil.rmtree(trace, ignore_errors=True)
    argv = [sys.executable, "-m", "tony_tpu_torch.cli.serve", "--port", "0",
            *SHALLOW, "--seed", "51", "--trace-dir", str(trace)]
    procs = []

    def spawn(extra_env):
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, "PYTHONPATH": str(REPO),
                            **extra_env})
        procs.append(proc)
        return proc, t0

    def read_until_port(proc, t0):
        """-> (port, its output lines, seconds at which each line came);
        a thread keeps appending the rest of its output to the lines."""
        lines, at = [], []
        while True:
            line = proc.stdout.readline()
            if not line:
                fail(f"replay (c): serve exited {proc.wait()} before "
                     f"serving:\n{''.join(lines)[-3000:]}")
            lines.append(line)
            at.append(time.perf_counter() - t0)
            m = re.search(r"http://[\d.]+:(\d+)", line)
            if m:
                threading.Thread(target=lambda: lines.extend(proc.stdout),
                                 daemon=True).start()
                return int(m.group(1)), lines, at

    rng = np.random.default_rng(51)
    payloads = [dict(prompt=rng.integers(0, 32768, int(n)).tolist(),
                     max_new_tokens=REPLAY_KILL_NEW, timeout_s=600.0)
                for n in rng.integers(256, 1025, REPLAY_KILL)]
    try:
        # a one-block warm-up request first, as in (b): the burst then
        # meets a warm process; the kill comes REPLAY_KILL_BLOCK blocks
        # after it
        proc, t0 = spawn({"TONY_TEST_SERVING_SIGKILL_AT_BLOCK":
                          str(1 + REPLAY_KILL_BLOCK)})
        port, lines, _ = read_until_port(proc, t0)
        url = f"http://127.0.0.1:{port}/generate"
        warm = _post(url, dict(prompt=list(range(1, 300)), max_new_tokens=16))
        if warm[0] != 200:
            fail(f"replay (c): warm-up answered {warm[0]}: {warm[1]}")
        results = [None] * REPLAY_KILL
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, _post(url,
                                                            payloads[i])))
            for i in range(REPLAY_KILL)]
        for t in threads:
            t.start()
        rc = proc.wait(timeout=600)
        for t in threads:
            t.join(timeout=60)
        if rc != -9 or any(r is None or r[0] is not None for r in results):
            fail(f"replay (c): serve exited {rc}, requests answered "
                 f"{[r and r[0] for r in results]} (expected -9 and none):"
                 f"\n{''.join(lines)[-3000:]}")
        left = read_journal(trace / JOURNAL_FILE)
        proc, t0 = spawn({})
        port, lines, at = read_until_port(proc, t0)
        m = [re.search(r"resumed (\d+) unfinished", x) for x in lines]
        resumed = next((int(x.group(1)) for x in m if x), 0)
        t_journal = next(a for x, a in zip(lines, at)
                         if x.startswith("request journal ->"))
        t_ready = at[-1]
        st = None
        while time.perf_counter() - t0 < 600:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                        timeout=30) as r:
                st = json.loads(r.read())
            if (st["replays"] >= resumed and st["journal"]["entries"] == 0
                    and st["active"] == 0 and st["queued"] == 0):
                break
            time.sleep(0.05)
        t_idle = time.perf_counter() - t0
        proc.terminate()                # SIGTERM: serve's graceful drain
        proc.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    after = read_journal(trace / JOURNAL_FILE)
    if (resumed < 1 or resumed != len(left) or st["replays"] < resumed
            or st["journal"]["entries"] != 0 or after):
        fail(f"replay (c): journal left {len(left)} entries, the restart "
             f"resumed {resumed}, /stats {st}, {len(after)} live after")
    shutil.rmtree(trace, ignore_errors=True)
    return dict(killed_at_block=1 + REPLAY_KILL_BLOCK, journaled=len(left),
                journaled_tokens=[len(e.emitted) for e in left],
                resumed=resumed, replays=st["replays"],
                replayed_tokens=st["replayed_tokens"],
                restart_to_journal_s=t_journal, restart_to_ready_s=t_ready,
                restart_to_idle_s=t_idle, recovery_s=t_idle - t_ready)


def _replay_checkpoint(torch, S, prepared, cfg) -> dict:
    """(d): checkpoint_progress at the flagship width (8 slots of 1024-token
    prompts, 512 new each) with blocks in flight: its host time, and
    whether the newest block's event was still pending when it returned,
    as the serving loop calls it (right after a step) and with 1 s of
    device work appended to the newest block (after its kernels, before
    its read starts: a device-bound block), each beside the wait a read
    queued behind the newest block would take (a stream synchronisation);
    then the host cost of starting a block's read (pinned buffer, copy,
    event). The delay goes after the block's kernels because the host
    cannot enqueue far ahead of the card: a block is thousands of
    launches, and with the card stalled its dispatch waits on the launch
    queue."""
    import numpy as np

    rng = np.random.default_rng(61)
    eng = S.SlotServer(prepared, cfg)
    for _ in range(8):
        eng.submit(S.Request(prompt=rng.integers(0, 32768, 1024).tolist(),
                             max_new_tokens=512))
    eng.step()
    torch.cuda.synchronize()
    decode = S._decode_block

    def delayed_block(*args, **kw):
        out = decode(*args, **kw)
        torch.cuda._sleep(2_000_000_000)    # >= 1 s at <= 2 GHz
        return out

    rows = []
    for delayed in (False, True) * 3:
        S._decode_block = delayed_block if delayed else decode
        try:
            t0 = time.perf_counter()
            eng.step()                      # the newest block
            step_ms = (time.perf_counter() - t0) * 1e3
        finally:
            S._decode_block = decode
        t0 = time.perf_counter()
        eng.checkpoint_progress()
        ckpt_ms = (time.perf_counter() - t0) * 1e3
        pending = not eng._pipeline[-1]["ready"].query()
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        rows.append(dict(delayed=delayed, step_ms=step_ms, ckpt_ms=ckpt_ms,
                         newest_pending=pending, in_flight=len(eng._pipeline),
                         drain_wait_ms=(time.perf_counter() - t0) * 1e3))
    # the same delay queued before a block: its dispatch waits for the
    # card, since the host cannot run a whole block's launches ahead
    torch.cuda._sleep(2_000_000_000)
    t0 = time.perf_counter()
    eng.step()
    stalled_step_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_drained()
    packed = torch.zeros(8, 18, dtype=torch.int32, device="cuda")
    start_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        S._start_read(packed)
        start_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(r["newest_pending"] for r in rows if r["delayed"]):
        fail("replay (d): checkpoint_progress waited for the newest block")
    return dict(calls=rows, start_read_ms=start_ms,
                stalled_step_ms=stalled_step_ms,
                pending_at_return=sum(r["newest_pending"] for r in rows))


def phase_replay(torch, ops) -> dict:
    """The request journal and replay on the card: (a) float32 replay
    through injected crashes, token-identical up to a near-tie; (b) the
    flagship at bf16 through serve's app, REPLAY_REQUESTS HTTP requests
    without and with two crashes, none failed; (c) a SIGKILLed serve
    process restarted from its file journal; (d) checkpoint_progress
    against blocks in flight. Returns the kernels' launches (none: the
    serving path runs the einsum attention)."""
    print("== main path: replay")
    import numpy as np

    from tony_tpu_torch.cli import serve
    from tony_tpu_torch.models import generate as G
    from tony_tpu_torch.models import serving as S
    from tony_tpu_torch.models import transformer as T

    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    direct = _replay_direct(torch, G, T, S)

    rng = np.random.default_rng(41)
    lens = rng.integers(REPLAY_PROMPT[0], REPLAY_PROMPT[1] + 1,
                        REPLAY_REQUESTS)
    news = rng.integers(REPLAY_NEW[0], REPLAY_NEW[1] + 1, REPLAY_REQUESTS)
    payloads = [dict(prompt=rng.integers(0, 32768, int(n)).tolist(),
                     max_new_tokens=int(m), timeout_s=600.0)
                for n, m in zip(lens, news)]
    calm = _replay_http(torch, serve, payloads, ())
    # two crashes at 30% and 65% of the crashless burst's blocks, counted
    # after the warm-up's
    crash_at = [calm["warm_blocks"] + max(1, round(calm["blocks"] * f))
                for f in (0.3, 0.65)]
    crashed = _replay_http(torch, serve, payloads, crash_at)
    budget = int(news.sum())
    if calm["loop_restarts"] or calm["decoded"] != budget:
        fail(f"replay (b): the crashless burst restarted "
             f"{calm['loop_restarts']} times, decoded {calm['decoded']} of "
             f"{budget} tokens")
    if (crashed["loop_restarts"] != 2 or crashed["crashes"] != 2
            or not crashed["healthy"]
            or crashed["replays"] < sum(crashed["inflight_at_crash"])):
        fail(f"replay (b): {crashed['crashes']} crashes, "
             f"{crashed['loop_restarts']} restarts, {crashed['replays']} "
             f"replays for {crashed['inflight_at_crash']} in flight")
    same = 0
    for i, ((rid, toks, reason), (_, want, _)) in enumerate(
            zip(crashed["completions"], calm["completions"])):
        _check_prefixes("replay (b)", toks, crashed["prefixes"].get(rid, []))
        if reason != "length" or len(toks) != len(want) \
                or not all(0 <= t < 32768 for t in toks):
            fail(f"replay (b): request {i} ended {reason} with {len(toks)} "
                 f"tokens, the crashless run's {len(want)}")
        same += toks == want
    reprefilled = crashed["prefill_computed"] - calm["prefill_computed"]
    redecoded = crashed["decoded"] - calm["decoded"]
    print(f"replay (b, bf16, serve's defaults): {REPLAY_REQUESTS} requests, "
          f"{int(lens.sum())} prompt and {budget} output tokens; crashless "
          f"{calm['wall_s']:.3f} s ({calm['blocks']} decode blocks); with "
          f"crashes at blocks {crash_at}: {crashed['wall_s']:.3f} s, "
          f"{REPLAY_REQUESTS} of {REPLAY_REQUESTS} completed, 0 failed, "
          f"{crashed['loop_restarts']} loop restarts, {crashed['replays']} "
          f"replays for {crashed['inflight_at_crash']} in flight, "
          f"{crashed['replayed_tokens']} journaled tokens teacher-forced; "
          f"re-prefilled {reprefilled} tokens (bound: prompt + journaled "
          f"prefix over the replays, {crashed['replay_bound']}); re-decoded "
          f"{redecoded} tokens; {same} of {REPLAY_REQUESTS} streams equal "
          f"the crashless run's (bf16); {nvidia_smi_line()}")
    kill = _replay_sigkill(torch)
    print(f"replay (c): serve SIGKILLed at decode block "
          f"{kill['killed_at_block']} with {kill['journaled']} requests "
          f"journaled ({kill['journaled_tokens']} tokens each); the restart "
          f"resumed {kill['resumed']}, replays {kill['replays']}, journal "
          f"compacted to 0 live entries; restart to journal line "
          f"{kill['restart_to_journal_s']:.2f} s (imports and the model's "
          f"load), to serving {kill['restart_to_ready_s']:.2f} s, to idle "
          f"{kill['restart_to_idle_s']:.2f} s (recovery after serving "
          f"{kill['recovery_s']:.2f} s)")
    args = serve.build_argparser().parse_args(SHALLOW + ["--seed", "41"])
    params, cfg = serve.load_model(args)
    prepared = G.prepare_decode(params, cfg)
    del params
    ckpt = _replay_checkpoint(torch, S, prepared, cfg)
    del prepared
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"replay: kernels launched {counts}, expected none")
    rows = ckpt["calls"]
    print("replay (d): checkpoint_progress host ms "
          + " ".join(f"{r['ckpt_ms']:.2f}{'*' if r['delayed'] else ''}"
                     for r in rows)
          + " (* with 1 s of device work appended to the newest block); "
          f"returned with the newest block pending {ckpt['pending_at_return']}"
          f" of {len(rows)} calls; a read queued behind it would have waited "
          + " ".join(f"{r['drain_wait_ms']:.2f}" for r in rows)
          + " ms; the steps' host ms "
          + " ".join(f"{r['step_ms']:.1f}" for r in rows)
          + f", {ckpt['stalled_step_ms']:.1f} with the delay queued before "
          "its block; starting a block's read "
          + " ".join(f"{x:.3f}" for x in ckpt["start_read_ms"]) + " ms")
    print("replay " + json.dumps(dict(
        direct=[r for r in direct if r.get("diverge") is not None
                or r.get("near_ties") or r["resumed_from"]],
        http=dict(requests=REPLAY_REQUESTS, prompt_tokens=int(lens.sum()),
                  output_tokens=budget, crash_at=crash_at,
                  wall_s_crashless=calm["wall_s"],
                  wall_s_crashed=crashed["wall_s"],
                  blocks_crashless=calm["blocks"],
                  blocks_crashed=crashed["blocks"],
                  loop_restarts=crashed["loop_restarts"],
                  inflight_at_crash=crashed["inflight_at_crash"],
                  replays=crashed["replays"],
                  replayed_tokens=crashed["replayed_tokens"],
                  reprefilled_tokens=reprefilled,
                  reprefill_bound=crashed["replay_bound"],
                  redecoded_tokens=redecoded, equal_bf16=same),
        sigkill=kill, checkpoint=ckpt, launches=counts,
        card=nvidia_smi_line())))
    return counts


def _sse(url: str, payload: dict, headers: dict | None = None) -> dict:
    """One streamed POST -> {status, frames: [(id line or None, data,
    seconds since the POST)], error}; data parsed from JSON except the
    [DONE] sentinel."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    frames, eid = [], None
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            for raw in r:
                line = raw.decode().rstrip("\n")
                if line.startswith("id: "):
                    eid = line[4:]
                elif line.startswith("data: "):
                    data = line[6:]
                    frames.append((eid, data if data == "[DONE]"
                                   else json.loads(data),
                                   time.perf_counter() - t0))
                    eid = None
            return dict(status=r.status, frames=frames, error=None)
    except urllib.error.HTTPError as e:
        return dict(status=e.code, frames=frames, error=e.read().decode())
    except OSError as e:
        return dict(status=None, frames=frames, error=repr(e))


def _sse_all(url, payloads) -> list:
    """Stream every payload at once -> each one's ``_sse`` record."""
    import threading

    results = [None] * len(payloads)
    threads = [threading.Thread(
        target=lambda i=i: results.__setitem__(i, _sse(url, payloads[i])))
        for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results


def _stream_record(name, res, budget, skip=0) -> dict:
    """Check one finished stream, /generate's or /v1's: answered 200, every
    delta non-empty, each ``id:`` cursor the running count of tokens
    delivered from ``skip`` on (none twice, none missing), the closing
    frame at ``budget`` with finish_reason "length" (and /generate's
    n_tokens the count delivered). -> {rid, tokens, times: each delta's
    arrival, sizes: its tokens, trace_id}."""
    frames = res["frames"]
    if res["status"] != 200 or not frames:
        fail(f"{name}: answered {res['status']}: {res['error']}")
    v1 = frames[-1][1] == "[DONE]"
    *deltas, (eid, closing, _) = frames[:-1] if v1 else frames
    if "error" in closing:
        fail(f"{name}: the stream ended in an error frame: {closing}")
    if v1:
        chunks = [d["choices"][0]["tokens"] for _, d, _ in deltas]
        reason = closing["choices"][0]["finish_reason"]
        rid, n_tokens = int(closing["id"].rsplit("-", 1)[1]), None
    else:
        chunks = [d["tokens"] for _, d, _ in deltas]
        reason, rid, n_tokens = (closing["finish_reason"], closing["id"],
                                 closing["n_tokens"])
    cursors = [int(e.split(":")[1]) for e, _, _ in deltas]
    running, n = [], skip
    for c in chunks:
        n += len(c)
        running.append(n)
    flat = [t for c in chunks for t in c]
    if (not all(chunks) or cursors != running or reason != "length"
            or int(eid.split(":")[1]) != budget or skip + len(flat) != budget
            or n_tokens not in (None, len(flat))):
        fail(f"{name}: request {rid}: cursors {cursors} for chunks of "
             f"{[len(c) for c in chunks]} from {skip}, closing {closing} at "
             f"{eid}, budget {budget}")
    return dict(rid=rid, tokens=flat, times=[t for _, _, t in deltas],
                sizes=[len(c) for c in chunks],
                trace_id=closing.get("trace_id"))


def _record_completions(srv) -> dict:
    """Every Completion the engine hands ServeApp's loop, by request id (a
    stream's terminal drops its completion unread)."""
    comps, drain = {}, srv.drain_completed

    def recording():
        done = drain()
        comps.update(done)
        return done

    srv.drain_completed = recording
    return comps


def _checked_dispatch(torch, srv) -> dict:
    """Run every decode block's dispatch under sync debug mode "error" (a
    synchronisation there fails the run) and count the admissions' syncs,
    by source line; -> the counters."""
    import warnings

    syncs = {"admission": 0, "sites": collections.Counter()}
    dispatch, admit = srv._dispatch_block, srv._admit
    spec_round = srv._dispatch_spec_round

    def checked(fn):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def checked_dispatch():
        checked(dispatch)

    def checked_spec_round():
        checked(spec_round)

    def counted_admit():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                admit()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        for w in caught:
            if "called a synchronizing CUDA operation" in str(w.message):
                syncs["admission"] += 1
                syncs["sites"][f"{Path(w.filename).name}:{w.lineno}"] += 1

    srv._dispatch_block, srv._admit = checked_dispatch, counted_admit
    srv._dispatch_spec_round = checked_spec_round
    return syncs


def _first_frame_then_close(url, payload) -> tuple:
    """A raw client that reads a stream's first frame and hangs up ->
    (its id line, its tokens, the instant of the close)."""
    import socket
    from urllib.parse import urlparse

    u = urlparse(url)
    sock = socket.create_connection((u.hostname, u.port), timeout=600)
    body = json.dumps(payload).encode()
    sock.sendall(f"POST {u.path}?{u.query} HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    buf = b""
    while b"data: " not in buf or not buf.endswith(b"\n\n"):
        chunk = sock.recv(1 << 20)
        if not chunk:
            fail(f"streaming (c): the server closed before a frame: {buf}")
        buf += chunk
    sock.close()
    closed = time.perf_counter()
    frame = buf.split(b"\r\n\r\n", 1)[1].decode().split("\n\n")[0]
    lines = dict(x.split(": ", 1) for x in frame.split("\n"))
    return lines["id"], json.loads(lines["data"])["tokens"], closed


def _stream_parity(torch, ops, G, serve) -> dict:
    """(a), (c) and (d) at float32, 2 layers, serve's defaults otherwise
    but a journal checkpoint every 0.25 s (so a stream's first frame comes
    early in (c)):
    the streams against solo generate on the card and against the
    engine's own completions; a cut stream resumed; streams across two
    loop crashes against a crashless server."""
    import numpy as np

    argv = FLAGSHIP + ["--n-layers", "2", "--dtype", "float32", "--seed",
                       "71", "--text-codec", "ids", "--journal-checkpoint-s",
                       "0.25"]
    app, httpd, url = _serve_app(serve, argv)
    base = url[:-len("/generate")]
    srv = app.server
    comps = _record_completions(srv)
    rng = np.random.default_rng(71)
    prompts = [rng.integers(0, 32768, int(n)).tolist()
               for n in rng.integers(64, 513, STREAM_F32)]
    cut_prompt = rng.integers(0, 32768, 256).tolist()
    crash_prompts = [rng.integers(0, 32768, int(n)).tolist()
                     for n in rng.integers(64, 513, STREAM_CRASH)]
    crash_app = None
    try:
        # the references on the card (its kernels), before the counted run
        w = G.DecodeWeights(srv._params, srv._fused)
        solo = [_solo_greedy(torch, G, w, srv.cfg, p, STREAM_F32_NEW)
                for p in prompts]
        solo_cut = _solo_greedy(torch, G, w, srv.cfg, cut_prompt,
                                STREAM_CUT_NEW)
        del w
        ops.reset_launch_counts()

        # ---- (a) every prompt buffered, streamed, streamed on /v1
        n = STREAM_F32_NEW
        texts = [" ".join(map(str, p)) for p in prompts]
        buf = _post_all(url, [dict(prompt=p, max_new_tokens=n)
                              for p in prompts])
        gen = _sse_all(url + "?stream=true",
                       [dict(prompt=p, max_new_tokens=n) for p in prompts])
        v1 = _sse_all(base + "/v1/completions",
                      [dict(prompt=t, max_tokens=n, stream=True)
                       for t in texts])
        chat = _sse_all(base + "/v1/chat/completions", [dict(
            messages=[{"role": "user", "content": t}], max_tokens=n,
            stream=True) for t in texts[:2]])
        rows, same_buf = [], 0
        for i, (toks, gaps) in enumerate(solo):
            b = buf[i][1]["tokens"]
            row = dict(request=i, buffered=_near_tie_check(
                f"streaming (a) buffered {i}", b, toks, gaps, n))
            for way, res in (("generate", gen[i]), ("v1", v1[i])):
                rec = _stream_record(f"streaming (a) {way} {i}", res, n)
                if rec["tokens"] != comps[rec["rid"]].tokens:
                    fail(f"streaming (a) {way} {i}: the stream is not its "
                         "own completion")
                row[way] = _near_tie_check(f"streaming (a) {way} {i}",
                                           rec["tokens"], toks, gaps, n)
                same_buf += rec["tokens"] == b
            rows.append(row)
        for i, res in enumerate(chat):
            rec = _stream_record(f"streaming (a) chat {i}", res, n)
            first = res["frames"][0][1]["choices"][0]["delta"]
            if res["frames"][-1][1] != "[DONE]" or first.get("role") != \
                    "assistant" or rec["tokens"] != comps[rec["rid"]].tokens:
                fail(f"streaming (a) chat {i}: first delta {first}")
            _near_tie_check(f"streaming (a) chat {i}", rec["tokens"],
                            solo[i][0], solo[i][1], n)
        print(f"streaming (a, float32, 2 layers): {STREAM_F32} greedy prompts"
              f" of {[len(p) for p in prompts]} tokens, {n} new, each "
              "buffered, streamed on /generate and on /v1/completions "
              "(--text-codec ids): every stream its own completion, "
              f"{same_buf} of {2 * STREAM_F32} streams equal the buffered "
              "answer, and all three agree with solo generate on the card "
              f"up to its first near-tie (gap < {PARITY_NEAR_TIE}); 2 chat "
              "streams end in [DONE] with the role in their first delta")

        # ---- (c) a stream cut after its first frame, resumed
        payload = dict(prompt=cut_prompt, max_new_tokens=STREAM_CUT_NEW)
        whole = _stream_record("streaming (c) uninterrupted",
                               _sse(url + "?stream=true", payload),
                               STREAM_CUT_NEW)
        cancelled_at, cancel = {}, app.cancel

        def timed_cancel(rid):
            out = cancel(rid)
            cancelled_at.setdefault(rid, time.perf_counter())
            return out

        app.cancel = timed_cancel
        n_blocks = len(srv.block_dispatch_s)
        st0 = app.stats()
        eid, first, closed = _first_frame_then_close(url + "?stream=true",
                                                     payload)
        rid, acked = map(int, eid.split(":"))
        if not 0 < acked < STREAM_CUT_NEW:
            fail(f"streaming (c): the first frame carried {acked} tokens")
        t_seen = t_free = None
        while time.perf_counter() - closed < 60:
            st = app.stats()
            now = time.perf_counter()
            if t_seen is None and st["stream_disconnects"] > \
                    st0["stream_disconnects"]:
                t_seen = now - closed
            if t_seen is not None and st["active"] == 0:
                t_free = now - closed
                break
            time.sleep(0.002)
        app.cancel = cancel
        blocks = list(srv.block_dispatch_s)[n_blocks:]
        t_cancel = cancelled_at.get(rid, float("inf")) - closed
        bound = 0.25 + max(blocks) + 0.05
        if t_free is None or t_cancel > bound:
            fail(f"streaming (c): cancelled {t_cancel:.3f} s after the close "
                 f"(bound {bound:.3f}: a wait beat, a block, 50 ms), "
                 f"the slot freed after {t_free}")
        rest = _stream_record(
            "streaming (c) resumed",
            _sse(url + "?stream=true", payload,
                 headers={"Last-Event-ID": eid}), STREAM_CUT_NEW, skip=acked)
        stitched = first + rest["tokens"]
        cut = _near_tie_check("streaming (c) stitched", stitched,
                              solo_cut[0], solo_cut[1], STREAM_CUT_NEW)
        _near_tie_check("streaming (c) uninterrupted", whole["tokens"],
                        solo_cut[0], solo_cut[1], STREAM_CUT_NEW)
        st = app.stats()
        rec_c = dict(acked=acked, cancel_s=t_cancel, seen_s=t_seen,
                     freed_s=t_free, bound_s=bound,
                     block_ms_max=max(blocks) * 1e3,
                     equal_uninterrupted=stitched == whole["tokens"],
                     replays=st["replays"],
                     disconnects=st["stream_disconnects"], **cut)
        print(f"streaming (c, float32, 2 layers): a {STREAM_CUT_NEW}-token "
              f"stream cut after its first frame ({acked} tokens): cancelled "
              f"{t_cancel:.3f} s after the close (bound {bound:.3f} s: a "
              f"0.25 s wait beat, the longest block {max(blocks) * 1e3:.1f} "
              f"ms, 50 ms), seen in /stats at {t_seen:.3f} s, the slot free "
              f"at {t_free:.3f} s; resumed with Last-Event-ID {eid}: "
              f"{len(rest['tokens'])} more tokens, no duplicate and no gap, "
              f"the parts {'equal' if rec_c['equal_uninterrupted'] else 'not equal'}"
              " to the uninterrupted stream and equal to solo generate up "
              "to its first near-tie")

        # ---- (d, float32) streams across two loop crashes
        ref = _post_all(url, [dict(prompt=p, max_new_tokens=STREAM_CRASH_NEW,
                                   logprobs=2) for p in crash_prompts])
        os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"] = STREAM_CRASH_F32
        try:
            crash_app, crash_httpd, crash_url = _serve_app(serve, argv)
        finally:
            del os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"]
        crash_comps = _record_completions(crash_app.server)
        res = _sse_all(crash_url + "?stream=true",
                       [dict(prompt=p, max_new_tokens=STREAM_CRASH_NEW)
                        for p in crash_prompts])
        equal = 0
        for i, (r, b) in enumerate(zip(res, ref)):
            rec = _stream_record(f"streaming (d, float32) {i}", r,
                                 STREAM_CRASH_NEW)
            if rec["tokens"] != crash_comps[rec["rid"]].tokens:
                fail(f"streaming (d, float32) {i}: the stream is not its "
                     "completion")
            gaps = [e["top"][1][0] - e["top"][1][1]
                    for e in b[1]["logprobs"]]
            _near_tie_check(f"streaming (d, float32) {i}", rec["tokens"],
                            b[1]["tokens"], gaps, STREAM_CRASH_NEW)
            equal += rec["tokens"] == b[1]["tokens"]
        csrv = crash_app.server
        if csrv.chaos_faults_injected != 2 or crash_app.loop_restarts != 2:
            fail(f"streaming (d, float32): {csrv.chaos_faults_injected} "
                 f"crashes, {crash_app.loop_restarts} restarts")
        rec_d = dict(done=len(res), equal=equal, replays=csrv.replays,
                     replayed_tokens=csrv.replayed_tokens)
        print(f"streaming (d, float32, 2 layers): {STREAM_CRASH} greedy "
              f"streams of {STREAM_CRASH_NEW} new tokens across crashes at "
              f"decode blocks {STREAM_CRASH_F32}: {len(res)} of "
              f"{STREAM_CRASH} done, no token twice, {csrv.replays} replays "
              f"({csrv.replayed_tokens} journaled tokens); {equal} of "
              f"{STREAM_CRASH} equal the crashless server's, every other "
              f"only at or after a near-tie (gap < {PARITY_NEAR_TIE})")
    finally:
        _stop_app(app, httpd)
        if crash_app is not None:
            _stop_app(crash_app, crash_httpd)
    return dict(parity=[r for r in rows if any(
        v.get("diverge") is not None or v.get("near_ties")
        for v in r.values() if isinstance(v, dict))],
        same_as_buffered=same_buf, cut=rec_c, crash_f32=rec_d)


def _stream_bursts(torch, serve, argv, bursts) -> tuple:
    """Serve's app from ``argv``, a one-block warm-up request, then each
    burst of ``bursts`` ((streamed, payloads) pairs) in turn, its payloads
    posted at once: on /generate?stream=true, or buffered. Every block's
    dispatch is checked for synchronisations. -> (the engine, a record a
    burst: each stream's check or each buffered answer, the wall time,
    the blocks' host dispatch and the engine's counters)."""
    app, httpd, url = _serve_app(serve, argv)
    srv = app.server
    comps = _record_completions(srv)
    syncs = _checked_dispatch(torch, srv)
    out = []
    try:
        res = _post(url, dict(prompt=list(range(1, 300)), max_new_tokens=16))
        if res[0] != 200:
            fail(f"streaming: warm-up answered {res[0]}: {res[1]}")
        for streamed, payloads in bursts:
            syncs["admission"] = 0
            with app.lock:
                s0 = srv.stats()
            n0 = len(srv.block_dispatch_s)
            t0 = time.perf_counter()
            results = (_sse_all(url + "?stream=true", payloads) if streamed
                       else _post_all(url, payloads))
            wall = time.perf_counter() - t0
            with app.lock:
                s1 = srv.stats()
            out.append(dict(
                streamed=streamed, results=results, wall_s=wall,
                health=app.health(), restarts=app.loop_restarts,
                syncs=syncs["admission"],
                dispatch_ms=[x * 1e3 for x in
                             list(srv.block_dispatch_s)[n0:]],
                warm_blocks=s0["blocks_dispatched"],
                blocks=s1["blocks_dispatched"] - s0["blocks_dispatched"],
                stalls=s1["stream_stalls"] - s0["stream_stalls"],
                opened=s1["streams_opened"] - s0["streams_opened"],
                crashes=s1["chaos_faults_injected"],
                replays=s1["replays"] - s0["replays"]))
    finally:
        _stop_app(app, httpd)
        del srv._dispatch_block, srv._admit, srv.drain_completed
    for rec, (streamed, payloads) in zip(out, bursts):
        if not streamed:
            continue
        rec["recs"] = []
        for i, (res, pl) in enumerate(zip(rec["results"], payloads)):
            r = _stream_record(f"streaming request {i}", res,
                               pl["max_new_tokens"])
            if r["tokens"] != comps[r["rid"]].tokens:
                fail(f"streaming request {i}: the stream is not its "
                     "completion")
            rec["recs"].append(r)
    return srv, out


def _burst_row(rec, n_tokens) -> dict:
    """A burst's record for the output: its wall time and tokens/s, its
    blocks' host dispatch, and a streamed burst's cadence."""
    disp = _quantiles(rec["dispatch_ms"])
    row = dict(wall_s=rec["wall_s"], output_tokens_per_s=n_tokens
               / rec["wall_s"], decode_blocks=rec["blocks"],
               block_dispatch_ms_p50=disp["p50"],
               block_dispatch_ms_max=disp["max"],
               admission_syncs=rec["syncs"])
    if rec["streamed"]:
        row.update(stream_stalls=rec["stalls"], **_cadence(rec["recs"]))
    return row


def _cadence(recs, burst_s=0.02) -> dict:
    """The client-side cadence of a burst's streams: time to the first
    frame, frames a request and tokens a frame; and deliveries: the engine
    feeds a stream once per block it processes, and a turn that processes
    several blocks sends their frames back to back, so frames that arrive
    within ``burst_s`` of the one before count as one delivery (its
    tokens, and the gap from the delivery before)."""
    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None

    n_del, del_tokens, gaps = [], [], []
    for r in recs:
        groups = []         # [first arrival, last arrival, tokens]
        for t, n in zip(r["times"], r["sizes"]):
            if groups and t - groups[-1][1] < burst_s:
                groups[-1][1:] = [t, groups[-1][2] + n]
            else:
                groups.append([t, t, n])
        n_del.append(len(groups))
        del_tokens += [g[2] for g in groups]
        gaps += [b[0] - a[0] for a, b in zip(groups, groups[1:])]
    ttff = [r["times"][0] for r in recs]
    frames = [len(r["times"]) for r in recs]
    sizes = [s for r in recs for s in r["sizes"]]
    return dict(ttff_s_p50=pct(ttff, 0.5), ttff_s_max=max(ttff),
                frames_per_request_mean=sum(frames) / len(frames),
                frames_per_request_min=min(frames),
                frames_per_request_max=max(frames),
                tokens_per_frame_mean=sum(sizes) / len(sizes),
                tokens_per_frame_max=max(sizes),
                deliveries_per_request_mean=sum(n_del) / len(n_del),
                tokens_per_delivery_mean=sum(del_tokens) / len(del_tokens),
                tokens_per_delivery_max=max(del_tokens),
                delivery_gap_s_p50=pct(gaps, 0.5),
                delivery_gap_s_p99=pct(gaps, 0.99))


def phase_streaming(torch, ops, run_a) -> tuple:
    """Streaming and the OpenAI routes through serve's own build_argparser,
    build_app and make_httpd on 127.0.0.1: (a) float32 streams against
    their buffered answers, their completions and solo generate; (b) run
    A's 24 requests streamed at the flagship width (SERVE_CUT_LAYERS
    layers) with serve's defaults, at two journal checkpoint cadences
    beside one buffered run, with a block's device time with streams
    attached against a block without on the same engine; (c) a stream cut
    and resumed with Last-Event-ID; (d) streams across two loop crashes,
    float32 and bf16. Returns the kernels' launches (none: the serving
    path runs the einsum attention) and the block without streams (the
    telemetry phase's baseline at this depth)."""
    print("== main path: streaming")
    import numpy as np

    from tony_tpu_torch.cli import serve
    from tony_tpu_torch.models import generate as G
    from tony_tpu_torch.models import serving as S

    torch.cuda.empty_cache()
    parity = _stream_parity(torch, ops, G, serve)

    # ---- (b) run A's requests buffered and streamed, in turns, and a
    # burst whose streams all run to the end together, at each checkpoint
    # cadence
    rng, lens, news, _, payloads = _serve_payloads()
    urng = np.random.default_rng(91)
    n_uni, uni_len, uni_new = STREAM_UNIFORM
    uniform = [dict(prompt=urng.integers(0, 32768, uni_len).tolist(),
                    max_new_tokens=uni_new, timeout_s=600.0)
               for _ in range(n_uni)]
    cadences, buffered = {}, None
    for k, cad in enumerate(STREAM_CADENCES):
        # one buffered run, with the first cadence, serves both
        names = (["buffered"] if k == 0 else []) + ["streamed", "uniform"]
        names = names[::-1 if k % 2 else 1]
        srv, recs = _stream_bursts(
            torch, serve, SHALLOW + ["--seed", "21", "--journal-checkpoint-s",
                                     str(cad)],
            [(n != "buffered", uniform if n == "uniform" else payloads)
             for n in names])
        got = dict(zip(names, recs))
        buffered = got.setdefault("buffered", buffered)
        for name, r in got.items():
            want_streams = {"buffered": 0, "streamed": SERVE_REQUESTS,
                            "uniform": n_uni}[name]
            if (not r["health"]["healthy"] or r["restarts"]
                    or r["opened"] != want_streams):
                fail(f"streaming (b, {cad} s, {name}): health {r['health']},"
                     f" {r['restarts']} restarts, {r['opened']} streams")
        for res, pl in zip(got["buffered"]["results"], payloads):
            body = res[1]
            if body["finish_reason"] != "length" or \
                    len(body["tokens"]) != pl["max_new_tokens"]:
                fail(f"streaming (b, {cad} s): a buffered request ended "
                     f"{body['finish_reason']} with {len(body['tokens'])}")
        row = {name: _burst_row(r, int(news.sum()) if name != "uniform"
                                else n_uni * uni_new)
               for name, r in got.items()}
        cadences[cad] = row
        st, bu, un = row["streamed"], row["buffered"], row["uniform"]
        print(f"streaming (b, bf16, {SERVE_CUT_LAYERS} layers, serve's "
              f"defaults, --journal-checkpoint-s {cad}): run A's {SERVE_REQUESTS} requests streamed: "
              f"{SERVE_REQUESTS} of {SERVE_REQUESTS} done, cursors strictly "
              f"increasing, each its completion; {int(news.sum())} tokens in "
              f"{st['wall_s']:.3f} s ({st['output_tokens_per_s']:.1f} "
              f"tokens/s; buffered in turn {bu['wall_s']:.3f} s, "
              f"{bu['output_tokens_per_s']:.1f}); first frame p50 "
              f"{st['ttff_s_p50']:.3f} s, max {st['ttff_s_max']:.3f} s; "
              f"{st['frames_per_request_mean']:.2f} frames a request "
              f"({st['frames_per_request_min']}-"
              f"{st['frames_per_request_max']}), "
              f"{st['tokens_per_frame_mean']:.1f} tokens a frame (max "
              f"{st['tokens_per_frame_max']}); "
              f"{st['deliveries_per_request_mean']:.2f} deliveries a request "
              f"of {st['tokens_per_delivery_mean']:.1f} tokens (max "
              f"{st['tokens_per_delivery_max']}), a delivery every "
              f"{st['delivery_gap_s_p50']:.3f} s (p50; p99 "
              f"{st['delivery_gap_s_p99']:.3f} s); a "
              f"block's host dispatch {st['block_dispatch_ms_p50']:.2f} ms "
              f"(median of {st['decode_blocks']}; buffered "
              f"{bu['block_dispatch_ms_p50']:.2f} of {bu['decode_blocks']}, "
              f"run A at {N_LAYERS} layers "
              f"{run_a['block_dispatch_ms_p50']:.2f}); "
              f"synchronisations 0 in dispatch, {st['admission_syncs']} in "
              f"admission; {st['stream_stalls']} stream stalls")
        print(f"streaming (b, --journal-checkpoint-s {cad}): {n_uni} streams "
              f"of {uni_len}-token prompts and {uni_new} new, ending "
              f"together: first frame p50 {un['ttff_s_p50']:.3f} s; "
              f"{un['frames_per_request_mean']:.2f} frames a request of "
              f"{un['tokens_per_frame_mean']:.1f} tokens, in "
              f"{un['deliveries_per_request_mean']:.2f} deliveries of "
              f"{un['tokens_per_delivery_mean']:.1f} tokens (max "
              f"{un['tokens_per_delivery_max']}), a delivery every "
              f"{un['delivery_gap_s_p50']:.3f} s (p50; p99 "
              f"{un['delivery_gap_s_p99']:.3f} s); a block's host dispatch "
              f"{un['block_dispatch_ms_p50']:.2f} ms")
    base = _profile_block(torch, S, srv, rng, "streaming (no streams)")
    blk = _profile_block(torch, S, srv, rng, "streaming", streams=True)
    del srv
    torch.cuda.empty_cache()
    want = base["device_ms"]
    diff = _device_time_check("streaming (8 streams attached)",
                              blk["device_ms"], want,
                              "a block without streams")

    # ---- (d, bf16) streams across two crashes at the flagship width
    rng = np.random.default_rng(81)
    crash_payloads = [dict(prompt=rng.integers(0, 32768, int(n)).tolist(),
                           max_new_tokens=STREAM_CRASH_NEW, timeout_s=600.0)
                      for n in rng.integers(64, 1025, STREAM_CRASH)]
    argv = SHALLOW + ["--seed", "81"]
    _, (calm,) = _stream_bursts(torch, serve, argv, [(True, crash_payloads)])
    crash_at = [calm["warm_blocks"] + max(1, round(calm["blocks"] * f))
                for f in (0.3, 0.65)]
    os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"] = ",".join(
        map(str, crash_at))
    try:
        _, (crashed,) = _stream_bursts(torch, serve, argv,
                                       [(True, crash_payloads)])
    finally:
        del os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"]
    if crashed["crashes"] != 2 or crashed["restarts"] != 2 \
            or not crashed["health"]["healthy"]:
        fail(f"streaming (d, bf16): {crashed['crashes']} crashes, "
             f"{crashed['restarts']} restarts, health {crashed['health']}")
    equal = sum(a["tokens"] == b["tokens"]
                for a, b in zip(calm["recs"], crashed["recs"]))
    crash_bf16 = dict(crash_at=crash_at, done=len(crashed["recs"]),
                      equal=equal, replays=crashed["replays"],
                      wall_s_crashless=calm["wall_s"],
                      wall_s_crashed=crashed["wall_s"])
    del calm, crashed
    torch.cuda.empty_cache()
    print(f"streaming (d, bf16, serve's defaults): {STREAM_CRASH} greedy "
          f"streams of {STREAM_CRASH_NEW} new tokens, crashes at blocks "
          f"{crash_at}: {crash_bf16['done']} of {STREAM_CRASH} done, no token "
          f"twice, {crash_bf16['replays']} replays; "
          f"{crash_bf16['wall_s_crashless']:.3f} s crashless, "
          f"{crash_bf16['wall_s_crashed']:.3f} s with the crashes; {equal} of "
          f"{STREAM_CRASH} streams equal the crashless run's (bf16)")
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"streaming: kernels launched {counts}, expected none")
    print("streaming " + json.dumps(dict(
        parity=parity, cadences=cadences,
        block=dict(wall_ms=blk["wall_ms"], device_ms=blk["device_ms"],
                   device_ms_without_streams=want,
                   device_time_diff=diff), crash_bf16=crash_bf16,
        launches=counts, card=nvidia_smi_line())))
    return counts, base


# ------------------------------------------------------------ paged KV

PAGED_MODES = {           # mode -> (both engines' options, the paged one's)
    "predictive": ({}, {}),
    "eos": ({}, {}),      # the stop token comes from the predictive run
    "int8": ({"kv_dtype": "int8"}, {}),
    "prefix_cache": ({}, {}),
    "interleave": ({}, {"prefill_interleave": 64}),
}


def _paged_prompts() -> list:
    """Paged (a)'s PAGED_ID prompts of 64-512 tokens, drawn from seed 61."""
    import numpy as np

    rng = np.random.default_rng(61)
    return [rng.integers(0, 32768, int(n)).tolist()
            for n in rng.integers(64, 513, PAGED_ID)]


def _paged_identity(torch, G, T, S) -> list:
    """(a): the flagship widths at 2 layers, float32 and bf16, PAGED_ID
    requests through 3 slots on the paged engine (kv_block PAGED_KV_BLOCK)
    and on the ring engine admitting slot by slot (the paged engine
    prefills one slot at a time, so the two run the same programs on the
    same ring layout), in every mode: token-identical completions, the
    allocator's invariant after the drain.

    Interleaved prefill is the exception: a slot's offset is re-derived at
    its final chunk for the cursor of then, so its ring layout is the ring
    engine's rotated by the blocks decoded meanwhile, and the softmax's and
    the PV product's sums over the ring group the same terms differently.
    That mode is held token-identical at float32; at bf16 it is reported,
    beside a control: the ring engine against itself with its cursor
    started one block later."""
    dev = torch.device("cuda")
    plain = _paged_prompts()
    shared = _prefix_prompts(63)[:PAGED_ID]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                                  n_heads=8, n_kv_heads=8, d_ff=4096,
                                  dtype=dtype)
        w = G.prepare_decode(T.init(cfg, torch.Generator(device=dev)
                                    .manual_seed(61), dev), cfg)
        stop = None
        for mode, (common, paged_only) in PAGED_MODES.items():
            prompts = shared if mode == "prefix_cache" else plain
            if mode == "eos":
                common = {"stop_tokens": (stop,)}

            def run(cursor=0, **kw):
                eng = S.SlotServer(w, cfg, slots=3, max_len=2048, **common,
                                   **kw)
                eng._cursor = cursor
                reqs = [S.Request(prompt=p, max_new_tokens=PAGED_ID_NEW,
                                  logprobs=2) for p in prompts]
                for r in reqs:
                    eng.submit(r)
                done = eng.run_until_drained()
                return [done[r.id] for r in reqs], eng

            ring, ring_eng = run(batched_admission=False,
                                 prefix_cache_blocks=PREFIX_BLOCKS
                                 if mode == "prefix_cache" else 0)
            paged, eng = run(paged=True, kv_block=PAGED_KV_BLOCK,
                             prefix_cache_blocks=PAGED_TRIE_BLOCKS
                             if mode == "prefix_cache" else 0, **paged_only)
            eng._allocator.check()
            name = f"paged (a, {str(dtype)[6:]}, {mode})"
            same = [a.tokens == b.tokens and a.finish_reason == b.finish_reason
                    for a, b in zip(ring, paged)]
            rotated = mode == "interleave" and dtype == torch.bfloat16
            if not all(same) and not rotated:
                i = same.index(False)
                j = next((j for j, (x, y) in enumerate(
                    zip(ring[i].tokens, paged[i].tokens)) if x != y), None)
                fail(f"{name}: request {i} differs from the ring engine's "
                     f"at token {j} ({ring[i].finish_reason} / "
                     f"{paged[i].finish_reason})")
            st = eng.stats()
            row = dict(dtype=str(dtype)[6:], mode=mode, identical=sum(same),
                       gathers=st["paged_kv"]["gather_dispatches"],
                       peak_blocks=st["paged_kv"]["pool_blocks_peak"])
            if mode == "predictive":
                stop = ring[0].tokens[3]
            if mode == "eos":
                row["stopped"] = sum(c.finish_reason == "stop" for c in ring)
                if not row["stopped"]:
                    fail(f"{name}: the stop token {stop} never fired")
            if mode == "prefix_cache":
                row.update(hits=st["prefix_cache"]["hits"],
                           ring_hits=ring_eng.stats()["prefix_cache"]["hits"],
                           reused=st["prefill_tokens_reused"],
                           ring_reused=ring_eng.prefill_tokens_reused)
                if not row["hits"] or eng.prefix_copy_dispatches \
                        or row["reused"] != row["ring_reused"]:
                    fail(f"{name}: {row}, {eng.prefix_copy_dispatches} "
                         "copies")
            if mode == "interleave":
                row["interleaved"] = st["paged_kv"][
                    "prefill_chunks_interleaved"]
                if not row["interleaved"]:
                    fail(f"{name}: no prefill was interleaved")
                # where each request parts from the ring, with the ring's
                # top-2 logit gap there; the control: the ring engine with
                # its cursor one block on
                row["parted"] = [_parting(i, a, b)
                                 for i, (a, b) in enumerate(zip(ring, paged))
                                 if a.tokens != b.tokens]
                shifted, _ = run(cursor=16, batched_admission=False)
                row["ring_shifted_identical"] = sum(
                    a.tokens == b.tokens for a, b in zip(ring, shifted))
                row["ring_shifted_parted"] = [
                    _parting(i, a, b)
                    for i, (a, b) in enumerate(zip(ring, shifted))
                    if a.tokens != b.tokens]
            rows.append(row)
            del ring_eng, eng
        del w
        torch.cuda.empty_cache()
    print(f"paged (a, 2 layers, {PAGED_ID} requests through 3 slots, "
          f"{PAGED_ID_NEW} new, kv_block {PAGED_KV_BLOCK}): requests "
          "token-identical to the ring engine (interleave at bf16 reported, "
          "every other row required): "
          + "; ".join(f"{r['dtype']} {r['mode']} {r['identical']}/{PAGED_ID}"
                      for r in rows))
    for r in rows:
        if "ring_shifted_identical" in r:
            print(f"paged (a, {r['dtype']}, interleave): parted from the "
                  f"ring at (request, step, the ring's top-2 gap) "
                  f"{r['parted']}; control, the ring engine with its cursor "
                  f"one block on: {r['ring_shifted_identical']}/{PAGED_ID} "
                  f"identical to itself, parted at "
                  f"{r['ring_shifted_parted']}")
    return rows


def _parting(i, ref, got) -> tuple:
    """(request, the first step where ``got`` leaves ``ref``, the top-2
    logit gap of ``ref``'s distribution there)."""
    j = next(j for j, (a, b) in enumerate(zip(ref.tokens + [None],
                                                 got.tokens + [None]))
             if a != b)
    top = ref.logprobs[j]["top"][1] if j < len(ref.logprobs) else None
    return (i, j, round(top[0] - top[1], 5) if top else None)


def _paged_http(torch, serve, payloads, argv, name) -> tuple:
    """Serve's app from SHALLOW + ``argv``, a warm-up request, then every
    payload at once, each block's dispatch under sync debug mode "error".
    -> (the engine, the burst's record: completions in payload order, wall
    time, latency, a block's host dispatch, the admissions' syncs, the
    device memory's peak over the burst, beside what was allocated before
    the app was built, the engine's counters)."""
    gc.collect()                # a stopped app's cycles hold its tensors
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    app, httpd, url = _serve_app(serve, SHALLOW + argv)
    srv = app.server
    syncs = _checked_dispatch(torch, srv)
    try:
        warm = _post(url, dict(prompt=list(range(1, 300)), max_new_tokens=40))
        if warm[0] != 200:
            fail(f"{name}: warm-up answered {warm[0]}: {warm[1]}")
        syncs["admission"] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = len(srv.block_dispatch_s)
        with app.lock:
            s0 = srv.stats()
        t0 = time.perf_counter()
        results = _post_all(url, payloads)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with app.lock:
            s1 = srv.stats()
        health = app.health()
    finally:
        _stop_app(app, httpd)
        del srv._dispatch_block, srv._admit
    if app.loop_failures or not health["healthy"]:
        fail(f"{name}: the loop failed: {health}")
    for i, ((_, body, _), pl) in enumerate(zip(results, payloads)):
        toks = body["tokens"]
        if (body["finish_reason"] != "length"
                or len(toks) != pl["max_new_tokens"]
                or not all(0 <= t < 32768 for t in toks)):
            fail(f"{name}: request {i} ended {body['finish_reason']} with "
                 f"{len(toks)} tokens of {pl['max_new_tokens']}")
    n_out = sum(pl["max_new_tokens"] for pl in payloads)
    lat = _quantiles([r[2] for r in results])
    rec = dict(wall_s=wall, output_tokens_per_s=n_out / wall,
               latency_s_p50=lat["p50"], latency_s_max=lat["max"],
               block_dispatch_ms_p50=_quantiles(
                   [x * 1e3 for x in list(srv.block_dispatch_s)[n0:]])["p50"],
               decode_blocks=s1["blocks_dispatched"] - s0["blocks_dispatched"],
               prefill_calls=s1["admission_dispatches"]
               - s0["admission_dispatches"],
               admission_syncs=syncs["admission"], peak_bytes=peak,
               base_bytes=base, tokens=[r[1]["tokens"] for r in results])
    if "paged_kv" in s1:
        pk = s1["paged_kv"]
        rec.update(admission_defers=pk["admission_defers"]
                   - s0["paged_kv"]["admission_defers"],
                   pool_blocks_peak=pk["pool_blocks_peak"],
                   pool_blocks_total=pk["pool_blocks_total"])
        srv._allocator.check()
        if pk["pool_blocks_used"] != 0:
            fail(f"{name}: {pk['pool_blocks_used']} blocks held after the "
                 "drain")
    return srv, rec


def _profiled_ms(torch, fn) -> tuple:
    """fn's device time by torch.profiler -> (ms or None, its kernels'
    names). The profiler can miss the first kernels of a region (the
    paged block's profile in the full script lacked its gather and one
    launch of each kernel of its first step), so fn's work queues behind
    a 20 ms device sleep, whose own kernel is left out of the sum. Even
    so, after the earlier phases' profiles it records none of the paged
    gather's kernels: callers time the gather by CUDA events as well."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(0.02 * 2e9))
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0 \
                and "spin" not in e.key:
            rows.append((us, e.key))
    rows.sort(reverse=True)
    return (sum(r[0] for r in rows) / 1e3 if rows else None,
            [k[:60] for _, k in rows[:6]])


def _block_device_ms(torch, S, srv, rng) -> float | None:
    """One decode block's device time on ``srv`` with 8 busy slots of
    1024-token prompts, by ``_profiled_ms``."""
    reqs = [S.Request(prompt=rng.integers(0, 32768, 1024).tolist(),
                      max_new_tokens=64) for _ in range(8)]
    for r in reqs:
        srv.submit(r)
    srv.step()
    ms, _ = _profiled_ms(torch, srv._dispatch_block)
    srv.run_until_drained()
    return ms


def _paged_block_costs(torch, S, srv, rng, name) -> dict:
    """The gather and the scatter of one decode block on ``srv`` (paged)
    with 8 busy slots of 1024-token prompts, on the indices the next block
    stages: their device time by CUDA events over repeated calls and by
    torch.profiler over one call, against their bytes bound; a block's
    wall and device time (``_profile_block``)."""
    import numpy as np

    blk = _profile_block(torch, S, srv, rng, name)
    blk["device_ms_warm"] = _block_device_ms(torch, S, srv, rng)
    reqs = [S.Request(prompt=rng.integers(0, 32768, 1024).tolist(),
                      max_new_tokens=64) for _ in range(8)]
    for r in reqs:
        srv.submit(r)
    srv.step()
    torch.cuda.synchronize()
    pool, kvh, B, M = (srv._kv_pool, srv.cfg.n_kv_heads, srv.kv_block,
                       srv.max_len)
    _, b, row = S._paged_rows(srv._np_tables, srv._np_offs, B,
                              np.arange(M)[None, :])
    base = S._stage(b * (kvh * B) + row, srv.device)
    view = S._gather_paged_view(pool, base, srv._d_lens)
    window = (srv._cursor + np.arange(srv.block_size)) % M
    ring_ids = np.broadcast_to(window, (srv.slots, srv.block_size))
    p, b, row = S._paged_rows(srv._np_tables, srv._np_offs, B, ring_ids)
    keep = (p >= srv._np_floor[:, None]) & (b < srv._allocator.n_blocks)
    si, ji = np.nonzero(keep)
    rows = S._stage(np.stack([si * (kvh * M) + ring_ids[si, ji],
                              b[si, ji] * (kvh * B) + row[si, ji]])
                    .astype(np.int64), srv.device)
    def gather():
        return S._gather_paged_view(pool, base, srv._d_lens)

    def scatter():          # rewrites the pool rows with what they hold
        S._scatter_paged_rows(pool, view, rows)

    gather_ms = cuda_ms(gather, 20)
    scatter_ms = cuda_ms(scatter, 50)
    profiled = {label: _profiled_ms(torch, fn)
                for label, fn in (("gather", gather), ("scatter", scatter))}
    view_bytes = 2 * view.k.numel() * view.k.element_size()
    row_bytes = 2 * srv.cfg.n_layers * kvh * view.k.shape[-1] \
        * view.k.element_size()
    gather_bytes = 2 * view_bytes + base.numel() * 8
    scatter_bytes = 2 * len(si) * row_bytes + rows.numel() * 8
    del view
    done = srv.run_until_drained()
    if sorted(len(done[r.id].tokens) for r in reqs) != [64] * 8:
        fail(f"{name}: the timed requests did not complete")
    srv._allocator.check()
    out = dict(block=blk, gather_ms=gather_ms,
               gather_bound_ms=gather_bytes / PEAK_BYTES * 1e3,
               gather_bytes=gather_bytes, scatter_ms=scatter_ms,
               scatter_bound_ms=scatter_bytes / PEAK_BYTES * 1e3,
               scatter_bytes=scatter_bytes, scatter_rows=int(len(si)),
               gather_ms_profiler=profiled["gather"][0],
               gather_kernels=profiled["gather"][1],
               scatter_ms_profiler=profiled["scatter"][0],
               scatter_kernels=profiled["scatter"][1])
    print(f"{name}: a block's gather {gather_ms:.4f} ms on the device by "
          f"events, {out['gather_ms_profiler']} ms by torch.profiler "
          f"({gather_bytes} bytes, bound {out['gather_bound_ms']:.4f} ms); "
          f"scatter {scatter_ms:.4f} ms by events, "
          f"{out['scatter_ms_profiler']} ms by torch.profiler ({len(si)} "
          f"rows a layer and head, {scatter_bytes} bytes, bound "
          f"{out['scatter_bound_ms']:.5f} ms); kernels "
          f"{profiled['gather'][1]} / {profiled['scatter'][1]}")
    return out


def _paged_serving(torch, ops, S, G, T, serve, run_a) -> dict:
    """(b) and (c): run A's requests at float32 (PAGED_F32_LAYERS layers)
    through the
    ring and the paged engine (up to the ring's first near-tie); at bf16
    through serve's app with its defaults and --paged-kv, and then
    --paged-kv on PAGED_OVER_SLOTS slots over the same pool; each with its
    throughput, latency, syncs and peak device memory, the gather's and
    the scatter's device time."""
    rng, lens, news, sampled, payloads = _serve_payloads()
    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024,
                              n_layers=PAGED_F32_LAYERS, n_heads=8,
                              n_kv_heads=8, d_ff=4096, dtype=torch.float32)
    w = G.prepare_decode(T.init(cfg, torch.Generator(device=dev)
                                .manual_seed(21), dev), cfg)
    got = {}
    for paged in (False, True):
        eng = S.SlotServer(w, cfg, paged=paged)
        reqs = [S.Request(prompt=pl["prompt"],
                          max_new_tokens=pl["max_new_tokens"],
                          temperature=pl.get("temperature"),
                          top_k=pl.get("top_k"), logprobs=2)
                for pl in payloads]
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        got[paged] = [done[r.id] for r in reqs]
        if paged:
            eng._allocator.check()
        del eng
    del w
    torch.cuda.empty_cache()
    f32 = []
    for i, (a, b) in enumerate(zip(got[False], got[True])):
        gaps = [e["top"][1][0] - e["top"][1][1] for e in a.logprobs]
        if i in sampled:
            if len(b.tokens) != payloads[i]["max_new_tokens"]:
                fail(f"paged (b, float32): sampled request {i} has "
                     f"{len(b.tokens)} tokens")
            f32.append(dict(request=i, sampled=True,
                            equal=a.tokens == b.tokens))
            continue
        row = _near_tie_check(f"paged (b, float32) request {i}", b.tokens,
                              a.tokens, gaps, payloads[i]["max_new_tokens"])
        f32.append(dict(request=i, equal=row["diverge"] is None, **row))
    f32_equal = sum(r["equal"] for r in f32)
    print(f"paged (b, float32, {PAGED_F32_LAYERS} layers, serve's "
          f"defaults): run A's "
          f"{SERVE_REQUESTS} requests through the paged engine: "
          f"{f32_equal} of {SERVE_REQUESTS} token-identical to the ring "
          f"engine's, the {SERVE_REQUESTS - len(sampled)} greedy ones up to "
          f"its first near-tie (gap < {PARITY_NEAR_TIE})")

    ops.reset_launch_counts()
    # each engine goes before the next is built: a burst's peak device
    # memory is its own engine's alone
    srv, paged = _paged_http(torch, serve, payloads,
                             ["--seed", "21", "--paged-kv"], "paged (b)")
    costs = _paged_block_costs(torch, S, srv, rng, "paged (b)")
    del srv
    srv, over = _paged_http(
        torch, serve, payloads, ["--seed", "21", "--paged-kv", "--slots",
                                 str(PAGED_OVER_SLOTS), "--kv-pool-blocks",
                                 str(paged["pool_blocks_total"])],
        "paged (c)")
    over_costs = _paged_block_costs(torch, S, srv, rng, "paged (c)")
    del srv
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"paged (b, c): kernels launched {counts}, expected none")
    for rec in (paged, over):
        del rec["tokens"]
    print(f"paged (b, bf16, {SERVE_CUT_LAYERS} layers, serve's defaults + "
          f"--paged-kv, "
          f"{paged['pool_blocks_total']} blocks of {PAGED_KV_BLOCK}): run "
          f"A's {SERVE_REQUESTS} requests {SERVE_REQUESTS} of "
          f"{SERVE_REQUESTS} done; "
          f"{paged['output_tokens_per_s']:.1f} output tokens/s (the serving "
          f"phase at {N_LAYERS} layers {run_a['output_tokens_per_s']:.1f}); "
          f"latency p50 "
          f"{paged['latency_s_p50']:.3f} s, max {paged['latency_s_max']:.3f}"
          f" s; a block's host dispatch "
          f"{paged['block_dispatch_ms_p50']:.2f} ms (run A at {N_LAYERS} "
          f"layers {run_a['block_dispatch_ms_p50']:.2f}); a block's wall "
          f"{costs['block']['wall_ms']:.2f} ms and device "
          f"{costs['block']['device_ms_warm']} ms (run A "
          f"{run_a['block_wall_ms']:.2f}, {run_a['block_device_ms']}); "
          f"synchronisations 0 in dispatch, {paged['admission_syncs']} in "
          f"admission; peak device memory "
          f"{paged['peak_bytes']} bytes, {paged['base_bytes']} of them "
          f"allocated before the app; "
          f"{paged['prefill_calls']} prefill calls; launches {counts}")
    print(f"paged (c, {PAGED_OVER_SLOTS} slots on the same "
          f"{over['pool_blocks_total']} blocks): {SERVE_REQUESTS} of "
          f"{SERVE_REQUESTS} done, {over['admission_defers']} admissions "
          f"deferred, {over['pool_blocks_peak']} blocks at the peak; "
          f"{over['output_tokens_per_s']:.1f} output tokens/s ((b) "
          f"{paged['output_tokens_per_s']:.1f}), latency p50 "
          f"{over['latency_s_p50']:.3f} s; the {PAGED_OVER_SLOTS}-slot "
          f"view's gather {over_costs['gather_ms']:.4f} ms (bound "
          f"{over_costs['gather_bound_ms']:.4f}); a block's device time "
          f"{over_costs['block']['device_ms_warm']} ms; peak device memory "
          f"{over['peak_bytes']} bytes ({over['base_bytes']} before the "
          f"app); {nvidia_smi_line()}")
    return dict(float32=dict(equal=f32_equal, rows=[
        r for r in f32 if not r["equal"] or r.get("near_ties")
        or r.get("sampled")]),
        paged=paged, paged_costs=costs, over=over, over_costs=over_costs,
        launches=counts)


def _paged_tiers(torch, S, serve) -> dict:
    """(d): serve's app with --paged-kv, --max-queue 8, --batch-queue-frac
    0.5 and a batch budget of PAGED_TIER_BUDGET blocks; PAGED_TIER batch
    requests, then PAGED_TIER interactive ones: every shed is batch, no
    interactive request is refused while a batch one is queued. Then a
    burst of PAGED_BURST long prompts while PAGED_STREAMS streams decode,
    without and with interleaved prefill: the streams' delivery gaps."""
    import threading

    import numpy as np

    rng = np.random.default_rng(71)
    payloads = {cls: [dict(prompt=rng.integers(0, 32768, int(n)).tolist(),
                           max_new_tokens=int(m), priority=cls,
                           timeout_s=600.0)
                      for n, m in zip(rng.integers(64, 1537, PAGED_TIER),
                                      rng.integers(32, 129, PAGED_TIER))]
                for cls in ("batch", "interactive")}
    app, httpd, url = _serve_app(serve, SHALLOW + [
        "--seed", "71", "--paged-kv", "--max-queue", "8",
        "--batch-queue-frac", "0.5", "--class-budget-batch",
        str(PAGED_TIER_BUDGET)])
    srv = app.server
    refusals, submit = [], srv.submit
    alloc, peak_batch = srv._allocator, [0]
    alloc_for = alloc.alloc_for

    def checked_submit(req):        # under the app's lock
        queued = [r.priority for r in srv._queue]
        try:
            return submit(req)
        except S.QueueFullError:
            refusals.append((req.priority, queued.count("batch")))
            raise

    def tracked_alloc(cls, n, *share):
        got = alloc_for(cls, n, *share)
        peak_batch[0] = max(peak_batch[0], alloc.class_used["batch"])
        return got

    srv.submit, alloc.alloc_for = checked_submit, tracked_alloc
    results = {}
    try:
        def post(cls, i):
            results[cls, i] = _post(url, payloads[cls][i])

        # the batch requests 50 ms apart, so the loop admits some until the
        # budget binds and the rest queue, then the interactive ones at once
        threads = []
        for cls in ("batch", "interactive"):
            for i in range(PAGED_TIER):
                threads.append(threading.Thread(target=post, args=(cls, i)))
                threads[-1].start()
                time.sleep(0.05 if cls == "batch" else 0)
            time.sleep(0.3)
        for t in threads:
            t.join(timeout=900)
        with app.lock:
            st = srv.stats()
    finally:
        _stop_app(app, httpd)
    count = collections.Counter()
    for (cls, i), (status, body, _) in results.items():
        if status == 200:
            if body["finish_reason"] != "length" or len(body["tokens"]) != \
                    payloads[cls][i]["max_new_tokens"]:
                fail(f"paged (d): {cls} request {i}: {body}")
            count[cls, "done"] += 1
        elif status == 429:
            kind = "shed" if "shed by" in body["error"] else "refused"
            count[cls, kind] += 1
        else:
            fail(f"paged (d): {cls} request {i} answered {status}: {body}")
    if count["interactive", "shed"]:
        fail(f"paged (d): an interactive request was shed: {dict(count)}")
    bad = [q for cls, q in refusals if cls == "interactive" and q]
    if bad:
        fail(f"paged (d): interactive refused with {bad} batch queued")
    sh = st["shed_by_class"]
    if (sh["interactive"] != count["interactive", "refused"]
            or sh["batch"] != count["batch", "refused"]
            + count["batch", "shed"]):
        fail(f"paged (d): shed_by_class {sh} against {dict(count)}")
    if peak_batch[0] > PAGED_TIER_BUDGET or st["paged_kv"]["class_used"] != \
            {"interactive": 0, "batch": 0}:
        fail(f"paged (d): batch held {peak_batch[0]} blocks, "
             f"{st['paged_kv']['class_used']} after the drain")
    srv._allocator.check()
    tiers = dict(counts={f"{c}_{k}": n for (c, k), n in count.items()},
                 shed_by_class=sh, batch_peak_blocks=peak_batch[0],
                 admission_defers=st["paged_kv"]["admission_defers"])
    print(f"paged (d, tiers: --max-queue 8, batch at half of it, a batch "
          f"budget of {PAGED_TIER_BUDGET} blocks): {PAGED_TIER} batch then "
          f"{PAGED_TIER} interactive requests: {tiers['counts']}; "
          f"shed_by_class {sh}; every interactive refusal found no batch "
          f"request queued; the batch class held at most {peak_batch[0]} "
          f"blocks; {tiers['admission_defers']} admissions deferred")
    del app, srv

    streams = [dict(prompt=rng.integers(0, 32768, PAGED_STREAM_LEN).tolist(),
                    max_new_tokens=PAGED_STREAM_NEW, timeout_s=600.0)
               for _ in range(PAGED_STREAMS)]
    burst = [dict(prompt=rng.integers(0, 32768, PAGED_BURST_LEN).tolist(),
                  max_new_tokens=16, timeout_s=600.0)
             for _ in range(PAGED_BURST)]
    gaps = {}
    for inter in PAGED_INTERLEAVES:
        torch.cuda.empty_cache()
        app, httpd, url = _serve_app(serve, SHALLOW + [
            "--seed", "73", "--paged-kv", "--slots", "16",
            "--journal-checkpoint-s", "0.25", "--prefill-interleave",
            str(inter)])
        srv = app.server
        comps = _record_completions(srv)
        out = {}
        try:
            if _post(url, dict(prompt=list(range(1, 300)),
                               max_new_tokens=16))[0] != 200:
                fail("paged (d): warm-up failed")
            t = threading.Thread(target=lambda: out.__setitem__(
                "streams", _sse_all(url + "?stream=true", streams)))
            t.start()
            deadline = time.perf_counter() + 120
            while time.perf_counter() < deadline:
                with app.lock:
                    n = srv.stats()["active"]
                if n >= PAGED_STREAMS:
                    break
                time.sleep(0.05)
            time.sleep(1.0)             # a few deliveries before the burst
            t0 = time.perf_counter()
            res = _post_all(url, burst)
            burst_wall = time.perf_counter() - t0
            t.join(timeout=900)
            with app.lock:
                st = srv.stats()["paged_kv"]
        finally:
            _stop_app(app, httpd)
            del srv.drain_completed
        recs = []
        for i, r in enumerate(out["streams"]):
            rec = _stream_record(f"paged (d) stream {i}", r,
                                 PAGED_STREAM_NEW)
            if rec["tokens"] != comps[rec["rid"]].tokens:
                fail(f"paged (d) stream {i}: not its completion")
            recs.append(rec)
        cad = _cadence(recs)
        lat = _quantiles([r[2] for r in res])
        gaps[inter] = dict(gap_s_p50=cad["delivery_gap_s_p50"],
                           gap_s_p99=cad["delivery_gap_s_p99"],
                           gap_s_max=max(b - a for r in recs for a, b in
                                         zip(r["times"], r["times"][1:])),
                           burst_wall_s=burst_wall,
                           burst_latency_s_p50=lat["p50"],
                           burst_latency_s_max=lat["max"],
                           interleaved=st["prefill_chunks_interleaved"])
        srv._allocator.check()
        del app, srv
        print(f"paged (d, --prefill-interleave {inter}): {PAGED_BURST} "
              f"prompts of {PAGED_BURST_LEN} tokens while {PAGED_STREAMS} "
              f"streams decode ({PAGED_STREAM_NEW} new each): the streams' "
              f"delivery gap p50 {gaps[inter]['gap_s_p50']:.3f} s, p99 "
              f"{gaps[inter]['gap_s_p99']:.3f} s, max "
              f"{gaps[inter]['gap_s_max']:.3f} s; the burst's latency p50 "
              f"{lat['p50']:.3f} s, max {lat['max']:.3f} s; "
              f"{st['prefill_chunks_interleaved']} pumps cut by the cap")
    return dict(tiers=tiers, interleave=gaps)


def _paged_prefix(torch, S, G, T, serve, prefix_admit) -> dict:
    """(e): serve's app with --paged-kv --prefix-cache-blocks
    PAGED_TRIE_BLOCKS and the prefix-cache cell's requests, cold then warm:
    a warm request maps at least the prefix's trie blocks and copies none;
    an admission burst of 8, cold and warm, beside the ring prefix cache's;
    warm completions against cold ones at float32 (2 layers)."""
    import threading

    prompts = _prefix_prompts(31)
    app, httpd, url = _serve_app(serve, FLAGSHIP + [
        "--seed", "31", "--paged-kv", "--prefix-cache-blocks",
        str(PAGED_TRIE_BLOCKS)])
    srv = app.server
    mapped, try_admit = {}, srv._try_admit_paged

    def recording(slot, qidx):
        rid = srv._queue[qidx].id
        status = try_admit(slot, qidx)
        if status == "ok":
            mapped[rid] = len(srv._slot_shared[slot])
        return status

    srv._try_admit_paged = recording
    shared, stop = [0], threading.Event()

    def poll():
        while not stop.is_set():
            with app.lock:
                shared[0] = max(shared[0], srv.stats()["paged_kv"]
                                ["pool_state"]["shared"])
            time.sleep(0.005)

    def requests():
        return [dict(prompt=p, max_new_tokens=PREFIX_NEW) for p in prompts]

    try:
        cold = _post_all(url, requests())
        n_cold = len(mapped)
        poller = threading.Thread(target=poll)
        poller.start()
        warm = _post_all(url, requests())
        stop.set()
        poller.join()
        with app.lock:
            st = srv.stats()
    finally:
        stop.set()
        _stop_app(app, httpd)
    del srv._try_admit_paged
    warm_mapped = list(mapped.values())[n_cold:]
    want = PREFIX_LEN // PAGED_KV_BLOCK
    if (len(warm_mapped) != PREFIX_REQUESTS or min(warm_mapped) < want
            or st["prefix_cache"]["copy_dispatches"]
            or st["prefix_cache"]["insert_dispatches"] or not shared[0]):
        fail(f"paged (e): warm requests mapped {warm_mapped} trie blocks "
             f"(want >= {want}), {st['prefix_cache']} copies, "
             f"pool_state.shared peaked at {shared[0]}")
    for res in cold + warm:
        if len(res[1]["tokens"]) != PREFIX_NEW:
            fail(f"paged (e): {res[1]}")
    same = sum(c[1]["tokens"] == w[1]["tokens"] for c, w in zip(cold, warm))
    lat_cold = _quantiles([r[2] for r in cold])
    lat_warm = _quantiles([r[2] for r in warm])
    srv.reset()
    admit = {}
    for name in ("cold", "warm"):
        before = srv.stats()
        reqs = [S.Request(prompt=p, max_new_tokens=PREFIX_NEW)
                for p in prompts[:8]]
        for r in reqs:
            srv.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv._admit()
        torch.cuda.synchronize()
        after = srv.stats()
        admit[name] = dict(
            ms=(time.perf_counter() - t0) * 1e3,
            computed=after["prefill_tokens_computed"]
            - before["prefill_tokens_computed"],
            reused=after["prefill_tokens_reused"]
            - before["prefill_tokens_reused"],
            prefill_calls=after["admission_dispatches"]
            - before["admission_dispatches"])
        srv.run_until_drained()
    srv._allocator.check()
    del app, srv
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    w = G.prepare_decode(T.init(cfg, torch.Generator(device=dev)
                                .manual_seed(33), dev), cfg)
    pprompts = _prefix_prompts(33)
    eng = S.SlotServer(w, cfg, paged=True,
                       prefix_cache_blocks=PAGED_TRIE_BLOCKS)
    passes = {}
    for name in ("cold", "warm"):
        reqs = [S.Request(prompt=p, max_new_tokens=PREFIX_NEW, logprobs=2)
                for p in pprompts]
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        passes[name] = [done[r.id] for r in reqs]
    rows = []
    for i, (c, wm) in enumerate(zip(passes["cold"], passes["warm"])):
        gaps = [e["top"][1][0] - e["top"][1][1] for e in c.logprobs]
        rows.append(_near_tie_check(f"paged (e, float32) request {i}",
                                    wm.tokens, c.tokens, gaps, PREFIX_NEW))
    eng._allocator.check()
    f32_same = sum(r["diverge"] is None for r in rows)
    del eng, w
    torch.cuda.empty_cache()
    print(f"paged (e, --prefix-cache-blocks {PAGED_TRIE_BLOCKS} of "
          f"{PAGED_KV_BLOCK} tokens): {PREFIX_REQUESTS} requests sharing a "
          f"{PREFIX_LEN}-token prefix, cold then warm: every warm request "
          f"mapped {min(warm_mapped)}-{max(warm_mapped)} trie blocks into "
          f"its table (>= {want}), 0 copies, pool_state.shared up to "
          f"{shared[0]}; latency p50 cold {lat_cold['p50']:.3f} s, warm "
          f"{lat_warm['p50']:.3f} s; {same} of {PREFIX_REQUESTS} warm equal "
          f"cold (bf16); an admission burst of 8 to the device's end: cold "
          f"{admit['cold']['ms']:.1f} ms ({admit['cold']['prefill_calls']} "
          f"prefill calls), warm {admit['warm']['ms']:.1f} ms "
          f"({admit['warm']['computed']} tokens prefilled, "
          f"{admit['warm']['reused']} mapped, "
          f"{admit['warm']['prefill_calls']} calls); the ring prefix "
          f"cache's: cold {prefix_admit['cold']['ms']:.1f} ms, warm "
          f"{prefix_admit['warm']['ms']:.1f} ms "
          f"({prefix_admit['warm']['computed']} prefilled, "
          f"{prefix_admit['warm']['reused']} copied); float32 (2 layers) "
          f"{f32_same} of {PREFIX_REQUESTS} warm completions equal cold, "
          f"every other one only at or after a near-tie")
    return dict(warm_mapped_min=min(warm_mapped), shared_peak=shared[0],
                latency_s_p50=dict(cold=lat_cold["p50"],
                                   warm=lat_warm["p50"]),
                warm_equal_cold_bf16=same, admission=admit,
                ring_admission=prefix_admit, float32_equal=f32_same,
                float32_rows=[r for r in rows if r["diverge"] is not None
                              or r["near_ties"]])


def _paged_replay(torch, G, T, S) -> dict:
    """(f): float32, 2 layers, REPLAY_F32 requests through 3 slots on the
    paged engine with crashes at decode blocks REPLAY_F32_CRASH: every
    completion equals the crashless paged server's up to its first
    near-tie, and the allocator's invariant holds after."""
    import numpy as np

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    w = G.prepare_decode(T.init(cfg, torch.Generator(device=dev)
                                .manual_seed(43), dev), cfg)
    rng = np.random.default_rng(43)
    prompts = [rng.integers(0, 32768, int(n)).tolist()
               for n in rng.integers(64, 513, REPLAY_F32)]
    ref = S.SlotServer(w, cfg, slots=3, max_len=1024, paged=True)
    reqs = [S.Request(prompt=p, max_new_tokens=REPLAY_F32_NEW, logprobs=2)
            for p in prompts]
    for r in reqs:
        ref.submit(r)
    got = ref.run_until_drained()
    want = [got[r.id] for r in reqs]
    os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"] = REPLAY_F32_CRASH
    try:
        srv = S.SlotServer(w, cfg, slots=3, max_len=1024, paged=True)
    finally:
        del os.environ["TONY_TEST_SERVING_CRASH_AT_BLOCKS"]
    reqs = [S.Request(prompt=p, max_new_tokens=REPLAY_F32_NEW)
            for p in prompts]
    done, prefixes = _crash_harness(srv, reqs)
    if srv.chaos_faults_injected != 2 or srv.replays < 1:
        fail(f"paged (f): {srv.chaos_faults_injected} crashes, "
             f"{srv.replays} replays")
    rows = []
    for i, (r, c) in enumerate(zip(reqs, want)):
        toks = done[r.id].tokens
        _check_prefixes("paged (f)", toks, prefixes[r.id])
        gaps = [e["top"][1][0] - e["top"][1][1] for e in c.logprobs]
        rows.append(_near_tie_check(f"paged (f) request {i}", toks, c.tokens,
                                    gaps, REPLAY_F32_NEW))
    srv._allocator.check()
    if srv.stats()["paged_kv"]["pool_blocks_used"]:
        fail("paged (f): blocks held after the drain")
    equal = sum(r["diverge"] is None for r in rows)
    print(f"paged (f, float32, 2 layers): {REPLAY_F32} requests through 3 "
          f"slots, crashes at decode blocks {REPLAY_F32_CRASH}, "
          f"{srv.replays} replays ({srv.replayed_tokens} journaled tokens): "
          f"{equal} of {REPLAY_F32} token-identical to the crashless paged "
          f"server, every other one only at or after a near-tie; the "
          f"allocator's invariant holds")
    del ref, srv, w
    torch.cuda.empty_cache()
    return dict(resumed=len(prefixes), equal=equal,
                rows=[r for r in rows if r["diverge"] is not None
                      or r["near_ties"]])


def phase_paged(torch, ops, run_a, prefix_admit) -> dict:
    """Paged KV and the admission tiers (SlotServer(paged=True), serve's
    --paged-kv flags): (a) token identity with the ring engine in five
    modes at float32 and bf16; (b) run A's requests through both engines
    at float32 and with --paged-kv at bf16; (c) PAGED_OVER_SLOTS slots on
    the same pool; (d) the
    class tiers and interleaved prefill; (e) the paged prefix cache; (f)
    replay. Returns the kernels' launches (none: the paged engine runs the
    ring engine's einsum programs on a gathered view)."""
    print("== main path: paged KV")
    from tony_tpu_torch.cli import serve
    from tony_tpu_torch.models import generate as G
    from tony_tpu_torch.models import serving as S
    from tony_tpu_torch.models import transformer as T

    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    identity = _paged_identity(torch, G, T, S)
    lap("a")
    flagship = _paged_serving(torch, ops, S, G, T, serve, run_a)
    lap("b, c")
    tiers = _paged_tiers(torch, S, serve)
    lap("d")
    prefix = _paged_prefix(torch, S, G, T, serve, prefix_admit)
    lap("e")
    replay = _paged_replay(torch, G, T, S)
    lap("f")
    counts = ops.launch_counts()
    if any(counts.values()):
        fail(f"paged: kernels launched {counts}, expected none")
    print("paged " + json.dumps(dict(
        identity=identity, flagship=flagship, tiers=tiers, prefix=prefix,
        replay=replay, launches=counts, seconds=seconds,
        card=nvidia_smi_line())))
    return counts


# ------------------------------------------------------------ telemetry

_PROM_META = re.compile(
    r"^# (HELP|TYPE) ([a-zA-Z_:][a-zA-Z0-9_:]*)(?: (.*))?$")
_PROM_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')


def _exposition(text: str) -> tuple:
    """A small check of Prometheus text (format 0.0.4), standing alone:
    every line a HELP or TYPE comment or a sample, a family's TYPE once
    and before its samples, no series twice, label blocks well formed;
    per histogram and label set, cumulative buckets ending at +Inf and
    +Inf equal to _count. -> ({family: type}, {series: value}), a series
    being the sample's line up to its value; raises ValueError."""
    types, samples, buckets, counts = {}, {}, {}, {}
    for line in text.splitlines():
        if not line:
            continue
        m = _PROM_META.match(line)
        if m:
            if m.group(1) == "TYPE":
                if m.group(2) in types or m.group(3) not in (
                        "counter", "gauge", "histogram"):
                    raise ValueError(f"bad TYPE line {line!r}")
                types[m.group(2)] = m.group(3)
            continue
        m = _PROM_SAMPLE.match(line)
        if not m:
            raise ValueError(f"malformed line {line!r}")
        name, block, value = m.group(1), m.group(2) or "", float(m.group(3))
        labels, pos = {}, 0
        while pos < len(block):
            lm = _PROM_LABEL.match(block, pos)
            if not lm:
                raise ValueError(f"malformed labels {line!r}")
            labels[lm.group(1)] = lm.group(2)
            pos = lm.end()
        series = line.rsplit(" ", 1)[0]
        if series in samples:
            raise ValueError(f"series twice: {series!r}")
        samples[series] = value
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        fam = base if types.get(base) == "histogram" else name
        if fam not in types:
            raise ValueError(f"sample before its TYPE: {line!r}")
        if fam != name:
            key = (fam, tuple(sorted((k, v) for k, v in labels.items()
                                     if k != "le")))
            if name.endswith("_bucket"):
                le = labels["le"]
                buckets.setdefault(key, []).append(
                    (math.inf if le == "+Inf" else float(le), value))
            elif name.endswith("_count"):
                counts[key] = value
    for key, bs in buckets.items():
        les = [le for le, _ in bs]
        vals = [v for _, v in bs]
        if les != sorted(les) or les[-1] != math.inf \
                or vals != sorted(vals) or counts.get(key) != vals[-1]:
            raise ValueError(f"histogram {key} is not cumulative to _count")
    return types, samples


def _get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def _scraper(base: str, every_s: float):
    """GET /metrics every ``every_s`` on a thread, each scrape through
    ``_exposition`` -> (stop(), the scrapes' record)."""
    import threading

    rec = {"n": 0, "errors": [], "ms": []}
    halt = threading.Event()

    def run():
        while not halt.wait(every_s):
            t0 = time.perf_counter()
            try:
                _exposition(_get(base + "/metrics"))
                rec["n"] += 1
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
            except Exception as e:
                rec["errors"].append(repr(e))

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def stop():
        halt.set()
        t.join(timeout=60)
        return rec

    return stop


def _scrape_pair(base: str) -> tuple:
    """/metrics and /stats of an idle app -> (samples, stats)."""
    _, samples = _exposition(_get(base + "/metrics"))
    return samples, json.loads(_get(base + "/stats"))


def _quiet_run_a(torch, serve, payloads, trace_dir) -> dict:
    """Run A through serve's app with --trace-dir and no scrape: the
    configuration (a) runs, less its scrapes, in turn with it."""
    gc.collect()
    torch.cuda.empty_cache()
    app, httpd, url = _serve_app(serve, SHALLOW + [
        "--seed", "21", "--trace-dir", str(trace_dir)])
    try:
        t0 = time.perf_counter()
        _post_all(url, payloads)
        wall = time.perf_counter() - t0
        disp = [x * 1e3 for x in app.server.block_dispatch_s]
    finally:
        _stop_app(app, httpd)
    shutil.rmtree(trace_dir, ignore_errors=True)
    n_out = sum(pl["max_new_tokens"] for pl in payloads)
    return dict(output_tokens_per_s=n_out / wall,
                block_dispatch_ms_p50=_quantiles(disp)["p50"])


def _telemetry_run_a(torch, ops, S, serve, run_a, base_block,
                     trace_dir) -> dict:
    """(a) run A's 24 requests with /metrics scraped every
    TELEMETRY_SCRAPE_S, then the idle scrape against /stats and the trace
    file, a block's device time against ``base_block``'s (a block of an
    engine without --trace-dir at the same depth), and (d) a restart on
    the same --trace-dir. Run A without the scrapes goes first, in
    turn."""
    from tony_tpu_torch.events.trace import TRACE_FILE, read_traces
    from tony_tpu_torch.observability import TERMINAL_SPANS

    rng, _, news, _, payloads = _serve_payloads()
    quiet = _quiet_run_a(torch, serve, payloads,
                         trace_dir.with_name(trace_dir.name + "_quiet"))
    gc.collect()
    torch.cuda.empty_cache()
    argv = SHALLOW + ["--seed", "21", "--trace-dir", str(trace_dir)]
    app, httpd, url = _serve_app(serve, argv)
    base = url.rsplit("/", 1)[0]
    srv = app.server
    syncs = _checked_dispatch(torch, srv)
    try:
        ops.reset_launch_counts()
        stop = _scraper(base, TELEMETRY_SCRAPE_S)
        t0 = time.perf_counter()
        results = _post_all(url, payloads)
        wall = time.perf_counter() - t0
        scrapes = stop()
        counts = ops.launch_counts()
        drained = srv.dispatch_tracker.drain(timeout=60)
        samples, stats = _scrape_pair(base)
        health = app.health()
        records = read_traces(trace_dir / TRACE_FILE)
        disp = [x * 1e3 for x in srv.block_dispatch_s]
        tel_blocks = srv.telemetry.hist["decode_block_s"].count
        with app.lock:
            state = json.loads(json.dumps(srv.telemetry.state()))
    finally:
        _stop_app(app, httpd)
        del srv._dispatch_block, srv._admit
    # the loop is stopped: the engine is this thread's
    blk = _profile_block(torch, S, srv, rng, "telemetry")
    del srv
    if app.loop_failures or not health["healthy"]:
        fail(f"telemetry (a): the loop failed: {health}")
    for i, ((_, body, _), pl) in enumerate(zip(results, payloads)):
        if body["finish_reason"] != "length" or \
                len(body["tokens"]) != pl["max_new_tokens"]:
            fail(f"telemetry (a): request {i} ended {body['finish_reason']} "
                 f"with {len(body['tokens'])} tokens")
    if any(counts.values()):
        fail(f"telemetry (a): kernels launched {counts}, expected none")
    if syncs["admission"]:
        fail(f"telemetry (a): {syncs['admission']} synchronisations in "
             f"admission {dict(syncs['sites'])}")
    if scrapes["errors"] or scrapes["n"] < 2:
        fail(f"telemetry (a): {scrapes['n']} scrapes, errors "
             f"{scrapes['errors'][:3]}")
    lat = stats["latency"]
    pairs = {"serving_queue_depth": stats["queued"],
             "serving_active_slots": stats["active"],
             "serving_slots": stats["slots"],
             "serving_shed_total": stats["shed"],
             "serving_retry_after_s": stats["retry_after_s"],
             "serving_blocks_dispatched_total": stats["blocks_dispatched"],
             "serving_admission_dispatches_total":
                 stats["admission_dispatches"],
             "serving_prefill_tokens_computed_total":
                 stats["prefill_tokens_computed"],
             "serving_ttft_seconds_count": lat["ttft_s"]["count"],
             "serving_e2e_seconds_count": lat["e2e_s"]["count"],
             "serving_decode_block_seconds_count":
                 lat["decode_block_s"]["count"]}
    wrong = {k: (samples.get(k), v) for k, v in pairs.items()
             if samples.get(k) != v}
    if wrong:
        fail(f"telemetry (a): /metrics against /stats {wrong}")
    if lat["ttft_s"]["count"] != SERVE_REQUESTS or \
            tel_blocks != stats["blocks_dispatched"]:
        fail(f"telemetry (a): TTFT count {lat['ttft_s']['count']}, "
             f"{tel_blocks} of {stats['blocks_dispatched']} blocks timed")
    device = _device_time_checks("telemetry (a)", stats, samples, drained)
    if len(records) != SERVE_REQUESTS or any(
            [n for n, _ in r["spans"]][-1] != "finished"
            or sum(n in TERMINAL_SPANS for n, _ in r["spans"]) != 1
            for r in records):
        fail(f"telemetry (a): {len(records)} trace records, or a record "
             "without exactly one terminal")
    want = base_block["device_ms"]
    diff = _device_time_check("telemetry (a)", blk["device_ms"], want,
                              "a block without --trace-dir (streaming)")

    # ---- (d) a new serve on the same --trace-dir resumes the dump
    dump = json.loads((trace_dir / serve.TELEMETRY_STATE_FILE).read_text())
    if dump != state:
        fail("telemetry (d): the dump is not the histograms at shutdown")
    gc.collect()
    torch.cuda.empty_cache()
    app, httpd, url = _serve_app(serve, argv)
    try:
        resumed = json.loads(json.dumps(app.server.telemetry.state()))
        again = _post(url, payloads[0])
        after = app.server.telemetry.hist["e2e_s"].count
    finally:
        _stop_app(app, httpd)
    if resumed != dump or again[0] != 200 or \
            after != dump["e2e_s"]["count"] + 1:
        fail(f"telemetry (d): restored {resumed == dump}, request "
             f"{again[0]}, e2e count {after} after "
             f"{dump['e2e_s']['count']}")
    out_tokens = int(news.sum())
    svc = sorted(r["spans"][-1][1] - dict(r["spans"])["admitted"]
                 for r in records)
    return dict(
        wall_s=wall, output_tokens_per_s=out_tokens / wall,
        scrapes=scrapes["n"], scrape_ms_p50=_quantiles(scrapes["ms"])["p50"],
        scrape_ms_max=_quantiles(scrapes["ms"])["max"],
        block_dispatch_ms_p50=_quantiles(disp)["p50"],
        block_dispatch_ms_serving=run_a["block_dispatch_ms_p50"],
        block_dispatch_ms_unscraped=quiet["block_dispatch_ms_p50"],
        output_tokens_per_s_unscraped=quiet["output_tokens_per_s"],
        block_device_ms=blk["device_ms"], block_wall_ms=blk["wall_ms"],
        block_device_ms_baseline=want, block_device_time_diff=diff,
        admission_syncs=syncs["admission"],
        device=device, ttft_s=lat["ttft_s"], tpot_s=lat["tpot_s"],
        queue_wait_s=lat["queue_wait_s"], e2e_s=lat["e2e_s"],
        loop_turn_s=lat["loop_turn_s"],
        service_s_p50=svc[len(svc) // 2], trace_records=len(records),
        resumed_e2e_count=dump["e2e_s"]["count"], launches=counts)


def _device_time_checks(name, stats, samples, drained) -> dict:
    """The dispatch tracker against the engine, on an idle app's /stats
    and /metrics after the tracker drained: each kind tracked as often as
    the engine dispatched it (prefill calls, decode blocks, paged
    scatters, prefix copies and inserts), nothing dropped, no reap error,
    nothing in flight; the five dispatch families equal /stats' device;
    a device lag for every decode block. -> the record."""
    dev = stats["device"]
    pk, pc = stats.get("paged_kv") or {}, stats.get("prefix_cache") or {}
    want = {"prefill": stats["admission_dispatches"],
            "decode_block": stats["blocks_dispatched"],
            "paged_scatter": pk.get("scatter_dispatches", 0),
            "prefix_copy": pc.get("copy_dispatches", 0),
            "prefix_insert": pc.get("insert_dispatches", 0)}
    want = {k: n for k, n in want.items() if n}
    got = {k: h["count"] for k, h in dev["dispatch_ready"].items()}
    lag = stats["latency"].get("device_lag_s", {"count": 0})
    pairs = {"serving_dispatches_tracked_total": dev["tracked"],
             "serving_dispatch_track_dropped_total": dev["dropped"],
             "serving_dispatch_reap_errors_total": dev["reap_errors"],
             "serving_inflight_dispatches": dev["in_flight"],
             "serving_device_lag_seconds_count": lag["count"]}
    pairs.update({f'serving_dispatch_ready_seconds_count{{kind="{k}"}}': n
                  for k, n in got.items()})
    wrong = {k: (samples.get(k), v) for k, v in pairs.items()
             if samples.get(k) != v}
    if not drained or got != want or dev["tracked"] != sum(want.values()) \
            or dev["dropped"] or dev["reap_errors"] or dev["in_flight"] \
            or wrong or lag["count"] != stats["blocks_dispatched"]:
        fail(f"{name}: device time: drained {drained}, tracked {got} "
             f"against the engine's dispatches {want} (total "
             f"{dev['tracked']}), dropped {dev['dropped']}, reap errors "
             f"{dev['reap_errors']}, in flight {dev['in_flight']}, "
             f"/metrics against /stats {wrong}, device lag count "
             f"{lag['count']} of {stats['blocks_dispatched']} blocks")
    return dict(tracked=dev["tracked"], by_kind=got, device_lag_s=lag,
                dispatch_ready={k: {q: h[q] for q in ("p50_s", "p99_s")}
                                for k, h in dev["dispatch_ready"].items()})


def _reaper_host_cost(torch) -> dict:
    """What the tracker's wait costs the host, on a kernel that keeps the
    card busy (``torch.cuda._sleep``): a pure-Python loop's time while the
    reaper waits, against the same loop with the reaper idle (the wait
    must release the interpreter lock), the best of three runs on each
    side, the sides in turns (idle, waiting, waiting, idle, idle, waiting:
    a slow stretch of the host falls on both; a single waiting run against
    a best of three idle ones read the host's noise as a cost), and the
    process's CPU seconds a wall second while this thread sleeps and the
    reaper waits (a blocking event's wait sleeps; a spinning one burns a
    core). A default, spinning CUDA event's wait is measured beside it."""
    from tony_tpu_torch.models.serving import _Fence
    from tony_tpu_torch.observability import DispatchTracker

    def loop():
        t0 = time.perf_counter()
        x = 0
        for i in range(3_000_000):
            x += i
        return time.perf_counter() - t0

    def waiting(tr, blocking, seconds):
        """Queue a sleep kernel of ``seconds`` and have the reaper wait on
        an event behind it."""
        torch.cuda.synchronize()
        torch.cuda._sleep(int(seconds * 2e9))
        ev = torch.cuda.Event(blocking=blocking)
        ev.record()
        tr.track("sleep", _Fence(ev))
        time.sleep(0.05)
        if tr.in_flight != 1:
            fail("reaper cost: the reaper is not waiting")

    def drained(tr) -> bool:
        """Whether the reaper was still waiting; then wait for it."""
        still = tr.in_flight == 1
        if not tr.drain(timeout=30):
            fail("reaper cost: the sleep kernel never became ready")
        return still

    def during(blocking):
        tr = DispatchTracker()
        idle, busy, still = [], [], True
        try:
            for side in ("idle", "waiting", "waiting", "idle", "idle",
                         "waiting"):
                if side == "idle":
                    idle.append(loop())
                    continue
                # a loop takes about 0.13 s: the kernel outlasts it
                waiting(tr, blocking, 0.6)
                busy.append(loop())
                still &= drained(tr)
            waiting(tr, blocking, 0.6)
            c0, w0 = time.process_time(), time.perf_counter()
            time.sleep(0.2)
            cpu_share = (time.process_time() - c0) / (time.perf_counter()
                                                      - w0)
            still &= drained(tr)
            return min(idle), min(busy), cpu_share, still
        finally:
            tr.shutdown()

    idle, loop_b, cpu_b, still_b = during(True)
    idle_s, loop_s, cpu_s, still_s = during(False)
    out = dict(loop_idle_s=idle, loop_waiting_s=loop_b,
               loop_ratio=loop_b / idle, cpu_share_blocking=cpu_b,
               cpu_share_spinning=cpu_s, loop_ratio_spinning=loop_s / idle_s,
               measured_while_waiting=still_b and still_s)
    print(f"reaper cost: a Python loop {loop_b * 1e3:.1f} ms while the "
          f"reaper waits on a blocking event, {idle * 1e3:.1f} ms idle "
          f"(best of three each, in turns) "
          f"(ratio {out['loop_ratio']:.3f}; beside a spinning event "
          f"{out['loop_ratio_spinning']:.3f}); process CPU a wall second "
          f"while the reaper waits: {cpu_b:.3f} (spinning event "
          f"{cpu_s:.3f}); waits still pending at the end "
          f"{out['measured_while_waiting']}")
    if not out["measured_while_waiting"] or out["loop_ratio"] > 1.3 \
            or cpu_b > 0.5:
        fail(f"reaper cost: {out}")
    return out


def _capture_profile(base: str, delay_s: float, seconds: float):
    """GET /debug/profile?seconds=N on a thread after ``delay_s`` ->
    join(), which returns the capture's summary: its files, the events
    by category, the CUDA kernels (count, and whether the serving loop's
    gemv, direct_copy and paged-gather kernels are among them), and the
    host threads whose operations it holds. The gather is one
    ``index_select`` a tensor, whose CUDA kernel is
    ``vectorized_gather_kernel``; the kernels named for a gather or an
    index are listed."""
    import threading

    out = {}

    def run():
        time.sleep(delay_s)
        t0 = time.perf_counter()
        try:
            res = json.loads(_get(f"{base}/debug/profile?seconds={seconds}"))
        except Exception as e:
            out["error"] = repr(e)
            return
        out["request_s"] = time.perf_counter() - t0
        out["files"] = res["files"]
        events = []
        for f in res["files"]:
            with open(Path(res["dir"]) / f) as fh:
                events += json.load(fh)["traceEvents"]
        cats = collections.Counter(e.get("cat") for e in events)
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        out.update(
            events=len(events), categories=dict(cats.most_common(8)),
            kernels=len(kernels),
            has={"gemv": any("gemv" in k for k in kernels),
                 "direct_copy": any("direct_copy" in k for k in kernels),
                 "paged_gather": any("gather_kernel" in k
                                     for k in kernels)},
            index_kernels=sorted({k[:60] for k in kernels
                                  if "index" in k.lower()
                                  or "gather" in k}),
            cpu_op_threads=len({e.get("tid") for e in events
                                if e.get("cat") == "cpu_op"}),
            top_kernels=collections.Counter(
                k[:50] for k in kernels).most_common(5))
        shutil.rmtree(res["dir"], ignore_errors=True)

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def join():
        t.join(timeout=300)
        return out

    return join


def _telemetry_shed(torch, ops, serve) -> dict:
    """(b) --max-queue TELEMETRY_MAX_QUEUE: a wave of 8 requests, then a
    burst of TELEMETRY_BURST (every third batch), every 429 against the
    estimate its shed carried (recorded with the queue's depth and the
    EWMA at the shed), then /autoscale/hint and a second burst."""
    from tony_tpu_torch.models import serving as S

    _, _, _, _, payloads = _serve_payloads()
    gc.collect()
    torch.cuda.empty_cache()
    app, httpd, url = _serve_app(serve, SHALLOW + [
        "--seed", "21", "--max-queue", str(TELEMETRY_MAX_QUEUE)])
    base = url.rsplit("/", 1)[0]
    srv = app.server
    traces = []
    srv.trace_sink = traces.append
    sheds, submit = [], srv.submit

    def recording_submit(req):
        try:
            return submit(req)
        except S.QueueFullError as e:
            sheds.append(dict(cls=req.priority, depth=len(srv._queue),
                              ewma_s=srv._rate.service_time_s,
                              retry_after_s=e.retry_after_s))
            raise

    srv.submit = recording_submit
    syncs = _checked_dispatch(torch, srv)
    burst = [dict(payloads[i % SERVE_REQUESTS],
                  priority="batch" if i % 3 == 2 else "interactive")
             for i in range(TELEMETRY_BURST)]
    try:
        ops.reset_launch_counts()
        _post_all(url, payloads[:8])            # a service history
        results = _post_many(url, burst)
        n_burst_sheds = len(sheds)
        with app.lock:
            ewma = srv._rate.service_time_s
        _post(base + "/autoscale/hint", {"cooldown_s": TELEMETRY_HINT_S})
        hinted = _post_many(url, [dict(payloads[i], max_new_tokens=16)
                                  for i in range(20)])
        counts = ops.launch_counts()
        health = app.health()
    finally:
        _stop_app(app, httpd)
        del srv._dispatch_block, srv._admit
    if app.loop_failures or not health["healthy"] or any(counts.values()):
        fail(f"telemetry (b): health {health}, launches {counts}")
    if syncs["admission"]:
        fail(f"telemetry (b): {syncs['admission']} synchronisations in "
             "admission")
    engine_429 = [int(r[2]) for r in results if r[0] == 429
                  and "queue full" in str(r[1])]
    tier_429 = [int(r[2]) for r in results if r[0] == 429
                and "admission tiers" in str(r[1])]
    served = [r for r in results if r[0] == 200]
    if len(served) + len(engine_429) + len(tier_429) != TELEMETRY_BURST \
            or not engine_429:
        fail(f"telemetry (b): {len(served)} served, {len(engine_429)} + "
             f"{len(tier_429)} shed of {TELEMETRY_BURST}")
    burst_sheds = sheds[:n_burst_sheds]
    for s in burst_sheds:
        want = int(min(60, max(1, math.ceil(
            s["ewma_s"] * (s["depth"] + 1) / srv.slots))))
        if s["retry_after_s"] != want:
            fail(f"telemetry (b): a shed carried {s['retry_after_s']}, the "
                 f"estimator says {want} for {s}")
    carried = sorted(s["retry_after_s"] for s in burst_sheds)
    if sorted(engine_429) != carried:
        fail(f"telemetry (b): the 429s said {sorted(engine_429)}, the "
             f"sheds carried {carried}")
    by_ewma = collections.defaultdict(list)
    for s in burst_sheds:
        by_ewma[s["ewma_s"]].append((s["depth"], s["retry_after_s"]))
    for rows in by_ewma.values():
        vals = [ra for _, ra in sorted(rows)]
        if vals != sorted(vals):
            fail(f"telemetry (b): Retry-After fell with depth: {rows}")
    hint_429 = [int(r[2]) for r in hinted if r[0] == 429]
    if not hint_429 or min(hint_429) < TELEMETRY_HINT_S - 1:
        fail(f"telemetry (b): after a hint of {TELEMETRY_HINT_S} s the "
             f"429s said {hint_429}")
    svc = sorted(t["spans"][-1][1] - dict(t["spans"])["admitted"]
                 for t in traces if t["attrs"]["finish_reason"] == "length")
    depths = collections.Counter((s["cls"], s["depth"]) for s in burst_sheds)
    return dict(
        served=len(served), shed_queue_full=len(engine_429),
        shed_displaced=len(tier_429),
        retry_after_values=sorted(collections.Counter(engine_429).items()),
        displaced_retry_after=sorted(collections.Counter(tier_429).items()),
        depths={f"{c}@{d}": n for (c, d), n in sorted(depths.items())},
        ewma_service_s=ewma, ewma_at_sheds=sorted(by_ewma),
        measured_service_s_p50=svc[len(svc) // 2],
        measured_service_s_max=svc[-1],
        predicted_drain_s=ewma * (TELEMETRY_MAX_QUEUE + 1) / srv.slots,
        hint_s=TELEMETRY_HINT_S, after_hint=sorted(hint_429),
        admission_syncs=syncs["admission"], launches=counts)


def _post_many(url, payloads) -> list:
    """POST every payload at once -> (status, body, Retry-After) each,
    refusals included."""
    import threading
    import urllib.error
    import urllib.request

    out = [None] * len(payloads)

    def post(i):
        try:
            with urllib.request.urlopen(
                    url, data=json.dumps(payloads[i]).encode(),
                    timeout=600) as r:
                out[i] = (r.status, json.loads(r.read()), None)
        except urllib.error.HTTPError as e:
            out[i] = (e.code, json.loads(e.read()),
                      e.headers.get("Retry-After"))

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return out


def _telemetry_paged(torch, ops, serve) -> dict:
    """(c) serve --paged-kv on run A's requests: the pool's families on
    /metrics against /stats' paged_kv, the exposition checked."""
    _, _, _, _, payloads = _serve_payloads()
    gc.collect()
    torch.cuda.empty_cache()
    trace_dir = REPO / "build" / "telemetry_paged_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    app, httpd, url = _serve_app(serve, SHALLOW + [
        "--seed", "21", "--paged-kv", "--trace-dir", str(trace_dir)])
    base = url.rsplit("/", 1)[0]
    srv = app.server
    syncs = _checked_dispatch(torch, srv)
    try:
        ops.reset_launch_counts()
        stop = _scraper(base, TELEMETRY_SCRAPE_S)
        profile = _capture_profile(base, TELEMETRY_PROFILE_AT_S,
                                   TELEMETRY_PROFILE_S)
        t0 = time.perf_counter()
        _post_all(url, payloads)
        wall = time.perf_counter() - t0
        scrapes = stop()
        capture = profile()
        drained = srv.dispatch_tracker.drain(timeout=60)
        samples, stats = _scrape_pair(base)
        counts = ops.launch_counts()
    finally:
        _stop_app(app, httpd)
        del srv._dispatch_block, srv._admit
        shutil.rmtree(trace_dir, ignore_errors=True)
    device = _device_time_checks("telemetry (c)", stats, samples, drained)
    if "error" in capture or not capture.get("events"):
        fail(f"telemetry (c): /debug/profile capture {capture}")
    pk = stats["paged_kv"]
    pairs = {f"serving_kv_pool_blocks_{k}": pk[f"pool_blocks_{k}"]
             for k in ("total", "free", "used", "peak")}
    pairs.update({f'serving_kv_pool_blocks{{state="{s}"}}': n
                  for s, n in pk["pool_state"].items()})
    pairs["serving_kv_admission_defers_total"] = pk["admission_defers"]
    wrong = {k: (samples.get(k), v) for k, v in pairs.items()
             if samples.get(k) != v}
    if wrong or scrapes["errors"] or any(counts.values()) \
            or syncs["admission"]:
        fail(f"telemetry (c): /metrics against paged_kv {wrong}, scrape "
             f"errors {scrapes['errors'][:3]}, launches {counts}, "
             f"{syncs['admission']} admission syncs")
    return dict(wall_s=wall, scrapes=scrapes["n"],
                pool_blocks_peak=pk["pool_blocks_peak"],
                pool_blocks_total=pk["pool_blocks_total"],
                admission_syncs=syncs["admission"], device=device,
                profile=capture, launches=counts)


def phase_telemetry(torch, ops, run_a, base_block) -> dict:
    """Serving telemetry through serve's app at the flagship width
    (SERVE_CUT_LAYERS layers) with its defaults, bf16: (a) run A scraped
    every TELEMETRY_SCRAPE_S, /metrics against /stats and the trace file,
    a block's host dispatch beside the serving phase's and its device time
    against ``base_block``'s (no --trace-dir, the same depth), no
    synchronisation in dispatch or
    admission; (b) --max-queue 8 under a burst: every 429's Retry-After
    the estimator's, never falling with the queue's depth, then the
    autoscale hint; (c) --paged-kv: the pool's families; (d) a restart on
    the same --trace-dir resumes the histograms. Returns the kernels'
    launches (none)."""
    print("== main path: telemetry")
    from tony_tpu_torch.cli import serve
    from tony_tpu_torch.models import serving as S

    t0 = time.perf_counter()
    trace_dir = REPO / "build" / "telemetry_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    ops.reset_launch_counts()
    a = _telemetry_run_a(torch, ops, S, serve, run_a, base_block,
                         trace_dir)
    shutil.rmtree(trace_dir, ignore_errors=True)
    b = _telemetry_shed(torch, ops, serve)
    c = _telemetry_paged(torch, ops, serve)
    reaper = _reaper_host_cost(torch)
    counts = {k: a["launches"][k] + b["launches"][k] + c["launches"][k]
              for k in a["launches"]}
    seconds = time.perf_counter() - t0
    print(f"telemetry (a, bf16, {SERVE_CUT_LAYERS} layers, serve's "
          f"defaults, --trace-dir): run A's "
          f"{SERVE_REQUESTS} requests with /metrics scraped every "
          f"{TELEMETRY_SCRAPE_S} s: {a['scrapes']} scrapes, each through "
          f"the exposition check (p50 {a['scrape_ms_p50']:.2f} ms, max "
          f"{a['scrape_ms_max']:.2f} ms); {a['output_tokens_per_s']:.1f} "
          f"output tokens/s (the serving phase at {N_LAYERS} layers "
          f"{run_a['output_tokens_per_s']:.1f}); gauges equal /stats, TTFT "
          f"count {SERVE_REQUESTS}, {a['trace_records']} trace records with "
          f"one terminal each; TTFT p50 {a['ttft_s']['p50_s']} s, p99 "
          f"{a['ttft_s']['p99_s']} s; TPOT p50 {a['tpot_s']['p50_s']} s; "
          f"a block's host dispatch {a['block_dispatch_ms_p50']:.2f} ms "
          f"(without the scrapes in turn "
          f"{a['block_dispatch_ms_unscraped']:.2f}, at "
          f"{a['output_tokens_per_s_unscraped']:.1f} tokens/s; the serving "
          f"phase's at {N_LAYERS} layers {a['block_dispatch_ms_serving']:.2f}"
          f"); device {a['block_device_ms']} ms (a block without "
          f"--trace-dir at {SERVE_CUT_LAYERS} layers "
          f"{a['block_device_ms_baseline']}); synchronisations 0 in dispatch"
          f", {a['admission_syncs']} in admission")
    print(f"telemetry (b, --max-queue {TELEMETRY_MAX_QUEUE}, a burst of "
          f"{TELEMETRY_BURST}): {b['served']} served, {b['shed_queue_full']} "
          f"shed at the door with Retry-After {b['retry_after_values']} "
          f"(value, count), {b['shed_displaced']} batch displaced "
          f"{b['displaced_retry_after']}; depths at the shed "
          f"{b['depths']}; EWMA service {b['ewma_service_s']:.3f} s, "
          f"measured p50 {b['measured_service_s_p50']:.3f} s (max "
          f"{b['measured_service_s_max']:.3f}), predicted drain of a full "
          f"queue {b['predicted_drain_s']:.3f} s; after a hint of "
          f"{TELEMETRY_HINT_S} s the 429s said {b['after_hint']}")
    print(f"telemetry (c, --paged-kv): run A in {c['wall_s']:.3f} s, "
          f"{c['scrapes']} scrapes; the pool's families equal /stats' "
          f"paged_kv (peak {c['pool_blocks_peak']} of "
          f"{c['pool_blocks_total']} blocks); (d) a restart resumed "
          f"{a['resumed_e2e_count']} e2e observations; the phase "
          f"{seconds:.1f} s; {nvidia_smi_line()}")
    for name, rec in (("a", a), ("c, --paged-kv", c)):
        dev = rec["device"]
        print(f"telemetry ({name}) device time: {dev['tracked']} dispatches "
              f"tracked, by kind {dev['by_kind']} (each the engine's own "
              "count), 0 dropped, 0 reap errors, 0 in flight after the "
              f"drain; device lag p50 {dev['device_lag_s'].get('p50_s')} s"
              f", p99 {dev['device_lag_s'].get('p99_s')} s over "
              f"{dev['device_lag_s']['count']} blocks; dispatch -> ready "
              f"p50/p99 by kind {dev['dispatch_ready']}")
    print(f"telemetry (a) a decode block's dispatch -> ready p50 "
          f"{a['device']['dispatch_ready']['decode_block']['p50_s']} s "
          f"beside its device time {a['block_device_ms']} ms (CUDA "
          f"events under torch.profiler) and host dispatch "
          f"{a['block_dispatch_ms_p50']:.2f} ms")
    cap = c["profile"]
    print(f"telemetry (c) /debug/profile?seconds={TELEMETRY_PROFILE_S} "
          f"during run A: {cap['files']} in {cap['request_s']:.2f} s, "
          f"{cap['events']} events {cap['categories']}, {cap['kernels']} "
          f"CUDA kernel events, the serving loop's kernels {cap['has']} "
          f"(index kernels {cap['index_kernels']}), host operations from "
          f"{cap['cpu_op_threads']} thread(s); top {cap['top_kernels']}")
    print("telemetry " + json.dumps(dict(
        run_a=a, shed=b, paged=c, reaper=reaper, seconds=seconds,
        launches=counts, card=nvidia_smi_line())))
    return counts


def _disagg_prompts() -> list:
    """The disaggregated (a) cell's DISAGG_F32 prompts of 64-512 tokens."""
    import numpy as np

    rng = np.random.default_rng(71)
    return [rng.integers(0, 32768, int(n)).tolist()
            for n in rng.integers(64, 513, DISAGG_F32)]


def _kv_heads_roundtrip(torch, S) -> list:
    """The mesh handoff's assembly and split on the card: a one-device
    pool (the flagship's 8 kv heads, 2 layers, 6 blocks of PAGED_KV_BLOCK
    rows, bf16 and int8 with its scales) sliced along its heads as t = 2
    and 4 tensor ranks hold it; each slice's snapshot of the same blocks,
    joined, is the pool's own payload byte for byte, and the join splits
    back into each slice."""
    gen = torch.Generator(device="cuda").manual_seed(73)
    shape = (2, 6, 8, PAGED_KV_BLOCK, 128)
    ids = [4, 0, 5]
    rows = []
    for kind in ("bfloat16", "int8"):
        if kind == "int8":
            bufs = [torch.randint(-127, 128, shape, generator=gen,
                                  device="cuda", dtype=torch.int8)
                    for _ in range(2)]
            bufs += [torch.rand(shape[:4], generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(2)]
        else:
            bufs = [torch.randn(shape, generator=gen, device="cuda",
                                dtype=torch.bfloat16) for _ in range(2)]
        pool = S._with_tensors(S.PrefixPool(k=bufs[0], v=bufs[1]), bufs)
        meta = dict(model="default", kv_block=PAGED_KV_BLOCK,
                    kv_dtype="int8" if kind == "int8" else "native",
                    body_len=3 * PAGED_KV_BLOCK - 1, entry={})
        whole = S._payload(S._snapshot_kv_blocks(pool, ids).wait(), **meta)
        for t in (2, 4):
            parts = [S._snapshot_kv_blocks(S._with_tensors(
                pool, S.split_kv_heads(bufs, r, t)), ids).wait()
                for r in range(t)]
            joined = S.join_kv_heads(parts)
            equal = S._payload(joined, **meta) == whole
            back = all(torch.equal(a, b) for r in range(t) for a, b in
                       zip(S.split_kv_heads(joined, r, t), parts[r]))
            if not (equal and back):
                fail(f"disagg: the kv heads' join at t={t} ({kind}) gives "
                     f"the one-device payload: {equal}; the split gives "
                     f"back each slice: {back}")
            rows.append(dict(kind=kind, t=t, payload_equal=equal,
                             split_back=back))
    return rows


def _disagg_identity(torch, G, T, S) -> list:
    """(a): the flagship widths at 2 layers, float32, DISAGG_F32 requests
    through a prefill replica (one slot on a pool of one request's
    blocks, so each prefill reuses the blocks the one before freed; then
    every pool block is overwritten before any payload is encoded: the
    export-overwrite check) and a decode replica (3 slots), against a
    solo paged engine (3 slots): token-identical up to the solo's first
    near-tie with native KV; with int8 KV how many are equal is reported
    (the carve-out). Every decode block's dispatch runs under sync debug
    mode "error"."""
    import numpy as np

    dev = torch.device("cuda")
    prompts = _disagg_prompts()
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    w = G.prepare_decode(T.init(cfg, torch.Generator(device=dev)
                                .manual_seed(71), dev), cfg)
    need = max(-(-(len(p) - 1 + DISAGG_NEW) // PAGED_KV_BLOCK)
               for p in prompts)
    rows = []
    for kv in ("native", "int8"):
        name = f"disagg (a, float32, {kv})"
        kw = dict(paged=True, kv_block=PAGED_KV_BLOCK, kv_dtype=kv,
                  max_len=2048)

        def requests():
            return [S.Request(prompt=p, max_new_tokens=DISAGG_NEW,
                              logprobs=2) for p in prompts]

        solo = S.SlotServer(w, cfg, slots=3, **kw)
        reqs = requests()
        for r in reqs:
            solo.submit(r)
        done = solo.run_until_drained()
        want = [done[r.id] for r in reqs]
        solo.shutdown()
        pre = S.SlotServer(w, cfg, slots=1, role="prefill",
                           kv_pool_blocks=need, **kw)
        pre_syncs = _checked_dispatch(torch, pre)
        reqs = requests()
        for r in reqs:
            pre.submit(r)
        done = pre.run_until_drained()
        if any(done[r.id].finish_reason != "prefilled" or done[r.id].tokens
               for r in reqs):
            fail(f"{name}: a prefill-role request did not end prefilled")
        pool = pre._kv_pool
        for t in (pool.k, pool.v, pool.k_scale, pool.v_scale):
            if t is not None:
                t.fill_(7)      # stream-ordered after every snapshot
        payloads = [pre.export_blocks(r.id) for r in reqs]
        pre._allocator.check()
        exports = pre.kv_exports
        pre.shutdown()
        del pre, pool
        dec = S.SlotServer(w, cfg, slots=3, role="decode", **kw)
        dec_syncs = _checked_dispatch(torch, dec)
        got = []
        for i in range(0, len(payloads), 3):
            rids = [dec.import_blocks(pl) for pl in payloads[i:i + 3]]
            done = dec.run_until_drained()
            got += [done[r] for r in rids]
        dec._allocator.check()
        imports = dec.kv_imports
        dec.shutdown()
        del dec
        row = dict(kv=kv, equal=sum(a.tokens == b.tokens
                                    for a, b in zip(want, got)),
                   exports=exports, imports=imports,
                   admission_syncs=pre_syncs["admission"]
                   + dec_syncs["admission"],
                   payload_bytes=sum(len(json.dumps(pl)) for pl in payloads))
        if kv == "native":
            for i, (a, b) in enumerate(zip(want, got)):
                gaps = [e["top"][1][0] - e["top"][1][1] for e in a.logprobs]
                _near_tie_check(f"{name} request {i}", b.tokens, a.tokens,
                                gaps, DISAGG_NEW)
        row["parted"] = [_parting(i, a, b) for i, (a, b)
                         in enumerate(zip(want, got)) if a.tokens != b.tokens]
        if exports != imports or exports != DISAGG_F32 or any(
                len(b.tokens) != DISAGG_NEW for b in got):
            fail(f"{name}: {row}")
        rows.append(row)
    del w
    torch.cuda.empty_cache()
    return rows


def _disagg_http(torch, ops, serve) -> dict:
    """(b): run A's first DISAGG_HTTP prompts, DISAGG_NEW greedy new
    tokens, at the flagship width, one request at a time: through serve
    --paged-kv (--role both) first, then POST /generate on --role prefill
    and its "handoff" verbatim to /kv/import on --role decode, every
    other one ?stream=true. One at a time, so each request's transfer is
    timed alone: the clients and both apps share this process, and a
    payload of tens of MB is JSON that holds the interpreter lock while it
    is encoded and parsed. Every decode block's dispatch under sync debug
    mode "error"; the export (encoding), the decode and verify before the
    lock and the install under it timed; then a torn payload (400) and a
    decode pool filled by DISAGG_FULL imports (429)."""
    _, _, _, _, payloads = _serve_payloads()
    bodies = [dict(prompt=pl["prompt"], max_new_tokens=DISAGG_NEW,
                   timeout_s=600.0) for pl in payloads[:DISAGG_HTTP]]
    ops.reset_launch_counts()

    def ttfts(comps):
        return sorted(c.trace["spans"][[n for n, _ in c.trace["spans"]]
                                       .index("first_token")][1]
                      - c.trace["spans"][0][1] for c in comps.values()
                      if c.trace and c.tokens)

    gc.collect()
    torch.cuda.empty_cache()
    app, httpd, url = _serve_app(serve, SHALLOW + ["--seed", "21",
                                                   "--paged-kv"])
    both_comps = _record_completions(app.server)
    both_syncs = _checked_dispatch(torch, app.server)
    try:
        t0 = time.perf_counter()
        solo = [_post(url, body) for body in bodies]
        solo_wall = time.perf_counter() - t0
    finally:
        _stop_app(app, httpd)
    solo_ttft = ttfts(both_comps)
    del app, httpd

    gc.collect()
    torch.cuda.empty_cache()
    pre_app, pre_httpd, pre_url = _serve_app(serve, SHALLOW + [
        "--seed", "21", "--paged-kv", "--role", "prefill"])
    dec_app, dec_httpd, dec_url = _serve_app(serve, SHALLOW + [
        "--seed", "21", "--paged-kv", "--role", "decode", "--kv-pool-blocks",
        str(DISAGG_DECODE_BLOCKS)])
    dec_base = dec_url.rsplit("/", 1)[0]
    pre_srv, dec_srv = pre_app.server, dec_app.server
    pre_syncs = _checked_dispatch(torch, pre_srv)
    dec_syncs = _checked_dispatch(torch, dec_srv)
    dec_comps = _record_completions(dec_srv)
    timed = {"export_ms": [], "prepare_ms": [], "install_ms": []}

    def timing(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                timed[key].append((time.perf_counter() - t0) * 1e3)
        return run

    install = dec_srv.import_blocks
    pre_srv.export_blocks = timing(pre_srv.export_blocks, "export_ms")
    dec_srv.prepare_import = timing(dec_srv.prepare_import, "prepare_ms")
    dec_srv.import_blocks = timing(install, "install_ms")
    legs = [None] * len(bodies)

    def two_legs(i):
        status, body, leg1_s = _post(pre_url, bodies[i])
        if status != 200 or body.get("finish_reason") != "prefilled" \
                or body.get("tokens") or "handoff" not in body:
            legs[i] = dict(error=f"leg 1: {status} {str(body)[:200]}")
            return
        handoff = body["handoff"]
        rec = dict(leg1_s=leg1_s, payload_bytes=len(json.dumps(handoff)),
                   kv_bytes=3 * len(handoff["blocks_k"]) // 2)
        if i % 2:
            res = _sse(dec_base + "/kv/import?stream=true", handoff)
            data = [f for _, f, _ in res["frames"]]
            rec.update(status=res["status"], streamed=True,
                       tokens=[t for f in data[:-1] for t in f["tokens"]],
                       finish=data[-1].get("finish_reason") if data else None,
                       first_frame_s=res["frames"][0][2]
                       if res["frames"] else None)
        else:
            status, body, leg2_s = _post(dec_base + "/kv/import", handoff)
            rec.update(status=status, streamed=False, leg2_s=leg2_s,
                       tokens=body.get("tokens"),
                       finish=body.get("finish_reason"))
        legs[i] = rec

    try:
        t0 = time.perf_counter()
        for i in range(len(bodies)):
            two_legs(i)
        wall = time.perf_counter() - t0
        bad = [(i, r) for i, r in enumerate(legs) if r is None or "error"
               in r or r["status"] != 200 or r["finish"] != "length"
               or len(r["tokens"]) != DISAGG_NEW]
        if bad:
            fail(f"disagg (b): requests failed: {str(bad)[:600]}")
        # a torn payload: 400, counted, the pool untouched
        import numpy as np

        long_prompt = np.random.default_rng(72).integers(
            0, 32768, 1536).tolist()
        status, body, _ = _post(pre_url, dict(
            prompt=long_prompt, max_new_tokens=DISAGG_FULL_NEW))
        full = body["handoff"]
        free0 = dec_srv.stats()["paged_kv"]["pool_blocks_free"]
        torn = dict(full, blocks_k=full["blocks_k"][:-24])
        torn_status = _post(dec_base + "/kv/import", torn)[0]
        free_torn = dec_srv.stats()["paged_kv"]["pool_blocks_free"]
        # the decode pool filled: DISAGG_FULL imports of the long prompt
        # under the lock, then one more over HTTP
        held = []
        with dec_app.lock:
            for _ in range(DISAGG_FULL):
                held.append(install(dec_srv.prepare_import(full)))
        free_full = dec_srv.stats()["paged_kv"]["pool_blocks_free"]
        full_status, full_body, _ = _post(dec_base + "/kv/import", full)
        for rid in held:
            dec_app.cancel(rid)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with dec_app.lock:
                if dec_srv.idle:
                    break
            time.sleep(0.05)
        drained = dec_srv.dispatch_tracker.drain(timeout=60)
        pre_samples, pre_stats = _scrape_pair(pre_url.rsplit("/", 1)[0])
        dec_samples, dec_stats = _scrape_pair(dec_base)
    finally:
        _stop_app(pre_app, pre_httpd)
        _stop_app(dec_app, dec_httpd)
    counts = ops.launch_counts()
    lag = _device_time_checks("disagg (b, decode)", dec_stats, dec_samples,
                              drained)
    pk_pre, pk_dec = pre_stats["paged_kv"], dec_stats["paged_kv"]
    wrong = {}
    for pk, smp in ((pk_pre, pre_samples), (pk_dec, dec_samples)):
        for key in ("kv_exports", "kv_imports", "kv_import_rejects"):
            if smp.get(f"serving_{key}_total") != pk[key]:
                wrong[key] = (smp.get(f"serving_{key}_total"), pk[key])
    n = len(bodies)
    if torn_status != 400 or full_status != 429 or wrong \
            or pk_pre["kv_exports"] != n + 1 \
            or pk_dec["kv_imports"] != n + DISAGG_FULL \
            or pk_dec["kv_import_rejects"] != 1 or free_torn != free0 \
            or any(counts.values()) or dec_syncs["admission"] \
            or pk_dec["pool_blocks_free"] != DISAGG_DECODE_BLOCKS:
        fail(f"disagg (b): torn {torn_status}, full pool {full_status} "
             f"{str(full_body)[:200]}, /metrics against /stats {wrong}, "
             f"{pk_pre['kv_exports']} exports, {pk_dec['kv_imports']} "
             f"imports, {pk_dec['kv_import_rejects']} rejects, pool free "
             f"{pk_dec['pool_blocks_free']}, launches {counts}, decode "
             f"admission syncs {dec_syncs['admission']}")
    if any(status != 200 for status, _, _ in solo):
        fail(f"disagg (b): --role both answered {[x[0] for x in solo]}")
    solo_tokens = [body["tokens"] for _, body, _ in solo]
    equal = sum(r["tokens"] == t for r, t in zip(legs, solo_tokens))
    parted = [next(j for j, (x, y) in enumerate(zip(r["tokens"], t))
                   if x != y)
              for r, t in zip(legs, solo_tokens) if r["tokens"] != t]
    leg2_ttft = ttfts({k: v for k, v in dec_comps.items() if k not in held})
    return dict(
        requests=n, equal_solo=equal, parted_at=parted, wall_s=wall,
        solo_wall_s=solo_wall,
        payload_mb=[round(r["payload_bytes"] / 1e6, 3) for r in legs],
        kv_mb=[round(r["kv_bytes"] / 1e6, 3) for r in legs],
        export_ms=timed["export_ms"][:n], prepare_ms=timed["prepare_ms"][:n],
        install_ms=timed["install_ms"][:n],
        leg1_s=[r["leg1_s"] for r in legs],
        leg2_ttft_s=leg2_ttft, solo_ttft_s=solo_ttft,
        first_frame_s=[r["first_frame_s"] for r in legs if r["streamed"]],
        torn_status=torn_status, full_status=full_status,
        full_pool_free=free_full, full_error=str(full_body)[:120],
        counters=dict(exports=pk_pre["kv_exports"],
                      imports=pk_dec["kv_imports"],
                      rejects=pk_dec["kv_import_rejects"]),
        admission_syncs=dict(both=both_syncs["admission"],
                             prefill=pre_syncs["admission"],
                             decode=dec_syncs["admission"]),
        device=lag, launches=counts)


def phase_disagg(torch, ops) -> dict:
    """Disaggregated prefill/decode serving: (a) at float32, a prefill
    replica's exports decode on a decode replica token-identical to a
    solo paged engine, and payloads survive the overwrite of their
    blocks; (b) at the flagship width through serve's apps, the two legs
    over HTTP beside --role both. Returns the kernels' launches (none:
    the serving path runs no kernel)."""
    print("== main path: disaggregated serving")
    from tony_tpu_torch.cli import serve
    from tony_tpu_torch.models import generate as G
    from tony_tpu_torch.models import serving as S
    from tony_tpu_torch.models import transformer as T

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    rows = _disagg_identity(torch, G, T, S)
    counts_a = ops.launch_counts()
    heads = _kv_heads_roundtrip(torch, S)
    print(f"disagg (a): a one-device pool's slices along its 8 kv heads as "
          f"tensor ranks hold them (t = 2 and 4, bf16 and int8 with its "
          f"scales) join into its own payload byte for byte and split back "
          f"into each slice: {len(heads)} of {len(heads)} cases")
    b = _disagg_http(torch, ops, serve)
    seconds = time.perf_counter() - t0
    for r in rows:
        print(f"disagg (a, float32, 2 layers, {r['kv']} KV, {DISAGG_F32} "
              f"requests of 64-512 tokens, {DISAGG_NEW} new): prefill "
              f"replica -> decode replica, every payload encoded after its "
              f"blocks were reused and overwritten: {r['equal']}/"
              f"{DISAGG_F32} token-identical to a solo paged engine"
              + (" (up to its first near-tie, required)"
                 if r["kv"] == "native" else " (reported)")
              + f", parted at {r['parted']}; {r['exports']} exports, "
              f"{r['imports']} imports, {r['payload_bytes']} payload bytes; "
              f"0 syncs in dispatch, {r['admission_syncs']} in admission")

    def q(xs):
        return (f"p50 {_quantiles(xs)['p50']:.3f} max "
                f"{_quantiles(xs)['max']:.3f}") if xs else "n/a"

    print(f"disagg (b, bf16, flagship, run A's first {b['requests']} "
          f"prompts, {DISAGG_NEW} greedy new, one at a time): two legs over "
          f"HTTP in {b['wall_s']:.3f} s (--role both in turn "
          f"{b['solo_wall_s']:.3f} s); {b['equal_solo']}/{b['requests']} "
          f"token-identical to --role both (bf16, reported; the others part "
          f"at tokens {b['parted_at']}); payload MB {b['payload_mb']} (KV "
          f"{b['kv_mb']}); export (encode) ms {q(b['export_ms'])}; import: "
          f"decode and verify before the lock ms {q(b['prepare_ms'])}, "
          f"install under the serving lock ms {q(b['install_ms'])}; leg 1 "
          f"(/generate to the handoff) s {q(b['leg1_s'])}; leg 2 TTFT "
          f"(import to first token) s {q(b['leg2_ttft_s'])}, streamed "
          f"first frames s {q(b['first_frame_s'])}; --role both TTFT s "
          f"{q(b['solo_ttft_s'])}")
    print(f"disagg (b): a torn payload answered {b['torn_status']}; "
          f"{DISAGG_FULL} imports of a 1536-token prompt with "
          f"{DISAGG_FULL_NEW} new left {b['full_pool_free']} of "
          f"{DISAGG_DECODE_BLOCKS} blocks and the next answered "
          f"{b['full_status']} ({b['full_error']}); counters on /stats and "
          f"/metrics alike {b['counters']}; the decode replica's tracker "
          f"{b['device']['by_kind']}, device lag p50 "
          f"{b['device']['device_lag_s'].get('p50_s')} s; synchronisations "
          f"0 in dispatch, in admission {b['admission_syncs']}; the phase "
          f"{seconds:.1f} s; {nvidia_smi_line()}")
    counts = {k: counts_a[k] + b["launches"][k] for k in counts_a}
    print("disagg " + json.dumps(dict(identity=rows, http=b, heads=heads,
                                      seconds=seconds, launches=counts,
                                      card=nvidia_smi_line())))
    return counts


def _solo_greedy(torch, G, w, cfg, prompt, n, server_order=False):
    """The port's greedy generation of n tokens for one prompt, its
    prefill and decode steps on the kernels, with each step's top-2 logit
    gap (``_greedy_rows`` of one row)."""
    toks, gaps = _greedy_rows(torch, G, w, cfg, torch.tensor(
        [prompt], device="cuda"), n, server_order)
    return toks[0], gaps[0]


def _write_hf_checkpoint(torch, path: Path) -> int:
    """HF_CONFIG at HF_LAYERS layers in HF's layout: config.json, two
    safetensors shards (the embedding and the first half of the layers;
    the rest, the final norm and lm_head) and their index; random bf16
    weights (standard deviation 0.02, norms 1) drawn on the card from a
    seeded generator. -> the bytes of weights written."""
    cfg = dict(HF_CONFIG, num_hidden_layers=HF_LAYERS)
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    kv = cfg["num_key_value_heads"] * d // cfg["num_attention_heads"]
    shapes = {"model.embed_tokens.weight": (v, d)}
    for i in range(HF_LAYERS):
        pre = f"model.layers.{i}."
        shapes.update({
            pre + "input_layernorm.weight": (d,),
            pre + "self_attn.q_proj.weight": (d, d),
            pre + "self_attn.k_proj.weight": (kv, d),
            pre + "self_attn.v_proj.weight": (kv, d),
            pre + "self_attn.o_proj.weight": (d, d),
            pre + "post_attention_layernorm.weight": (d,),
            pre + "mlp.gate_proj.weight": (f, d),
            pre + "mlp.up_proj.weight": (f, d),
            pre + "mlp.down_proj.weight": (d, f)})
    shapes.update({"model.norm.weight": (d,), "lm_head.weight": (v, d)})
    names = list(shapes)
    half = names.index(f"model.layers.{HF_LAYERS // 2}.input_layernorm.weight")
    shards = {"model-00001-of-00002.safetensors": names[:half],
              "model-00002-of-00002.safetensors": names[half:]}
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(cfg))
    g = torch.Generator(device="cuda").manual_seed(21)
    weight_map, total = {}, 0
    for shard, keys in shards.items():
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for key in keys:
            n = math.prod(shapes[key]) * 2
            header[key] = dict(dtype="BF16", shape=list(shapes[key]),
                               data_offsets=[offset, offset + n])
            weight_map[key] = shard
            offset += n
        blob = json.dumps(header).encode()
        blob += b" " * (-len(blob) % 8)
        with open(path / shard, "wb") as fh:
            fh.write(struct.pack("<Q", len(blob)) + blob)
            for key in keys:
                if key.endswith("norm.weight"):
                    t = torch.ones(shapes[key], device="cuda")
                else:
                    t = torch.randn(shapes[key], device="cuda",
                                    generator=g) * 0.02
                fh.write(t.to(torch.bfloat16).cpu().view(torch.uint8)
                         .numpy())
                del t
        total += offset
    (path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def _spec_solo(torch, ops, G, T, totals) -> dict:
    """(a): solo speculative_generate at the flagship's full width, float32,
    batch 1, against generate: a random draft at lm_generate's default
    draft dims (head_dim 32: its prefill on K1 and its steps on K6 at
    D = 32) and the target as its own draft; host-clock ms a token, spec
    and plain in turns; a bf16 run reported as a count."""
    import numpy as np

    from tony_tpu_torch.models.speculative import speculative_generate

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(71)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=12,
                                  n_heads=8, n_kv_heads=8, d_ff=4096,
                                  dtype=dtype)
        dcfg = T.TransformerConfig(vocab_size=32768, n_kv_heads=4,
                                   dtype=dtype, **SPEC_DRAFT)
        if dtype == torch.float32:
            raw, draw = T.init(cfg, gen, dev), T.init(dcfg, gen, dev)
        w, dw = G.prepare_decode(raw, cfg), G.prepare_decode(draw, dcfg)
        prompt = np.random.default_rng(71).integers(
            0, 32768, SPEC_PROMPT).tolist()
        p = torch.tensor([prompt], device=dev)

        def plain():
            return G.generate(w, cfg, p, SPEC_NEW)[0].tolist(), None

        def spec(draft, draft_cfg):
            def run():
                o, st = speculative_generate(w, cfg, draft, draft_cfg, p,
                                             SPEC_NEW, gamma=SPEC_GAMMA,
                                             return_stats=True)
                return o[0].tolist(), st
            return run

        runs = {"plain": plain, "random_draft": spec(dw, dcfg),
                "self_draft": spec(w, cfg)}
        if dtype == torch.bfloat16:
            # reported: bf16 tokens against bf16 generate, counted
            want = plain()[0]
            got, st = runs["random_draft"]()
            eq = sum(a == b for a, b in zip(got, want))
            out["bf16_random_draft_equal_tokens"] = eq
            print(f"speculative (a) bf16: random draft {eq} of {SPEC_NEW} "
                  f"tokens equal to bf16 generate (reported, not required)")
            break
        want, gaps = _solo_greedy(torch, G, w, cfg, prompt, SPEC_NEW)
        for name, fn in runs.items():     # one warm call each, counted
            ops.reset_launch_counts()
            toks, st = fn()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            for k, n in counts.items():
                totals[k] += n
            row = _near_tie_check(f"speculative (a) {name}", toks, want, gaps,
                                  SPEC_NEW)
            row.update(launches=counts)
            if st is not None:
                d_layers = (dcfg if name == "random_draft" else cfg).n_layers
                want_k = {"flash_fwd": cfg.n_layers + d_layers,
                          "flash_decode": st["rounds"] * (SPEC_GAMMA + 1)
                          * d_layers, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
                if counts != want_k:
                    fail(f"speculative (a) {name}: launches {counts}, "
                         f"expected {want_k}")
                row.update(st, target_forwards=st["rounds"] + 1)
            out[name] = row
        # host-clock ms a token, one timed run each (each ends in a
        # synchronize; the alternated second runs went for the pipeline
        # phase's seconds)
        ms = {k: [] for k in runs}
        for name in ("plain", "random_draft", "self_draft"):
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / SPEC_NEW)
        for name, xs in ms.items():
            out[name]["ms_per_token"] = xs
        r, sd = out["random_draft"], out["self_draft"]
        if r["acceptance_rate"] > 0.3 or sd["acceptance_rate"] < 0.99:
            fail(f"speculative (a): acceptance {r['acceptance_rate']} (random "
                 f"draft), {sd['acceptance_rate']} (self-draft)")
        print(f"speculative (a) float32 B1 prompt {SPEC_PROMPT}, {SPEC_NEW} "
              f"new, gamma {SPEC_GAMMA}: random draft (d{dcfg.d_model} "
              f"{dcfg.n_layers}L {dcfg.n_heads}h, head_dim {dcfg.head_dim}) "
              f"{r['rounds']} rounds, acceptance {r['acceptance_rate']:.3f}, "
              f"{r['target_forwards']} target forwards, launches "
              f"{r['launches']}; self-draft {sd['rounds']} rounds, "
              f"acceptance {sd['acceptance_rate']:.3f}, "
              f"{sd['target_forwards']} target forwards; tokens equal to "
              f"generate up to a near-tie (diverge {r['diverge']}, "
              f"{sd['diverge']}); host ms a token plain "
              + " ".join(f"{x:.2f}" for x in ms["plain"]) + ", random "
              + " ".join(f"{x:.2f}" for x in ms["random_draft"]) + ", self "
              + " ".join(f"{x:.2f}" for x in ms["self_draft"]))
    del w, dw, raw, draw
    torch.cuda.empty_cache()
    return out


def _spec_cli(torch, ops, G, T, lm_train, lm_generate, ckpt, totals) -> dict:
    """(b): lm_train trains a draft for 3 steps at lm_generate's default
    draft dims (head_dim 32: the backward kernels at D = 32); lm_generate
    on the checkpoint phase's directory at float32 with and without
    --draft-checkpoint-dir: the same tokens, up to a near-tie."""
    import numpy as np

    from tony_tpu_torch.train.checkpoint import restore_lm_params

    root = CKPT_ROOT / "spec_cli"
    root.mkdir(parents=True, exist_ok=True)
    ops.reset_launch_counts()
    rc = lm_train.main(["--vocab", "32768"] + SPEC_TRAIN_DRAFT + [
        "--batch-size", "8", "--seq-len", "512", "--steps", "3",
        "--checkpoint-dir", str(root / "draft"), "--checkpoint-every", "3"])
    counts = ops.launch_counts()
    if rc != 0 or counts["flash_fwd"] != 6 or counts["flash_bwd_dq"] != 6:
        fail(f"speculative (b): lm_train of the draft exited {rc}, launches "
             f"{counts}")
    for k, n in counts.items():
        totals[k] += n
    prompt = np.random.default_rng(73).integers(0, 32768, 256).tolist()
    base = FLAGSHIP + ["--dtype", "float32", "--checkpoint-dir", str(ckpt),
                       "--prompt", " ".join(map(str, prompt)),
                       "--max-new", str(SPEC_CLI_NEW)]
    res = {}
    for name, extra in (("plain", []), ("spec", [
            "--draft-checkpoint-dir", str(root / "draft")] + [
                f.replace("--", "--draft-", 1) if f.startswith("--") else f
                for f in SPEC_TRAIN_DRAFT])):
        metrics = root / f"{name}.json"
        ops.reset_launch_counts()
        rc = lm_generate.main(base + extra + ["--metrics-out", str(metrics)])
        counts = ops.launch_counts()
        if rc != 0:
            fail(f"speculative (b): lm_generate ({name}) exited {rc}")
        for k, n in counts.items():
            totals[k] += n
        res[name] = dict(json.loads(metrics.read_text()), launches=counts)
    plain, spec = res["plain"]["tokens"], res["spec"]["tokens"]
    row = dict(equal=spec == plain, diverge=None)
    if spec != plain:
        cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=12,
                                  n_heads=8, n_kv_heads=8, d_ff=4096,
                                  dtype=torch.float32)
        w = G.prepare_decode(restore_lm_params(str(ckpt), T.init(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")), cfg)
        _, gaps = _solo_greedy(torch, G, w, cfg, prompt, SPEC_CLI_NEW)
        row = _near_tie_check("speculative (b) lm_generate", spec, plain,
                              gaps, SPEC_CLI_NEW)
        del w
    st = res["spec"]["speculative"]
    row.update(speculative=st, launches=res["spec"]["launches"],
               plain_tokens_per_s=res["plain"]["decode_tokens_per_sec"],
               spec_tokens_per_s=res["spec"]["decode_tokens_per_sec"])
    print(f"speculative (b): lm_generate --checkpoint-dir float32 with "
          f"--draft-checkpoint-dir (a 3-step lm_train draft, d128 2L 4h, "
          f"head_dim 32): "
          f"tokens equal to the plain run's: {row['equal']}"
          + ("" if row["equal"] else f" (diverge {row['diverge']}, at or "
             "after a near-tie)")
          + f"; {st['rounds']} rounds, acceptance "
          f"{st['acceptance_rate']:.3f}; launches {row['launches']}; "
          f"{row['spec_tokens_per_s']:.1f} against "
          f"{row['plain_tokens_per_s']:.1f} tokens/s")
    shutil.rmtree(root)
    return row


def _spec_serve_run(torch, ops, serve, argv, prompts, passes=1) -> dict:
    """One serve app on ``argv``: a warm-up, then ``prompts`` posted at once
    (``passes`` times), every spec round's dispatch under sync debug mode
    "error" and the admissions' syncs counted -> tokens and stats."""
    app, httpd, url = _serve_app(serve, argv)
    srv = app.server
    try:
        with app.lock:
            syncs = _checked_dispatch(torch, srv)
        warm = _post(url, dict(prompt=list(range(1, 300)), max_new_tokens=8))
        if warm[0] != 200:
            fail(f"spec serving: warm-up answered {warm[0]}: {warm[1]}")
        syncs["admission"] = 0
        ops.reset_launch_counts()
        toks, walls = [], []
        for _ in range(passes):
            t0 = time.perf_counter()
            res = _post_all(url, [dict(prompt=p,
                                       max_new_tokens=SPEC_SERVE_NEW)
                                  for p in prompts])
            walls.append(time.perf_counter() - t0)
            toks.append([r[1]["tokens"] for r in res])
        counts = ops.launch_counts()
        with app.lock:
            st = app._stats_locked()
        health = app.health()
    finally:
        _stop_app(app, httpd)
    if any(counts.values()):
        fail(f"spec serving {argv[-2:]}: kernels launched {counts}")
    if app.loop_failures or not health["healthy"]:
        fail(f"spec serving: the loop failed: {health}")
    if syncs["admission"]:
        fail(f"spec serving: {syncs['admission']} synchronisations in "
             f"admission {dict(syncs['sites'])}")
    return dict(tokens=toks, stats=st, walls=walls)


def _spec_serving(torch, ops, serve, G, T) -> dict:
    """(c): serve at SERVE_CUT_LAYERS, float32, the paged (a) cell's 8
    prompts of 64-512 tokens, 48 new: spec-off, a random draft (--draft-
    model random), a self-draft (--model main=random:7 --model
    twin=random:7 --draft-model twin), and the self-draft on --paged-kv and
    with --prefix-cache-blocks 64 (two passes, the second on the trie):
    each equal to spec-off up to a near-tie."""
    import numpy as np

    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, 32768, int(n)).tolist()
               for n in rng.integers(64, 513, PAGED_ID)]
    base = SHALLOW + ["--dtype", "float32", "--model", "main=random:7"]
    self_draft = base + ["--model", "twin=random:7", "--draft-model", "twin"]
    cells = {"off": (base, 1), "random_draft": (base + ["--draft-model",
                                                        "random"], 1),
             "self_draft": (self_draft, 1),
             "self_draft_paged": (self_draft + ["--paged-kv"], 1),
             "self_draft_prefix": (self_draft + ["--prefix-cache-blocks",
                                                 "64"], 2)}
    runs = {name: _spec_serve_run(torch, ops, serve, argv, prompts, passes)
            for name, (argv, passes) in cells.items()}
    args = serve.build_argparser().parse_args(base)
    params, cfg = serve.load_named_model("random:7", args)
    w = G.prepare_decode(params, cfg)
    gaps = [_solo_greedy(torch, G, w, cfg, p, SPEC_SERVE_NEW)[1]
            for p in prompts]
    del params, w
    off = runs["off"]["tokens"][0]
    out = {}
    for name, run in runs.items():
        spec = run["stats"].get("speculative")
        rows = [_near_tie_check(f"spec serving {name} request {i}", got,
                                off[i], gaps[i], SPEC_SERVE_NEW)
                for toks in run["tokens"] for i, got in enumerate(toks)]
        agree = sum(r["diverge"] is None for r in rows)
        out[name] = dict(agree=agree, of=len(rows), walls_s=run["walls"],
                         speculative=spec)
        if name == "off":
            continue
        ewma = spec["acceptance_ewma"]
        if (name == "random_draft") != (ewma < 0.3) or (
                name != "random_draft" and ewma <= 0.8):
            fail(f"spec serving {name}: acceptance EWMA {ewma}")
        if name == "self_draft_prefix" and \
                not spec["draft_prefill_tokens_reused"]:
            fail("spec serving: the prefix cache reused no draft prefill")
        print(f"spec serving {name}: {agree} of {len(rows)} token-identical "
              f"to spec-off (the others at or after a near-tie); rounds "
              f"{spec['rounds']}, proposed {spec['proposed_tokens']}, "
              f"accepted {spec['accepted_tokens']}, EWMA {ewma}, gamma "
              f"{spec['gamma']}, draft prefill reused "
              f"{spec['draft_prefill_tokens_reused']}; wall "
              + " ".join(f"{x:.2f}" for x in run["walls"]) + " s against "
              f"spec-off {runs['off']['walls'][0]:.2f} s; 0 syncs in "
              "dispatch and admission")
    return out


def _multi_model(torch, ops, serve, G, T, ckpt) -> dict:
    """(d): serve --model a=random:0 --model b=ckpt:<checkpoint phase dir>
    at the checkpoint's depth, float32: 8 requests alternating the models,
    each equal (up to a near-tie) to a single-model serve of its weights;
    an unknown name's 400, /stats' models and /metrics' serving_models and
    model labels."""
    import numpy as np

    rng = np.random.default_rng(77)
    prompts = [rng.integers(0, 32768, int(n)).tolist()
               for n in rng.integers(64, 513, 8)]
    names = ["a" if i % 2 == 0 else "b" for i in range(8)]
    f32 = FLAGSHIP + ["--dtype", "float32"]
    app, httpd, url = _serve_app(serve, f32 + [
        "--model", "a=random:0", "--model", f"b=ckpt:{ckpt}"])
    try:
        ops.reset_launch_counts()
        res = _post_all(url, [dict(prompt=p, max_new_tokens=MULTI_NEW,
                                   model=m) for p, m in zip(prompts, names)])
        ghost = _post(url, dict(prompt=[1, 2, 3], model="ghost"))
        base = url.rsplit("/", 1)[0]
        stats = json.loads(_get(base + "/stats"))
        text = _get(base + "/metrics")
        counts = ops.launch_counts()
    finally:
        _stop_app(app, httpd)
    if any(counts.values()):
        fail(f"multi-model serve: kernels launched {counts}")
    if ghost[0] != 400 or "ghost" not in ghost[1].get("error", ""):
        fail(f"multi-model serve: an unknown model answered {ghost}")
    if set(stats["models"]) != {"a", "b"} or stats["registry"] != ["a", "b"]:
        fail(f"multi-model serve: /stats models {list(stats['models'])}, "
             f"registry {stats['registry']}")
    for needle in ('serving_models{model="a"} 1', 'serving_models{model="b"} 1',
                   'serving_active_slots{model="b"}',
                   'serving_ttft_seconds_bucket{model="a"'):
        if needle not in text:
            fail(f"multi-model serve: /metrics lacks {needle}")
    single = {}
    for m, extra in (("a", ["--model", "a=random:0"]),
                     ("b", ["--checkpoint-dir", str(ckpt)])):
        idx = [i for i, n in enumerate(names) if n == m]
        app, httpd, url = _serve_app(serve, f32 + extra)
        try:
            out = _post_all(url, [dict(prompt=prompts[i],
                                       max_new_tokens=MULTI_NEW)
                                  for i in idx])
        finally:
            _stop_app(app, httpd)
        single.update({i: r[1]["tokens"] for i, r in zip(idx, out)})
    rows = []
    for m, spec in (("a", "random:0"), ("b", f"ckpt:{ckpt}")):
        params, cfg = serve.load_named_model(
            spec, serve.build_argparser().parse_args(f32))
        w = G.prepare_decode(params, cfg)
        for i in (i for i, n in enumerate(names) if n == m):
            _, gaps = _solo_greedy(torch, G, w, cfg, prompts[i], MULTI_NEW)
            rows.append(_near_tie_check(
                f"multi-model request {i} (model {m})", res[i][1]["tokens"],
                single[i], gaps, MULTI_NEW))
        del params, w
    agree = sum(r["diverge"] is None for r in rows)
    print(f"multi-model serve (a=random:0, b=ckpt, {N_LAYERS} layers, "
          f"float32): {agree} of 8 token-identical to a single-model serve "
          f"of their weights (the others at or after a near-tie); unknown "
          f"model 400; /stats models {sorted(stats['models'])}; /metrics "
          f"serving_models and model labels present")
    return dict(agree=agree, rows=rows)


def phase_speculative(torch, ops, lm_train, lm_generate, serve, G, T) -> dict:
    """Speculative decoding and the model registry on the card: (a) solo,
    (b) the lm_generate CLI with an own-trained draft, (c) spec serving,
    (d) multi-model serving. Returns the kernels' launches on the main
    paths ((a)'s three runs, (b)'s training and generation)."""
    print("== main path: speculative decoding and the model registry")
    totals = dict.fromkeys(ops.launch_counts(), 0)
    ckpt = CKPT_ROOT / "b"
    try:
        with torch.no_grad():
            solo = _spec_solo(torch, ops, G, T, totals)
        cli = _spec_cli(torch, ops, G, T, lm_train, lm_generate, ckpt,
                        totals)
        serving = _spec_serving(torch, ops, serve, G, T)
        multi = _multi_model(torch, ops, serve, G, T, ckpt)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()
    print("speculative " + json.dumps(dict(
        solo=solo, cli=cli, serving=serving, multi_model=multi,
        launches=totals, card=nvidia_smi_line())))
    return totals


def _moe_layer_costs(torch, A, E) -> dict:
    """Where an MoE layer's forward time goes at the training step's shape
    (B4 x 1024 tokens, bf16): routing, the dispatch product, the expert
    products (with silu), the combine product and K1, each by CUDA events
    against its operations' time at the bf16 peak -> {piece: row}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(83)
    t, d, f, e = MOE_BATCH * MOE_SEQ, 1024, 4096, MOE_EXPERTS
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf16)

    x, router = randn(t, d), randn(d, e, scale=d ** -0.5)
    w_in, w_out = randn(e, d, f, scale=d ** -0.5), randn(e, f, d,
                                                         scale=f ** -0.5)
    cap = E.capacity_for(t, 2, e, 1.25)
    logits = x.float() @ router.float()
    dispatch, combine = (z.to(bf16) for z in E.top_k_routing(logits, 2, cap))
    xs = torch.einsum("td,tec->ecd", x, dispatch)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xs, w_in))
    ys = torch.einsum("ecf,efd->ecd", h, w_out)
    q, k, v = (randn(MOE_BATCH, MOE_SEQ, 8, 128) for _ in range(3))
    pieces = {
        "routing": (lambda: E.top_k_routing(logits, 2, cap), 0),
        "dispatch": (lambda: torch.einsum("td,tec->ecd", x, dispatch),
                     2 * t * d * e * cap),
        "experts": (lambda: torch.einsum("ecf,efd->ecd", torch.nn.functional
                                         .silu(torch.einsum("ecd,edf->ecf",
                                                            xs, w_in)),
                                         w_out), 4 * e * cap * d * f),
        "combine": (lambda: torch.einsum("ecd,tec->td", ys, combine),
                    2 * t * d * e * cap),
        "moe_ffn": (lambda: E.moe_ffn(x, router, w_in, w_out, k=2,
                                      capacity_factor=1.25,
                                      activation=torch.nn.functional.silu),
                    2 * t * d * e * cap * 2 + 4 * e * cap * d * f),
        "attention_k1": (lambda: A.attention_blhd(q, k, v, causal=True),
                         4 * 128 * visible_pairs(MOE_SEQ, MOE_SEQ, True, None)
                         * MOE_BATCH * 8),
    }
    out = {}
    for name, (fn, flops) in pieces.items():
        ms = cuda_ms(fn, 5)
        out[name] = dict(ms=ms, flops=flops,
                         peak_ms=flops / PEAK_BF16_FLOPS * 1e3)
    print(f"moe layer forward B{MOE_BATCH} x {MOE_SEQ} tokens, {e} experts, "
          f"capacity {cap}: " + ", ".join(
              f"{n} {r['ms']:.3f} ms"
              + (f" ({r['flops'] / r['ms'] / 1e9:.0f} TFLOP/s)" if r["flops"]
                 else "") for n, r in out.items()))
    del x, router, w_in, w_out, logits, dispatch, combine, xs, h, ys, q, k, v
    return out


def _moe_train(torch, ops, lm_train, A, E, T, totals) -> dict:
    """(a): lm_train --n-experts MOE_EXPERTS at the flagship width,
    MOE_TRAIN_LAYERS layers, batch MOE_BATCH x MOE_SEQ, MOE_STEPS steps:
    losses finite, the flash kernels once a layer a step; then one step
    profiled in process (device ms, busy share, peak memory, the top
    kernels) and a layer's forward broken into its pieces."""
    metrics = REPO / "build" / "chip_smoke" / "moe_train.json"
    metrics.parent.mkdir(parents=True, exist_ok=True)
    argv = MOE_FLAGS + ["--n-layers", str(MOE_TRAIN_LAYERS), "--batch-size",
                        str(MOE_BATCH), "--seq-len", str(MOE_SEQ), "--steps",
                        str(MOE_STEPS), "--metrics-out", str(metrics)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rc = lm_train.main(argv)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        fail(f"moe (a): lm_train --n-experts exited {rc}")
    per = MOE_STEPS * MOE_TRAIN_LAYERS
    want = {"flash_fwd": per, "flash_bwd_dkdv": per, "flash_bwd_dq": per,
            "flash_decode": 0}
    if counts != want:
        fail(f"moe (a): launches {counts}, expected {want}")
    for k, n in counts.items():
        totals[k] += n
    m = json.loads(metrics.read_text())
    losses = m["losses"]
    if len(losses) != MOE_STEPS or not all(map(math.isfinite, losses)):
        fail(f"moe (a): losses not all finite: {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024,
                              n_layers=MOE_TRAIN_LAYERS, n_heads=8,
                              n_kv_heads=8, d_ff=4096, n_experts=MOE_EXPERTS,
                              max_seq_len=MOE_SEQ)
    prof = _train_step_profile(torch, cfg, None, MOE_BATCH, MOE_SEQ,
                               name="moe training step")
    gc.collect()
    torch.cuda.empty_cache()
    pieces = _moe_layer_costs(torch, A, E)
    row = dict(layers=MOE_TRAIN_LAYERS, batch=MOE_BATCH, seq=MOE_SEQ,
               steps=MOE_STEPS, losses=losses, n_params=m["n_params"],
               steps_per_sec=m["steps_per_sec"],
               tokens_per_sec=m["tokens_per_sec"], lm_train_peak_gb=peak_gb,
               step=prof, layer_forward=pieces, launches=counts)
    print(f"moe (a) lm_train --n-experts {MOE_EXPERTS}, {MOE_TRAIN_LAYERS} "
          f"layers, {m['n_params'] / 1e6:.1f}M parameters, B{MOE_BATCH} x "
          f"{MOE_SEQ}, {MOE_STEPS} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {m['tokens_per_sec']:.1f} tokens/s over the "
          f"run (first step included), peak {peak_gb:.2f} GB; a step "
          f"{prof['wall_ms']:.2f} ms wall, "
          + ("not measured" if prof["device_ms"] is None
             else f"{prof['device_ms']:.2f}") + " ms on the device; launches "
          f"{counts}")
    return row


def _moe_parity(torch, ops, T, E) -> dict:
    """(b): float32, MOE_EXPERTS experts at full width, 2 layers, batch
    2 x 512: one loss and every gradient on the kernels (K1, K3-K5 float32)
    against the plain path (attn_impl "ref") from the same parameters, and
    each layer's dispatch and combine tensors. The routing must agree
    except where a token's top-3 router probabilities lie within
    MOE_ROUTE_NEAR_TIE (then the gradients are reported, not held)."""
    from tony_tpu_torch.train.step import _leaves

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              n_experts=MOE_EXPERTS, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(81)
    params = T.init(cfg, gen, dev)
    tokens = torch.randint(0, 32768, (2, 512), generator=gen, device=dev)
    targets = torch.randint(0, 32768, (2, 512), generator=gen, device=dev)
    route = E.top_k_routing

    def run(c):
        calls = []

        def recorded(logits, k, cap):
            d, cb = route(logits, k, cap)
            calls.append((logits.detach(), d.detach(), cb.detach()))
            return d, cb

        E.top_k_routing = recorded
        try:
            p = _leaf_copies(torch, params, dev)
            names, leaves = zip(*_leaves(p))
            loss = T.loss_fn(p, tokens, targets, c)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            E.top_k_routing = route
        return float(loss.detach()), names, grads, calls

    before = _kernel_launch_total(torch)
    k_loss, names, k_grads, k_calls = run(cfg)
    if _kernel_launch_total(torch) - before != 3 * cfg.n_layers:
        fail("moe (b): the kernel path did not run the flash kernels")
    p_loss, _, p_grads, p_calls = run(dataclasses.replace(cfg,
                                                          attn_impl="ref"))
    flips, combine_err = 0, 0.0
    for layer, ((lk, dk, ck), (_, dp, cp)) in enumerate(zip(k_calls,
                                                            p_calls)):
        if torch.equal(dk, dp):
            combine_err = max(combine_err, compare(
                f"moe (b) layer {layer} combine", ck, cp, (1e-6, 1e-5)))
            continue
        probs = torch.softmax(lk, dim=-1).sort(dim=-1, descending=True).values
        gap = (probs[:, :2] - probs[:, 1:3]).min(dim=-1).values
        differ = (dk != dp).any(dim=(1, 2)) | (ck != cp).any(dim=(1, 2))
        # a token routed elsewhere moves the later claims on its experts;
        # the first token that differs must sit at a near-tie
        first = int(differ.nonzero()[0])
        if float(gap[first]) >= MOE_ROUTE_NEAR_TIE:
            fail(f"moe (b) layer {layer}: dispatch differs at token {first}, "
                 f"whose top-3 gap is {float(gap[first]):.3g}")
        flips += 1
    g_err = {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
             for n, a, b in zip(names, k_grads, p_grads)}
    worst = max(g_err.values())
    row = dict(loss_kernels=k_loss, loss_plain=p_loss,
               loss_diff=abs(k_loss - p_loss), grad_rel_err=g_err,
               worst_grad_rel_err=worst, dispatch_equal_layers=(
                   cfg.n_layers - flips), combine_max_err=combine_err)
    print(f"moe (b) float32, 2 layers, B2 x 512: loss kernels {k_loss:.6f} "
          f"plain {p_loss:.6f}; worst gradient relative norm error "
          f"{worst:.3g} ({max(g_err, key=g_err.get)}); dispatch equal in "
          f"{cfg.n_layers - flips} of {cfg.n_layers} layers, combine max "
          f"|diff| {combine_err:.3g}")
    if not all(map(math.isfinite, g_err.values())):
        fail("moe (b): non-finite gradients")
    if not flips and (abs(k_loss - p_loss) > MOE_PARITY_LOSS_ATOL
                      or worst > MOE_PARITY_GRAD_RTOL):
        fail("moe (b): the kernel path's loss or gradients differ from the "
             "plain path's")
    del params, k_grads, p_grads, k_calls, p_calls
    return row


def _greedy_rows(torch, G, w, cfg, prompt, n, server_order=False) -> tuple:
    """Greedy decoding of a [B, L] prompt on ``cfg`` as given (no
    moe_dropfree of its own) -> (tokens [B][n], top-2 logit gaps [B][n]).
    ``server_order``: as the serving engines run it, the prompt but its
    last token prefilled on the cast weights, the last token fed to the
    first decode step (on the fused, int8, weights)."""
    cache = G.init_cache(cfg, prompt.shape[0], prompt.shape[1] + n,
                         device=prompt.device)
    if server_order:
        _, cache = G._forward_with_cache(w.params, cfg, prompt[:, :-1], cache,
                                         None, prefill=True)
        logits, cache = G._forward_with_cache(w.params, cfg, prompt[:, -1:],
                                              cache, w.fused)
    else:
        logits, cache = G._forward_with_cache(w.params, cfg, prompt, cache,
                                              w.fused, prefill=True)
    toks, gaps = [], []
    for step in range(n):
        top2 = logits.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).tolist())
        tok = logits.argmax(-1)
        toks.append(tok.tolist())
        if step < n - 1:
            logits, cache = G._forward_with_cache(w.params, cfg, tok[:, None],
                                                  cache, w.fused)
    return [list(r) for r in zip(*toks)], [list(r) for r in zip(*gaps)]


def _moe_generate(torch, ops, lm_generate, G, T, totals) -> dict:
    """(c): lm_generate --n-experts MOE_EXPERTS at MOE_GEN_LAYERS layers,
    random weights, B8 x prompt 1024 + 64 new, native and --weight-dtype
    int8 (their launches
    checked); the prefill's and a decode step's device time, native
    against int8; then at MOE_GEN_F32_LAYERS layers in float32 generate on
    the kernels against the plain path's greedy tokens, under the near-tie
    rule."""
    out_dir = REPO / "build" / "chip_smoke"
    runs = {}
    for wd in ("native", "int8"):
        metrics = out_dir / f"moe_generate_{wd}.json"
        argv = MOE_FLAGS + ["--n-layers", str(MOE_GEN_LAYERS), "--batch",
                            "8", "--prompt-len", "1024",
                            "--max-new", str(MAX_NEW), "--seed", "21",
                            "--weight-dtype", wd, "--metrics-out",
                            str(metrics)]
        ops.reset_launch_counts()
        rc = lm_generate.main(argv)
        counts = ops.launch_counts()
        if rc != 0:
            fail(f"moe (c): lm_generate --n-experts ({wd}) exited {rc}")
        want = {"flash_fwd": 3 * MOE_GEN_LAYERS,
                "flash_decode": 2 * MOE_GEN_LAYERS * (MAX_NEW - 1),
                "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
        if counts != want:
            fail(f"moe (c) {wd}: launches {counts}, expected {want}")
        for k, n in counts.items():
            totals[k] += n
        m = json.loads(metrics.read_text())
        if len(m["tokens"]) != MAX_NEW or not all(0 <= t < 32768
                                                  for t in m["tokens"]):
            fail(f"moe (c) {wd}: bad output {m}")
        runs[wd] = dict(prefill_ms=m["prefill_ms"],
                        decode_step_ms=m["decode_step_ms"],
                        batch_decode_tokens_per_sec=m[
                            "batch_decode_tokens_per_sec"], launches=counts)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        costs = _w8a16_costs(torch, G, T, n_experts=MOE_EXPERTS,
                             n_layers=MOE_GEN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    # float32 at MOE_GEN_F32_LAYERS layers: kernels against the plain path
    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024,
                              n_layers=MOE_GEN_F32_LAYERS, n_heads=8,
                              n_kv_heads=8, d_ff=4096, n_experts=MOE_EXPERTS,
                              dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(23)
    w = G.prepare_decode(T.init(cfg, gen, dev), cfg)
    prompt = torch.randint(0, 32768, (8, 1024), generator=gen, device=dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        got = G.generate(w, cfg, prompt, MAX_NEW).tolist()
        counts = ops.launch_counts()
        plain_cfg = G.moe_dropfree(dataclasses.replace(cfg, attn_impl="ref"))
        want, gaps = _greedy_rows(torch, G, w, plain_cfg, prompt, MAX_NEW)
    want_k = {"flash_fwd": cfg.n_layers,
              "flash_decode": cfg.n_layers * (MAX_NEW - 1),
              "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    if counts != want_k:
        fail(f"moe (c) float32: launches {counts}, expected {want_k}")
    rows = [_near_tie_check(f"moe (c) float32 row {i}", g, t, gp, MAX_NEW)
            for i, (g, t, gp) in enumerate(zip(got, want, gaps))]
    agree = sum(r["diverge"] is None for r in rows)
    del w
    print(f"moe (c) lm_generate --n-experts {MOE_EXPERTS}, {MOE_GEN_LAYERS} "
          f"layers, B8 prompt 1024, {MAX_NEW} new: native prefill {runs['native']['prefill_ms']:.2f} "
          f"ms, decode {runs['native']['decode_step_ms']:.3f} ms/step wall; "
          f"int8 {runs['int8']['prefill_ms']:.2f}, "
          f"{runs['int8']['decode_step_ms']:.3f}; device: prefill native "
          f"{costs['native']['prefill_device_ms']:.3f} ms, int8 "
          f"{costs['int8']['prefill_device_ms']:.3f}; a decode step native "
          f"{costs['native']['decode_step_device_ms']:.4f} ms, int8 "
          f"{costs['int8']['decode_step_device_ms']:.4f} (resident "
          f"{costs['native']['resident_gb']:.3f} GB against "
          f"{costs['int8']['resident_gb']:.3f}); float32 at "
          f"{MOE_GEN_F32_LAYERS} layers: {agree} of 8 rows token-identical "
          f"to the plain path (the others at or after a near-tie); launches "
          f"{counts}")
    return dict(layers=MOE_GEN_LAYERS, cli=runs, device=costs,
                f32_agree=agree, f32_rows=rows)


def _moe_serving(torch, ops, G, T) -> dict:
    """(d): the SlotServer on the MoE config at SERVE_CUT_LAYERS layers,
    float32: the paged (a) cell's 8 prompts of 64-512 tokens, 48 new, on
    the ring, the paged engine and the ring with a self-draft (spec_gamma
    4), each token-identical to solo generate under the near-tie rule; no
    synchronisation in dispatch, none in admission."""
    import numpy as np

    from tony_tpu_torch.models import serving as S

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024,
                              n_layers=SERVE_CUT_LAYERS, n_heads=8,
                              n_kv_heads=8, d_ff=4096, n_experts=MOE_EXPERTS,
                              dtype=torch.float32)
    w = G.prepare_decode(T.init(cfg, torch.Generator(device=dev)
                                .manual_seed(25), dev), cfg)
    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, 32768, int(n)).tolist()
               for n in rng.integers(64, 513, PAGED_ID)]
    with torch.no_grad():
        solo = [_solo_greedy(torch, G, w, G.moe_dropfree(cfg), p,
                             PAGED_ID_NEW) for p in prompts]
    engines = {"ring": {}, "paged": dict(paged=True, kv_block=PAGED_KV_BLOCK),
               "ring_self_draft": dict(draft=w, draft_cfg=cfg,
                                       spec_gamma=SPEC_GAMMA)}
    out = {}
    for name, kw in engines.items():
        srv = S.SlotServer(w, cfg, slots=8, max_len=1024, **kw)
        syncs = _checked_dispatch(torch, srv)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [S.Request(prompt=p, max_new_tokens=PAGED_ID_NEW)
                for p in prompts]
        for r in reqs:
            srv.submit(r)
        done = srv.run_until_drained()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        spec = srv.stats().get("speculative")
        srv.shutdown()
        if any(counts.values()):
            fail(f"moe (d) {name}: kernels launched {counts}")
        if syncs["admission"]:
            fail(f"moe (d) {name}: {syncs['admission']} synchronisations in "
                 f"admission {dict(syncs['sites'])}")
        rows = [_near_tie_check(f"moe (d) {name} request {i}",
                                done[r.id].tokens, toks, gaps, PAGED_ID_NEW)
                for i, (r, (toks, gaps)) in enumerate(zip(reqs, solo))]
        agree = sum(r["diverge"] is None for r in rows)
        out[name] = dict(agree=agree, of=len(rows), wall_s=wall,
                         speculative=spec)
        print(f"moe (d) {name}: {agree} of {len(rows)} token-identical to "
              f"solo generate (the others at or after a near-tie); wall "
              f"{wall:.2f} s; 0 syncs in dispatch and admission"
              + (f"; acceptance EWMA {spec['acceptance_ewma']}" if spec
                 else ""))
    del w
    return out


def phase_moe(torch, ops, lm_train, lm_generate, A, G, T) -> dict:
    """Mixture-of-Experts through the port's entry points at the flagship
    width with MOE_EXPERTS experts (top-2, capacity factor 1.25): (a)
    training, (b) kernels against the plain path on the loss and
    gradients, (c) generation, native and int8, (d) both serving engines
    and speculative serving. -> the kernels' launches of (a) and (c)."""
    print("== main path: Mixture-of-Experts")
    from tony_tpu_torch.parallel import expert as E

    totals = dict.fromkeys(ops.launch_counts(), 0)
    legs, seconds = {}, {}
    for name, fn, args in (
            ("training", _moe_train, (torch, ops, lm_train, A, E, T, totals)),
            ("parity", _moe_parity, (torch, ops, T, E)),
            ("generation", _moe_generate, (torch, ops, lm_generate, G, T,
                                           totals)),
            ("serving", _moe_serving, (torch, ops, G, T))):
        t0 = time.perf_counter()
        legs[name] = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - t0, 1)
    print("moe " + json.dumps(dict(
        experts=MOE_EXPERTS, top_k=2, capacity_factor=1.25, cuts=MOE_CUTS,
        **legs, seconds=seconds, launches=totals, card=nvidia_smi_line())))
    return totals


# ------------------------------------------------------------------- mesh

MESH_STEPS = 2
MESH_MESHES = ("fsdp=-1", "seq=-1")
# the on-demand capture of mesh (a)'s first run: the steps it adds, and
# the window the smoke asks the driver for (the loop's end stops it
# sooner). The StepTimer writes a record a step, so the flag is read at
# the first measured step and the capture takes the steps after it
MESH_PROFILE_STEPS, MESH_PROFILE_S = 2, 2.0
MESH_LOSS_ATOL = 3e-2
MESH_RING_N = (2, 4)
# (shape B, H, L, D; out and lse tolerance; gradient tolerance), causal
MESH_RING_CASES = {"bfloat16": ((8, 8, 2048, 128), (3e-2, 3e-2), (3e-2, 3e-2)),
                   "float32": ((2, 8, 1024, 128), (2e-5, 2e-5), (1e-4, 1e-4))}

# ------------------------------------------------------- the port's launcher

LAUNCH_DIR = REPO / "build" / "chip_smoke" / "launch"
CONFIGS = REPO / "tony_tpu_torch" / "examples" / "configs"


def _job_conf(name: str, conf_files=(), **extra):
    """A job's TonyConf: ``conf_files`` and ``extra`` over the port's
    defaults, its staging and history under LAUNCH_DIR/<name>, the
    driver's monitor and the executors' barrier poll at 100 ms."""
    from tony_tpu_torch.conf import TonyConf

    root = LAUNCH_DIR / name
    shutil.rmtree(root, ignore_errors=True)
    conf = TonyConf.resolve([str(f) for f in conf_files], include_site=False)
    settings = {"tony.staging.dir": str(root / "staging"),
                "tony.history.intermediate": str(root / "history"),
                "tony.am.monitor-interval-ms": 100,
                "tony.task.registration-poll-interval-ms": 100,
                "tony.execution.env": "PYTHONUNBUFFERED=1"}
    for k, v in {**settings, **extra}.items():
        conf.set(k, v)
    return conf


class _Job:
    """One TonY job through the port's TonyClient, submitted at
    construction: the client stages it and starts the driver (python -S -m
    tony_tpu_torch.driver), which launches an executor a task (python -S
    -m tony_tpu_torch.executor), whose runtime forks the task's command.
    The client monitors it from then on, on a thread of its own, so it
    acknowledges the job's end as soon as it comes. ``driver_s``: submit ->
    the driver's driver.json (its start-up)."""

    def __init__(self, conf):
        import threading

        from tony_tpu_torch.client import TonyClient

        self.client = TonyClient(conf, poll_interval_s=0.1)
        self.t0 = time.perf_counter()
        self.client.submit()
        info = Path(self.client.job_dir) / "driver.json"
        while not info.exists():
            if self.client._driver_proc.poll() is not None:
                fail(f"launch: the driver exited "
                     f"{self.client._driver_proc.returncode}: "
                     f"{self.log('driver.log')}")
            time.sleep(0.005)
        self.driver_s = time.perf_counter() - self.t0
        self.status = self.error = None
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()

    def _monitor(self) -> None:
        try:
            self.status = self.client.monitor().value
        except Exception as e:      # re-raised by wait()
            self.error = e
        self.wall_s = time.perf_counter() - self.t0

    def wait(self, want: str | None = "SUCCEEDED") -> str:
        """The job's end -> its status; fails unless it is ``want``."""
        self._thread.join()
        if self.error is not None:
            raise self.error
        if want is not None and self.status != want:
            fail(f"launch: job {self.client.app_id} ended {self.status}, "
                 f"expected {want} ({self.client.final_state.get('message')})"
                 f": {self.log('logs/worker_0.stderr')}")
        return self.status

    def stop(self) -> None:
        """Stop the job through its driver (every executor's process group
        with it) and wait for the driver."""
        self.client.stop()
        self.client._driver_proc.wait(timeout=60)

    def log(self, rel: str = "logs/worker_0.stdout") -> str:
        path = Path(self.client.job_dir) / rel
        return path.read_text()[-6000:] if path.exists() else ""

    def history(self) -> tuple:
        """-> (the jhist events, the sealed task traces)."""
        root = Path(str(self.client.conf.get("tony.history.intermediate")))
        d = root / self.client.app_id
        (jhist,) = d.glob("*.jhist")
        events = [json.loads(ln) for ln in jhist.read_text().splitlines()]
        traces = [json.loads(ln) for ln in
                  (d / "tasks.trace.jsonl").read_text().splitlines()]
        return events, traces

    def executor_s(self) -> dict:
        """task -> launched -> registered on the driver's clock (the
        executor's start-up: interpreter, conf, port, registration)."""
        out = {}
        for tr in self.history()[1]:
            t = {n: v for n, v in tr["spans"]}
            out[tr["id"]] = round(t["registered"] - t["launched"], 3)
        return out

    def task_metrics(self, task_id: str = "worker:0") -> dict:
        """The executor's last TaskMonitor push, from TASK_FINISHED."""
        for e in self.history()[0]:
            if (e["type"] == "TASK_FINISHED"
                    and e["payload"]["task_id"] == task_id):
                return {m["name"]: m["value"]
                        for m in e["payload"]["metrics"]}
        return {}

    def address(self, task_id: str = "worker:0") -> str:
        """The task's registered host:port."""
        (info,) = [i for i in self.client.task_infos
                   if i.task_id == task_id]
        return f"{info.host}:{info.port}"

    def record(self) -> dict:
        return dict(app_id=self.client.app_id, status=self.status,
                    driver_s=round(self.driver_s, 3),
                    executor_s=self.executor_s(),
                    wall_s=round(self.wall_s, 2))


_CONTRACT = ("TONY_COORDINATOR_ADDRESS", "TONY_PROCESS_ID",
             "TONY_NUM_PROCESSES")


def _launched_child(name: str, script: str, args: list,
                    timeout_s: int, on_submit=None) -> tuple:
    """``script`` (a Python program's text) run as a one-worker TonY job on
    the card through the port's launcher, with ``args`` -> (its standard
    output, the job's record). The child prints the runtime's contract as
    ``<name>_env {...}``; the coordinator must be the worker's registered
    address (rank 0's), the world one. ``on_submit(job)`` runs while the
    job does; its result is the record's ``on_submit``."""
    path = REPO / "build" / "chip_smoke" / f"{name}_child.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"import json as _j, os as _o\n"
                    f"print('{name}_env ' + _j.dumps({{k: _o.environ.get(k) "
                    f"for k in {_CONTRACT!r}}}), flush=True)\n" + script)
    command = " ".join([sys.executable, str(path)]
                       + [shlex.quote(a) for a in args])
    job = _Job(_job_conf(name, **{"tony.worker.instances": 1,
                                  "tony.worker.chips": 1,
                                  "tony.worker.command": command,
                                  "tony.application.timeout-ms":
                                      timeout_s * 1000}))
    extra = on_submit(job) if on_submit is not None else None
    job.wait()
    out = (Path(job.client.job_dir) / "logs" / "worker_0.stdout").read_text()
    env = json.loads([ln for ln in out.splitlines()
                      if ln.startswith(f"{name}_env ")][-1].split(" ", 1)[1])
    want = {"TONY_COORDINATOR_ADDRESS": job.address(), "TONY_PROCESS_ID": "0",
            "TONY_NUM_PROCESSES": "1"}
    if env != want:
        fail(f"{name}: the runtime's contract {env}, expected {want} (rank "
             f"0's registered address)")
    return out, dict(job.record(), contract=env, on_submit=extra,
                     job_dir=str(job.client.job_dir),
                     task_metrics=job.task_metrics())


# the child of the mesh phase's (a): lm_train launched by the port's
# launcher, once a mesh, its launches counted in the child
_MESH_CHILD = r"""
import importlib, json, sys
import torch.distributed as dist
from tony_tpu_torch import ops
from tony_tpu_torch.examples import lm_train
R = importlib.import_module("tony_tpu_torch.parallel.ring_attention")
ring_fwd, calls = R.ring_flash_fwd_rank, []
def counted(*args, **kwargs):
    calls.append(1)
    return ring_fwd(*args, **kwargs)
R.ring_flash_fwd_rank = counted
runs, argv = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = []
for mesh, metrics, steps in runs:
    ops.reset_launch_counts()
    calls.clear()
    rc = lm_train.main(argv + ["--mesh", mesh, "--metrics-out", metrics,
                               "--steps", str(steps)])
    out.append({"mesh": mesh, "rc": rc, "launches": ops.launch_counts(),
                "ring_forwards": len(calls)})
dist.destroy_process_group()
# the libraries this process built or loaded, and its device-memory peak
import torch
from tony_tpu_torch.ops import _build
print("mesh_child_memory " + json.dumps({
    "libraries": _build.noted(),
    "peak_mb": torch.cuda.max_memory_allocated() / 2**20}), flush=True)
print("mesh_child " + json.dumps(out))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_bootstrap(train_losses) -> dict:
    """(a): lm_train as a child launched by the port's launcher, a
    one-worker TonY job at world 1 (the torch runtime hands it rank 0's
    registered address as its coordinator): train.init joins an NCCL group
    and build_mesh makes a DeviceMesh, then MESH_STEPS steps at the
    flagship width and training's shape with --mesh fsdp=-1 (the sharded
    step) and --mesh seq=-1 (the flash ring at n = 1), each against the
    training phase's first steps."""
    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = [(m, str(out_dir / f"mesh_{i}.json"),
             MESH_STEPS + (MESH_PROFILE_STEPS if i == 0 else 0))
            for i, m in enumerate(MESH_MESHES)]
    argv = FLAGSHIP + ["--batch-size", str(TRAIN_BATCH), "--seq-len",
                       str(TRAIN_SEQ), "--step-log-every", "1"]
    stdout, job = _launched_child("mesh", _MESH_CHILD,
                                  [json.dumps(runs), json.dumps(argv)], 400,
                                  on_submit=_ask_for_a_capture)
    wall = job["wall_s"]
    joined = [ln for ln in stdout.splitlines()
              if ln.startswith("process 0/1:")]
    if len(joined) != len(runs) or not all(" nccl on cuda" in ln
                                           for ln in joined):
        fail(f"mesh (a): expected an NCCL group a run, got {joined}")
    child = json.loads([ln for ln in stdout.splitlines()
                        if ln.startswith("mesh_child ")][-1][11:])
    totals = dict.fromkeys(("flash_fwd", "flash_decode", "flash_bwd_dkdv",
                            "flash_bwd_dq"), 0)
    rows = []
    for (mesh, metrics, steps), rec, line in zip(runs, child, joined):
        want = {"flash_fwd": steps * N_LAYERS, "flash_decode": 0,
                "flash_bwd_dkdv": steps * N_LAYERS,
                "flash_bwd_dq": steps * N_LAYERS}
        # the ring's forward runs once a layer a step under seq=-1
        rings = steps * N_LAYERS if mesh.startswith("seq") else 0
        if (rec["rc"] != 0 or rec["launches"] != want
                or rec["ring_forwards"] != rings):
            fail(f"mesh (a) --mesh {mesh}: rc {rec['rc']}, launches "
                 f"{rec['launches']}, ring forwards {rec['ring_forwards']}, "
                 f"expected {want} and {rings}")
        m = json.loads(Path(metrics).read_text())
        losses = m["losses"]
        err = max(abs(a - b) for a, b in zip(losses, train_losses))
        if len(losses) != steps or not all(map(math.isfinite, losses)) \
                or err > MESH_LOSS_ATOL:
            fail(f"mesh (a) --mesh {mesh}: losses {losses} against the "
                 f"training phase's {train_losses[:steps]} (atol "
                 f"{MESH_LOSS_ATOL})")
        for k, n in rec["launches"].items():
            totals[k] += n
        rows.append(dict(mesh=mesh, joined=line, mesh_sizes=m["mesh"],
                         losses=losses, max_loss_diff=err,
                         bitwise=losses == train_losses[:steps],
                         steps_per_sec=m["steps_per_sec"],
                         launches=rec["launches"],
                         ring_forwards=rec["ring_forwards"]))
        print(f"mesh (a) --mesh {mesh}: {line}; losses {losses} against "
              f"the training phase's {train_losses[:steps]}: max |diff| "
              f"{err:.3g} (atol {MESH_LOSS_ATOL}); launches "
              f"{rec['launches']}, ring forwards {rec['ring_forwards']}")
    print(f"mesh (a): launched as job {job['app_id']}: {job['status']}, the "
          f"driver up in {job['driver_s']:.3f} s, the executor registered "
          f"{job['executor_s']['worker:0']:.3f} s after its launch, the "
          f"coordinator rank 0's registered address "
          f"{job['contract']['TONY_COORDINATOR_ADDRESS']}; the job "
          f"{wall:.1f} s")
    capture = _capture_checks(job, stdout, runs[0][2])
    return dict(runs=rows, child_wall_s=wall, launches=totals, job=job,
                capture=capture)


def _ask_for_a_capture(job) -> dict:
    """(b) of the observability hooks: once mesh (a)'s task runs, ask its
    driver for a MESH_PROFILE_S capture with the client-signed
    request_task_profile RPC (queued False while the task has no
    container). The command rides the next heartbeat answer to the
    executor, whose flag the child's StepTimer reads at its first
    record."""
    t0 = time.perf_counter()
    while job._thread.is_alive() and time.perf_counter() - t0 < 300:
        if job.client.request_profile("worker:0", MESH_PROFILE_S):
            return dict(queued_after_s=round(time.perf_counter() - t0, 3))
        time.sleep(0.2)
    fail("mesh (a): request_task_profile never queued a capture")


def _capture_checks(job, stdout: str, steps: int) -> dict:
    """(b) and (c) on mesh (a)'s job: the flag was written (the
    executor's relay) and consumed, the trace under logs/profiles/ names
    K1's and K3-K5's mma kernels, and the step times of the first run
    around the capture are printed; the step log's last record counts
    the kernel libraries the child built or loaded, none after its
    warm-up line, and the TaskMonitor's pushed device-memory peak is
    within 1% of the child's own at its end."""
    logs = Path(job["job_dir"]) / "logs"
    flag = logs / ("worker_0.steps.jsonl.profile")
    relayed = "profile command relayed" in (logs / "worker_0.stderr"
                                            ).read_text()
    traces = sorted((logs / "profiles").glob("worker_0_*/trace.*.json"))
    if flag.exists() or not relayed or len(traces) != 1:
        fail(f"mesh (b): the flag {'left behind' if flag.exists() else 'consumed'}"
             f", relayed by the executor: {relayed}, traces {traces}")
    text = traces[0].read_text()
    events = json.loads(text)["traceEvents"]
    kernels = collections.Counter(
        k for e in events if e.get("cat") == "kernel"
        for k in MMA_KERNELS if k in e.get("name", ""))
    if set(kernels) != set(MMA_KERNELS):
        fail(f"mesh (b): the capture's kernels {dict(kernels)}, expected "
             f"each of {MMA_KERNELS}")
    records = [json.loads(ln) for ln in
               (logs / "worker_0.steps.jsonl").read_text().splitlines()]
    # the first run's records: steps 1 .. steps - 1, its flag read at the
    # first, the capture taking the steps after it
    first = records[:steps - 1]
    step_ms = {r["train_step"]: r["mean_step_s"] * 1e3 for r in first}
    mem = json.loads([ln for ln in stdout.splitlines()
                      if ln.startswith("mesh_child_memory ")][-1][18:])
    last = records[-1]
    pushed = job["task_metrics"].get("max_gpu_memory_peak_mb")
    if (last["kernel_builds"] != len(mem["libraries"])
            or last["kernel_builds_post_warm"] != 0):
        fail(f"mesh (c): the step log's kernel_builds "
             f"{last['kernel_builds']} ({last['kernel_builds_post_warm']} "
             f"after warm-up) against the child's libraries "
             f"{mem['libraries']}")
    if pushed is None or abs(pushed - mem["peak_mb"]) > 0.01 * mem["peak_mb"]:
        fail(f"mesh (c): the TaskMonitor pushed gpu_memory_peak_mb {pushed} "
             f"against the child's max_memory_allocated {mem['peak_mb']:.1f}"
             " MiB (1%)")
    before = [v for k, v in step_ms.items() if k < 2]
    during = [v for k, v in step_ms.items() if k >= 2]
    print(f"mesh (b): a {MESH_PROFILE_S} s capture asked for "
          f"{job['on_submit']['queued_after_s']:.3f} s after submit rode a "
          f"heartbeat to the executor's flag (consumed) and the child's "
          f"torch.profiler: {traces[0].name}, {len(text)} bytes, "
          f"{len(events)} events, kernels {dict(kernels)}; the first run's "
          f"step ms (host, a record a step) "
          + ", ".join(f"step {k} {v:.1f}" for k, v in step_ms.items())
          + f": captured {during} against {before} before the capture")
    print(f"mesh (c): the step log's kernel_builds {last['kernel_builds']} "
          f"= the child's libraries {mem['libraries']}, "
          f"{last['kernel_builds_post_warm']} after warm-up; the "
          f"TaskMonitor's pushed gpu_memory_peak_mb {pushed:.1f} against "
          f"the child's max_memory_allocated {mem['peak_mb']:.1f} MiB at its "
          f"end ({abs(pushed - mem['peak_mb']) / mem['peak_mb']:.2%})")
    return dict(trace=traces[0].name, trace_bytes=len(text),
                events=len(events), kernels=dict(kernels), step_ms=step_ms,
                captured_ms=during, before_ms=before,
                kernel_builds=last["kernel_builds"],
                libraries=mem["libraries"], pushed_peak_mb=pushed,
                child_peak_mb=mem["peak_mb"])


def _mesh_ring_replay(torch, ops, A, R) -> list:
    """(b): the flash ring's schedule replayed in one process
    (replay_ring_flash: every rank's forward and backward over the blocks
    it would receive) at n = 2 and 4, held against the whole-sequence K1
    and K3-K5 and against the plain versions; K1, dK/dV and dQ launched
    once a visible step."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    rows = []
    for name, (shape, tol_o, tol_g) in MESH_RING_CASES.items():
        dt = getattr(torch, name)
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev, dtype=dt)
                      for _ in range(4))
        out_k, lse_k = A._flash_fwd_cuda(q, k, v, True, None, None)
        grads_k = A._flash_bwd_cuda(q, k, v, out_k, lse_k, g, None, True,
                                    None, None)
        out_p, lse_p = A._flash_fwd_reference(q, k, v, True, None, None)
        grads_p = A._flash_bwd_reference(q, k, v, out_p, lse_p, g, None,
                                         True, None, None)
        want = {"kernels": dict(out=out_k, lse=lse_k, dq=grads_k[0],
                                dk=grads_k[1], dv=grads_k[2]),
                "plain": dict(out=out_p, lse=lse_p, dq=grads_p[0],
                              dk=grads_p[1], dv=grads_p[2])}
        label = "B{} H{} L{} D{}".format(*shape) + f" {name} causal"
        for n in MESH_RING_N:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = R.replay_ring_flash(q, k, v, g, n, causal=True)
            end.record()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            steps = n * (n + 1) // 2
            expect = {"flash_fwd": steps, "flash_decode": 0,
                      "flash_bwd_dkdv": steps, "flash_bwd_dq": steps}
            if counts != expect:
                fail(f"mesh (b) {label} n={n}: launches {counts}, expected "
                     f"{expect}")
            errs = {}
            for against, ref in want.items():
                for key, w in ref.items():
                    tol = tol_o if key in ("out", "lse") else tol_g
                    errs[f"{key} vs {against}"] = compare(
                        f"mesh (b) {label} n={n} {key} vs {against}",
                        got[key], w, tol)
            rows.append(dict(shape=label, n=n, launches=counts,
                             visible_steps=steps, max_abs_err=errs,
                             tolerance={"out, lse": tol_o, "grads": tol_g},
                             replay_ms=start.elapsed_time(end)))
            print(f"mesh (b) {label}, ring of {n}: {steps} visible steps a "
                  f"pass, launches {counts}; max |err| "
                  + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
                  + f" (atol + rtol: out, lse {tol_o}, gradients {tol_g}); "
                  f"the replay {start.elapsed_time(end):.2f} ms")
        del q, k, v, g, out_k, lse_k, grads_k, out_p, lse_p, grads_p, want, got
        torch.cuda.empty_cache()
    return rows


def phase_mesh(torch, ops, A, train_losses) -> dict:
    """Multi-process training's pieces on the one card: (a) the bootstrap
    over NCCL and the sharded step at world 1 through lm_train, (b) the
    ring's block schedule replayed at n = 2 and 4 (several ranks cannot
    share one card under NCCL: PERF.md). Returns (a)'s launches."""
    print("== main path: mesh")
    import importlib

    R = importlib.import_module("tony_tpu_torch.parallel.ring_attention")
    boot = _mesh_bootstrap(train_losses)
    ring = _mesh_ring_replay(torch, ops, A, R)
    print("mesh " + json.dumps(dict(bootstrap=boot, ring=ring,
                                    card=nvidia_smi_line())))
    return boot["launches"]


# the tp phase: (a) a child under the TonY env contract at world 1 over an
# NCCL group of one: lm_generate --tensor-parallel 1 on the generation
# phase's request 0 (bf16, 12 layers); generate(mesh=) at float32 on
# TP_F32 (batch, prompt, new) against generate without a mesh; serve --mesh
# tensor=1 on run A's greedy requests at float32 and SERVE_CUT_LAYERS
# against the meshless serve. (b) the tensor axis's arithmetic replayed in
# one process at t = TP_REPLAY_T, float32 at the flagship's widths and
# TP_REPLAY_LAYERS layers: TP_REPLAY_SHAPE (batch, prompt, fed steps)
TP_F32 = (2, 1024, 16)
# of run A's 20 greedy requests, those the serve --mesh tensor=1 check
# sends (all 20 until the disaggregated handoff beside it needed the time)
TP_SERVE_REQUESTS = 12
TP_REPLAY_T = (2, 4)
TP_REPLAY_LAYERS = 2
TP_REPLAY_SHAPE = (2, 1024, 16)
# float32 logits of the replay against the whole model (kernels, and the
# plain path): the tensor axis only reorders float32 sums (wo over heads,
# w_down over d_ff, K6's split over fewer heads), rounding errors of about
# 1e-6 relative on logits of size about 1; 1e-3 leaves a 100x margin
# (PERF.md)
TP_LOGITS_ATOL = 1e-3

_TP_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
import chip_smoke as C
from tony_tpu_torch import ops
from tony_tpu_torch.cli import serve
from tony_tpu_torch.examples import lm_generate
from tony_tpu_torch.models import generate as G, transformer as T
from tony_tpu_torch.parallel import MeshSpec, build_mesh
args = json.loads(sys.argv[2])
out = {}
ops.reset_launch_counts()
out["bf16"] = {"rc": lm_generate.main(args["gen_argv"]),
               "launches": ops.launch_counts(),
               "backend": dist.get_backend()}
dev = torch.device("cuda")
cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=12,
                          n_heads=8, n_kv_heads=8, d_ff=4096,
                          dtype=torch.float32)
gen = torch.Generator(device=dev).manual_seed(5)
params = T.init(cfg, gen, dev)
b, lp, n = args["f32"]
prompt = torch.randint(0, 32768, (b, lp), generator=gen, device=dev)
mesh = build_mesh(MeshSpec(fsdp=1, tensor=1), "cuda")
ops.reset_launch_counts()
tp = G.generate(G.prepare_decode(params, cfg, mesh=mesh), cfg, prompt, n,
                mesh=mesh)
launches = ops.launch_counts()
plain = G.generate(params, cfg, prompt, n)
out["f32"] = {"equal": bool(torch.equal(tp, plain)), "launches": launches,
              "rows": tp.shape[0]}
del params, tp, plain
torch.cuda.empty_cache()
rng, lens, news, sampled, payloads = C._serve_payloads()
greedy = [dict(p, logprobs=2) for i, p in enumerate(payloads)
          if i not in sampled][:args["serve_requests"]]
runs = {}
for name, extra in (("meshless", []), ("mesh", ["--mesh", "tensor=1"])):
    app, httpd, url = C._serve_app(serve, args["serve_argv"] + extra)
    eng = getattr(app.server, "_engine", app.server)
    syncs = C._checked_dispatch(torch, eng)
    res = C._post_all(url, greedy)
    stats = app.stats()
    C._stop_app(app, httpd)
    runs[name] = {"tokens": [r[1]["tokens"] for r in res],
                  "gaps": [[e["top"][1][0] - e["top"][1][1]
                            for e in r[1]["logprobs"]] for r in res],
                  "admission_syncs": syncs["admission"],
                  "sites": dict(syncs["sites"]),
                  "blocks": stats["blocks_dispatched"],
                  "lockstep": stats.get("lockstep"),
                  "world": stats.get("world"), "mesh": stats.get("mesh")}
out["serve"] = runs
# a prefill role on the mesh hands the disaggregated (a) cell's requests
# off to a meshless decode role; a meshless solo paged serve beside them
prompts = C._disagg_prompts()
disagg = {}
for name, extra in (("prefill", ["--mesh", "tensor=1", "--role", "prefill"]),
                    ("decode", ["--role", "decode"]), ("solo", [])):
    app, httpd, url = C._serve_app(serve, args["serve_argv"] + ["--paged-kv"]
                                   + extra)
    eng = getattr(app.server, "_engine", app.server)
    syncs = C._checked_dispatch(torch, eng)
    if name == "decode":
        bodies, url = handoffs, url.replace("/generate", "/kv/import")
    else:
        bodies = [dict(prompt=p, max_new_tokens=C.DISAGG_NEW, logprobs=2)
                  for p in prompts]
    res = C._post_all(url, bodies)
    stats = app.stats()
    C._stop_app(app, httpd)
    rec = {"admission_syncs": syncs["admission"], "role": stats["role"],
           "world": stats.get("world"),
           "exports": stats["paged_kv"]["kv_exports"],
           "imports": stats["paged_kv"]["kv_imports"],
           "s": [r[2] for r in res]}
    if name == "prefill":
        handoffs = [r[1].get("handoff") for r in res]
        rec["reasons"] = [r[1]["finish_reason"] for r in res]
        rec["payload_bytes"] = [len(json.dumps(h)) for h in handoffs]
    else:
        rec["tokens"] = [r[1]["tokens"] for r in res]
    if name == "solo":
        rec["gaps"] = [[e["top"][1][0] - e["top"][1][1]
                        for e in r[1]["logprobs"]] for r in res]
    disagg[name] = rec
out["disagg"] = disagg
dist.destroy_process_group()
print("tp_child " + json.dumps(out))
"""


def _tp_world_one(torch) -> dict:
    """(a): the child of _TP_CHILD launched by the port's launcher, a
    one-worker TonY job (the torch runtime's TONY_COORDINATOR_ADDRESS,
    TONY_PROCESS_ID=0, TONY_NUM_PROCESSES=1) -> its record and the K1 and
    K6 launches it counted."""
    out_dir = REPO / "build" / "chip_smoke"
    req0 = json.loads((out_dir / "request0.json").read_text())
    b, lp, extra = REQUESTS[0]
    gen_argv = FLAGSHIP + ["--batch", str(b), "--prompt-len", str(lp),
                           "--max-new", str(MAX_NEW), "--max-len",
                           str(MAX_LEN), "--seed", "0", "--tensor-parallel",
                           "1", "--metrics-out",
                           str(out_dir / "tp_request0.json")] + extra
    serve_argv = SHALLOW + ["--dtype", "float32", "--port", "0"]
    stdout, job = _launched_child("tp", _TP_CHILD, [str(REPO), json.dumps(dict(
        gen_argv=gen_argv, serve_argv=serve_argv, f32=list(TP_F32),
        serve_requests=TP_SERVE_REQUESTS))], 400)
    wall = job["wall_s"]
    child = json.loads([ln for ln in stdout.splitlines()
                        if ln.startswith("tp_child ")][-1][9:])
    bf16, f32, runs = child["bf16"], child["f32"], child["serve"]
    disagg = _tp_disagg_checks(child["disagg"])
    tp0 = json.loads((out_dir / "tp_request0.json").read_text())
    want_bf16 = {"flash_fwd": 3 * N_LAYERS,
                 "flash_decode": 2 * N_LAYERS * (MAX_NEW - 1),
                 "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    if (bf16["rc"] != 0 or bf16["backend"] != "nccl"
            or bf16["launches"] != want_bf16
            or tp0["tokens"] != req0["tokens"]):
        fail(f"tp (a) bf16: rc {bf16['rc']} over {bf16['backend']}, "
             f"launches {bf16['launches']} (expected {want_bf16}), tokens "
             f"{tp0['tokens'][:8]}... against the generation phase's "
             f"{req0['tokens'][:8]}...")
    n_new = TP_F32[2]
    want_f32 = {"flash_fwd": N_LAYERS,
                "flash_decode": N_LAYERS * (n_new - 1),
                "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    if not f32["equal"] or f32["launches"] != want_f32:
        fail(f"tp (a) float32: tokens equal {f32['equal']}, launches "
             f"{f32['launches']} (expected {want_f32})")
    mesh, plain = runs["mesh"], runs["meshless"]
    for name, rec in runs.items():
        if rec["admission_syncs"]:
            fail(f"tp (a) serve {name}: {rec['admission_syncs']} syncs in "
                 f"admission ({rec['sites']})")
    if mesh["world"] != 1:
        fail(f"tp (a) serve --mesh tensor=1: world {mesh['world']}")
    # the two serves batch their arrivals differently, and a float32
    # product of another shape may round a near tie the other way
    parity = [_near_tie_check(f"tp (a) serve --mesh tensor=1 request {i}",
                              got, want, gaps, len(want))
              for i, (got, want, gaps) in enumerate(zip(
                  mesh["tokens"], plain["tokens"], plain["gaps"]))]
    same = sum(r["diverge"] is None for r in parity)
    ls = mesh["lockstep"]
    print(f"tp (a): lm_generate --tensor-parallel 1 over {bf16['backend']} "
          f"at world 1: request 0's tokens equal the generation phase's "
          f"({len(req0['tokens'])}), launches {bf16['launches']}; float32 "
          f"generate(mesh=) B{TP_F32[0]} x {TP_F32[1]} + {n_new} equal to "
          f"generate without a mesh, launches {f32['launches']}; serve "
          f"--mesh tensor=1 at float32, {SERVE_CUT_LAYERS} layers: "
          f"{len(mesh['tokens'])} greedy requests equal to the meshless "
          f"serve's up to its first near-tie ({same} exactly), "
          f"{mesh['blocks']} blocks, 0 syncs in dispatch and "
          f"admission; the turn exchange's host time p50 "
          f"{ls['exchange_s_p50'] * 1e3:.3f} ms, max "
          f"{ls['exchange_s_max'] * 1e3:.3f} ms over {ls['turns']} turns; "
          f"launched as job {job['app_id']} ({job['status']}, the "
          f"coordinator rank 0's registered address), the job {wall:.1f} s")
    launches = {k: bf16["launches"][k] + f32["launches"][k]
                for k in want_bf16}
    return dict(bf16=bf16, f32=f32, serve={k: {n: v for n, v in r.items()
                                                if n not in ("tokens", "gaps")}
                                            for k, r in runs.items()},
                serve_parity=parity, disagg=disagg,
                child_wall_s=wall, launches=launches, job=job)


def _tp_disagg_checks(d) -> dict:
    """(a)'s handoff: serve --mesh tensor=1 --role prefill at world 1 ->
    a meshless serve --role decode, the disaggregated (a) cell's requests
    at float32 and SERVE_CUT_LAYERS layers, against a meshless solo paged
    serve: every request prefilled and handed off, the roles on /stats
    as given, the decode role's tokens the solo's up to its first
    near-tie, no synchronisation in admission."""
    pre, dec, solo = d["prefill"], d["decode"], d["solo"]
    n = len(solo["tokens"])
    if (pre["reasons"] != ["prefilled"] * n or pre["role"] != "prefill"
            or pre["world"] != 1 or dec["role"] != "decode"
            or pre["exports"] != n or dec["imports"] != n):
        fail(f"tp (a) disagg: prefill {pre['reasons']} role {pre['role']} "
             f"world {pre['world']} exports {pre['exports']}; decode role "
             f"{dec['role']} imports {dec['imports']} (expected {n})")
    for name, rec in d.items():
        if rec["admission_syncs"]:
            fail(f"tp (a) disagg {name}: {rec['admission_syncs']} syncs in "
                 "admission")
    parity = [_near_tie_check(f"tp (a) disagg request {i}", got, want, gaps,
                              DISAGG_NEW)
              for i, (got, want, gaps) in enumerate(zip(
                  dec["tokens"], solo["tokens"], solo["gaps"]))]
    same = sum(r["diverge"] is None for r in parity)
    print(f"tp (a) disagg: serve --mesh tensor=1 --role prefill (world "
          f"{pre['world']}) -> serve --role decode without a mesh, {n} "
          f"requests of 64-512 tokens, {DISAGG_NEW} new, float32, "
          f"{SERVE_CUT_LAYERS} layers: {n} prefilled and imported, tokens "
          f"equal to the solo paged serve's up to its first near-tie "
          f"({same} exactly); payload bytes {sum(pre['payload_bytes'])}; "
          f"the prefill leg p50 {_quantiles(pre['s'])['p50']:.3f} s, the "
          f"decode leg p50 {_quantiles(dec['s'])['p50']:.3f} s; 0 syncs in "
          f"dispatch and admission")
    return dict(requests=n, exactly_equal=same, parity=parity,
                payload_bytes=pre["payload_bytes"],
                prefill_s=pre["s"], decode_s=dec["s"], solo_s=solo["s"])


def _tp_replay(torch, ops, A, DA, G, T, R) -> dict:
    """(b): every rank of a tensor axis of t = 2 and 4 replayed in one
    process (tp_replay.replay_tp_decode: the multi-process path's own
    forward, the collectives in memory) at the flagship's widths, float32,
    against the whole model with the kernels and on the plain path, the
    same tokens fed to each; each rank's K1 and K6 calls recorded by their
    head counts."""
    import dataclasses

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024,
                              n_layers=TP_REPLAY_LAYERS, n_heads=8,
                              n_kv_heads=8, d_ff=4096, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(11)
    params = T.init(cfg, gen, dev)
    b, lp, n = TP_REPLAY_SHAPE
    prompt = torch.randint(0, 32768, (b, lp), generator=gen, device=dev)
    max_len = lp + n + 1
    toks = G.generate(params, cfg, prompt, n + 1)
    fed = toks[:, :n]
    heads = {"flash_fwd": collections.Counter(),
             "flash_decode": collections.Counter()}
    fwd, dec = A._flash_fwd_cuda, DA._decode_cuda

    def fwd_rec(q, *a, **kw):
        heads["flash_fwd"][q.shape[1]] += 1
        return fwd(q, *a, **kw)

    def dec_rec(q, *a, **kw):
        heads["flash_decode"][q.shape[1]] += 1
        return dec(q, *a, **kw)

    A._flash_fwd_cuda, DA._decode_cuda = fwd_rec, dec_rec
    try:
        ops.reset_launch_counts()
        whole = R.decode_logits(params, cfg, prompt, fed, max_len)
        torch.cuda.synchronize()
        whole_counts = ops.launch_counts()
        plain = R.decode_logits(params, dataclasses.replace(
            cfg, attn_impl="ref"), prompt, fed, max_len)
        rows = []
        for t in TP_REPLAY_T:
            for c in heads.values():
                c.clear()
            ops.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = R.replay_tp_decode(params, cfg, prompt, fed, t, max_len)
            end.record()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            want = {k: t * v for k, v in whole_counts.items()}
            if counts != want:
                fail(f"tp (b) t={t}: launches {counts}, expected {want}")
            want_heads = {"flash_fwd": {8 // t: t * whole_counts["flash_fwd"]},
                          "flash_decode": {8 // t: t * whole_counts[
                              "flash_decode"]}}
            if {k: dict(v) for k, v in heads.items()} != want_heads:
                fail(f"tp (b) t={t}: kernel calls by head count "
                     f"{dict(heads)}, expected {want_heads}")
            if not all(torch.equal(x, y) for r in got[1:]
                       for x, y in zip(r, got[0])):
                fail(f"tp (b) t={t}: the ranks' logits differ")
            errs = {"kernels": max(float((x - y).abs().max())
                                   for x, y in zip(got[0], whole)),
                    "plain": max(float((x - y).abs().max())
                                 for x, y in zip(got[0], plain))}
            for against, e in errs.items():
                if not e <= TP_LOGITS_ATOL:
                    fail(f"tp (b) t={t}: logits max |err| {e:.3g} against "
                         f"the whole model ({against}), atol "
                         f"{TP_LOGITS_ATOL}")
            ties = []
            for r in range(b):
                gaps = [float(w[r].topk(2).values[0] - w[r].topk(2).values[1])
                        for w in whole]
                ties.append(_near_tie_check(
                    f"tp (b) t={t} row {r}",
                    [int(x[r].argmax()) for x in got[0]],
                    [int(x[r].argmax()) for x in whole], gaps, n + 1))
            rows.append(dict(t=t, launches=counts, kernel_heads={
                k: dict(v) for k, v in heads.items()}, max_abs_err=errs,
                tolerance=TP_LOGITS_ATOL, near_ties=ties,
                replay_ms=start.elapsed_time(end)))
            print(f"tp (b) t={t}: launches {counts} (t x the whole model's "
                  f"{whole_counts}), K1 on {8 // t} heads and K6 on "
                  f"{8 // t} kv heads a rank; float32 logits of {n + 1} "
                  f"steps max |err| {errs['kernels']:.3g} against the whole "
                  f"model's kernels, {errs['plain']:.3g} against its plain "
                  f"path (atol {TP_LOGITS_ATOL}); greedy tokens equal up "
                  f"to the top-2-gap rule; the replay "
                  f"{start.elapsed_time(end):.1f} ms")
    finally:
        A._flash_fwd_cuda, DA._decode_cuda = fwd, dec
    del params, whole, plain, got
    torch.cuda.empty_cache()
    # K6 at a rank's kv heads beside the whole model's, at the decode
    # table's shape (B8, 2081 of 4160 positions, bf16), each with its
    # plain version's and scaled_dot_product_attention's time
    k6 = {}
    for kvh in (8, 4, 2):
        q = torch.randn(8, kvh, 1, 128, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        ck, cv = (torch.randn(8, kvh, 4160, 128, generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        k6[kvh] = dict(
            ms=cuda_ms(lambda: DA.flash_decode(q, ck, cv, 2080), 200),
            plain_ms=cuda_ms(lambda: DA._flash_decode_reference(
                q, ck, cv, 2080), 6, warmup=1),
            library_ms=cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, ck[:, :, :2081], cv[:, :, :2081]), 48))
        del q, ck, cv
    print(f"tp (b) K6 B8 D128 bf16, 2081 of 4160 positions: "
          + ", ".join(f"{h} kv heads {r['ms']:.4f} ms (plain "
                      f"{r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f})"
                      for h, r in k6.items())
          + f"; {nvidia_smi_line()}")
    return dict(rows=rows, k6=k6)


def phase_tp(torch, ops, A, DA, G, T) -> dict:
    """Tensor-parallel decode and serving on the one card: (a) the NCCL
    path at world 1 through lm_generate, generate and serve, (b) the
    tensor axis's arithmetic replayed at t = 2 and 4 (two NCCL ranks cannot
    share one card: PERF.md). Returns (a)'s launches."""
    print("== main path: tp")
    import importlib

    R = importlib.import_module("tony_tpu_torch.parallel.tp_replay")
    world_one = _tp_world_one(torch)
    with torch.no_grad():
        replay = _tp_replay(torch, ops, A, DA, G, T, R)
    print("tp " + json.dumps(dict(world_one=world_one, replay=replay,
                                  card=nvidia_smi_line())))
    return world_one["launches"]


# -------------------------------------------------------------- pipeline

# the pipeline phase. (a) create_pipeline_train_step's three schedules with
# their stages replayed in one process (collectives.ReplayWorld: every
# stage's own code, the ring's sends in memory) at the flagship's widths,
# bf16, PIPE_LAYERS layers, PIPE_BATCH: (schedule, S, V, M) of PIPE_BF16,
# each one step against the one-device step from the same parameters; (b)
# the same at float32, PIPE_F32_LAYERS layers, PIPE_F32_BATCH; (c) MoE
# (MOE_EXPERTS experts, top-2, capacity factor 1.25), float32,
# PIPE_MOE_LAYERS layers, PIPE_MOE_BATCH: the training step's loss and
# gradients replayed at expert=2 and at data=2 (the routing the global
# batch's, tokens dropped), generate replayed at tensor=2,expert=2 over
# PIPE_MOE_GEN (batch, prompt, fed steps); (d) the NCCL group of one in
# process: the pipelined step at pipe=1 and an MoE step at expert=1.
# Depth is the flagship's in (a); (b)-(d) are cut to the layers named
PIPE_LAYERS, PIPE_BATCH = N_LAYERS, (8, 2048)
PIPE_BF16 = (("gpipe", 2, 1, 4), ("gpipe", 4, 1, 4), ("1f1b", 2, 1, 4),
             ("1f1b", 4, 1, 4), ("circular", 2, 2, 4),
             ("circular", 4, 3, 8))
PIPE_BF16_LOSS_ATOL = 3e-2
PIPE_F32_LAYERS, PIPE_F32_BATCH = 4, (2, 1024)
PIPE_F32 = (("gpipe", 4, 1, 2), ("1f1b", 4, 1, 2), ("circular", 2, 2, 2))
PIPE_F32_LOSS_RTOL, PIPE_F32_PARAM_ATOL = 2e-5, 1e-4
PIPE_MOE_LAYERS, PIPE_MOE_BATCH = 2, (2, 512)
PIPE_MOE_LOSS_ATOL, PIPE_MOE_GRAD_ATOL = 2e-5, 1e-4
PIPE_MOE_GEN = (2, 512, 16)
PIPE_CUTS = ["(b) float32: 12 -> 4 layers", "(c) MoE: 12 -> 2 layers",
             "(d) world 1: (b)'s model"]


def _pipe_cfg(T, torch, layers, dtype, experts=0):
    return T.TransformerConfig(vocab_size=32768, d_model=1024,
                               n_layers=layers, n_heads=8, n_kv_heads=8,
                               d_ff=4096, dtype=dtype, n_experts=experts,
                               capacity_factor=1.25)


def _pipe_one_device(torch, ST, cfg, params, tok, tgt) -> tuple:
    """One step of the one-device bundle -> (metrics, parameters after)."""
    b = ST.create_train_step(cfg, device="cuda",
                             params=_clone_tree(torch, params))
    p, _, m = b.step_fn(b.params, b.opt_state, tok, tgt)
    return ({k: float(v) for k, v in m.items()},
            _clone_tree(torch, p))


def _pipe_replay(torch, ops, PS, cfg, params, tok, tgt, schedule, s, v, m,
                 timed_step: bool):
    """One step of create_pipeline_train_step with its S stages replayed
    -> (each stage's metrics and parameters after it, its launches; with
    ``timed_step`` a second step's wall and device ms: CUDA events around
    the replayed step, the host's gaps between launches included)."""
    from tony_tpu_torch.parallel.collectives import ReplayWorld
    from tony_tpu_torch.parallel.tp_replay import ReplayMesh

    world = ReplayWorld(s)
    bundles: list = [None] * s

    def first(r):
        b = PS.create_pipeline_train_step(
            cfg, ReplayMesh(world, r, {"pipe": s}), m, schedule=schedule,
            num_chunks=v, params=params, device="cuda")
        bundles[r] = b
        p, _, met = b.step_fn(b.params, b.opt_state, tok, tgt)
        return ({k: float(x) for k, x in met.items()},
                None if timed_step else _clone_tree(torch, p))

    ops.reset_launch_counts()
    out = world.run(first)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = dev_ms = None
    if timed_step:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        world.run(lambda r: bundles[r].step_fn(
            bundles[r].params, bundles[r].opt_state, tok, tgt))
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        dev_ms = start.elapsed_time(end)
    del bundles
    return out, counts, wall, dev_ms


def _pipe_schedules(torch, ops, T, ST, PS, dtype, layers, batch, table,
                    seed) -> list:
    """(a) or (b): each schedule of ``table`` replayed against the
    one-device step -> rows."""
    dev = torch.device("cuda")
    f32 = dtype == torch.float32
    cfg = _pipe_cfg(T, torch, layers, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init(cfg, gen, dev)
    tok, tgt = ST.synthetic_lm_batch(gen, *batch, cfg.vocab_size)
    tok, tgt = tok.contiguous(), tgt.contiguous()
    ops.reset_launch_counts()
    one, after = _pipe_one_device(torch, ST, cfg, params, tok, tgt)
    torch.cuda.synchronize()
    one_launches = ops.launch_counts()
    one_ms = None
    if not f32:
        # the one-device step's second step, timed as the replays' are
        b = ST.create_train_step(cfg, device="cuda",
                                 params=_clone_tree(torch, params))
        b.step_fn(b.params, b.opt_state, tok, tgt)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        b.step_fn(b.params, b.opt_state, tok, tgt)
        end.record()
        torch.cuda.synchronize()
        one_ms = ((time.perf_counter() - t0) * 1e3, start.elapsed_time(end))
        del b
        torch.cuda.empty_cache()
    rows = []
    for schedule, s, v, m in table:
        torch.cuda.reset_peak_memory_stats()
        stages, counts, wall, dev_ms = _pipe_replay(
            torch, ops, PS, cfg, params, tok, tgt, schedule, s, v, m,
            timed_step=not f32)
        k1 = (2 if schedule == "1f1b" else 1) * layers * m
        want = {"flash_fwd": k1, "flash_decode": 0,
                "flash_bwd_dkdv": layers * m, "flash_bwd_dq": layers * m}
        name = f"{'f32' if f32 else 'bf16'} {schedule} S={s}" + (
            f" V={v}" if schedule == "circular" else "") + f" M={m}"
        if counts != want:
            fail(f"pipeline {name}: launches {counts}, expected {want}")
        row = dict(name=name, launches=counts, step_wall_ms=wall,
                   step_device_ms=dev_ms,
                   one_device_step_ms=one_ms and dict(wall=one_ms[0],
                                                      device=one_ms[1]))
        losses = [met["loss"] for met, _ in stages]
        row["loss"], row["one_device_loss"] = losses[0], one["loss"]
        if len(set(losses)) != 1:
            fail(f"pipeline {name}: the stages' losses differ: {losses}")
        err = abs(losses[0] - one["loss"])
        if f32:
            if not err <= PIPE_F32_LOSS_RTOL * abs(one["loss"]):
                fail(f"pipeline {name}: loss {losses[0]!r} against the "
                     f"one-device {one['loss']!r} (rtol "
                     f"{PIPE_F32_LOSS_RTOL})")
            perr = 0.0
            for stage, (_, p) in enumerate(stages):
                want_l = PS.stage_layers(after["layers"], s, stage, schedule,
                                         v)
                for k, w in want_l.items():
                    perr = max(perr, float((p["layers"][k] - w).abs().max()))
                for k in ("embed", "final_norm", "unembed"):
                    perr = max(perr, float((p[k] - after[k]).abs().max()))
            row["param_max_abs_err"] = perr
            if not perr <= PIPE_F32_PARAM_ATOL:
                fail(f"pipeline {name}: parameters after one step max "
                     f"|err| {perr:.3g} against the one-device step (atol "
                     f"{PIPE_F32_PARAM_ATOL})")
        elif not err <= PIPE_BF16_LOSS_ATOL:
            fail(f"pipeline {name}: loss {losses[0]!r} against the "
                 f"one-device {one['loss']!r} (atol {PIPE_BF16_LOSS_ATOL})")
        row["loss_abs_err"] = err
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"pipeline {name}: loss {losses[0]:.6f} against one device "
              f"{one['loss']:.6f} (|err| {err:.3g}"
              + (f", parameters after a step max |err| "
                 f"{row['param_max_abs_err']:.3g}" if f32 else "")
              + f"), launches {counts} summed over the stages"
              + (f"; a second step {wall:.1f} ms wall, {dev_ms:.1f} ms "
                 f"between events (one device: {one_ms[0]:.1f} and "
                 f"{one_ms[1]:.1f})" if wall is not None else ""))
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    del params, after
    return rows, one_launches


def _moe_replay_grads(torch, ST, T, cfg, params, tok, tgt, shape, rules):
    """The MoE training step's loss and gradients (the step's own: the
    loss on the rank's tokens, its backward, the sums over the data axes)
    with the ranks of ``shape`` replayed -> each rank's (loss, {name:
    gradient}, its mesh)."""
    from tony_tpu_torch.parallel.collectives import ReplayWorld
    from tony_tpu_torch.parallel.spmd import Plan
    from tony_tpu_torch.parallel.tp_replay import ReplayMesh

    world = ReplayWorld(math.prod(shape.values()))

    def rank(r):
        mesh = ReplayMesh(world, r, shape)
        b = ST.create_train_step(cfg, mesh, rules=rules, device="cuda",
                                 params=_clone_tree(torch, params))
        plan = Plan(mesh, b.rules)
        n, i = plan.batch_size, plan.batch_rank
        rows = tok.shape[0] // n
        local = ST._local_tree(b.params, grad=True)
        names = [k for k, _ in ST._leaves(local)]
        loss = T.loss_fn(local, tok[i * rows:(i + 1) * rows],
                         tgt[i * rows:(i + 1) * rows], b.config, mesh,
                         b.rules)
        grads = list(torch.autograd.grad(loss, [p for _, p in
                                               ST._leaves(local)]))
        axes = dict(ST._leaves(T.param_logical_axes(cfg)))
        plan.reduce_grads(grads, [axes[k] for k in names])
        return float(loss), dict(zip(names, grads)), mesh, b.rules

    return world.run(rank)


def _pipe_moe(torch, ops, T, ST, G, R) -> dict:
    """(c): the MoE step's loss and gradients at expert=2 and data=2, and
    MoE decode at tensor=2,expert=2, against one device."""
    from tony_tpu_torch.parallel import (
        EP_RULES, FSDP_TP_RULES, TP_DECODE_RULES, merge_rules,
    )
    from tony_tpu_torch.parallel.sharding import local_slice, logical_to_spec

    dev = torch.device("cuda")
    cfg = _pipe_cfg(T, torch, PIPE_MOE_LAYERS, torch.float32, MOE_EXPERTS)
    gen = torch.Generator(device=dev).manual_seed(71)
    params = T.init(cfg, gen, dev)
    tok, tgt = (x.contiguous() for x in ST.synthetic_lm_batch(
        gen, *PIPE_MOE_BATCH, cfg.vocab_size))
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in ST._leaves(params)}
    tree = {"embed": leaves["embed"], "final_norm": leaves["final_norm"],
            "unembed": leaves["unembed"],
            "layers": {k.split(".", 1)[1]: p for k, p in leaves.items()
                       if k.startswith("layers.")}}
    loss = T.loss_fn(tree, tok, tgt, cfg)
    want = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    one_loss = float(loss.detach())
    axes = dict(ST._leaves(T.param_logical_axes(cfg)))
    rules = merge_rules(FSDP_TP_RULES, EP_RULES)
    out = {"one_device_loss": one_loss, "meshes": {}}
    for name, shape in (("expert=2", {"expert": 2}), ("data=2", {"data": 2})):
        res = _moe_replay_grads(torch, ST, T, cfg, params, tok, tgt, shape,
                                rules)
        gerr, lerr = 0.0, 0.0
        for loss_r, grads, mesh, rls in res:
            lerr = max(lerr, abs(loss_r - one_loss))
            for k, g in grads.items():
                w = local_slice(want[k], mesh, logical_to_spec(axes[k], rls))
                gerr = max(gerr, float((g - w).abs().max()))
        if not (lerr <= PIPE_MOE_LOSS_ATOL and gerr <= PIPE_MOE_GRAD_ATOL):
            fail(f"pipeline (c) MoE {name}: loss |err| {lerr:.3g} (atol "
                 f"{PIPE_MOE_LOSS_ATOL}), gradients max |err| {gerr:.3g} "
                 f"(atol {PIPE_MOE_GRAD_ATOL}) against one device")
        out["meshes"][name] = dict(loss_abs_err=lerr, grad_max_abs_err=gerr)
        print(f"pipeline (c) MoE step {name}: loss {res[0][0]:.6f} against "
              f"one device {one_loss:.6f} (|err| {lerr:.3g}), gradients "
              f"max |err| {gerr:.3g}")
        del res
    del leaves, tree, want
    torch.cuda.empty_cache()
    # decode: drop-free routing, the experts split over expert=2 and the
    # heads over tensor=2, against the whole model with the kernels
    dec = G.moe_dropfree(cfg)
    b, lp, n = PIPE_MOE_GEN
    prompt = torch.randint(0, cfg.vocab_size, (b, lp), generator=gen,
                           device=dev)
    with torch.no_grad():
        toks = G.generate(params, cfg, prompt, n + 1)
        fed = toks[:, :n]
        ops.reset_launch_counts()
        whole = R.decode_logits(params, dec, prompt, fed, lp + n + 1)
        torch.cuda.synchronize()
        whole_counts = ops.launch_counts()
        ops.reset_launch_counts()
        got = R.replay_tp_decode(params, dec, prompt, fed, 2, lp + n + 1,
                                 rules=merge_rules(TP_DECODE_RULES, EP_RULES),
                                 shape={"tensor": 2, "expert": 2})
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    want_counts = {k: 4 * v for k, v in whole_counts.items()}
    if counts != want_counts:
        fail(f"pipeline (c) MoE decode: launches {counts}, expected "
             f"{want_counts} (each rank's K1 and K6)")
    err = max(float((x - y).abs().max()) for x, y in zip(got[0], whole))
    ties = []
    for r in range(b):
        gaps = [float(w[r].topk(2).values[0] - w[r].topk(2).values[1])
                for w in whole]
        ties.append(_near_tie_check(
            f"pipeline (c) MoE decode row {r}",
            [int(x[r].argmax()) for x in got[0]],
            [int(x[r].argmax()) for x in whole], gaps, n + 1))
    out["decode"] = dict(launches=counts, whole_launches=whole_counts,
                         logits_max_abs_err=err, near_ties=ties)
    print(f"pipeline (c) MoE decode at tensor=2,expert=2 (B{b} x {lp} + "
          f"{n}): greedy tokens equal the meshless path's up to the top-2-"
          f"gap rule, float32 logits max |err| {err:.3g}, launches {counts} "
          f"(4 x the whole model's {whole_counts})")
    del params, whole, got
    torch.cuda.empty_cache()
    return out


def _pipe_world_one(torch, ops, T, ST, PS) -> dict:
    """(d): an NCCL group of one in this process: the pipelined step at
    pipe=1 and an MoE step at expert=1, each against the one-device step.
    -> the record, with the launches of both steps."""
    import torch.distributed as dist

    from tony_tpu_torch.parallel import (
        EP_RULES, FSDP_TP_RULES, MeshSpec, build_mesh, merge_rules,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = build_mesh(MeshSpec(fsdp=1), "cuda")
        out, launches = {}, None
        cases = (("pipe=1 gpipe", _pipe_cfg(T, torch, PIPE_F32_LAYERS,
                                             torch.float32)),
                 ("expert=1 MoE", _pipe_cfg(T, torch, PIPE_MOE_LAYERS,
                                            torch.float32, MOE_EXPERTS)))
        for name, cfg in cases:
            gen = torch.Generator(device=dev).manual_seed(5)
            params = T.init(cfg, gen, dev)
            tok, tgt = (x.contiguous() for x in ST.synthetic_lm_batch(
                gen, *PIPE_F32_BATCH, cfg.vocab_size))
            one, _ = _pipe_one_device(torch, ST, cfg, params, tok, tgt)
            ops.reset_launch_counts()
            if cfg.n_experts:
                b = ST.create_train_step(cfg, mesh, rules=merge_rules(
                    FSDP_TP_RULES, EP_RULES), params=params, device=dev)
                _, _, met = b.step_fn(b.params, b.opt_state, tok, tgt)
            else:
                b = PS.create_pipeline_train_step(cfg, mesh, 2,
                                                  params=params, device=dev)
                _, _, met = b.step_fn(b.params, b.opt_state, tok, tgt)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            loss = float(met["loss"])
            if not abs(loss - one["loss"]) <= PIPE_F32_LOSS_RTOL * abs(
                    one["loss"]):
                fail(f"pipeline (d) {name} over nccl: loss {loss!r} against "
                     f"one device {one['loss']!r}")
            if counts["flash_fwd"] == 0 or counts["flash_bwd_dq"] == 0:
                fail(f"pipeline (d) {name}: launches {counts}")
            out[name] = dict(loss=loss, one_device_loss=one["loss"],
                             launches=counts, backend=dist.get_backend())
            launches = counts if launches is None else {
                k: launches[k] + counts[k] for k in counts}
            print(f"pipeline (d) {name} over {dist.get_backend()} at world "
                  f"1: loss {loss:.6f} against one device "
                  f"{one['loss']:.6f}, launches {counts}")
            del params, b
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["launches"] = launches
    return out


def phase_pipeline(torch, ops, G, T) -> dict:
    """Pipeline schedules and expert sharding on the one card: (a), (b) the
    schedules replayed at bf16 and float32, (c) MoE's step and decode on
    replayed meshes, (d) the NCCL group of one (several NCCL ranks cannot
    share one card: PERF.md). Returns (d)'s launches."""
    print("== main path: pipeline")
    import importlib

    R = importlib.import_module("tony_tpu_torch.parallel.tp_replay")
    PS = importlib.import_module("tony_tpu_torch.train.pipeline_step")
    ST = importlib.import_module("tony_tpu_torch.train.step")
    torch.cuda.reset_peak_memory_stats()
    bf16, bf16_one = _pipe_schedules(torch, ops, T, ST, PS, torch.bfloat16,
                                     PIPE_LAYERS, PIPE_BATCH, PIPE_BF16, 61)
    f32, _ = _pipe_schedules(torch, ops, T, ST, PS, torch.float32,
                             PIPE_F32_LAYERS, PIPE_F32_BATCH, PIPE_F32, 67)
    moe = _pipe_moe(torch, ops, T, ST, G, R)
    world_one = _pipe_world_one(torch, ops, T, ST, PS)
    print("pipeline " + json.dumps(dict(
        bf16=bf16, one_device_bf16_launches=bf16_one, f32=f32, moe=moe,
        world_one=world_one, cuts=PIPE_CUTS, card=nvidia_smi_line())))
    return world_one["launches"]


# the launch phase: MNIST's steps (mnist_cuda.json's 500 cut for the
# script's time), its loss after them on its synthetic blobs (a float32 MLP
# reaches ~1e-6 within a hundred Adam steps at lr 1e-3), the memory its
# process adds to the card (a CUDA context is about 500 MB), and the
# execution timeout given a worker that sleeps
LAUNCH_MNIST_STEPS = 200
LAUNCH_MNIST_LOSS, LAUNCH_MNIST_ACC = 1e-2, 0.99
LAUNCH_CHILD_MB = 100
LAUNCH_TIMEOUT_MS = 2000
# launch (d), the elastic job: the flagship's depth cut 12 -> 2 for the
# drill's seconds (ELASTIC_CUT_LAYERS), the steps the job trains (every
# attempt to the last), the save interval, the chaos preemption's step,
# the seed whose choice preempts worker:0 (random.Random(1)), the rescale
# retry, the drain grace
ELASTIC_CUT_LAYERS = 2
ELASTIC_TOTAL_STEPS, ELASTIC_SAVE_EVERY = 16, 4
ELASTIC_PREEMPT_AT, ELASTIC_CHAOS_SEED = 6, 1
ELASTIC_RETRY_MS, ELASTIC_GRACE_MS = 3000, 10000


def _python(command: str) -> str:
    """A job file's command with its leading ``python`` as this
    interpreter."""
    return (sys.executable + command[len("python"):]
            if command.startswith("python ") else command)


def _card_memory_mb() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True, timeout=60,
        check=True).stdout
    return float(out.split()[0])


def _launch_mnist(job, metrics: Path, base_mb: float) -> dict:
    """(a)'s checks once its job ended: the loss, the accuracy, the NCCL
    group of one, the TaskMonitor's push of the card."""
    job.wait()
    m = json.loads(metrics.read_text())
    out = job.log()
    pushed = job.task_metrics()
    if (not math.isfinite(m["final_loss"])
            or m["final_loss"] > LAUNCH_MNIST_LOSS
            or m["accuracy"] < LAUNCH_MNIST_ACC):
        fail(f"launch (a): MNIST loss {m['final_loss']}, accuracy "
             f"{m['accuracy']} (want <= {LAUNCH_MNIST_LOSS}, >= "
             f"{LAUNCH_MNIST_ACC})")
    if (m["process"]["backend"] != "nccl"
            or m["process"]["num_processes"] != 1
            or "process 0/1: nccl on cuda:0, data shard 0 of 1" not in out):
        fail(f"launch (a): expected an NCCL group of one: {m['process']}")
    card = {k: pushed.get(f"max_{k}") for k in (
        "gpu_utilization_pct", "gpu_memory_used_mb", "gpu_memory_total_mb",
        "gpu_index")}
    if (None in card.values() or card["gpu_index"] != 0
            or card["gpu_memory_used_mb"] < base_mb + LAUNCH_CHILD_MB):
        fail(f"launch (a): the TaskMonitor pushed {card} (the card held "
             f"{base_mb} MB before the job; want the child's "
             f"{LAUNCH_CHILD_MB}+ MB on card 0)")
    return dict(job.record(), final_loss=m["final_loss"],
                accuracy=m["accuracy"], steps_per_sec=m["steps_per_sec"],
                time_to_first_step_s=m["time_to_first_step_s"],
                child_s={k: round(m[k], 2) for k in (
                    "import_s", "backend_and_data_s",
                    "compile_first_block_s")},
                card_before_mb=base_mb, pushed_card=card,
                heartbeat_rtt_ms={k: pushed.get(f"{k}_heartbeat_rtt_ms")
                                  for k in ("max", "avg")})


def _proc_children(pid: int) -> list:
    path = Path(f"/proc/{pid}/task/{pid}/children")
    return [int(p) for p in path.read_text().split()] if path.exists() else []


def _serve_checks(serve, job, spec, cut) -> tuple:
    """(b)'s requests: the in-process serve's answers, then the replica's
    once it published its port -> (the port, seconds to serving, the
    near-tie rows)."""
    flags = shlex.split(spec.command)
    argv = flags[flags.index("tony_tpu_torch.cli.serve") + 1:] + cut
    argv[argv.index("--port") + 1] = "0"
    payloads = [dict(prompt=p, max_new_tokens=PAGED_ID_NEW, logprobs=2,
                     timeout_s=600.0) for p in _paged_prompts()]
    app, httpd, url = _serve_app(serve, argv)
    want = _post_all(url, payloads)
    _stop_app(app, httpd)
    rpc = job.client._connect()
    deadline = time.monotonic() + 300
    while True:
        (info,) = rpc.call("get_task_infos")
        if info["ports"]:
            break
        if time.monotonic() > deadline or info["status"] in (
                "FAILED", "KILLED", "SUCCEEDED"):
            fail(f"launch (b): the replica published no serve_port: {info} "
                 f"{job.log(f'logs/{spec.name}_0.stderr')}")
        time.sleep(0.1)
    ready_s = time.perf_counter() - job.t0
    port = info["ports"]["serve_port"]
    if port != info["port"] or info["ports"]["metrics_port"] != port:
        fail(f"launch (b): published ports {info['ports']} against the "
             f"registered port {info['port']}")
    got = _post_all(f"http://{info['host']}:{port}/generate", payloads)
    parity = [_near_tie_check(
        f"launch (b) request {i}", g[1]["tokens"], w[1]["tokens"],
        [e["top"][1][0] - e["top"][1][1] for e in w[1]["logprobs"]],
        PAGED_ID_NEW) for i, (g, w) in enumerate(zip(got, want))]
    return port, ready_s, parity


def _launch_serving(serve) -> dict:
    """(b): serve_cuda.json's replica at SERVE_CUT_LAYERS layers, float32,
    against the same argv served in this process; then client.stop()."""
    from tony_tpu_torch.cluster.provisioner import _pid_alive

    cut = ["--n-layers", str(SERVE_CUT_LAYERS), "--dtype", "float32"]
    conf = _job_conf("serve", [CONFIGS / "serve_cuda.json"],
                     **{"tony.serving.healthz-interval-ms": 200})
    (spec,) = conf.role_specs()
    conf.set(f"tony.{spec.name}.command",
             _python(spec.command) + " " + " ".join(cut))
    job = _Job(conf)
    try:
        port, ready_s, parity = _serve_checks(serve, job, spec, cut)
    except BaseException:
        job.stop()
        raise
    journal = [json.loads(ln) for ln in (Path(job.client.job_dir)
               / "driver.journal.jsonl").read_text().splitlines()]
    pids = [json.loads((Path(job.client.job_dir) / "driver.json")
                       .read_text())["pid"]]
    pids += [r["pid"] for r in journal if r["op"] == "launch"]
    pids += [c for pid in pids[1:] for c in _proc_children(pid)]
    names = {}
    for pid in pids:
        try:
            names[pid] = Path(f"/proc/{pid}/cmdline").read_bytes().replace(
                b"\0", b" ").decode()[:80]
        except OSError:
            names[pid] = "?"
    t0 = time.perf_counter()
    job.stop()
    while any(map(_pid_alive, pids)) and time.perf_counter() - t0 < 60:
        time.sleep(0.05)
    left = [p for p in pids if _pid_alive(p)]
    if left:
        fail(f"launch (b): processes {[names[p] for p in left]} outlived "
             f"client.stop()")
    return dict(app_id=job.client.app_id, driver_s=round(job.driver_s, 3),
                ready_s=round(ready_s, 2),
                serve_port=port, requests=len(parity),
                equal=sum(r["diverge"] is None for r in parity),
                parity=parity, stop_s=round(time.perf_counter() - t0, 2),
                processes=names)


class _Background:
    """fn(*args) on a thread; result() joins it and re-raises its
    failure."""

    def __init__(self, fn, *args):
        import threading

        self._out, self._err = None, None
        self._thread = threading.Thread(target=self._run, args=(fn, args),
                                        daemon=True)
        self._thread.start()

    def _run(self, fn, args):
        try:
            self._out = fn(*args)
        except BaseException as e:      # re-raised by result()
            self._err = e

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


def _elastic_job():
    """(d)'s job, submitted: two world-1 workers (the generic runtime
    exports no world size), each lm_train under the elastic_cost child
    wrapper (a line a step with its loss) on the card, each with its own
    checkpoint directory; the driver's chaos preemption armed by the
    environment it starts with."""
    root = LAUNCH_DIR / "elastic"
    ckpt = root / "ckpt_$TONY_TASK_INDEX"
    argv = (FLAGSHIP + ["--n-layers", str(ELASTIC_CUT_LAYERS),
                        "--batch-size", str(TRAIN_BATCH), "--seq-len",
                        str(TRAIN_SEQ), "--device", "cuda",
                        "--step-log-every", "1", "--checkpoint-every",
                        str(ELASTIC_SAVE_EVERY), "--checkpoint-dir",
                        str(ckpt)])
    command = " ".join([sys.executable, "-m",
                        "tony_tpu_torch.tools.elastic_cost", "--child",
                        "--total-steps", str(ELASTIC_TOTAL_STEPS),
                        "--hold-file", str(root / "hold_$TONY_TASK_INDEX"),
                        "--"] + argv)
    conf = _job_conf("elastic", **{
        "tony.worker.instances": 2, "tony.worker.command": command,
        "tony.application.framework": "generic",
        "tony.worker.max-restarts": 0,
        "tony.train.elastic-enabled": True,
        "tony.train.elastic-min-instances": 1,
        "tony.train.rescale-retry-ms": ELASTIC_RETRY_MS,
        "tony.train.checkpoint-dir": str(ckpt),
        "tony.task.preempt-grace-ms": ELASTIC_GRACE_MS,
        "tony.task.heartbeat-interval-ms": 250,
        "tony.task.metrics-interval-ms": 250,
        "tony.application.timeout-ms": 600 * 1000})
    chaos = {"TONY_TEST_DRIVER_PREEMPT_AT_STEP": str(ELASTIC_PREEMPT_AT),
             "TONY_TEST_DRIVER_CHAOS_SEED": str(ELASTIC_CHAOS_SEED)}
    os.environ.update(chaos)
    try:
        return _Job(conf)
    finally:       # only this job's driver is started with them
        for k in chaos:
            os.environ.pop(k, None)


def _elastic_drive(job) -> dict:
    """(d)'s sequence, driven from here while the job runs: once the
    chaos preemption drained worker:0 (its first attempt ends 79),
    worker:1's child is held at its next step boundary (its hold file) so
    that it cannot finish while worker:0 relaunches; once worker:0's new
    attempt steps, worker:1's child is SIGKILLed (its budget is 0: the
    resize down) and its newest checkpoint recorded (the rejoin's
    prestage must read it). The driver's /metrics is scraped until the
    job ends."""
    import signal
    import urllib.request

    from tony_tpu_torch.tools.elastic_cost import parse_child

    logs = Path(job.client.job_dir) / "logs"
    hold = LAUNCH_DIR / "elastic" / "hold_1"
    info = json.loads((Path(job.client.job_dir) / "driver.json").read_text())
    url = f"http://127.0.0.1:{info['metrics_port']}/metrics"
    out = dict(metrics="", killed=None, held=None)
    deadline = time.monotonic() + 400

    def attempts(i):
        path = logs / f"worker_{i}.stdout"
        return parse_child(path.read_text()) if path.exists() else []

    while job._thread.is_alive():
        if time.monotonic() > deadline:
            job.stop()
            fail(f"launch (d): the elastic job did not end: {out}")
        w0, w1 = attempts(0), attempts(1)
        if out["held"] is None and w1 and w1[0]["end"]:
            fail(f"launch (d): worker:1's first attempt ended "
                 f"{w1[0]['end']} before worker:0 was preempted")
        if (out["held"] is None and w0 and w0[0]["end"]
                and w1 and w1[-1]["end"] is None):
            if w0[0]["end"]["rc"] != 79:
                fail(f"launch (d): worker:0's first attempt ended "
                     f"{w0[0]['end']}, expected the chaos drain (79)")
            hold.write_text("")
            out["held"] = dict(pid=w1[-1]["pid"],
                                  step=w1[-1]["steps"][-1][0]
                                  if w1[-1]["steps"] else None)
        if (out["held"] is not None and out["killed"] is None
                and len(w0) > 1 and w0[1]["steps"]):
            os.kill(out["held"]["pid"], signal.SIGKILL)
            out["killed"] = dict(t=time.time(), worker0_step=w0[1]["steps"]
                                 [-1][0], worker1_step=w1[-1]["steps"][-1][0]
                                 if w1[-1]["steps"] else None)
            time.sleep(0.5)     # its writer thread is gone with it
            hold.unlink()       # the rejoin must not wait
            root = LAUNCH_DIR / "elastic" / "ckpt_1"
            step = max(int(p.name) for p in root.iterdir()
                       if p.name.isdigit())
            out["ckpt_1"] = dict(step=step, bytes=sum(
                f.stat().st_size for f in (root / str(step)).rglob("*")
                if f.is_file()))
        try:
            with urllib.request.urlopen(url, timeout=2) as r:
                out["metrics"] = r.read().decode()
        except OSError:
            pass
        time.sleep(0.2)
    return out


def _elastic_checks(job, drive: dict) -> tuple:
    """(d)'s checks once its job ended -> (its record, the kernels'
    launches over the attempts that ended on their own)."""
    from tony_tpu_torch.cluster.provisioner import _pid_alive
    from tony_tpu_torch.tools.elastic_cost import continuity, parse_child

    job.wait()
    jd = Path(job.client.job_dir)
    if drive["killed"] is None:
        fail(f"launch (d): worker:1 was never killed: {drive}")
    workers = {i: parse_child((jd / "logs" / f"worker_{i}.stdout")
                              .read_text()) for i in (0, 1)}
    checks, launches = {}, dict.fromkeys(
        ("flash_fwd", "flash_decode", "flash_bwd_dkdv", "flash_bwd_dq"), 0)
    # the steps: none skipped, every worker to the last, and each attempt
    # that ended on its own launched K1 and K3-K5 once a layer a step
    recomputed, losses = {}, {}
    for i, atts in workers.items():
        seq = [s for a in atts for s in a["steps"]]
        steps = [s for s, _, _ in seq]
        try:
            recomputed[i] = continuity(steps)
        except AssertionError as e:
            fail(f"launch (d): worker:{i}: {e}")
        if steps[0] != 0 or steps[-1] != ELASTIC_TOTAL_STEPS - 1:
            fail(f"launch (d): worker:{i} stepped {steps}")
        for s, loss, _ in seq:
            losses.setdefault(i, {}).setdefault(s, []).append(loss)
        for a in atts:
            if a["end"] is None:
                continue
            n = len(a["steps"]) * ELASTIC_CUT_LAYERS
            want = {"flash_fwd": n, "flash_decode": 0, "flash_bwd_dkdv": n,
                    "flash_bwd_dq": n}
            if a["end"]["launches"] != want:
                fail(f"launch (d): worker:{i}'s attempt launched "
                     f"{a['end']['launches']}, expected {want}")
            for k, v in want.items():
                launches[k] += v
    checks["continuous_steps"] = recomputed
    # two straight runs: the workers' first attempts share the seed, the
    # data and the steps, so they tell whether the card repeats a run to
    # the bit; recomputed steps are then held to the bit, else within the
    # spread the two runs show
    shared = sorted(set(losses[0]) & set(losses[1]))
    spread = max(abs(losses[0][s][0] - losses[1][s][0]) for s in shared)
    worst = max(abs(x - v[0]) for w in losses.values() for v in w.values()
                for x in v)
    redone = sum(len(v) - 1 for w in losses.values() for v in w.values())
    if worst > spread or (spread == 0 and worst != 0) or not redone:
        fail(f"launch (d): recomputed losses differ by {worst} (the two "
             f"workers' straight runs by {spread}; {redone} recomputed)")
    checks["recomputed_losses"] = dict(bitwise=worst == 0, spread=spread,
                                       recomputed=redone)
    # the driver's counters, the journal, the traces
    m = drive["metrics"]
    if ("driver_gang_resizes_total 2" not in m
            or "driver_preemptions_total 1" not in m
            or "driver_task_restarts_total 0" not in m):
        fail(f"launch (d): /metrics read "
             f"{[ln for ln in m.splitlines() if '_total' in ln]}")
    checks["metrics"] = "2 resizes, 1 preemption, 0 restarts"
    journal = [json.loads(ln) for ln in
               (jd / "driver.journal.jsonl").read_text().splitlines()]
    got = [(r["op"], r.get("kind"), r.get("task"), r.get("gen"))
           for r in journal if r["op"] in ("detach", "reattach",
                                           "generation", "ledger")]
    want = [("ledger", "preempt", "worker:0", None),
            ("detach", None, "worker:1", None),
            ("generation", None, None, 1),
            ("ledger", "resize", "worker:0", None),
            ("reattach", None, "worker:1", None),
            ("generation", None, None, 2)]
    it = iter(got)
    if not all(w in it for w in want):
        fail(f"launch (d): the journal's records {got}, expected {want} "
             f"in order")
    checks["journal"] = got
    _, traces = job.history()
    tr = {t["id"]: t for t in traces}
    names = {k: [n for n, _ in v["spans"]] for k, v in tr.items()}
    a1 = tr["worker:1"]["attrs"]
    if (not {"preempting", "preempted", "resized"} <= set(names["worker:0"])
            or names["worker:0"].count("resized") != 2
            or names["worker:1"].count("resized") != 2
            or "ckpt_prestaged" not in names["worker:1"]
            or tr["worker:0"]["attrs"].get("gang_generation") != 2):
        fail(f"launch (d): trace marks {names}")
    checks["traces"] = {k: [n for n in v if n in (
        "preempting", "preempted", "resized", "ckpt_prestaged")]
        for k, v in names.items()}
    if (a1.get("prestage_step"), a1.get("prestage_bytes")) != (
            drive["ckpt_1"]["step"], drive["ckpt_1"]["bytes"]):
        fail(f"launch (d): prestaged step {a1.get('prestage_step')}, "
             f"{a1.get('prestage_bytes')} bytes; worker:1's newest "
             f"checkpoint {drive['ckpt_1']}")
    checks["prestage"] = dict(step=a1["prestage_step"],
                              bytes=a1["prestage_bytes"],
                              s=a1["prestage_s"])
    # no process left behind: the driver, every executor, every child
    pids = [json.loads((jd / "driver.json").read_text())["pid"]]
    pids += [r["pid"] for r in journal if r["op"] == "launch"]
    pids += [a["pid"] for atts in workers.values() for a in atts]
    t0 = time.perf_counter()
    while any(map(_pid_alive, pids)) and time.perf_counter() - t0 < 60:
        time.sleep(0.05)
    left = [p for p in pids if _pid_alive(p)]
    if left:
        fail(f"launch (d): processes {left} outlived the job")
    checks["processes_left"] = 0
    rec = dict(job.record(), checks=checks, killed=drive["killed"],
               held=drive["held"],
               attempts={i: [dict(world=a["world"], gen=a["gen"],
                                  first=a["steps"][0][0] if a["steps"]
                                  else None,
                                  last=a["steps"][-1][0] if a["steps"]
                                  else None,
                                  rc=a["end"]["rc"] if a["end"] else None,
                                  peak_mb=a["end"]["peak_mb"] if a["end"]
                                  else None)
                             for a in atts] for i, atts in workers.items()})
    return rec, launches


class _EarlyElastic:
    """Launch (d), submitted before the tp phase: its children start up,
    train and relaunch beside the tp and pipeline phases and launch
    (a)-(c), which the launch phase then checks it after. Its sequence
    runs on a thread of its own from its submit on (its steps must be
    watched while the other phases run); its kernels' launches are its
    children's own counts. ``base_mb``: the card's memory before it (and
    before every job of the launch phase)."""

    def __init__(self, torch):
        torch.cuda.empty_cache()
        self.base_mb = _card_memory_mb()
        self.t0 = time.perf_counter()
        self.job = _elastic_job()
        self.drive = _Background(_elastic_drive, self.job)

    def stop(self) -> None:
        """No job outlives a failed phase."""
        if self.job.client._driver_proc.poll() is None:
            self.job.stop()


def phase_launch(torch, ops, serve, early: _EarlyElastic) -> dict:
    """The port's launch path on the card (TonyClient -> driver ->
    executor -> runtime): (a) mnist_cuda.json, (b) serve_cuda.json's
    replica against an in-process serve up to the first near tie, then
    stopped, (c) a failing and a timed-out worker fail their jobs, (d) the
    elastic job (``early``: submitted before the tp phase); (a)-(c) at
    once, beside (d)'s end. Returns the launches of (d)'s children (MNIST
    and the serving engines run no kernel)."""
    print("== main path: launch")
    ops.reset_launch_counts()
    conf = _job_conf("mnist", [CONFIGS / "mnist_cuda.json"],
                     **{"tony.task.metrics-interval-ms": 250})
    (spec,) = conf.role_specs()
    metrics = LAUNCH_DIR / "mnist" / "metrics.json"
    conf.set("tony.worker.command", _python(spec.command) + f" --steps "
             f"{LAUNCH_MNIST_STEPS} --metrics-out {metrics}")
    torch.cuda.empty_cache()
    elastic, drive, base_mb = early.job, early.drive, early.base_mb
    jobs = [elastic]
    try:
        drill = _Background(_elastic_drill, LAUNCH_DIR / "elastic_drill")
        jobs.append(_Job(conf))
        jobs.append(_Job(_job_conf("exit1", **{
            "tony.worker.instances": 1, "tony.worker.command":
                f"{sys.executable} -c 'raise SystemExit(1)'"})))
        jobs.append(_Job(_job_conf("timeout", **{
            "tony.worker.instances": 1, "tony.worker.command": "sleep 600",
            "tony.task.executor.execution-timeout-ms": LAUNCH_TIMEOUT_MS})))
        _, mnist, failing, slow = jobs
        b = _launch_serving(serve)
        failing.wait("FAILED")
        slow.wait("FAILED")
        codes = [j.client.task_infos[0].exit_code for j in (failing, slow)]
        if codes != [1, 256 - 9] or slow.wall_s > 30:
            fail(f"launch (c): exit codes {codes} (want 1 and the "
                 f"SIGKILLed child's 247), the timed-out job "
                 f"{slow.wall_s:.1f} s")
        a = _launch_mnist(mnist, metrics, base_mb)
        d, d_launches = _elastic_checks(elastic, drive.result())
        d["phase_s"] = round(time.perf_counter() - early.t0, 1)
        drill = drill.result()
    except BaseException:
        for job in jobs:        # no job outlives a failed phase
            if job.client._driver_proc.poll() is None:
                job.stop()
        raise
    c = dict(exit1=failing.record(), timeout=slow.record())
    launches = {k: n + d_launches[k]
                for k, n in ops.launch_counts().items()}
    print(f"launch (a): mnist_cuda.json {a['status']} in {a['wall_s']} s "
          f"(driver up {a['driver_s']} s, executor registered "
          f"{a['executor_s']['worker:0']} s after launch), final loss "
          f"{a['final_loss']:.3g}, accuracy {a['accuracy']}, "
          f"{a['steps_per_sec']:.0f} steps/s, the child's first block "
          f"{a['time_to_first_step_s']:.1f} s ({a['child_s']}); the "
          f"TaskMonitor pushed "
          f"{a['pushed_card']}; heartbeat RTT {a['heartbeat_rtt_ms']} ms")
    print(f"launch (b): serve_cuda.json's replica serving in {b['ready_s']} "
          f"s on port {b['serve_port']} (driver up {b['driver_s']} s): "
          f"{b['equal']} of {b['requests']} requests token-equal to the "
          f"in-process serve, the rest up to its first near tie; "
          f"client.stop() left none of {len(b['processes'])} processes "
          f"after {b['stop_s']} s")
    print(f"launch (c): exit 1 -> FAILED in {c['exit1']['wall_s']} s; "
          f"execution timeout {LAUNCH_TIMEOUT_MS} ms -> FAILED (247) in "
          f"{c['timeout']['wall_s']} s")
    ck = d["checks"]
    print(f"launch (d): elastic job {d['status']} in {d['wall_s']} s "
          f"({d['phase_s']} s from its submit before the tp phase); "
          f"passed: continuous steps "
          f"(recomputed {ck['continuous_steps']}), recomputed losses "
          f"{'bit-equal' if ck['recomputed_losses']['bitwise'] else 'within the straight runs spread'} "
          f"({ck['recomputed_losses']}), /metrics {ck['metrics']}, the "
          f"journal {ck['journal']}, trace marks {ck['traces']}, prestaged "
          f"{ck['prestage']} = worker:1's newest checkpoint, "
          f"{ck['processes_left']} processes left, launches {d_launches}; "
          f"attempts {d['attempts']}")
    print(f"launch: the elastic_train drill: drained at step "
          f"{drill['drained_at']} (kept {drill['kept']}), relaunched at "
          f"{drill['resumed_at']}, {drill['recomputed']} steps recomputed, "
          f"final {drill['final']} equal to the straight run's; "
          f"{drill['wall_s']:.1f} s")
    print("launch " + json.dumps(dict(mnist=a, serving=b, failures=c,
                                      elastic=d, elastic_drill=drill,
                                      launches=launches,
                                      card=nvidia_smi_line())))
    return launches


def phase_hf(torch, ops, lm_generate, G, serve) -> dict:
    """A checkpoint in HF's layout at Llama-3.1-8B's widths (HF_CONFIG,
    HF_LAYERS layers, bf16, two shards), written here and read by the
    port's own reader: lm_generate --hf-checkpoint native and with
    --weight-dtype int8; at float32 the kernels (K1 at H32 on kvH8, K6 at
    rep 4) against the plain path, token-identical up to the plain path's
    first near-tie; serve --hf-checkpoint --weight-dtype int8 at float32
    on the ring and --paged-kv against solo int8 decoding in the server's
    order (the prompt but its last token prefilled on the cast weights,
    every token after on the int8 ones), under the near-tie rule; one bf16 engine, reported. -> the launches of the
    entry points' runs."""
    print("== HF checkpoint (Llama-3.1-8B widths)")
    import numpy as np

    from tony_tpu_torch.models.hf_import import load_hf

    out_dir = REPO / "build" / "chip_smoke"
    ckpt = out_dir / "hf_llama"
    t0 = time.perf_counter()
    nbytes = _write_hf_checkpoint(torch, ckpt)
    rec = dict(wrote=dict(bytes=nbytes, seconds=time.perf_counter() - t0))
    print(f"hf: wrote {nbytes / 1e9:.3f} GB of bf16 weights in two shards "
          f"in {rec['wrote']['seconds']:.2f} s")
    totals = dict.fromkeys(ops.launch_counts(), 0)
    rec["lm_generate"] = {}
    for wd in ("native", "int8"):
        metrics = out_dir / f"hf_{wd}.json"
        argv = ["--hf-checkpoint", str(ckpt), "--batch", "4", "--prompt-len",
                "512", "--max-new", str(HF_NEW), "--seed", "3",
                "--weight-dtype", wd, "--metrics-out", str(metrics)]
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        rc = lm_generate.main(argv)
        counts = ops.launch_counts()
        if rc != 0:
            fail(f"hf: lm_generate --weight-dtype {wd} exited {rc}")
        want = {"flash_fwd": 3 * HF_LAYERS,
                "flash_decode": 2 * HF_LAYERS * (HF_NEW - 1),
                "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
        if counts != want:
            fail(f"hf lm_generate {wd}: launches {counts}, expected {want}")
        m = json.loads(metrics.read_text())
        if len(m["tokens"]) != HF_NEW or not all(
                0 <= t < HF_CONFIG["vocab_size"] for t in m["tokens"]):
            fail(f"hf lm_generate {wd}: bad output {m['tokens']}")
        for name, n in counts.items():
            totals[name] += n
        rec["lm_generate"][wd] = dict(
            prefill_ms=m["prefill_ms"], decode_step_ms=m["decode_step_ms"],
            batch_decode_tokens_per_sec=m["batch_decode_tokens_per_sec"],
            load_s=m["hf_load_s"], load_gb_per_s=nbytes / m["hf_load_s"] / 1e9)
        print(f"hf lm_generate {wd} weights: B4 prompt 512, load "
              f"{m['hf_load_s']:.2f} s ({nbytes / m['hf_load_s'] / 1e9:.2f} "
              f"GB/s), prefill {m['prefill_ms']:.2f} ms, decode "
              f"{m['decode_step_ms']:.3f} ms/step; launches {counts}")

    gc.collect()
    torch.cuda.empty_cache()
    params, cfg = load_hf(ckpt, torch.float32)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 513, HF_REQUESTS)]
    w = G.prepare_decode(params, cfg)
    ref_cfg = dataclasses.replace(cfg, attn_impl="ref")
    rec["float32_kernels"] = []
    with torch.no_grad():
        for i, p in enumerate(prompts[:4]):
            ops.reset_launch_counts()
            got, _ = _solo_greedy(torch, G, w, cfg, p, HF_NEW)
            kern = ops.launch_counts()
            want_toks, gaps = _solo_greedy(torch, G, w, ref_cfg, p, HF_NEW)
            if (kern["flash_fwd"] != HF_LAYERS or kern["flash_decode"]
                    != HF_LAYERS * (HF_NEW - 1)
                    or ops.launch_counts() != kern):
                fail(f"hf float32 request {i}: kernel launches {kern}, then "
                     f"{ops.launch_counts()} after the plain path")
            rec["float32_kernels"].append(_near_tie_check(
                f"hf float32 kernels, request {i}", got, want_toks, gaps,
                HF_NEW))
        del w
        w8 = G.prepare_decode(params, cfg, weight_dtype="int8")
        solo = [_solo_greedy(torch, G, w8, cfg, p, HF_NEW,
                             server_order=True) for p in prompts]
    del w8, params
    gc.collect()
    torch.cuda.empty_cache()
    payloads = [{"prompt": p, "max_new_tokens": HF_NEW} for p in prompts]
    rec["serve"] = {}
    for dtype, engine, extra in (("float32", "ring", []),
                                 ("float32", "paged", ["--paged-kv"]),
                                 ("bfloat16", "ring", [])):
        argv = ["--hf-checkpoint", str(ckpt), "--dtype", dtype,
                "--weight-dtype", "int8", "--vocab",
                str(HF_CONFIG["vocab_size"])] + extra
        t0 = time.perf_counter()
        app, httpd, url = _serve_app(serve, argv)
        ready_s = time.perf_counter() - t0
        try:
            ops.reset_launch_counts()
            res = _post_all(url, payloads)
            counts = ops.launch_counts()
        finally:
            _stop_app(app, httpd)
        for name, n in counts.items():
            totals[name] += n
        toks = [body["tokens"] for _, body, _ in res]
        row = dict(ready_s=ready_s, wall_s=max(r[2] for r in res),
                   launches=counts,
                   equal_solo=sum(t == s for t, (s, _) in zip(toks, solo)))
        if dtype == "float32":
            row["near_tie"] = [
                _near_tie_check(f"hf serve {engine} request {i}", t, s, g,
                                HF_NEW)
                for i, (t, (s, g)) in enumerate(zip(toks, solo))]
        else:
            row["shared_with_float32_solo"] = [
                next((j for j, (a, b) in enumerate(zip(t, s)) if a != b),
                     len(t)) for t, (s, _) in zip(toks, solo)]
        rec["serve"][f"{dtype} {engine}"] = row
        held = ("every one up to its first near-tie" if dtype == "float32"
                else "reported: bf16 against the float32 solo")
        print(f"hf serve --hf-checkpoint --weight-dtype int8 ({dtype}, "
              f"{engine}): {len(res)} requests answered, {row['equal_solo']} "
              f"of {len(res)} equal to float32 solo int8 decoding in the "
              f"server's order ({held}); ready in {ready_s:.2f} s; launches "
              f"{counts}")
    shutil.rmtree(ckpt, ignore_errors=True)
    rec.update(launches=totals, card=nvidia_smi_line())
    print("hf " + json.dumps(rec))
    return totals


def phase_serving_parity(torch, G, T) -> None:
    """Flagship width at 2 layers in float32 on the card: 8 requests
    through 3 slots (re-admission), batched and per-slot admission,
    against the port's generate run solo (its kernels) on the card."""
    print("== parity: serving")
    import numpy as np

    from tony_tpu_torch.models import serving as S

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    w = G.prepare_decode(T.init(cfg, torch.Generator(device=dev)
                                .manual_seed(9), dev), cfg)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 32768, int(n)).tolist()
               for n in rng.integers(64, 513, 8)]
    n_new = 32
    solo = []
    for i, p in enumerate(prompts):
        toks, gaps = _solo_greedy(torch, G, w, cfg, p, n_new)
        ref = G.generate(w, cfg, torch.tensor([p], device=dev), n_new)
        if ref[0].tolist() != toks:
            fail("serving parity: the solo loop differs from generate")
        solo.append((toks, gaps))
        for j, g in enumerate(gaps):
            if g < PARITY_NEAR_TIE:
                print(f"serving parity: request {i} step {j}: solo top-2 "
                      f"gap {g:.3g} (a near-tie)")
    rows = []
    for batched in (True, False):
        eng = S.SlotServer(w, cfg, slots=3, max_len=1024,
                           batched_admission=batched)
        reqs = [S.Request(prompt=p, max_new_tokens=n_new) for p in prompts]
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        for i, (r, (toks, gaps)) in enumerate(zip(reqs, solo)):
            got = done[r.id].tokens
            near = [j for j, g in enumerate(gaps) if g < PARITY_NEAR_TIE]
            first_near = near[0] if near else n_new
            diverge = next((j for j, (a, b) in enumerate(zip(got, toks))
                            if a != b), None)
            rows.append(dict(batched=batched, request=i, diverge=diverge,
                             near_ties=[(j, gaps[j]) for j in near]))
            if len(got) != n_new or (diverge is not None
                                     and diverge < first_near):
                fail(f"serving parity ({'batched' if batched else 'per-slot'}"
                     f" admission): request {i} diverges from solo at step "
                     f"{diverge}, its first near-tie at {first_near}")
    agree = sum(r["diverge"] is None for r in rows)
    print(f"serving parity: {agree} of {len(rows)} streams token-identical to "
          f"solo generate (float32, card); every other one diverges only at "
          f"or after a near-tie (gap < {PARITY_NEAR_TIE})")
    print("serving_parity " + json.dumps(rows))


def _leaf_copies(torch, params, device, dtype=None):
    return {k: _leaf_copies(torch, v, device, dtype) if isinstance(v, dict)
            else v.detach().to(device, dtype).requires_grad_()
            for k, v in params.items()}


def phase_train_parity(torch, T) -> None:
    """Flagship width at 2 layers, one batch of 2 x 256 tokens, from the
    same float32 weights: the loss and every gradient of the card's kernel
    path (bf16) against the CPU's plain path in float32, and against the
    card's own plain path (attn_impl="ref", bf16)."""
    print("== parity: training")
    from tony_tpu_torch.train.step import _leaves

    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(5)
    params = T.init(cfg, gen, "cpu")
    tokens = torch.randint(0, 32768, (2, 256), generator=gen)
    targets = torch.randint(0, 32768, (2, 256), generator=gen)

    def loss_and_grads(c, device):
        p = _leaf_copies(torch, params, device)
        names, leaves = zip(*_leaves(p))
        loss = T.loss_fn(p, tokens.to(device), targets.to(device), c)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), names, [g.float().cpu() for g in grads]

    dev = torch.device("cuda")
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    want_loss, names, want = loss_and_grads(cfg, "cpu")
    before = _kernel_launch_total(torch)
    got_loss, _, got = loss_and_grads(bcfg, dev)
    if _kernel_launch_total(torch) - before < 3 * cfg.n_layers:
        fail("training parity: the card's kernel path did not run the "
             "flash kernels")
    plain_loss, _, plain = loss_and_grads(
        dataclasses.replace(bcfg, attn_impl="ref"), dev)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    e_cpu = {n: rel(g, w) for n, g, w in zip(names, got, want)}
    e_plain = {n: rel(g, w) for n, g, w in zip(names, got, plain)}
    worst_cpu, worst_plain = max(e_cpu.values()), max(e_plain.values())
    print(f"training parity: loss cpu f32 {want_loss:.5f}, card kernels bf16 "
          f"{got_loss:.5f}, card plain bf16 {plain_loss:.5f} (atol "
          f"{TRAIN_PARITY_LOSS_ATOL}); worst gradient relative norm error "
          f"card kernels vs cpu f32 {worst_cpu:.4f} "
          f"({max(e_cpu, key=e_cpu.get)}), vs card plain {worst_plain:.4f} "
          f"({max(e_plain, key=e_plain.get)}) (limit "
          f"{TRAIN_PARITY_GRAD_RTOL})")
    print("train_parity " + json.dumps(dict(
        loss_cpu_f32=want_loss, loss_card_kernels=got_loss,
        loss_card_plain=plain_loss, grad_rel_err_vs_cpu=e_cpu,
        grad_rel_err_vs_card_plain=e_plain)))
    if (abs(got_loss - want_loss) > TRAIN_PARITY_LOSS_ATOL
            or abs(got_loss - plain_loss) > TRAIN_PARITY_LOSS_ATOL):
        fail("training parity: the card's loss differs")
    if not all(map(math.isfinite, e_cpu.values())) or \
            max(worst_cpu, worst_plain) > TRAIN_PARITY_GRAD_RTOL:
        fail("training parity: the card's gradients differ")


def _kernel_launch_total(torch) -> int:
    from tony_tpu_torch import ops

    c = ops.launch_counts()
    return c["flash_fwd"] + c["flash_bwd_dkdv"] + c["flash_bwd_dq"]


def _profile_rows(prof, n):
    """(device ms per step, top kernels, the port's kernels) from a
    torch.profiler run over n steps; device kernels only, less a device
    sleep queued ahead of the steps."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0 \
                and "spin" not in e.key:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    top = [dict(kernel=k[:80], ms_per_step=us / 1e3 / n, calls_per_step=c / n)
           for us, k, c in rows[:10]]
    port = {}
    for us, k, c in rows:
        m = re.search(r"(flash_\w+|decode_\w+)_kernel", k)
        if m:
            port[m.group(1)] = dict(ms_per_step=us / 1e3 / n,
                                    calls_per_step=c / n)
    return sum(r[0] for r in rows) / 1e3 / n, top, port


def phase_train_profile(torch, T) -> None:
    """Where a flagship training step's time goes (batch 8 x 2048): host
    wall time against the device time the profiler records, with remat
    off and under each policy (the flash forward's calls a step read from
    the profile)."""
    import dataclasses

    base = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=12,
                               n_heads=8, n_kv_heads=8, d_ff=4096,
                               max_seq_len=TRAIN_SEQ)
    rows = {}
    for policy in (None,) + REMAT_POLICIES:
        # the remat policies at TRAIN_PROFILE_REMAT_LAYERS (the remat
        # phase runs them at the flagship's depth)
        cfg = dataclasses.replace(
            base, remat=policy is not None, remat_policy=policy or "full",
            n_layers=N_LAYERS if policy is None
            else TRAIN_PROFILE_REMAT_LAYERS)
        rows[policy or "off"] = _train_step_profile(torch, cfg, policy)
    print("remat_profile " + json.dumps(rows))


def _train_step_profile(torch, cfg, policy, batch=TRAIN_BATCH,
                        seq=TRAIN_SEQ, name=None) -> dict:
    name = name or f"training step (remat {policy or 'off'})"
    print(f"== profile: {name}")
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch import train

    gc.collect()
    torch.cuda.empty_cache()
    bundle = train.create_train_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens, targets = train.synthetic_lm_batch(gen, batch, seq, 32768)

    def steps(n):
        for _ in range(n):
            bundle.step_fn(bundle.params, bundle.opt_state, tokens, targets)
        torch.cuda.synchronize()

    steps(1)                                    # warm
    # timed steps (3 until the observability checks needed the time)
    n = 2
    t0 = time.perf_counter()
    steps(n)
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dev_ms, top, port = _profile_rows(prof, 1)
    del bundle
    if not top:
        print(f"profile: {name} {wall_ms:.3f} ms wall; device time not "
              "measured (the profiler recorded no device activity)")
        return dict(wall_ms=wall_ms, device_ms=None, peak_gb=peak_gb)
    print(f"profile: {name} B{batch} L{seq}: {wall_ms:.3f} ms "
          f"wall, {dev_ms:.3f} ms on the device, busy share "
          f"{dev_ms / wall_ms:.3f}, peak memory {peak_gb:.1f} GB")
    if policy is None and cfg.n_experts == 0:
        print("train_profile_top " + json.dumps(top))
        print("train_profile_port " + json.dumps(port))
    return dict(wall_ms=wall_ms, device_ms=dev_ms, peak_gb=peak_gb,
                port_kernels=port, top=top)


def phase_parity(torch, G, T) -> None:
    """Flagship width at 2 layers, from the same weights and tokens: the
    card's kernel path (bf16) against the CPU's plain path in float32, and
    against the card's own plain path (attn_impl="ref", bf16)."""
    print("== parity")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=2,
                              n_heads=8, n_kv_heads=8, d_ff=4096,
                              dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    params = T.init(cfg, gen, "cpu")
    prompt = torch.randint(0, 32768, (1, 256), generator=gen)
    dev = torch.device("cuda")
    gcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    gparams = G.prepare_decode(
        {k: ({n: w.to(dev) for n, w in v.items()} if isinstance(v, dict)
             else v.to(dev)) for k, v in params.items()}, gcfg)
    cpu_prep = G.prepare_decode(params, cfg)

    ref_tokens = G.generate(cpu_prep, cfg, prompt, 16)
    gpu_tokens = G.generate(gparams, gcfg, prompt.to(dev), 16).cpu()
    agree = int((ref_tokens == gpu_tokens).long().cumprod(-1).sum())

    # teacher-forced logits: prefill (flash forward kernel) and 15 decode
    # steps (flash decode kernel) fed the CPU's greedy tokens
    def forced(w, c, device):
        cache = G.init_cache(c, 1, 272, device=device)
        logits, cache = G._forward_with_cache(w.params, c, prompt.to(device),
                                              cache, w.fused, prefill=True)
        out = [logits.float().cpu()]
        for t in ref_tokens[0, :-1]:
            logits, cache = G._forward_with_cache(
                w.params, c, t.view(1, 1).to(device), cache, w.fused)
            out.append(logits.float().cpu())
        return torch.cat(out)

    want = forced(cpu_prep, cfg, "cpu")
    got = forced(gparams, gcfg, dev)
    plain = forced(gparams, dataclasses.replace(gcfg, attn_impl="ref"), dev)
    err = (got - want).abs().max(dim=-1).values
    err_plain = float((got - plain).abs().max())
    print(f"parity: logits std {float(want.std()):.3f}; max |card bf16 - cpu "
          f"f32| prefill {float(err[0]):.4f}, decode steps "
          f"{float(err[1:].max()):.4f} (atol {PARITY_LOGITS_ATOL}); max "
          f"|card kernels - card plain| {err_plain:.4f} (atol "
          f"{KERNEL_PATH_ATOL}); greedy agreement {agree}/16 tokens")
    if not torch.isfinite(got).all() or float(err.max()) > PARITY_LOGITS_ATOL:
        fail("parity: card logits differ from the CPU float32 plain path")
    if err_plain > KERNEL_PATH_ATOL:
        fail("parity: the card's kernel path differs from its plain path")


def phase_profile(torch, G, T) -> None:
    """Where a flagship decode step's time goes: host wall time against the
    device time the profiler records, batch 8 with 2048 cached positions.
    Prints "not measured" if the profiler sees no device activity."""
    print("== profile: decode step")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(vocab_size=32768, d_model=1024, n_layers=12,
                              n_heads=8, n_kv_heads=8, d_ff=4096)
    gen = torch.Generator(device=dev).manual_seed(11)
    w = G.prepare_decode(T.init(cfg, gen, dev), cfg)
    prompt = torch.randint(0, 32768, (8, 2048), generator=gen, device=dev)
    cache = G.init_cache(cfg, 8, 2048 + 128, device=dev)
    logits, cache = G._forward_with_cache(w.params, cfg, prompt, cache,
                                          w.fused, prefill=True)
    tok = logits.argmax(-1)[:, None]

    def steps(n, cache):
        for _ in range(n):
            logits, cache = G._forward_with_cache(w.params, cfg, tok, cache,
                                                  w.fused)
        torch.cuda.synchronize()
        return cache

    cache = steps(4, cache)                     # warm
    n, walls = 16, []
    for _ in range(5):      # host-clock times spread: five rounds of n steps
        t0 = time.perf_counter()
        cache = steps(n, cache)
        walls.append((time.perf_counter() - t0) * 1e3 / n)
    wall_ms = sorted(walls)[len(walls) // 2]
    print("profile: decode step wall ms over 5 rounds of 16 steps: "
          + " ".join(f"{w:.3f}" for w in walls) + f" (median {wall_ms:.3f})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cache = steps(n, cache)
    dev_ms, top, port = _profile_rows(prof, n)
    if not top:
        print(f"profile: decode step {wall_ms:.3f} ms wall; device time not "
              "measured (the profiler recorded no device activity)")
        return
    print(f"profile: decode step B8 with 2048 cached: {wall_ms:.3f} ms wall, "
          f"{dev_ms:.3f} ms on the device, busy share {dev_ms / wall_ms:.3f}")
    print("profile_top " + json.dumps(top))
    print("profile_port " + json.dumps(port))


def main() -> int:
    import faulthandler

    import torch

    # a crash inside a native library (the profiler, CUDA) prints every
    # thread's Python stack before the process dies
    faulthandler.enable()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from tony_tpu_torch import ops
    from tony_tpu_torch.cli import serve
    from tony_tpu_torch.examples import lm_generate, lm_train
    from tony_tpu_torch.models import generate as G
    from tony_tpu_torch.models import transformer as T
    from tony_tpu_torch.ops import _build
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import decode_attention as DA

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    compiled = timed("card", phase_card, _build)

    with torch.no_grad():
        records = timed("kernels", phase_kernels, torch, A)
        records += timed("decode_kernel", phase_decode, torch, DA, G, T)
        records += timed("bwd_kernels", phase_bwd_kernels, torch, A)
    gen_launches = timed("generation", phase_main_path, torch, ops,
                         lm_generate, G, T)
    train_launches, train_losses, *train_costs = timed(
        "training", phase_train_path, torch, ops, lm_train)
    remat_launches = timed("remat", phase_remat, torch, ops, lm_train, A,
                           (train_losses, *train_costs))
    serve_launches, run_a = timed("serving", phase_serving, torch, ops)
    ckpt_launches = timed("checkpoint", phase_checkpoint, torch, ops,
                          lm_train, lm_generate, train_losses)
    prefix_launches, prefix_admit = timed("prefix_cache", phase_prefix_cache,
                                          torch, ops)
    replay_launches = timed("replay", phase_replay, torch, ops)
    stream_launches, base_block = timed("streaming", phase_streaming, torch,
                                        ops, run_a)
    paged_launches = timed("paged", phase_paged, torch, ops, run_a,
                           prefix_admit)
    telemetry_launches = timed("telemetry", phase_telemetry, torch, ops,
                               run_a, base_block)
    disagg_launches = timed("disagg", phase_disagg, torch, ops)
    hf_launches = timed("hf", phase_hf, torch, ops, lm_generate, G, serve)
    spec_launches = timed("speculative", phase_speculative, torch, ops,
                          lm_train, lm_generate, serve, G, T)
    moe_launches = timed("moe", phase_moe, torch, ops, lm_train, lm_generate,
                         A, G, T)
    mesh_launches = timed("mesh", phase_mesh, torch, ops, A, train_losses)
    # launch (d) runs from here on, beside the tp and pipeline phases
    early = _EarlyElastic(torch)
    try:
        tp_launches = timed("tp", phase_tp, torch, ops, A, DA, G, T)
        pipe_launches = timed("pipeline", phase_pipeline, torch, ops, G, T)
    except BaseException:
        early.stop()
        raise
    launch_launches = timed("launch", phase_launch, torch, ops, serve, early)
    launches = {k: gen_launches[k] + train_launches[k] + remat_launches[k]
                + serve_launches[k] + ckpt_launches[k] + prefix_launches[k]
                + replay_launches[k] + stream_launches[k]
                + paged_launches[k] + telemetry_launches[k]
                + disagg_launches[k] + hf_launches[k] + spec_launches[k]
                + moe_launches[k] + mesh_launches[k] + tp_launches[k]
                + pipe_launches[k] + launch_launches[k] for k in gen_launches}
    print("launches_by_phase " + json.dumps(dict(
        generation=gen_launches, training=train_launches,
        remat=remat_launches, serving=serve_launches,
        checkpoint=ckpt_launches, prefix_cache=prefix_launches,
        replay=replay_launches, streaming=stream_launches,
        paged=paged_launches, telemetry=telemetry_launches,
        disagg=disagg_launches, hf=hf_launches, speculative=spec_launches,
        moe=moe_launches, mesh=mesh_launches, tp=tp_launches,
        pipeline=pipe_launches, launch=launch_launches)))
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched {name}")
    for r in records:
        r["launches"] = launches[r["name"]]
        mma = (f"{r['name']}_mma_kernel<128>" if r["name"] != "flash_decode"
               else "flash_decode_kernel<bf16,bf16,128,1>")
        if mma in compiled:
            n_regs, st, ld, hmma = compiled[mma]
            r.update(registers_d128_bf16=n_regs, spill_bytes_d128_bf16=st + ld,
                     hmma_d128_bf16=hmma)
    timed("parity", phase_parity, torch, G, T)
    timed("train_parity", phase_train_parity, torch, T)
    timed("serving_parity", phase_serving_parity, torch, G, T)
    with torch.no_grad():
        timed("profile", phase_profile, torch, G, T)
    timed("train_profile", phase_train_profile, torch, T)
    PHASE_SECONDS["total"] = round(time.perf_counter() - t0, 1)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tolerance", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "design", "tflops", "registers_d128_bf16",
            "spill_bytes_d128_bf16", "hmma_d128_bf16", "d32")
    for r in records:
        r["kernel_ms"] = r["ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys + ("library",)
                                   if k in r} for r in records]}))
    print("phase_seconds " + json.dumps(PHASE_SECONDS))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
