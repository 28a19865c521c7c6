#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--n 50000] [--J 50000] [--layers 24]
                          [--zamba-layers 54]

1. Prints the card (name and power limit from nvidia-smi) and the torch
   and CUDA versions.
2. Builds the port's CUDA kernels from the checkout with nvcc (one
   process per source, all at once) and prints the build time and the
   ``-Xptxas -v`` report.
3. The STRADS Lasso round.  Builds the data on the card (dense f32 X of
   n × J, the recipe of ``synthetic_correlated``, from ``--seed``), then
   holds ``lasso_partial`` and ``gram_block`` against their plain
   versions at the main path's shapes, at ragged ones and on views one
   element past 16-byte alignment and times them (``gram_block`` also at
   the ``scan_w1`` run's (1, n, 128), with ``matmul`` beside it), prints
   the registers and spills of both kernels, and times the floor of a
   kernel node (one ``add_`` on one element in a CUDA graph).
   Drives the main path through the port's entry points: the plan
   ``examples/plans/lasso_pallas.json`` as checked in (scan, 16 rounds,
   W = 4, the CUDA kernels), the same plan on the loop executor, on
   W = 1, and with ``kind="reference"``.  It checks that both kernels
   were launched, that loop ≡ scan bit for bit, that the other runs agree
   within the stated tolerance and that the objective is finite and
   falls.  Then the pipelined executor and the checkpoints
   (``lasso_pipelined_phase``, ``lasso_loadbal_phase``): the plan
   ``examples/plans/pipelined.json`` as checked in (the launch counts
   it implies, 17 ``gram_block`` for 16 ``lasso_partial``; split 8 + 8
   through the carry, equal to the bit; within STATE_TOL of the plain
   kernels; round 0 on scan's schedule, the later rounds compared with
   scan's; the objective descending every round) and
   ``examples/plans/lasso_loadbal.json`` with a temporary ``ckpt_dir``
   (4 files; the rebalances' versions and load spreads; the host ms of
   a boundary and the files' bytes and write ms; equal to the scan run
   to the bit; a fresh engine resumed from step 8's file equal to the
   bit).  Then the SSP executor (``lasso_ssp_phase``): the plan
   ``examples/plans/ssp_s2.json`` as checked in (12 rounds, s = 2,
   W = 4; 12 ``gram_block`` and 12 ``lasso_partial``; the staleness
   histogram [4, 4, 4]; within STATE_TOL of the plain kernels; s = 0
   equal to scan to the bit; timed alternately with scan, 6 runs
   each).  Then telemetry (``lasso_counters_phase``): ``ssp_s2.json``
   with device counters (still 12 and 12 launches, equal to the
   uninstrumented run to the bit; 12 rounds, proposed 12 × 128 = accepted
   + killed, sched_size = accepted, the histogram [4, 4, 4]) and 16 scan
   rounds with counters and without, timed alternately (6 runs each).
   Then serving (``lasso_serve_phase``): ``serve_ssp.json`` (24 rounds,
   s = 2) through ``serve_while_training`` with 64 ``predict`` requests,
   stale (max staleness 4: reads at 0 and 3) and snapshot; the trained
   state equal to an unserved run to the bit; each ŷ against xᵀβ in f64
   at the clock it read.  Then times where a round goes, a profiler
   window, and ``lasso_loadbal.json`` traced (``lasso_trace_phase``:
   ``kind="trace", profiler=True``: strictly nested spans, a
   ``rebalance`` instant at each move with the spreads printed above, a
   ``checkpoint`` span every 4 rounds, a ``record_function`` range a
   span in the profiler, the Chrome trace in
   ``build/lasso_loadbal.trace.json``, host ms by span name), and runs
   the repo's convergence check (``tests/test_lasso.py``) on the card at
   a small size.  Streaming (``lasso_stream_phase``, after serving):
   ``lasso_pallas.json`` with ``StreamSpec("replace", ingest_every=4)``
   and ``LassoDriftSource(rows_per_ingest=512)`` (boundaries 4, 8, 12),
   each run from the original data: an EmptySource run equal to the
   unstreamed one, 16 and 16 launches, loop, card-tensor deltas, a
   checkpointed run and a fresh engine resumed from step 8 through
   ``replay_data`` equal to the bit, the reference within STATE_TOL,
   r = y − Xβ in f64 at the end, the ``ingest`` span's host ms; then
   ``serve_ssp.json`` served with the stream every window (3 rounds),
   its training equal to the unserved streamed run's.
4. STRADS MF at the Netflix Prize shape: 17,770 movies, 1.18 % of the
   entries observed, the users cut to MF_USERS (131,072: the dense
   layout holds A, the mask and R, 9.3 GB each), rank 40, λ = 0.05, W = 4,
   planted rank 20, data made on the card from ``--seed``.  One sweep
   (80 rounds) on scan, then on loop and on pipelined (each equal to
   the bit: the round-robin schedule reads no state), a checkpointed
   ``load_balanced`` sweep (``mf_checkpoint_run``: two files of 9.3 GB,
   equal to scan, and a fresh engine resumed from the middle file equal
   too), on the SSP executor at s = 1 (equal to scan to the bit) and at
   s = 2 over 78 rounds beside scan over as many (the objective falls;
   the peak memory within 1 GB of scan's), a sweep with device counters
   (equal to scan to the bit, [40, 40] rounds a phase, its rate within
   OBS_RATE_TOL of scan's), 256 ``recommend`` requests served over an
   ``ssp`` sweep at s = 1 (training equal to scan; each batch's top-k
   against an f64 recount of W_u·H), then at W = 1 (within
   MF_W_TOL); the objective falls every
   round within MF_MONO_TOL; rounds/s, the peak memory and a profiler
   window of 4 rounds; then ALS (2 iterations) beside STRADS on the
   first 8,192 users.  Streaming (``mf_stream_runs``): a sweep with
   ``StreamSpec("extend", ingest_every=8)`` and 256 drifting users a
   boundary (9 boundaries), its peak within STREAM_PEAK_GB of the
   unstreamed sweep's, the cursor and the rows the ring gives, R in f64
   on the ingested rows just after each boundary, loop equal to scan;
   ``replace`` on ssp at s = 1 equal to scan.  MF runs plain torch ops: it has no kernel.
5. STRADS LDA at the UCI NYTimes shape: 299,776 documents (2,342 a
   worker), 102,660 words, 99.5 M tokens (777,344 a worker), K = 1,000,
   W = 128 workers, a planted corpus made on the card from ``--seed``.
   ``lda_gibbs`` against its plain version at the chip shape on round 0
   with one explicit Gumbel tensor (z, B, D and s̃ equal to the bit; a
   difference is reported with its top-2 margin and fails), at ragged
   shapes (K = 1, 7, 33 and K = 2,049, 3,000, 4,500, 16,384, where the
   kernel's ring depth is 6, 4, 2 and 0; a worker with no active token,
   one with a single document, an unaligned B) in both noise modes, for
   STRADS's rotation and for the baseline's one block over the
   vocabulary on replicas of B, and at K = 1,000 on a corpus of runs of
   one word in one document (each token changes the rows the next ones
   read); the sampler's Philox draws are Gumbel (10⁸ of the
   plain version's, made on the card: mean within 1e-3 of γ, variance
   within 1e-2 of π²/6).  Then the main path:
   one rotation (128 rounds) on scan and on loop, with the launch counts
   set to 0 just before and read after (128 each), equal to the bit, and
   on pipelined (counts set to 0 again: 128; equal to scan to the bit,
   as the rotation reads no state), and on the SSP executor at s = 0
   (128 launches, equal to scan to the bit) and at s = 2 over lcm(3,
   128) = 384 rounds (384 launches; D, B, s recounted from z, s the
   column sums of B, the log-likelihood up) beside scan over as many;
   D, B, s recounted from z equal to the state; the log-likelihood up;
   z in [0, K); every count below 2²⁴.  Then a rotation with device
   counters (equal to scan, 128 ones a phase, its rate within
   OBS_RATE_TOL of scan's) and 256 rounds served with a snapshot at each
   rotation and 64 ``infer_topics`` requests of held-out documents
   (``lda_obs_serve``: training equal to an unserved run; every pin
   unchanged after the next rotations' in-place writes; θ against an f64
   fold-in from the pin).  Then ``python -m repro_torch.launch.serve
   --engine lda --requests 32 --trace build/serve.trace.json`` as a
   subprocess (``serve_cli_run``), which must exit 0.  The kernel timed at round 0's
   shape against two bounds: the roofline (the distinct B and D rows the
   round touches read once at 3.35 TB/s, or its operations at 67
   TFLOP/s with each logf at the cost of its SASS, the larger), the
   chain (the longest chain times one step at K = 1) and the longest
   chain's operations on one SM (``worker_ops_floor_ms``), and once more
   on round 0's first sweep from the planted start, where nearly every
   token changes topic; a profiler window of 4
   rounds that must hold every launch; the Philox kernel's
   log-likelihood after a rotation within LDA_BAND of the plain
   version's with torch's draws, at a smaller size; the data-parallel
   baseline (1 round, W = 16) beside one STRADS rotation on the first
   eighth of the corpus, its sweep first held against the plain version
   to the bit at its chip shape (the leading 2,048 tokens of 4
   workers).  Streaming (``lda_stream_runs``): two rotations with
   ``StreamSpec("extend", ingest_every=128)`` and 65,536 drifting
   tokens at t = 128: 256 launches, D, B, s recounted from (words, z),
   counts below 2²⁴, loop equal to scan, the index rebuild and the
   first round after the boundary timed; ``replace`` served with a
   snapshot at 0, 128, 256, its training equal to the unserved run's.
   Then ``launch.serve --engine lda --stream --requests 32`` as a
   subprocess (``serve_cli_stream_run``): exit 0, rows ingested.
6. Model-zoo serving of Phi-3.5-MoE at its published widths, depth cut to
   ``--layers`` (24 of 32: the bf16 weights must fit the card), through
   the port's ``launch/serve_lm``: batch 4, prompt 1,024, 32 greedy
   tokens.  First a prefill and one decode step in which every launch of
   ``flash_attention`` and ``topk_gating`` is held against its plain
   version on the same inputs; then both kernels against their plain
   versions at the shapes of layer 0 (its real q, k, v and router
   logits) and at ragged ones, timed, with SDPA beside attention; then
   the main path (``Server.generate``) with the launch counts set to 0
   just before and read just after (24 and 792; every gating launch of
   a main path, a sort prefill and a training run on the kernels'
   vector route, ``gating_routes``); then the same prefill
   and first decode step with the plain versions, and with a float64
   attention as a control of how far a 24-layer bf16 model amplifies
   rounding; then the prefill with ``moe_impl="sort"`` on the same
   weights (``sort_prefill``: every launch against its plain version,
   24 + 24 launches a prefill, two prefills equal to the bit, prefill ms
   in turns with the einsum dispatch); then profiler windows over a
   prefill and 4 decode steps.
7. The same model in float32 with two layers, at full width: the first
   token and the logits of the prefill and the first decode step with the
   kernels equal those with the plain versions, within the stated
   tolerance, and the sort dispatch's logits and tokens those of the
   einsum one.
8. Model-zoo serving of Zamba2-2.7B at its published widths and full
   depth (54 mamba layers, the shared attention block applied 9 times),
   bf16, after the Phi-3.5-MoE weights are freed: batch 4, prompt 1,000
   (longer than 128 and not a multiple of it, so every mamba layer of a
   prefill runs ``ssm_scan``), 32 greedy tokens.  First a prefill and a
   decode step in which every launch of ``ssm_scan`` and
   ``flash_attention`` is held against its plain version on the same
   inputs; then ``ssm_scan`` timed at layer 0's real inputs and checked
   at ragged shapes, and ``flash_attention`` timed at the shared block's
   first real inputs (head dim 80), with SDPA beside it; then the main path (``Server.generate``) with the
   counts set to 0 just before and read just after (54 ``ssm_scan``, 9
   ``flash_attention``: the prefill's; decode runs neither); the same
   prefill and first decode step with the plain versions (printed, not
   asserted: a bf16 model at depth amplifies rounding); profiler windows
   over a prefill and 4 decode steps.
9. Zamba2-2.7B in float32 with 12 layers (2 groups, so the shared
   block's cache is stacked over 2 applications), at full width: logits
   within the stated tolerance, kernels against plain versions, and the
   first tokens equal in every row that f32 can decide (the top-2 margin
   of a float64 control above twice the plain path's own distance from
   it; a row below that is a tie at f32's resolution, and its token must
   be one of the control's top two).
10. Model-zoo training of MiniCPM-2B at its published widths and full
   depth (40 layers, 3.01 × 10⁹ parameters), bf16, batch 4, sequence
   2,048, through ``repro_torch.launch.train.main``: 8 plain steps (WSD),
   with the launch counts set to 0 just before and read just after (2 ×
   40 forward launches a step, the forward and the group checkpoint's
   recompute, and 40 backward launches), a falling loss, every
   parameter's gradient finite and the attention projections' nonzero in
   every layer; then 8 ``--strads`` steps (U = 20 of 41 blocks,
   ``--weight-decay 0``) in which every block the mask left out keeps its
   bits; every backward call on the wgmma route (``flash_attention.
   BWD_ROUTE_CALLS``); profiler windows over a plain and a STRADS step,
   each holding 40 launches of each wgmma-route kernel and none of the
   mma.sync route's; the backward kernel (and the forward's ``lse``) at
   layer 0's real inputs and at GQA, head-dim 80, windowed, Sq ≠ Skv,
   ragged and unaligned shapes (head dim 80 on the wgmma route, and one
   element into its buffer on the mma.sync route) against its plain
   version, each on the
   route it must take, timed with SDPA's forward and backward beside it
   (eager, and as device time from CUDA graphs), the wgmma kernels'
   registers and spills from ptxas (none may spill); a
   2-layer float32 step (loss and every gradient leaf) with the kernels
   against the plain attention; and at 2 layers a checkpointed run
   resumed from step 4 equal to the uninterrupted run to the bit.
11. The rest of the zoo at full width and depth, bf16, each model's
   weights freed before the next.  xLSTM-125M (``xlstm_phase``; 12
   layers, sLSTM at 3 and 9, every sLSTM call one launch of the sLSTM
   kernel ``slstm_scan`` and none of the cell ``_slstm_cell``): serving
   as Phi's (batch 4, prompt 1,024, 32 tokens: 2 launches a prefill and
   2 a decode step, 66 a generate; profiler windows); in float32 at 4
   layers the prefill and first decode step against the same model on
   the CPU; training at batch 4 × 2,048 (XLSTM_STEPS plain steps and
   XLSTM_STEPS ``--strads --weight-decay 0`` steps, both at full depth,
   13 blocks: the 12 unrolled layers and the rest, every unscheduled
   block keeping its bits; 4 forward and 2 ``slstm_scan_bwd`` launches a
   step); both kernels at layer 3's real inputs of a training step
   against their plain versions in f32, twice to the bit, timed with
   the plain versions, their bounds and the exchange floor (the same
   cooperative grid through its exchanges of tagged words alone), both
   also at the prefill's inputs (from the serving cache's state, the
   initial state's gradients checked) and the forward at a decode
   step's, then at d = 768 from zeros with n < 1, at both ties of the
   cell, at batch 16 and 48, and at batch 72, which runs forward and
   backward in chunks of rows (``slstm_kernel_phase``,
   ``slstm_edge_checks``); a
   4-layer f32 training step against the plain versions; the sLSTM
   layers' share of a full-depth step (one sLSTM layer's checkpointed
   forward, recompute and backward, timed alone); a profiler window over
   a full-depth step; ptxas's registers and spills of both kernels.
   InternVL2-1B (``vlm_phase``; 256 patch embeddings ahead of
   the prompt): serving with every prefill launch of ``flash_attention``
   against its plain version, the kernel timed at layer 0's inputs
   (1,280 queries, 16 query heads padded from 14 over 2 kv heads of 64)
   with SDPA, the main path's counts (24); then training at 2,304
   queries a sequence (ZOO_STEPS steps; 2 × 24 forward and 24 backward
   launches a step, all on the wgmma route, none of
   ``_chunked_attention``), a training step with every forward launch
   checked, the backward at layer 0's inputs against its plain version
   and timed with SDPA's, a profiler window over a step holding 24
   launches of each wgmma-route kernel and none of the mma.sync
   route's.  HuBERT-XLarge
   (``audio_phase``; 48 layers, 16 heads of 80, bidirectional):
   ``encode_step`` of 4 × 1,500 frames with every launch checked, the
   kernel timed at layer 0's non-causal inputs with SDPA, 3 timed
   encodes (48 launches each), a profiler window; then training as
   InternVL2's, its backward on the wgmma route at head dim 80 (48
   launches of each of its kernels in the window, none of mma.sync's).
12. Training the moe and hybrid families, with the backward kernels of
   ``ssm_scan`` and ``topk_gating``.  Zamba2-2.7B (``zamba_train_phase``)
   at full width and depth, bf16, batch 4 × 2,000 (not a multiple of
   128: every Mamba2 layer's scan through ``ssm_scan``, its states saved
   every 16 steps, and ``ssm_scan_bwd``) through ``launch.train.main``:
   ZTRAIN_STEPS plain steps, then as many ``--strads --weight-decay 0``
   steps (5 of 10 blocks; every unscheduled block keeps its bits), each
   step 108 ``ssm_scan``, 54 ``ssm_scan_bwd``, 18 ``flash_attention``
   and 9 backward launches on the wgmma route (head dim 80);
   ``ssm_scan_bwd`` at layer 0's inputs against its plain version (two
   calls to the bit), its resident blocks an SM (at least 2) and shared
   memory a block from the occupancy API, timed beside the forward with
   and without its saved states; a profiler window over a plain step (9
   launches of each wgmma-route backward kernel, none of mma.sync's);
   ZTRAIN_SSD_STEPS
   steps at 4 × 2,048 (the SSD form: no SSM kernel); an f32 step of one
   group (6 layers) with the kernels against the plain versions.
   Phi-3.5-MoE (``phi_train_phase``) at full width, depth cut to
   PHI_TRAIN_LAYERS, bf16, batch 4 × 2,048, the einsum dispatch:
   PHI_TRAIN_STEPS plain and as many ``--strads`` steps, each 4
   ``topk_gating``, 2 ``topk_gating_bwd``, 4 ``flash_attention`` and 2
   backward launches on the wgmma route; ``topk_gating_bwd`` at layer
   0's logits against its plain version; a profiler window; an f32 step
   against the plain versions.  Both gating kernels' ptxas reports:
   the main path's instantiations (Phi's and Llama-4's) may not spill.
13. The last four configurations (``dense_phase``, ``llama4_phase``).
   Granite-3-2B (GQA 32/8 at head dim 64, tied embeddings), StableLM-3B
   (MHA 32/32 at 80, LayerNorm, rope over a quarter of the head) and
   ChatGLM3-6B (GQA 32/2 at 128, a group of 16, rope over half) at full
   width, bf16: serving at full depth as InternVL2's (every prefill
   launch checked, L ``flash_attention`` launches a prefill, the kernel
   timed at layer 0's inputs with SDPA, profiler windows); the same
   model in f32 at 2 layers, first tokens equal and logits within
   LOGIT_TOL with the kernels and with the plain versions; training at
   4 × 2,048 (full depth; ChatGLM3 at DENSE_TRAIN_LAYERS's 12 of 28),
   ZOO_STEPS plain and ZOO_STEPS ``--strads --weight-decay 0`` steps, as
   InternVL2's (2 forward and 1 backward launch a layer a step, all on
   the wgmma route, no ``_chunked_attention``, a checked step, the
   backward at layer 0's inputs, a profiler window).  Llama-4 Maverick
   at full width, LLAMA4_LAYERS layers (one dense, one MoE of 128
   experts top-1 with a shared expert), bf16, serving batch 4 × 1,024,
   32 tokens: every ``flash_attention`` (48/8 at 128) and ``topk_gating``
   ((4,096, 128) and (4, 128), k = 1) launch checked, both kernels timed,
   init seconds and peak, serving peak, prefill ms, decode tok/s beside
   a decode step's weight-read bound; no f32 run (74 GB of weights).

Kernel times: ``ms`` is the eager loop (CUDA events around 50–200 calls
enqueued back to back), which for a kernel of a few microseconds times
the host's enqueue; ``device_ms`` is the device alone (20 calls captured
in one CUDA graph, replayed 10 times, ``graph_ms``); the library call has
both.  ``lasso_partial`` and ``gram_block`` are also checked to be one
kernel a call (the nodes of a CUDA graph that captures one call,
``graph_kernels``) and to give the eager call's bits on each of 3 replays
of a captured call; ``gram_block``'s G to be symmetric to the bit.  Each
kernel's ``floor_bound_ms`` is the larger of its bound and
``launch_floor_ms``, the device time of a trivial kernel node.
The launch counts are read outside every captured region (a replay
adds nothing to them).

Any failure exits nonzero before the last line.  The line before the last
lists every kernel and the floor (``{"kernels": [...], "launch_floor_ms":
t}``); the last line is
``{"ok": true, "device": {...}}``.  Everything measured is also written
to ``chiprun_out/chip_smoke.json``.  Float32 products run in full f32
(``allow_tf32`` is set False for matmul and cuDNN).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, data sheet
PEAK_F32_FLOPS = 67e12         # H100 SXM FP32 outside the tensor cores
KERNEL_TOL = 1e-4              # max |kernel − plain| ≤ KERNEL_TOL·max(1, max|plain|)
STATE_TOL = 1e-4               # |β|, |r| between runs that sum in another order
LASSO_MONO_TOL = 1e-6          # obj(t+1) ≤ obj(t)·(1 + LASSO_MONO_TOL)
PEAK_BF16_FLOPS = 989e12       # H100 SXM bf16 tensor cores, dense
ATTN_TOL = 2e-2                # |kernel − plain| ≤ ATTN_TOL·max(1, max|plain|)
                               # for bf16 attention (one bf16 rounding)
ATTN_TOL_F32 = 1e-4            # the same for f32 attention
GATE_TOL = 1e-5                # gating probabilities; idx must be equal
LOGIT_TOL = 1e-3               # f32 run: |Δ logits| ≤ LOGIT_TOL·max|logits|
SSM_TOL = 1e-2                 # |kernel − plain| ≤ SSM_TOL·max(1, max|plain|)
                               # for bf16 y (one bf16 rounding)
SSM_TOL_F32 = 1e-4             # the same for f32 y and for h (f32 sums in
                               # another order over up to 1,000 steps)
OBS_RATE_TOL = 0.02           # MF and LDA: rounds/s with counters within 2 %
                               # of the uninstrumented run's (device-bound)
SERVE_TOL = 1e-5               # served ŷ vs f64 xᵀβ: |Δ| ≤ SERVE_TOL·Σ|x_j β_j|
MF_TIE_TOL = 1e-5              # MF top-k: f64 scores of the served items vs
                               # the f64 top-k, ≤ MF_TIE_TOL·max|score| (f32
                               # near-ties may swap)
LDA_THETA_TOL = 1e-5           # LDA θ (f32) vs an f64 fold-in from the pin
LASSO_REQUESTS = 64            # predict requests over serve_ssp.json
MF_REQUESTS = 256              # recommend requests over an ssp sweep
LDA_REQUESTS = 64              # infer_topics requests over 256 rounds
LDA_DOC_LEN = 256              # tokens a held-out document
DEVICE = "cuda"
PROFILE_SPACED = 32            # a profiler window's lead guard: empty
PROFILE_GAP_S = 1e-3           # kernels each waited for and this far
PROFILE_PRIMERS = 512          # apart, then these back to back; and as
PROFILE_TAIL = 64              # many back to back after the call.  A
PROFILE_ATTEMPTS = 3           # session loses some device records near
                               # its start (all of 64 primers once; not
                               # the first moments of a window: margins
                               # do not help; tools/profile_window_check
                               # .py); a window that lost any record of
                               # the call is taken again
SOURCE = "src/repro_torch/kernels/csrc/lasso_cd.cu"
SOURCES = {"lasso_partial": SOURCE, "gram_block": SOURCE,
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "topk_gating": "src/repro_torch/kernels/csrc/moe_gating.cu",
           "ssm_scan": "src/repro_torch/kernels/csrc/ssm_scan.cu",
           "lda_gibbs": "src/repro_torch/kernels/csrc/lda_gibbs.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "topk_gating_bwd": "src/repro_torch/kernels/csrc/moe_gating.cu",
           "ssm_scan_bwd": "src/repro_torch/kernels/csrc/ssm_scan.cu",
           "slstm_scan": "src/repro_torch/kernels/csrc/slstm_scan.cu",
           "slstm_scan_bwd": "src/repro_torch/kernels/csrc/slstm_scan.cu"}
REPLACES = {"lasso_partial": "src/repro/kernels/lasso_cd.py:50",
            "gram_block": "src/repro/kernels/lasso_cd.py:94",
            "flash_attention": "src/repro/kernels/flash_attention.py:100",
            "topk_gating": "src/repro/kernels/moe_gating.py:56",
            "ssm_scan": "src/repro/kernels/ssm_scan.py:67",
            # no Pallas kernel: the lax.scan of _gibbs_scan
            "lda_gibbs": "src/repro/apps/lda.py:73",
            # no Pallas kernel: the JAX package differentiates the forward
            # (its _sdpa, models/layers.py:186) by autodiff
            "flash_attention_bwd": "src/repro/kernels/flash_attention.py:100",
            # no Pallas kernel: the JAX package differentiates its oracles
            # (ref.topk_gating_ref, ref.ssm_scan_ref) behind the forwards
            "topk_gating_bwd": "src/repro/kernels/moe_gating.py:56",
            "ssm_scan_bwd": "src/repro/kernels/ssm_scan.py:67",
            # no Pallas kernel: the lax.scan of slstm_apply (chunked_scan
            # of _slstm_cell), differentiated by autodiff
            "slstm_scan": "src/repro/models/xlstm.py:261",
            "slstm_scan_bwd": "src/repro/models/xlstm.py:261"}
ARCH = "phi3.5-moe-42b-a6.6b"
BATCH, PROMPT, GEN = 4, 1024, 32
ZAMBA = "zamba2-2.7b"
ZPROMPT = 1000                 # > 128 and not a multiple of 128: the scan path
BUILD = ("lasso_cd", "flash_attention", "moe_gating", "ssm_scan",
         "lda_gibbs", "slstm_scan")


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of one call, from CUDA events over ``iters`` calls
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


_CAPTURE_STREAM = None         # graph_ms's one side stream (made on the card)


def graph_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call apart from the host: ``calls`` calls
    captured in one CUDA graph (after a warm-up call on the capture's
    side stream, one stream for every capture), the graph replayed once,
    then ``replays`` times between CUDA events; the time over calls ×
    replays.  A replay enqueues the whole graph at once, so the host's
    per-call work (Python, ctypes, launch) drops out.  The graph and
    its memory are freed on return, and so are the cuBLAS workspaces a
    capture adds, so the peak memory the main paths report is not the
    harness's."""
    global _CAPTURE_STREAM
    if _CAPTURE_STREAM is None:
        _CAPTURE_STREAM = torch.cuda.Stream()
    side = _CAPTURE_STREAM
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    del g
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return a.elapsed_time(b) / (calls * replays)


def graph_kernels(torch, fn) -> tuple[int, int]:
    """Kernel nodes and all nodes of a CUDA graph that captures one call
    of ``fn``, read with the driver's cuGraphGetNodes and
    cuGraphNodeGetType: the launches one call makes, without a profiler
    (whose sessions leave the host's launches slower)."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    err = err or cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        err = err or cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                             ctypes.byref(kind))
        kinds.append(kind.value)
    check(err == 0, f"CUDA driver error {err} reading a graph's nodes")
    del g
    return kinds.count(0), len(kinds)    # 0: CU_GRAPH_NODE_TYPE_KERNEL


def offset_view(torch, t):
    """``t``'s values in a contiguous view one element into a larger
    buffer: a base that is not 16-byte aligned."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def max_err(torch, got, want) -> tuple[float, float]:
    err = (got - want).abs().max().item()
    return err, KERNEL_TOL * max(1.0, want.abs().max().item())


def kernel_phase(torch, lc, ref, X, y, W: int, U: int, UP: int, seed: int):
    """Each kernel against its plain version at the main path's shapes
    (candidate columns gathered out of the real X), at ragged ones and on
    a view one element past 16-byte alignment, timed eager and on the
    device alone, checked to be one kernel node a call and replayed from
    a captured CUDA graph; ``gram_block`` also at the scan_w1 run's
    shape."""
    n, J = X.shape
    gen = torch.Generator().manual_seed(seed)
    Xw = X.view(W, n // W, J)
    rw = y.view(W, n // W)
    cand = torch.randperm(J, generator=gen)[:UP].to(X.device)
    Xc = Xw.index_select(-1, cand)                  # (W, n/W, U′)
    Xb = Xw.index_select(-1, cand[:U])              # (W, n/W, U)
    ragged_X = torch.randn((4, 1001, 37), generator=gen).to(X.device)
    ragged_r = torch.randn((4, 1001), generator=gen).to(X.device)
    Xb_off, rw_off = offset_view(torch, Xb), offset_view(torch, rw)
    Xc_off = offset_view(torch, Xc)
    cases = {
        "lasso_partial": dict(
            fn=lambda: lc.lasso_partial(Xb, rw),
            plain=lambda: ref.lasso_partial_ref(Xb, rw),
            library=lambda: torch.matmul(Xb.mT, rw.unsqueeze(-1)),
            ragged=(lambda: lc.lasso_partial(ragged_X, ragged_r),
                    lambda: ref.lasso_partial_ref(ragged_X, ragged_r)),
            # the main path's shapes one element past 16-byte alignment:
            # the kernel's scalar loads
            unaligned=(lambda: lc.lasso_partial(Xb_off, rw_off),
                       lambda: ref.lasso_partial_ref(Xb_off, rw_off)),
            nbytes=4 * (W * (n // W) * (U + 1) + W * U),
            flops=2 * W * (n // W) * U),
        "gram_block": dict(
            fn=lambda: lc.gram_block(Xc),
            plain=lambda: ref.gram_ref(Xc),
            library=lambda: torch.matmul(Xc.mT, Xc),
            ragged=(lambda: lc.gram_block(ragged_X),
                    lambda: ref.gram_ref(ragged_X)),
            unaligned=(lambda: lc.gram_block(Xc_off),
                       lambda: ref.gram_ref(Xc_off)),
            # G is symmetric: the upper triangle, U′(U′+1)/2 entries of
            # 2·n/W operations each, is all the function needs
            nbytes=4 * (W * (n // W) * UP + W * UP * UP),
            flops=W * (n // W) * UP * (UP + 1)),
    }
    out = {}
    for name, c in cases.items():
        before = lc.LAUNCHES[name]
        got, want = c["fn"](), c["plain"]()
        torch.cuda.synchronize()
        check(lc.LAUNCHES[name] == before + 1,
              f"{name}: the wrapper did not launch its kernel")
        check(torch.equal(got, c["fn"]()), f"{name}: two launches differ")
        if name == "gram_block":
            check(torch.equal(got, got.mT), "gram_block: G is not symmetric "
                                            "to the bit")
        err, tol = max_err(torch, got, want)
        check(err <= tol, f"{name}: max abs err {err} > {tol} at the main "
                          f"path's shapes")
        rg, rw_ = c["ragged"]
        rerr, rtol = max_err(torch, rg(), rw_())
        check(rerr <= rtol, f"{name}: max abs err {rerr} > {rtol} at "
                            f"ragged shapes (4, 1001, 37)")
        extra = {}
        if "unaligned" in c:
            ug, uw = c["unaligned"]
            uerr, utol = max_err(torch, ug(), uw())
            check(uerr <= utol, f"{name}: max abs err {uerr} > {utol} on "
                                f"a view one element past alignment")
            extra["unaligned_max_abs_err"] = uerr
        kernels, nodes = graph_kernels(torch, c["fn"])
        check(kernels == 1 and nodes == 1,
              f"{name}: a captured call has {kernels} kernels in {nodes} "
              f"graph nodes, not one")
        # one captured call replayed: the same bits each time (the
        # counters are back at 0 after every call)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            captured = c["fn"]()
        for _ in range(3):
            captured.zero_()
            g.replay()
            torch.cuda.synchronize()
            check(torch.equal(captured, got),
                  f"{name}: a graph replay differs from the eager call")
        del g, captured
        extra["graph_replays_equal"] = 3
        ms = time_ms(torch, c["fn"])
        device_ms = graph_ms(torch, c["fn"])
        plain_ms = time_ms(torch, c["plain"])
        library_ms = time_ms(torch, c["library"])
        library_device_ms = graph_ms(torch, c["library"])
        ms_again = time_ms(torch, c["fn"])
        device_again = graph_ms(torch, c["fn"])
        bms, by = bound(c["nbytes"], c["flops"])
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "tolerance": tol, "ragged_max_abs_err": rerr,
            "ms_repeat": ms_again, "device_ms_repeat": device_again,
            "bound_share": bms / ms, "device_bound_share": bms / device_ms,
            "graph_kernels_a_call": kernels, "graph_nodes_a_call": nodes,
            **extra,
            "shape": list(Xc.shape if name == "gram_block" else Xb.shape)}
    # the scan_w1 run's shape: one worker over all n rows
    out["gram_block"]["by_shape"] = {"scan_w1": gram_at(
        torch, lc, ref, X.view(1, n, J).index_select(-1, cand))}
    return out


def gram_at(torch, lc, ref, Xc) -> dict:
    """``gram_block`` at one shape: within KERNEL_TOL of its plain
    version, symmetric to the bit, timed eager and on the device, with
    ``matmul``'s device time and the bound."""
    W, n, U = Xc.shape
    got = lc.gram_block(Xc)
    err, tol = max_err(torch, got, ref.gram_ref(Xc))
    check(err <= tol, f"gram_block: max abs err {err} > {tol} at "
                      f"{tuple(Xc.shape)}")
    check(torch.equal(got, got.mT) and torch.equal(got, lc.gram_block(Xc)),
          f"gram_block: not symmetric or not the same bits at "
          f"{tuple(Xc.shape)}")
    device_ms = graph_ms(torch, lambda: lc.gram_block(Xc))
    bms, by = bound(4 * (W * n * U + W * U * U), W * n * U * (U + 1))
    return {"shape": [W, n, U], "max_abs_err": err, "tolerance": tol,
            "ms": time_ms(torch, lambda: lc.gram_block(Xc)),
            "device_ms": device_ms, "bound_ms": bms, "bound_by": by,
            "device_bound_share": bms / device_ms,
            "library_device_ms": graph_ms(
                torch, lambda: torch.matmul(Xc.mT, Xc))}


def ptxas_kernels(log: str) -> dict:
    """Registers, spill bytes and shared bytes of each entry function in
    an ``nvcc -Xptxas -v`` report, by its (demangled-enough) name."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            if name.startswith("_ZN"):       # the last nested component
                i, parts = 3, []
                while i < len(name) and name[i].isdigit():
                    j = i
                    while name[j].isdigit():
                        j += 1
                    parts.append(name[j:j + int(name[i:j])])
                    i = j + int(name[i:j])
                targs = re.match(r"I((?:Li-?\d+E|f|13__nv_bfloat16)+)E",
                                 name[i:])
                name = parts[-1] if parts else name
                if targs:                    # a template's arguments
                    name += "<" + ",".join(
                        n or ("f32" if f else "bf16") for n, f in
                        re.findall(r"Li(-?\d+)E|(f)|13__nv_bfloat16",
                                   targs.group(1))) + ">"
            out[name] = {}
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            out[name].update(spill_store_bytes=int(st),
                             spill_load_bytes=int(ld))
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def run_plan(torch, lasso, cfg, plan, X, y, seed: int, pushed=None):
    """One run of a plan through the port's entry points; returns the
    report, its wall time and the objective trace.  ``pushed`` (a list)
    collects the schedule of every round the run pushes."""
    eng = lasso.make_engine(cfg, workers=plan.workers, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})
    state = eng.init_state(y=y)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    if pushed is not None:
        push = eng.app.push
        eng.app.push = lambda d, s, sched, ph: (pushed.append(sched),
                                                push(d, s, sched, ph))[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.execute(state, data, gen, plan,
                      collect=eng.app.objective_collect())
    torch.cuda.synchronize()
    return eng, rep, time.perf_counter() - t0


def round_breakdown(torch, eng, state, data, seed: int, reps: int = 5):
    """Where one round's time goes: each step of the round body run on
    its own between synchronisations, timed by CUDA events (device time
    including the host's enqueue time, as the eager round pays it)."""
    app = eng.app
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    carry = eng.init_sched_carry()
    J = app.num_schedulable()
    times: dict = {}
    for t in range(reps):
        def step(name, fn):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            times.setdefault(name, []).append(a.elapsed_time(b))
            return out
        g = step("noise", lambda: -torch.log(-torch.log(torch.rand(
            (J,), generator=gen, device=DEVICE).clamp_min_(1e-38))))
        cand = step("propose", lambda: app.propose(state, carry, g, t, 0))
        Xc = step("gather_candidates",
                  lambda: data["X"].index_select(-1, cand))
        Gw = step("gram_block", lambda: app.kernels.gram_block(Xc))
        G = step("sum_workers", lambda: Gw.sum(0))
        sched = step("rho_filter", lambda: app.schedule(state, carry, cand,
                                                        G, t, 0))
        Xb = step("gather_block",
                  lambda: data["X"].index_select(-1, sched["idx"]))
        zw = step("lasso_partial",
                  lambda: app.kernels.lasso_partial(Xb, state["r"]))
        z = zw.sum(0)
        new = step("pull", lambda: app.pull(state, sched, z, None, data, 0))
        carry = step("carry_update", lambda: app.sched_update(
            carry, state, new, sched, 0))
        state = new
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def profile_rounds(torch, lasso, lc, cfg, plan, X, y, seed: int):
    """Device busy share over a 4-round window (``profile_window``), every
    launch of both Lasso kernels in it."""
    eng = lasso.make_engine(cfg, workers=plan.workers, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})
    state = eng.init_state(y=y)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    short = type(plan).from_json(dict(plan.to_json(), rounds=4))
    eng.execute(state, data, gen, short)                  # warm
    return profile_window(
        torch, lambda: eng.execute(state, data, gen, short),
        {"lasso_partial": (lc.LAUNCHES, ("lasso_partial_fused",)),
         "gram_block": (lc.LAUNCHES, ("gram_fused",))})

def lasso_pipelined_phase(torch, lasso, lc, ExecutionPlan, KernelSpec, cfg,
                          X, y, seed: int) -> dict:
    """``examples/plans/pipelined.json`` as checked in (pipelined, 16
    rounds, W = 4, the app's default kernels: the CUDA ones on the card),
    with the launch counts set to 0 just before each run and read just
    after.  The counts the code implies:

    - a fresh run of R rounds: R + 1 ``gram_block`` (round 0's schedule
      is made before the first round, and round R − 1 prefetches round
      R's, which no round runs) and R ``lasso_partial``;
    - the same plan as two ``execute`` calls of R/2 rounds through the
      carry: R/2 + 1 and R/2 ``gram_block`` (the second call takes round
      R/2's schedule from the carry), R/2 and R/2 ``lasso_partial``;
    - the plan with ``kind="reference"``: none.

    Checks: the split run equals the whole one to the bit; β and r within
    STATE_TOL of the reference run's; round 0 pushes the round-0 schedule
    of the same plan on scan (the first draw, the fresh carry), whose
    later schedules and state are compared and reported (they differ
    only through the staleness); the objective finite and
    descending every round within LASSO_MONO_TOL (the guarantee
    ``tests/test_engine_scan.py:86`` holds on the correlated design) and
    below its start.  Then the two plans' times, alternately
    (:func:`pipelined_against_scan`)."""
    with open(os.path.join(ROOT, "examples", "plans",
                           "pipelined.json")) as f:
        plan = ExecutionPlan.from_json(json.load(f))
    R = plan.rounds
    check(plan.executor == "pipelined" and R == 16 and plan.workers == 4
          and plan.kernels is None, f"unexpected plan {plan}")
    run_plan(torch, lasso, cfg, ExecutionPlan.from_json(
        dict(plan.to_json(), rounds=2)), X, y, seed)         # warm-up
    pushed: list = []
    lc.reset_launch_counts()
    eng, rep, secs = run_plan(torch, lasso, cfg, plan, X, y, seed, pushed)
    launches = dict(lc.LAUNCHES)
    ran = list(pushed)          # the engine's later calls push too
    check(launches == {"lasso_partial": R, "gram_block": R + 1},
          f"pipelined: launches {launches}, want {R} lasso_partial and "
          f"{R + 1} gram_block")
    check(rep.carry.depth == 1 and rep.carry.t == R,
          "pipelined: the carry holds no in-flight schedule")
    # the same plan in two calls through the carry
    data = eng.shard_data({"X": X, "y": y})
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    obj = eng.app.objective_collect()
    half = ExecutionPlan.from_json(dict(plan.to_json(), rounds=R // 2))
    lc.reset_launch_counts()
    first = eng.execute(eng.init_state(y=y), data, gen, half, collect=obj)
    split = [dict(lc.LAUNCHES)]
    lc.reset_launch_counts()
    second = eng.execute(first.state, data, gen, plan, collect=obj,
                         carry=first.carry)
    split.append(dict(lc.LAUNCHES))
    check(split == [{"lasso_partial": R // 2, "gram_block": R // 2 + 1},
                    {"lasso_partial": R // 2, "gram_block": R // 2}],
          f"pipelined in two calls: launches {split}")
    check(torch.equal(second.state["beta"], rep.state["beta"])
          and torch.equal(second.state["r"], rep.state["r"])
          and torch.equal(torch.cat([first.trace, second.trace]),
                          rep.trace),
          "pipelined: the run split through the carry differs from the "
          "whole run")
    # the plain versions
    ref_plan = ExecutionPlan.from_json(dict(
        plan.to_json(), kernels=KernelSpec(kind="reference").to_json()))
    lc.reset_launch_counts()
    _, rep_ref, secs_ref = run_plan(torch, lasso, cfg, ref_plan, X, y, seed)
    check(not any(lc.LAUNCHES.values()),
          "the pipelined reference run launched a kernel")
    db = (rep_ref.state["beta"] - rep.state["beta"]).abs().max().item()
    dr = (rep_ref.state["r"] - rep.state["r"]).abs().max().item()
    check(db <= STATE_TOL and dr <= STATE_TOL,
          f"pipelined: reference differs: |Δβ| {db}, |Δr| {dr} > "
          f"{STATE_TOL}")
    # the same plan on scan: round 0 runs scan's round-0 schedule; later
    # rounds may differ through the one round of staleness (reported)
    scan_pushed: list = []
    scan_plan = ExecutionPlan.from_json(dict(plan.to_json(),
                                             executor="scan"))
    _, rep_scan, secs_scan = run_plan(torch, lasso, cfg, scan_plan, X, y,
                                      seed, scan_pushed)
    differ = [t for t, (a, b) in enumerate(zip(ran, scan_pushed))
              if not (torch.equal(a["idx"], b["idx"])
                      and torch.equal(a["mask"], b["mask"]))]
    check(len(ran) == len(scan_pushed) == R and 0 not in differ,
          "pipelined: round 0 did not run scan's round-0 schedule")
    vs_scan = {"rounds_with_another_schedule": differ,
               "state_equal": bool(
                   torch.equal(rep_scan.state["beta"], rep.state["beta"])
                   and torch.equal(rep_scan.state["r"], rep.state["r"]))}
    obj0 = 0.5 * float((y.double() ** 2).sum())
    trace = rep.trace.double().cpu().tolist()
    check(len(trace) == R and all(map(math.isfinite, trace)),
          "pipelined: the objective trace is not finite")
    rises = [t for t in range(R) if trace[t] > (trace[t - 1] if t else obj0)
             * (1 + LASSO_MONO_TOL)]
    check(not rises and trace[-1] < obj0,
          f"pipelined: the objective rose in rounds {rises} (or did not "
          f"fall: {trace[-1]} vs {obj0})")
    alternating = pipelined_against_scan(torch, lasso, cfg, plan, scan_plan,
                                         eng, data, X, y, seed)
    return {"plan": plan.to_json(), "launches": launches,
            "launches_split": split, "split_equals_whole": True,
            "max_diff_vs_reference": {"beta": db, "r": dr},
            "round0_schedule_equals_scan": True, "vs_scan": vs_scan,
            "objective_start": obj0, "objective_end": trace[-1],
            "objective_descends": True,
            "rounds_per_s": {"pipelined": R / secs,
                             "pipelined_reference": R / secs_ref,
                             "scan": R / secs_scan},
            "seconds": {"pipelined": secs, "pipelined_reference": secs_ref,
                        "scan": secs_scan},
            "alternating": alternating}


def pipelined_against_scan(torch, lasso, cfg, plan, scan_plan, eng, data,
                           X, y, seed: int, pairs: int = 3) -> dict:
    """The pipelined plan and the same plan on scan timed alternately in
    this process (pipelined, scan, scan, pipelined, … for ``pairs`` × 2
    runs each), and one schedule's wall time (noise, propose, the
    candidates' Gram block, Σ workers, the ρ-filter; synchronised before
    and after).  A fresh pipelined run makes R + 1 schedules against
    scan's R, so ``extra_schedule_ms`` is the part of the gap that the
    code implies; ``unexplained_ms`` is the median gap less it."""
    alt = alternately(torch, lasso, cfg, {"pipelined": plan,
                                          "scan": scan_plan}, X, y, seed,
                      pairs)
    secs = alt["seconds"]
    gaps = [(a - b) * 1e3 for a, b in zip(secs["pipelined"], secs["scan"])]
    state, sc = eng.init_state(y=y), eng.init_sched_carry()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sched_ms = []
    for t in range(7):
        noise = eng._noise(gen, None, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._make_schedule(state, sc, data, noise, t, 0)
        torch.cuda.synchronize()
        sched_ms.append((time.perf_counter() - t0) * 1e3)
    gap, one = median(gaps), median(sched_ms)
    return {**alt, "gap_ms": gaps, "median_gap_ms": gap,
            "schedule_ms": sched_ms, "extra_schedule_ms": one,
            "unexplained_ms": gap - one}


def lasso_ssp_phase(torch, lasso, lc, ExecutionPlan, KernelSpec, cfg, X,
                    y, seed: int) -> dict:
    """``examples/plans/ssp_s2.json`` as checked in (the SSP executor,
    12 rounds, s = 2, W = 4, the app's default kernels: the CUDA ones on
    the card), with the launch counts set to 0 just before the run and
    read just after: each proposal of a window makes its own Gram block
    and each push its own partials, so 12 ``gram_block`` and 12
    ``lasso_partial``.  Checks: the carry's clocks at 12; the same plan
    through ``StradsEngine.run_ssp`` with telemetry equal to the bit,
    its staleness histogram [4, 4, 4] (each window serves one read at
    each staleness 0..2), the largest staleness 2, 4 flushes; β and r
    within STATE_TOL of the plan on the plain kernels (no launch); the
    objective finite, at round 12 below round 0's and the start's; the
    plan at s = 0 equal to ``scan`` to the bit.  Then the plan and the
    same 12 rounds on ``scan`` timed alternately, 6 runs each."""
    with open(os.path.join(ROOT, "examples", "plans", "ssp_s2.json")) as f:
        plan = ExecutionPlan.from_json(json.load(f))
    R, s = plan.rounds, plan.staleness
    check(plan.executor == "ssp" and R == 12 and s == 2 and plan.workers == 4
          and plan.kernels is None, f"unexpected plan {plan}")
    run_plan(torch, lasso, cfg, ExecutionPlan.from_json(
        dict(plan.to_json(), rounds=s + 1)), X, y, seed)     # warm-up
    lc.reset_launch_counts()
    eng, rep, secs = run_plan(torch, lasso, cfg, plan, X, y, seed)
    launches = dict(lc.LAUNCHES)
    check(launches == {"lasso_partial": R, "gram_block": R},
          f"ssp: launches {launches}, want {R} of each kernel")
    check(rep.carry.t == R and rep.carry.clocks.tolist() == [R] * 4,
          f"ssp: the carry ends at t {rep.carry.t}, clocks "
          f"{rep.carry.clocks.tolist()}")
    data = eng.shard_data({"X": X, "y": y})
    st, tel = eng.run_ssp(eng.init_state(y=y), data,
                          torch.Generator(device=DEVICE).manual_seed(seed),
                          R, staleness=s, with_telemetry=True)
    check(torch.equal(st["beta"], rep.state["beta"])
          and torch.equal(st["r"], rep.state["r"]),
          "ssp: run_ssp differs from execute")
    window = R // (s + 1)
    check(tel.hist.tolist() == [window] * (s + 1) and tel.max_staleness == s
          and tel.flushes == window and tel.clocks.tolist() == [R] * 4,
          f"ssp: telemetry {tel.to_json()}")
    del st
    ref_plan = ExecutionPlan.from_json(dict(
        plan.to_json(), kernels=KernelSpec(kind="reference").to_json()))
    lc.reset_launch_counts()
    _, rep_ref, secs_ref = run_plan(torch, lasso, cfg, ref_plan, X, y, seed)
    check(not any(lc.LAUNCHES.values()),
          "the ssp reference run launched a kernel")
    db = (rep_ref.state["beta"] - rep.state["beta"]).abs().max().item()
    dr = (rep_ref.state["r"] - rep.state["r"]).abs().max().item()
    check(db <= STATE_TOL and dr <= STATE_TOL,
          f"ssp: reference differs: |Δβ| {db}, |Δr| {dr} > {STATE_TOL}")
    obj0 = 0.5 * float((y.double() ** 2).sum())
    trace = rep.trace.double().cpu().tolist()
    check(len(trace) == R and all(map(math.isfinite, trace))
          and trace[-1] < trace[0] < obj0,
          f"ssp: the objective did not fall: {obj0} → {trace[0]} → "
          f"{trace[-1]}")
    rises = [t for t in range(R) if trace[t] > (trace[t - 1] if t else obj0)
             * (1 + LASSO_MONO_TOL)]
    s0_plan = ExecutionPlan.from_json(dict(plan.to_json(), staleness=0))
    scan_plan = ExecutionPlan.from_json(dict(plan.to_json(),
                                             executor="scan", staleness=0))
    _, rep0, secs0 = run_plan(torch, lasso, cfg, s0_plan, X, y, seed)
    _, rep_scan, secs_scan = run_plan(torch, lasso, cfg, scan_plan, X, y,
                                      seed)
    check(torch.equal(rep0.state["beta"], rep_scan.state["beta"])
          and torch.equal(rep0.state["r"], rep_scan.state["r"])
          and torch.equal(rep0.trace, rep_scan.trace),
          "ssp: s = 0 differs from scan")
    alternating = alternately(torch, lasso, cfg, {"ssp": plan,
                                                  "scan": scan_plan},
                              X, y, seed)
    return {"plan": plan.to_json(), "launches": launches,
            "telemetry": tel.to_json(), "run_ssp_equals_execute": True,
            "max_diff_vs_reference": {"beta": db, "r": dr},
            "objective_start": obj0, "objective_round0": trace[0],
            "objective_end": trace[-1], "objective_rises_in_rounds": rises,
            "s0_equals_scan": True,
            "rounds_per_s": {"ssp": R / secs, "ssp_reference": R / secs_ref,
                             "ssp_s0": R / secs0, "scan": R / secs_scan},
            "alternating": alternating}


def alternately(torch, lasso, cfg, plans: dict, X, y, seed: int,
                pairs: int = 3) -> dict:
    """Two plans of as many rounds timed alternately in this process (a,
    b, b, a, … for ``pairs`` × 2 runs each): the host clock spreads ~30 %
    within one run, so only runs taken in turns are compared."""
    a, b = plans
    secs: dict = {a: [], b: []}
    for order in ((a, b), (b, a)) * pairs:
        for name in order:
            secs[name].append(run_plan(torch, lasso, cfg, plans[name], X, y,
                                       seed)[2])
    R = plans[a].rounds
    return {"seconds": secs,
            "median_rounds_per_s": {k: R / median(v)
                                    for k, v in secs.items()}}


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


class BoundaryTimer:
    """Times a chunked run's boundaries on the host: the partition check
    (``StradsEngine._partition_step``: the signal's copy to the host,
    the EMA, the rebalance decision and the greedy re-binning) and the
    checkpoint write, each after a ``synchronize`` so that the chunk's
    device work is not counted; and the bytes of each file."""

    def __init__(self, torch, eng, engine_mod):
        self.torch, self.eng, self.mod = torch, eng, engine_mod
        self.partition_ms: list = []
        self.save_ms: list = []
        self.bytes: list = []

    def _timed(self, fn, out: list):
        def run(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            out.append((time.perf_counter() - t0) * 1e3)
            return r
        return run

    def __enter__(self):
        save = self._timed(self.mod.save_checkpoint, self.save_ms)

        def save_and_size(*a, **kw):
            path = save(*a, **kw)
            self.bytes.append(os.path.getsize(path))
            return path
        self.eng._partition_step = self._timed(self.eng._partition_step,
                                               self.partition_ms)
        self._swap = patched(self.mod, save_checkpoint=save_and_size)
        self._swap.__enter__()
        return self

    def __exit__(self, *exc):
        self._swap.__exit__(*exc)
        del self.eng._partition_step

    def summary(self) -> dict:
        return {"partition_ms": self.partition_ms, "save_ms": self.save_ms,
                "checkpoint_bytes": self.bytes}


def lasso_loadbal_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                        seed: int, scan_state) -> dict:
    """``examples/plans/lasso_loadbal.json`` as checked in (scan, 16
    rounds, W = 4, dynamic priority U = 32 of U′ = 128, ρ = 0.3, a
    ``load_balanced`` partitioner checked every 4 rounds) with a
    temporary ``ckpt_dir``: 4 chunks, 4 files (steps 4, 8, 12, 16), 16
    launches of each kernel (scan makes one schedule a round); the
    assignment's version and load spread (before and after the move, on
    the EMA at that boundary) at each boundary; the host ms of a boundary
    and each checkpoint's bytes and write ms (:class:`BoundaryTimer`).
    The run equals ``lasso_pallas.json``'s scan run to the bit (the same
    scheduler, kernels and seed: ownership is bookkeeping).  A fresh
    engine resumed from step 8's file (state, carry and ``partition=``)
    launches each kernel 8 times and equals the uninterrupted run to the
    bit in β, r, the scheduler carry, the final assignment and the
    EMA."""
    import tempfile
    from repro_torch.checkpoint import load_flat, restore_checkpoint
    from repro_torch.core import engine as engine_mod
    from repro_torch.part import Assignment, contiguous_assignment
    with open(os.path.join(ROOT, "examples", "plans",
                           "lasso_loadbal.json")) as f:
        plan = ExecutionPlan.from_json(json.load(f))
    R, C = plan.rounds, plan.checkpoint_every
    check(plan.executor == "scan" and (R, C) == (16, 4)
          and plan.partitioner.kind == "load_balanced",
          f"unexpected plan {plan}")
    eng = lasso.make_engine(cfg, workers=plan.workers, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})
    obj = eng.app.objective_collect()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lasso_") as d:
        lc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with BoundaryTimer(torch, eng, engine_mod) as timer:
            rep = eng.execute(eng.init_state(y=y), data,
                              torch.Generator(device=DEVICE).manual_seed(
                                  seed), plan, collect=obj, ckpt_dir=d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(lc.LAUNCHES)
        check(launches == {"lasso_partial": R, "gram_block": R},
              f"lasso_loadbal: launches {launches}, want {R} each")
        files = sorted(os.listdir(d))
        check(files == [f"step_{t:08d}.npz" for t in range(C, R + 1, C)],
              f"lasso_loadbal: files {files}")
        check(torch.equal(rep.state["beta"], scan_state["beta"])
              and torch.equal(rep.state["r"], scan_state["r"]),
              "lasso_loadbal: the run differs from lasso_pallas.json's")
        final, ema = eng.partition_assignment, eng.partition_stats["ema"]
        payload = eng.partition_payload()
        boundaries = []
        prev = contiguous_assignment(cfg.num_features, plan.workers)
        for t in range(C, R + 1, C):
            flat = load_flat(d, t)
            own = Assignment.from_payload(
                {k: flat[f"assignment/{k}"]
                 for k in ("owner", "num_workers", "version")})
            w = flat["assignment/stats_ema"]
            boundaries.append({"t": t, "version": own.version,
                               "spread_before": prev.spread(w),
                               "spread_after": own.spread(w)})
            prev = own
        check(prev == final, "lasso_loadbal: the last file's assignment is "
                             "not the engine's")
        # a fresh engine resumed from the middle file
        eng2 = lasso.make_engine(cfg, workers=plan.workers, device=DEVICE)
        eng2.set_partitioner(plan.partitioner)
        back = restore_checkpoint(d, R // 2, {
            "state": rep.state, "carry": rep.carry, "assignment": payload})
        lc.reset_launch_counts()
        res = eng2.execute(back["state"], eng2.shard_data({"X": X, "y": y}),
                           None, plan, carry=back["carry"],
                           partition=back["assignment"],
                           ckpt_dir=os.path.join(d, "resumed"))
        resumed_launches = dict(lc.LAUNCHES)
    check(resumed_launches == {"lasso_partial": R // 2,
                               "gram_block": R // 2},
          f"lasso_loadbal resumed: launches {resumed_launches}")
    check(torch.equal(res.state["beta"], rep.state["beta"])
          and torch.equal(res.state["r"], rep.state["r"])
          and torch.equal(res.carry.sched_carry, rep.carry.sched_carry)
          and eng2.partition_assignment == final
          and (eng2.partition_stats["ema"] == ema).all(),
          "lasso_loadbal: the run resumed from step 8 differs")
    return {"plan": plan.to_json(), "launches": launches,
            "launches_resumed": resumed_launches, "chunks": len(files),
            "files": files, "boundaries": boundaries,
            "final_version": final.version, **timer.summary(),
            "rounds_per_s": R / secs, "seconds": secs,
            "equals_scan_w4": True, "resumed_equals_whole": True}

# ---------------------------------------------------------------------------
# Telemetry and serving on the Lasso path
# ---------------------------------------------------------------------------

def load_plan(ExecutionPlan, name: str, **override):
    """A checked-in plan of ``examples/plans``, with fields replaced."""
    with open(os.path.join(ROOT, "examples", "plans", name)) as f:
        plan = ExecutionPlan.from_json(json.load(f))
    if override:
        plan = ExecutionPlan.from_json(dict(plan.to_json(), **override))
    return plan


def lasso_counters_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                         seed: int) -> dict:
    """Device counters on the Lasso path at the chip shape.
    ``examples/plans/ssp_s2.json`` with ``TelemetrySpec(kind="counters")``,
    the launch counts set to 0 just before and read just after (still 12
    and 12): β, r and the objective trace equal the uninstrumented run's
    to the bit; the RunReport counts 12 rounds, proposed 12 × U′,
    accepted + killed = proposed, sched_size = accepted, and its ``ssp``
    section the histogram [4, 4, 4]; the trace CLI's check passes.  Then
    ``lasso_pallas.json`` (16 scan rounds) with counters and without,
    timed alternately (6 runs each): the medians are printed, with no
    limit (the host clock spreads ~20–30 % within a run)."""
    from repro_torch.launch.trace import check_report
    from repro_torch.obs import TelemetrySpec
    counters = TelemetrySpec(kind="counters").to_json()
    plan = load_plan(ExecutionPlan, "ssp_s2.json")
    R, s = plan.rounds, plan.staleness
    inst = load_plan(ExecutionPlan, "ssp_s2.json", telemetry=counters)
    _, plain, _ = run_plan(torch, lasso, cfg, plan, X, y, seed)
    lc.reset_launch_counts()
    _, rep, secs = run_plan(torch, lasso, cfg, inst, X, y, seed)
    launches = dict(lc.LAUNCHES)
    check(launches == {"lasso_partial": R, "gram_block": R},
          f"lasso counters: launches {launches}, want {R} of each")
    check(torch.equal(rep.state["beta"], plain.state["beta"])
          and torch.equal(rep.state["r"], plain.state["r"])
          and torch.equal(rep.trace, plain.trace),
          "lasso counters: the instrumented ssp run differs from the "
          "uninstrumented one")
    report = rep.telemetry
    c = report.counters
    check(c["rounds"] == R and c["rounds_per_phase"] == [R]
          and c["proposed"] == R * cfg.num_candidates
          and c["accepted"] + c["killed"] == c["proposed"]
          and c["sched_size"] == c["accepted"] and c["accepted"] > 0,
          f"lasso counters: {c}")
    hist = [int(v) for v in report.ssp.hist]
    check(hist == [R // (s + 1)] * (s + 1) and check_report(report) is None,
          f"lasso counters: ssp section {report.ssp.to_json()}")
    scan = load_plan(ExecutionPlan, "lasso_pallas.json")
    scan_inst = load_plan(ExecutionPlan, "lasso_pallas.json",
                          telemetry=counters)
    alt = alternately(torch, lasso, cfg, {"scan_counters": scan_inst,
                                          "scan": scan}, X, y, seed)
    return {"plan": inst.to_json(), "launches": launches, "counters": c,
            "ssp": report.ssp.to_json(), "equals_uninstrumented": True,
            "rounds_per_s": R / secs, "alternating_16_scan_rounds": alt}


def span_totals(events: list) -> dict:
    """Each span name's count and total host ms."""
    out: dict = {}
    for e in events:
        if e.get("ph") == "X":
            n, ms = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    return {k: {"count": n, "host_ms": ms} for k, (n, ms) in out.items()}


def lasso_trace_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                      seed: int, loadbal: dict, scan_state) -> dict:
    """``examples/plans/lasso_loadbal.json`` with ``TelemetrySpec(kind=
    "trace", profiler=True)`` and a temporary ``ckpt_dir``, inside a
    torch.profiler window: the state equals the ``lasso_pallas.json``
    scan run's to the bit (as the uninstrumented phase did);
    ``validate_spans`` passes; one ``rebalance`` instant at each boundary
    where ``lasso_loadbal_phase`` saw the version move, with its version
    and the load spreads that phase printed (the same run and arithmetic:
    equal); a ``checkpoint`` span every C rounds and one executor span a
    chunk; each span a ``strads.<name>`` range in the profiler.  The
    Chrome trace goes to ``build/lasso_loadbal.trace.json``; each span
    name's total host ms is returned."""
    import tempfile
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import TelemetrySpec, validate_spans
    from repro_torch.obs.events import RANGE_PREFIX
    spec = TelemetrySpec(kind="trace", profiler=True)
    plan = load_plan(ExecutionPlan, "lasso_loadbal.json",
                     telemetry=spec.to_json())
    R, C = plan.rounds, plan.checkpoint_every
    eng = lasso.make_engine(cfg, workers=plan.workers, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        lc.reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rep = eng.execute(eng.init_state(y=y), data,
                              torch.Generator(device=DEVICE).manual_seed(
                                  seed), plan, ckpt_dir=d)
            torch.cuda.synchronize()
    launches = dict(lc.LAUNCHES)
    check(launches == {"lasso_partial": R, "gram_block": R},
          f"lasso trace: launches {launches}")
    same = {k: torch.equal(rep.state[k], scan_state[k])
            for k in ("beta", "r")}
    check(all(same.values()),
          f"lasso trace: the traced run differs from lasso_pallas.json's: "
          f"{same}, shapes {tuple(rep.state['r'].shape)} and "
          f"{tuple(scan_state['r'].shape)}")
    events = rep.telemetry.events
    err = validate_spans(events)
    check(err is None, f"lasso trace: {err}")
    moves, version = [], 0
    for b in loadbal["boundaries"]:
        if b["version"] != version:
            moves.append(b)
            version = b["version"]
    got = [dict(e["args"]) for e in events if e["name"] == "rebalance"]
    check([(g["t"], g["version"], g["spread_before"], g["spread_after"])
           for g in got]
          == [(b["t"], b["version"], b["spread_before"], b["spread_after"])
              for b in moves],
          f"lasso trace: rebalance instants {got} are not the phase's "
          f"moves {moves}")
    spans = [e for e in events if e["ph"] == "X"]
    ckpts = [e["args"]["t"] for e in spans if e["name"] == "checkpoint"]
    names = [e["name"] for e in spans]
    check(ckpts == list(range(C, R + 1, C))
          and names.count("scan") == R // C and names.count("execute") == 1,
          f"lasso trace: spans {names}, checkpoints at {ckpts}")
    totals = span_totals(events)
    ranges = {}
    for e in prof.events():
        name = e.name[len(RANGE_PREFIX):]
        if e.device_type == DeviceType.CPU and \
                e.name.startswith(RANGE_PREFIX) and name in totals:
            ranges[name] = ranges.get(name, 0) + 1
    check(all(ranges.get(k) == v["count"] for k, v in totals.items()),
          f"lasso trace: record_function ranges {ranges} for spans "
          f"{ {k: v['count'] for k, v in totals.items()} }")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = rep.telemetry.write_chrome_trace(
        os.path.join(ROOT, "build", "lasso_loadbal.trace.json"))
    return {"plan": plan.to_json(), "launches": launches,
            "rebalances": got, "checkpoint_spans_at": ckpts,
            "span_totals": totals, "profiler_ranges": ranges,
            "chrome_trace": os.path.relpath(path, ROOT),
            "events": len(events), "equals_scan_w4": True}


def serve_summary(srep, secs: float, rounds: int, unserved_secs: float,
                  peak_gb: float) -> dict:
    """What every serving run prints: latency percentiles, requests a
    second of wall time, the staleness histogram, rounds/s served and
    unserved, the peak memory."""
    pct = srep.latency_percentiles()
    return {"requests": len(srep.responses), "p50_ms": pct["p50_ms"],
            "p99_ms": pct["p99_ms"],
            "requests_per_s": len(srep.responses) / secs,
            "staleness_hist": {str(k): v for k, v in
                               sorted(srep.staleness_hist().items())},
            "max_staleness_read": srep.max_staleness_read(),
            "rounds_per_s_served": rounds / secs,
            "rounds_per_s_unserved": rounds / unserved_secs,
            "seconds": secs, "peak_memory_gb": peak_gb}


def lasso_serve_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                      seed: int) -> dict:
    """``examples/plans/serve_ssp.json`` as checked in (ssp, 24 rounds,
    s = 2, W = 4) through ``serve_while_training`` with LASSO_REQUESTS
    ``predict`` requests (rows of X drawn from ``--seed``) due across
    rounds 0–24, once with ``ServeSpec("stale", max_staleness=4)`` and
    once with ``ServeSpec("snapshot")``, the launch counts set to 0 just
    before each and read just after (24 and 24).  Checks: the trained
    state equals an unserved ``execute`` of the plan to the bit; the
    stale run reads at staleness 0 and 3 and none above 4 (publishes
    every 3 rounds, the cache refreshed when 6 rounds old), the snapshot
    run at 0; each ŷ within SERVE_TOL·Σ_j|x_j β_j| of xᵀβ in f64, with β
    the unserved run's after round (clock − staleness) of its read
    (collected every round; zero at clock 0)."""
    from repro_torch.serve import ServeSpec, serve_while_training
    plan = load_plan(ExecutionPlan, "serve_ssp.json")
    R = plan.rounds
    check(plan.executor == "ssp" and R == 24 and plan.staleness == 2
          and plan.workers == 4, f"unexpected plan {plan}")
    eng = lasso.make_engine(cfg, workers=plan.workers, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})

    def gen():
        return torch.Generator(device=DEVICE).manual_seed(seed)

    g = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    rows = torch.randint(0, X.shape[0], (LASSO_REQUESTS,), generator=g,
                         device=DEVICE).tolist()
    reqs = [((i * R) // LASSO_REQUESTS, {"x": X[r]})
            for i, r in enumerate(rows)]
    plain = eng.execute(eng.init_state(y=y), data, gen(), plan,
                        collect=lambda st: st["beta"].clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.execute(eng.init_state(y=y), data, gen(), plan)
    torch.cuda.synchronize()
    unserved = time.perf_counter() - t0
    out = {"plan": plan.to_json(), "requests": LASSO_REQUESTS}
    for name, spec in (("stale", ServeSpec("stale", max_staleness=4)),
                       ("snapshot", ServeSpec("snapshot"))):
        lc.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srep = serve_while_training(eng, eng.init_state(y=y), data, gen(),
                                    plan, spec=spec, requests=reqs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = dict(lc.LAUNCHES)
        check(launches == {"lasso_partial": R, "gram_block": R},
              f"lasso serve {name}: launches {launches}")
        st = srep.report.state
        check(torch.equal(st["beta"], plain.state["beta"])
              and torch.equal(st["r"], plain.state["r"]),
              f"lasso serve {name}: training differs from the unserved run")
        hist = srep.staleness_hist()
        want = {0, 3} if name == "stale" else {0}
        check(set(hist) == want and srep.max_staleness_read() <= 4
              and len(srep.responses) == LASSO_REQUESTS,
              f"lasso serve {name}: staleness histogram {hist}")
        worst = 0.0
        # max_batch 1: one read a response, in the requests' order
        for (_, p), resp, read in zip(reqs, srep.responses, srep.reads):
            c = read["clock"]
            beta = (plain.trace[c - 1].double() if c
                    else torch.zeros(X.shape[1], dtype=torch.float64,
                                     device=DEVICE))
            terms = p["x"].double() * beta
            err = abs(float(resp.result["y_hat"]) - float(terms.sum()))
            scale = float(terms.abs().sum())
            check(err <= SERVE_TOL * scale,
                  f"lasso serve {name}: ŷ off xᵀβ at clock {c} by {err} "
                  f"> {SERVE_TOL}·{scale}")
            worst = max(worst, err / scale if scale else err)
        out[name] = {"spec": spec.to_json(), "launches": launches,
                     "max_rel_err": worst,
                     **serve_summary(srep, secs, R, unserved, peak)}
    out["trained_equals_unserved"] = True
    return out


# ---------------------------------------------------------------------------
# Streaming ingest at the chip shapes
# ---------------------------------------------------------------------------

LASSO_STREAM_ROWS = 512        # rows a Lasso drift boundary replaces
LASSO_STREAM_EVERY = 4         # boundaries 4, 8, 12 of lasso_pallas.json
LASSO_SERVE_STREAM_ROWS = 64   # rows a boundary while serving (7 boundaries;
                               # the source's numpy takes ~2 ms a row here)
MF_STREAM_ROWS = 256           # users a boundary brings in
MF_STREAM_EVERY = 8            # boundaries 8, 16, …, 72 of an 80-round sweep
LDA_STREAM_TOKENS = 65_536     # tokens a boundary brings in
STREAM_PEAK_GB = 1.0           # a streamed sweep's peak within this of
                               # the unstreamed one's


def flat_rows(x):
    """A row-split data leaf (W, n/W, …) as a view of its global rows."""
    return x.view(x.shape[0] * x.shape[1], *x.shape[2:])


def backup_rows(torch, data: dict, rows):
    """Save the global ``rows`` of every data leaf; returns a function
    that writes them back (a streamed run writes the data in place, and
    every run here starts from the original data)."""
    import numpy as np
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=DEVICE)
    flats = {k: flat_rows(v) for k, v in data.items()}
    saved = {k: f[idx].clone() for k, f in flats.items()}

    def restore():
        for k, f in flats.items():
            f[idx] = saved[k]
    return restore


def stream_rows(Ingestor, ScheduledSource, spec, deltas: dict, eng,
                data) -> list:
    """The global rows each delta of ``deltas`` ({t: [delta, …]}) lands
    on, by the port's own ring arithmetic (``Ingestor._slots``), in
    order."""
    ing = Ingestor(spec, ScheduledSource(deltas)).bind(eng, data)
    return [ing._slots(d)[0] for t in sorted(deltas) for d in deltas[t]]


def on_card(torch, deltas: dict) -> dict:
    """The same deltas with every array a tensor on the card."""
    def conv(d):
        return {k: ({n: torch.as_tensor(v, device=DEVICE)
                     for n, v in x.items()} if isinstance(x, dict)
                    else torch.as_tensor(x, device=DEVICE))
                for k, x in d.items()}
    return {t: [conv(d) for d in ds] for t, ds in deltas.items()}


def lasso_stream_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                       seed: int) -> dict:
    """Streaming ingest on the Lasso path at n = J = 50,000:
    ``lasso_pallas.json`` as checked in (16 scan rounds, W = 4, the CUDA
    kernels) with ``StreamSpec("replace", ingest_every=4)`` and
    ``LassoDriftSource(rows_per_ingest=512, seed=seed + 2)``: boundaries
    4, 8 and 12 replace 1,536 rows of X and y.  Every run starts from the
    original data (the touched rows are saved first and written back),
    the launch counts set to 0 just before and read just after.

    Checks: an ``EmptySource`` run equals the unstreamed one to the bit;
    the drift run launches 16 ``gram_block`` and 16 ``lasso_partial``,
    its β differs from the unstreamed run's, and at its end r = y − Xβ
    holds in f64 on the final X within STATE_TOL of max(1, |r|); the same
    deltas made once (a ScheduledSource) give the same bits, on scan and
    on loop, as card tensors too; ``kind="reference"`` within STATE_TOL;
    a checkpointed run (every 4 rounds) equals it, its files hold
    ``stream/...``, and a fresh engine resumed from step 8 with
    ``replay_data(..., t_upto=8, stream_state=...)`` on the original data
    equals it to the bit; a traced run gives the ``ingest`` span's host
    ms.  Then ``serve_ssp.json`` through ``serve_while_training`` with
    the stream at one window's cadence (every 3 rounds, 7 boundaries of
    LASSO_SERVE_STREAM_ROWS rows):
    the trained state equals the unserved streamed run's to the bit and
    each ŷ is within SERVE_TOL of the f64 xᵀβ at the clock it read."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import load_flat, restore_checkpoint
    from repro_torch.kernels import KernelSpec
    from repro_torch.obs import TelemetrySpec
    from repro_torch.serve import ServeSpec, serve_while_training
    from repro_torch.stream import (EmptySource, Ingestor,
                                    LassoDriftSource, ScheduledSource,
                                    StreamSpec, replay_data)
    import numpy as np
    plan = load_plan(ExecutionPlan, "lasso_pallas.json")
    splan = load_plan(ExecutionPlan, "serve_ssp.json")
    R, W, sR = plan.rounds, plan.workers, splan.rounds
    check(R == 16 and W == 4 and sR == 24, f"unexpected plans {plan}, "
                                           f"{splan}")
    n, J = X.shape
    eng = lasso.make_engine(cfg, workers=W, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})
    spec = StreamSpec(kind="replace", ingest_every=LASSO_STREAM_EVERY)
    s_every = eng._step_length(splan)                  # one window: 3
    sspec = StreamSpec(kind="replace", ingest_every=s_every)

    def source():
        return LassoDriftSource(num_rows=n, num_features=J,
                                rows_per_ingest=LASSO_STREAM_ROWS,
                                seed=seed + 2)

    t0 = time.perf_counter()
    src = source()
    deltas = {t: src.take(t) for t in range(spec.ingest_every, R,
                                            spec.ingest_every)}
    take_s = (time.perf_counter() - t0) / len(deltas)
    ssrc = LassoDriftSource(num_rows=n, num_features=J,
                            rows_per_ingest=LASSO_SERVE_STREAM_ROWS,
                            seed=seed + 2)
    sdeltas = {t: ssrc.take(t) for t in range(s_every, sR, s_every)}
    rows = np.unique(np.concatenate(
        stream_rows(Ingestor, ScheduledSource, spec, deltas, eng, data)
        + stream_rows(Ingestor, ScheduledSource, sspec, sdeltas, eng,
                      data)))
    restore = backup_rows(torch, data, rows)

    def gen():
        return torch.Generator(device=DEVICE).manual_seed(seed)

    def run(p, source=None, stream=spec, e=None, **kw):
        e = e or eng
        restore()                       # the original data
        state = e.init_state(y=y)
        lc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = e.execute(state, data, gen(), p,
                        stream=stream if source is not None else None,
                        source=source, **kw)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0, dict(lc.LAUNCHES)

    def same(a, b, what):
        check(torch.equal(a.state["beta"], b.state["beta"])
              and torch.equal(a.state["r"], b.state["r"]),
              f"lasso stream: {what}")

    run(plan, ScheduledSource(deltas))                  # warm-up
    plain, plain_s, _ = run(plan)
    empty, empty_s, _ = run(plan, EmptySource())
    same(empty, plain, "the EmptySource run differs from the unstreamed")
    check(int(empty.stream["rows_in"]) == 0, "lasso stream: EmptySource "
                                             "ingested rows")
    drift, drift_s, launches = run(plan, source())
    check(launches == {"lasso_partial": R, "gram_block": R},
          f"lasso stream: launches {launches}, want {R} of each")
    check(not torch.equal(drift.state["beta"], plain.state["beta"]),
          "lasso stream: the drift did not move β")
    check({k: int(v) for k, v in drift.stream.items()} == dict(
        cursor=0, rows_in=3 * LASSO_STREAM_ROWS, rows_dropped=0, fill0=0),
        f"lasso stream: cursor {drift.stream}")
    # r = y − Xβ on the final X, in f64, chunk by chunk of rows
    beta = drift.state["beta"].double()
    r = drift.state["r"].reshape(-1)
    worst, scale = 0.0, 1.0
    for i in range(0, n, 4096):
        r64 = y[i:i + 4096].double() - X[i:i + 4096].double() @ beta
        worst = max(worst, float((r[i:i + 4096].double() - r64).abs()
                                 .max()))
        scale = max(scale, float(r64.abs().max()))
    check(worst <= STATE_TOL * scale, f"lasso stream: r off y − Xβ by "
                                      f"{worst} > {STATE_TOL}·{scale}")
    cached, cached_s, _ = run(plan, ScheduledSource(deltas))
    same(cached, drift, "the same deltas made once differ")
    loop_plan = ExecutionPlan.from_json(dict(plan.to_json(),
                                             executor="loop"))
    loop, loop_s, _ = run(loop_plan, ScheduledSource(deltas))
    same(loop, drift, "loop and scan differ under the stream")
    cards, cards_s, _ = run(plan, ScheduledSource(on_card(torch, deltas)))
    same(cards, drift, "card-tensor deltas differ from numpy ones")
    ref_plan = ExecutionPlan.from_json(dict(
        plan.to_json(), kernels=KernelSpec(kind="reference").to_json()))
    refr, _, ref_launch = run(ref_plan, ScheduledSource(deltas))
    check(not any(ref_launch.values()), "lasso stream: the reference run "
                                        "launched a kernel")
    diffs = {k: float((refr.state[k] - drift.state[k]).abs().max())
             for k in ("beta", "r")}
    check(max(diffs.values()) <= STATE_TOL,
          f"lasso stream: reference differs by {diffs} > {STATE_TOL}")
    # checkpoints every 4 rounds, then a fresh engine resumed from 8
    ck_plan = ExecutionPlan.from_json(dict(plan.to_json(),
                                           checkpoint_every=4))
    d = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        full, _, _ = run(ck_plan, ScheduledSource(deltas), ckpt_dir=d)
        same(full, drift, "the checkpointed run differs")
        keys = sorted(k for k in load_flat(d, 8) if k.startswith("stream/"))
        check(keys == ["stream/cursor", "stream/fill0",
                       "stream/rows_dropped", "stream/rows_in"],
              f"lasso stream: checkpoint stream keys {keys}")
        restore()
        eng2 = lasso.make_engine(cfg, workers=W, device=DEVICE)
        data2 = eng2.shard_data({"X": X, "y": y})
        ck = restore_checkpoint(d, 8, {"state": eng2.init_state(y=y),
                                       "carry": full.carry,
                                       "stream": full.stream})
        data2, _ = replay_data(eng2, data2, spec, ScheduledSource(deltas),
                               8, stream_state=ck["stream"])
        lc.reset_launch_counts()
        rest = eng2.execute(ck["state"], data2,
                            torch.Generator(device=DEVICE), ck_plan,
                            carry=ck["carry"], ckpt_dir=d + "_b",
                            stream=spec, source=ScheduledSource(deltas),
                            stream_state=ck["stream"])
        check(dict(lc.LAUNCHES) == {"lasso_partial": R - 8,
                                    "gram_block": R - 8},
              f"lasso stream: resumed launches {dict(lc.LAUNCHES)}")
        same(rest, drift, "the resumed run differs from the uninterrupted")
    finally:
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(d + "_b", ignore_errors=True)
    traced_plan = ExecutionPlan.from_json(dict(
        plan.to_json(), telemetry=TelemetrySpec(kind="trace").to_json()))
    traced, traced_s, _ = run(traced_plan, ScheduledSource(deltas))
    same(traced, drift, "the traced run differs")
    spans = span_totals(traced.telemetry.events)
    rows_ev = [e["args"] for e in traced.telemetry.events
               if e["name"] == "ingest_rows"]
    check(spans.get("ingest", {}).get("count") == 3 and len(rows_ev) == 3
          and all(a["rows_in"] == LASSO_STREAM_ROWS for a in rows_ev),
          f"lasso stream: ingest events {spans.get('ingest')}, {rows_ev}")

    # serving with the stream at one window's cadence
    restore()
    g = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    req_rows = torch.randint(0, n, (LASSO_REQUESTS,), generator=g,
                             device=DEVICE).tolist()
    reqs = [((i * sR) // LASSO_REQUESTS, {"x": X[r].clone()})
            for i, r in enumerate(req_rows)]
    splain, splain_s, _ = run(splan, ScheduledSource(sdeltas), stream=sspec,
                              collect=lambda st: st["beta"].clone())
    restore()
    sstate = eng.init_state(y=y)
    lc.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srep = serve_while_training(eng, sstate, data, gen(), splan,
                                spec=ServeSpec("stale", max_staleness=4),
                                requests=reqs, stream=sspec,
                                source=ScheduledSource(sdeltas))
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    served_peak = torch.cuda.max_memory_allocated() / 1e9
    s_launch = dict(lc.LAUNCHES)
    check(s_launch == {"lasso_partial": sR, "gram_block": sR},
          f"lasso stream serve: launches {s_launch}")
    same(srep.report, splain, "the served streamed run differs from the "
                              "unserved one")
    check(srep.ingest == splain.stream and int(srep.ingest["rows_in"])
          == len(sdeltas) * LASSO_SERVE_STREAM_ROWS,
          f"lasso stream serve: cursor {srep.ingest}")
    worst_rel = 0.0
    for (_, p), resp, read in zip(reqs, srep.responses, srep.reads):
        c = read["clock"]
        b = (splain.trace[c - 1].double() if c
             else torch.zeros(J, dtype=torch.float64, device=DEVICE))
        terms = p["x"].double() * b
        err = abs(float(resp.result["y_hat"]) - float(terms.sum()))
        sc = float(terms.abs().sum())
        check(err <= SERVE_TOL * sc, f"lasso stream serve: ŷ off xᵀβ at "
                                     f"clock {c} by {err} > "
                                     f"{SERVE_TOL}·{sc}")
        worst_rel = max(worst_rel, err / sc if sc else err)
    check(len(srep.responses) == LASSO_REQUESTS
          and srep.max_staleness_read() <= 4,
          f"lasso stream serve: {len(srep.responses)} responses, "
          f"staleness {srep.staleness_hist()}")
    restore()                           # later phases read the original
    return {
        "plan": plan.to_json(), "stream": spec.to_json(),
        "rows_per_ingest": LASSO_STREAM_ROWS, "boundaries": sorted(deltas),
        "launches": launches, "cursor": {k: int(v) for k, v in
                                         drift.stream.items()},
        "empty_equals_unstreamed": True, "loop_equals_scan": True,
        "card_tensor_deltas_equal_numpy": True,
        "resumed_equals_uninterrupted": True,
        "reference_max_diff": diffs, "residual_f64_max_err": worst,
        "residual_f64_scale": scale,
        "source_take_ms": take_s * 1e3,
        "ingest_span": spans.get("ingest"),
        "ingest_span_ms_per_boundary": spans["ingest"]["host_ms"] / 3,
        "span_totals_traced": spans,
        "seconds": {"unstreamed": plain_s, "empty": empty_s,
                    "drift_fresh_source": drift_s,
                    "drift_made_once": cached_s, "loop": loop_s,
                    "card_tensor_deltas": cards_s, "traced": traced_s},
        "rounds_per_s": {"unstreamed": R / plain_s,
                         "drift_fresh_source": R / drift_s,
                         "drift_made_once": R / cached_s},
        "serve": {"plan": splan.to_json(), "stream": sspec.to_json(),
                  "rows_per_ingest": LASSO_SERVE_STREAM_ROWS,
                  "boundaries": sorted(sdeltas), "launches": s_launch,
                  "trained_equals_unserved": True,
                  "max_rel_err": worst_rel,
                  **serve_summary(srep, served_s, sR, splain_s,
                                   served_peak)},
    }


def mf_stream_runs(torch, mf, ExecutionPlan, cfg, A, mask, gen,
                   seed: int) -> dict:
    """Streaming ingest on MF at the chip shape: one sweep (2K rounds)
    with ``StreamSpec("extend", ingest_every=8)`` and
    ``MFDriftSource(rows_per_ingest=256, density=Netflix's,
    kind="extend", seed=seed + 2)``: boundaries 8, 16, …, 72 bring in
    9 × 256 users, which land on the ring's oldest rows (every row holds
    ratings, so the ring starts full).  Every run starts from the
    original data (the touched rows saved first and written back).

    Checks: the streamed scan sweep's cursor is (2,304, 2,304, 0, the
    valid rows); its objective is finite; its peak memory within
    STREAM_PEAK_GB of the unstreamed sweep's, measured the same way
    (the ingest writes only the rows it names, and no span keeps its
    start state alive), and what each replace-kind sweep adds at its peak
    within STREAM_PEAK_GB of what the unstreamed one adds (the ssp run
    starts while the replace scan run's report is held); the streamed
    loop sweep equals it to the bit, and in it each ingest lands on the rows the
    ring arithmetic gives, with R = (A − WH)·mask in f64 on those rows
    just after their boundary (within STATE_TOL of max(1, |R|)).  Then
    ``kind="replace"`` on scan and on ssp at s = 1, equal to the bit, as
    unstreamed s = 1 is."""
    from repro_torch.stream import (Ingestor, MFDriftSource,
                                    ScheduledSource, StreamSpec)
    import numpy as np
    t_phase = time.perf_counter()
    N, M, K, P = cfg.num_rows, cfg.num_cols, cfg.rank, MF_WORKERS
    R = 2 * K
    density = NETFLIX["ratings"] / (NETFLIX["users"] * NETFLIX["movies"])
    eng = mf.make_engine(cfg, workers=P, device=DEVICE)
    data = eng.shard_data({"A": A, "mask": mask})
    specs = {kind: StreamSpec(kind=kind, ingest_every=MF_STREAM_EVERY)
             for kind in ("extend", "replace")}
    bounds = range(MF_STREAM_EVERY, R, MF_STREAM_EVERY)
    deltas, take_s = {}, {}
    for kind in specs:
        src = MFDriftSource(num_rows=N, num_cols=M,
                            rows_per_ingest=MF_STREAM_ROWS,
                            density=density, kind=kind, seed=seed + 2)
        t0 = time.perf_counter()
        deltas[kind] = {t: src.take(t) for t in bounds}
        take_s[kind] = (time.perf_counter() - t0) / len(bounds) * 1e3
    fill0 = int(mask.any(dim=1).sum())
    rows = np.unique(np.concatenate(sum(
        (stream_rows(Ingestor, ScheduledSource, specs[k], deltas[k], eng,
                     data) for k in specs), [])))
    restore = backup_rows(torch, data, rows)
    obj = eng.app.objective_collect()

    def run(executor, kind=None, staleness=0):
        """(report, seconds, peak GB, peak GB above what was held when
        the run began: the reports this function still keeps hold 9.3
        GB each)"""
        restore()                       # the original data
        state = eng.init_state(A=A, mask=mask, generator=gen())
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        rep = eng.execute(state, data, None, ExecutionPlan(
            executor=executor, rounds=R, workers=P, staleness=staleness),
            collect=obj, stream=specs[kind] if kind else None,
            source=ScheduledSource(deltas[kind]) if kind else None)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        return rep, time.perf_counter() - t0, peak, peak - base

    def same(a, b, what):
        for k in ("W", "H", "R"):
            check(torch.equal(a.state[k], b.state[k]),
                  f"mf stream: {what} ({k})")
        check(torch.equal(a.trace, b.trace), f"mf stream: {what} (trace)")

    plain, plain_s, plain_peak, plain_rise = run("scan")
    del plain
    ext, ext_s, ext_peak, ext_rise = run("scan", "extend")
    n_in = len(bounds) * MF_STREAM_ROWS
    cursor = {k: int(v) for k, v in ext.stream.items()}
    check(cursor == dict(cursor=n_in, rows_in=n_in, rows_dropped=0,
                         fill0=fill0), f"mf stream: cursor {cursor}")
    trace = ext.trace.cpu().tolist()
    check(len(trace) == R and all(map(math.isfinite, trace)),
          "mf stream: the objective is not finite")
    check(abs(ext_peak - plain_peak) <= STREAM_PEAK_GB,
          f"mf stream: peak {ext_peak} GB not within {STREAM_PEAK_GB} GB "
          f"of the unstreamed sweep's {plain_peak} GB")
    # the loop sweep, each ingest checked just after its boundary
    landed, worst = [], [0.0]
    ingest = eng.app.ingest

    def checked(data_, state, rows_, delta):
        out = ingest(data_, state, rows_, delta)
        seen = sum(len(r) for r in landed)
        want_rows = (fill0 + seen + np.arange(len(rows_))) % N
        check(np.array_equal(rows_, want_rows),
              "mf stream: the rows differ from the ring arithmetic")
        landed.append(rows_)
        idx = torch.as_tensor(rows_, device=DEVICE)
        m = flat_rows(data_["mask"])[idx].double()
        want = (flat_rows(data_["A"])[idx].double()
                - flat_rows(state["W"])[idx].double()
                @ state["H"].double()) * m
        err = float((flat_rows(state["R"])[idx].double() - want).abs()
                    .max())
        scale = max(1.0, float(want.abs().max()))
        check(err <= STATE_TOL * scale, f"mf stream: R off (A − WH)·mask "
                                        f"by {err} > {STATE_TOL}·{scale}")
        worst[0] = max(worst[0], err / scale)
        return out

    eng.app.ingest = checked
    try:
        loop, loop_s, _, _ = run("loop", "extend")
    finally:
        del eng.app.ingest
    check(len(landed) == len(bounds), f"mf stream: {len(landed)} ingests")
    same(loop, ext, "loop and scan differ under the stream")
    del loop, ext                       # each holds a 9.3 GB R
    rep_scan, rep_s, rep_peak, rep_rise = run("scan", "replace")
    rep_ssp, ssp_s, ssp_peak, ssp_rise = run("ssp", "replace", staleness=1)
    same(rep_ssp, rep_scan, "ssp at s = 1 and scan differ under the stream")
    # rep_scan is held through the ssp run: compare what each run adds
    for name, rise in (("replace", rep_rise), ("replace on ssp", ssp_rise)):
        check(abs(rise - plain_rise) <= STREAM_PEAK_GB,
              f"mf stream: the {name} sweep adds {rise} GB at its peak, "
              f"not within {STREAM_PEAK_GB} GB of the unstreamed sweep's "
              f"{plain_rise} GB")
    check(rep_ssp.stream == rep_scan.stream
          and int(rep_scan.stream["rows_in"]) == n_in,
          f"mf stream: replace cursor {rep_scan.stream}")
    out = {
        "rounds": R, "rows_per_ingest": MF_STREAM_ROWS,
        "boundaries": list(bounds), "cursor": cursor,
        "objective_end": trace[-1], "loop_equals_scan": True,
        "ssp_s1_equals_scan_replace": True,
        "residual_f64_max_rel_err": worst[0],
        "source_take_ms": take_s,
        "peak_memory_gb": {"unstreamed": plain_peak, "extend": ext_peak,
                           "replace": rep_peak, "replace_ssp_s1": ssp_peak},
        "peak_rise_gb": {"unstreamed": plain_rise, "extend": ext_rise,
                         "replace": rep_rise, "replace_ssp_s1": ssp_rise},
        "seconds": {"unstreamed": plain_s, "extend": ext_s,
                    "extend_loop": loop_s, "replace": rep_s,
                    "replace_ssp_s1": ssp_s},
        "rounds_per_s": {"unstreamed": R / plain_s, "extend": R / ext_s,
                         "replace": R / rep_s,
                         "replace_ssp_s1": R / ssp_s}}
    del rep_scan, rep_ssp
    restore()                           # later runs read the original
    torch.cuda.empty_cache()
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out


def lda_stream_runs(torch, lda, lg, ExecutionPlan, cfg, words, docs, z0,
                    seed: int, scan_rounds_per_s: float) -> dict:
    """Streaming ingest on LDA at the NYTimes shape: two rotations (2U
    rounds) on scan with ``StreamSpec("extend", ingest_every=U)`` and
    ``LDADriftSource(tokens_per_ingest=65,536, seed=seed + 2)``:
    boundary U brings in 65,536 tokens (the corpus has no padding, so
    they land on the oldest slots).  Every run starts from the original
    corpus (the touched slots saved first and written back) and a state
    built from it, the launch counts set to 0 just before and read just
    after.

    Checks: 2U ``lda_gibbs`` launches; the cursor; D, B and s recounted
    from the streamed (words, docs, z) equal the state; every count below
    2²⁴; the log-likelihood finite; the loop run (timed round by round)
    equal to scan to the bit.  The token index rebuild (``gibbs_index``
    after the ingest's in-place write) is timed on its own, and the
    first round after the boundary beside the median round of the loop
    run.  Then ``kind="replace"`` on scan, and the same stream served
    (``ServeSpec("snapshot")``: pins at 0, U and 2U) whose training
    equals the unserved streamed run to the bit."""
    from repro_torch.serve import ServeSpec, serve_while_training
    from repro_torch.stream import (Ingestor, LDADriftSource,
                                    ScheduledSource, StreamSpec)
    import numpy as np
    t_phase = time.perf_counter()
    U, K, T = cfg.num_workers, cfg.num_topics, cfg.tokens_per_worker
    R = 2 * U
    eng = lda.make_engine(cfg, device=DEVICE)
    data = eng.shard_data({"words": words, "docs": docs})
    specs = {kind: StreamSpec(kind=kind, ingest_every=U)
             for kind in ("extend", "replace")}
    deltas, take_ms = {}, {}
    for kind in specs:
        src = LDADriftSource(num_tokens=U * T, vocab=cfg.vocab,
                             num_topics=K, docs_per_worker=cfg.docs_per_worker,
                             tokens_per_ingest=LDA_STREAM_TOKENS, kind=kind,
                             seed=seed + 2)
        t0 = time.perf_counter()
        deltas[kind] = {U: src.take(U)}
        take_ms[kind] = (time.perf_counter() - t0) * 1e3
    fill0 = int((words >= 0).sum())
    rows = np.unique(np.concatenate(sum(
        (stream_rows(Ingestor, ScheduledSource, specs[k], deltas[k], eng,
                     data) for k in specs), [])))
    restore = backup_rows(torch, data, rows)

    def run(executor, kind, callback=None):
        restore()                       # the original corpus
        state = eng.init_state(words=words, docs=docs, z0=z0)
        lg.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.execute(state, data, None, ExecutionPlan(
            executor=executor, rounds=R), callback=callback,
            stream=specs[kind], source=ScheduledSource(deltas[kind]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(lg.LAUNCHES["lda_gibbs"] == R,
              f"lda stream {executor} {kind}: {lg.LAUNCHES['lda_gibbs']} "
              f"launches in {R} rounds")
        return rep, secs

    def same(a, b, what):
        for k in ("z", "D", "B", "s", "s_err"):
            check(torch.equal(a.state[k], b.state[k]),
                  f"lda stream: {what} ({k})")

    ext, ext_s = run("scan", "extend")
    cursor = {k: int(v) for k, v in ext.stream.items()}
    check(cursor == dict(cursor=LDA_STREAM_TOKENS,
                         rows_in=LDA_STREAM_TOKENS, rows_dropped=0,
                         fill0=fill0), f"lda stream: cursor {cursor}")
    flat = eng.unshard(ext.state)
    rec = lda.build_state(cfg, data["words"], data["docs"], flat["z"],
                          device=DEVICE)
    for k in ("D", "B", "s"):
        check(torch.equal(rec[k], flat[k]),
              f"lda stream: {k} recounted from (words, z) differs")
    s_max = float(flat["s"].max())
    check(s_max < 2 ** 24 and float(flat["D"].max()) < 2 ** 24
          and float(flat["B"].max()) < 2 ** 24,
          f"lda stream: a count is not exact in f32 (s max {s_max})")
    ll = float(lda.log_likelihood(cfg, ext.state))
    check(math.isfinite(ll), "lda stream: the log-likelihood is not finite")
    del rec, flat
    # the index rebuild the ingest's write costs, on its own
    Vb = cfg.block_vocab
    idx_ms = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        lg.gibbs_index(data["words"], Vb, U)
        ev[1].record()
        torch.cuda.synchronize()
        idx_ms.append(ev[0].elapsed_time(ev[1]))
    stamps = []

    def stamp(t, s, out):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return False

    loop, loop_s = run("loop", "extend", callback=stamp)
    same(loop, ext, "loop and scan differ under the stream")
    del loop
    round_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    # round_ms[i] is round i + 1's: the first round after boundary U is
    # round U (its sweep rebuilds the index first)
    first_after = round_ms[U - 1]
    steady = sorted(round_ms[U:])[len(round_ms[U:]) // 2]
    rep_scan, rep_s = run("scan", "replace")
    restore()
    start = eng.init_state(words=words, docs=docs, z0=z0)
    reqs = [(t, {"words": words[i * 4096:i * 4096 + LDA_DOC_LEN].clone()})
            for i, t in enumerate((0, U, R))]
    lg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srep = serve_while_training(eng, start, data, None, ExecutionPlan(
        executor="scan", rounds=R), spec=ServeSpec.default_for("snapshot"),
        requests=reqs, stream=specs["replace"],
        source=ScheduledSource(deltas["replace"]))
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    check(lg.LAUNCHES["lda_gibbs"] == R,
          f"lda stream serve: {lg.LAUNCHES['lda_gibbs']} launches")
    same(srep.report, rep_scan, "the served streamed run differs from the "
                                "unserved one")
    clocks = sorted({r["clock"] for r in srep.reads})
    check(srep.ingest == rep_scan.stream and len(srep.responses) == 3
          and set(clocks) <= {0, U, R},
          f"lda stream serve: cursor {srep.ingest}, reads {srep.reads}")
    out = {
        "rounds": R, "tokens_per_ingest": LDA_STREAM_TOKENS,
        "boundaries": [U], "cursor": cursor, "launches": R,
        "counts_recount_exactly": True, "s_max": s_max, "loglik_end": ll,
        "loop_equals_scan": True, "served_equals_unserved": True,
        "served_read_clocks": clocks, "source_take_ms": take_ms, "index_rebuild_ms": sorted(idx_ms)[1],
        "loop_round_ms_first_after_boundary": first_after,
        "loop_round_ms_median_after_boundary": steady,
        "seconds": {"extend": ext_s, "extend_loop": loop_s,
                    "replace": rep_s, "replace_served": served_s},
        "rounds_per_s": {"extend": R / ext_s, "replace": R / rep_s,
                         "replace_served": R / served_s,
                         "unstreamed_rotation_earlier": scan_rounds_per_s}}
    del ext, rep_scan, srep, start
    restore()
    torch.cuda.empty_cache()
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out


def serve_cli_stream_run() -> dict:
    """``python -m repro_torch.launch.serve --engine lda --stream
    --requests 32`` as a subprocess on the card: it must exit 0 and print
    ``rows ingested=`` with a count above 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
           "lda", "--stream", "--requests", "32"]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(p.returncode == 0, f"serve CLI --stream exited {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    got = [ln for ln in p.stdout.splitlines()
           if ln.startswith("rows ingested=")]
    n_in = int(got[0].split("=")[1].split()[0]) if got else 0
    check(n_in > 0, f"serve CLI --stream ingested nothing: {p.stdout}")
    return {"command": " ".join(cmd[1:]), "seconds": secs,
            "rows_ingested": n_in,
            "stdout": p.stdout.strip().splitlines()}


# ---------------------------------------------------------------------------
# STRADS MF at the Netflix Prize shape, STRADS LDA at the NYTimes shape
# ---------------------------------------------------------------------------

# Netflix Prize: 100,480,507 ratings of 17,770 movies by 480,189 users
NETFLIX = dict(users=480_189, movies=17_770, ratings=100_480_507)
MF_USERS = 131_072             # users cut to what the dense layout holds
MF_RANK, MF_PLANTED, MF_LAM, MF_WORKERS = 40, 20, 0.05, 4
MF_ALS_USERS = 8_192
MF_W_TOL = 1e-3                # W = 1 vs W = 4: |Δx| ≤ MF_W_TOL·max|x| (f32
                               # sums over other row splits, 80 CD rounds)
MF_MONO_TOL = 1e-6             # obj(t+1) ≤ obj(t)·(1 + MF_MONO_TOL)
# UCI NYTimes bag of words: 299,752 documents, 102,660 words, ~99.5 M tokens
NYTIMES = dict(docs=299_752, vocab=102_660)
LDA_TOPICS, LDA_WORKERS = 1_000, 128
LDA_TOKENS_PER_WORKER = 777_344     # 128 × 777,344 = 99,500,032 tokens
LDA_DOCS_PER_WORKER = 2_342         # 128 × 2,342 ≥ 299,752 documents
LDA_SEED = 17                       # StradsLDA's Philox seed (lda.STRADS_SEED)
LDA_BAND = 0.10                # |LL(Philox) − LL(plain, torch draws)| after a
                               # rotation ≤ LDA_BAND × the plain path's climb
LDA_BAND_CFG = dict(vocab=5_000, num_topics=100, num_workers=16,
                    tokens_per_worker=16_000, docs_per_worker=500)
LDA_BASELINE_WORKERS = 16      # the baseline on the corpus's first eighth
LDA_BASELINE_CHECK = (4, 2_048)     # its workers and leading tokens held
                                    # against the plain version
GUMBEL_DRAWS = (LDA_WORKERS, 800)   # slots × K = 1.024e8 Philox draws
EULER_GAMMA = 0.5772156649015329
LDA_LOGF_PER_TOPIC = 4         # log(γ + B), log(α + D), two in the Gumbel draw
LDA_OTHER_OPS_PER_TOPIC = 6    # 5 adds, 1 compare (Philox's integer work and
                               # log(vg + s̃), kept per topic, not counted)
SFU_SLOTS = 8                  # an SFU (MUFU) result takes 8 FMA lanes' time
                               # on sm_90: 16 a clock an SM against 128 (CUDA
                               # C++ Programming Guide, instruction throughput)
LOGF_PROBE = r"""
extern "C" __global__ void probe_logf(const float* x, float* y) {
  y[threadIdx.x] = logf(x[threadIdx.x]);
}
extern "C" __global__ void probe_copy(const float* x, float* y) {
  y[threadIdx.x] = x[threadIdx.x];
}
"""


def mf_phase(torch, mf, ExecutionPlan, seed: int) -> dict:
    """STRADS MF at the Netflix Prize shape with the users cut to
    MF_USERS: one full sweep (2K rounds) on scan, then on loop (equal to
    the bit), then at W = 1; the objective must fall every round within
    MF_MONO_TOL; rounds/s, a profiler window of 4 rounds and the peak
    memory; then ALS and STRADS side by side on the first MF_ALS_USERS
    users."""
    from repro_torch.obs import TelemetrySpec
    N, M, K, P = MF_USERS, NETFLIX["movies"], MF_RANK, MF_WORKERS
    density = NETFLIX["ratings"] / (NETFLIX["users"] * NETFLIX["movies"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A, mask = mf.synthetic_ratings_device(seed, N, M, MF_PLANTED,
                                          density=density, device=DEVICE)
    torch.cuda.synchronize()
    res = {"users": N, "movies": M, "rank": K, "planted_rank": MF_PLANTED,
           "lam": MF_LAM, "workers": P, "density": density,
           "observed": int(mask.sum().item()),
           "data_seconds": time.perf_counter() - t0,
           "dense_gb_each": A.numel() * 4 / 1e9,
           "data_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"mf: A, mask ({N}, {M}) f32, {res['dense_gb_each']:.2f} GB each, "
          f"{res['observed']} ratings, built in {res['data_seconds']:.2f} s")
    cfg = mf.MFConfig(num_rows=N, num_cols=M, rank=K, lam=MF_LAM)
    R = 2 * K

    def gen():
        return torch.Generator(device=DEVICE).manual_seed(seed)

    def run(workers, executor, rounds=R, collect=True, staleness=0,
            telemetry=False):
        eng = mf.make_engine(cfg, workers=workers, device=DEVICE)
        data = eng.shard_data({"A": A, "mask": mask})
        state = eng.init_state(A=A, mask=mask, generator=gen())
        obj = eng.app.objective_collect()
        obj0 = float(obj(state))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.execute(state, data, None, ExecutionPlan(
            executor=executor, rounds=rounds, workers=workers,
            staleness=staleness,
            telemetry=TelemetrySpec(kind="counters") if telemetry
            else False), collect=obj if collect else None)
        torch.cuda.synchronize()
        return (eng, data, rep, time.perf_counter() - t0, obj0,
                torch.cuda.max_memory_allocated() / 1e9)

    run(P, "scan", rounds=2, collect=False)               # warm-up
    eng, data, scan, secs, obj0, peak = run(P, "scan")
    _, _, loop, loop_secs, _, _ = run(P, "loop")
    for k in ("W", "H", "R"):
        check(torch.equal(scan.state[k], loop.state[k]),
              f"mf: loop and scan differ in {k} on the card")
    check(torch.equal(scan.trace, loop.trace), "mf: the objective traces of "
                                               "loop and scan differ")
    del loop
    trace = scan.trace.cpu().tolist()
    check(len(trace) == R and all(map(math.isfinite, trace)),
          "mf: the objective trace is not finite")
    rises = [t for t in range(R) if trace[t] > (trace[t - 1] if t else obj0)
             * (1 + MF_MONO_TOL)]
    check(not rises, f"mf: the objective rose in rounds {rises}")
    check(trace[-1] < obj0, f"mf: the objective did not fall: {trace[-1]} "
                            f">= {obj0}")
    # the pipelined executor: round-robin schedules read no state, so it
    # equals scan to the bit
    _, _, pipe, pipe_secs, _, _ = run(P, "pipelined")
    for k in ("W", "H", "R"):
        check(torch.equal(scan.state[k], pipe.state[k]),
              f"mf: pipelined and scan differ in {k} on the card")
    check(torch.equal(scan.trace, pipe.trace), "mf: the objective traces of "
                                               "pipelined and scan differ")
    check(pipe.carry.depth == 1, "mf: the pipelined carry holds no "
                                 "in-flight schedule")
    del pipe
    ssp = mf_ssp_runs(torch, run, scan, R, peak, obj0)
    obs = mf_counters_run(torch, run, scan, cfg)
    serving = mf_serve_run(torch, mf, ExecutionPlan, cfg, A, mask, gen,
                           scan.state, ssp["rounds_per_s"]["s1"], seed)
    ckpt = mf_checkpoint_run(torch, mf, ExecutionPlan, cfg, A, mask, gen,
                             scan.state)
    stream = mf_stream_runs(torch, mf, ExecutionPlan, cfg, A, mask, gen,
                            seed)
    _, _, one, one_secs, _, _ = run(1, "scan")
    diffs = {}
    for k in ("W", "H", "R"):
        a = scan.state[k].reshape(-1)
        b = one.state[k].reshape(-1)
        diffs[k] = float((a - b).abs().max() / a.abs().max())
        check(diffs[k] <= MF_W_TOL, f"mf: W = 1 and W = {P} differ in {k} by "
                                    f"{diffs[k]} of its largest value > "
                                    f"{MF_W_TOL}")
    obj_w1 = float(one.trace[-1])
    del one
    obj_fn = eng.app.objective_collect()
    res.update(
        rounds=R, objective_start=obj0, objective_end=trace[-1],
        objective_w1_end=obj_w1, loop_equals_scan=True,
        max_rel_diff_w1_vs_w4=diffs,
        rounds_per_s={"scan": R / secs, "loop": R / loop_secs,
                      "scan_w1": R / one_secs, "pipelined": R / pipe_secs},
        seconds={"scan": secs, "loop": loop_secs, "scan_w1": one_secs,
                 "pipelined": pipe_secs},
        pipelined_equals_scan=True, checkpoint=ckpt, ssp=ssp,
        counters=obs, serve=serving, stream=stream,
        objective_ms=time_ms(torch, lambda: obj_fn(scan.state), iters=10,
                             warmup=2),
        peak_memory_gb=peak)
    # the profiler window last: a session slows the host's later launches
    st = scan.state
    res["profile"] = profile_window(torch, lambda: eng.execute(
        st, data, None, ExecutionPlan(executor="scan", rounds=4, workers=P)))
    del scan, st, data, eng
    torch.cuda.empty_cache()

    # ALS against STRADS on the first MF_ALS_USERS users
    n = min(MF_ALS_USERS, N)
    A8, m8 = A[:n], mask[:n]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, als_trace = mf.als_fit(A8, m8, K, MF_LAM, 2, generator=gen(),
                              device=DEVICE)
    torch.cuda.synchronize()
    als_s = time.perf_counter() - t0
    cfg8 = mf.MFConfig(num_rows=n, num_cols=M, rank=K, lam=MF_LAM)
    t0 = time.perf_counter()
    _, s_trace = mf.fit(cfg8, A8, m8, plan=ExecutionPlan(
        executor="scan", rounds=R, workers=P, collect_every=R),
        generator=gen(), device=DEVICE)
    torch.cuda.synchronize()
    strads_s = time.perf_counter() - t0
    check(all(math.isfinite(v) for _, v in als_trace + s_trace),
          "mf: an ALS or STRADS objective is not finite")
    res["als_vs_strads"] = {
        "users": n, "als_iterations": 2,
        "als_objective": [v for _, v in als_trace], "als_seconds": als_s,
        "strads_rounds": R, "strads_objective": s_trace[-1][1],
        "strads_seconds": strads_s}
    del A, mask, A8, m8
    torch.cuda.empty_cache()
    return res


def mf_ssp_runs(torch, run, scan, R: int, scan_peak_gb: float,
                obj0: float) -> dict:
    """MF on the SSP executor at the chip shape: s = 1 over the sweep's
    R rounds (a window is one H/W cycle: the H push reads a fresh
    snapshot and the W commit recomputes from flush-time state) equal to
    the ``scan`` run to the bit; s = 2 over R − 2 rounds (a multiple of
    lcm(3, 2)), whose objective must fall, beside ``scan`` over as many
    rounds.  The peak memory of each within 1 GB of that scan run's
    (all three run while the first scan run's report holds its R, which
    ``scan_peak_gb`` did not): the cache holds a reference to H, never a
    copy of R, and no window keeps its start's R alive."""
    _, _, s1, s1_secs, _, s1_peak = run(MF_WORKERS, "ssp", staleness=1)
    for k in ("W", "H", "R"):
        check(torch.equal(scan.state[k], s1.state[k]),
              f"mf: ssp at s = 1 and scan differ in {k} on the card")
    check(torch.equal(scan.trace, s1.trace), "mf: the objective traces of "
                                             "ssp at s = 1 and scan differ")
    check(s1.carry.clocks.tolist() == [R] * MF_WORKERS,
          f"mf: ssp clocks {s1.carry.clocks.tolist()}")
    del s1
    R2 = R - R % 6
    _, _, s2, s2_secs, _, s2_peak = run(MF_WORKERS, "ssp", rounds=R2,
                                        staleness=2)
    tr2 = s2.trace.cpu().tolist()
    del s2
    check(len(tr2) == R2 and all(map(math.isfinite, tr2)) and tr2[-1] < obj0,
          f"mf: ssp at s = 2: the objective did not fall: {obj0} → "
          f"{tr2[-1]}")
    rises = [t for t in range(R2) if tr2[t] > (tr2[t - 1] if t else obj0)
             * (1 + MF_MONO_TOL)]
    _, _, sc2, sc2_secs, _, sc2_peak = run(MF_WORKERS, "scan", rounds=R2)
    scan_end = float(sc2.trace[-1])
    del sc2
    for name, p in (("s1", s1_peak), ("s2", s2_peak)):
        check(abs(p - sc2_peak) <= 1.0,
              f"mf: ssp {name} peak {p} GB is not within 1 GB of scan's "
              f"{sc2_peak} GB")
    torch.cuda.empty_cache()
    return {"s1_rounds": R, "s1_equals_scan": True,
            "s2_rounds": R2, "s2_objective_end": tr2[-1],
            "scan_objective_end_same_rounds": scan_end,
            "s2_objective_rises_in_rounds": rises,
            "rounds_per_s": {"s1": R / s1_secs, "s2": R2 / s2_secs,
                             "scan_same_rounds_as_s2": R2 / sc2_secs},
            "seconds": {"s1": s1_secs, "s2": s2_secs,
                        "scan_same_rounds_as_s2": sc2_secs},
            "peak_memory_gb": {"s1": s1_peak, "s2": s2_peak,
                               "scan": scan_peak_gb,
                               "scan_same_rounds_as_s2": sc2_peak}}


def in_turns(once) -> dict:
    """``once(instrumented)`` timed in turns (plain, counters, counters,
    plain): the card's clock drifts over a run (a warmer card), so only
    runs taken together are compared.  Returns the seconds of each arm
    and the ratio of their means (plain over counters: 1 = no cost)."""
    secs = {False: [], True: []}
    for inst in (False, True, True, False):
        secs[inst].append(once(inst))
    mean = {k: sum(v) / len(v) for k, v in secs.items()}
    return {"seconds_plain": secs[False], "seconds_counters": secs[True],
            "rate_ratio": mean[False] / mean[True]}


def mf_counters_run(torch, run, scan, cfg) -> dict:
    """One sweep on scan with ``TelemetrySpec(kind="counters")`` and
    without, in turns (:func:`in_turns`): each instrumented run equal to
    the first scan run to the bit (state and objective trace);
    rounds_per_phase [K, K] (the H and W halves), the rank blocks' width
    counted each round with proposed = accepted (no filter runs); the
    mean rates within OBS_RATE_TOL (MF's round is device-bound, so a few
    counter ops a round should cost nothing that shows)."""
    R = 2 * cfg.rank
    seen = {}

    def once(inst):
        _, _, rep, secs, _, _ = run(MF_WORKERS, "scan", telemetry=inst)
        if inst:
            for k in ("W", "H", "R"):
                check(torch.equal(scan.state[k], rep.state[k]),
                      f"mf counters: the instrumented run differs in {k}")
            check(torch.equal(scan.trace, rep.trace),
                  "mf counters: the objective traces differ")
            seen["c"] = rep.telemetry.counters
        return secs

    turns = in_turns(once)
    c = seen["c"]
    width = R * cfg.ranks_per_round
    check(c["rounds"] == R and c["rounds_per_phase"] == [R // 2, R // 2]
          and c["sched_size"] == c["proposed"] == c["accepted"] == width
          and c["killed"] == 0, f"mf counters: {c}")
    check(abs(turns["rate_ratio"] - 1) <= OBS_RATE_TOL,
          f"mf counters: rate ratio {turns['rate_ratio']} (in turns "
          f"{turns}) outside {OBS_RATE_TOL}")
    torch.cuda.empty_cache()
    return {"counters": c, "equals_uninstrumented": True, **turns,
            "rounds_per_s": R * 2 / sum(turns["seconds_counters"]),
            "rounds_per_s_uninstrumented":
            R * 2 / sum(turns["seconds_plain"])}


def mf_serve_run(torch, mf, ExecutionPlan, cfg, A, mask, gen, scan_state,
                 unserved_rps: float, seed: int) -> dict:
    """MF_REQUESTS ``recommend`` requests (users drawn from ``--seed``)
    due across an ``ssp`` sweep at s = 1, ``ServeSpec.default_for(
    "stale", max_staleness=1)`` (batches of 8).  Checks: the trained
    state equals the scan sweep's to the bit (ssp at s = 1 does); each
    batch's top-k items against an f64 recount of W_u·H from the very
    tensors the query read: the f64 scores of the served items equal the
    f64 top-k's position by position within MF_TIE_TOL·max|score| (items
    whose f64 scores are that close may swap in f32; how many rows
    differ in order or set is reported).  The rounds/s beside the
    unserved ssp sweep's (``mf_ssp_runs``, with the same collect)."""
    from repro_torch.serve import ServeSpec, serve_while_training
    P, R = MF_WORKERS, 2 * cfg.rank
    eng = mf.make_engine(cfg, workers=P, device=DEVICE)
    data = eng.shard_data({"A": A, "mask": mask})
    g = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    users = torch.randint(0, cfg.num_rows, (MF_REQUESTS,), generator=g,
                          device=DEVICE)
    reqs = [((i * R) // MF_REQUESTS, {"user": users[i]})
            for i in range(MF_REQUESTS)]
    seen = []
    query = eng.app.query

    def recording(state, batch):
        out = query(state, batch)
        u = batch["user"].long()
        seen.append((state["W"].reshape(-1, cfg.rank)[u].clone(),
                     state["H"].clone(), out["items"].clone()))
        return out

    eng.app.query = recording
    spec = ServeSpec.default_for("stale", max_staleness=1)
    plan = ExecutionPlan(executor="ssp", rounds=R, workers=P, staleness=1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srep = serve_while_training(
        eng, eng.init_state(A=A, mask=mask, generator=gen()), data, None,
        plan, spec=spec, requests=reqs,
        collect=eng.app.objective_collect())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    for k in ("W", "H", "R"):
        check(torch.equal(srep.report.state[k], scan_state[k]),
              f"mf serve: training differs from the scan sweep in {k}")
    srep.report = None
    k = min(cfg.top_k, cfg.num_cols)
    worst, rows_differ = 0.0, 0
    for Wu, H, items in seen:
        s64 = Wu.double() @ H.double()
        top = torch.sort(s64, dim=-1, descending=True, stable=True)
        dev = float(((s64.gather(1, items) - top.values[:, :k]).abs()
                     .amax(1) / s64.abs().amax(1)).max())
        worst = max(worst, dev)
        rows_differ += int((items != top.indices[:, :k]).any(1).sum())
    check(len(srep.responses) == MF_REQUESTS and worst <= MF_TIE_TOL,
          f"mf serve: served top-{k} scores off the f64 recount by {worst} "
          f"of the largest score > {MF_TIE_TOL}")
    unserved = R / unserved_rps
    out = {"spec": spec.to_json(), "plan": plan.to_json(), "top_k": k,
           "batches": len(seen), "max_rel_score_gap": worst,
           "rows_in_another_order": rows_differ,
           "trained_equals_scan": True,
           **serve_summary(srep, secs, R, unserved, peak)}
    del seen, srep
    torch.cuda.empty_cache()
    return out


def mf_checkpoint_run(torch, mf, ExecutionPlan, cfg, A, mask, gen,
                      scan_state) -> dict:
    """One sweep (2K rounds) on scan under a ``load_balanced`` partitioner
    (EMA 0.5, threshold 0.1), chunked at its middle with a temporary
    ``ckpt_dir``: two files, and the state equal to the unchunked scan
    run's to the bit (ownership is bookkeeping).  Then a fresh engine
    resumed from the middle file (state, carry and ``partition=``)
    equals it too.  Records the boundaries' host ms and each
    checkpoint's bytes and write ms (:class:`BoundaryTimer`), and the
    restore's seconds.  The final file is removed before the resumed
    run writes its own, so the disk holds two at a time."""
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core import engine as engine_mod
    from repro_torch.part import PartitionerSpec
    P, R = MF_WORKERS, 2 * cfg.rank
    plan = ExecutionPlan(executor="scan", rounds=R, workers=P,
                         checkpoint_every=R // 2,
                         partitioner=PartitionerSpec(
                             kind="load_balanced", ema=0.5,
                             imbalance_threshold=0.1))
    eng = mf.make_engine(cfg, workers=P, device=DEVICE)
    data = eng.shard_data({"A": A, "mask": mask})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mf_") as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with BoundaryTimer(torch, eng, engine_mod) as timer:
            rep = eng.execute(eng.init_state(A=A, mask=mask,
                                             generator=gen()),
                              data, None, plan, ckpt_dir=d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        files = sorted(os.listdir(d))
        check(files == [f"step_{t:08d}.npz" for t in (R // 2, R)],
              f"mf checkpoints: files {files}")
        for k in ("W", "H", "R"):
            check(torch.equal(rep.state[k], scan_state[k]),
                  f"mf: the chunked load_balanced run differs in {k} from "
                  f"scan")
        eng2 = mf.make_engine(cfg, workers=P, device=DEVICE)
        eng2.set_partitioner(plan.partitioner)
        template = {"state": rep.state, "carry": rep.carry,
                    "assignment": eng.partition_payload()}
        del rep
        os.remove(os.path.join(d, files[-1]))
        t0 = time.perf_counter()
        back = restore_checkpoint(d, R // 2, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del template
        res = eng2.execute(back["state"], eng2.shard_data({"A": A,
                                                           "mask": mask}),
                           None, plan, carry=back["carry"],
                           partition=back["assignment"], ckpt_dir=d)
        del back
        for k in ("W", "H", "R"):
            check(torch.equal(res.state[k], scan_state[k]),
                  f"mf: the run resumed from step {R // 2} differs in {k}")
        check(eng2.partition_assignment == eng.partition_assignment,
              "mf: the resumed run ends on another assignment")
    out = {"rounds": R, "checkpoint_every": R // 2, "files": files,
           "seconds": secs, "restore_seconds": restore_s,
           "final_version": eng.partition_assignment.version,
           **timer.summary(), "equals_scan": True,
           "resumed_equals_scan": True}
    del res
    torch.cuda.empty_cache()
    return out


def lda_ssp_runs(torch, lda, lg, ExecutionPlan, cfg, eng, data, words,
                 docs, scan, inits: list, ll0: float) -> dict:
    """LDA on the SSP executor at the chip shape, each run from its own
    copy of the start (``inits``: the push writes z, B, D in place), with
    the launch counts set to 0 just before each run and read just after:
    s = 0 over one rotation (U launches) equal to the ``scan`` run to the
    bit; s = 2 over lcm(3, U) rounds (as many launches), whose z, D, B
    and s recount from z on the card, s equal to B's column sums, the
    token count kept, the log-likelihood up; and ``scan`` over as many
    rounds beside it."""
    U = cfg.num_workers
    L2 = math.lcm(3, U)
    out: dict = {"launches": {}, "rounds_per_s": {}, "seconds": {}}

    def timed(name, state, executor, rounds, staleness=0):
        lg.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.execute(state, data, None, ExecutionPlan(
            executor=executor, rounds=rounds, staleness=staleness),
            collect=lambda s: s["s_err"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out["launches"][name] = lg.LAUNCHES["lda_gibbs"]
        out["rounds_per_s"][name] = rounds / secs
        out["seconds"][name] = secs
        check(out["launches"][name] == rounds,
              f"lda {name}: lda_gibbs launched {out['launches'][name]} "
              f"times in {rounds} rounds")
        return rep

    s0 = timed("ssp_s0", inits[0], "ssp", U)
    for k in ("z", "D", "B", "s", "s_err"):
        check(torch.equal(scan.state[k], s0.state[k]),
              f"lda: ssp at s = 0 and scan differ in {k} on the card")
    check(torch.equal(scan.trace, s0.trace), "lda: the s-error traces of "
                                             "ssp at s = 0 and scan differ")
    del s0
    s2 = timed("ssp_s2", inits[1], "ssp", L2, staleness=2)
    flat = eng.unshard(s2.state)
    rec = lda.build_state(cfg, words, docs, flat["z"], device=DEVICE)
    for k in ("D", "B", "s"):
        check(torch.equal(rec[k], flat[k]),
              f"lda ssp: {k} recounted from z differs from the state")
    n_tok = int((words >= 0).sum())
    check(torch.equal(flat["s"], flat["B"].sum(0))
          and int(flat["B"].double().sum()) == n_tok
          and int(flat["D"].double().sum()) == n_tok,
          "lda ssp: s is not B's column sums, or a token was lost")
    z = flat["z"]
    check(int(z.min()) >= 0 and int(z.max()) < cfg.num_topics,
          "lda ssp: z out of [0, K)")
    ll2 = float(lda.log_likelihood(cfg, s2.state))
    check(math.isfinite(ll2) and ll2 > ll0,
          f"lda ssp: the log-likelihood did not rise: {ll0} → {ll2}")
    s_errs = s2.trace.cpu().tolist()
    del s2, flat, rec, z
    sc = timed("scan_same_rounds", inits[2], "scan", L2)
    ll_scan = float(lda.log_likelihood(cfg, sc.state))
    del sc
    torch.cuda.empty_cache()
    out.update(s0_rounds=U, s0_equals_scan=True, s2_rounds=L2,
               s2_counts_recount_exactly=True, tokens=n_tok,
               s2_loglik_end=ll2, scan_loglik_end_same_rounds=ll_scan,
               s2_s_err_max=max(s_errs), s2_s_err_last=s_errs[-1])
    return out


def fingerprint(torch, tree: dict) -> dict:
    """Two f64 sums a leaf (plain and position-weighted): a change to any
    count or topic shows."""
    out = {}
    for k, v in tree.items():
        x = v.reshape(-1).double()
        w = torch.arange(x.numel(), device=x.device,
                         dtype=torch.float64).remainder_(9973).add_(1)
        out[k] = (float(x.sum()), float((x * w).sum()))
        del x, w
    return out


def lda_fold_in_f64(torch, cfg, pin: dict, words, iters: int):
    """θ of a batch of documents from the pinned B and s, recomputed
    plainly in float64: φ_lk ∝ (γ + B[v_l, k]) / (Vγ + s_k), θ
    re-estimated ``iters`` times from uniform (the fold-in's
    definition)."""
    K = cfg.num_topics
    Bf = pin["B"].reshape(-1, K).double()
    active = (words >= 0)[..., None]
    v = words.long().clamp(0, cfg.padded_vocab - 1)
    phi = (cfg.gamma + Bf[v]) / (cfg.padded_vocab * cfg.gamma
                                 + pin["s"].double())
    phi = torch.where(active, phi, torch.ones_like(phi))
    theta = torch.full((words.shape[0], K), 1.0 / K, dtype=torch.float64,
                       device=words.device)
    for _ in range(iters):
        q = phi * theta[:, None, :]
        q = q / q.sum(-1, keepdim=True)
        q = torch.where(active, q, torch.zeros_like(q))
        theta = cfg.alpha + q.sum(1)
        theta = theta / theta.sum(-1, keepdim=True)
    return theta


def lda_obs_serve(torch, lda, lg, ExecutionPlan, cfg, eng, data, words,
                  scan, start: dict, seed: int):
    """Telemetry and serving on LDA's main path at the chip shape.  The
    push writes z, B, D in place, so every run but the served one starts
    from a working copy reset to ``start`` (a copy of the start state),
    and the served run takes ``start`` itself; the launch counts are set
    to 0 just before each run and read just after.

    Counters: a rotation on scan with ``TelemetrySpec(kind="counters")``
    and without, in turns (:func:`in_turns`; U launches each), each
    instrumented run equal to the first scan run to the bit;
    rounds_per_phase U ones, proposed = accepted (the rotation's schedule
    is implicit: no width, nothing filtered); the mean rates within
    OBS_RATE_TOL (the sweep is device-bound).

    Serving: 2U rounds on scan through ``serve_while_training`` with
    ``ServeSpec.default_for("snapshot")`` (a pin at every rotation: t =
    0, U, 2U) and LDA_REQUESTS ``infer_topics`` requests of held-out
    documents (LDA_DOC_LEN words drawn from the corpus's tokens by
    ``--seed``; −1 padding drawn among them is inert), beside an unserved
    run of the same plan.  Checks: 2U launches each; the served run's
    state equals the unserved one's to the bit; every pin's fingerprint
    after the run equals the one at its publish, though the next
    rotations wrote the live tensors in place (the live B's differs from
    the first pin's); each θ within LDA_THETA_TOL of a float64
    recomputation from the pin its batch read."""
    from repro_torch.obs import TelemetrySpec
    from repro_torch.serve import ServeSpec, serve_while_training
    from repro_torch.serve import view as view_mod
    U = cfg.num_workers
    work = {k: v.clone() for k, v in start.items()}
    counted = {}

    def timed(plan, **kw):
        for k in work:
            work[k].copy_(start[k])
        lg.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.execute(work, data, None, plan, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(lg.LAUNCHES["lda_gibbs"] == plan.rounds,
              f"lda: {lg.LAUNCHES['lda_gibbs']} launches in {plan.rounds} "
              f"rounds")
        return rep, secs

    def once(inst):
        rep, secs = timed(ExecutionPlan(
            executor="scan", rounds=U,
            telemetry=TelemetrySpec(kind="counters") if inst else False),
            collect=lambda s: s["s_err"])
        if inst:
            for k in ("z", "D", "B", "s", "s_err"):
                check(torch.equal(scan.state[k], rep.state[k]),
                      f"lda counters: the instrumented run differs in {k}")
            check(torch.equal(scan.trace, rep.trace),
                  "lda counters: the s-error traces differ")
            counted["c"] = rep.telemetry.counters
        return secs

    turns = in_turns(once)
    c = counted["c"]
    check(c["rounds_per_phase"] == [1] * U and c["rounds"] == U
          and c["proposed"] == c["accepted"] and c["killed"] == 0,
          f"lda counters: {c}")
    check(abs(turns["rate_ratio"] - 1) <= OBS_RATE_TOL,
          f"lda counters: rate ratio {turns['rate_ratio']} (in turns "
          f"{turns}) outside {OBS_RATE_TOL}")
    obs = {"counters": c, "equals_uninstrumented": True, **turns,
           "rounds_per_s": U * 2 / sum(turns["seconds_counters"]),
           "rounds_per_s_uninstrumented":
           U * 2 / sum(turns["seconds_plain"])}

    R = 2 * U
    plan = ExecutionPlan(executor="scan", rounds=R)
    pin_gb = sum(v.numel() * v.element_size() for v in start.values()) / 1e9
    held_now = torch.cuda.memory_allocated() / 1e9
    print(f"lda serving: a pin is {pin_gb:.2f} GB; {held_now:.2f} GB held; "
          f"the run keeps its 3 pins alive for the checks: reckoned peak "
          f"~{held_now + 3 * pin_gb + 2 * pin_gb:.1f} GB (with a rotation's "
          f"transients and the fingerprints' f64 copies)")
    ref, unserved = timed(plan)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    pos = torch.randint(0, words.numel(), (LDA_REQUESTS, LDA_DOC_LEN),
                        generator=g, device=DEVICE)
    held = words.reshape(-1)[pos]
    reqs = [((i * R) // LDA_REQUESTS, {"words": held[i]})
            for i in range(LDA_REQUESTS)]
    seen, pins = [], []
    query = eng.app.query

    def recording(state, batch):
        out = query(state, batch)
        seen.append((state, batch["words"].clone(), out["theta"].clone()))
        return out

    publish = view_mod.ModelView.publish

    def pinning(self, state, t):
        publish(self, state, t)
        pins.append((int(t), self._pinned, fingerprint(torch,
                                                       self._pinned)))

    eng.app.query = recording
    live = start
    torch.cuda.reset_peak_memory_stats()
    lg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(view_mod.ModelView, publish=pinning):
        srep = serve_while_training(eng, live, data, None, plan,
                                    spec=ServeSpec.default_for("snapshot"),
                                    requests=reqs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng.app.query
    launches = lg.LAUNCHES["lda_gibbs"]
    check(launches == R, f"lda serve: {launches} launches in {R} rounds")
    for k in ("z", "D", "B", "s", "s_err"):
        check(torch.equal(srep.report.state[k], ref.state[k]),
              f"lda serve: training differs from the unserved run in {k}")
    check([t for t, _, _ in pins] == [0, U, R],
          f"lda serve: pins at {[t for t, _, _ in pins]}")
    for t, pin, fp in pins:
        check(fingerprint(torch, pin) == fp,
              f"lda serve: the pin of t = {t} changed after its publish")
    check(fingerprint(torch, {"B": live["B"]})["B"] != pins[0][2]["B"],
          "lda serve: the live B was not written after the first pin")
    worst = 0.0
    for pin, w, theta in seen:
        want = lda_fold_in_f64(torch, cfg, pin, w, eng.app.query_iters)
        worst = max(worst, float((theta.double() - want).abs().max()))
    check(len(srep.responses) == LDA_REQUESTS and worst <= LDA_THETA_TOL,
          f"lda serve: θ off the f64 fold-in by {worst} > {LDA_THETA_TOL}")
    serve = {"spec": srep.spec.to_json(), "plan": plan.to_json(),
             "launches": launches, "pins_at": [t for t, _, _ in pins],
             "pin_gb": pin_gb, "pins_survive": True,
             "theta_max_abs_err": worst, "batches": len(seen),
             "trained_equals_unserved": True,
             **serve_summary(srep, secs, R, unserved, peak)}
    del seen, pins, srep, ref, live, held, work
    torch.cuda.empty_cache()
    return obs, serve


def serve_cli_run() -> dict:
    """``python -m repro_torch.launch.serve --engine lda --requests 32
    --trace build/serve.trace.json`` once, as a subprocess on the card at
    its default size (with ``--out``): it must exit 0, serve 32 requests
    within its staleness bound and write a trace that holds its training
    chunks and serving batches."""
    out = os.path.join("build", "serve_cli.json")
    trace = os.path.join("build", "serve.trace.json")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
           "lda", "--requests", "32", "--trace", trace, "--out", out]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(p.returncode == 0, f"serve CLI exited {p.returncode}: "
                             f"{p.stderr[-2000:]}")
    with open(os.path.join(ROOT, out)) as f:
        art = json.load(f)
    with open(os.path.join(ROOT, trace)) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    check(art["requests"] == 32 and art["device"].startswith("cuda")
          and art["max_staleness_read"] <= art["serve_spec"]["max_staleness"]
          and {"train_chunk", "serve_batch", "serve_read"} <= names,
          f"serve CLI: artifact {art}, trace names {names}")
    return {"command": " ".join(cmd[1:]), "seconds": secs,
            "stdout": p.stdout.strip().splitlines(),
            "latency": art["latency"],
            "staleness_hist": art["staleness_hist"]}


def lda_counts(torch, words, docs, z, n_slabs: int, rows: int, dpw: int,
               K: int):
    """B (n_slabs, rows, K), D (P, dpw, K) and s counted from (P, T)
    words, docs and z, word w in slab w // rows."""
    P, T = words.shape
    on = words >= 0
    w, k = words[on].long(), z[on].long()
    p = torch.arange(P, device=words.device)[:, None].expand(P, T)[on]
    one = torch.ones(k.shape, device=words.device)
    B = torch.zeros((n_slabs, rows, K), device=words.device)
    B.index_put_((w // rows, w % rows, k), one, accumulate=True)
    D = torch.zeros((P, dpw, K), device=words.device)
    D.index_put_((p, docs[on].long(), k), one, accumulate=True)
    return B, D, B.sum((0, 1))


def gumbel_noise(torch, gen, shape):
    u = torch.rand(shape, generator=gen, device=DEVICE)
    return -torch.log(-torch.log(u.clamp_min_(1.1754944e-38)))


def lda_kernel_vs_plain(torch, lg, ref, words, docs, z, order, offsets, B,
                        D, s, kw, gumbel=None) -> dict:
    """``lda_gibbs`` and its plain version on copies of the same state and
    the same noise: z, B, D and s̃ must be equal to the bit."""
    kz, kB, kD = z.clone(), B.clone(), D.clone()
    pz, pB, pD = z.clone(), B.clone(), D.clone()
    before = lg.LAUNCHES["lda_gibbs"]
    ks = lg.lda_gibbs(words, docs, kz, order, offsets, kB, kD, s,
                      gumbel=gumbel, **kw)
    torch.cuda.synchronize()
    check(lg.LAUNCHES["lda_gibbs"] == before + 1,
          "lda_gibbs: the wrapper did not launch its kernel")
    t0 = time.perf_counter()
    ps = ref.lda_gibbs_ref(words, docs, pz, order, offsets, pB, pD, s,
                           gumbel=gumbel, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    out = {"z_mismatches": int((kz != pz).sum()),
           "max_abs_err": max(float((a - b).abs().max()) for a, b in
                              ((kB, pB), (kD, pD), (ks, ps))),
           "plain_seconds": plain_s, "kernel": (kz, kB, kD, ks),
           "plain": (pz, pB, pD, ps)}
    out["equal"] = (out["z_mismatches"] == 0 and torch.equal(kB, pB)
                    and torch.equal(kD, pD) and torch.equal(ks, ps))
    return out


def first_mismatch(torch, ref, words, docs, z, order, offsets, B, D, s, kw,
                   gumbel, kz, pz) -> dict:
    """Where the kernel and the plain version first part: the worker and
    position of the first differing token, and the top-2 margin of its
    noisy logits in the plain version's replay up to it."""
    blocks, slots, counts = ref.gibbs_active(order, offsets, kw["phase"])
    L = slots.shape[1]
    valid = torch.arange(L, device=slots.device)[None] < counts[:, None]
    diff = (kz.gather(1, slots) != pz.gather(1, slots)) & valid
    j = int(torch.nonzero(diff.any(0))[0])
    p = int(torch.nonzero(diff[:, j])[0])
    blk = int(blocks[p])
    off = offsets[p:p + 1].clone()
    off[0, blk + 1] = off[0, blk] + j
    z1, B1, D1 = z[p:p + 1].clone(), B.clone(), D[p:p + 1].clone()
    st = ref.lda_gibbs_ref(words[p:p + 1], docs[p:p + 1], z1,
                           order[p:p + 1], off, B1, D1, s,
                           **dict(kw, phase=blk), gumbel=gumbel[p:p + 1, :j])
    slot = int(slots[p, j])
    v = int(words[p, slot]) - blk * kw["block_vocab"]
    d, zi = int(docs[p, slot]), int(z1[0, slot])
    b, dd, s_ = B1[blk, v].clone(), D1[0, d].clone(), st[0].clone()
    b[zi] -= 1
    dd[zi] -= 1
    s_[zi] -= 1
    x = gumbel[p, j] + ((torch.log(kw["gamma"] + b)
                         - torch.log(kw["vg"] + s_))
                        + torch.log(kw["alpha"] + dd))
    top = x.topk(2).values if x.numel() > 1 else x
    return {"mismatched_tokens": int(diff.sum()), "worker": p,
            "position": j, "kernel_z": int(kz[p, slot]),
            "plain_z": int(pz[p, slot]),
            "top2_margin": float(top[0] - top[-1])}


LDA_RAGGED_TOPICS = (1, 7, 33, 2049, 3000, 4500, 16384)


def lda_ragged(torch, lg, ref, seed: int) -> dict:
    """``lda_gibbs`` against its plain version at ragged shapes: K = 1, 7,
    33, and K where the kernel's ring depth changes (2,049: more topics
    than threads; 16,384 has no ring); a worker with no active token; a
    worker whose tokens all share one document; B on a view one element
    past 16-byte alignment; both noise modes; STRADS's rotation over nb
    blocks and the baseline's one block over the whole vocabulary on a
    replica of B a worker."""
    P, T, nb, Vb, dpw = 4, 600, 4, 12, 6
    V = nb * Vb
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    words = torch.randint(0, V, (P, T), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    words[2] = -1                              # no active token at all
    docs = torch.randint(0, dpw, (P, T), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    docs[1] = 0                                # every token in one document
    index = {True: lg.gibbs_index(words, Vb, nb),
             False: lg.gibbs_index(words, V, 1)}
    out = {"ring_depth": {}}
    for K in LDA_RAGGED_TOPICS:
        out["ring_depth"][K] = lg.ring_depth(K)
        z0 = torch.randint(0, K, (P, T), generator=gen, device=DEVICE,
                           dtype=torch.int32)
        B, D, s = lda_counts(torch, words, docs, z0, nb, Vb, dpw, K)
        for rotate in (True, False):
            order, offsets = index[rotate]
            Br = B if rotate else B.reshape(1, V, K).expand(P, V, K) \
                .contiguous()
            for phase in (0, 3):
                kw = dict(phase=phase, rotate=rotate,
                          block_vocab=Vb if rotate else V, vg=V * 0.1,
                          alpha=0.1, gamma=0.1, seed=LDA_SEED)
                L = int(lg.active_counts(offsets, phase).max())
                for mode in ("explicit", "philox", "unaligned"):
                    g = (gumbel_noise(torch, gen, (P, L, K))
                         if mode == "explicit" else None)
                    Bm = offset_view(torch, Br) if mode == "unaligned" \
                        else Br
                    r = lda_kernel_vs_plain(torch, lg, ref, words, docs, z0,
                                            order, offsets, Bm, D, s, kw, g)
                    name = (f"K{K}_{'rotate' if rotate else 'baseline'}_"
                            f"phase{phase}_{mode}")
                    check(r["equal"], f"lda_gibbs: kernel and plain differ "
                                      f"at {name}: {r['z_mismatches']} "
                                      f"topics, max abs err "
                                      f"{r['max_abs_err']}")
                    out[name] = r["max_abs_err"]
    return out


def repeat_corpus(torch, gen, P: int, T: int, V: int, dpw: int):
    """(P, T) words and docs made of runs: a word repeated 1..12 times in
    one document, a word at j and j + 2 with another between, and single
    tokens, so a token's B and D rows are often the ones the tokens just
    before it changed."""
    seg = torch.randint(1, 13, (P, T), generator=gen, device=DEVICE)
    kind = torch.randint(0, 3, (P, T), generator=gen, device=DEVICE)
    seg = torch.where(kind == 0, seg, torch.where(kind == 1, 3, 1))
    v0 = torch.randint(0, V, (P, T), generator=gen, device=DEVICE)
    d0 = torch.randint(0, dpw, (P, T), generator=gen, device=DEVICE)
    words = torch.empty((P, T), dtype=torch.int32, device=DEVICE)
    docs = torch.empty((P, T), dtype=torch.int32, device=DEVICE)
    seg, kind, v0, d0 = (t.cpu() for t in (seg, kind, v0, d0))
    for p in range(P):
        out_w, out_d, i = [], [], 0
        while len(out_w) < T:
            v, d, n, k = (int(v0[p, i]), int(d0[p, i]), int(seg[p, i]),
                          int(kind[p, i]))
            if k == 1:                          # v, another word, v
                out_w += [v, (v + 1) % V, v]
                out_d += [d, (d + i) % dpw, d]
            else:
                out_w += [v] * n
                out_d += [d] * n
            i += 1
        words[p] = torch.tensor(out_w[:T], dtype=torch.int32)
        docs[p] = torch.tensor(out_d[:T], dtype=torch.int32)
    return words, docs


def lda_repeats(torch, lg, ref, seed: int, K: int = 1000) -> dict:
    """``lda_gibbs`` against its plain version at K = 1,000 on a corpus of
    runs (``repeat_corpus``): both noise modes, STRADS's rotation and the
    baseline's replicas, to the bit.  Each token's update lands in the
    ring slots of the next ones, which the kernel must patch."""
    P, T, nb, Vb, dpw = 4, 2000, 4, 64, 8
    V = nb * Vb
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    words, docs = repeat_corpus(torch, gen, P, T, V, dpw)
    z0 = torch.randint(0, K, (P, T), generator=gen, device=DEVICE,
                       dtype=torch.int32)
    B, D, s = lda_counts(torch, words, docs, z0, nb, Vb, dpw, K)
    out = {"workers": P, "tokens_each": T, "topics": K,
           "ring_depth": lg.ring_depth(K)}
    for rotate in (True, False):
        order, offsets = (lg.gibbs_index(words, Vb, nb) if rotate
                          else lg.gibbs_index(words, V, 1))
        Br = B if rotate else B.reshape(1, V, K).expand(P, V, K).contiguous()
        kw = dict(phase=1, rotate=rotate, block_vocab=Vb if rotate else V,
                  vg=V * 0.1, alpha=0.1, gamma=0.1, seed=LDA_SEED)
        L = int(lg.active_counts(offsets, 1).max())
        for mode in ("explicit", "philox"):
            g = (gumbel_noise(torch, gen, (P, L, K)) if mode == "explicit"
                 else None)
            r = lda_kernel_vs_plain(torch, lg, ref, words, docs, z0, order,
                                    offsets, Br, D, s, kw, g)
            name = f"{'rotate' if rotate else 'baseline'}_{mode}"
            check(r["equal"], f"lda_gibbs: kernel and plain differ on the "
                              f"runs corpus at {name}: {r['z_mismatches']} "
                              f"topics, max abs err {r['max_abs_err']}")
            out[name] = {"max_abs_err": r["max_abs_err"],
                         "changed_topics": int((r["kernel"][0] != z0)
                                               .sum()),
                         "plain_seconds": r["plain_seconds"]}
    return out


def lda_baseline_vs_plain(torch, lg, ref, lda, cfg, data, state,
                          seed: int) -> dict:
    """The data-parallel baseline's sweep at its chip shape (one block
    spanning the padded vocabulary, a replica of B a worker) against its
    plain version on one explicit Gumbel tensor, to the bit: the first
    LDA_BASELINE_CHECK[1] tokens of the first LDA_BASELINE_CHECK[0]
    workers (the plain version steps one token a Python iteration)."""
    P, J = LDA_BASELINE_CHECK
    Vp, K = cfg.padded_vocab, cfg.num_topics
    words, docs = data["words"][:P], data["docs"][:P]
    order, offsets = lg.gibbs_index(words, Vp, 1)
    offsets[:, 1].clamp_(max=J)
    replica = state["B"].expand(P, Vp, K).contiguous()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    g = gumbel_noise(torch, gen, (P, J, K))
    kw = dict(phase=0, rotate=False, block_vocab=Vp, vg=Vp * cfg.gamma,
              alpha=cfg.alpha, gamma=cfg.gamma, seed=lda.BASELINE_SEED)
    r = lda_kernel_vs_plain(torch, lg, ref, words, docs, state["z"][:P],
                            order, offsets, replica, state["D"][:P],
                            state["s"], kw, g)
    check(r["equal"], f"lda_gibbs: the baseline's sweep and its plain "
                      f"version differ at the chip shape: "
                      f"{r['z_mismatches']} topics, max abs err "
                      f"{r['max_abs_err']}")
    return {"workers": P, "tokens_each": J, "replica_shape": [P, Vp, K],
            "max_abs_err": r["max_abs_err"], "equal": True,
            "plain_seconds": r["plain_seconds"]}


def logf_cost() -> dict:
    """Operations of one full-precision ``logf`` as nvcc compiles it for
    sm_90a with the kernels' own flags (no fast math): the SASS
    instructions (``cuobjdump -sass``) that a kernel taking one logf has
    beyond one that copies, an FFMA counted as 2 operations, a MUFU as
    2·SFU_SLOTS and any other as 1 (a floor: each takes an issue slot)."""
    import re
    import shutil
    from collections import Counter
    from repro_torch.kernels import _build
    d = _build.build_dir()
    d.mkdir(parents=True, exist_ok=True)
    src, lib = d / "logf_probe.cu", d / "logf_probe.so"
    src.write_text(LOGF_PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    ops = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        ops[name] = Counter(re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)",
            part))
    check({"probe_logf", "probe_copy"} <= set(ops),
          f"logf probe: functions {sorted(ops)} in the SASS")
    extra = ops["probe_logf"] - ops["probe_copy"]
    extra.pop("NOP", None)
    flops = sum(n * (2 if op == "FFMA" else 2 * SFU_SLOTS if op == "MUFU"
                     else 1) for op, n in extra.items())
    check(flops > 0, "logf probe: no instructions for a logf in the SASS")
    return {"instructions": sum(extra.values()), "flops": flops,
            "mix": dict(extra)}


def lda_round_bytes(torch, ref, words, docs, order, offsets, phase: int,
                    rotate: bool, K: int, vocab: int, dpw: int,
                    changed: int) -> tuple[float, dict]:
    """The least bytes one round of ``lda_gibbs`` moves on these inputs:
    each distinct (slab, word) row of B and (worker, doc) row of D that
    the round's active tokens touch, read once; each active token's slot,
    word, doc and topic read once; for each of the ``changed`` tokens
    whose topic moves, its topic and the four counts it moves written
    once; s read and each worker's s̃ written once."""
    blocks, slots, counts = ref.gibbs_active(order, offsets, phase)
    P, L = slots.shape
    on = torch.arange(L, device=slots.device)[None] < counts[:, None]
    p = torch.arange(P, device=slots.device)[:, None].expand(P, L)
    slab = (blocks[:, None].expand(P, L) if rotate else p)[on]
    w = words.gather(1, slots)[on].long()
    d = docs.gather(1, slots)[on].long()
    rows_b = int(torch.unique(slab * vocab + w).numel())
    rows_d = int(torch.unique(p[on] * dpw + d).numel())
    n = int(on.sum())
    nbytes = 4 * K * (rows_b + rows_d) + 16 * n + 20 * changed \
        + 4 * K * (1 + P)
    return nbytes, {"b_rows": rows_b, "d_rows": rows_d, "tokens": n,
                    "changed_tokens": changed, "gb": nbytes / 1e9}


def lda_step_us(torch, lg, K: int, seed: int, tokens: int = 20_000) -> float:
    """µs a token of one worker's chain (one thread block alone on the
    card) at K topics: the latency of one step of the kernel."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    V, dpw = 64, 16
    words = torch.randint(0, V, (1, tokens), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    docs = torch.randint(0, dpw, (1, tokens), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    z = torch.randint(0, K, (1, tokens), generator=gen, device=DEVICE,
                      dtype=torch.int32)
    B, D, s = lda_counts(torch, words, docs, z, 1, V, dpw, K)
    order, offsets = lg.gibbs_index(words, V, 1)
    kw = dict(phase=0, rotate=True, block_vocab=V, vg=V * 0.1, alpha=0.1,
              gamma=0.1, seed=LDA_SEED)
    ms = time_ms(torch, lambda: lg.lda_gibbs(words, docs, z, order, offsets,
                                             B, D, s, **kw), iters=5,
                 warmup=1)
    return ms * 1e3 / tokens


def lda_phase(torch, lda, lg, ref, ExecutionPlan, KernelSpec, seed: int):
    """STRADS LDA at the NYTimes shape, K = 1,000, W = 128 workers;
    returns (the kernel's entry for the kernels line, the phase's
    numbers)."""
    U, K = LDA_WORKERS, LDA_TOPICS
    cfg = lda.LDAConfig(vocab=NYTIMES["vocab"], num_topics=K,
                        num_workers=U, tokens_per_worker=LDA_TOKENS_PER_WORKER,
                        docs_per_worker=LDA_DOCS_PER_WORKER)
    Vb, Vp, T = cfg.block_vocab, cfg.padded_vocab, cfg.tokens_per_worker
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    words, docs, z0 = lda.synthetic_corpus_device(seed, cfg, device=DEVICE)
    torch.cuda.synchronize()
    res = {"docs": U * cfg.docs_per_worker, "vocab": cfg.vocab,
           "tokens": U * T, "topics": K, "workers": U,
           "tokens_per_worker": T, "docs_per_worker": cfg.docs_per_worker,
           "block_vocab": Vb, "padded_vocab": Vp,
           "data_seconds": time.perf_counter() - t0}
    print(f"lda: {U * T} tokens over {cfg.vocab} words and "
          f"{U * cfg.docs_per_worker} documents, K = {K}, W = {U} "
          f"(V_b = {Vb}, V_p = {Vp}), built in {res['data_seconds']:.2f} s")
    eng = lda.make_engine(cfg, device=DEVICE)
    data = eng.shard_data({"words": words, "docs": docs})
    order, offsets = lg.gibbs_index(data["words"], Vb, U)
    counts = torch.stack([lg.active_counts(offsets, ph).long()
                          for ph in range(U)])        # (round, worker)
    res["active_tokens"] = {
        "max_per_worker_round": int(counts.max()),
        "mean_per_worker_round": float(counts.double().mean()),
        "round0_max": int(counts[0].max()),
        "round0_total": int(counts[0].sum()),
        "chain_tokens_a_rotation": int(counts.max(1).values.sum())}
    init = eng.init_state(words=words, docs=docs, z0=z0)
    loop_init = {k: v.clone() for k, v in init.items()}
    pipe_init = {k: v.clone() for k, v in init.items()}
    ssp_inits = [{k: v.clone() for k, v in init.items()} for _ in range(3)]
    obs_start = {k: v.clone() for k, v in init.items()}
    kw = dict(phase=0, rotate=True, block_vocab=Vb, vg=Vp * cfg.gamma,
              alpha=cfg.alpha, gamma=cfg.gamma, seed=LDA_SEED)

    # the kernel against its plain version at the chip shape, round 0, on
    # one explicit Gumbel tensor of the active slots
    L = res["active_tokens"]["round0_max"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    gumbel = gumbel_noise(torch, gen, (U, L, K))
    res["explicit_noise_gb"] = gumbel.numel() * 4 / 1e9
    args = (data["words"], data["docs"], init["z"], order, offsets,
            init["B"], init["D"], init["s"])
    r = lda_kernel_vs_plain(torch, lg, ref, *args, kw, gumbel)
    if not r["equal"]:
        res["mismatch"] = first_mismatch(torch, ref, *args, kw, gumbel,
                                         r["kernel"][0], r["plain"][0])
        print("lda mismatch: " + json.dumps(res["mismatch"]))
    check(r["equal"], f"lda_gibbs: kernel and plain differ at the chip "
                      f"shape: {r['z_mismatches']} topics, max abs err "
                      f"{r['max_abs_err']}")
    plain_ms = r["plain_seconds"] * 1e3
    entry = {"max_abs_err": r["max_abs_err"], "plain_ms": plain_ms,
             "z_mismatches": 0}
    del r, gumbel
    torch.cuda.empty_cache()
    entry["ragged_max_abs_err"] = lda_ragged(torch, lg, ref, seed)
    entry["repeats_vs_plain"] = lda_repeats(torch, lg, ref, seed)

    # the sampler's Philox draws are Gumbel: the plain version's draws,
    # made on the card (the kernel's are the same bits: it equals the
    # plain version in Philox mode, above)
    slots = torch.arange(GUMBEL_DRAWS[0] * GUMBEL_DRAWS[1],
                         device=DEVICE).view(*GUMBEL_DRAWS)
    dk = ref.philox_gumbel(LDA_SEED, 3, slots, K)
    mean, var = float(dk.double().mean()), float(dk.double().var())
    check(abs(mean - EULER_GAMMA) <= 1e-3 and abs(var - math.pi ** 2 / 6)
          <= 1e-2, f"lda_gibbs: Philox draws are not Gumbel: mean {mean}, "
                   f"variance {var}")
    res["philox"] = {"draws": dk.numel(), "mean": mean, "variance": var}
    del dk, slots

    # the main path: one rotation on scan, then on loop, from one state
    warm = {k: v.clone() for k, v in init.items()}
    eng.execute(warm, data, None, ExecutionPlan(executor="loop", rounds=1))
    del warm
    ll0 = float(lda.log_likelihood(cfg, init))
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    lg.reset_launch_counts()
    for ex, state in (("scan", init), ("loop", loop_init)):
        before = lg.LAUNCHES["lda_gibbs"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.execute(state, data, None, ExecutionPlan(
            executor=ex, rounds=U), collect=lambda s: s["s_err"])
        torch.cuda.synchronize()
        runs[ex] = (rep, time.perf_counter() - t0)
        check(lg.LAUNCHES["lda_gibbs"] - before == U,
              f"lda {ex}: lda_gibbs launched "
              f"{lg.LAUNCHES['lda_gibbs'] - before} times in {U} rounds")
    launches = lg.LAUNCHES["lda_gibbs"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the pipelined executor: the rotation reads no state, so it equals
    # scan to the bit (and so its counts recount exactly, as scan's do)
    lg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = eng.execute(pipe_init, data, None, ExecutionPlan(
        executor="pipelined", rounds=U), collect=lambda s: s["s_err"])
    torch.cuda.synchronize()
    pipe_secs = time.perf_counter() - t0
    pipe_launches = lg.LAUNCHES["lda_gibbs"]
    check(pipe_launches == U, f"lda pipelined: lda_gibbs launched "
                              f"{pipe_launches} times in {U} rounds")
    a, b = runs["scan"][0], runs["loop"][0]
    for k in ("z", "D", "B", "s", "s_err"):
        check(torch.equal(a.state[k], pipe.state[k]),
              f"lda: pipelined and scan differ in {k} on the card")
    check(torch.equal(a.trace, pipe.trace), "lda: the s-error traces of "
                                            "pipelined and scan differ")
    del pipe, pipe_init
    res["ssp"] = lda_ssp_runs(torch, lda, lg, ExecutionPlan, cfg, eng, data,
                              words, docs, a, ssp_inits, ll0)
    del ssp_inits
    res["counters"], res["serve"] = lda_obs_serve(
        torch, lda, lg, ExecutionPlan, cfg, eng, data, words, a, obs_start,
        seed)
    del obs_start
    for k in ("z", "D", "B", "s", "s_err"):
        check(torch.equal(a.state[k], b.state[k]),
              f"lda: loop and scan differ in {k} on the card")
    check(torch.equal(a.trace, b.trace), "lda: the s-error traces of loop "
                                         "and scan differ")
    flat = eng.unshard(a.state)
    rec = lda.build_state(cfg, words, docs, flat["z"], device=DEVICE)
    for k in ("D", "B", "s"):
        check(torch.equal(rec[k], flat[k]),
              f"lda: {k} recounted from z differs from the state")
    z = flat["z"]
    check(int(z.min()) >= 0 and int(z.max()) < K, "lda: z out of [0, K)")
    s_max = float(flat["s"].max())
    check(s_max < 2 ** 24, f"lda: a topic count {s_max} is not exact in f32")
    ll1 = float(lda.log_likelihood(cfg, a.state))
    check(math.isfinite(ll1) and ll1 > ll0,
          f"lda: the log-likelihood did not rise: {ll0} → {ll1}")
    s_errs = a.trace.cpu().tolist()
    res.update(
        rounds=U, launches=launches, loop_equals_scan=True,
        counts_recount_exactly=True, loglik_start=ll0, loglik_end=ll1,
        s_max=s_max, s_err_last=s_errs[-1], s_err_max=max(s_errs),
        s_err_mean=sum(s_errs) / len(s_errs),
        rounds_per_s={**{ex: U / s for ex, (_, s) in runs.items()},
                      "pipelined": U / pipe_secs},
        seconds={**{ex: s for ex, (_, s) in runs.items()},
                 "pipelined": pipe_secs},
        pipelined_equals_scan=True, launches_pipelined=pipe_launches,
        peak_memory_gb=peak)
    entry["launches_ssp"] = {k: res["ssp"]["launches"][k]
                             for k in ("ssp_s0", "ssp_s2")}
    entry["launches_serve"] = res["serve"]["launches"]
    del b, runs, loop_init, rec, flat

    # the kernel timed at round 0's shape on the main path's state
    st = a.state

    def fn():
        return lg.lda_gibbs(data["words"], data["docs"], st["z"], order,
                            offsets, st["B"], st["D"], st["s"], **kw)
    z_before = st["z"].clone()
    fn()
    changed = int((st["z"] != z_before).sum())
    del z_before
    ms = time_ms(torch, fn, iters=10, warmup=2)
    device_ms = graph_ms(torch, fn, calls=5, replays=4)
    n_act = res["active_tokens"]["round0_total"]
    nbytes, rows = lda_round_bytes(torch, ref, data["words"], data["docs"],
                                   order, offsets, 0, True, K, Vp,
                                   cfg.docs_per_worker, changed)
    logf = logf_cost()
    flops = n_act * K * (LDA_LOGF_PER_TOPIC * logf["flops"]
                         + LDA_OTHER_OPS_PER_TOPIC)
    bms, by = bound(nbytes, flops)
    # round 0's first sweep from the planted start, where nearly every
    # token changes topic (the calls above repeat round 0, whose draws are
    # the same each time, so after the first call few tokens change)
    fresh = eng.init_state(words=words, docs=docs, z0=z0)
    first = {k: fresh[k].clone() for k in ("z", "B", "D")}
    first_ms, first_changed = [], 0
    for _ in range(3):
        for k in ("z", "B", "D"):
            first[k].copy_(fresh[k])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        lg.lda_gibbs(data["words"], data["docs"], first["z"], order, offsets,
                     first["B"], first["D"], fresh["s"], **kw)
        ev[1].record()
        torch.cuda.synchronize()
        first_ms.append(ev[0].elapsed_time(ev[1]))
        first_changed = int((first["z"] != fresh["z"]).sum())
    del fresh, first
    torch.cuda.empty_cache()
    step1 = lda_step_us(torch, lg, 1, seed)
    stepK = lda_step_us(torch, lg, K, seed)
    chain_ms = res["active_tokens"]["round0_max"] * step1 / 1e3
    # the longest chain's operations on the one SM that runs it
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worker_ops_ms = (res["active_tokens"]["round0_max"] * K
                     * (LDA_LOGF_PER_TOPIC * logf["flops"]
                        + LDA_OTHER_OPS_PER_TOPIC)
                     / (PEAK_F32_FLOPS / sms) * 1e3)
    entry.update(
        name="lda_gibbs", route="cuda", source=SOURCES["lda_gibbs"],
        replaces=REPLACES["lda_gibbs"], pallas_counterpart=None,
        launches=launches, launches_pipelined=pipe_launches, ms=ms,
        device_ms=device_ms,
        ms_repeat=time_ms(torch, fn, iters=10, warmup=1),
        device_ms_repeat=graph_ms(torch, fn, calls=5, replays=4),
        bound_ms=bms, bound_by=by, library_ms=None,
        bound_share=bms / ms, device_bound_share=bms / device_ms,
        bytes_bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
        ops_bound_ms=flops / PEAK_F32_FLOPS * 1e3, bound_rows=rows,
        logf=logf, gflop=flops / 1e9, step_us_k1=step1, step_us=stepK,
        chain_floor_ms=chain_ms,
        chain_floor_share=chain_ms / device_ms,
        worker_ops_floor_ms=worker_ops_ms,
        worker_ops_floor_share=worker_ops_ms / device_ms,
        changed_tokens=changed,
        device_ms_first_sweep=sorted(first_ms)[1],
        changed_tokens_first_sweep=first_changed,
        ring_depth=lg.ring_depth(K), threads=lg.block_threads(K),
        shape={"workers": U, "tokens_per_worker": T, "topics": K,
               "active_tokens_round0": n_act,
               "longest_chain_round0": res["active_tokens"]["round0_max"]})
    # the profiler window last: a session slows the host's later launches
    res["profile"] = profile_window(torch, lambda: eng.execute(
        st, data, None, ExecutionPlan(executor="scan", rounds=4)),
        {"lda_gibbs": (lg.LAUNCHES, ("lda_gibbs_kernel",))})
    del a, st, init, data, eng
    torch.cuda.empty_cache()

    # Philox draws against torch's, through one rotation at a smaller
    # size: the kernel's log-likelihood within LDA_BAND of the plain
    # version's, driven by torch.Generator draws
    bcfg = lda.LDAConfig(**LDA_BAND_CFG)
    bw, bd, bz = lda.synthetic_corpus_device(seed + 1, bcfg, device=DEVICE)
    tg = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    shape = (bcfg.num_workers, bcfg.tokens_per_worker, bcfg.num_topics)
    band = {}
    for name, kwargs in (
            ("kernel_philox", {}),
            ("plain_torch_draws", dict(
                kernels=KernelSpec(kind="reference"),
                noise=lambda phase: gumbel_noise(torch, tg, shape)))):
        e = lda.make_engine(bcfg, device=DEVICE, **kwargs)
        d = e.shard_data({"words": bw, "docs": bd})
        s0 = e.init_state(words=bw, docs=bd, z0=bz)
        band["loglik_start"] = float(lda.log_likelihood(bcfg, s0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = e.execute(s0, d, None, ExecutionPlan(
            executor="scan", rounds=bcfg.num_workers))
        torch.cuda.synchronize()
        band[name] = {"loglik": float(lda.log_likelihood(bcfg, rep.state)),
                      "seconds": time.perf_counter() - t0}
    climb = band["plain_torch_draws"]["loglik"] - band["loglik_start"]
    gap = band["kernel_philox"]["loglik"] - band["plain_torch_draws"][
        "loglik"]
    check(climb > 0 and abs(gap) <= LDA_BAND * climb,
          f"lda: after a rotation the Philox kernel's log-likelihood is "
          f"{gap} from the plain path's, outside {LDA_BAND} of its climb "
          f"{climb}")
    band.update(config=LDA_BAND_CFG, gap=gap, climb=climb,
                gap_share_of_climb=gap / climb, band=LDA_BAND)
    res["philox_vs_torch_draws"] = band
    del bw, bd, bz, e, d, s0, rep

    # the data-parallel baseline on the corpus's first eighth, one round,
    # beside one STRADS rotation on the same sub-corpus
    Ub = LDA_BASELINE_WORKERS
    scfg = lda.LDAConfig(vocab=cfg.vocab, num_topics=K, num_workers=Ub,
                         tokens_per_worker=T,
                         docs_per_worker=cfg.docs_per_worker)
    sub = (words[:Ub * T], docs[:Ub * T], z0[:Ub * T])
    side = {"workers": Ub, "tokens": Ub * T}
    for name, baseline, rounds in (("baseline", True, 1),
                                   ("strads", False, Ub)):
        e = lda.make_engine(scfg, device=DEVICE, baseline=baseline)
        d = e.shard_data({"words": sub[0], "docs": sub[1]})
        s0 = e.init_state(words=sub[0], docs=sub[1], z0=sub[2])
        if baseline:
            entry["baseline_vs_plain"] = lda_baseline_vs_plain(
                torch, lg, ref, lda, scfg, d, s0, seed)
        side["loglik_start"] = float(lda.log_likelihood(scfg, s0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = e.execute(s0, d, None, ExecutionPlan(
            executor="loop" if baseline else "scan", rounds=rounds))
        torch.cuda.synchronize()
        side[name] = {"rounds": rounds,
                      "seconds": time.perf_counter() - t0,
                      "loglik": float(lda.log_likelihood(scfg, rep.state))}
        check(math.isfinite(side[name]["loglik"]),
              f"lda: the {name} log-likelihood is not finite")
        del e, d, s0, rep
        torch.cuda.empty_cache()
    res["baseline_vs_strads"] = side
    del sub
    res["stream"] = lda_stream_runs(torch, lda, lg, ExecutionPlan, cfg, words,
                                    docs, z0, seed,
                                    res["rounds_per_s"]["scan"])
    entry["launches_stream"] = res["stream"]["launches"]
    del words, docs, z0
    torch.cuda.empty_cache()
    return entry, res


# ---------------------------------------------------------------------------
# Model-zoo serving: flash_attention and topk_gating
# ---------------------------------------------------------------------------

class patched:
    """Swap attributes of a module for the length of a ``with`` block."""

    def __init__(self, mod, **attrs):
        self.mod, self.attrs, self.saved = mod, attrs, {}

    def __enter__(self):
        for k, v in self.attrs.items():
            self.saved[k] = getattr(self.mod, k)
            setattr(self.mod, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.mod, k, v)


def rel_err(torch, got, want) -> tuple[float, float]:
    """max |got − want| and that over max(1, max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def checked_ops(torch, ops, ref):
    """Stand-ins for ``ops.attention`` / ``ops.topk_gating`` that launch
    the kernel through the real wrapper, then hold its output against the
    plain version on the same inputs.  Keeps the worst error per kernel
    and the inputs of the first call of each shape (layer 0's)."""
    real_attn, real_gate = ops.attention, ops.topk_gating
    stats = {"flash_attention": {"calls": 0, "max_abs_err": 0.0,
                                 "max_rel_err": 0.0},
             "topk_gating": {"calls": 0, "max_abs_err": 0.0,
                             "idx_equal": True}}
    first: dict = {}

    def attention(q, k, v, **kw):
        out = real_attn(q, k, v, **kw)
        q, k, v = q.detach(), k.detach(), v.detach()
        with torch.no_grad():               # under a training step too
            err, rel = rel_err(torch, out.detach(),
                               ref.attention_ref(q, k, v, **kw))
        st = stats["flash_attention"]
        st["calls"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["max_rel_err"] = max(st["max_rel_err"], rel)
        first.setdefault("attention", (q, k, v, kw))
        return out

    def topk_gating(logits, k):
        p, i = real_gate(logits, k)
        pr, ir = ref.topk_gating_ref(logits, k)
        st = stats["topk_gating"]
        st["calls"] += 1
        st["max_abs_err"] = max(st["max_abs_err"],
                                (p - pr).abs().max().item())
        st["idx_equal"] = st["idx_equal"] and bool(torch.equal(i, ir))
        first.setdefault(("gating", logits.shape[0]), (logits, k))
        return p, i
    return attention, topk_gating, stats, first


def attention_f64(torch, ref):
    """The plain attention with scores, softmax and sum in float64: the
    control for how far the model amplifies a change of rounding."""
    def attention(q, k, v, *, causal=True, window=None, scale=None):
        B, Sq, Hq, D = q.shape
        G = Hq // k.shape[2]
        scale = D ** -0.5 if scale is None else scale
        kd = k.double().repeat_interleave(G, dim=2)
        vd = v.double().repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q.double() * scale, kd)
        mask = ref.attention_mask(Sq, k.shape[1], k.shape[1] - Sq, causal,
                                  window, q.device)
        p = torch.softmax(s.masked_fill(~mask, ref.NEG_INF), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vd).to(q.dtype)
    return attention


def attention_bound(torch, ref, q, k, causal, window) -> tuple[float, str]:
    """Least time for one attention call: both products (QKᵀ and PV,
    2·B·Hq·D operations a visible (query, key) pair each) at the tensor
    cores' bf16 rate for bf16 inputs, at the FP32 rate for f32 inputs,
    over the pairs the mask lets through; or q, k, v read and the output
    written once, if that takes longer."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    pairs = int(ref.attention_mask(Sq, Skv, Skv - Sq, causal,
                                   window).sum())
    rate = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops = 4.0 * B * Hq * D * pairs / rate
    nbytes = q.element_size() * (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_timing(torch, ops, ref, q, k, v, kw) -> dict:
    """``flash_attention`` at one call's real inputs: two launches give the
    same bits and agree with the plain version within ATTN_TOL; the
    kernel, the plain version and SDPA timed, and the bound."""
    import torch.nn.functional as F
    tq = lambda x: x.transpose(1, 2)
    got = ops.attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, ops.attention(q, k, v, **kw)),
          "flash_attention: two launches differ")
    err, rel = rel_err(torch, got, want)
    check(rel <= ATTN_TOL, f"flash_attention: error {rel} of the largest "
                           f"value > {ATTN_TOL} at shapes {tuple(q.shape)}")
    check(kw["window"] is None, f"flash_attention: SDPA's yardstick here "
                                f"has no window; the call has {kw}")
    library = lambda: F.scaled_dot_product_attention(
        tq(q), tq(k), tq(v), is_causal=kw["causal"], enable_gqa=True)
    lib_err, _ = rel_err(torch, tq(library()), want)
    kernel = lambda: ops.attention(q, k, v, **kw)
    ms = time_ms(torch, kernel, iters=50)
    device_ms = graph_ms(torch, kernel)
    plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, **kw),
                       iters=20)
    library_ms = time_ms(torch, library, iters=50)
    library_device_ms = graph_ms(torch, library)
    ms_again = time_ms(torch, kernel, iters=50)
    bms, by = attention_bound(torch, ref, q, k, kw["causal"], kw["window"])
    return {
        "max_abs_err": err, "ms": ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": library_ms, "library_device_ms": library_device_ms,
        "max_rel_err": rel, "ms_repeat": ms_again, "bound_share": bms / ms,
        "device_bound_share": bms / device_ms,
        "library_max_abs_err_vs_plain": lib_err,
        "shape": {"q": list(q.shape), "k": list(k.shape),
                  "dtype": str(q.dtype)}}


def serve_kernel_phase(torch, ops, ref, first, seed: int):
    """Both kernels against their plain versions at layer 0's shapes (its
    real inputs) and at ragged ones, timed, with SDPA beside attention."""
    gen = torch.Generator().manual_seed(seed + 2)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(DEVICE, dtype)

    q, k, v, kw = first["attention"]
    out = {}

    # flash_attention
    ragged = {}
    for case in [(2, 200, 333, 8, 2, 64, True, 50),
                 (1, 65, 300, 4, 1, 128, False, None),
                 (3, 100, 100, 8, 2, 80, True, 7),
                 (1, 40, 20, 4, 4, 128, True, None),
                 (2, 300, 170, 4, 2, 64, True, 5)]:
        B, Sq, Skv, Hq, Hkv, D, causal, window = case
        for dtype, tol in ((torch.bfloat16, ATTN_TOL),
                           (torch.float32, ATTN_TOL_F32)):
            a, b, c = rnd(B, Sq, Hq, D, dtype=dtype), \
                rnd(B, Skv, Hkv, D, dtype=dtype), \
                rnd(B, Skv, Hkv, D, dtype=dtype)
            e, r = rel_err(torch, ops.attention(a, b, c, causal=causal,
                                                window=window),
                           ref.attention_ref(a, b, c, causal=causal,
                                             window=window))
            check(r <= tol, f"flash_attention: error {r} > {tol} at "
                            f"{case} {dtype}")
            ragged[f"{case} {str(dtype)[6:]}"] = e
    phi = attention_timing(torch, ops, ref, q, k, v, kw)
    out["flash_attention"] = {
        **phi,
        "tolerance": f"{ATTN_TOL} of max(1, max|plain|) (bf16), "
                     f"{ATTN_TOL_F32} (f32)",
        "ragged_max_abs_err": ragged,
        "library": "F.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True)",
        "by_shape": {ARCH: phi}}

    # topk_gating
    logits, kk = first[("gating", BATCH * PROMPT)]
    gate = gating_timing(torch, ops, ref, logits, kk)
    dec_logits, _ = first[("gating", BATCH)]
    dp, di = ops.topk_gating(dec_logits, kk)
    dpr, dir_ = ref.topk_gating_ref(dec_logits, kk)
    check(torch.equal(di, dir_) and (dp - dpr).abs().max().item()
          <= GATE_TOL, "topk_gating: decode-step logits disagree")
    gragged = {}
    for T, E, k_ in [(1000, 16, 1), (1000, 16, 2), (777, 128, 1),
                     (777, 128, 2), (5, 128, 2)]:
        lg = rnd(T, E, dtype=torch.float32)
        lg[: T // 2] = lg[: T // 2].bfloat16().float()     # exact ties
        a, b = ops.topk_gating(lg, k_), ref.topk_gating_ref(lg, k_)
        e = (a[0] - b[0]).abs().max().item()
        check(torch.equal(a[1], b[1]) and e <= GATE_TOL,
              f"topk_gating: disagrees at T={T}, E={E}, k={k_}")
        gragged[f"T={T} E={E} k={k_}"] = e
    out["topk_gating"] = {
        **gate,
        # the decode step's (4, 16) logits: 768 of the main path's 792
        # launches
        "decode_shape_ms": time_ms(torch, lambda: ops.topk_gating(
            dec_logits, kk)),
        "decode_shape_device_ms": graph_ms(torch, lambda: ops.topk_gating(
            dec_logits, kk)),
        "library": "none: no single PyTorch call computes softmax, top-k "
                   "with lowest-index ties and renormalisation",
        "tolerance": f"probs {GATE_TOL} absolute; idx equal",
        "ragged_max_abs_err": gragged,
        "decode_shape_max_abs_err": (dp - dpr).abs().max().item(),
        "bound_share": gate["bound_ms"] / gate["ms"],
        "ms_repeat": time_ms(torch, lambda: ops.topk_gating(logits, kk))}
    return out


def window_records(prof, mark: str) -> dict:
    """What a profiler session kept of the call inside the ``mark``
    range, matched by correlation id (issue order): the call's kernel
    launches, those whose kernel record was lost, its device events
    (kernels, copies, fills) as (name, µs), and the guard kernels kept
    before and after it.  The CUDA API calls are the host events named
    ``cu*``; ``mark`` also names a device range, which is no event."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    rng = [e for e in evs
           if e.name() == mark and e.device_type() == DeviceType.CPU]
    if not rng:
        return {"launches": 0, "lost": 0, "events": [], "lead": 0,
                "tail": 0}
    lo = rng[0].start_ns()
    hi = lo + rng[0].duration_ns()
    api = [e for e in evs
           if e.device_type() == DeviceType.CPU and e.name().startswith("cu")
           and lo <= e.start_ns() <= hi]
    corr = {e.correlation_id() for e in api}
    dev = [e for e in evs
           if e.device_type() == DeviceType.CUDA and e.name() != mark]
    kept = {e.correlation_id() for e in dev}
    launches = [e.correlation_id() for e in api
                if "LaunchKernel" in e.name()]
    spin = [e.correlation_id() for e in dev if "spin_kernel" in e.name()]
    return {"launches": len(launches),
            "lost": sum(c not in kept for c in launches),
            "events": [(e.name(), e.duration_ns() / 1e3) for e in dev
                       if e.correlation_id() in corr],
            "lead": sum(c < min(corr) for c in spin) if corr else 0,
            "tail": sum(c > max(corr) for c in spin) if corr else 0}


def profile_window(torch, fn, kernels=None, counts: bool = False) -> dict:
    """Device busy share over one call of ``fn``, from torch.profiler: the
    device's own events over the wall time of the call.  A session loses
    some device records near its start, more the older the process
    (``tools/profile_window_check.py``), so the window first launches a
    lead guard of empty kernels (PROFILE_SPACED, each waited for and
    PROFILE_GAP_S apart, then PROFILE_PRIMERS back to back) and, after
    the call, PROFILE_TAIL more.  The window holds the whole call when
    every kernel launch inside the call's ``record_function`` range has
    its kernel record, it kept a kernel of each guard, and (``kernels``)
    it holds one event for each launch a port kernel's counter adds; a
    window that fails any of these is taken again, up to
    PROFILE_ATTEMPTS windows in all, and the run fails after the last.
    ``kernels`` maps a launch counter ``key`` of a ``LAUNCHES`` dict to
    (that dict, the kernels' names).  ``counts``: also the window's
    events by kernel name."""
    from torch.profiler import ProfilerActivity, profile, record_function
    kernels = kernels or {}
    mark = "chip_smoke.profile_window.call"
    lead_n = PROFILE_SPACED + PROFILE_PRIMERS
    taken = []
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        before = {k: c[k] for k, (c, _) in kernels.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_SPACED):
                torch.cuda._sleep(0)
                torch.cuda.synchronize()
                time.sleep(PROFILE_GAP_S)
            for _ in range(PROFILE_PRIMERS):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(mark):
                fn()
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            for _ in range(PROFILE_TAIL):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        rec = window_records(prof, mark)
        launched = {k: c[k] - before[k] for k, (c, _) in kernels.items()}
        recorded = {k: sum(any(n in name for n in names)
                           for name, _ in rec["events"])
                    for k, (_, names) in kernels.items()}
        taken.append({"call_launches": rec["launches"],
                      "call_kernels_lost": rec["lost"],
                      "lead_lost": lead_n - rec["lead"],
                      "tail_lost": PROFILE_TAIL - rec["tail"],
                      "port_kernels": recorded})
        whole = (rec["launches"] > 0 and rec["lost"] == 0 and rec["lead"]
                 and rec["tail"] and recorded == launched)
        if whole:
            break
    check(whole, f"profiler window: the call's records incomplete in each "
                 f"of {PROFILE_ATTEMPTS} windows {taken} (port kernels "
                 f"launched {launched})")
    per_name: dict = {}
    for n, us in rec["events"]:
        d, c = per_name.get(n, (0.0, 0))
        per_name[n] = (d + us, c + 1)
    busy_us = sum(d for d, _ in per_name.values())
    rows = sorted(((d, k, c) for k, (d, c) in per_name.items()),
                  reverse=True)
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": (1 - busy_us / wall_us) if busy_us else None,
           "kernel_events": recorded, "attempts": attempt,
           "windows": taken,
           "top": [{"name": k[:120], "device_ms": d / 1e3, "count": c}
                   for d, k, c in rows[:15]]}
    if counts:
        out["counts"] = {k: c for k, (_, c) in per_name.items()}
        out["counts_ms"] = {k: d / 1e3 for k, (d, _) in per_name.items()}
    return out


def prompt_len(M, cfg, batch) -> int:
    """Positions a prompt fills: its tokens, after a vision arch's
    frontend tokens."""
    return batch["tokens"].shape[1] + M.num_frontend_tokens(cfg)


def first_step(torch, M, cfg, params, batch, cache_len, tok=None):
    """Prefill logits and the first decode step's logits (fed ``tok``, or
    the prefill's greedy pick)."""
    lg, cache = M.prefill(cfg, params, batch, cache_len=cache_len)
    pick = lg[:, :cfg.vocab_size].argmax(-1)
    d, _ = M.decode_step(cfg, params, cache, pick if tok is None else tok,
                         prompt_len(M, cfg, batch))
    return lg.float(), pick, d.float()


def route_calls() -> dict:
    """A copy of ``moe_gating.ROUTE_CALLS``."""
    from repro_torch.kernels import moe_gating as tmg
    return {n: dict(rc) for n, rc in tmg.ROUTE_CALLS.items()}


def gating_routes(before: dict, launches: dict, where: str) -> dict:
    """The gating kernels' routes since ``before`` (a :func:`route_calls`
    copy): every launch of a main path takes the vector route, as many
    as ``launches`` counted."""
    routes = {n: {r: c - before[n][r] for r, c in rc.items()}
              for n, rc in route_calls().items()}
    for n, rc in routes.items():
        check(rc == {"vector": launches[n], "scalar": 0},
              f"{where}: {n} took the routes {rc} in {launches[n]} "
              f"launches; every main-path launch takes the vector route")
    return routes


def main_path(torch, ops, M, srv, want: dict) -> tuple:
    """The serving main path: a prefill timed on its own, then
    ``Server.generate`` with the launch counts set to 0 just before and
    read just after, which must equal ``want``.  Returns (tokens,
    numbers)."""
    cfg = srv.cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, _ = M.prefill(cfg, srv.params, srv.batch, cache_len=srv.cache_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(lg).all()), "prefill logits not finite")
    del lg, _
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    routes0 = route_calls()
    t0 = time.perf_counter()
    toks = srv.generate(GEN)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches == want, f"{cfg.name}: main path launches {launches}, "
                            f"expected {want}")
    routes = gating_routes(routes0, launches, f"{cfg.name} main path")
    check(toks.shape == (BATCH, GEN) and bool(((toks >= 0) & (
        toks < cfg.vocab_size)).all()), "tokens outside the vocabulary")
    return toks, dict(
        prefill_ms=prefill_s * 1e3, generate_s=gen_s,
        decode_tok_per_s=BATCH * GEN / (gen_s - prefill_s),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches, gating_routes=routes,
        sample_tokens=toks[0, :16].tolist())


def profile_serving(torch, ops, M, srv) -> dict:
    """Profiler windows over a prefill and over 4 decode steps, every
    launch of the model kernels in them."""
    cfg, prm, batch = srv.cfg, srv.params, srv.batch
    lg, cache = M.prefill(cfg, prm, batch, cache_len=srv.cache_len)
    tok = lg[:, :cfg.vocab_size].argmax(-1)
    start = prompt_len(M, cfg, batch)

    def decode4():
        for i in range(4):
            M.decode_step(cfg, prm, cache, tok, start + i)
    decode4()
    kernels = {"flash_attention": (ops.LAUNCHES, ("flash_fwd_bf16",
                                                  "flash_fwd_f32")),
               "topk_gating": (ops.LAUNCHES, ("topk_gating_rows",)),
               "ssm_scan": (ops.LAUNCHES, ("ssm_scan_fwd",)),
               "slstm_scan": (ops.LAUNCHES, ("slstm_fwd",))}
    return {"profile_prefill": profile_window(
                torch, lambda: M.prefill(cfg, prm, batch,
                                         cache_len=srv.cache_len), kernels),
            "profile_decode4": profile_window(torch, decode4, kernels)}


def serve_phase(torch, ops, ref, M, serve_lm, layers: int, seed: int):
    """Phi-3.5-MoE at full width through the port's serving entry point;
    returns (kernel entries, main-path numbers)."""
    sargs = serve_lm.parse_args([
        "--arch", ARCH, "--preset", "full", "--layers", str(layers),
        "--batch", str(BATCH), "--prompt-len", str(PROMPT), "--gen",
        str(GEN), "--seed", str(seed), "--device", DEVICE])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = serve_lm.build(sargs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, prm, batch = srv.cfg, srv.params, srv.batch
    weights_gb = torch.cuda.memory_allocated() / 1e9
    print(f"serve: {cfg.name}, {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token}, "
          f"{cfg.dtype}: {weights_gb:.2f} GB of weights made in "
          f"{init_s:.2f} s from seed {seed}")
    res = {"arch": cfg.name, "layers": cfg.num_layers, "batch": BATCH,
           "prompt": PROMPT, "gen": GEN, "cache_len": srv.cache_len,
           "weights_gb": weights_gb, "init_s": init_s}
    with torch.inference_mode():
        # every launch of a prefill and a decode step against its plain
        # version on its own inputs (also the warm-up)
        attn, gate, stats, first = checked_ops(torch, ops, ref)
        with patched(ops, attention=attn, topk_gating=gate):
            first_step(torch, M, cfg, prm, batch, srv.cache_len)
        torch.cuda.synchronize()
        st_a, st_g = stats["flash_attention"], stats["topk_gating"]
        check(st_a["calls"] == cfg.num_layers
              and st_g["calls"] == 2 * cfg.num_layers,
              f"checked run: {st_a['calls']} attention and {st_g['calls']} "
              f"gating calls for {cfg.num_layers} layers")
        check(st_a["max_rel_err"] <= ATTN_TOL,
              f"flash_attention on the main path: error "
              f"{st_a['max_rel_err']} > {ATTN_TOL}")
        check(st_g["idx_equal"] and st_g["max_abs_err"] <= GATE_TOL,
              f"topk_gating on the main path: {st_g}")
        res["every_launch_vs_plain"] = stats
        print("serve: every launch of a prefill and a decode step vs its "
              "plain version: " + json.dumps(stats))

        kern = serve_kernel_phase(torch, ops, ref, first, seed)
        del first

        toks, numbers = main_path(torch, ops, M, srv, launch_counts(
            flash_attention=cfg.num_layers,
            topk_gating=cfg.num_layers * (GEN + 1)))
        for name in kern:
            kern[name]["launches"] = numbers["launches"][name]
        res.update(numbers)

        # the same first step with the plain versions, and the control
        lk, tk, dk = first_step(torch, M, cfg, prm, batch, srv.cache_len)
        check(torch.equal(tk, toks[:, 0].long()),
              "the main path's first token is not the prefill's argmax")
        with patched(ops, attention=ref.attention_ref,
                     topk_gating=ref.topk_gating_ref):
            lp, tp, dp = first_step(torch, M, cfg, prm, batch,
                                    srv.cache_len, tk)
        with patched(ops, attention=attention_f64(torch, ref),
                     topk_gating=ref.topk_gating_ref):
            lc, tc, dc = first_step(torch, M, cfg, prm, batch,
                                    srv.cache_len, tk)
        check(bool(torch.isfinite(lp).all() and torch.isfinite(lc).all()),
              "plain-version logits not finite")
        vs = lambda a, b, ta, tb: {
            "first_tokens_equal": int((ta == tb).sum()),
            "prefill_logits_max_abs_diff": (a[0] - b[0]).abs().max().item(),
            "decode_logits_max_abs_diff": (a[1] - b[1]).abs().max().item(),
            "max_abs_logit": b[0].abs().max().item()}
        res["kernels_vs_plain"] = vs((lk, dk), (lp, dp), tk, tp)
        res["plain_vs_f64_attention_control"] = vs((lp, dp), (lc, dc), tp,
                                                   tc)
        top2 = lp[:, :cfg.vocab_size].topk(2, -1).values
        res["plain_top2_margins"] = (top2[:, 0] - top2[:, 1]).tolist()

        res["sort"] = sort_prefill(torch, ops, ref, M, srv)
        kern["topk_gating"]["launches_sort_prefill"] = \
            res["sort"]["launches"]["topk_gating"]
        kern["flash_attention"]["launches_sort_prefill"] = \
            res["sort"]["launches"]["flash_attention"]
        print("serve moe_impl='sort': " + json.dumps(res["sort"]))
        res.update(profile_serving(torch, ops, M, srv))
    del srv, prm, cfg
    return kern, res


def sort_prefill(torch, ops, ref, M, srv) -> dict:
    """The same model's prefill with ``moe_impl="sort"`` on the same
    weights and prompts: every kernel launch against its plain version;
    the launch counts of two prefills (L attention, L gating each); the
    two equal to the bit (each token's row of the ``index_add_`` sums at
    most k = 2 values into zeros, an order-free sum); prefill ms in
    turns with the einsum dispatch (einsum, sort, sort, einsum, twice);
    the logits beside the einsum path's (bf16 at depth: printed, the
    2-layer f32 run holds them)."""
    import dataclasses
    cfg = srv.cfg
    scfg = dataclasses.replace(cfg, moe_impl="sort")
    L = cfg.num_layers

    def prefill(c):
        return M.prefill(c, srv.params, srv.batch,
                         cache_len=srv.cache_len)[0].float()
    attn, gate, stats, _ = checked_ops(torch, ops, ref)
    with patched(ops, attention=attn, topk_gating=gate):
        prefill(scfg)
    st_a, st_g = stats["flash_attention"], stats["topk_gating"]
    check(st_a["calls"] == L and st_g["calls"] == L,
          f"sort prefill: {st_a['calls']} attention and {st_g['calls']} "
          f"gating calls for {L} layers")
    check(st_a["max_rel_err"] <= ATTN_TOL and st_g["idx_equal"]
          and st_g["max_abs_err"] <= GATE_TOL, f"sort prefill: {stats}")
    ops.reset_launch_counts()
    routes0 = route_calls()
    a, b = prefill(scfg), prefill(scfg)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches == attn_launches(2 * L, 0, 2 * L),
          f"sort prefill: two prefills launched {launches}")
    routes = gating_routes(routes0, launches, "sort prefill")
    check(torch.equal(a, b), "sort prefill: two runs differ")
    e = prefill(cfg)
    check(bool(torch.isfinite(a).all()), "sort prefill: logits not finite")
    ms = {"einsum": [], "sort": []}
    for name in ("einsum", "sort", "sort", "einsum") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(cfg if name == "einsum" else scfg)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
    return {"every_launch_vs_plain": stats, "launches": {
                k: v // 2 for k, v in launches.items()},
            "gating_routes": routes, "two_runs_equal": True,
            "prefill_ms": ms,
            "prefill_ms_median": {k: median(v) for k, v in ms.items()},
            "first_tokens_equal_einsum": int((
                a[:, :cfg.vocab_size].argmax(-1)
                == e[:, :cfg.vocab_size].argmax(-1)).sum()),
            "logits_max_abs_diff_vs_einsum": (a - e).abs().max().item(),
            "max_abs_logit": e.abs().max().item()}


def parity_phase(torch, ops, ref, M, get_config, data, seed: int,
                 arch: str = ARCH):
    """``arch`` (Phi-3.5-MoE, or a dense arch) at full width in float32
    with 2 layers: the first token and the logits with the kernels equal
    those with the plain versions; 2 ``flash_attention`` launches (the
    prefill's) and, for a moe arch, 2 ``topk_gating`` a MoE layer (the
    prefill's and the decode step's).  A moe arch's sort dispatch too."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32")
    moe_layers = 2 // cfg.moe_every if cfg.family == "moe" else 0
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    prm = M.init_params(cfg, gen)
    batch = data.make_batch(data.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=PROMPT, batch_size=BATCH,
        seed=seed), 0, device=DEVICE)
    cache_len = PROMPT + GEN
    with torch.inference_mode():
        ops.reset_launch_counts()
        lk, tk, dk = first_step(torch, M, cfg, prm, batch, cache_len)
        check(ops.LAUNCHES == launch_counts(flash_attention=2,
                                            topk_gating=2 * moe_layers),
              f"{cfg.name} f32 run launches {ops.LAUNCHES}")
        with patched(ops, attention=ref.attention_ref,
                     topk_gating=ref.topk_gating_ref):
            lp, tp, dp = first_step(torch, M, cfg, prm, batch, cache_len,
                                    tk)
    out = {"arch": cfg.name, "layers": 2, "dtype": "float32",
           "first_tokens_equal": int((tk == tp).sum()),
           "tolerance": f"{LOGIT_TOL} of max|logits|"}
    for name, a, b in (("prefill", lk, lp), ("decode", dk, dp)):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        out[f"{name}_logits_max_abs_diff"] = err
        out[f"{name}_max_abs_logit"] = scale
        check(err <= LOGIT_TOL * scale, f"f32 run: {name} logits differ by "
                                        f"{err} > {LOGIT_TOL}·{scale}")
    check(torch.equal(tk, tp), f"f32 run: first tokens {tk.tolist()} with "
                               f"the kernels, {tp.tolist()} plain")
    if not moe_layers:
        del prm
        return out
    # the sort dispatch (the same capacity and drop order at T = 4,096)
    with torch.inference_mode():
        ls, ts, ds = first_step(torch, M, dataclasses.replace(
            cfg, moe_impl="sort"), prm, batch, cache_len, tk)
    for name, a, b in (("prefill", ls, lk), ("decode", ds, dk)):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        out[f"sort_{name}_logits_max_abs_diff"] = err
        check(err <= LOGIT_TOL * scale, f"f32 run: the sort dispatch's "
                                        f"{name} logits differ from "
                                        f"einsum's by {err}")
    check(torch.equal(ts, tk), f"f32 run: first tokens {ts.tolist()} with "
                               f"the sort dispatch, {tk.tolist()} einsum")
    del prm
    return out


# ---------------------------------------------------------------------------
# Model-zoo serving of Zamba2-2.7B: ssm_scan (and flash_attention)
# ---------------------------------------------------------------------------

def ssm_err(torch, got, want) -> tuple[float, float]:
    """(max abs err of y and h, the larger of the two over its tolerance
    (SSM_TOL for bf16 y, SSM_TOL_F32 for f32 y and for h), relative to
    max(1, max|plain|))."""
    (y, h), (yr, hr) = got, want
    ey, ry = rel_err(torch, y, yr)
    eh, rh = rel_err(torch, h, hr)
    ytol = SSM_TOL if y.dtype == torch.bfloat16 else SSM_TOL_F32
    return max(ey, eh), max(ry / ytol, rh / SSM_TOL_F32)


def checked_ssm(torch, ops, ref):
    """A stand-in for ``ops.ssm_scan`` that launches the kernel through the
    real wrapper, then holds y and h against the plain version on the same
    inputs.  Keeps the worst error and layer 0's inputs."""
    real = ops.ssm_scan
    stats = {"calls": 0, "max_abs_err": 0.0, "max_err_over_tol": 0.0}
    first: dict = {}

    def ssm_scan(x, dt, A, Bm, Cm, h0=None):
        out = real(x, dt, A, Bm, Cm, h0)
        err, over = ssm_err(torch, out, ref.ssm_scan_ref(x, dt, A, Bm, Cm,
                                                          h0))
        stats["calls"] += 1
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        stats["max_err_over_tol"] = max(stats["max_err_over_tol"], over)
        first.setdefault("ssm", (x, dt, A, Bm, Cm, h0))
        return out
    return ssm_scan, stats, first


def ssm_bound(torch, x, Bm, h0) -> tuple[float, str]:
    """Least time for one scan: x and dt read and y written once (x's
    type), B and C read once, A, h0 (when given) and h once in f32; 5
    operations a (b, t, c, n) on the FP32 cores."""
    B, S, C = x.shape
    N = Bm.shape[-1]
    e = x.element_size()
    nbytes = 3 * B * S * C * e + 2 * B * S * N * e + 4 * C \
        + 4 * B * C * N * (1 if h0 is None else 2)
    return bound(nbytes, 5.0 * B * S * C * N)


def ssm_kernel_phase(torch, ops, ref, first, seed: int):
    """``ssm_scan`` against its plain version at layer 0's real inputs,
    timed (eager and device alone), on those inputs one element past
    16-byte alignment, and at ragged shapes (S = 1, 25, 200, 1,000; h0
    given and None; N = 1, 16, 17, 63 and 64; C not a multiple of the
    32-channel block; bf16 and f32)."""
    gen = torch.Generator().manual_seed(seed + 3)
    args = first["ssm"]
    x, dt, A, Bm, Cm, h0 = args
    got = ops.ssm_scan(*args)
    want = ref.ssm_scan_ref(*args)
    torch.cuda.synchronize()
    again = ops.ssm_scan(*args)
    check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
          "ssm_scan: two launches differ")
    err, over = ssm_err(torch, got, want)
    check(over <= 1.0, f"ssm_scan: error {over} of its tolerance at layer "
                       f"0's shapes")
    # layer 0's inputs, each one element past 16-byte alignment: the
    # kernel's element loads in place of its 16-byte copies
    moved = [None if t is None else offset_view(torch, t)
             if i in (0, 1, 3, 4) else t for i, t in enumerate(args)]
    uerr, uover = ssm_err(torch, ops.ssm_scan(*moved),
                          ref.ssm_scan_ref(*moved))
    check(uover <= 1.0, f"ssm_scan: error {uover} of its tolerance on views "
                        f"one element past alignment")
    del moved
    ragged = {}
    for B, S, C, N, with_h0 in [(4, 1, 5120, 64, True),
                                (2, 25, 130, 16, False),
                                (3, 200, 257, 64, True),
                                (1, 1000, 5000, 64, False),
                                (2, 1000, 96, 16, True),
                                (2, 300, 70, 1, True),
                                (3, 200, 200, 17, False),
                                (1, 1000, 1000, 63, True)]:
        for dtype in (torch.bfloat16, torch.float32):
            r = lambda *shape: torch.randn(shape, generator=gen)
            xs, Bs, Cs = r(B, S, C), r(B, S, N), r(B, S, N)
            dts = torch.nn.functional.softplus(r(B, S, C) - 1)
            As = -torch.exp(torch.rand(C, generator=gen) * 2 - 1)
            hs = r(B, C, N) if with_h0 else None
            a = [t.to(DEVICE, dtype) for t in (xs, dts)] + [As.to(DEVICE)] \
                + [t.to(DEVICE, dtype) for t in (Bs, Cs)] \
                + [None if hs is None else hs.to(DEVICE)]
            e, o = ssm_err(torch, ops.ssm_scan(*a), ref.ssm_scan_ref(*a))
            key = f"B={B} S={S} C={C} N={N} h0={with_h0} {str(dtype)[6:]}"
            check(o <= 1.0, f"ssm_scan: error {o} of its tolerance at {key}")
            ragged[key] = e
    ms = time_ms(torch, lambda: ops.ssm_scan(*args), iters=100)
    device_ms = graph_ms(torch, lambda: ops.ssm_scan(*args))
    plain_ms = time_ms(torch, lambda: ref.ssm_scan_ref(*args), iters=2,
                       warmup=1)
    ms_again = time_ms(torch, lambda: ops.ssm_scan(*args), iters=100)
    bms, by = ssm_bound(torch, x, Bm, h0)
    return {
        "max_abs_err": err, "ms": ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": None,
        "library": "none: no single PyTorch call computes a selective scan",
        "tolerance": f"{SSM_TOL} of max(1, max|plain|) for bf16 y, "
                     f"{SSM_TOL_F32} for f32 y and h",
        "max_err_over_tol": over, "ragged_max_abs_err": ragged,
        "unaligned_max_abs_err": uerr,
        "ms_repeat": ms_again, "bound_share": bms / ms,
        "device_bound_share": bms / device_ms,
        "shape": {"x": list(x.shape), "B": list(Bm.shape),
                  "dtype": str(x.dtype), "x_strides": list(x.stride()),
                  "h0": None if h0 is None else list(h0.shape)}}


def zamba_phase(torch, ops, ref, M, serve_lm, layers: int, seed: int):
    """Zamba2-2.7B at full width through the port's serving entry point;
    returns (the ssm_scan entry, main-path numbers)."""
    sargs = serve_lm.parse_args([
        "--arch", ZAMBA, "--preset", "full", "--layers", str(layers),
        "--batch", str(BATCH), "--prompt-len", str(ZPROMPT), "--gen",
        str(GEN), "--seed", str(seed), "--device", DEVICE])
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    srv = serve_lm.build(sargs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, prm, batch = srv.cfg, srv.params, srv.batch
    groups = cfg.num_layers // cfg.attn_every
    weights_gb = torch.cuda.memory_allocated() / 1e9 - before_gb
    print(f"zamba2: {cfg.name}, {cfg.num_layers} mamba layers + the shared "
          f"block x{groups}, d={cfg.d_model}, {cfg.dtype}: "
          f"{weights_gb:.2f} GB of weights made in {init_s:.2f} s from seed "
          f"{seed} ({before_gb:.2f} GB held before)")
    res = {"arch": cfg.name, "layers": cfg.num_layers, "groups": groups,
           "batch": BATCH, "prompt": ZPROMPT, "gen": GEN,
           "cache_len": srv.cache_len, "weights_gb": weights_gb,
           "allocated_before_gb": before_gb, "init_s": init_s}
    with torch.inference_mode():
        # every launch of a prefill and a decode step against its plain
        # version on its own inputs (also the warm-up)
        attn, _, astats, afirst = checked_ops(torch, ops, ref)
        ssm, sstats, sfirst = checked_ssm(torch, ops, ref)
        with patched(ops, attention=attn, ssm_scan=ssm):
            first_step(torch, M, cfg, prm, batch, srv.cache_len)
        torch.cuda.synchronize()
        st_a = astats["flash_attention"]
        check(sstats["calls"] == cfg.num_layers and st_a["calls"] == groups,
              f"checked run: {sstats['calls']} scans and {st_a['calls']} "
              f"attention calls for {cfg.num_layers} layers")
        check(sstats["max_err_over_tol"] <= 1.0,
              f"ssm_scan on the main path: {sstats}")
        check(st_a["max_rel_err"] <= ATTN_TOL,
              f"flash_attention on the Zamba2 path: error "
              f"{st_a['max_rel_err']} > {ATTN_TOL}")
        stats = {"ssm_scan": sstats, "flash_attention": st_a}
        res["every_launch_vs_plain"] = stats
        print("zamba2: every launch of a prefill and a decode step vs its "
              "plain version: " + json.dumps(stats))
        q, k, v, kw = afirst["attention"]
        res["flash_attention_layer0"] = attention_timing(torch, ops, ref, q,
                                                         k, v, kw)
        del afirst, q, k, v
        kern = ssm_kernel_phase(torch, ops, ref, sfirst, seed)
        del sfirst

        toks, numbers = main_path(torch, ops, M, srv, launch_counts(
            flash_attention=groups, ssm_scan=cfg.num_layers))
        res.update(numbers)

        # the same first step with the plain versions (printed only)
        lk, tk, dk = first_step(torch, M, cfg, prm, batch, srv.cache_len)
        check(torch.equal(tk, toks[:, 0].long()),
              "the main path's first token is not the prefill's argmax")
        with patched(ops, attention=ref.attention_ref,
                     ssm_scan=ref.ssm_scan_ref):
            lp, tp, dp = first_step(torch, M, cfg, prm, batch,
                                    srv.cache_len, tk)
        check(bool(torch.isfinite(lp).all()), "plain logits not finite")
        top2 = lp[:, :cfg.vocab_size].topk(2, -1).values
        res["kernels_vs_plain_bf16"] = {
            "first_tokens_equal": int((tk == tp).sum()),
            "prefill_logits_max_abs_diff": (lk - lp).abs().max().item(),
            "decode_logits_max_abs_diff": (dk - dp).abs().max().item(),
            "max_abs_logit": lp.abs().max().item(),
            "plain_top2_margins": (top2[:, 0] - top2[:, 1]).tolist()}

        res.update(profile_serving(torch, ops, M, srv))
    kern["launches"] = res["launches"]["ssm_scan"]
    del srv, prm, cfg
    return kern, res


def ssm_scan_f64(torch):
    """The plain scan's steps in float64: the control for how far the
    model amplifies a change of rounding."""
    def ssm_scan(x, dt, A, Bm, Cm, h0=None):
        xd, dtd, Ad, Bd, Cd = (t.double() for t in (x, dt, A, Bm, Cm))
        h = torch.zeros((x.shape[0], x.shape[2], Bm.shape[-1]),
                        dtype=torch.float64, device=x.device) \
            if h0 is None else h0.double()
        ys = []
        for t in range(x.shape[1]):
            h = torch.exp(dtd[:, t] * Ad)[:, :, None] * h \
                + (dtd[:, t] * xd[:, t])[:, :, None] * Bd[:, t][:, None, :]
            ys.append(torch.einsum("bcn,bn->bc", h, Cd[:, t]))
        return torch.stack(ys, dim=1).to(x.dtype), h.float()
    return ssm_scan


def zamba_parity_phase(torch, ops, ref, M, get_config, data, seed: int):
    """Zamba2-2.7B at full width in float32 with 12 layers (2 groups): the
    logits with the kernels equal those with the plain versions within
    LOGIT_TOL, and so do the first tokens wherever f32 can decide them
    (see the check at the end); a float64 control (scan and attention in
    float64) measures how far the model amplifies f32 rounding."""
    import dataclasses
    cfg = dataclasses.replace(get_config(ZAMBA), num_layers=12,
                              dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    prm = M.init_params(cfg, gen)
    batch = data.make_batch(data.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=ZPROMPT, batch_size=BATCH,
        seed=seed), 0, device=DEVICE)
    cache_len = ZPROMPT + GEN
    with torch.inference_mode():
        ops.reset_launch_counts()
        lk, tk, dk = first_step(torch, M, cfg, prm, batch, cache_len)
        check(ops.LAUNCHES == launch_counts(flash_attention=2, ssm_scan=12),
              f"Zamba2 f32 run launches {ops.LAUNCHES}")
        with patched(ops, attention=ref.attention_ref,
                     ssm_scan=ref.ssm_scan_ref):
            lp, tp, dp = first_step(torch, M, cfg, prm, batch, cache_len,
                                    tk)
        with patched(ops, attention=attention_f64(torch, ref),
                     ssm_scan=ssm_scan_f64(torch)):
            lc, tc, dc = first_step(torch, M, cfg, prm, batch, cache_len,
                                    tk)
    top2 = lambda lg: (lambda v: (v[:, 0] - v[:, 1]).tolist())(
        lg[:, :cfg.vocab_size].topk(2, -1).values)
    out = {"layers": 12, "groups": 2, "dtype": "float32",
           "first_tokens_equal": int((tk == tp).sum()),
           "tolerance": f"{LOGIT_TOL} of max|logits|",
           "tokens": {"kernels": tk.tolist(), "plain": tp.tolist(),
                      "f64_control": tc.tolist()},
           "top2_margins": {"kernels": top2(lk), "plain": top2(lp),
                            "f64_control": top2(lc)},
           "f64_control_vs_plain": {
               "prefill_logits_max_abs_diff": (lc - lp).abs().max().item(),
               "decode_logits_max_abs_diff": (dc - dp).abs().max().item()},
           "f64_control_vs_kernels": {
               "prefill_logits_max_abs_diff": (lc - lk).abs().max().item(),
               "decode_logits_max_abs_diff": (dc - dk).abs().max().item()}}
    for name, a, b in (("prefill", lk, lp), ("decode", dk, dp)):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        out[f"{name}_logits_max_abs_diff"] = err
        out[f"{name}_max_abs_logit"] = scale
    print("Zamba2 f32 parity (12 layers, full width): " + json.dumps(out))
    for name, a, b in (("prefill", lk, lp), ("decode", dk, dp)):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        check(err <= LOGIT_TOL * scale, f"Zamba2 f32 run: {name} logits "
                                        f"differ by {err} > "
                                        f"{LOGIT_TOL}·{scale}")
    # A first token is decidable in f32 where the float64 control's top-2
    # margin exceeds twice the plain f32 path's own distance from the
    # control; there the kernels must pick the plain version's token, and
    # elsewhere one of the control's top two.
    floor = out["f64_control_vs_plain"]["prefill_logits_max_abs_diff"]
    top2_c = lc[:, :cfg.vocab_size].topk(2, -1).indices
    decidable = [m > 2 * floor for m in out["top2_margins"]["f64_control"]]
    out["decidable_rows"] = decidable
    out["decidable_first_tokens_equal"] = all(
        bool(tk[i] == tp[i]) for i, d in enumerate(decidable) if d)
    check(out["decidable_first_tokens_equal"],
          f"Zamba2 f32 run: first tokens {tk.tolist()} with the kernels, "
          f"{tp.tolist()} plain, in rows decidable in f32 {decidable}")
    check(all(bool((top2_c[i] == tk[i]).any())
              for i, d in enumerate(decidable) if not d),
          f"Zamba2 f32 run: a first token {tk.tolist()} outside the "
          f"control's top two {top2_c.tolist()}")
    check(sum(decidable) >= 3, f"Zamba2 f32 run: only {sum(decidable)} of "
                               f"4 first tokens decidable in f32")
    del prm
    return out


# ---------------------------------------------------------------------------
# Model-zoo training of MiniCPM-2B: flash_attention forward and backward
# ---------------------------------------------------------------------------

TRAIN_ARCH = "minicpm-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
TRAIN_RESUME_LAYERS = 2        # the resume check's depth (checkpoints of the
                               # full-depth state take ~36 GB each; 2 layers
                               # hold every kind of leaf, and cost ~10 s less
                               # than 4 in files, for xLSTM's STRADS run)
ATTN_BWD_TOL = 2e-2            # bf16 dq, dk, dv vs the f32 plain version:
                               # |Δ| ≤ ATTN_BWD_TOL·max|plain| (P and dS are
                               # rounded to bf16 as operands)
ATTN_BWD_TOL_F32 = 1e-4        # f32 kernels vs the f64 plain version
LSE_TOL = 1e-4                 # |Δ lse| ≤ LSE_TOL·max(1, max|lse|)
TRAIN_LOSS_TOL = 1e-5          # f32 parity: |Δ loss| ≤ TRAIN_LOSS_TOL·|loss|
TRAIN_GRAD_TOL = 1e-3          # f32 parity: |Δ g| ≤ TRAIN_GRAD_TOL·max|g|
                               # for every parameter leaf


def train_argv(seed: int, *extra) -> list:
    return ["--arch", TRAIN_ARCH, "--preset", "full", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
            str(TRAIN_STEPS), "--log-every", "1", "--seed", str(seed),
            "--device", DEVICE, *extra]


def launch_counts(**counts) -> dict:
    """A full ``ops.LAUNCHES`` dict: the given counts, 0 elsewhere."""
    out = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                         "topk_gating", "topk_gating_bwd", "ssm_scan",
                         "ssm_scan_bwd", "slstm_scan", "slstm_scan_bwd"), 0)
    check(set(counts) <= set(out), f"unknown kernels {set(counts) - set(out)}")
    out.update(counts)
    return out


def attn_launches(fwd: int = 0, bwd: int = 0, gating: int = 0) -> dict:
    """A full ``ops.LAUNCHES`` dict of attention's and gating's counts."""
    return launch_counts(flash_attention=fwd, flash_attention_bwd=bwd,
                    topk_gating=gating)


def bwd_routes(route=None, n: int = 0) -> dict:
    """A full ``BWD_ROUTE_CALLS`` dict: ``n`` calls on ``route``."""
    out = {"f32": 0, "mma_sync": 0, "wgmma": 0}
    if route:
        out[route] = n
    return out


def train_run(torch, ops, tfa, tlaunch, argv, on_step, layers: int,
              steps: int = TRAIN_STEPS, tokens: int = TRAIN_BATCH * TRAIN_SEQ,
              per_step: dict = None) -> tuple:
    """One ``launch.train.main`` run of ``steps`` steps with the launch
    counts set to 0 just before and read just after: 2 forward launches
    a layer a step (the forward and the group checkpoint's recompute) and
    1 backward, every backward on the wgmma route; or ``per_step``'s
    counts a step, when given.  The loss must fall; step ms is the median
    of steps 2 on."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    routes0 = dict(tfa.BWD_ROUTE_CALLS)
    gates0 = route_calls()
    t0 = time.perf_counter()
    hist = tlaunch.main(argv, on_step=on_step)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    gates = gating_routes(gates0, launches,
                          f"training run {argv[:2]} {argv[-4:]}")
    routes = {r: n - routes0[r] for r, n in tfa.BWD_ROUTE_CALLS.items()}
    if per_step is None:
        n = layers * steps
        want = attn_launches(2 * n, n)
    else:
        want = launch_counts(**{k: c * steps for k, c in per_step.items()})
        n = want["flash_attention_bwd"]
    check(launches == want, f"training run {argv[:2]} {argv[-4:]}: "
                            f"launches {launches}, expected {want}")
    check(routes == bwd_routes("wgmma", n),
          f"training run {argv[:2]} {argv[-4:]}: backward routes {routes}, "
          f"expected {n} on wgmma")
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps and all(map(math.isfinite, losses)),
          f"training run: losses {losses}")
    check(losses[-1] < losses[0], f"training run {argv[:2]}: the loss did "
                                  f"not fall: {losses}")
    step_ms = median([h["step_ms"] for h in hist[1:]])
    return hist, {
        "seconds": secs, "launches": launches, "bwd_routes": routes,
        "gating_routes": gates, "losses": losses,
        "grad_norms": [h["grad_norm"] for h in hist],
        "lrs": [h["lr"] for h in hist],
        "step_ms": [h["step_ms"] for h in hist],
        "step_ms_median_from_2": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def strads_checker(torch, tree_flatten, L: int, U: int, box: dict) -> tuple:
    """An ``on_step`` for a STRADS run (``--weight-decay 0``) of a model
    whose layer leaves are stacked over L layer groups (``layers/…``,
    masked along their leading axis; every other leaf in block L): after
    every step no block outside the mask moved (each leaf compared as its
    bytes, a group's slice at a time) and at most U blocks were active.
    Returns (the callback, its stats, the copy of the last parameters);
    the last state goes to ``box["state"]``."""
    prev, sstats = {}, {"blocks_active": [], "scheduled_moved": [],
                        "unscheduled_layers_checked": 0}

    def strads_check(i, state, metrics):
        params = tree_flatten(state["params"])
        if metrics is not None:
            mask = metrics["mask"] > 0
            active = int(mask.sum())
            sstats["blocks_active"].append(active)
            check(active == float(metrics["blocks_active"]) and active <= U,
                  f"STRADS step {i}: {active} blocks active, U = {U}")
            moved = torch.zeros(L + 1, dtype=torch.bool, device=DEVICE)
            for n, x in params:
                b = prev[n]
                if n.startswith("layers/"):
                    same = (x.view(torch.uint8) == b.view(torch.uint8)) \
                        .reshape(x.shape[0], -1).all(1)
                    moved[:L] |= ~same
                else:
                    moved[L] |= not torch.equal(x, b)
            check(not bool((moved & ~mask).any()),
                  f"STRADS step {i}: unscheduled blocks "
                  f"{(moved & ~mask).nonzero().flatten().tolist()} moved")
            sstats["unscheduled_layers_checked"] += int((~mask).sum())
            sstats["scheduled_moved"].append(int((moved & mask).sum()))
        prev.clear()
        prev.update({n: x.clone() for n, x in params})
        box["state"] = state
    return strads_check, sstats, prev


def bwd_bound(torch, ref, q, k, causal, window) -> tuple[float, str]:
    """Least time for one backward call: its five products (QKᵀ, dO·Vᵀ,
    Pᵀ·dO, dSᵀ·Q, dS·K; 2·D operations a visible pair each) at the
    tensor cores' bf16 rate (FP32 rate for f32), or q, k, v, o, dO and
    lse read and dq, dk, dv written once, if that takes longer."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    pairs = int(ref.attention_mask(Sq, Skv, Skv - Sq, causal,
                                   window).sum())
    rate = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops = 10.0 * B * Hq * D * pairs / rate
    nbytes = (q.element_size() * (4 * B * Sq * Hq * D + 4 * B * Skv * Hkv * D)
              + 4 * B * Hq * Sq)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bwd_check(torch, ref, tfa, q, k, v, kw, seed: int,
              route: str = "wgmma") -> dict:
    """The forward (with lse) and the backward kernel at (q, k, v) (B, S,
    H, D) against the plain versions: f32 math for bf16 inputs within
    ATTN_BWD_TOL of each gradient's largest magnitude, f64 math for f32
    inputs within ATTN_BWD_TOL_F32; lse within LSE_TOL, −inf on exactly
    the rows that see no key; two runs equal to the bit; the backward on
    ``route``."""
    t = lambda x: x.transpose(1, 2)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dout = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
    calls0 = tfa.BWD_ROUTE_CALLS[route]

    def run():
        o, lse = tfa.flash_attention(t(q), t(k), t(v), return_lse=True, **kw)
        g = tfa.flash_attention_bwd(t(q), t(k), t(v), o, lse, t(dout), **kw)
        return (t(o), lse) + tuple(t(x) for x in g)
    first, again = run(), run()
    torch.cuda.synchronize()
    took = tfa.bwd_route(t(q), t(k), t(v), t(first[0]), t(dout))
    check(took == route and tfa.BWD_ROUTE_CALLS[route] == calls0 + 2,
          f"flash_attention_bwd: route {took}, expected {route} at "
          f"{tuple(q.shape)} {tuple(k.shape)}")
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"flash_attention_bwd: two runs differ at {tuple(q.shape)}")
    o, lse, dq, dk, dv = first
    bf16 = q.dtype == torch.bfloat16
    rdt, tol = (torch.float32, ATTN_BWD_TOL) if bf16 else \
        (torch.float64, ATTN_BWD_TOL_F32)
    shape = f"q {tuple(q.shape)} k {tuple(k.shape)} {kw} {q.dtype}"
    lse_ref = ref.attention_lse_ref(q, k, **kw, dtype=rdt)
    seen = torch.isfinite(lse_ref)
    check(torch.equal(seen, torch.isfinite(lse))
          and bool((lse[~seen] == float("-inf")).all()),
          f"flash_attention lse: rows without a key differ at {shape}")
    lse_err = (lse[seen].double() - lse_ref[seen].double()).abs().max()
    lse_err = lse_err.item() if seen.any() else 0.0
    lse_scale = max(1.0, lse_ref[seen].abs().max().item()) \
        if seen.any() else 1.0
    check(lse_err <= LSE_TOL * lse_scale,
          f"flash_attention lse: error {lse_err} at {shape}")
    fwd_err, fwd_rel = rel_err(torch, o, ref.attention_ref(q, k, v, **kw))
    check(fwd_rel <= (ATTN_TOL if bf16 else ATTN_TOL_F32),
          f"flash_attention: forward error {fwd_rel} at {shape}")
    want = ref.attention_bwd_ref(q, k, v, o, dout, lse_ref, **kw, dtype=rdt)
    out = {"shape": shape, "bwd_route": route, "lse_max_abs_err": lse_err,
           "forward_max_abs_err": fwd_err, "tolerance": tol}
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        err = (got.to(rdt) - w).abs().max().item()
        scale = w.abs().max().item()
        out[f"{name}_max_abs_err"] = err
        out[f"{name}_max_abs"] = scale
        check(err <= tol * scale, f"flash_attention_bwd: {name} error {err} "
                                  f"> {tol}·{scale} at {shape}")
    del want, first, again
    return out


# B, Sq, Skv, Hq, Hkv, D, causal, window, dtype[, offset]: Granite's GQA
# 32/8 at head dim 64 and Phi's 32/8 at 128 (bf16, the wgmma route), and
# at 1,000 rows (a tail of 104, not a multiple of 128); Sq < Skv, Sq > Skv
# with a window (rows that see no key), full attention, ragged, on the
# wgmma route; a view one element into its buffer (bf16, the mma.sync
# route); Zamba2's head dim 80 with a window (bf16, the wgmma route) and
# one element into its buffer (the mma.sync route); Zamba2's head dim 80
# with a window, Sq < Skv and Sq > Skv with ragged tails, and full
# attention, in f32 against the f64 plain version
TRAIN_BWD_CASES = [
    (1, 2048, 2048, 32, 8, 64, True, None, "bfloat16"),
    (1, 2048, 2048, 32, 8, 128, True, None, "bfloat16"),
    (1, 1000, 1000, 32, 8, 64, True, None, "bfloat16"),
    (1, 1000, 1000, 32, 8, 128, True, None, "bfloat16"),
    (2, 333, 1001, 8, 2, 128, True, None, "bfloat16"),
    (1, 700, 333, 8, 2, 64, True, 100, "bfloat16"),
    (2, 129, 257, 4, 1, 64, False, None, "bfloat16"),
    (1, 1000, 1000, 32, 8, 64, True, None, "bfloat16", 1),
    (2, 1000, 1000, 32, 32, 80, True, 300, "bfloat16"),
    (1, 1000, 1000, 32, 32, 80, True, 300, "bfloat16", 1),
    (2, 1000, 1000, 32, 32, 80, True, 300, "float32"),
    (2, 333, 1001, 8, 2, 64, True, None, "float32"),
    (1, 700, 333, 8, 2, 128, True, 100, "float32"),
    (2, 129, 257, 4, 1, 80, False, None, "float32"),
]


def case_route(D: int, dtype: str, offset: int) -> str:
    """The backward route a TRAIN_BWD_CASES case must take."""
    if dtype == "float32":
        return "f32"
    return "wgmma" if D in (64, 80, 128) and not offset else "mma_sync"


def bwd_ptxas() -> dict:
    """Registers, shared memory and spills of the wgmma route's kernels
    (ptxas's report of the build); none may spill."""
    from repro_torch.kernels import _build
    regs = ptxas_kernels(_build.build_log["flash_attention"]["ptxas"])
    out = {n: regs.get(n) for n in (
        "flash_bwd_prep<64>", "flash_bwd_dkdv_wgmma<64>",
        "flash_bwd_dq_wgmma<64,3>", "flash_bwd_prep<80>",
        "flash_bwd_dkdv_wgmma<80>", "flash_bwd_dq_wgmma<80,3>",
        "flash_bwd_prep<128>", "flash_bwd_dkdv_wgmma<128>",
        "flash_bwd_dq_wgmma<128,2>")}
    check(all(r and r.get("spill_store_bytes") == 0
              and r.get("spill_load_bytes") == 0 for r in out.values()),
          f"flash_attention_bwd: the wgmma route's kernels spill or are "
          f"missing from ptxas's report: {out}")
    return out


def train_kernel_phase(torch, ops, ref, tfa, first, seed: int) -> tuple:
    """flash_attention_bwd at layer 0's inputs of a training step and at
    the shapes of TRAIN_BWD_CASES against its plain version, then timed
    at layer 0's inputs: the raw launchers eager and in a CUDA graph,
    the plain version, and SDPA's forward and backward beside them.
    Returns (the bwd kernel's entry, the forward's training-shape
    entry)."""
    q, k, v, kw = first
    checks = {"layer0": bwd_check(torch, ref, tfa, q, k, v, kw, seed)}
    gen = torch.Generator().manual_seed(seed + 5)
    for i, (B, Sq, Skv, Hq, Hkv, D, causal, window, dt, *off) in enumerate(
            TRAIN_BWD_CASES):
        dtype = getattr(torch, dt)
        off = off[0] if off else 0

        def put(shape):
            x = torch.randn(shape, generator=gen).to(DEVICE, dtype)
            if not off:
                return x
            buf = torch.zeros(x.numel() + off, dtype=dtype, device=DEVICE)
            buf[off:] = x.reshape(-1)
            return buf[off:].view(shape)
        a, b, c = (put(s) for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                                    (B, Skv, Hkv, D)))
        checks[f"case{i}"] = bwd_check(torch, ref, tfa, a, b, c,
                                       {"causal": causal, "window": window},
                                       seed + i, case_route(D, dt, off))
        del a, b, c
    entry, fwd_entry = bwd_timing(torch, ref, tfa, q, k, v, kw, seed)
    entry.update(
        max_abs_err=max(checks["layer0"][f"d{x}_max_abs_err"]
                        for x in "qkv"),
        tolerance=f"{ATTN_BWD_TOL} of each gradient's max|plain| (bf16, "
                  f"f32 plain), {ATTN_BWD_TOL_F32} (f32, f64 plain)",
        checks=checks)
    fwd_entry["max_rel_err"] = checks["layer0"]["forward_max_abs_err"]
    return entry, fwd_entry


def bwd_timing(torch, ref, tfa, q, k, v, kw, seed: int) -> tuple:
    """The backward kernel at (q, k, v) (B, S, H, D): the raw launchers
    eager and in a CUDA graph, the plain version, and SDPA's forward and
    backward beside them (the call's causal flag; GQA expanded by SDPA).
    Returns (the backward's entry, the forward's with its lse)."""
    import torch.nn.functional as F
    t = lambda x: x.transpose(1, 2)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dout = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
    o, lse = tfa.flash_attention(t(q), t(k), t(v), return_lse=True, **kw)
    bwd = lambda: tfa.flash_attention_bwd(t(q), t(k), t(v), o, lse, t(dout),
                                          **kw)
    fwd_lse = lambda: tfa.flash_attention(t(q), t(k), t(v), return_lse=True,
                                          **kw)
    fwd = lambda: tfa.flash_attention(t(q), t(k), t(v), **kw)
    lse_ref = ref.attention_lse_ref(q, k, **kw)
    plain = lambda: ref.attention_bwd_ref(q, k, v, t(o), dout, lse_ref,
                                          **kw)
    qs, ks, vs = (t(x).detach().requires_grad_() for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=kw["causal"], enable_gqa=gqa)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qs, ks, vs), t(dout))

    def sdpa_fwd():
        with torch.no_grad():
            sdpa()
    check(kw["window"] is None, f"flash_attention_bwd: SDPA's yardstick "
                                f"here has no window; the call has {kw}")
    timing = {
        "ms": time_ms(torch, bwd, iters=20),
        "device_ms": graph_ms(torch, bwd),
        "plain_ms": time_ms(torch, plain, iters=3, warmup=1),
        "forward_lse_ms": time_ms(torch, fwd_lse, iters=20),
        "forward_lse_device_ms": graph_ms(torch, fwd_lse),
        "forward_device_ms": graph_ms(torch, fwd),
        "library_fwd_bwd_ms": time_ms(torch, sdpa_fwd_bwd, iters=20),
        "library_fwd_ms": time_ms(torch, sdpa_fwd, iters=20),
        "library_fwd_bwd_device_ms": graph_ms(torch, sdpa_fwd_bwd),
        "library_fwd_device_ms": graph_ms(torch, sdpa_fwd),
        "ms_repeat": time_ms(torch, bwd, iters=20)}
    timing["library_ms"] = (timing["library_fwd_bwd_ms"]
                            - timing["library_fwd_ms"])
    timing["library_device_ms"] = (timing["library_fwd_bwd_device_ms"]
                                   - timing["library_fwd_device_ms"])
    bms, by = bwd_bound(torch, ref, q, k, kw["causal"], kw["window"])
    fbms, fby = attention_bound(torch, ref, q, k, kw["causal"], kw["window"])
    shape = {"q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype),
             "causal": kw["causal"]}
    entry = {
        **timing, "bound_ms": bms, "bound_by": by,
        "bound_share": bms / timing["ms"],
        "device_bound_share": bms / timing["device_ms"],
        "library": f"F.scaled_dot_product_attention(is_causal="
                   f"{kw['causal']}, enable_gqa={gqa}) forward and backward, "
                   f"less its forward (SDPA has no backward call of its "
                   f"own); device ms: each a CUDA graph",
        "shape": shape}
    fwd_entry = {"shape": shape,
                 "ms": timing["forward_lse_ms"],
                 "device_ms": timing["forward_lse_device_ms"],
                 "device_ms_without_lse": timing["forward_device_ms"],
                 "library_ms": timing["library_fwd_ms"],
                 "library_device_ms": timing["library_fwd_device_ms"],
                 "bound_ms": fbms,
                 "bound_by": fby,
                 "device_bound_share": fbms / timing["forward_lse_device_ms"]}
    del o, lse, dout, qs, ks, vs, lse_ref
    return entry, fwd_entry


def train_f32_parity(torch, ops, ref, M, tstep, get_config, data,
                     seed: int) -> dict:
    """MiniCPM-2B at full width in float32 with 2 layers: one step's loss
    and gradients through the kernels (forward and backward) against the
    same model through the plain attention under autograd on the card.

    At the reference's init (every stacked weight of std L^-0.5) the
    gradients are ill-conditioned: a change of rounding inside attention
    moves some leaves by ~1e-3 of their largest value.  So the stated
    tolerances are held with the layer weights scaled by 0.1
    (``scaled``), and at the reference's init the kernels are held
    within the larger of TRAIN_GRAD_TOL and twice the distance of a
    control (the plain attention in float64) from the plain path."""
    import dataclasses
    from repro_torch.optim import tree_flatten
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=2,
                              dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    prm = M.init_params(cfg, gen)
    batch = data.make_batch(data.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=seed), 0, device=DEVICE)

    def leaf_rel(ga, gb) -> dict:
        return {n: (a - b).abs().max().item() / max(b.abs().max().item(),
                                                   1e-30)
                for (n, a), (_, b) in zip(tree_flatten(ga),
                                          tree_flatten(gb))}
    out = {"layers": 2, "dtype": "float32",
           "tolerance": f"loss {TRAIN_LOSS_TOL} relative; each gradient "
                        f"leaf {TRAIN_GRAD_TOL} of its max|g| (scaled), "
                        f"max({TRAIN_GRAD_TOL}, 2x the f64 control's "
                        f"distance) at the reference init"}
    for name in ("scaled", "reference_init"):
        if name == "scaled":
            p = {k: v for k, v in prm.items()}
            p["layers"] = {sub: {n: (x if n == "norm" else x * 0.1)
                                 for n, x in leaves.items()}
                           for sub, leaves in prm["layers"].items()}
        else:
            p = prm
        ops.reset_launch_counts()
        (lk, _), gk = tstep.value_and_grad(cfg, p, batch)
        torch.cuda.synchronize()
        check(ops.LAUNCHES["flash_attention"] == 4
              and ops.LAUNCHES["flash_attention_bwd"] == 2,
              f"f32 training step launches {ops.LAUNCHES}")
        with patched(ops, attention=ref.attention_ref):
            (lp, _), gp = tstep.value_and_grad(cfg, p, batch)
        rel = leaf_rel(gk, gp)
        res = {"loss_kernels": float(lk), "loss_plain": float(lp),
               "grad_rel": rel, "grad_worst_rel": max(rel.values())}
        del gk
        limit = TRAIN_GRAD_TOL
        if name == "reference_init":
            with patched(ops, attention=attention_f64(torch, ref)):
                (lc, _), gc = tstep.value_and_grad(cfg, p, batch)
            crel = leaf_rel(gc, gp)
            res.update(loss_f64_control=float(lc), control_grad_rel=crel,
                       control_grad_worst_rel=max(crel.values()))
            limit = max(limit, 2 * res["control_grad_worst_rel"])
            del gc
        del gp, p
        res["limit"] = limit
        out[name] = res
        check(abs(float(lk) - float(lp)) <= TRAIN_LOSS_TOL * abs(float(lp)),
              f"f32 training step ({name}): loss {float(lk)} vs plain "
              f"{float(lp)}")
        check(res["grad_worst_rel"] <= limit,
              f"f32 training step ({name}): a gradient leaf differs by "
              f"{res['grad_worst_rel']} of its largest > {limit}")
    print("training f32 parity (2 layers, full width): " + json.dumps(out))
    del prm
    return out


def train_resume(torch, tlaunch, tree_flatten, seed: int) -> dict:
    """Full width, TRAIN_RESUME_LAYERS layers: ``--ckpt-every 4`` over 8
    steps, then the file of step 8 removed and ``--resume`` from step 4
    through a new ``main`` call (new state, new step functions): the final
    state equal to the uninterrupted run's to the bit."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = train_argv(seed, "--layers", str(TRAIN_RESUME_LAYERS),
                      "--ckpt-dir", d, "--ckpt-every", "4")
    finals = []

    def keep_last(i, state, metrics):
        if i == TRAIN_STEPS - 1:
            finals.append({n: x.clone() for n, x in tree_flatten(state)})
    try:
        t0 = time.perf_counter()
        full = tlaunch.main(argv, on_step=keep_last)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        files = sorted(os.listdir(d))
        check(files == ["step_00000004.npz", "step_00000008.npz"],
              f"resume run: checkpoint files {files}")
        file_gb = os.path.getsize(os.path.join(d, files[0])) / 1e9
        os.remove(os.path.join(d, files[1]))
        t0 = time.perf_counter()
        resumed = tlaunch.main(argv + ["--resume"], on_step=keep_last)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check([h["step"] for h in resumed] == [4, 5, 6, 7],
          f"resumed run logged steps {[h['step'] for h in resumed]}")
    a, b = finals
    differ = {n: (a[n].double() - b[n].double()).abs().max().item()
              for n in a if not torch.equal(a[n], b[n])}
    out = {"layers": TRAIN_RESUME_LAYERS, "checkpoint_gb": file_gb,
           "uninterrupted_s": full_s, "resumed_s": resumed_s,
           "losses_uninterrupted": [h["loss"] for h in full],
           "losses_resumed": [h["loss"] for h in resumed],
           "leaves": len(a), "leaves_differing": differ}
    print(f"training resume (full width, {TRAIN_RESUME_LAYERS} layers): "
          + json.dumps(out))
    check(not differ and resumed[-1]["loss"] == full[-1]["loss"],
          f"resumed run differs from the uninterrupted one: {differ}")
    del finals, a, b
    return out


def train_phase(torch, ops, ref, tfa, M, tlaunch, tstep, get_config, data,
                seed: int) -> tuple:
    """MiniCPM-2B at full width and depth, bf16, batch 4, sequence 2,048,
    through ``launch.train.main``: 8 plain steps, then 8 STRADS steps
    (U = 20 of 41 blocks, ``--weight-decay 0``), profiler windows over
    one plain and one STRADS step, the backward kernel at layer 0's
    inputs and other shapes, and the f32 parity and resume checks.  Returns
    (the bwd kernel's entry, the forward's training-shape entry, the
    numbers)."""
    from repro_torch.optim import tree_flatten
    from repro_torch.sched.block import BlockScheduleConfig
    cfg = get_config(TRAIN_ARCH)
    L = cfg.num_layers
    res = {"arch": cfg.name, "layers": L, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "params": M.num_params(cfg)}

    # 1. plain training
    box = {}
    hist, res["plain"] = train_run(
        torch, ops, tfa, tlaunch, train_argv(seed),
        lambda i, state, metrics: box.update(state=state), L)
    print("training plain: " + json.dumps(res["plain"]))
    state = box.pop("state")
    batch = data.make_batch(data.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=seed), TRAIN_STEPS, device=DEVICE)
    first = {}
    real = ops.attention

    def capture(q, k, v, **kw):
        if "qkv" not in first:
            first["qkv"] = (q.detach().clone(), k.detach().clone(),
                            v.detach().clone(), kw)
        return real(q, k, v, **kw)
    with patched(ops, attention=capture):
        (loss, _), grads = tstep.value_and_grad(cfg, state["params"], batch)
    flat = tree_flatten(grads)
    bad = [n for n, g in flat if g is None or not bool(torch.isfinite(g)
                                                       .all())]
    check(not bad, f"training: gradients not finite for {bad}")
    proj = {}
    for n in ("wq", "wk", "wv", "wo"):
        per_layer = grads["layers"]["attn0"][n].flatten(1).abs().amax(1)
        proj[n] = {"layers_nonzero": int((per_layer > 0).sum()),
                   "min_layer_max_abs": per_layer.min().item()}
        check(bool((per_layer > 0).all()), f"training: the {n} gradient is "
                                           f"0 in some layer: {proj[n]}")
    res["gradients"] = {"leaves": len(flat), "all_finite": True,
                        "attention_projections": proj,
                        "loss": float(loss)}
    del grads, flat, state
    torch.cuda.empty_cache()

    # 2. STRADS training (wd 0: an unscheduled layer keeps its bits)
    nblocks = L + 1
    U = nblocks // 2
    strads_check, sstats, prev = strads_checker(torch, tree_flatten, L, U,
                                                box)
    hist, res["strads"] = train_run(
        torch, ops, tfa, tlaunch, train_argv(seed, "--strads",
                                             "--weight-decay", "0"),
        strads_check, L)
    res["strads"].update(sstats, U=U, blocks=nblocks,
                         peak_memory_note="includes the check's copy of "
                                          "the parameters (bf16)")
    print("training STRADS: " + json.dumps(res["strads"]))
    prev.clear()

    # profiler windows over one plain and one STRADS step on the STRADS
    # run's state (a session slows the host's later launches: nothing
    # after this in the phase is timed on the host)
    state = box.pop("state")
    tc = tstep.TrainConfig()
    plain_step = tstep.make_train_step(cfg, tc, donate=True)
    sched = BlockScheduleConfig(nblocks, U, min(nblocks, 2 * U),
                                min_distance=1)
    strads_step = tstep.make_strads_train_step(cfg, tc, sched, donate=True)
    kernels = {"flash_attention": (ops.LAUNCHES, ("flash_fwd_bf16",)),
               "flash_attention_bwd": (ops.LAUNCHES,
                                       ("flash_bwd_dq_wgmma",))}
    plain_step(state, batch)                    # warm
    res["profile_plain_step"] = profile_window(
        torch, lambda: plain_step(state, batch), kernels, counts=True)
    res["profile_strads_step"] = profile_window(
        torch, lambda: strads_step(state, batch), kernels, counts=True)
    for w in ("profile_plain_step", "profile_strads_step"):
        wgmma_bwd_kernels(res[w], L, f"training {w}")
        print(f"training {w}: " + json.dumps(
            {k: v for k, v in res[w].items() if k != "top"}))
        for row in res[w]["top"][:8]:
            print(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} "
                  f"{row['name'][:90]}")
    del state, box
    torch.cuda.empty_cache()

    # 3. the backward kernel at layer 0's inputs and other shapes
    kentry, fentry = train_kernel_phase(torch, ops, ref, tfa, first["qkv"],
                                        seed)
    del first
    kentry["launches"] = res["plain"]["launches"]["flash_attention_bwd"]
    kentry["launches_strads"] = res["strads"]["launches"][
        "flash_attention_bwd"]
    kentry["bwd_route"] = kentry["checks"]["layer0"]["bwd_route"]
    kentry["ptxas"] = bwd_ptxas()
    print("flash_attention_bwd at layer 0's inputs: " + json.dumps(
        {k: v for k, v in kentry.items() if k != "checks"}))
    print("flash_attention_bwd checks: " + json.dumps(kentry["checks"]))
    torch.cuda.empty_cache()

    # 4. f32 parity, 5. resume
    res["f32_parity"] = train_f32_parity(torch, ops, ref, M, tstep,
                                         get_config, data, seed)
    torch.cuda.empty_cache()
    res["resume"] = train_resume(torch, tlaunch, tree_flatten, seed)
    torch.cuda.empty_cache()

    torch.cuda.empty_cache()
    return kentry, fentry, res


# ---------------------------------------------------------------------------
# The rest of the zoo: xLSTM-125M, InternVL2-1B, HuBERT-XLarge
# ---------------------------------------------------------------------------

XLSTM, VLM, AUDIO = "xlstm-125m", "internvl2-1b", "hubert-xlarge"
XLSTM_CUT_LAYERS = 4           # the f32 runs' depth (mLSTM 0-2, sLSTM 3)
XLSTM_PARITY_PROMPT = 512      # two mLSTM chunks; the CPU side takes ~3 s
SLSTM_TOL = 1e-4               # sLSTM forward vs plain (f32 both): |Δ| ≤
                               # SLSTM_TOL·max(1, max|plain|) of each output
SLSTM_BWD_TOL = 1e-3           # sLSTM backward vs plain (f32 both): |Δ| ≤
                               # SLSTM_BWD_TOL·max|plain| of each gradient
                               # (dg·W_rᵀ summed over 4d in another order,
                               # carried back over 2,048 steps)
SLSTM_CELL_FLOPS = (30, 60)    # a (b, t, unit)'s cell, forward and backward
                               # (the gates' adds, max, exps, tanh, σ, the
                               # state updates; under 1 % of the product's
                               # 2·4d at d = 768)
ZOO_STEPS = 6                  # InternVL2, HuBERT and xLSTM training steps
XLSTM_STEPS = ZOO_STEPS
AUDIO_FRAMES = 1500            # 30 s of audio at HuBERT's 50 Hz frames


def zoo_argv(arch: str, seed: int, steps: int, seq: int, *extra) -> list:
    return ["--arch", arch, "--preset", "full", "--batch", str(TRAIN_BATCH),
            "--seq", str(seq), "--steps", str(steps), "--log-every", "1",
            "--seed", str(seed), "--device", DEVICE, *extra]


def counted(fn, box: dict):
    """``fn`` that adds one to ``box["calls"]`` a call."""
    def wrapped(*args, **kw):
        box["calls"] += 1
        return fn(*args, **kw)
    return wrapped


def serve_build(torch, serve_lm, arch: str, seed: int, layers: int = 0):
    """``serve_lm.build`` at full width: batch 4, prompt 1,024, 32 tokens;
    ``layers`` cuts the depth (0: the config's own)."""
    sargs = serve_lm.parse_args([
        "--arch", arch, "--preset", "full", "--batch", str(BATCH),
        "--prompt-len", str(PROMPT), "--gen", str(GEN), "--seed", str(seed),
        "--layers", str(layers), "--device", DEVICE])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = serve_lm.build(sargs)
    torch.cuda.synchronize()
    return srv, {"arch": srv.cfg.name, "layers": srv.cfg.num_layers,
                 "batch": BATCH, "prompt": PROMPT, "gen": GEN,
                 "cache_len": srv.cache_len,
                 "weights_gb": torch.cuda.memory_allocated() / 1e9,
                 "init_s": time.perf_counter() - t0,
                 "init_peak_memory_gb":
                     torch.cuda.max_memory_allocated() / 1e9}


def checked_train_step(torch, ops, ref, tstep, cfg, params, batch,
                       layers: int) -> tuple:
    """One ``value_and_grad`` of a training step with every forward launch
    (the forward and the layer checkpoint's recompute) held against its
    plain version: 2 forward and 1 backward launch a layer, finite
    gradients.  Returns (the checks, layer 0's (q, k, v, kw))."""
    ops.reset_launch_counts()
    attn, _, stats, first = checked_ops(torch, ops, ref)
    with patched(ops, attention=attn):
        (loss, _), grads = tstep.value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    check(ops.LAUNCHES == attn_launches(2 * layers, layers),
          f"{cfg.name} checked training step: launches {ops.LAUNCHES}")
    st = stats["flash_attention"]
    check(st["calls"] == 2 * layers and st["max_rel_err"] <= ATTN_TOL,
          f"{cfg.name} training step: flash_attention vs plain {st}")
    from repro_torch.optim import tree_flatten
    bad = [n for n, g in tree_flatten(grads)
           if not bool(torch.isfinite(g).all())]
    check(not bad, f"{cfg.name} training step: gradients not finite: {bad}")
    del grads
    return {"every_launch_vs_plain": st, "loss": float(loss)}, \
        first["attention"]


def train_profile(torch, ops, tstep, cfg, state, batch, kernels,
                  counts: bool = False) -> dict:
    """A profiler window over one plain training step (warmed first)."""
    step = tstep.make_train_step(cfg, tstep.TrainConfig(), donate=True)
    step(state, batch)
    return profile_window(torch, lambda: step(state, batch), kernels,
                          counts=counts)


BWD_KERNELS = ("flash_bwd_prep", "flash_bwd_dkdv_wgmma",
               "flash_bwd_dq_wgmma", "flash_bwd_delta",
               "flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16")


def wgmma_bwd_kernels(window: dict, n: int, tag: str) -> dict:
    """The attention backward's kernels by name in a profiler window taken
    with ``counts``: the wgmma route's prep, dK/dV and dQ ``n`` times
    each, none of the mma.sync route's (its delta pass, its bf16 dK/dV
    and dQ kernels); the window keeps the device ms of the wgmma route's
    three kernels, summed over their ``n`` launches."""
    counts, counts_ms = window.pop("counts"), window.pop("counts_ms")
    bwd = {k: sum(c for name, c in counts.items() if k in name)
           for k in BWD_KERNELS}
    window["bwd_kernels_device_ms"] = {
        k: sum(d for name, d in counts_ms.items() if k in name)
        for k in BWD_KERNELS[:3]}
    want = {k: n if k in BWD_KERNELS[:3] else 0 for k in BWD_KERNELS}
    check(bwd == want, f"{tag}: the backward's kernels {bwd}, expected the "
                       f"wgmma route's {n} each and none of the mma.sync "
                       f"route's")
    window["bwd_kernels"] = bwd
    return bwd


def xlstm_parity(torch, M, get_config, data, seed: int) -> dict:
    """xLSTM-125M at full width in float32 with XLSTM_CUT_LAYERS layers
    (mLSTM 0-2, sLSTM 3) and a prompt of XLSTM_PARITY_PROMPT tokens: the
    prefill and first decode step on the card against the same model,
    weights and prompts on the CPU (the port's plain result).  Logits within LOGIT_TOL of the largest; a first
    token is decidable where the CPU's top-2 margin exceeds twice the two
    runs' prefill distance, and there the tokens must be equal, elsewhere
    the card's one of the CPU's top two."""
    import dataclasses
    from repro_torch.models import params as P
    cfg = dataclasses.replace(get_config(XLSTM),
                              num_layers=XLSTM_CUT_LAYERS, dtype="float32")
    prm_cpu = M.init_params(cfg, torch.Generator().manual_seed(seed))
    prm = P.tree_map(lambda _, t: t.to(DEVICE), prm_cpu)
    batch_cpu = data.make_batch(data.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=XLSTM_PARITY_PROMPT,
        batch_size=BATCH, seed=seed), 0)
    batch_cpu.pop("labels")
    batch = {k: v.to(DEVICE) for k, v in batch_cpu.items()}
    cache_len = XLSTM_PARITY_PROMPT + GEN
    with torch.inference_mode():
        lk, tk, dk = first_step(torch, M, cfg, prm, batch, cache_len)
        t0 = time.perf_counter()
        lc, tc, dc = first_step(torch, M, cfg, prm_cpu, batch_cpu,
                                cache_len, tk.cpu())
        cpu_s = time.perf_counter() - t0
    lk, tk, dk = lk.cpu(), tk.cpu(), dk.cpu()
    top2 = lc[:, :cfg.vocab_size].topk(2, -1)
    margins = (top2.values[:, 0] - top2.values[:, 1]).tolist()
    out = {"layers": XLSTM_CUT_LAYERS, "prompt": XLSTM_PARITY_PROMPT,
           "dtype": "float32",
           "slstm_layers": [i for i in cfg.slstm_layers
                            if i < cfg.num_layers],
           "cpu_seconds": cpu_s, "tolerance": f"{LOGIT_TOL} of max|logits|",
           "tokens": {"card": tk.tolist(), "cpu": tc.tolist()},
           "cpu_top2_margins": margins}
    for name, a, b in (("prefill", lk, lc), ("decode", dk, dc)):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        out[f"{name}_logits_max_abs_diff"] = err
        out[f"{name}_max_abs_logit"] = scale
        check(err <= LOGIT_TOL * scale, f"xLSTM f32 run: {name} logits "
                                        f"differ from the CPU's by {err}")
    decidable = [m > 2 * out["prefill_logits_max_abs_diff"]
                 for m in margins]
    out["decidable_rows"] = decidable
    print("xLSTM f32 parity (card vs CPU): " + json.dumps(out))
    check(all(bool(tk[i] == tc[i]) for i, d in enumerate(decidable) if d)
          and all(bool((top2.indices[i] == tk[i]).any())
                  for i, d in enumerate(decidable) if not d),
          f"xLSTM f32 run: first tokens {tk.tolist()} on the card, "
          f"{tc.tolist()} on the CPU, decidable rows {decidable}")
    check(sum(decidable) >= len(decidable) - 1,
          f"xLSTM f32 run: only {sum(decidable)} of {len(decidable)} first "
          f"tokens decidable in f32")
    del prm, prm_cpu
    return out


def slstm_share(torch, cfg, params, seed: int, step_ms: float) -> dict:
    """The sLSTM layers' share of a training step: one sLSTM layer's work
    in a step (its checkpointed forward, the recompute and the backward,
    as the step runs it: two forward launches of the kernel and one
    backward) at the step's shapes and weights, timed on the host clock
    to a sync, the median of 3 (the training run before it warmed the
    same code and shapes), times the number of sLSTM layers, over the
    step's ms."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import params as P
    from repro_torch.models import transformer as T
    i = cfg.slstm_layers[0]
    p = P.tree_map(lambda _, t: t.detach().requires_grad_(),
                   params["layers"][f"layer_{i:02d}"])
    leaves = list(P.leaves(p))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x, g = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                        device=DEVICE).to(torch.bfloat16) for _ in range(2))
    x.requires_grad_()
    ctx = {"positions": None, "kpos": None, "slot": None, "window": None,
           "cache": None}
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = checkpoint(T._apply_sub, "slstm", p, x, cfg, ctx,
                          use_reentrant=False)
        torch.autograd.grad(y, [x] + leaves, g)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    ms = median(runs)
    n = len(cfg.slstm_layers)
    return {"slstm_layers": n, "layer_fwd_bwd_ms": ms,
            "layer_fwd_bwd_ms_runs": runs, "slstm_ms_a_step": n * ms,
            "step_ms": step_ms, "share": n * ms / step_ms}


class slstm_capture:
    """``ops.slstm_scan`` swapped for the length of a ``with`` block for a
    wrapper that keeps detached copies of its first call's (gx, wr, bias,
    state) in ``first``; and ``xlstm._slstm_cell`` for one that counts
    its calls in ``cells`` (the card's route never reaches it)."""

    def __init__(self, torch, ops, TX):
        self.first, self.cells = None, {"calls": 0}
        real = ops.slstm_scan

        def scan(gx, wr, bias, state=None):
            if self.first is None:
                with torch.inference_mode(False):   # plain tensors
                    self.first = tuple(t.detach().clone()
                                       for t in (gx, wr, bias)) + (
                        None if state is None else tuple(
                            t.detach().float().clone() for t in state),)
            return real(gx, wr, bias, state)
        self._swaps = (patched(ops, slstm_scan=scan),
                       patched(TX, _slstm_cell=counted(TX._slstm_cell,
                                                       self.cells)))

    def __enter__(self):
        for sw in self._swaps:
            sw.__enter__()
        return self

    def __exit__(self, *exc):
        for sw in self._swaps:
            sw.__exit__(*exc)


def slstm_bounds(B: int, S: int, d: int, save: bool, state: bool) -> tuple:
    """(the forward's bound, the backward's): the product h·W_r (and
    dg·W_rᵀ) at 2·4d operations a (b, t, unit) plus the cell's
    (SLSTM_CELL_FLOPS) at 67 TFLOP/s in f32, against each input read once
    and each output written once (gx, W_r, bias, the states, hs, and
    with ``save`` the pre-activations and states the backward reads;
    the backward reads those, dhs and W_r and writes dG)."""
    f = 4
    fwd_bytes = f * (B * S * 4 * d + d * 4 * d + 4 * d + B * S * d
                     + 4 * B * d * (2 if state else 1)
                     + (B * S * 7 * d if save else 0))
    bwd_bytes = f * (d * 4 * d + B * S * 7 * d + B * S * d + B * S * 4 * d
                     + (8 * B * d if state else 0))
    units = B * S * d
    return (bound(fwd_bytes, units * (8 * d + SLSTM_CELL_FLOPS[0])),
            bound(bwd_bytes, units * (8 * d + SLSTM_CELL_FLOPS[1])))


def slstm_kernel_phase(torch, ops, ref, tsl, args, prefill_args,
                       seed: int) -> tuple:
    """The sLSTM kernels at layer 3's real inputs of a training step
    (``args``: gx (4, 2,048, 3,072), no state) and of a serving prefill
    (``prefill_args``: 4 × 1,024 from the serving cache's state; the
    backward there with the initial state's gradients) against
    their plain versions in f32: forward (hs, the final state and what
    the backward reads, each within SLSTM_TOL) and backward (dhs drawn
    from a seed; dG and dW_r, dbias from it within SLSTM_BWD_TOL), each
    twice to the bit; timed eager (CUDA events) and as device time (the
    cooperative launch captured in a CUDA graph), beside the plain
    versions, the bounds and the exchange floor (the same grid through
    its S − 1 exchanges of tagged words alone).  Returns (the forward's
    entry, the backward's)."""
    gx, wr, bias, state = args
    B, S, d4 = gx.shape
    d = d4 // 4
    check(state is None, f"slstm_scan in training: a state {state}")
    hs, fin, saved = tsl.slstm_scan(gx, wr, bias, None, save=True)
    hs2, fin2, saved2 = tsl.slstm_scan(gx, wr, bias, None, save=True)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(
        (hs,) + fin + saved, (hs2,) + fin2 + saved2)),
        "slstm_scan: two calls differ")
    del hs2, fin2, saved2
    hr, fr, sr = ref.slstm_scan_ref(gx, wr, bias, None, save=True)
    ferr = {}
    for name, a, b in zip(("hs", "c", "n", "m", "h", "G", "C", "N", "M"),
                          (hs,) + fin + saved, (hr,) + fr + sr):
        top = max(1.0, b.abs().max().item())
        ferr[name] = {"max_abs_err": (a - b).abs().max().item(),
                      "scale": top}
        check(ferr[name]["max_abs_err"] <= SLSTM_TOL * top,
              f"slstm_scan vs plain at layer 3's inputs: {name} {ferr}")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    dhs = torch.randn(hs.shape, generator=gen, device=DEVICE)
    bwd = lambda: tsl.slstm_scan_bwd(wr, None, saved, dhs, None,
                                     want_dstate=False)
    dG, _ = bwd()
    dG2, _ = bwd()
    torch.cuda.synchronize()
    check(torch.equal(dG, dG2), "slstm_scan_bwd: two calls differ")
    del dG2
    t0 = time.perf_counter()
    dGr, _ = ref.slstm_scan_bwd_ref(wr, None, sr, dhs)
    torch.cuda.synchronize()
    plain_bwd_ms = (time.perf_counter() - t0) * 1e3
    berr = {}
    for name, a, b in zip(("dG", "dwr", "dbias"),
                          (dG,) + ref.slstm_param_grads(dG, hs, None),
                          (dGr,) + ref.slstm_param_grads(dGr, hr, None)):
        top = b.abs().max().item()
        berr[name] = {"max_abs_err": (a - b).abs().max().item(),
                      "max_abs": top}
        check(berr[name]["max_abs_err"] <= SLSTM_BWD_TOL * top,
              f"slstm_scan_bwd vs plain at layer 3's inputs: {berr}")
    del hr, fr, sr, dGr
    (fb_ms, fb_by), (bb_ms, bb_by) = slstm_bounds(B, S, d, True, False)
    fwd_save = lambda: tsl.slstm_scan(gx, wr, bias, None, save=True)
    floor = lambda: tsl.barriers(B, S, d, gx.device)
    plan = tsl.plan(B, d)
    fwd = {"max_abs_err": max(v["max_abs_err"] for v in ferr.values()),
           "errors": ferr, "tolerance": f"{SLSTM_TOL} of max(1, max|plain|)"
                                        f" of each output (f32 both)",
           "ms": time_ms(torch, fwd_save, iters=5, warmup=1),
           "device_ms": graph_ms(torch, fwd_save, calls=2, replays=3),
           "plain_ms": time_ms(torch, lambda: ref.slstm_scan_ref(
               gx, wr, bias, None, save=True), iters=1, warmup=0),
           "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None,
           "library": "none: no one PyTorch call computes an sLSTM with "
                      "exponential gating",
           "exchange_floor_ms": time_ms(torch, floor, iters=5, warmup=1),
           "exchange_floor_device_ms": graph_ms(torch, floor, calls=2,
                                                replays=3),
           "same_bits_twice": True, "plan": plan,
           "shape": {"gx": [B, S, d4], "state": None, "save": True}}
    fwd["device_bound_share"] = fb_ms / fwd["device_ms"]
    fwd["exchange_floor_share"] = (fwd["exchange_floor_device_ms"]
                                   / fwd["device_ms"])
    bwd_entry = {
        "max_abs_err": max(v["max_abs_err"] for v in berr.values()),
        "errors": berr, "tolerance": f"{SLSTM_BWD_TOL} of each gradient's "
                                     f"max|plain| (f32 both)",
        "ms": time_ms(torch, bwd, iters=5, warmup=1),
        "device_ms": graph_ms(torch, bwd, calls=2, replays=3),
        "plain_ms": plain_bwd_ms, "bound_ms": bb_ms, "bound_by": bb_by,
        "library_ms": None,
        "library": "none: no one PyTorch call computes an sLSTM with "
                   "exponential gating",
        "exchange_floor_device_ms": fwd["exchange_floor_device_ms"],
        "same_bits_twice": True, "plan": plan,
        "shape": {"dhs": [B, S, d], "saved_gb": sum(
            t.numel() for t in saved) * 4 / 1e9}}
    bwd_entry["device_bound_share"] = bb_ms / bwd_entry["device_ms"]
    bwd_entry["exchange_floor_share"] = (fwd["exchange_floor_device_ms"]
                                         / bwd_entry["device_ms"])
    del saved, dhs, dG, hs
    torch.cuda.empty_cache()

    # the serving prefill's call (4 × 1,024 from the cache's state,
    # no saving) and a decode step's (S = 1 from the prefill's state)
    gx, wr, bias, state = prefill_args
    Bp, Sp, _ = gx.shape
    hs, fin = tsl.slstm_scan(gx, wr, bias, state)
    hr, fr = ref.slstm_scan_ref(gx, wr, bias, state)
    perr = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip((hs,) + fin, (hr,) + fr))
    check(perr <= SLSTM_TOL, f"slstm_scan at the prefill's inputs: {perr}")
    (pb_ms, pb_by), _ = slstm_bounds(Bp, Sp, d, False, True)
    run = lambda: tsl.slstm_scan(gx, wr, bias, state)
    prefill = {"shape": [Bp, Sp, d4], "max_rel_err": perr,
               "device_ms": graph_ms(torch, run, calls=2, replays=3),
               "ms": time_ms(torch, run, iters=5, warmup=1),
               "plain_ms": time_ms(torch, lambda: ref.slstm_scan_ref(
                   gx, wr, bias, state), iters=1, warmup=0),
               "bound_ms": pb_ms, "bound_by": pb_by,
               "exchange_floor_device_ms": graph_ms(
                   torch, lambda: tsl.barriers(Bp, Sp, d, gx.device),
                   calls=2, replays=3)}
    # the backward at the prefill's shape from the same state (zeros but
    # m = −1e30, so every first step has fa = 0 and ties max(n, 1) at
    # n = 1): the initial state's gradients against the plain sweep too
    check(state is not None, "sLSTM prefill: no state from the cache")
    _, finp, savedp = tsl.slstm_scan(gx, wr, bias, state, save=True)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 17)
    dhp = torch.randn(hs.shape, generator=gen, device=DEVICE)
    dfp = tuple(torch.randn(t.shape, generator=gen, device=DEVICE)
                for t in finp)
    bwdp = lambda: tsl.slstm_scan_bwd(wr, state, savedp, dhp, dfp)
    dGp, dsp = bwdp()
    _, _, srp = ref.slstm_scan_ref(gx, wr, bias, state, save=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dGpr, dspr = ref.slstm_scan_bwd_ref(wr, state, srp, dhp, dfp)
    torch.cuda.synchronize()
    plain_bwdp_ms = (time.perf_counter() - t0) * 1e3
    pberr = slstm_grad_errors(("dG", "dc0", "dn0", "dm0", "dh0"),
                              (dGp,) + tuple(dsp), (dGpr,) + tuple(dspr),
                              "slstm_scan_bwd at the prefill's inputs")
    _, (pbb_ms, pbb_by) = slstm_bounds(Bp, Sp, d, True, True)
    bwd_prefill = {"shape": [Bp, Sp, d], "errors": pberr,
                   "max_abs_err": max(v["max_abs_err"]
                                      for v in pberr.values()),
                   "ms": time_ms(torch, bwdp, iters=5, warmup=1),
                   "device_ms": graph_ms(torch, bwdp, calls=2, replays=3),
                   "plain_ms": plain_bwdp_ms, "bound_ms": pbb_ms,
                   "bound_by": pbb_by,
                   "exchange_floor_device_ms":
                       prefill["exchange_floor_device_ms"]}
    del savedp, dhp, dfp, dGp, dsp, srp, dGpr, dspr
    bwd_entry["by_shape"] = {"prefill": bwd_prefill}

    one = gx[:, :1].contiguous()
    step = lambda: tsl.slstm_scan(one, wr, bias, fin)
    hr1, fr1 = ref.slstm_scan_ref(one, wr, bias, fin)
    h1, f1 = step()
    derr = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip((h1,) + f1, (hr1,) + fr1))
    check(derr <= SLSTM_TOL, f"slstm_scan at a decode step: {derr}")
    (db_ms, db_by), _ = slstm_bounds(Bp, 1, d, False, True)
    decode = {"shape": [Bp, 1, d4], "max_rel_err": derr,
              "device_ms": graph_ms(torch, step),
              "ms": time_ms(torch, step),
              "plain_ms": time_ms(torch, lambda: ref.slstm_scan_ref(
                  one, wr, bias, fin), iters=50),
              "bound_ms": db_ms, "bound_by": db_by}
    fwd["by_shape"] = {"prefill": prefill, "decode": decode}
    fwd["cases"] = slstm_edge_checks(torch, ref, tsl, wr, seed)
    return fwd, bwd_entry


def slstm_grad_errors(names, got, want, what: str) -> dict:
    """|got − want| of each gradient against SLSTM_BWD_TOL of its
    max|plain|; fails the run past it."""
    out = {}
    for name, a, b in zip(names, got, want):
        top = b.abs().max().item()
        out[name] = {"max_abs_err": (a - b).abs().max().item(),
                     "max_abs": top}
        check(out[name]["max_abs_err"] <= SLSTM_BWD_TOL * max(top, 1e-30),
              f"{what}: {name} {out[name]}")
    return out


def slstm_edge_checks(torch, ref, tsl, wr_real, seed: int) -> dict:
    """The sLSTM kernels against their plain versions, forward (each
    output within SLSTM_TOL) and backward (dG and the initial state's
    dc, dn, dm, dh within SLSTM_BWD_TOL, each twice to the bit), at
    d = 768 where the gradient's path through the stabiliser shows and
    where B runs as several chunks of one launch:

    - ``zero_state``: a state of zeros (m = 0, n = 0), i lowered by 3,
      so n_t < 1 and max(n, 1) clamps: h depends on m and dm is real;
    - ``m_tie``: W_r = 0 and bias = 0, the first step ties
      max(logσ(f) + m, i) (f = 100, i = m = 0.5) and max(n, 1) (n = 0);
    - ``batch_16`` and ``batch_48``, from a state with n ≥ 1, and
      ``chunks_72``, which runs the forward and the backward in 2 chunks
      of rows each (the ring's tags run on across the chunks).
    """
    d = wr_real.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 19)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=DEVICE)
    out = {}
    for name, B, S in (("zero_state", 4, 64), ("m_tie", 4, 64),
                       ("batch_16", 16, 64), ("batch_48", 48, 40),
                       ("chunks_72", 72, 40)):
        gx, bias = rnd(B, S, 4 * d), rnd(4 * d) * 0.5
        wr = wr_real.clone()
        state = (rnd(B, d), rnd(B, d).abs() + 1, rnd(B, d), rnd(B, d))
        if name == "zero_state":
            state = tuple(torch.zeros_like(t) for t in state)
            gx[:, :, d:2 * d] -= 3.0
        elif name == "m_tie":
            wr.zero_()
            bias.zero_()
            state = (state[0], torch.zeros_like(state[1]),
                     torch.full_like(state[2], 0.5), state[3])
            gx[:, 0, d:2 * d] = 0.5
            gx[:, 0, 2 * d:3 * d] = 100.0
        hs, fin, saved = tsl.slstm_scan(gx, wr, bias, state, save=True)
        hr, fr, sr = ref.slstm_scan_ref(gx, wr, bias, state, save=True)
        ferr = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                   for a, b in zip((hs,) + fin + saved, (hr,) + fr + sr))
        check(ferr <= SLSTM_TOL, f"slstm_scan, case {name}: {ferr}")
        dhs = rnd(B, S, d)
        dfin = tuple(rnd(B, d) for _ in range(4))
        dG, dst = tsl.slstm_scan_bwd(wr, state, saved, dhs, dfin)
        dG2, dst2 = tsl.slstm_scan_bwd(wr, state, saved, dhs, dfin)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((dG,) + dst,
                                                    (dG2,) + dst2)),
              f"slstm_scan_bwd, case {name}: two calls differ")
        dGr, dsr = ref.slstm_scan_bwd_ref(wr, state, sr, dhs, dfin)
        berr = slstm_grad_errors(("dG", "dc0", "dn0", "dm0", "dh0"),
                                 (dG,) + tuple(dst), (dGr,) + tuple(dsr),
                                 f"slstm_scan_bwd, case {name}")
        plan = tsl.plan(B, d, backward=True)
        out[name] = {"B": B, "S": S, "fwd_max_rel_err": ferr,
                     "bwd_errors": berr,
                     "chunks_fwd": plan["chunks_fwd"],
                     "chunks_bwd": plan["chunks_bwd"]}
    check(out["chunks_72"]["chunks_fwd"] > 1
          and out["chunks_72"]["chunks_bwd"] > 1,
          f"sLSTM edge cases: the chunked case ran in one chunk {out}")
    return out


def xlstm_phase(torch, ops, ref, tfa, M, serve_lm, tlaunch, tstep,
                get_config, data, seed: int) -> tuple:
    """xLSTM-125M at full width and depth (12 layers, sLSTM at 3 and 9),
    bf16: serving (batch 4, prompt 1,024, 32 tokens) and training (batch
    4 × 2,048: XLSTM_STEPS plain steps and XLSTM_STEPS ``--strads
    --weight-decay 0`` steps) through the entry points, every sLSTM call
    one launch of the sLSTM kernel and none of ``_slstm_cell``: 2 a
    prefill, 2 a decode step, 4 forward and 2 backward a training step.
    Also the f32 parity run, the kernels at layer 3's real inputs
    against their plain versions with the exchange floor
    (``slstm_kernel_phase``), a 4-layer f32 training step against the
    plain versions, the sLSTM layers' share of a step and a profiler
    window over a full-depth step.  Returns (the forward kernel's entry,
    the backward's, the numbers)."""
    from repro_torch.kernels import slstm_scan as tsl
    from repro_torch.models import xlstm as TX
    from repro_torch.optim import tree_flatten
    srv, res = serve_build(torch, serve_lm, XLSTM, seed)
    cfg = srv.cfg
    L, n_sl = cfg.num_layers, len(cfg.slstm_layers)
    res["params"] = M.num_params(cfg)
    with torch.inference_mode(), slstm_capture(torch, ops, TX) as cap:
        first_step(torch, M, cfg, srv.params, srv.batch, srv.cache_len)
        toks, numbers = main_path(torch, ops, M, srv, launch_counts(
            slstm_scan=n_sl * (1 + GEN)))
        res.update(numbers)
        window = profile_serving(torch, ops, M, srv)
    check(cap.cells["calls"] == 0, f"xLSTM serving: {cap.cells['calls']} "
                                   f"calls of _slstm_cell on the card")
    prefill_args = cap.first
    res.update(window)
    print("xLSTM serving: " + json.dumps(
        {k: v for k, v in res.items() if not k.startswith("profile")}))
    print_profile("xLSTM serving profile_prefill", window["profile_prefill"])
    del srv, window
    torch.cuda.empty_cache()
    out = {"serve": res}
    out["f32_parity"] = xlstm_parity(torch, M, get_config, data, seed)
    torch.cuda.empty_cache()

    per_step = family_per_step(cfg, L, scan=False)
    box = {}
    with slstm_capture(torch, ops, TX) as cap:
        _, out["plain"] = train_run(
            torch, ops, tfa, tlaunch, zoo_argv(XLSTM, seed, XLSTM_STEPS,
                                               TRAIN_SEQ),
            lambda i, state, metrics: box.update(state=state), L,
            steps=XLSTM_STEPS, per_step=per_step)
    check(cap.cells["calls"] == 0, f"xLSTM training: {cap.cells['calls']} "
                                   f"calls of _slstm_cell on the card")
    out["launches_a_step"] = per_step
    print("xLSTM training plain: " + json.dumps(out["plain"]))
    state = box.pop("state")
    out["slstm_share"] = slstm_share(torch, cfg, state["params"], seed,
                                     out["plain"]["step_ms_median_from_2"])
    print("xLSTM sLSTM layers' share of a step: " + json.dumps(
        out["slstm_share"]))
    fentry, bentry = slstm_kernel_phase(torch, ops, ref, tsl, cap.first,
                                        prefill_args, seed)
    del cap, prefill_args
    print("slstm_scan at layer 3's inputs: " + json.dumps(fentry))
    print("slstm_scan_bwd at layer 3's inputs: " + json.dumps(bentry))
    del state
    torch.cuda.empty_cache()

    # STRADS at full depth, weight decay 0: a block the mask left out keeps
    # its bits (layer XX is block XX, the rest block L)
    prev, sstats = {}, {"blocks_active": [], "unscheduled_checked": 0}

    def strads_check(i, state, metrics):
        params = tree_flatten(state["params"])
        mapping, nb = tstep.layer_blocks(cfg, state["params"])
        if metrics is not None:
            mask = metrics["mask"] > 0
            moved = torch.zeros(nb, dtype=torch.bool, device=DEVICE)
            for n, x in params:
                if not torch.equal(x, prev[n]):
                    moved[mapping[n]] = True
            check(not bool((moved & ~mask).any()),
                  f"xLSTM STRADS step {i}: unscheduled blocks "
                  f"{(moved & ~mask).nonzero().flatten().tolist()} moved")
            sstats["blocks_active"].append(int(mask.sum()))
            sstats["unscheduled_checked"] += int((~mask).sum())
        box["state"] = state
        prev.clear()
        prev.update({n: x.clone() for n, x in params})
    _, out["strads"] = train_run(
        torch, ops, tfa, tlaunch, zoo_argv(
            XLSTM, seed, XLSTM_STEPS, TRAIN_SEQ, "--strads",
            "--weight-decay", "0"),
        strads_check, L, steps=XLSTM_STEPS, per_step=per_step)
    check(len(sstats["blocks_active"]) == XLSTM_STEPS,
          f"xLSTM STRADS: {len(sstats['blocks_active'])} steps checked")
    out["strads"].update(sstats, layers=L, blocks=L + 1)
    print("xLSTM training STRADS: " + json.dumps(out["strads"]))
    prev.clear()
    state = box.pop("state")
    batch = data_batch(cfg, TRAIN_SEQ, XLSTM_STEPS, seed)
    out["profile_train_step"] = train_profile(
        torch, ops, tstep, cfg, state, batch,
        {"slstm_scan": (ops.LAUNCHES, ("slstm_fwd",)),
         "slstm_scan_bwd": (ops.LAUNCHES, ("slstm_bwd",))})
    out["profile_train_step"]["layers"] = L
    print_profile("xLSTM training profile_train_step",
                  out["profile_train_step"])
    del state, box, batch
    torch.cuda.empty_cache()

    # 4 layers in f32, weights scaled by 0.1: the kernels against
    # ops.slstm_scan_plain (the plain forward and reverse sweep)
    out["f32_step"] = family_f32_step(
        torch, ops, ref, M, tstep, tree_flatten, get_config, data, XLSTM,
        XLSTM_CUT_LAYERS, TRAIN_SEQ, {"slstm_scan": ops.slstm_scan_plain})
    print("xLSTM f32 step (4 layers, full width): " + json.dumps(
        {k: v for k, v in out["f32_step"].items() if k != "grad_rel"}))
    torch.cuda.empty_cache()
    for entry, name in ((fentry, "slstm_scan"), (bentry, "slstm_scan_bwd")):
        entry["launches"] = out["plain"]["launches"][name]
        entry["launches_strads"] = out["strads"]["launches"][name]
        entry["launches_f32_step"] = out["f32_step"]["launches"][name]
    fentry["launches_serving"] = res["launches"]["slstm_scan"]
    ptx = family_ptxas("slstm_scan", ("slstm_",), ("slstm_fwd", "slstm_bwd"))
    fentry["ptxas"] = {k: v for k, v in ptx.items() if k != "slstm_bwd"}
    bentry["ptxas"] = {"slstm_bwd": ptx["slstm_bwd"]}
    return fentry, bentry, out


def attn_kernels(ops):
    return {"flash_attention": (ops.LAUNCHES, ("flash_fwd_bf16",
                                               "flash_fwd_f32")),
            "flash_attention_bwd": (ops.LAUNCHES, ("flash_bwd_dq",))}


def zoo_train_phase(torch, ops, ref, tfa, M, tlaunch, tstep, layers_mod,
                    cfg, seed: int, seq: int, layers: int = 0,
                    strads: bool = False) -> dict:
    """InternVL2-1B, HuBERT-XLarge or a dense arch at full width, bf16,
    batch 4 × ``seq`` (InternVL2: 2,048 tokens after 256 patch
    embeddings, 2,304 queries; HuBERT: 1,500 frames) through
    ``launch.train.main`` (ZOO_STEPS plain steps; with ``strads`` then
    ZOO_STEPS ``--strads --weight-decay 0`` steps, U = half the L + 1
    blocks, every unscheduled block keeping its bits), at ``cfg``'s depth
    (``layers``: the ``--layers`` cut it was made with, 0 for none), with
    ``_chunked_attention`` counted (none may run on the card); then a
    checked training step, the backward kernel at layer 0's inputs (the
    wgmma route) and timed, and a profiler window over one step holding
    L launches of each wgmma-route kernel and none of the mma.sync
    route's.  Returns (the numbers, the backward's entry, the forward's
    training-shape entry)."""
    from repro_torch.optim import tree_flatten
    L = cfg.num_layers
    chunked = {"calls": 0}
    box = {}
    cut = ("--layers", str(layers)) if layers else ()
    argv = lambda *extra: zoo_argv(cfg.name, seed, ZOO_STEPS, seq, *cut,
                                   *extra)
    with patched(layers_mod, _chunked_attention=counted(
            layers_mod._chunked_attention, chunked)):
        _, res = train_run(
            torch, ops, tfa, tlaunch, argv(),
            lambda i, state, metrics: box.update(state=state), L,
            steps=ZOO_STEPS, tokens=TRAIN_BATCH * seq)
        print(f"{cfg.name} training: " + json.dumps(res))
        if strads:
            box.clear()
            torch.cuda.empty_cache()
            U = (L + 1) // 2
            strads_check, sstats, prev = strads_checker(
                torch, tree_flatten, L, U, box)
            _, res["strads"] = train_run(
                torch, ops, tfa, tlaunch, argv("--strads", "--weight-decay",
                                               "0"),
                strads_check, L, steps=ZOO_STEPS, tokens=TRAIN_BATCH * seq)
            check(len(sstats["blocks_active"]) == ZOO_STEPS,
                  f"{cfg.name} STRADS: {len(sstats['blocks_active'])} "
                  f"steps checked")
            res["strads"].update(sstats, U=U, blocks=L + 1,
                                 peak_memory_note="includes the check's "
                                                  "copy of the parameters "
                                                  "(bf16)")
            print(f"{cfg.name} training STRADS: " + json.dumps(
                res["strads"]))
            prev.clear()
        state = box.pop("state")
        batch = data_batch(cfg, seq, ZOO_STEPS, seed)
        res["checked_step"], first = checked_train_step(
            torch, ops, ref, tstep, cfg, state["params"], batch, L)
    check(chunked["calls"] == 0, f"{cfg.name}: _chunked_attention ran "
                                 f"{chunked['calls']} times on the card")
    res["chunked_attention_calls"] = 0
    q, k, v, kw = first
    res["queries"] = q.shape[1]
    res["bwd_layer0"] = bwd_check(torch, ref, tfa, q, k, v, kw, seed,
                                  "wgmma")
    bentry, fentry = bwd_timing(torch, ref, tfa, q, k, v, kw, seed)
    bentry["max_abs_err"] = max(res["bwd_layer0"][f"d{x}_max_abs_err"]
                                for x in "qkv")
    bentry["bwd_route"] = "wgmma"
    fentry["max_rel_err"] = res["bwd_layer0"]["forward_max_abs_err"]
    del first, q, k, v
    res["profile_train_step"] = train_profile(
        torch, ops, tstep, cfg, state, batch, attn_kernels(ops), counts=True)
    wgmma_bwd_kernels(res["profile_train_step"], L,
                      f"{cfg.name} training profile")
    print(f"{cfg.name} training profile: " + json.dumps(
        {k: v for k, v in res["profile_train_step"].items() if k != "top"}))
    for row in res["profile_train_step"]["top"][:8]:
        print(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} "
              f"{row['name'][:90]}")
    del state, box, batch
    torch.cuda.empty_cache()
    return res, bentry, fentry


def data_batch(cfg, seq: int, step: int, seed: int) -> dict:
    """The trainer's batch of ``step`` for ``cfg``, its frontend's inputs
    included."""
    from repro_torch import data
    return data.make_batch(data.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=TRAIN_BATCH,
        seed=seed), step, device=DEVICE, **data.frontend_batch_kwargs(cfg))


def vlm_phase(torch, ops, ref, tfa, M, serve_lm, tlaunch, tstep, layers_mod,
              seed: int) -> tuple:
    """InternVL2-1B at full width and depth (24 layers, 16 padded query
    heads over 2 kv heads of 64), bf16: serving 256 patch embeddings + a
    1,024-token prompt (1,280 queries) with every prefill launch checked,
    the kernel timed at layer 0's inputs with SDPA, the main path's
    counts (24 flash_attention), profiler windows; then training (2,304
    queries a sequence: above the CPU's chunked threshold, on the flash
    kernel on the card).  Returns (the numbers, the flash_attention
    entries by shape, the backward's entry)."""
    srv, res = serve_build(torch, serve_lm, VLM, seed)
    cfg = srv.cfg
    L = cfg.num_layers
    res["params"] = M.num_params(cfg)
    res["frontend_tokens"] = cfg.frontend_tokens
    with torch.inference_mode():
        attn, _, stats, first = checked_ops(torch, ops, ref)
        with patched(ops, attention=attn):
            first_step(torch, M, cfg, srv.params, srv.batch, srv.cache_len)
        torch.cuda.synchronize()
        st = stats["flash_attention"]
        check(st["calls"] == L and st["max_rel_err"] <= ATTN_TOL,
              f"{cfg.name} prefill: flash_attention vs plain {st}")
        res["every_launch_vs_plain"] = st
        q, k, v, kw = first["attention"]
        check(q.shape[1] == PROMPT + cfg.frontend_tokens,
              f"{cfg.name}: attention over {q.shape[1]} queries")
        serve_attn = attention_timing(torch, ops, ref, q, k, v, kw)
        del first, q, k, v
        toks, numbers = main_path(torch, ops, M, srv, attn_launches(L))
        res.update(numbers)
        window = profile_serving(torch, ops, M, srv)
    res.update(window)
    print(f"{cfg.name} serving: " + json.dumps(
        {k: v for k, v in res.items() if not k.startswith("profile")}))
    for w in ("profile_prefill", "profile_decode4"):
        print(f"{cfg.name} {w}: " + json.dumps(
            {k: v for k, v in res[w].items() if k != "top"}))
    del srv, window
    torch.cuda.empty_cache()
    train, bentry, fentry = zoo_train_phase(
        torch, ops, ref, tfa, M, tlaunch, tstep, layers_mod, cfg, seed,
        TRAIN_SEQ)
    check(train["queries"] == TRAIN_SEQ + cfg.frontend_tokens,
          f"{cfg.name} training: attention over {train['queries']} queries")
    return ({"serve": res, "train": train},
            {f"{VLM} serving": serve_attn, f"{VLM} training": fentry},
            bentry)


def audio_phase(torch, ops, ref, tfa, M, tlaunch, tstep, get_config, data,
                layers_mod, seed: int) -> tuple:
    """HuBERT-XLarge at full width and depth (48 layers, 16 heads of 80,
    bidirectional), bf16: ``encode_step`` of 4 × 1,500 frames with every
    launch checked, the kernel timed at layer 0's inputs (non-causal,
    with SDPA), 3 timed encodes (48 launches each), the plain attention's
    logits beside the kernels' (printed), a profiler window; then
    training on the wgmma backward route (head dim 80).  Returns (the
    numbers, the flash_attention entries by shape, the backward's
    entry)."""
    cfg = get_config(AUDIO)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prm = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    batch = data_batch(cfg, AUDIO_FRAMES, 0, seed)
    batch.pop("labels")
    torch.cuda.synchronize()
    res = {"arch": cfg.name, "layers": L, "batch": BATCH,
           "frames": AUDIO_FRAMES, "params": M.num_params(cfg),
           "init_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9}
    encode = lambda: M.encode_step(cfg, prm, batch)[0]
    with torch.inference_mode():
        attn, _, stats, first = checked_ops(torch, ops, ref)
        with patched(ops, attention=attn):
            encode()
        torch.cuda.synchronize()
        st = stats["flash_attention"]
        check(st["calls"] == L and st["max_rel_err"] <= ATTN_TOL,
              f"{cfg.name} encode: flash_attention vs plain {st}")
        res["every_launch_vs_plain"] = st
        q, k, v, kw = first["attention"]
        check(not kw["causal"] and q.shape[1:] == (AUDIO_FRAMES, 16, 80),
              f"{cfg.name}: attention {tuple(q.shape)} {kw}")
        encode_attn = attention_timing(torch, ops, ref, q, k, v, kw)
        del first, q, k, v
        encode()
        ops.reset_launch_counts()
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lk = encode()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        check(ops.LAUNCHES == attn_launches(3 * L),
              f"{cfg.name} encode: launches {ops.LAUNCHES}")
        check(lk.shape == (BATCH, AUDIO_FRAMES, 2048)
              and bool(torch.isfinite(lk).all()),
              f"{cfg.name} encode: logits {tuple(lk.shape)} not finite")
        res.update(encode_ms=ms, encode_ms_median=median(ms),
                   frames_per_s=BATCH * AUDIO_FRAMES / (median(ms) / 1e3),
                   launches=attn_launches(L),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        with patched(ops, attention=ref.attention_ref):
            lp = encode()
        res["kernels_vs_plain_bf16"] = {
            "logits_max_abs_diff": (lk.float() - lp.float()).abs().max()
            .item(), "max_abs_logit": lp.float().abs().max().item(),
            "argmax_equal_share": (lk.argmax(-1) == lp.argmax(-1)).float()
            .mean().item()}
        del lk, lp
        res["profile_encode"] = profile_window(torch, encode,
                                               attn_kernels(ops))
    print(f"{cfg.name} encode: " + json.dumps(
        {k: v for k, v in res.items() if not k.startswith("profile")}))
    print(f"{cfg.name} profile_encode: " + json.dumps(
        {k: v for k, v in res["profile_encode"].items() if k != "top"}))
    del prm, batch
    torch.cuda.empty_cache()
    train, bentry, fentry = zoo_train_phase(
        torch, ops, ref, tfa, M, tlaunch, tstep, layers_mod, cfg, seed,
        AUDIO_FRAMES)
    return ({"encode": res, "train": train},
            {f"{AUDIO} encode": encode_attn, f"{AUDIO} training": fentry},
            bentry)


# ---------------------------------------------------------------------------
# Training the moe and hybrid families: Zamba2-2.7B, Phi-3.5-MoE
# ---------------------------------------------------------------------------

ZTRAIN_SEQ = 2000              # > 128 and not a multiple of 128: every Mamba2
                               # layer's scan through ssm_scan, ssm_scan_bwd
ZTRAIN_SSD_SEQ = 2048          # a multiple of 128: the SSD form, no SSM kernel
ZTRAIN_STEPS = 4
ZTRAIN_SSD_STEPS = 2
ZTRAIN_F32_LAYERS = 6          # the f32 step's depth: one group (six Mamba2
                               # layers and the shared block)
PHI_TRAIN_LAYERS = 2           # 2.87 × 10⁹ parameters; 3 layers (4.17 × 10⁹)
                               # do not fit 80 GB with f32 moments
PHI_TRAIN_STEPS = 4
GATE_BWD_TOL = 1e-6            # topk_gating_bwd vs plain: |Δ dlogits|
SSM_BWD_TOL = 1e-3             # ssm_scan_bwd vs the plain version in f32:
                               # |Δ| ≤ SSM_BWD_TOL·max|plain| + the output's
                               # own rounding (bf16: 2⁻⁸ of the element); the
                               # sums run over 2,000 steps and 5,120 channels
                               # in another order
SSM_BWD_FLOPS = 14             # a (b, t, c, n): the state again (mul, FMA),
                               # g, dC, dB, du, da (an FMA each), the decay


def family_per_step(cfg, layers: int, scan: bool) -> dict:
    """Kernel launches of one training step of a moe or hybrid model at
    ``layers`` layers: each forward kernel twice (the step's forward and
    the group checkpoint's recompute), each backward once; the SSM
    kernels only on the scan path (``scan``).  The xLSTM stack (family
    ``ssm``): its sLSTM layers' kernels, forward and backward."""
    if cfg.family == "ssm":
        n = sum(i < layers for i in cfg.slstm_layers)
        return launch_counts(slstm_scan=2 * n, slstm_scan_bwd=n)
    if cfg.family == "hybrid":
        g = layers // cfg.attn_every
        n = layers if scan else 0
        return launch_counts(flash_attention=2 * g, flash_attention_bwd=g,
                        ssm_scan=2 * n, ssm_scan_bwd=n)
    m = layers // max(1, cfg.moe_every)
    return launch_counts(flash_attention=2 * layers, flash_attention_bwd=layers,
                    topk_gating=2 * m, topk_gating_bwd=m)


def layer0_inputs(torch, ops, tstep, tree_flatten, cfg, params,
                  batch) -> tuple:
    """One ``value_and_grad`` of a training step keeping layer 0's inputs
    of ``ops.ssm_scan``, ``ops.topk_gating`` and ``ops.attention``
    (detached copies); every gradient finite.  Returns (the inputs, the
    loss)."""
    first: dict = {}
    real_s, real_g, real_a = ops.ssm_scan, ops.topk_gating, ops.attention

    def attention(q, k, v, **kw):
        first.setdefault("attention", (q.detach().clone(),
                                       k.detach().clone(),
                                       v.detach().clone(), kw))
        return real_a(q, k, v, **kw)

    def ssm_scan(x, dt, A, Bm, Cm, h0=None):
        first.setdefault("ssm", tuple(
            None if t is None else t.detach().clone()
            for t in (x, dt, A, Bm, Cm, h0)))
        return real_s(x, dt, A, Bm, Cm, h0)

    def topk_gating(logits, k):
        first.setdefault("gating", (logits.detach().clone(), k))
        return real_g(logits, k)
    with patched(ops, ssm_scan=ssm_scan, topk_gating=topk_gating,
                 attention=attention):
        (loss, _), grads = tstep.value_and_grad(cfg, params, batch)
    bad = [n for n, g in tree_flatten(grads)
           if not bool(torch.isfinite(g).all())]
    check(not bad, f"{cfg.name} training: gradients not finite for {bad}")
    del grads
    return first, float(loss)


def attn_bwd_layer0(torch, ref, tfa, first: dict, seed: int) -> tuple:
    """The attention backward at layer 0's inputs of a training step on
    the wgmma route, against its plain version and timed with SDPA's (as
    the zoo's training phases do).  Returns (the check, the backward's
    entry, the forward's)."""
    q, k, v, kw = first.pop("attention")
    checked = bwd_check(torch, ref, tfa, q, k, v, kw, seed, "wgmma")
    bentry, fentry = bwd_timing(torch, ref, tfa, q, k, v, kw, seed)
    bentry.update(max_abs_err=max(checked[f"d{x}_max_abs_err"]
                                  for x in "qkv"), bwd_route="wgmma")
    fentry["max_rel_err"] = checked["forward_max_abs_err"]
    return checked, bentry, fentry


def plain_ssm_scan(torch, ref):
    """``ops.ssm_scan``'s plain version under autograd: the plain forward,
    and the plain backward (autograd through the step loop would keep
    every step's state)."""
    class PlainScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, Bm, Cm, h0):
            ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
            return ref.ssm_scan_ref(x, dt, A, Bm, Cm, h0)

        @staticmethod
        def backward(ctx, dy, dh):
            return ref.ssm_scan_bwd_ref(*ctx.saved_tensors, dy, dh)
    return lambda x, dt, A, Bm, Cm, h0=None: PlainScan.apply(x, dt, A, Bm,
                                                             Cm, h0)


def ssm_bwd_phase(torch, ref, tss, args, seed: int) -> dict:
    """``ssm_scan_bwd`` at layer 0's inputs of a training step (dy drawn
    from a seed, the final state's gradient None as in training) against
    its plain version in f32, two calls to the bit; timed eager and in a
    CUDA graph, beside the forward with and without its saved states."""
    x, dt, A, Bm, Cm, h0 = args
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    dy = torch.randn(x.shape, generator=gen, device=DEVICE).to(x.dtype)
    y, h, states = tss.ssm_scan(*args, save_states=True)
    got = tss.ssm_scan_bwd(*args, states, dy)
    again = tss.ssm_scan_bwd(*args, states, dy)
    torch.cuda.synchronize()
    check(all((a is None and b is None) or torch.equal(a, b)
              for a, b in zip(got, again)), "ssm_scan_bwd: two calls differ")
    f32 = [None if t is None else t.float() for t in args]
    want = ref.ssm_scan_bwd_ref(*f32, dy.float())

    def held(got) -> tuple:
        errs, worst = {}, 0.0
        for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got,
                              want):
            check((a is None) == (b is None), f"ssm_scan_bwd: {name} missing")
            if a is None:
                continue
            b = b.float()
            top = b.abs().max().item()
            lim = SSM_BWD_TOL * top + (2.0 ** -8 * b.abs()
                                       if a.dtype == torch.bfloat16 else 0.0)
            diff = (a.float() - b).abs()
            over = (diff / lim).max().item()
            errs[name] = {"max_abs_err": diff.max().item(), "max_abs": top,
                          "err_over_limit": over}
            worst = max(worst, over)
        check(worst <= 1.0, f"ssm_scan_bwd vs plain: {errs}")
        return errs
    errs = held(got)
    # the same inputs in f32 (the kernel's f32 instantiation): the
    # distance without the bf16 outputs' rounding
    _, _, st32 = tss.ssm_scan(*f32, save_states=True)
    errs_f32 = held(tss.ssm_scan_bwd(*f32, st32, dy.float()))
    del want, got, again, st32, f32
    B, S, C = x.shape
    N = Bm.shape[-1]
    blocks, smem = tss.ssm_scan_bwd_occupancy(x.dtype, N)
    check(blocks >= 2, f"ssm_scan_bwd: {blocks} resident block(s) an SM at "
                       f"{smem} bytes of shared memory, expected 2 or more")
    e = x.element_size()
    nbytes = (5 * B * S * C * e + 4 * B * S * N * e + 8 * C
              + 4 * states.numel() + (8 * B * C * N if h0 is not None else 0))
    bms, by = bound(nbytes, SSM_BWD_FLOPS * B * S * C * N)
    run = lambda: tss.ssm_scan_bwd(*args, states, dy)
    ms = time_ms(torch, run, iters=20, warmup=2)
    device_ms = graph_ms(torch, run, calls=5, replays=4)
    fwd = lambda: tss.ssm_scan(*args)
    fwd_save = lambda: tss.ssm_scan(*args, save_states=True)
    out = {
        "max_abs_err": max(v["max_abs_err"] for v in errs.values()),
        "errors": errs, "errors_f32_inputs": errs_f32, "ms": ms,
        "device_ms": device_ms,
        "plain_ms": time_ms(torch, lambda: ref.ssm_scan_bwd_ref(
            *args, dy), iters=1, warmup=0),
        "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
        "device_bound_share": bms / device_ms, "library_ms": None,
        "library": "none: no one PyTorch call does it",
        "tolerance": f"{SSM_BWD_TOL} of each gradient's max|plain| (f32 "
                     f"plain) plus the output's rounding (bf16: 2^-8 of the "
                     f"element)",
        "same_bits_twice": True, "blocks_per_sm": blocks,
        "smem_bytes_per_block": smem,
        "states_gb": states.numel() * 4 / 1e9,
        "forward_device_ms": graph_ms(torch, fwd, calls=10, replays=5),
        "forward_saving_states_device_ms": graph_ms(torch, fwd_save,
                                                    calls=10, replays=5),
        "ms_repeat": time_ms(torch, run, iters=20, warmup=2),
        "shape": {"x": list(x.shape), "B": list(Bm.shape),
                  "dtype": str(x.dtype), "h0": h0 is not None}}
    del states, dy
    return out


def gating_bwd_phase(torch, ref, tmg, logits, k: int, seed: int) -> dict:
    """``topk_gating_bwd`` at layer 0's logits of a training step (dprobs
    drawn from a seed) against its plain version, two calls to the bit;
    timed eager and in a CUDA graph."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 12)
    probs, idx = tmg.topk_gating(logits, k)
    dprobs = torch.randn(probs.shape, generator=gen, device=DEVICE)
    run = lambda: tmg.topk_gating_bwd(logits, idx, probs, dprobs)
    got, again = run(), run()
    torch.cuda.synchronize()
    check(torch.equal(got, again), "topk_gating_bwd: two calls differ")
    err = (got - ref.topk_gating_bwd_ref(logits, idx, probs, dprobs)) \
        .abs().max().item()
    check(err <= GATE_BWD_TOL, f"topk_gating_bwd: error {err} > "
                               f"{GATE_BWD_TOL}")
    T, E = logits.shape
    bms, by = bound(T * (8 * E + 12 * k), T * (7 * E + 4 * k))
    ms = time_ms(torch, run)
    device_ms = graph_ms(torch, run)
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": time_ms(torch, lambda: ref.topk_gating_bwd_ref(
                logits, idx, probs, dprobs), iters=50),
            "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
            "device_bound_share": bms / device_ms, "library_ms": None,
            "library": "none: no one PyTorch call does it",
            "tolerance": f"{GATE_BWD_TOL} absolute",
            "same_bits_twice": True, "ms_repeat": time_ms(torch, run),
            "shape": {"logits": [T, E], "k": k}}


def family_f32_step(torch, ops, ref, M, tstep, tree_flatten, get_config,
                    data, arch: str, layers: int, seq: int,
                    plain: dict) -> dict:
    """``arch`` at full width in float32 with ``layers`` layers, the layer
    weights scaled by 0.1 (``train_f32_parity`` says why): one step's loss
    and gradients through the kernels against the same step through the
    plain versions (``plain``: ops' names to them) on the card."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32")
    prm = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(7))
    prm["layers"] = {sub: {n: (x if n == "norm" else x * 0.1)
                           for n, x in leaves.items()}
                     for sub, leaves in prm["layers"].items()}
    batch = data.make_batch(data.SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=TRAIN_BATCH,
        seed=7), 0, device=DEVICE)
    ops.reset_launch_counts()
    (lk, _), gk = tstep.value_and_grad(cfg, prm, batch)
    torch.cuda.synchronize()
    got = dict(ops.LAUNCHES)
    want = family_per_step(cfg, layers, scan=seq % 128 != 0)
    check(got == want, f"{arch} f32 step: launches {got}, expected {want}")
    with patched(ops, **plain):
        (lp, _), gp = tstep.value_and_grad(cfg, prm, batch)
    rel = {n: (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
           for (n, a), (_, b) in zip(tree_flatten(gk), tree_flatten(gp))}
    out = {"layers": layers, "seq": seq, "dtype": "float32",
           "launches": got, "loss_kernels": float(lk),
           "loss_plain": float(lp), "grad_worst_rel": max(rel.values()),
           "grad_rel": rel,
           "tolerance": f"loss {TRAIN_LOSS_TOL} relative; each gradient "
                        f"leaf {TRAIN_GRAD_TOL} of its max|g| (weights "
                        f"scaled by 0.1)"}
    check(abs(float(lk) - float(lp)) <= TRAIN_LOSS_TOL * abs(float(lp)),
          f"{arch} f32 step: loss {float(lk)} vs plain {float(lp)}")
    check(out["grad_worst_rel"] <= TRAIN_GRAD_TOL,
          f"{arch} f32 step: a gradient leaf differs by "
          f"{out['grad_worst_rel']} of its largest")
    del gk, gp, prm
    return out


def family_ptxas(source: str, prefixes: tuple, path: tuple) -> dict:
    """Registers and spills of a source's kernels whose names start with
    one of ``prefixes``; the instantiations the training path runs
    (``path``) may not spill."""
    from repro_torch.kernels import _build
    regs = {n: r for n, r in ptxas_kernels(
        _build.build_log[source]["ptxas"]).items() if n.startswith(prefixes)}
    check(all(regs.get(n) and regs[n].get("spill_store_bytes") == 0
              and regs[n].get("spill_load_bytes") == 0 for n in path),
          f"{source}.cu: {path} spill or are missing: {regs}")
    return regs


def print_profile(tag: str, window: dict) -> None:
    print(f"{tag}: " + json.dumps({k: v for k, v in window.items()
                                   if k != "top"}))
    for row in window["top"][:8]:
        print(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} "
              f"{row['name'][:90]}")


def zamba_train_phase(torch, ops, ref, tfa, M, tlaunch, tstep, get_config,
                      data, seed: int) -> tuple:
    """Zamba2-2.7B at full width and depth (54 Mamba2 layers, the shared
    block after every 6), bf16, batch 4 × ZTRAIN_SEQ through
    ``launch.train.main``: plain steps, then ``--strads --weight-decay 0``
    steps (an unscheduled block keeps its bits), every scan through
    ``ssm_scan`` and ``ssm_scan_bwd``, attention's backward on the wgmma
    route (head dim 80); then plain steps at 4 × ZTRAIN_SSD_SEQ (the SSD form,
    no SSM kernel); ``ssm_scan_bwd`` at layer 0's inputs; an f32 step of
    one group against the plain versions; a profiler window over a plain
    step.  Returns (the ``ssm_scan_bwd`` entry, the numbers)."""
    from repro_torch.kernels import ssm_scan as tss
    from repro_torch.optim import tree_flatten
    cfg = get_config(ZAMBA)
    L, G = cfg.num_layers, cfg.num_layers // cfg.attn_every
    res = {"arch": cfg.name, "layers": L, "groups": G, "batch": TRAIN_BATCH,
           "seq": ZTRAIN_SEQ, "steps": ZTRAIN_STEPS,
           "params": M.num_params(cfg)}
    per_step = family_per_step(cfg, L, scan=True)
    box = {}
    _, res["plain"] = train_run(
        torch, ops, tfa, tlaunch, zoo_argv(ZAMBA, seed, ZTRAIN_STEPS,
                                           ZTRAIN_SEQ),
        lambda i, state, metrics: box.update(state=state), L,
        steps=ZTRAIN_STEPS, tokens=TRAIN_BATCH * ZTRAIN_SEQ,
        per_step=per_step)
    res["launches_a_step"] = per_step
    print("zamba2 training plain: " + json.dumps(res["plain"]))
    box.clear()
    torch.cuda.empty_cache()

    U = (G + 1) // 2
    strads_check, sstats, prev = strads_checker(torch, tree_flatten, G, U,
                                                box)
    _, res["strads"] = train_run(
        torch, ops, tfa, tlaunch, zoo_argv(
            ZAMBA, seed, ZTRAIN_STEPS, ZTRAIN_SEQ, "--strads",
            "--weight-decay", "0"),
        strads_check, L, steps=ZTRAIN_STEPS,
        tokens=TRAIN_BATCH * ZTRAIN_SEQ, per_step=per_step)
    check(len(sstats["blocks_active"]) == ZTRAIN_STEPS,
          f"zamba2 STRADS: {len(sstats['blocks_active'])} steps checked")
    res["strads"].update(sstats, U=U, blocks=G + 1,
                         peak_memory_note="includes the check's copy of "
                                          "the parameters (bf16)")
    print("zamba2 training STRADS: " + json.dumps(res["strads"]))
    prev.clear()
    state = box.pop("state")
    batch = data_batch(cfg, ZTRAIN_SEQ, ZTRAIN_STEPS, seed)
    first, res["layer0_loss"] = layer0_inputs(
        torch, ops, tstep, tree_flatten, cfg, state["params"], batch)
    kentry = ssm_bwd_phase(torch, ref, tss, first.pop("ssm"), seed)
    print("ssm_scan_bwd at layer 0's inputs: " + json.dumps(kentry))
    res["attn_bwd_layer0"], res["attn_bwd"], res["attn_fwd"] = \
        attn_bwd_layer0(torch, ref, tfa, first, seed)
    print("zamba2 training: flash_attention_bwd at layer 0's inputs: "
          + json.dumps(res["attn_bwd"]))
    torch.cuda.empty_cache()

    # a profiler window over one plain step of the STRADS run's state
    res["profile_plain_step"] = train_profile(
        torch, ops, tstep, cfg, state, batch,
        {"ssm_scan": (ops.LAUNCHES, ("ssm_scan_fwd<", "ssm_scan_fwdI")),
         "ssm_scan_bwd": (ops.LAUNCHES, ("ssm_scan_bwd<", "ssm_scan_bwdI")),
         "flash_attention_bwd": (ops.LAUNCHES, ("flash_bwd_dq_wgmma",))},
        counts=True)
    wgmma_bwd_kernels(res["profile_plain_step"], G,
                      "zamba2 training profile_plain_step")
    print_profile("zamba2 training profile_plain_step",
                  res["profile_plain_step"])
    del state, batch, first
    box.clear()
    torch.cuda.empty_cache()

    _, res["ssd"] = train_run(
        torch, ops, tfa, tlaunch, zoo_argv(ZAMBA, seed, ZTRAIN_SSD_STEPS,
                                           ZTRAIN_SSD_SEQ),
        lambda i, state, metrics: None, L, steps=ZTRAIN_SSD_STEPS,
        tokens=TRAIN_BATCH * ZTRAIN_SSD_SEQ,
        per_step=family_per_step(cfg, L, scan=False))
    res["ssd"]["seq"] = ZTRAIN_SSD_SEQ
    print("zamba2 training SSD form (4 x 2048): " + json.dumps(res["ssd"]))
    torch.cuda.empty_cache()

    res["f32_step"] = family_f32_step(
        torch, ops, ref, M, tstep, tree_flatten, get_config, data, ZAMBA,
        ZTRAIN_F32_LAYERS, ZTRAIN_SEQ,
        {"attention": ref.attention_ref,
         "ssm_scan": plain_ssm_scan(torch, ref)})
    print("zamba2 f32 step (one group, full width): " + json.dumps(
        {k: v for k, v in res["f32_step"].items() if k != "grad_rel"}))
    torch.cuda.empty_cache()
    kentry["launches"] = res["plain"]["launches"]["ssm_scan_bwd"]
    kentry["launches_strads"] = res["strads"]["launches"]["ssm_scan_bwd"]
    kentry["ptxas"] = family_ptxas(
        "ssm_scan", ("ssm_scan_bwd", "ssm_scan_fwd"),
        ("ssm_scan_fwd<bf16,64>", "ssm_scan_bwd<bf16,64>",
         "ssm_scan_bwd_sum<bf16>"))
    return kentry, res


def phi_train_phase(torch, ops, ref, tfa, M, tlaunch, tstep, get_config,
                    data, seed: int) -> tuple:
    """Phi-3.5-MoE at full width, depth cut to PHI_TRAIN_LAYERS, bf16,
    batch 4 × 2,048, ``moe_impl="einsum"``, through ``launch.train.main``:
    plain steps, then ``--strads --weight-decay 0`` steps; the router
    through ``topk_gating`` and ``topk_gating_bwd``, attention's backward
    on the wgmma route (head dim 128, 32 query heads over 8); then
    ``topk_gating_bwd`` at layer 0's logits, an f32 step against the
    plain versions and a profiler window over a plain step.  Returns (the
    ``topk_gating_bwd`` entry, the numbers)."""
    import dataclasses
    from repro_torch.kernels import moe_gating as tmg
    from repro_torch.optim import tree_flatten
    L = PHI_TRAIN_LAYERS
    cfg = dataclasses.replace(get_config(ARCH), num_layers=L)
    check(cfg.moe_impl == "einsum", f"{ARCH}: moe_impl {cfg.moe_impl}")
    res = {"arch": cfg.name, "layers": L, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": PHI_TRAIN_STEPS,
           "params": M.num_params(cfg)}
    per_step = family_per_step(cfg, L, scan=False)
    res["launches_a_step"] = per_step
    argv = lambda *extra: zoo_argv(ARCH, seed, PHI_TRAIN_STEPS, TRAIN_SEQ,
                                   "--layers", str(L), *extra)
    _, res["plain"] = train_run(
        torch, ops, tfa, tlaunch, argv(), lambda i, state, metrics: None, L,
        steps=PHI_TRAIN_STEPS, per_step=per_step)
    print("phi3.5-moe training plain: " + json.dumps(res["plain"]))
    torch.cuda.empty_cache()

    box = {}
    U = max(1, (L + 1) // 2)
    strads_check, sstats, prev = strads_checker(torch, tree_flatten, L, U,
                                                box)
    _, res["strads"] = train_run(
        torch, ops, tfa, tlaunch, argv("--strads", "--weight-decay", "0"),
        strads_check, L, steps=PHI_TRAIN_STEPS, per_step=per_step)
    check(len(sstats["blocks_active"]) == PHI_TRAIN_STEPS,
          f"phi STRADS: {len(sstats['blocks_active'])} steps checked")
    res["strads"].update(sstats, U=U, blocks=L + 1,
                         peak_memory_note="includes the check's copy of "
                                          "the parameters (bf16)")
    print("phi3.5-moe training STRADS: " + json.dumps(res["strads"]))
    prev.clear()
    state = box.pop("state")
    batch = data_batch(cfg, TRAIN_SEQ, PHI_TRAIN_STEPS, seed)
    first, res["layer0_loss"] = layer0_inputs(
        torch, ops, tstep, tree_flatten, cfg, state["params"], batch)
    logits, k = first.pop("gating")
    check(tuple(logits.shape) == (TRAIN_BATCH * TRAIN_SEQ,
                                  cfg.num_experts) and k == 2,
          f"phi training: router logits {tuple(logits.shape)}, k {k}")
    kentry = gating_bwd_phase(torch, ref, tmg, logits, k, seed)
    print("topk_gating_bwd at layer 0's logits: " + json.dumps(kentry))
    res["attn_bwd_layer0"], res["attn_bwd"], res["attn_fwd"] = \
        attn_bwd_layer0(torch, ref, tfa, first, seed)
    print("phi3.5-moe training: flash_attention_bwd at layer 0's inputs: "
          + json.dumps(res["attn_bwd"]))
    res["profile_plain_step"] = train_profile(
        torch, ops, tstep, cfg, state, batch,
        {"topk_gating_bwd": (ops.LAUNCHES, ("topk_gating_bwd_rows",)),
         "flash_attention_bwd": (ops.LAUNCHES, ("flash_bwd_dq_wgmma",))})
    print_profile("phi3.5-moe training profile_plain_step",
                  res["profile_plain_step"])
    del state, batch, first, logits
    torch.cuda.empty_cache()

    res["f32_step"] = family_f32_step(
        torch, ops, ref, M, tstep, tree_flatten, get_config, data, ARCH, L,
        TRAIN_SEQ, {"attention": ref.attention_ref,
                    "topk_gating": ref.topk_gating_ref})
    print("phi3.5-moe f32 step (2 layers, full width): " + json.dumps(
        {k: v for k, v in res["f32_step"].items() if k != "grad_rel"}))
    torch.cuda.empty_cache()
    kentry["launches"] = res["plain"]["launches"]["topk_gating_bwd"]
    kentry["launches_strads"] = res["strads"]["launches"]["topk_gating_bwd"]
    # the main path's instantiations <G, NV, VEC, K>: Phi's forward and
    # backward, Llama-4's forward
    kentry["ptxas"] = family_ptxas("moe_gating", ("topk_gating",),
                                   ("topk_gating_rows<4,1,1,2>",
                                    "topk_gating_rows<8,4,1,1>",
                                    "topk_gating_bwd_rows<4,1,1,2>"))
    return kentry, res


# ---------------------------------------------------------------------------
# The last four configurations: ChatGLM3-6B, Granite-3-2B, StableLM-3B
# (serving, f32 and training), Llama-4 Maverick (serving at 2 layers)
# ---------------------------------------------------------------------------

GRANITE, STABLELM, CHATGLM = "granite-3-2b", "stablelm-3b", "chatglm3-6b"
LLAMA4 = "llama4-maverick-400b-a17b"
DENSE_ARCHS = (GRANITE, STABLELM, CHATGLM)
DENSE_TRAIN_LAYERS = {GRANITE: 0, STABLELM: 0, CHATGLM: 12}
                               # 0: full depth.  ChatGLM3's 28 layers
                               # (6.2 × 10⁹ parameters) with f32 moments
                               # overflow 80 GB; 12 are 3.0 × 10⁹, the size
                               # of MiniCPM-2B, which trains at full depth
LLAMA4_LAYERS = 2              # one dense and one MoE layer (moe_every 2):
                               # 1.86 × 10¹⁰ parameters, 37.2 GB in bf16;
                               # its f32 run would need 74 GB
#: (padded query heads, kv heads, head dim) of each arch's attention
ATTN_HEADS = {GRANITE: (32, 8, 64), STABLELM: (32, 32, 80),
              CHATGLM: (32, 2, 128), LLAMA4: (48, 8, 128)}


def serve_checked_prefill(torch, ops, ref, M, srv, attn_calls: int,
                          gate_calls: int = 0) -> tuple:
    """The first prefill and decode step of ``srv`` with every kernel
    launch held against its plain version: ``attn_calls``
    ``flash_attention`` launches within ATTN_TOL (the prefill's; a decode
    step attends without the kernel), ``gate_calls`` ``topk_gating``
    launches with equal indices and probabilities within GATE_TOL.
    Returns (both kernels' stats, layer 0's inputs of each kernel)."""
    cfg = srv.cfg
    attn, gate, stats, first = checked_ops(torch, ops, ref)
    with patched(ops, attention=attn, topk_gating=gate):
        first_step(torch, M, cfg, srv.params, srv.batch, srv.cache_len)
    torch.cuda.synchronize()
    st_a, st_g = stats["flash_attention"], stats["topk_gating"]
    check(st_a["calls"] == attn_calls and st_a["max_rel_err"] <= ATTN_TOL,
          f"{cfg.name} prefill: flash_attention vs plain {st_a}, expected "
          f"{attn_calls} calls")
    check(st_g["calls"] == gate_calls and st_g["idx_equal"]
          and st_g["max_abs_err"] <= GATE_TOL,
          f"{cfg.name} prefill and decode step: topk_gating vs plain "
          f"{st_g}, expected {gate_calls} calls")
    q, k = first["attention"][:2]
    check((q.shape[2], k.shape[2], q.shape[3]) == ATTN_HEADS[cfg.name]
          and q.shape[:2] == (BATCH, PROMPT),
          f"{cfg.name}: attention at q {tuple(q.shape)}, k "
          f"{tuple(k.shape)}; expected heads {ATTN_HEADS[cfg.name]}")
    return stats, first


def print_serving(cfg, res: dict) -> None:
    print(f"{cfg.name} serving: " + json.dumps(
        {k: v for k, v in res.items() if not k.startswith("profile")}))
    for w in ("profile_prefill", "profile_decode4"):
        print_profile(f"{cfg.name} {w}", res[w])


def dense_phase(torch, ops, ref, tfa, M, serve_lm, tlaunch, tstep,
                layers_mod, get_config, data, arch: str, seed: int) -> tuple:
    """A dense arch (Granite-3-2B, StableLM-3B, ChatGLM3-6B) at full
    width, bf16: serving at full depth (batch 4, prompt 1,024, 32 greedy
    tokens) with every prefill launch of ``flash_attention`` held against
    its plain version, the kernel timed at layer 0's inputs with SDPA,
    the main path's counts (L launches a prefill), profiler windows over
    a prefill and 4 decode steps; the same model in f32 at 2 layers, the
    first token and logits with the kernels against those with the plain
    versions (``parity_phase``); then plain and STRADS training at 4 ×
    2,048 through ``launch.train.main`` at full depth, or
    DENSE_TRAIN_LAYERS's cut (``zoo_train_phase``).  Returns (the
    numbers, the flash_attention entries by shape, the backward's
    entry)."""
    import dataclasses
    srv, res = serve_build(torch, serve_lm, arch, seed)
    cfg = srv.cfg
    L = cfg.num_layers
    res["params"] = M.num_params(cfg)
    with torch.inference_mode():
        res["every_launch_vs_plain"], first = serve_checked_prefill(
            torch, ops, ref, M, srv, L)
        q, k, v, kw = first.pop("attention")
        serve_attn = attention_timing(torch, ops, ref, q, k, v, kw)
        del first, q, k, v
        _, numbers = main_path(torch, ops, M, srv, attn_launches(L))
        res.update(numbers)
        res.update(profile_serving(torch, ops, M, srv))
    print_serving(cfg, res)
    del srv
    torch.cuda.empty_cache()

    parity = parity_phase(torch, ops, ref, M, get_config, data, seed, arch)
    print(f"{arch} f32 parity (2 layers, full width): "
          + json.dumps(parity))
    torch.cuda.empty_cache()

    cut = DENSE_TRAIN_LAYERS[arch]
    tcfg = dataclasses.replace(cfg, num_layers=cut) if cut else cfg
    train, bentry, fentry = zoo_train_phase(
        torch, ops, ref, tfa, M, tlaunch, tstep, layers_mod, tcfg, seed,
        TRAIN_SEQ, layers=cut, strads=True)
    train["params"] = M.num_params(tcfg)
    return ({"serve": res, "f32_parity": parity, "train": train},
            {f"{arch} serving": serve_attn, f"{arch} training": fentry},
            bentry)


def gating_timing(torch, ops, ref, logits, k: int) -> dict:
    """``topk_gating`` at one call's real logits (T, E): two launches give
    the same bits, the indices equal the plain version's and the
    probabilities are within GATE_TOL; timed eager and in a CUDA graph,
    with the plain version, and its bound (the logits read, probabilities
    and indices written)."""
    p, i = ops.topk_gating(logits, k)
    p2, i2 = ops.topk_gating(logits, k)
    pr, ir = ref.topk_gating_ref(logits, k)
    torch.cuda.synchronize()
    check(torch.equal(p, p2) and torch.equal(i, i2),
          f"topk_gating: two launches differ at {tuple(logits.shape)}")
    err = (p - pr).abs().max().item()
    check(torch.equal(i, ir) and err <= GATE_TOL,
          f"topk_gating at {tuple(logits.shape)}, k {k}: idx equal "
          f"{torch.equal(i, ir)}, probs error {err}")
    T, E = logits.shape
    bms, by = bound(4 * T * E + 8 * T * k, T * E * (4 + k))
    kernel = lambda: ops.topk_gating(logits, k)
    out = {"shape": {"logits": [T, E], "k": k}, "max_abs_err": err,
           "idx_equal": True, "ms": time_ms(torch, kernel),
           "device_ms": graph_ms(torch, kernel),
           "plain_ms": time_ms(torch, lambda: ref.topk_gating_ref(logits, k)),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    out["device_bound_share"] = bms / out["device_ms"]
    return out


def llama4_phase(torch, ops, ref, M, serve_lm, seed: int) -> tuple:
    """Llama-4 Maverick at full width, depth cut to LLAMA4_LAYERS (one
    dense layer and one MoE layer of 128 experts, top-1, with its shared
    expert), bf16, through ``serve_lm``: batch 4, prompt 1,024, 32 greedy
    tokens.  Every launch of a prefill and a decode step against its
    plain version (2 ``flash_attention`` at 48 query heads padded from
    40 over 8 of 128, 1 ``topk_gating`` at (4,096, 128) and 1 at the
    decode step's (4, 128), k = 1); both kernels timed at layer 0's
    inputs; the main path's counts (2 attention, 33 gating launches); the
    seconds and peak memory of the weights' init (each stacked expert
    leaf, 128 × 5,120 × 8,192, drawn as one f32 temporary) and of
    serving; prefill ms, decode tok/s beside the bound of a decode step,
    which reads every weight but the embedding table (at 4 tokens the
    capacity of 4 a expert runs the FFN of all 128 experts); profiler
    windows.  No f32 token-for-token run: at 2 layers its weights take
    74 GB in f32.  Returns (the numbers, the flash_attention entry by
    shape, the topk_gating entries by shape)."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models.params import leaves
    srv, res = serve_build(torch, serve_lm, LLAMA4, seed, LLAMA4_LAYERS)
    cfg = srv.cfg
    check(cfg.num_experts == 128 and cfg.experts_per_token == 1
          and cfg.moe_every == 2 and cfg.moe_shared_expert,
          f"{cfg.name}: {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, moe_every {cfg.moe_every}")
    moe_layers = cfg.num_layers // cfg.moe_every
    res["params"] = M.num_params(cfg)
    res["capacity"] = {
        "prefill": tmoe._capacity(min(tmoe.GROUP, BATCH * PROMPT), 1,
                                  cfg.num_experts, cfg.capacity_factor),
        "decode": tmoe._capacity(BATCH, 1, cfg.num_experts,
                                 cfg.capacity_factor)}
    nbytes = lambda ts: sum(x.numel() * x.element_size() for x in ts)
    read = nbytes(leaves(srv.params)) - nbytes([srv.params["tok_embed"]])
    res["decode_step_weight_bytes"] = read
    res["decode_step_bound_ms"] = read / PEAK_BYTES_PER_S * 1e3
    moe = srv.params["layers"][f"ffn{cfg.moe_every - 1}"]
    experts = nbytes(moe[n] for n in ("wg", "wu", "wd"))
    res["expert_weight_bytes"] = experts
    res["expert_read_ms"] = experts / PEAK_BYTES_PER_S * 1e3
    with torch.inference_mode():
        res["every_launch_vs_plain"], first = serve_checked_prefill(
            torch, ops, ref, M, srv, cfg.num_layers, 2 * moe_layers)
        q, k, v, kw = first.pop("attention")
        serve_attn = attention_timing(torch, ops, ref, q, k, v, kw)
        logits, kk = first.pop(("gating", BATCH * PROMPT))
        dec_logits, _ = first.pop(("gating", BATCH))
        check(kk == 1 and tuple(logits.shape) == (BATCH * PROMPT, 128),
              f"{cfg.name}: router logits {tuple(logits.shape)}, k {kk}")
        gates = {f"{LLAMA4} prefill": gating_timing(torch, ops, ref, logits,
                                                    kk),
                 f"{LLAMA4} decode": gating_timing(torch, ops, ref,
                                                   dec_logits, kk)}
        del first, q, k, v, logits, dec_logits
        _, numbers = main_path(torch, ops, M, srv, launch_counts(
            flash_attention=cfg.num_layers,
            topk_gating=moe_layers * (GEN + 1)))
        res.update(numbers)
        res["decode_ms_a_step"] = BATCH / res["decode_tok_per_s"] * 1e3
        res["decode_bound_share"] = (res["decode_step_bound_ms"]
                                     / res["decode_ms_a_step"])
        res.update(profile_serving(torch, ops, M, srv))
    print_serving(cfg, res)
    print("topk_gating by shape: " + json.dumps(gates))
    del srv
    torch.cuda.empty_cache()
    return res, {f"{LLAMA4} serving": serve_attn}, gates


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--J", type=int, default=50_000)
    ap.add_argument("--layers", type=int, default=24,
                    help="Phi-3.5-MoE layers served (32 published; 24 fit "
                         "the card in bf16)")
    ap.add_argument("--zamba-layers", type=int, default=54,
                    help="Zamba2-2.7B layers served (54 published; a "
                         "multiple of 6)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a card",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch import data as tdata
    from repro_torch.apps import lasso, lda, mf
    from repro_torch.configs import get_config
    from repro_torch.core import ExecutionPlan
    from repro_torch.kernels import KernelSpec, _build, ops, ref
    from repro_torch.kernels import lasso_cd as lc
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import lda_gibbs as lg
    from repro_torch.launch import serve_lm
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import layers as tlayers
    from repro_torch.models import model as M
    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result: dict = {}
    t_start, phase_s = time.perf_counter(), {}

    def phase(name: str) -> None:
        """Record the command's seconds at the end of a phase."""
        phase_s[name] = time.perf_counter() - t_start
        print(f"[{phase_s[name]:7.1f} s] {name} done")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}; allow_tf32=False "
          f"(matmul and cuDNN)")
    result["card"] = card
    result["versions"] = {"torch": torch.__version__,
                          "cuda": torch.version.cuda}

    # 2. the build: one nvcc per source, all started together
    t0 = time.perf_counter()
    _build.build(BUILD)
    build_s = time.perf_counter() - t0
    print(f"build: {', '.join(n + '.cu' for n in BUILD)} in {build_s:.2f} s "
          f"(in parallel; nvcc {' '.join(_build.NVCC_FLAGS)})")
    result["build"] = {"seconds": build_s}
    phase("build")
    for name in BUILD:
        ptxas = [ln.strip() for ln in _build.build_log[name]["ptxas"]
                 .splitlines() if "ptxas info" in ln or "spill" in ln]
        print(f"  {name}.cu ({_build.build_log[name]['seconds']:.2f} s):")
        for ln in ptxas:
            print(f"    {ln}")
        result["build"][name] = {
            "seconds": _build.build_log[name]["seconds"], "ptxas": ptxas}

    # 3. data on the card, then the kernels against their plain versions
    n, J = args.n, args.J
    W, U, UP, LAM, RHO = 4, 32, 128, 0.02, 0.3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    X, y, _ = lasso.synthetic_correlated_device(args.seed, n, J, k_true=16,
                                                device=DEVICE)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"data: X ({n}, {J}) f32 = {X.numel() * 4 / 1e9:.2f} GB on the "
          f"card, built in {gen_s:.2f} s from seed {args.seed}")
    check(bool(torch.isfinite(X).all()) and bool(torch.isfinite(y).all()),
          "the data is not finite")
    torch.cuda.reset_peak_memory_stats()
    kern = kernel_phase(torch, lc, ref, X, y, W, U, UP, args.seed)
    kern_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    regs = ptxas_kernels(_build.build_log["lasso_cd"]["ptxas"])
    for name, fn in (("lasso_partial", "lasso_partial_fused"),
                     ("gram_block", "gram_fused")):
        kern[name]["ptxas"] = regs.get(fn)
        print(f"{fn}: {json.dumps(regs.get(fn))}")
    print("gram_block by shape: " + json.dumps(kern["gram_block"]["by_shape"]))
    # the floor of a kernel node: one trivial kernel (add_ on one element)
    # in the same CUDA-graph timing as every kernel's device_ms
    one = torch.zeros(1, device=DEVICE)
    launch_floor_ms = graph_ms(torch, lambda: one.add_(1.0))
    print(f"launch floor (one add_ kernel node, device): "
          f"{launch_floor_ms:.6f} ms")
    del one

    # 4. the main path
    with open(os.path.join(ROOT, "examples", "plans",
                           "lasso_pallas.json")) as f:
        plan = ExecutionPlan.from_json(json.load(f))
    check(plan.executor == "scan" and plan.workers == W
          and plan.kernels.kind == "pallas", f"unexpected plan {plan}")
    cfg = lasso.LassoConfig(num_features=J, lam=LAM, block_size=U,
                            num_candidates=UP, rho=RHO)
    loop_plan = ExecutionPlan.from_json(dict(plan.to_json(),
                                             executor="loop"))
    w1_plan = ExecutionPlan.from_json(dict(plan.to_json(), workers=1))
    ref_plan = ExecutionPlan.from_json(dict(
        plan.to_json(), kernels=KernelSpec(kind="reference").to_json()))
    # warm-up (library handles, allocator), not counted or timed
    run_plan(torch, lasso, cfg, ExecutionPlan.from_json(
        dict(plan.to_json(), rounds=2)), X, y, args.seed)
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    for name, p in (("scan_w4", plan), ("loop_w4", loop_plan),
                    ("scan_w1", w1_plan)):
        before = dict(lc.LAUNCHES)
        eng, rep, secs = run_plan(torch, lasso, cfg, p, X, y, args.seed)
        runs[name] = (rep, secs)
        for k in lc.LAUNCHES:
            check(lc.LAUNCHES[k] - before[k] == p.rounds,
                  f"{name}: {k} launched {lc.LAUNCHES[k] - before[k]} "
                  f"times in {p.rounds} rounds")
    launches = dict(lc.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"the main path never launched {k}")
        kern[k]["launches"] = v
    before = dict(lc.LAUNCHES)
    _, rep_ref, secs_ref = run_plan(torch, lasso, cfg, ref_plan, X, y,
                                    args.seed)
    check(lc.LAUNCHES == before, "the reference run launched a kernel")
    runs["scan_w4_reference"] = (rep_ref, secs_ref)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    a, b = runs["scan_w4"][0], runs["loop_w4"][0]
    check(torch.equal(a.state["beta"], b.state["beta"])
          and torch.equal(a.state["r"], b.state["r"])
          and torch.equal(a.trace, b.trace),
          "loop and scan differ on the card")
    diffs = {}
    for name in ("scan_w1", "scan_w4_reference"):
        o = runs[name][0]
        db = (o.state["beta"] - a.state["beta"]).abs().max().item()
        dr = (o.state["r"].reshape(-1)
              - a.state["r"].reshape(-1)).abs().max().item()
        diffs[name] = {"beta": db, "r": dr}
        check(db <= STATE_TOL and dr <= STATE_TOL,
              f"{name} differs from scan_w4: |Δβ| {db}, |Δr| {dr} "
              f"> {STATE_TOL}")
    obj0 = 0.5 * float((y.double() ** 2).sum())
    trace = a.trace.double().cpu().numpy()
    check(trace.shape == (plan.rounds,) and all(map(math.isfinite, trace)),
          "the objective trace is not finite")
    check(trace[-1] < obj0, f"the objective did not fall: {trace[-1]} >= "
                            f"{obj0}")
    main = {
        "plan": plan.to_json(), "n": n, "J": J, "lam": LAM, "U": U,
        "U_prime": UP, "rho": RHO,
        "rounds_per_s": {k: plan.rounds / s for k, (_, s) in runs.items()},
        "seconds": {k: s for k, (_, s) in runs.items()},
        "peak_memory_gb": peak_gb, "data_build_peak_memory_gb": gen_peak_gb,
        "kernel_check_peak_memory_gb": kern_peak_gb, "launches": launches,
        "objective_start": obj0, "objective_end": float(trace[-1]),
        "max_diff_vs_scan_w4": diffs, "loop_equals_scan": True,
        "data_seconds": gen_s,
    }
    print("main path: " + json.dumps(main))
    # the pipelined executor and a checkpointed load_balanced run
    pipelined = lasso_pipelined_phase(torch, lasso, lc, ExecutionPlan,
                                      KernelSpec, cfg, X, y, args.seed)
    print("lasso pipelined: " + json.dumps(pipelined))
    loadbal = lasso_loadbal_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                                  args.seed, runs["scan_w4"][0].state)
    print("lasso load_balanced + checkpoints: " + json.dumps(loadbal))
    lssp = lasso_ssp_phase(torch, lasso, lc, ExecutionPlan, KernelSpec, cfg,
                           X, y, args.seed)
    print("lasso ssp: " + json.dumps(lssp))
    phase("lasso main path, pipelined, load_balanced, ssp")
    lobs = lasso_counters_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                                args.seed)
    print("lasso counters: " + json.dumps(lobs))
    lserve = lasso_serve_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                               args.seed)
    print("lasso serve: " + json.dumps(lserve))
    phase("lasso counters and serving")
    lstream = lasso_stream_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                                 args.seed)
    print("lasso stream: " + json.dumps(
        {k: v for k, v in lstream.items() if k != "span_totals_traced"}))
    phase("lasso streaming")
    for k in ("lasso_partial", "gram_block"):
        kern[k]["launches_pipelined"] = pipelined["launches"][k]
        kern[k]["launches_loadbal"] = loadbal["launches"][k]
        kern[k]["launches_ssp"] = lssp["launches"][k]
        kern[k]["launches_counters"] = lobs["launches"][k]
        kern[k]["launches_serve"] = {n: lserve[n]["launches"][k]
                                     for n in ("stale", "snapshot")}
        kern[k]["launches_stream"] = lstream["launches"][k]
        kern[k]["launches_stream_serve"] = lstream["serve"]["launches"][k]

    eng = lasso.make_engine(cfg, workers=W, device=DEVICE)
    data = eng.shard_data({"X": X, "y": y})
    main["breakdown_ms"] = round_breakdown(torch, eng, runs["scan_w4"][0]
                                           .state, data, args.seed)
    print("round breakdown (ms): " + json.dumps(main["breakdown_ms"]))
    prof = profile_rounds(torch, lasso, lc, cfg, plan, X, y, args.seed)
    print("profile (4 rounds): " + json.dumps(
        {k: v for k, v in prof.items() if k != "top"}))
    # the traced run (a profiler session) comes last, on data made again
    scan_state = {k: runs["scan_w4"][0].state[k].clone()
                  for k in ("beta", "r")}
    del X, y, data, runs, eng

    # the repo's own convergence check (tests/test_lasso.py) on the card
    import numpy as np
    rs = np.random.default_rng(0)
    Xs, ys, _ = lasso.synthetic_correlated(rs, n=150, J=60, k_true=5)
    scfg = lasso.LassoConfig(num_features=60, lam=LAM, block_size=8,
                             num_candidates=32, rho=0.3, eta=1e-2)
    before = dict(lc.LAUNCHES)
    st, _ = lasso.fit(scfg, Xs, ys, plan=ExecutionPlan(
        executor="scan", rounds=400, workers=2,
        kernels=KernelSpec.default_for("pallas")), device=DEVICE)
    check(all(lc.LAUNCHES[k] - before[k] == 400 for k in lc.LAUNCHES),
          "the small run did not go through the kernels")

    def obj(bv):
        return 0.5 * np.sum((ys - Xs @ bv) ** 2) + LAM * np.sum(np.abs(bv))

    got = float(obj(st["beta"].cpu().numpy()))
    want = float(obj(lasso.reference_cd(Xs, ys, LAM, 100)))
    check(got <= want * 1.05 + 1e-6, f"small run: objective {got} not "
                                     f"within 5% of reference_cd's {want}")
    print(f"small run (n=150, J=60, 400 rounds, W=2, CUDA kernels): "
          f"objective {got:.6f} vs reference_cd {want:.6f}")

    del st, Xs, ys
    torch.cuda.empty_cache()
    phase("lasso breakdown, profile, small run")

    # 4. STRADS MF at the Netflix Prize shape (no kernel of its own)
    mfres = mf_phase(torch, mf, ExecutionPlan, args.seed)
    print("mf: " + json.dumps({k: v for k, v in mfres.items()
                               if k not in ("profile", "stream")}))
    print("mf stream: " + json.dumps(mfres["stream"]))
    print("mf profile (4 rounds): " + json.dumps(
        {k: v for k, v in mfres["profile"].items() if k != "top"}))
    for row in mfres["profile"]["top"][:6]:
        print(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} "
              f"{row['name'][:90]}")
    phase("mf")

    # 5. STRADS LDA at the NYTimes shape: lda_gibbs
    kern["lda_gibbs"], ldares = lda_phase(
        torch, lda, lg, ref, ExecutionPlan, KernelSpec, args.seed)
    kern["lda_gibbs"]["ptxas"] = {
        k: v for k, v in ptxas_kernels(
            _build.build_log["lda_gibbs"]["ptxas"]).items()
        if k.startswith("lda_gibbs_kernel")}
    print("lda: " + json.dumps({k: v for k, v in ldares.items()
                                if k not in ("profile", "stream")}))
    print("lda stream: " + json.dumps(ldares["stream"]))
    print("lda profile (4 rounds): " + json.dumps(
        {k: v for k, v in ldares["profile"].items() if k != "top"}))
    for row in ldares["profile"]["top"][:6]:
        print(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} "
              f"{row['name'][:90]}")
    print("lda_gibbs: " + json.dumps(kern["lda_gibbs"]))
    phase("lda")
    for name, run in (("lasso", lserve["stale"]),
                      ("lasso snapshot", lserve["snapshot"]),
                      ("mf", mfres["serve"]), ("lda", ldares["serve"])):
        print(f"serving {name}: " + json.dumps(
            {k: run[k] for k in ("requests", "p50_ms", "p99_ms",
                                   "requests_per_s", "staleness_hist",
                                   "rounds_per_s_served",
                                   "rounds_per_s_unserved",
                                   "peak_memory_gb")}))
    torch.cuda.empty_cache()
    cli = serve_cli_run()
    print("serve CLI: " + json.dumps(cli))
    cli_stream = serve_cli_stream_run()
    print("serve CLI --stream: " + json.dumps(cli_stream))
    phase("serve CLI")

    # 6. model-zoo serving: Phi-3.5-MoE at full width, bf16
    skern, serve = serve_phase(torch, ops, ref, M, serve_lm, args.layers,
                               args.seed)
    torch.cuda.empty_cache()
    print("serve: " + json.dumps({k: v for k, v in serve.items()
                                  if not k.startswith("profile")}))
    for w in ("profile_prefill", "profile_decode4"):
        print(f"serve {w}: " + json.dumps(
            {k: v for k, v in serve[w].items() if k != "top"}))
        for row in serve[w]["top"][:6]:
            print(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} "
                  f"{row['name'][:90]}")

    phase("phi3.5-moe serving")

    # 7. the same model in f32, 2 layers: kernels vs plain, token for token
    parity = parity_phase(torch, ops, ref, M, get_config, tdata, args.seed)
    print("f32 parity (2 layers, full width): " + json.dumps(parity))
    torch.cuda.empty_cache()

    # 8. model-zoo serving: Zamba2-2.7B at full width and depth, bf16
    skern["ssm_scan"], zamba = zamba_phase(torch, ops, ref, M, serve_lm,
                                           args.zamba_layers, args.seed)
    torch.cuda.empty_cache()
    print("zamba2: " + json.dumps({k: v for k, v in zamba.items()
                                   if not k.startswith("profile")}))
    print("ssm_scan at layer 0's inputs: " + json.dumps(
        {k: skern["ssm_scan"][k] for k in ("ms", "device_ms", "ms_repeat",
                                           "plain_ms", "bound_ms",
                                           "bound_by", "bound_share",
                                           "device_bound_share",
                                           "max_abs_err")}))
    for w in ("profile_prefill", "profile_decode4"):
        print(f"zamba2 {w}: " + json.dumps(
            {k: v for k, v in zamba[w].items() if k != "top"}))
        for row in zamba[w]["top"][:8]:
            print(f"    {row['device_ms']:9.3f} ms  x{row['count']:<5d} "
                  f"{row['name'][:90]}")
    skern["flash_attention"]["launches_zamba2"] = \
        zamba["launches"]["flash_attention"]
    skern["flash_attention"]["by_shape"][ZAMBA] = \
        zamba.pop("flash_attention_layer0")
    print("flash_attention at layer 0's inputs: " + json.dumps(
        {name: {k: e[k] for k in ("shape", "ms", "device_ms", "ms_repeat",
                                  "plain_ms", "library_ms",
                                  "library_device_ms", "bound_ms",
                                  "bound_by", "bound_share",
                                  "device_bound_share", "max_rel_err")}
         for name, e in skern["flash_attention"]["by_shape"].items()}))

    phase("f32 parity, zamba2 serving")

    # 9. Zamba2 in f32, 12 layers: kernels vs plain, token for token
    zparity = zamba_parity_phase(torch, ops, ref, M, get_config, tdata,
                                 args.seed)
    phase("zamba2 f32 parity")
    torch.cuda.empty_cache()

    # 10. model-zoo training: MiniCPM-2B at full width and depth
    skern["flash_attention_bwd"], fentry, train = train_phase(
        torch, ops, ref, tfa, M, tlaunch, tstep, get_config, tdata,
        args.seed)
    skern["flash_attention"]["by_shape"][f"{TRAIN_ARCH} training"] = fentry
    skern["flash_attention"]["launches_training"] = \
        train["plain"]["launches"]["flash_attention"]
    phase("minicpm-2b training")

    # 11. the rest of the zoo: xLSTM-125M, InternVL2-1B, HuBERT-XLarge
    zoo = {}
    skern["slstm_scan"], skern["slstm_scan_bwd"], zoo["xlstm"] = \
        xlstm_phase(torch, ops, ref, tfa, M, serve_lm, tlaunch, tstep,
                    get_config, tdata, args.seed)
    phase("xlstm-125m serving and training")
    fa, fb = skern["flash_attention"], skern["flash_attention_bwd"]
    fb["by_shape"] = {}
    zoo["internvl2"], shapes, fb["by_shape"][f"{VLM} training"] = vlm_phase(
        torch, ops, ref, tfa, M, serve_lm, tlaunch, tstep, tlayers, args.seed)
    fa["by_shape"].update(shapes)
    fa["launches_internvl2"] = {
        "serving": zoo["internvl2"]["serve"]["launches"]["flash_attention"],
        "training": zoo["internvl2"]["train"]["launches"]["flash_attention"]}
    fb["launches_internvl2_training"] = \
        zoo["internvl2"]["train"]["launches"]["flash_attention_bwd"]
    phase("internvl2-1b serving and training")
    zoo["hubert"], shapes, fb["by_shape"][f"{AUDIO} training"] = audio_phase(
        torch, ops, ref, tfa, M, tlaunch, tstep, get_config, tdata, tlayers,
        args.seed)
    fa["by_shape"].update(shapes)
    fa["launches_hubert"] = {
        "encode": zoo["hubert"]["encode"]["launches"]["flash_attention"],
        "training": zoo["hubert"]["train"]["launches"]["flash_attention"]}
    fb["launches_hubert_training"] = \
        zoo["hubert"]["train"]["launches"]["flash_attention_bwd"]
    phase("hubert-xlarge encoding and training")

    # 12. training the moe and hybrid families: the backward kernels of
    # ssm_scan and topk_gating
    skern["ssm_scan_bwd"], ztrain = zamba_train_phase(
        torch, ops, ref, tfa, M, tlaunch, tstep, get_config, tdata,
        args.seed)
    phase("zamba2-2.7b training")
    skern["topk_gating_bwd"], ptrain = phi_train_phase(
        torch, ops, ref, tfa, M, tlaunch, tstep, get_config, tdata,
        args.seed)
    phase("phi3.5-moe training")
    for arch, run in ((ZAMBA, ztrain), (ARCH, ptrain)):
        for name in ("flash_attention", "flash_attention_bwd", "ssm_scan",
                     "topk_gating"):
            count = run["plain"]["launches"][name]
            if count:
                skern[name][f"launches_{arch}_training"] = count
        fa["by_shape"][f"{arch} training"] = run.pop("attn_fwd")
        fb["by_shape"][f"{arch} training"] = run.pop("attn_bwd")

    # 13. the last four configurations: the dense archs serving at full
    # depth, in f32 at 2 layers and training; Llama-4 serving at 2 layers
    for arch in DENSE_ARCHS:
        zoo[arch], shapes, fb["by_shape"][f"{arch} training"] = dense_phase(
            torch, ops, ref, tfa, M, serve_lm, tlaunch, tstep, tlayers,
            get_config, tdata, arch, args.seed)
        fa["by_shape"].update(shapes)
        run = zoo[arch]["train"]
        fa[f"launches_{arch}"] = {
            "serving": zoo[arch]["serve"]["launches"]["flash_attention"],
            "training": run["launches"]["flash_attention"],
            "training_strads": run["strads"]["launches"]["flash_attention"]}
        fb[f"launches_{arch}_training"] = {
            "plain": run["launches"]["flash_attention_bwd"],
            "strads": run["strads"]["launches"]["flash_attention_bwd"]}
        phase(f"{arch} serving, f32 and training")
    zoo[LLAMA4], shapes, gates = llama4_phase(torch, ops, ref, M, serve_lm,
                                              args.seed)
    fa["by_shape"].update(shapes)
    fa[f"launches_{LLAMA4}"] = zoo[LLAMA4]["launches"]["flash_attention"]
    tg = skern["topk_gating"]
    tg["by_shape"] = {ARCH: {k: tg[k] for k in (
        "shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
        "bound_by", "device_bound_share")}, **gates}
    tg[f"launches_{LLAMA4}"] = zoo[LLAMA4]["launches"]["topk_gating"]
    phase(f"{LLAMA4} serving")
    for name in ("flash_attention", "flash_attention_bwd"):
        print(f"{name} by shape: " + json.dumps(
            {shape: {k: e.get(k) for k in (
                "shape", "device_ms", "library_device_ms", "bound_ms",
                "bound_by", "device_bound_share", "max_rel_err",
                "max_abs_err")}
             for shape, e in skern[name]["by_shape"].items()}))

    # 14. lasso_loadbal.json traced, inside a profiler session: last, since
    # a session slows the host's later launches (decode is host-bound)
    torch.cuda.empty_cache()
    X, y, _ = lasso.synthetic_correlated_device(args.seed, n, J, k_true=16,
                                                device=DEVICE)
    ltrace = lasso_trace_phase(torch, lasso, lc, ExecutionPlan, cfg, X, y,
                               args.seed, loadbal, scan_state)
    del X, y
    print("lasso trace (lasso_loadbal.json): " + json.dumps(ltrace))
    for name, v in ltrace["span_totals"].items():
        print(f"    span {name:<12s} x{v['count']:<3d} "
              f"{v['host_ms']:10.3f} ms on the host")
    for k in ("lasso_partial", "gram_block"):
        kern[k]["launches_trace"] = ltrace["launches"][k]
    phase("lasso trace")

    for name, entry in skern.items():
        kern[name] = {"name": name, "route": "cuda",
                      "source": SOURCES[name], "replaces": REPLACES[name],
                      **entry}
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    for name, entry in kern.items():
        missing = [k for k in keys if k not in entry]
        check(not missing and entry["launches"],
              f"{name}: missing {missing} or never launched on its path")
        # the least a launch can take in a graph: the bound or the floor
        entry["floor_bound_ms"] = max(entry["bound_ms"], launch_floor_ms)
        entry["device_floor_share"] = (entry["floor_bound_ms"]
                                       / entry["device_ms"])
    tg = kern["topk_gating"]
    tg["decode_shape_floor_share"] = (max(tg["bound_ms"], launch_floor_ms)
                                      / tg["decode_shape_device_ms"])
    for shape in (f"{LLAMA4} prefill", f"{LLAMA4} decode"):
        e = tg["by_shape"][shape]
        tg[f"device_floor_share_{shape.replace(' ', '_')}"] = (
            max(e["bound_ms"], launch_floor_ms) / e["device_ms"])
    result.update(kernels=list(kern.values()), main=main, profile=prof,
                  lasso_pipelined=pipelined, lasso_loadbal=loadbal,
                  lasso_ssp=lssp, lasso_counters=lobs, lasso_serve=lserve,
                  lasso_trace=ltrace, lasso_stream=lstream, serve_cli=cli,
                  serve_cli_stream=cli_stream, phase_seconds=phase_s,
                  launch_floor_ms=launch_floor_ms,
                  small={"objective": got, "reference_cd": want},
                  mf=mfres, lda=ldares,
                  serve=serve, f32_parity=parity, zamba2=zamba,
                  zamba2_f32_parity=zparity, train=train, zoo=zoo,
                  train_families={ZAMBA: ztrain, ARCH: ptrain})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"kernels": list(kern.values()),
                      "launch_floor_ms": launch_floor_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
