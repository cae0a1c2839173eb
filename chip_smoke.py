#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the whole run, one card
    python3 chip_smoke.py --kernels-only   # build + kernel checks only
    python3 chip_smoke.py --resnet-only    # the card, then phase 19 alone
    python3 chip_smoke.py --resume-drill JSON   # one run of phase 17's drill
    python3 chip_smoke.py --fit-only       # the card, the build, phase 20
    python3 chip_smoke.py --fit-drill JSON # one run of phase 20's drill

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: name and power limit as nvidia-smi reports them, torch and
     CUDA versions; no CUDA is a failure;
  2. build: every kernel source in paddle_tpu_torch/ops/csrc, one nvcc
     each, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     serving shapes, the flash forward also at the training main path's
     (B=16, T=512, 12 heads, bfloat16, causal, as make_eval_step gives
     it), and at the edge cases (ragged T, idle slot, block
     edge, the paged kernel's chunk edges for each cache, T-1, full clamp,
     every slot full, NaN tail, a 16384-row cache), and the fused
     dropout-residual(+LN) kernels at float32, bfloat16 and mixed input
     types, Hd 64, 768 and 1000, p 0, 0.1 and 1, both dropout modes, and
     at the training paths' shapes, fed the kernels' own dropout bits,
     with the tolerances stated below; the dropout kernels read their key
     from a Philox word on the card (seed, base) and a delta, held to the
     plain versions at (seed, base + delta); AdamW reads lr, c1 and c2
     from a scalar buffer on the card, also over t = 1..5 with the lr
     changed; with the scalar buffer's guard word at 0 the kernel and the
     plain rule leave the parameter and both moments bit-equal to their
     inputs (float32 and bfloat16); with the clip's scale word at 0.3711
     the kernel and the plain rule bit-equal to the composed float32
     product g * scale; F.dropout's keep-mask kernel against
     its plain version; the backward's mask equal to the forward's; each
     gate raising on inputs its kernel does not take, and the flash gate
     handing an additive mask and dropout p=1 to the plain attention;
  4. each kernel's device time (CUDA events, median of 25 runs of 10
     back-to-back launches queued behind a sleep kernel) beside its bound,
     its plain version's time and one library call's time;
  5. the main path: gpt2-small at full width and depth (seeded weights)
     behind GenerationEngine(max_batch=8, max_seq_len=512, buckets
     (32, 128, 256)) and ContinuousBatcher with the prefix cache on,
     serving 16 requests; the engine's step programs are CUDA graphs,
     each captured once and replayed; the kernel launch counters are
     zeroed just before and read just after, and must equal each
     program's runs times its captured launches, with kernels launched
     through replays; the compile-once contract (one decode program, at
     most one prefill program a bucket, a suffix program for the shared
     head of requests 2 and 6), each program's capture time and the graph
     pool's memory; the flash forward's launches by prefill bucket
     (summed against each bucket's time and bound); a torch.profiler
     breakdown of the decode step; the same requests again on the same
     engine (dirty slots, a fresh prefix cache, every program built):
     the same tokens and no build; then the same requests through the
     engine's step bodies run eagerly: tokens identical and the final
     cache (k, v, lens) bit-equal to the replayed run's;
  6. the same requests with both kernel flags off (the plain versions on
     the card, captured the same way): tokens must agree, or first differ
     where the plain run's top-2 logit gap is a near tie;
  7. a shorter int8-cache run, checked, profiled and held to the eager
     bodies (scales too) the same way, and to the plain int8 path;
  8. the server: the same model behind InferenceServer (the same engine
     settings, http_port=0, the flight recorder's and the heartbeat's
     directories in a temporary folder), requests submitted from 4
     threads: (a) one worker, the 16 requests of phase 5; (b) two
     workers, the same, both engines' programs built; (c) an int8 cache,
     one worker, phase 7's 8 requests. Each: tokens held to phase 6's (or
     7's) plain run by its rule; /healthz (200) and /metrics scraped while
     it serves, /statusz before and after (completed requests and tokens
     equal to the handles', ttft_ms present, hbm in_use in (0, memory
     reserved], retraces by engine equal to the programs built); the
     heartbeat file fresh; the launch counts zeroed just before and read
     just after, the flash forward and the paged decode kernel launched,
     also through replays; tokens/s, TTFT p50, the decode step, the graph
     pools and peak memory printed. (d) the crash drill: a worker whose
     decode raises on its third call: its handles fail with the fault
     chained, a crash bundle with its six files (memory.json too), and
     /healthz 503 naming the dead worker, 200 after stop(). (e) the
     built engine's decode step with telemetry off and on, in turns;
  9. the training kernels' device times at the training main path's
     shapes (flash forward with lse and dropout, flash backward dq and
     dk/dv: B=16, H=12, T=512, D=64, bfloat16, causal, p=0.1; AdamW over
     every gpt2-small parameter), each beside its bound, its plain
     version's time and one library call's time (AdamW's 148 launches
     with the clip's scale word replayed from one CUDA graph, beside the
     same launches without it, PERF.md's time before the word, and the
     launches enqueued one by one); the flash
     forward and backward also at p=0 (their Philox share) and at ERNIE's
     attention (B=32, T=128, not causal, p=0.1); the keep-mask kernel at
     a hidden dropout's shape;
 10. the training main path: the JAX package's GPT-2 train bench
     (benchmarks/train_bench.py) on the port: gpt2-small at full width and
     depth (seeded weights, both dropouts 0.1) -> amp.decorate(O2,
     bfloat16) -> AdamW(lr=1e-4, weight_decay=0.01) -> make_train_step,
     fed by DataLoader(prefetch_to_device=2) over the bench's synthetic
     token stream, B=16, T=512: first 2 + 5 steps through the step's
     bodies run eagerly (the step as it ran before it was captured), then
     the captured step, one CUDA graph built at its first call and
     replayed, 3 warm-up and 10 timed steps, the launch and path counters
     zeroed just before and read just after (launches a step, launches
     through replays, capture ms, graph pool); each with a torch.profiler
     breakdown of one step; then, from one saved state, two steps through
     the captured step and two through its eager bodies (twice), at
     dropout 0.1 and on a fresh model at 0: losses, parameters and
     moments bit-equal, the steps' Philox words and masks different, a
     restored RNG state repeating the first;
 11. the same float32 weights with both dropouts 0, B=4, T=512, 3 steps
     through the captured step, once with the kernels and once with
     use_flash_attention and use_fused_optimizer off (which must launch
     nothing): the losses and the parameters must agree within the
     stated tolerances;
 12. the fused dropout-residual(+LN) kernels' device times at path B's
     shape (N=8192, Hd=768, bfloat16) and path A's (N=4096, Hd=768,
     float32), beside their bounds, their plain versions and the composed
     PyTorch route the flag replaces, and the backward's grid and the
     bytes of its partial rows;
 13. path B: phase 10 with FLAGS_use_fused_dropout_ln and FLAGS_fused_block
     on (12 / 12 / 24 launches of the fused forward, no-LN forward and
     backward a step), its step beside phase 10's; then phase 11 with the
     fused flags on in the kernel run;
 14. path A: the JAX package's ERNIE bench (train_bench.py bench_ernie)
     on the port: ernie-base at full width and depth (seeded weights,
     dropouts 0.1), B=32, T=128, AdamW(lr=1e-4, weight_decay=0.01),
     make_train_step with the MLM + NSP criterion, under
     amp.auto_cast(level="O2"), FLAGS_use_fused_dropout_ln on, eager
     bodies, captured step and graph against eager as in 10; then one
     forward in eval mode with a [B, T] padding mask (half of one row
     padded) and use_flash_attention on: every layer takes the plain
     attention (xla_sdpa), no flash kernel launches, and the output is
     bit-equal to the same call with the flag off;
 15. path A's kernels vs plain: float32, no dropout, 3 steps, as in 11;
 16. guards and eval on the training main path (phase 10's model,
     optimizer and loader, built again): (1) captured steps made with
     FLAGS_skip_nonfinite_steps off and on, 3 + 10 steps each (launches
     a step equal to phase 10's), then 20 pairs of steps and 20 pairs of
     the graph's replays alone (CUDA events), one of each way a pair, the
     order flipped every pair: step times and the pairs' differences
     beside phase 10's step, the card's clock and temperature before and
     after, one profiled step each way (the guard's kernels, and the
     device's idle time, off and on);
     (2) the NaN drill,
     PADDLE_TPU_CHAOS=nan_at_step:3 over 5 steps from a saved state
     through the captured graph: the loss NaN at step 3 only, that step
     alone skipped, parameters and both moments after it bit-equal to
     their values after step 2, AdamW launched 148 times every step, and
     steps 4-5 bit-equal to the same drill through the eager bodies; (3)
     the watchdog, step_watchdog_s=0.5 with hang_at_step:2:1.5 (warn):
     the dump names compiled train step 2 and the step finishes finite;
     (4) the OOM drill, oom:2: the call raises, a crash bundle with
     memory.json names jit_train and step 2, pt_oom_total rises by 1,
     and the next call replays with no build; (5) make_eval_step with
     the criterion in eval mode, B=16, T=512: one program, 10 timed
     replays (ms, tokens/s), the loss bit-equal to its eager body, the
     loss and logits held to the eager body with use_flash_attention off
     (the plain attention: 12 xla_sdpa, no flash launch), 12
     flash forward launches a call through replays, no backward or AdamW
     launch, the parameters untouched; (6) the jit_train and jit_eval
     retraces equal the programs built, pt_train_steps_total the steps
     run, and the flight recorder's last dispatch the last step;
 17. resumable training on the GPT-2 configuration: phase 10's model,
     O2 and loader with AdamW(LinearWarmup(CosineAnnealingDecay(1e-4,
     T_max=100), warmup_steps=4), weight_decay=0.01,
     ClipGradByGlobalNorm(1.0)) (`gpt2_recipe`): (a) the captured step,
     3 + 10 steps (one program, launches equal to phase 10's, the clip's
     scale in (0, 1]), its ms beside phase 10's, then the clip's cost as
     20 pairs of steps with an optimizer without the clip on the same
     model, in turns; (b) a sync save (host capture s, total s, bytes),
     one step, an async save (s it blocks, the steps while its write is
     in flight), a load of the sync save into the built step (s; the
     state bit-equal to the saved one) and the step after it bit-equal
     to the step after the save with no new build, the pt_ckpt_*
     counters; (c) the resume drill, each run a fresh process
     (`chip_smoke.py --resume-drill`, `resume_drill`): 3 epochs x 2
     steps in TrainEpochRange uninterrupted, then under
     PADDLE_TPU_CHAOS=sigterm_at_step:3 (exit 0 after epoch 1's save),
     then a relaunch that resumes at epoch 2: its losses and the sha256
     of its final parameters and moments bit-equal to the uninterrupted
     run's, dropout on; (d) bitflip_ckpt:1 on the newer of two saves:
     load_latest quarantines it and falls back (pt_ckpt_corrupt_total
     and pt_ckpt_fallback_total +1), then torn_write in epoch 1's save
     (the run dies by SIGKILL) and a relaunch from epoch 0 whose losses
     and final state equal the uninterrupted run's. Checkpoints go under
     a temporary directory, removed at the end of the phase.
 18. float16, GradScaler and the other optimizers: (a) the float16
     instances of rows 1t, 2, 3, 4-6 and 7 timed at the main path's shapes
     beside their bounds and PyTorch's float16 calls (phase 3 holds each
     against its plain version, and the flash backward under a loss scale
     of 2^15), then phase 10's GPT-2 path in float16 (decorate O2 float16,
     every step under auto_cast(O2, float16)) with the fused flags off and
     as path B: launches a step of the float16 instances only, graph
     against eager at dropout 0.1; (b) the reference's eager GradScaler
     recipe at full width (scale, backward, step, clear_grad; 20 steps,
     GradScaler(init_loss_scaling=2**15), no auto_cast as the recipe runs
     in the reference: a float16 loss): skipped steps, scale history,
     then the overflow drill (scale 2^24: the step skipped, parameters and
     moments bit-equal, the scale halved); (c) ERNIE-base (path A's
     setup) with Lamb(1e-4, lamb_weight_decay=0.01, LayerNorm and biases
     excluded) through the captured step, and 3 steps bit-equal to its
     eager bodies; (d) SGD, Momentum (and Nesterov), Lars, Adamax, Adagrad,
     Adadelta, RMSProp (and centered), Ftrl, DecayedAdagrad, ProximalGD and
     ProximalAdagrad on gpt2-small at 2 layers and full width, B=16, T=512,
     O2 bf16, LinearWarmup over CosineAnnealingDecay: 3 captured steps
     bit-equal to their eager bodies and a nan_at_step:2 drill under
     FLAGS_skip_nonfinite_steps (the state bit-equal across the skipped
     step); Dpsgd 3 eager steps, and make_train_step refusing it.
 19. ResNet-50 (`resnet_main`), the JAX package's bench_resnet50 at its
     on-chip shapes (train_bench.py:317-388) through the dygraph step:
     resnet50(num_classes=100), seeded weights, Momentum(0.01, 0.9),
     make_train_step, the batch RandomState(0) rand(B, 3, 224, 224) and
     randint(0, 100, (B, 1)). (a) float32, B=8, 3 steps from one state
     (parameters, velocities, running statistics, step count) through the
     captured step and twice through its eager bodies: losses,
     parameters, velocities and running statistics bit-equal; if the two
     eager runs or the graph differ, the check is made again with
     torch.backends.cudnn.deterministic on (cuDNN's weight-gradient
     algorithms may sum with atomics), and the run says so; (b) B=64 under
     auto_cast(level="O1", dtype="bfloat16") (the bench's amp_bf16_pass),
     3 warm-up and 20 timed steps of the captured step: step ms, images/s,
     MFU (3 x 4.1e9 x B FLOPs a step, train_bench.py:379-381), peak
     memory, one profiled step's device idle share and its groups
     (cuDNN convolutions, pooling, batch norm's reductions, elementwise),
     the Momentum update's device time alone (a graph replay); every
     parameter, velocity and running statistic float32; none of the
     port's kernels launched (the reference reaches no pl.pallas_call on
     this path); (c) the guard drill, FLAGS_skip_nonfinite_steps with
     nan_at_step:2 at B=16: step 2 skipped, parameters, velocities and
     every running statistic after it bit-equal to their values before
     it, step 3 moving them; (d) make_eval_step in eval() mode on the
     trained network: one program, replays timed, the loss and logits
     held to the eager eval forward, no running statistic written.
 20. Model.fit (`fit_main`), the hapi loop over the port's train step:
     (a) GPT-2-small at full width and depth, phase 10's setup with
     AdamW over LinearWarmup(1e-4, 4 steps), through
     `Model(net).prepare(opt, criterion).fit(TokenPairs, batch_size=16,
     shuffle=False, num_workers=2, num_iters=13, telemetry_dir=...,
     callbacks=[LRScheduler(by_step=True)])`: the first 13 batches of 2
     worker processes (spawned: CUDA is up) bit-equal to num_workers=0's
     and pinned; one program, launches a step equal to phase 10's (rows
     1t, 2, 3 12 each, row 7 148, row K 25), all through replays; the
     per-step losses bit-equal to a make_train_step loop over the same
     batches from the same seed; `tools/ptdoctor.py summary` over the
     telemetry directory showing `retraces: jit_train=1` and the last
     step; fit's step (host clock between batch ends, median of the last
     10) beside the loop's and phase 10's, pt_feed_stall_ms at 2 workers
     and at 0, one profiled fit step's device idle share; (b) the
     preemption drill in fresh processes (`--fit-drill`): GPT-2 cut to 2
     layers at full width, 2 epochs x 4 steps with auto_checkpoint_dir,
     SIGTERM (chaos sigterm_at_step:5) mid-epoch -> rc 0 and a committed
     preempt_ckpt; the relaunch resumes at epoch 1 step 2 and its losses
     and the sha256 of its parameters and AdamW moments are bit-equal to
     an uninterrupted fit's, dropout on; preempt_ckpt gone after; (c)
     ResNet-50 (phase 19's setup, auto_cast O1 bf16) through fit over a
     map-style set (`ImageSet`: sample i is RandomState(i)'s image) with
     4 workers (38.5 MB a batch through shared memory) and
     Accuracy(topk=(1, 5)), 3 + 20 steps: each step's top-1/top-5 equal
     to the stable rank of its labels among its logits; `evaluate` over 4
     batches equal to the eager eval forward, no running statistic
     written; `predict` over 2 batches equal to the eager logits;
     images/s beside phase 19's and the feed stall; (d) bench.py's
     bench_lenet_fit (LeNet, Adam(1e-3), CrossEntropyLoss, MNIST with
     PADDLE_TPU_SYNTH_SAMPLES=8192, B=256, 2 + 50 train_batch calls):
     images/s; then a one-epoch fit with Accuracy and ModelCheckpoint,
     and Model.load of its final.pdparams/.pdopt into a fresh Model: an
     evaluate bit-equal to the trained one's.

The line before the last is the kernel table as JSON (the float16
instances under their names + "_f16"); the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# tolerances of the kernel-vs-plain checks (max abs error)
TOL = {
    # float32 sums over up to 512 keys in another order
    "float32": 1e-4,
    # one bfloat16 rounding of outputs of magnitude up to ~3 (one ulp at
    # |o| in [2, 4) is 0.0156; at |o| >= 4 it is 0.031, which fails)
    "bfloat16": 2e-2,
    # float16 rounds 8 times finer; held to bfloat16's bound all the same
    "float16": 2e-2,
}
# greedy tokens may first differ only where the plain run's top-2 logit
# gap is below this: a near tie that summation order can flip. int8 adds
# the chance that a K/V element rounds to the other int8 neighbour.
TIE_TOL = {"float32": 1e-3, "int8": 1e-2}

# NVIDIA H100 SXM data-sheet peaks (dense), as the bound's denominators.
# int32: instructions a second, from the float32 rate: 67 TFLOP/s counts
# an FMA as 2 operations on 128 float32 lanes an SM a clock, and an SM of
# compute capability 9.0 has 64 int32 lanes a clock (the CUDA C++
# Programming Guide's arithmetic-instruction throughput table)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "int32": 67e12 / 2 / 2}
SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}
# int32 operations a lane makes in one Philox-4x32-10 call
# (attn_dropout.cuh), as nvcc compiles it for sm_90a (cuobjdump -sass of
# fdrln_bits_kernel<true>): a round is two IMAD.WIDE.U32, each a low and a
# high 32-bit product (4), and two LOP3 three-way XORs (2). The key
# schedule runs once a warp on the uniform datapath (UIADD3) and is not
# counted, nor are indexing and the stores.
PHILOX_INT_OPS = 10 * 6

# training-kernel checks, max abs error relative to the largest |value| of
# the plain version's output (at least 1):
REL_TOL = {
    # float32 sums over up to 512 keys in another order
    "float32": 2e-4,
    # bfloat16 outputs, rounded once on each side: a float32 difference
    # under one bfloat16 ulp of the largest value (2^-8 to 2^-7 of it)
    # shows as at most that one ulp, which this passes and two fail. The
    # tensor-core flash backward keeps its difference far below that by
    # taking M o p (P without dropout) and dS as bfloat16 hi + lo pairs;
    # the tensor-core forward rounds P once to bfloat16 for P V, about
    # 1e-3 of the largest output, under a quarter of this (the CPU mirrors
    # tests/test_torch_flash_bwd.py and test_torch_flash_fwd.py; the
    # latter also holds check_flash's bfloat16 cases to TOL)
    "bfloat16": 1e-2,
    # float16 outputs: one rounding is 2^-11, four times finer than
    # bfloat16's; held to bfloat16's tolerance, the reading printed beside
    # it
    "float16": 1e-2,
}
# the float16 backward under a loss scale: dO times this (GradScaler's
# default init_loss_scaling) must give finite dq, dk and dv wherever the
# plain float32 arithmetic rounds to a finite float16
LOSS_SCALE = 2.0 ** 15
# AdamW: the kernel rounds every operation on its own, as the plain rule
# does (no FMA contraction), so the parameter must be bit-equal; each
# moment element may differ from the plain one by at most this share of
# its size (one float32 ulp)
ADAMW_MOMENT_REL_TOL = 2 ** -23
# the bfloat16 cases at lr 1e-2 on parameters of size ~1e-2 must move at
# least this share of the elements, or the bit-equality shows nothing
ADAMW_MOVED_MIN = 0.9
# row 7's time in PERF.md before the clip's scale word (148 launches
# replayed from one graph, on an H100 80GB HBM3 at 700 W), printed beside
# the re-time
ADAMW_EARLIER_MS = 1.3858
# the clip scale the row-7 checks stage in the buffer's fifth word
ADAMW_CHECK_SCALE = 0.3711
# train_compare: max parameter difference after 3 float32 steps at lr
# 1e-4, between a sound reading (~1e-5: float32 sums in another order,
# amplified by Adam's normalised step) and the whole 3-step movement
# (~3e-4), which a run that skipped its updates would show
TRAIN_PARAM_TOL = 1e-4
TRAIN_LR = 1e-4
# ernie_compare: elements whose first-step |g| is at most this (ten times
# Adam's epsilon) are held within 2 * steps * lr (see compare_runs)
ADAM_NOISE_FLOOR = 1e-7
DROP_RATE_TOL = 0.002
# fused dropout-LN checks with bfloat16 outputs: one bfloat16 rounding of
# y, z and the gradients (2^-8 relative), plus the float32 differences
# that flip it, relative to the largest value (at least 1); float32
# outputs are held to 1e-4 the same way
FDRLN_BF16_REL_TOL = 2e-2
FDRLN_F32_REL_TOL = 1e-4

TPU_KERNELS = {
    "flash_fwd": "paddle_tpu/ops/pallas_kernels.py:324",
    "flash_fwd_train": "paddle_tpu/ops/pallas_kernels.py:324",
    "flash_bwd_dq": "paddle_tpu/ops/pallas_kernels.py:462",
    "flash_bwd_dkv": "paddle_tpu/ops/pallas_kernels.py:524",
    "fused_dropout_ln_fwd": "paddle_tpu/ops/pallas_kernels.py:768",
    "fused_dropout_residual_fwd": "paddle_tpu/ops/pallas_kernels.py:792",
    "fused_dropout_ln_bwd": "paddle_tpu/ops/pallas_kernels.py:800",
    "adamw": "paddle_tpu/ops/pallas_kernels.py:1044",
    # no TPU kernel: the reference draws a dropout's mask with jax.random
    "dropout_keep": "paddle_tpu/ops/nn_ops.py:577",
    "paged_decode": "paddle_tpu/ops/pallas_kernels.py:1738",
    "paged_decode_int8": "paddle_tpu/ops/pallas_kernels.py:1746",
}
SOURCES = {
    "flash_fwd": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
    "flash_fwd_train": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
    "flash_bwd_dq": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "paddle_tpu_torch/ops/csrc/flash_bwd.cu",
    "fused_dropout_ln_fwd": "paddle_tpu_torch/ops/csrc/fused_dropout_ln.cu",
    "fused_dropout_residual_fwd":
        "paddle_tpu_torch/ops/csrc/fused_dropout_ln.cu",
    "fused_dropout_ln_bwd": "paddle_tpu_torch/ops/csrc/fused_dropout_ln.cu",
    "adamw": "paddle_tpu_torch/ops/csrc/adamw.cu",
    "dropout_keep": "paddle_tpu_torch/ops/csrc/fused_dropout_ln.cu",
    "paged_decode": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
    "paged_decode_int8": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
}
KERNEL_ORDER = ("flash_fwd", "flash_fwd_train", "flash_bwd_dq",
                "flash_bwd_dkv", "fused_dropout_ln_fwd",
                "fused_dropout_residual_fwd", "fused_dropout_ln_bwd", "adamw",
                "dropout_keep", "paged_decode", "paged_decode_int8")
FUSED_KERNELS = ("fused_dropout_ln_fwd", "fused_dropout_residual_fwd",
                 "fused_dropout_ln_bwd")
# the training kernels' float16 instances, counted apart from the others
# (cuda_kernels.F16), each in the kernels line under its own name
F16_ORDER = tuple(n + "_f16" for n in (
    "flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv", "fused_dropout_ln_fwd",
    "fused_dropout_residual_fwd", "fused_dropout_ln_bwd", "adamw"))

# the training main path: the JAX package's GPT-2 train bench
TRAIN_B, TRAIN_T, TRAIN_WARMUP, TRAIN_STEPS = 16, 512, 3, 10
# the same paths' step bodies run eagerly, for the step as it ran before
# it was captured
EAGER_WARMUP, EAGER_STEPS = 2, 5
# the ERNIE-base pretraining path: the JAX package's ERNIE bench
ERNIE_B, ERNIE_T = 32, 128
# the serving main path's prefill buckets (GenerationEngine's
# prefill_buckets), each a query length of the flash forward
BUCKETS = (32, 128, 256)
DROPOUT = 0.1
SEED, OFFSET = 0x1234_5678_9ABC_DEF0, 7       # kernel checks' dropout key
# ... which the kernels read from a Philox word on the card holding (SEED,
# OFFSET - DELTA), with the call's delta DELTA (made in main)
DELTA = 3
WORD = None

VOCAB_TOKENS = 50257          # GPT-2's tokenizer; the table is padded


def say(*parts):
    print(*parts, flush=True)


def require(cond, msg):
    if not cond:
        raise SystemExit("chip_smoke FAILED: " + msg)


def ptxas_registers(logs, needles):
    """(source, kernel entry, registers, spill line) from nvcc's -Xptxas -v
    output, for the entries whose mangled name holds one of `needles`."""
    out = []
    for name, log in sorted(logs.items()):
        entry = spill = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry, spill = m.group(1), None
            elif "spill stores" in line:
                spill = line.strip()
            else:
                m = re.search(r"Used (\d+) registers", line)
                if m and entry and any(n in entry for n in needles):
                    out.append((name, entry, int(m.group(1)), spill))
                    entry = None
    return out


# ---------------------------------------------------------------------------
# timing


class Timer:
    """Device time of a callable: each run queues `reps` calls behind a
    sleep kernel long enough to cover their enqueue, so the launches run
    back to back and the events measure the device, not the host."""

    def __init__(self, torch):
        self.torch = torch
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        e.synchronize()
        self.cycles_per_ms = 10_000_000 / s.elapsed_time(e)

    def ms(self, fn, runs=25, reps=10):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        cycles = int(self.cycles_per_ms * (2.0 * host_ms + 0.5))
        out = []
        for _ in range(runs):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(cycles)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e) / reps)
        return statistics.median(out)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel checks


def qkv_views(torch, B, T, H, D, dtype, gen):
    """q, k, v [B, H, T, D] as the model hands them over: views of one
    fused qkv tensor [B, T, 3, H, D]."""
    qkv = torch.randn((B, T, 3, H, D), generator=gen, device="cuda")
    return qkv.to(dtype).permute(2, 0, 3, 1, 4).unbind(0)


def check_flash(torch, ck, gen):
    worst = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    cases = [(1, T, T, 12, 64, True) for T in (32, 128, 256)] + [
        (2, 40, 40, 12, 64, True),           # ragged edge
        (1, 16, 48, 4, 64, True),            # bottom-right causal, Tq < Tk
        (1, 100, 100, 4, 64, False),
        (1, 64, 64, 2, 128, True),           # widest head the kernel takes
        (1, 33, 33, 2, 24, True)]            # head_dim not a multiple of 32
    # the training main path's attention, which make_eval_step's forward
    # (phase 16) sends through this wrapper: gpt2-small in bfloat16
    train_case = (TRAIN_B, TRAIN_T, TRAIN_T, 12, 64, True)
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16),
                              ("float16", torch.float16)):
        for B, Tq, Tk, H, D, causal in cases + (
                [train_case] if dtype_name != "float32" else []):
            q, _, _ = qkv_views(torch, B, Tq, H, D, dtype, gen)
            _, k, v = qkv_views(torch, B, Tk, H, D, dtype, gen)
            got = ck.flash_attention(q, k, v, causal)
            want = ck.flash_attention_plain(q, k, v, causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            require(got.dtype == dtype and got.shape == want.shape,
                    "flash_fwd output type or shape")
            require(err <= TOL[dtype_name],
                    "flash_fwd %s B=%d Tq=%d Tk=%d H=%d D=%d causal=%s: "
                    "max abs err %.3g > %.3g" % (dtype_name, B, Tq, Tk, H,
                                                 D, causal, err,
                                                 TOL[dtype_name]))
            worst[dtype_name] = max(worst[dtype_name], err)
    for name, err in worst.items():
        say("check flash_fwd %s: max abs err %.3g (tol %.0e) over %d cases%s"
            % (name, err, TOL[name], len(cases) + (name != "float32"),
               ", one at B=%d T=%d H=12 D=64 causal" % (TRAIN_B, TRAIN_T)
               if name != "float32" else ""))
    return worst["float32"]


def abs_rel_err(got, want):
    """(max |got - want|, that over max(1, max |want|))."""
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def check_dropout_bits(torch, ck):
    """The kernel's bits equal the plain Philox bit for bit, and drop at
    rate p at the main path's shapes."""
    for BH, Tq, Tk in ((6, 37, 50), (2, 4, 1)):
        got = ck.attn_dropout_bits(WORD, DELTA, BH, Tq, Tk)
        want = ck.attn_dropout_bits_plain(SEED, OFFSET, BH, Tq, Tk,
                                          device="cuda")
        require(torch.equal(got, want), "attn_dropout_bits %s differ from "
                "the plain Philox" % ((BH, Tq, Tk),))
    bits = ck.attn_dropout_bits(WORD, DELTA, TRAIN_B * 12, TRAIN_T, TRAIN_T)
    thr = min(int(DROPOUT * 2 ** 32), 2 ** 32 - 1)
    rate = (bits < thr).double().mean().item()
    require(abs(rate - DROPOUT) <= DROP_RATE_TOL,
            "dropout rate %.5f, want %.3f +- %.3f" % (rate, DROPOUT,
                                                       DROP_RATE_TOL))
    say("check attn_dropout_bits: bit-equal to the plain Philox; drop rate "
        "%.5f at [%d, %d, %d] (want %.3f +- %.3f)"
        % (rate, TRAIN_B * 12, TRAIN_T, TRAIN_T, DROPOUT, DROP_RATE_TOL))


def check_flash_train(torch, ck, gen):
    """Training forward (o, lse) and backward (dq, dk, dv) against the
    plain versions fed the kernels' own dropout bits; the backward plain
    versions take the kernel's o and lse, so each kernel is held alone.
    The float16 instances (names + ck.F16) at every case the bfloat16 ones
    take."""
    names = ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv")
    names += tuple(n + ck.F16 for n in names)
    worst = {n: 0.0 for n in names}            # relative, for the checks
    worst_abs = {n: 0.0 for n in names}        # absolute, for the table
    worst_at = {n: "" for n in names}          # the case of the worst
    count = {n: 0 for n in names}
    cases = [(2, 64, 64, 4, 64, True),
             (1, 200, 200, 2, 64, True),          # ragged T
             (1, 48, 96, 2, 64, True),            # bottom-right, Tq < Tk
             (1, 100, 100, 2, 64, False),
             (1, 64, 64, 2, 128, True),           # widest head
             (1, 33, 33, 2, 24, True),            # D not a multiple of 32
             (2, 512, 512, 2, 64, True)]          # main path's T
    runs = [(dn, dt, c, p) for dn, dt in (("float32", torch.float32),
                                          ("bfloat16", torch.bfloat16))
            for c in cases for p in (0.0, DROPOUT)]
    # bfloat16 only (the tensor-core kernels): GPT-2's and ERNIE's
    # attention as their training steps launch it, and a head dim that is
    # not a multiple of 8 (rows not 16-byte aligned: the kernels' element
    # loads and stores)
    runs += [("bfloat16", torch.bfloat16, (TRAIN_B, TRAIN_T, TRAIN_T, 12, 64,
                                           True), DROPOUT),
             ("bfloat16", torch.bfloat16, (ERNIE_B, ERNIE_T, ERNIE_T, 12, 64,
                                           False), DROPOUT)]
    runs += [("bfloat16", torch.bfloat16, (1, 72, 72, 2, 20, True), p)
             for p in (0.0, DROPOUT)]
    runs += [("float16", torch.float16) + r[2:] for r in runs
             if r[0] == "bfloat16"]
    for dtype_name, dtype, (B, Tq, Tk, H, D, causal), p in runs:
        sfx = ck.F16 if dtype == torch.float16 else ""
        tol = REL_TOL[dtype_name]
        q, _, _ = qkv_views(torch, B, Tq, H, D, dtype, gen)
        _, k, v = qkv_views(torch, B, Tk, H, D, dtype, gen)
        do = torch.randn((B, H, Tq, D), generator=gen,
                         device="cuda").to(dtype)
        bits = (ck.attn_dropout_bits(WORD, DELTA, B * H, Tq, Tk)
                if p else None)
        o, lse = ck.flash_fwd_train(q, k, v, causal, p, WORD, DELTA)
        dq, delta = ck.flash_bwd_dq(q, k, v, o, do, lse, causal, p, WORD,
                                    DELTA)
        dk, dv = ck.flash_bwd_dkv(q, k, v, do, lse, delta, causal, p, WORD,
                                  DELTA)
        o_ref, lse_ref = ck.flash_fwd_train_plain(q, k, v, causal, p, bits)
        dq_ref, delta_ref = ck.flash_bwd_dq_plain(q, k, v, o, do, lse,
                                                  causal, p, bits)
        dk_ref, dv_ref = ck.flash_bwd_dkv_plain(q, k, v, do, lse, delta_ref,
                                                causal, p, bits)
        torch.cuda.synchronize()
        pairs = {"flash_fwd_train" + sfx: ((o, o_ref), (lse, lse_ref)),
                 "flash_bwd_dq" + sfx: ((dq, dq_ref), (delta, delta_ref)),
                 "flash_bwd_dkv" + sfx: ((dk, dk_ref), (dv, dv_ref))}
        for t in (o, dq, dk, dv):
            require(t.dtype == dtype
                    and bool(torch.isfinite(t.float()).all()),
                    "flash training kernels: non-finite or wrong type")
        for name, outs in pairs.items():
            ea, er = (max(x) for x in zip(*(abs_rel_err(g, w)
                                            for g, w in outs)))
            case = "%s B=%d Tq=%d Tk=%d H=%d D=%d causal=%s p=%g" % (
                dtype_name, B, Tq, Tk, H, D, causal, p)
            require(er <= tol, "%s %s: rel err %.3g > %.3g"
                    % (name, case, er, tol))
            if er > worst[name] or not worst_at[name]:
                worst[name], worst_at[name] = er, case
            worst_abs[name] = max(worst_abs[name], ea)
            count[name] += 1
    for name, err in worst.items():
        say("check %s: max rel err %.3g at %s (tol f32 %.0e, bf16 %.0e, "
            "f16 %.0e), max abs err %.3g, over %d cases, p in {0, %g}"
            % (name, err, worst_at[name], REL_TOL["float32"],
               REL_TOL["bfloat16"], REL_TOL["float16"], worst_abs[name],
               count[name], DROPOUT))
    return worst_abs


def check_flash_f16_range(torch, ck, gen):
    """The float16 flash backward under a loss scale: dO of a GradScaler
    step (LOSS_SCALE times a gradient of unit size, clamped to float16's
    range, which is all dO can hold) against values of size ~4, so that
    dS = p (dP - Delta) / 8 reaches past float16's 65504 in some rows: the
    kernels' per-row power-of-two scaling of dS must absorb it. The main
    path's T and head size, causal, p in {0, 0.1}. Where the plain
    version's float32 dq, dk and dv round to finite float16 values, the
    kernels' must be finite and within REL_TOL["float16"] of them
    (relative to the largest finite value); where the plain version
    overflows float16, so may the kernels. Prints the largest |dS| of the
    plain arithmetic and how many of its elements pass 65504."""
    B, H, T, D = 2, 4, TRAIN_T, 64
    dt = torch.float16
    worst, ds_max, n_big, n_fin = 0.0, 0.0, 0, 0
    for p in (0.0, DROPOUT):
        q, k, v = qkv_views(torch, B, T, H, D, dt, gen)
        v = (v.float() * 4.0).to(dt)
        do = (torch.randn((B, H, T, D), generator=gen, device="cuda")
              * LOSS_SCALE).clamp(-60000, 60000).to(dt)
        bits = ck.attn_dropout_bits(WORD, DELTA, B * H, T, T) if p else None
        o, lse = ck.flash_fwd_train(q, k, v, True, p, WORD, DELTA)
        dq, delta = ck.flash_bwd_dq(q, k, v, o, do, lse, True, p, WORD,
                                    DELTA)
        dk, dv = ck.flash_bwd_dkv(q, k, v, do, lse, delta, True, p, WORD,
                                  DELTA)
        dq_ref, delta_ref = ck.flash_bwd_dq_plain(q, k, v, o, do, lse, True,
                                                  p, bits)
        dk_ref, dv_ref = ck.flash_bwd_dkv_plain(q, k, v, do, lse, delta_ref,
                                                True, p, bits)
        pr, _, dpr = ck._bwd_terms(q, k, v, do, lse, True, p, bits)
        ds = (pr * (dpr - delta_ref.reshape(B, H, T, 1)) * (D ** -0.5)).abs()
        ds_max = max(ds_max, ds.max().item())
        n_big += int((ds > 65504).sum().item())
        del pr, dpr, ds
        torch.cuda.synchronize()
        for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                                ("dv", dv, dv_ref)):
            fin = torch.isfinite(want.float())
            require(bool(torch.isfinite(got.float())[fin].all()),
                    "flash backward f16 under a loss scale of %g, p=%g: %s "
                    "non-finite where the plain version is finite"
                    % (LOSS_SCALE, p, name))
            w = want.float()[fin]
            err = (got.float()[fin] - w).abs().max().item() / max(
                1.0, w.abs().max().item())
            require(err <= REL_TOL["float16"], "flash backward f16 under a "
                    "loss scale, p=%g: %s rel err %.3g > %.3g"
                    % (p, name, err, REL_TOL["float16"]))
            worst = max(worst, err)
            n_fin += int(fin.sum().item())
    require(n_big > 0, "the loss-scale check's dS stayed below 65504: it "
            "shows nothing")
    say("check flash backward f16 under a loss scale of %g (dO = %g x "
        "N(0, 1) clamped to 60000, |v| ~ 4, B=%d H=%d T=%d D=%d causal, p 0 "
        "and %g): largest |dS| %.6g, %d elements past float16's 65504; dq, "
        "dk, dv finite wherever the plain float32 arithmetic rounds finite "
        "(%d elements), max rel err %.3g (tol %.0e)"
        % (LOSS_SCALE, LOSS_SCALE, B, H, T, D, DROPOUT, ds_max, n_big,
           n_fin, worst, REL_TOL["float16"]))


def step_scalars(torch, ck, lr, t, scale=1.0):
    """A scalar buffer on the card holding the step's (lr, c1, c2, go,
    scale), as the optimizer stages it, with the clip's scale written
    over the staged 1."""
    from paddle_tpu_torch.framework.device import write_values
    sc = torch.empty(5, device="cuda")
    vals = ck.adam_step_scalars(lr, t, 0.9, 0.999)
    vals[ck.SCALE] = scale
    write_values(sc, vals)
    return sc


def check_adamw(torch, ck, gen):
    """The kernel, reading lr, c1 and c2 from a scalar buffer on the card,
    against the plain rule with host lr and t: parameter bit-equal,
    moments within one float32 ulp. Each case runs at lr 1e-4 on
    parameters of size ~1 (the main path's lr, where a bfloat16 parameter
    mostly does not move) and at lr 1e-2 on parameters of size ~1e-2,
    where it must. Then five steps t = 1..5 with the lr changed after the
    second, the buffer rewritten before each: the kernel and the plain
    rule reading the same buffer (the route with use_fused_optimizer off)
    against the plain rule with host arguments."""
    worst_p = {"adamw": 0.0, "adamw" + ck.F16: 0.0}
    worst_m = 0.0
    moved_min = 1.0
    n = 0
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16),
                              ("float16", torch.float16)):
        for lr, pscale in ((1e-4, 1.0), (1e-2, 1e-2)):
            for coeff in (0.0, 0.01):
                for t in (1, 1000):
                    for numel in (7, 768, 2304 * 768):
                        p = (torch.randn(numel, generator=gen, device="cuda")
                             * pscale).to(dtype)
                        g = (torch.randn(numel, generator=gen, device="cuda")
                             * 1e-2).to(dtype)
                        m1 = torch.randn(numel, generator=gen,
                                         device="cuda") * 1e-3
                        m2 = torch.rand(numel, generator=gen,
                                        device="cuda") * 1e-5
                        kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8,
                                  coeff=coeff)
                        ka = [x.clone() for x in (p, g, m1, m2)]
                        pa = [x.clone() for x in (p, g, m1, m2)]
                        ck.adamw(*ka, step_scalars(torch, ck, lr, t), **kw)
                        ck.adamw_plain(*pa, lr, t, **kw)
                        torch.cuda.synchronize()
                        what = "adamw %s lr=%g coeff=%g t=%d numel=%d" % (
                            dtype_name, lr, coeff, t, numel)
                        err_p = (ka[0].float() - pa[0].float()).abs() \
                            .max().item()
                        require(torch.equal(ka[0], pa[0]),
                                "%s: parameter differs from the plain rule "
                                "by %.3g" % (what, err_p))
                        key = "adamw" + (ck.F16 if dtype == torch.float16
                                         else "")
                        worst_p[key] = max(worst_p[key], err_p)
                        err_m = max(((ka[i] - pa[i]).abs()
                                     / pa[i].abs().clamp_min(1e-30)).max()
                                    .item() for i in (2, 3))
                        require(err_m <= ADAMW_MOMENT_REL_TOL,
                                "%s: moment rel err %.3g > %.3g"
                                % (what, err_m, ADAMW_MOMENT_REL_TOL))
                        worst_m = max(worst_m, err_m)
                        if dtype != torch.float32 and lr == 1e-2 \
                                and numel > 7:
                            moved = (ka[0] != p).double().mean().item()
                            require(moved >= ADAMW_MOVED_MIN,
                                    "%s: only %.3f of the parameter moved"
                                    % (what, moved))
                            moved_min = min(moved_min, moved)
                        n += 1
    say("check adamw: parameters bit-equal to the plain rule, moments max "
        "rel err %.3g (tol %.3g) over %d cases (float32, bfloat16, "
        "float16); bfloat16 and float16 at lr 1e-2 moved >= %.4f of the "
        "elements (want >= %.2f)"
        % (worst_m, ADAMW_MOMENT_REL_TOL, n, moved_min, ADAMW_MOVED_MIN))
    from paddle_tpu_torch.framework.device import write_values
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        numel = 2304 * 768
        p = (torch.randn(numel, generator=gen, device="cuda") * 1e-2).to(dtype)
        ka, sa, pa = ([p.clone(), torch.zeros(numel, device="cuda"),
                       torch.zeros(numel, device="cuda")] for _ in range(3))
        sc = torch.empty(5, device="cuda")
        for t in range(1, 6):
            lr = 1e-2 if t <= 2 else 3e-3
            g = (torch.randn(numel, generator=gen, device="cuda")
                 * 1e-2).to(dtype)
            write_values(sc, ck.adam_step_scalars(lr, t, 0.9, 0.999))
            ck.adamw(ka[0], g, ka[1], ka[2], sc, **kw)
            ck.adamw_plain_scalars(sa[0], g, sa[1], sa[2], sc, **kw)
            ck.adamw_plain(pa[0], g, pa[1], pa[2], lr, t, **kw)
            torch.cuda.synchronize()
            what = "adamw %s t=%d lr=%g (scalar buffer)" % (dtype, t, lr)
            require(torch.equal(ka[0], pa[0]) and torch.equal(sa[0], pa[0]),
                    "%s: parameter differs from the plain rule" % what)
            require(all(torch.equal(a, b) for a, b in ((sa[1], pa[1]),
                                                       (sa[2], pa[2]))),
                    "%s: the plain rule on the buffer differs from it with "
                    "host arguments" % what)
            err_m = max(((ka[i] - pa[i]).abs()
                         / pa[i].abs().clamp_min(1e-30)).max().item()
                        for i in (1, 2))
            require(err_m <= ADAMW_MOMENT_REL_TOL, "%s: moment rel err %.3g"
                    % (what, err_m))
            n += 1
    say("check adamw over t = 1..5 (lr 1e-2, then 3e-3 from t = 3) through "
        "the scalar buffer, float32, bfloat16 and float16: kernel "
        "parameters and the "
        "plain rule on the buffer bit-equal to the plain rule with host lr "
        "and t")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        numel = 2304 * 768
        p = (torch.randn(numel, generator=gen, device="cuda") * 1e-2).to(dtype)
        g = (torch.randn(numel, generator=gen, device="cuda") * 1e-2).to(dtype)
        m1 = torch.randn(numel, generator=gen, device="cuda") * 1e-3
        m2 = torch.rand(numel, generator=gen, device="cuda") * 1e-5
        sc = step_scalars(torch, ck, 1e-2, 3)
        sc[3].zero_()                   # the guard skipped this step
        for fn in (ck.adamw, ck.adamw_plain_scalars):
            args = [x.clone() for x in (p, g, m1, m2)]
            fn(*args, sc, **kw)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in
                        zip(args, (p, g, m1, m2))),
                    "%s %s with the guard word at 0 changed its state"
                    % (fn.__name__, dtype))
    say("check adamw guard word: at 0 the kernel and the plain rule leave "
        "the parameter and both moments bit-equal to their inputs (float32, "
        "bfloat16 and float16, %d elements); at 1 (every case above) the "
        "kernel is "
        "bit-equal to the plain rule" % (2304 * 768))
    check_adamw_scale(torch, ck, gen)
    return worst_p


def check_adamw_scale(torch, ck, gen):
    """The clip's scale word (ClipGradByGlobalNorm): the kernel launched
    with scaled=True on a buffer whose fifth word is ADAMW_CHECK_SCALE,
    against the plain rule on the same buffer and against the composed
    route, the gradient widened and multiplied by the scale in float32
    (the reference's product) and then the unscaled plain rule with host
    lr and t: parameters bit-equal, moments within one float32 ulp; the
    plain rule on the buffer bit-equal to the composed route. Float32 and
    bfloat16 and float16 gradients, lr 1e-2 on parameters of size ~1e-2,
    t = 3."""
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)
    worst_m = 0.0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for numel in (7, 2304 * 768):
            p = (torch.randn(numel, generator=gen, device="cuda")
                 * 1e-2).to(dtype)
            g = torch.randn(numel, generator=gen, device="cuda").to(dtype)
            m1 = torch.randn(numel, generator=gen, device="cuda") * 1e-3
            m2 = torch.rand(numel, generator=gen, device="cuda") * 1e-5
            sc = step_scalars(torch, ck, 1e-2, 3, ADAMW_CHECK_SCALE)
            ka, sa, pa = ([x.clone() for x in (p, m1, m2)] for _ in range(3))
            ck.adamw(ka[0], g, ka[1], ka[2], sc, scaled=True, **kw)
            ck.adamw_plain_scalars(sa[0], g, sa[1], sa[2], sc, scaled=True,
                                   **kw)
            composed = g.float() * sc[ck.SCALE]
            ck.adamw_plain(pa[0], composed, pa[1], pa[2], 1e-2, 3, **kw)
            unscaled = p.clone()
            ck.adamw(unscaled, g, m1.clone(), m2.clone(), sc, **kw)
            torch.cuda.synchronize()
            what = "adamw %s numel=%d scale=%g" % (dtype, numel,
                                                  ADAMW_CHECK_SCALE)
            require(torch.equal(ka[0], pa[0]) and torch.equal(sa[0], pa[0]),
                    "%s: parameter differs from the composed float32 "
                    "product" % what)
            require(all(torch.equal(a, b) for a, b in ((sa[1], pa[1]),
                                                       (sa[2], pa[2]))),
                    "%s: the plain rule on the buffer differs from the "
                    "composed route" % what)
            err_m = max(((ka[i] - pa[i]).abs()
                         / pa[i].abs().clamp_min(1e-30)).max().item()
                        for i in (1, 2))
            require(err_m <= ADAMW_MOMENT_REL_TOL,
                    "%s: moment rel err %.3g" % (what, err_m))
            require(numel == 7 or not torch.equal(unscaled, ka[0]),
                    "%s: the scale changed nothing" % what)
            worst_m = max(worst_m, err_m)
    say("check adamw clip scale word (%g, t = 3, lr 1e-2): kernel and the "
        "plain rule on the buffer bit-equal to the composed float32 product "
        "g * scale and the plain rule (float32, bfloat16 and float16 "
        "gradients), "
        "moments max rel err %.3g; the scale moved the parameters"
        % (ADAMW_CHECK_SCALE, worst_m))


def check_dropout_keep(torch, ck):
    """The keep mask of F.dropout on the card (`dropout_keep`: the fused
    bits kernel under its own tag) bit-equal to its plain version at the
    training paths' shapes (hidden; ERNIE's feed-forward activation), at
    the kernels' drop rate."""
    shapes = ((TRAIN_B, TRAIN_T, 768), (ERNIE_B, ERNIE_T, 768),
              (ERNIE_B, ERNIE_T, 3072), (3, 5, 7))
    for shape in shapes:
        for p in (DROPOUT, 0.5):
            got = ck.dropout_keep(WORD, DELTA, shape, p)
            want = ck.dropout_keep_plain(SEED, OFFSET, shape, p,
                                         device="cuda")
            require(got.dtype == torch.bool and torch.equal(got, want),
                    "dropout_keep %s p=%g differs from its plain version"
                    % (shape, p))
    rate = 1.0 - ck.dropout_keep(WORD, DELTA, (TRAIN_B, TRAIN_T, 768),
                                 DROPOUT).double().mean().item()
    require(abs(rate - DROPOUT) <= DROP_RATE_TOL, "dropout_keep rate %.5f"
            % rate)
    say("check dropout_keep: bit-equal to the plain Philox mask at %s, p "
        "%g and 0.5; drop rate %.5f (want %.3f +- %.3f)"
        % (list(shapes), DROPOUT, rate, DROPOUT, DROP_RATE_TOL))
    return 0.0


def paged_inputs(torch, quantized, lens, gen, nan_tail=True, B=8, H=12,
                 T=512, D=64):
    """Decode-step inputs; the cache past each slot's lens is NaN garbage
    when `nan_tail` (uninitialized pages, the hostile case)."""
    dev = "cuda"
    q, nk, nv = (torch.randn((B, H, 1, D), generator=gen, device=dev)
                 for _ in range(3))
    kf = torch.randn((B, H, T, D), generator=gen, device=dev)
    vf = torch.randn((B, H, T, D), generator=gen, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    dead = (torch.arange(T, device=dev)[None, :]
            >= lens_t[:, None])[:, None, :] & nan_tail        # [B, 1, T]
    if quantized:
        from paddle_tpu_torch.ops.cuda_kernels import quantize_kv
        kc, ks = quantize_kv(kf)
        vc, vs = quantize_kv(vf)
        ks = ks.masked_fill(dead, float("nan"))
        vs = vs.masked_fill(dead, float("nan"))
        return [q, kc, vc, lens_t, nk, nv, ks, vs]
    kf = kf.masked_fill(dead[..., None], float("nan"))
    vf = vf.masked_fill(dead[..., None], float("nan"))
    return [q, kf, vf, lens_t, nk, nv, None, None]


def clone_args(args):
    return [None if a is None else a.clone() for a in args]


def check_paged(torch, ck, quantized, gen):
    """Idle slot, inside a block, both sides of a 128-row block edge, a
    mid length, T-1 and T (full clamp), NaN garbage past every lens; the
    kernel's chunk edges for this cache (lens 0, chunk - 1, chunk, chunk +
    1, 2 chunk, T - 1, T) and a batch whose every slot is at T, so every
    chunk is live; then a cache depth and head width no power-of-two block
    tiles (T=100, D=24), which the gate also sends to the kernel, and a
    cache deeper than any shared array could hold (T=16384, lens near
    T)."""
    name = "paged_decode_int8" if quantized else "paged_decode"
    worst = 0.0
    serving = dict(B=8, H=12, T=512, D=64)
    geometry = (ck.paged_int8_geometry if quantized
                else ck.paged_split_geometry)
    c = geometry(64)[1]
    for lens, shape in (([0, 5, 127, 128, 300, 511, 512, 200], serving),
                        ([0, c - 1, c, c + 1, 2 * c, 511, 512, 3 * c + 1],
                         serving),
                        ([512] * 8, serving),
                        ([0, 57, 99, 100], dict(B=4, H=2, T=100, D=24)),
                        ([16384, 16001], dict(B=2, H=2, T=16384, D=64))):
        args = paged_inputs(torch, quantized, lens, gen, **shape)
        ka, pa = clone_args(args), clone_args(args)
        got = ck.paged_decode(*ka)
        want = ck.paged_decode_plain(*pa)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        require(bool(torch.isfinite(got).all()),
                "%s %s: non-finite output" % (name, shape))
        require(err <= TOL["float32"], "%s %s: max abs err %.3g > %.3g"
                % (name, shape, err, TOL["float32"]))
        # the in-place append: same rows written, bit for bit, nothing else
        for i in (1, 2, 6, 7) if quantized else (1, 2):
            a, b = ka[i], pa[i]
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            require(bool(same.all()), "%s %s: cache buffer %d differs from "
                    "the plain version's after the append" % (name, shape, i))
        say("check %s %s: max abs err %.3g (tol %.0e), lens %s, cache rows "
            "bit-equal" % (name, shape, err, TOL["float32"], lens))
        worst = max(worst, err)
    return worst


def check_gates(torch, ck, gen):
    """On the card a gate gives way to the plain version only when its
    flag is off, or, for the flash gate, where the reference's gate does
    for what the call computes (an additive mask, dropout p=1): an input
    its kernel does not take raises."""
    q, k, v = qkv_views(torch, 1, 32, 2, 64, torch.float32, gen)
    routed = [("additive mask", lambda: ck.flash_attention_or_none(
                  q, k, v, torch.zeros(32, 32, device="cuda"), True)),
              ("dropout p=1", lambda: ck.flash_attention_or_none(
                  q, k, v, None, True, dropout_p=1.0))]
    bad = [("float16 q with float32 k, v", lambda: ck.flash_attention_or_none(
                q.half(), k, v, None, True)),
           ("D=160", lambda: ck.flash_attention_or_none(
                *qkv_views(torch, 1, 8, 1, 160, torch.float32, gen), None,
                True))]
    bad.append(("dropout p=-0.1", lambda: ck.flash_attention_or_none(
        q, k, v, None, True, dropout_p=-0.1)))
    qh = q.detach().double()
    bad.append(("float64 backward", lambda: ck.flash_bwd_dq(
        qh, qh, qh, qh, qh, torch.zeros(64, device="cuda"), True)))
    w = torch.zeros(16, device="cuda", dtype=torch.float64)
    m = torch.zeros(16, device="cuda")
    sc = torch.zeros(4, device="cuda")
    bad.append(("float64 adamw", lambda: ck.fused_adamw_or_none(
        w, w, sc, m, m, beta1=0.9, beta2=0.999, epsilon=1e-8,
        coeff=0.0)))
    args = paged_inputs(torch, False, [3, 4], gen, B=2, H=2, T=64, D=64)
    args[3] = args[3].long()
    bad.append(("int64 lens",
                lambda: ck.paged_decode_attention_or_none(*args)))
    before = ck.launch_counts()
    for what, call in bad:
        try:
            call()
        except ValueError:
            continue
        raise SystemExit("chip_smoke FAILED: a gate took %s on the card "
                         "without raising" % what)
    for what, call in routed:
        require(call() is None, "the flash gate took %s on the card" % what)
    require(ck.launch_counts() == before, "a rejected input launched")
    say("check gates: %d inputs the kernels do not take raise on the card; "
        "%s go to the plain attention, launching nothing"
        % (len(bad), " and ".join(w for w, _ in routed)))


# ---------------------------------------------------------------------------
# kernel timings


def time_flash(torch, ck, F, timer, gen, T):
    q, k, v = qkv_views(torch, 1, T, 12, 64, torch.float32, gen)
    B, H, D = 1, 12, 64
    nbytes = 4 * B * H * T * D * 4
    flops = 4 * D * B * H * (T * (T + 1) // 2)
    bound, by = bound_ms(nbytes, flops, "float32")
    return {
        "ms": timer.ms(lambda: ck.flash_attention(q, k, v, True)),
        "plain_ms": timer.ms(lambda: ck.flash_attention_plain(q, k, v,
                                                              True)),
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": bound, "bound_by": by}


def time_paged(torch, ck, F, timer, gen, quantized, lens):
    """Times at the main path's shapes with `lens` as the live lengths.
    Eight copies of the inputs are used in turn (over 50 MB, the L2), so
    each launch finds its cache cold, as a decode step does."""
    sets = [paged_inputs(torch, quantized, lens, gen, nan_tail=False)
            for _ in range(8)]
    B, H, T, D = sets[0][1].shape
    esize = 1 if quantized else 4
    nbytes = flops = 0
    for ln in lens:
        cl = min(ln, T - 1)
        rows = cl * (2 * D * esize + (8 if quantized else 0))
        io = 3 * D * 4 + D * 4 + 2 * D * esize + (8 if quantized else 0)
        nbytes += H * (rows + io) + 4
        flops += H * 4 * D * (cl + 1)
    bound, by = bound_ms(nbytes, flops, "float32")
    turn = [0]

    def rotating(fn):
        def call():
            a = sets[turn[0] % len(sets)]
            turn[0] += 1
            fn(a)
        return call

    out = {
        "ms": timer.ms(rotating(lambda a: ck.paged_decode(*a))),
        "plain_ms": timer.ms(rotating(lambda a: ck.paged_decode_plain(*a))),
        "library_ms": None, "bound_ms": bound, "bound_by": by}
    if not quantized:
        # yardstick: sdpa over the same cache with a live-length mask; it
        # reads all T rows and does not append
        live = (torch.arange(T, device="cuda")[None, :]
                <= sets[0][3][:, None].long())[:, None, None, :]
        out["library_ms"] = timer.ms(rotating(
            lambda a: F.scaled_dot_product_attention(a[0], a[1], a[2],
                                                     attn_mask=live)))
    return out


# ---------------------------------------------------------------------------
# training


def bwd_timings(torch, ck, F, timer, gen, B, T, causal, p,
                dt_name="bfloat16"):
    """Device times of the flash backward kernels (rows 2 and 3) at
    B x 12 heads x T x 64, bfloat16 (or float16: their float16 instances),
    beside their plain versions, their bounds and PyTorch's sdpa backward
    (dq, dk and dv in one call) on the same inputs."""
    H, D, dt = 12, 64, getattr(torch, dt_name)
    q, k, v = qkv_views(torch, B, T, H, D, dt, gen)
    do = torch.randn((B, H, T, D), generator=gen, device="cuda").to(dt)
    bits = ck.attn_dropout_bits(WORD, DELTA, B * H, T, T) if p else None
    o, lse = ck.flash_fwd_train(q, k, v, causal, p, WORD, DELTA)
    _, delta = ck.flash_bwd_dq(q, k, v, o, do, lse, causal, p, WORD, DELTA)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                        dropout_p=p)
    lib_bwd = timer.ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True))
    bhtd, bht = B * H * T * D * 2, B * H * T * 4
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    # dq: reads q, k, v, o, dO, lse; writes dq, Delta; 3 products.
    # dk/dv: reads q, k, v, dO, lse, Delta; writes dk, dv; 4 products.
    kernels = (
        ("flash_bwd_dq", 3,
         lambda: ck.flash_bwd_dq(q, k, v, o, do, lse, causal, p, WORD,
                                 DELTA),
         lambda: ck.flash_bwd_dq_plain(q, k, v, o, do, lse, causal, p,
                                       bits)),
        ("flash_bwd_dkv", 4,
         lambda: ck.flash_bwd_dkv(q, k, v, do, lse, delta, causal, p, WORD,
                                  DELTA),
         lambda: ck.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, p,
                                        bits)))
    out = {}
    for name, products, fn, plain in kernels:
        b, by = bound_ms(6 * bhtd + 2 * bht, 2 * products * D * pairs,
                         dt_name)
        out[name] = {"ms": timer.ms(fn), "plain_ms": timer.ms(plain),
                     "library_ms": lib_bwd, "bound_ms": b, "bound_by": by}
    shape = "B=%d H=%d T=%d D=%d %s %s p=%g" % (
        B, H, T, D, SHORT[dt_name], "causal" if causal else "not causal", p)
    for name, t in out.items():
        say("time %s %s: %.4f ms, plain %.4f ms, torch sdpa bwd (dq+dk+dv) "
            "%.4f ms, bound %.4f ms (%s)"
            % (name, shape, t["ms"], t["plain_ms"], t["library_ms"],
               t["bound_ms"], t["bound_by"]))
    say("time flash backward dq + dkv %s: %.4f ms vs torch sdpa backward "
        "%.4f ms, bound %.4f ms" % (
            shape, out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"],
            lib_bwd, out["flash_bwd_dq"]["bound_ms"]
            + out["flash_bwd_dkv"]["bound_ms"]))
    return out


def fwd_timings(torch, ck, F, timer, gen, B, T, causal, p,
                dt_name="bfloat16"):
    """Device time of the training flash forward (row 1t: lse and
    in-kernel dropout) at B x 12 heads x T x 64, bfloat16 (or float16: its
    float16 instance), beside its plain version, its bound and PyTorch's
    sdpa forward on the same inputs."""
    H, D = 12, 64
    q, k, v = qkv_views(torch, B, T, H, D, getattr(torch, dt_name), gen)
    bits = ck.attn_dropout_bits(WORD, DELTA, B * H, T, T) if p else None
    bhtd, bht = B * H * T * D * 2, B * H * T * 4
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    # reads q, k, v; writes o, lse; 2 products of 2 D flops a live pair
    b, by = bound_ms(4 * bhtd + bht, 4 * D * pairs, dt_name)
    t = {"ms": timer.ms(lambda: ck.flash_fwd_train(q, k, v, causal, p, WORD,
                                                   DELTA)),
         "plain_ms": timer.ms(lambda: ck.flash_fwd_train_plain(
             q, k, v, causal, p, bits)),
         "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
             q, k, v, is_causal=causal, dropout_p=p)),
         "bound_ms": b, "bound_by": by}
    say("time flash_fwd_train B=%d H=%d T=%d D=%d %s %s p=%g: %.4f ms, "
        "plain %.4f ms, torch sdpa fwd %.4f ms, bound %.4f ms (%s)"
        % (B, H, T, D, SHORT[dt_name], "causal" if causal else "not causal",
           p, t["ms"],
           t["plain_ms"], t["library_ms"], t["bound_ms"], t["bound_by"]))
    return t


def train_timings(torch, ck, F, timer, gen):
    """Device times of the training kernels at the main path's shapes; the
    flash kernels also at GPT-2's shape without dropout (the Philox share)
    and at ERNIE's attention shape (path A)."""
    B, T = TRAIN_B, TRAIN_T
    out = {"flash_fwd_train": fwd_timings(torch, ck, F, timer, gen, B, T,
                                          True, DROPOUT)}
    fwd_timings(torch, ck, F, timer, gen, B, T, True, 0.0)
    fwd_timings(torch, ck, F, timer, gen, ERNIE_B, ERNIE_T, False, DROPOUT)
    out.update(bwd_timings(torch, ck, F, timer, gen, B, T, True, DROPOUT))
    bwd_timings(torch, ck, F, timer, gen, B, T, True, 0.0)
    bwd_timings(torch, ck, F, timer, gen, ERNIE_B, ERNIE_T, False, DROPOUT)
    return out


def time_adamw(torch, ck, timer, gen, shapes, card, dt_name="bfloat16"):
    """One AdamW step over tensors shaped like every gpt2-small parameter,
    bfloat16 parameters and gradients, float32 moments, as the O2 main
    path runs it: one launch per parameter, lr and the bias corrections
    from the scalar buffer, each gradient times the clip's scale word (the
    GPT-2 configuration's ClipGradByGlobalNorm, phase 17). The row's time
    is the launches replayed from one CUDA graph, as the captured train
    step runs them: device time alone. The same launches without the
    scale (phase 10's optimizer) are replayed too, and enqueued one by one
    from the host (the time this row reported before the step was
    captured). With dt_name float16: the same for the kernel's float16
    instance; PyTorch's AdamW(fused=True) keeps float16 moments there, so it
    is no yardstick of the same function (library_ms None)."""
    dt = getattr(torch, dt_name)
    ps = [torch.randn(s, generator=gen, device="cuda").to(dt)
          for s in shapes]
    gs = [(torch.randn(s, generator=gen, device="cuda") * 1e-2).to(dt)
          for s in shapes]
    m1 = [torch.zeros(s, device="cuda") for s in shapes]
    m2 = [torch.zeros(s, device="cuda") for s in shapes]
    sc = step_scalars(torch, ck, 1e-4, 10, ADAMW_CHECK_SCALE)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)

    def run(fn, *args, **extra):
        for p, g, a, b in zip(ps, gs, m1, m2):
            fn(p, g, a, b, *args, **kw, **extra)

    def captured(**extra):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(ck.adamw, sc, **extra)    # warm-up on the capture stream
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run(ck.adamw, sc, **extra)
        return graph
    graph, unscaled = captured(scaled=True), captured()
    lib_p = [p.clone().requires_grad_() for p in ps]
    for p, g in zip(lib_p, gs):
        p.grad = g.clone()
    lib = torch.optim.AdamW(lib_p, lr=1e-4, weight_decay=0.01, fused=True)
    n = sum(p.numel() for p in ps)
    # each element: param read + write (2 + 2), grad read (2), m1 and m2
    # read + write (8 + 8); 10 operations and the scale's product
    b, by = bound_ms(22 * n, 11 * n, "float32")
    eager_ms = timer.ms(lambda: run(ck.adamw, sc))
    unscaled_ms = timer.ms(unscaled.replay)
    lib_ms = timer.ms(lib.step)
    out = {"ms": timer.ms(graph.replay),
           "plain_ms": timer.ms(lambda: run(ck.adamw_plain_scalars, sc,
                                            scaled=True)),
           "library_ms": lib_ms if dt == torch.bfloat16 else None,
           "bound_ms": b, "bound_by": by}
    say("time adamw %d parameters, %d elements, %s param+grad, f32 "
        "moments, the clip's scale word: %.4f ms/step replayed from a CUDA "
        "graph (without the scale %.4f ms replayed, %.4f ms enqueued one "
        "launch at a time), plain %.4f ms, torch AdamW(fused=True) %.4f ms "
        "(%s moments), bound %.4f ms (%s)"
        % (len(shapes), n, SHORT[dt_name], out["ms"], unscaled_ms, eager_ms,
           out["plain_ms"], lib_ms, SHORT[dt_name], b, by))
    say("time adamw %s with the scale word: %.4f ms/step replayed, %.2f of "
        "its bound, %+.4f ms against the unscaled launches in this run; "
        "PERF.md's bf16 time before the word %.4f ms (another run) (%s)"
        % (SHORT[dt_name], out["ms"], b / out["ms"], out["ms"] - unscaled_ms,
           ADAMW_EARLIER_MS, card))
    return out


def time_dropout_keep(torch, ck, timer, shape):
    """Device time of the keep-mask kernel at a hidden dropout's shape
    beside its bound (one bool written an element; one Philox call,
    PHILOX_INT_OPS int32 operations a lane, a 4 elements at the card's
    int32 rate) and its plain version. No PyTorch call
    draws this function (torch.rand's bits are another generator's):
    library_ms is null."""
    n = int(np.prod(shape))
    b, by = bound_ms(n, PHILOX_INT_OPS * n / 4, "int32")
    out = {"ms": timer.ms(lambda: ck.dropout_keep(WORD, DELTA, shape,
                                                  DROPOUT)),
           "plain_ms": timer.ms(lambda: ck.dropout_keep_plain(
               SEED, OFFSET, shape, DROPOUT, device="cuda")),
           "library_ms": None, "bound_ms": b, "bound_by": by}
    say("time dropout_keep %s p=%g: %.4f ms, plain %.4f ms, bound %.4f ms "
        "(%s)" % (shape, DROPOUT, out["ms"], out["plain_ms"], b, by))
    return out


def token_stream(io, vocab, T):
    class TokenStream(io.Dataset):
        """The bench's synthetic stream (benchmarks/train_bench.py)."""

        def __len__(self):
            return 100000

        def __getitem__(self, i):
            rs = np.random.RandomState(i)
            return rs.randint(0, vocab, (T + 1,)).astype(np.int64)
    return TokenStream()


# kernel-name patterns of the training step's profile groups, first match
PROFILE_GROUPS = (("flash kernels (port)", ("flash_fwd_", "flash_bwd_")),
                  ("dropout keep mask (port)", ("fdrln_bits_kernel",)),
                  ("fused dropout-LN (port)", ("fdrln_",)),
                  ("adamw (port)", ("adamw_kernel",)),
                  ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "cublas")),
                  ("reductions", ("reduce_kernel",)),
                  ("elementwise", ("elementwise", "vectorized")))


def group_of(kernel, groups=PROFILE_GROUPS):
    """The first group of `groups` whose patterns a kernel name holds, else
    "other"."""
    return next((g for g, pats in groups if any(p in kernel for p in pats)),
                "other")


def profile_groups(rows, groups=PROFILE_GROUPS):
    """Device ms per group of `groups` (and "other") of profiler rows."""
    out = {}
    for t_us, key, _ in rows:
        name = group_of(key, groups)
        out[name] = out.get(name, 0.0) + t_us / 1e3
    return out


def profile_step(torch, step, batch):
    """Device time of one train step from torch.profiler: (kernel ms, all
    kernel rows by device time). 0 ms when the profiler saw no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*batch())
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return sum(t for t, _, _ in rows) / 1e3, rows


def report_profile(label, dev_ms, step_ms, top, groups=PROFILE_GROUPS):
    """Print one profiled step: its kernel time against the median step
    (the device's idle share), the groups and the largest kernels."""
    if dev_ms <= 0:
        say("%s step profile: not measured (the profiler saw no device "
            "activity)" % label)
        return
    say("%s step profile: %.3f ms of kernels in one step (torch.profiler) "
        "vs %.2f ms median step: device idle %.1f %%"
        % (label, dev_ms, step_ms, 100.0 * (1.0 - dev_ms / step_ms)))
    for name, ms in sorted(profile_groups(top, groups).items(),
                           key=lambda kv: -kv[1]):
        say("  group %-26s %8.3f ms/step" % (name, ms))
    for t_us, key, count in top[:12]:
        say("  %9.1f us/step  %5d launches  %s" % (t_us, count, key[:90]))


def eager_train_step(Step):
    class EagerStep(Step):
        """The step's body run eagerly on every call: no program is built,
        captured or replayed (the step as it ran before it was captured,
        and the reference the programs are held to). Its telemetry counts
        under an engine of its own, so that the jit_train and jit_eval
        retraces count program builds."""

        engine = "eager_bodies"

        def _run(self, key, body):
            return body()
    return EagerStep


def timed_steps(torch, step, batch, warmup, timed):
    """warmup + timed calls of `step` on `batch()`, each ended by a
    synchronize: (losses, ms of each timed call, the last outputs)."""
    losses, times = [], []
    for _ in range(warmup + timed):
        t0 = time.perf_counter()
        loss, outs = step(*batch())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return [float(x) for x in losses], times[warmup:], outs


def step_line(label, times, tokens, flops, peak, dev_ms, card):
    """One path's step numbers: median step, tokens/s, MFU, peak memory,
    and the kernel time and device idle share of one profiled step."""
    step_ms = statistics.median(times)
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    idle = ("%.3f ms of kernels in one profiled step, device idle %.1f %%"
            % (dev_ms, 100.0 * (1.0 - dev_ms / step_ms)) if dev_ms > 0
            else "kernel time not measured (the profiler saw no device "
            "activity)")
    say("%s: step %.2f ms median (%.2f mean) over %d timed steps, %.0f "
        "tokens/s, MFU %.4f of 989 TFLOP/s bf16, peak memory %.1f MiB; %s "
        "(%s)" % (label, step_ms, statistics.mean(times), len(times),
                  tokens / (step_ms / 1e3), mfu, peak / 2 ** 20, idle, card))
    return step_ms


def run_path(torch, ck, label, card, model, opt, loss_fn, batch, ctx,
             tokens, flops, want):
    """One training path: its step's bodies run eagerly (EAGER_WARMUP +
    EAGER_STEPS steps, one profiled), then the captured step, the main
    path: the launch and path counters zeroed just before its TRAIN_WARMUP
    + TRAIN_STEPS steps and read just after; one program built, every
    later step a replay; the launches a step `want` (kernel: count), all
    of them through replays; one replay profiled. Returns (launches,
    attention paths, median step ms, the last outputs, the runs of the
    step's body in Python: on the card the build's eager run and its
    capture, on the CPU every step)."""
    from paddle_tpu_torch.jit import TrainStep, make_train_step
    eager = eager_train_step(TrainStep)(model, loss_fn, opt)
    with ctx():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, times, _ = timed_steps(torch, eager, batch, EAGER_WARMUP,
                                  EAGER_STEPS)
        peak = torch.cuda.max_memory_allocated()
        dev_ms, top = profile_step(torch, eager, batch)
    step_line("%s eager bodies" % label, times, tokens, flops, peak, dev_ms,
              card)
    report_profile("%s eager" % label, dev_ms, statistics.median(times), top)
    del eager
    step = make_train_step(model, loss_fn, opt)
    with ctx():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.launch_counts(reset=True)
        ck.attention_path_counts(reset=True)
        losses, times, outs = timed_steps(torch, step, batch, TRAIN_WARMUP,
                                          TRAIN_STEPS)
        launches = ck.launch_counts()
        paths = ck.attention_path_counts()
        peak = torch.cuda.max_memory_allocated()
        progs = step.programs
        (key,) = progs.builds
        replayed = {k: progs.replays[key] * n for k, n in
                    progs.launches[key].items()}
        n_steps = TRAIN_WARMUP + TRAIN_STEPS
        require(step.compiles == 1 and step.replays == n_steps - 1,
                "%s: %d programs and %d replays in %d steps (want one "
                "build, then replays)" % (label, step.compiles, step.replays,
                                          n_steps))
        dev_ms, top = profile_step(torch, step, batch)
    require(all(math.isfinite(x) for x in losses),
            "%s: non-finite loss %s" % (label, losses))
    say("%s main path: %d steps, losses %s" % (
        label, n_steps, ["%.4f" % x for x in losses]))
    per_step = {k: launches[k] / n_steps for k in launches}
    say("%s main path launches %s, attention paths %s" % (label, launches,
                                                         paths))
    require(all(per_step[k] == v for k, v in want.items()),
            "%s: launches per step %s, want %s" % (label, per_step, want))
    require(all(replayed[k] > 0 for k, v in want.items() if v),
            "%s: kernels launched in no replay: %s" % (label, replayed))
    say("%s program %s: %d build + %d replays (compiles %d), captured in "
        "%.1f ms, graph pool %.1f MiB, launches a step %s, launches through "
        "replays %s (%s)"
        % (label, key, progs.builds[key], progs.replays[key], step.compiles,
           progs.capture_s[key] * 1e3, progs.pool_bytes() / 2 ** 20,
           {k: n for k, n in progs.launches[key].items() if n},
           {k: n for k, n in replayed.items() if n}, card))
    step_ms = step_line("%s captured step" % label, times, tokens, flops,
                        peak, dev_ms, card)
    report_profile("%s captured" % label, dev_ms, step_ms, top)
    bodies = 2 if next(model.parameters()).is_cuda else n_steps
    return launches, paths, step_ms, outs, bodies


def graph_against_eager_train(torch, ck, label, model, opt, loss_fn,
                              batches, ctx, p):
    """From one saved state (parameters, moments, step count, RNG), the steps
    of `batches` (two or more) through the captured step and through its bodies
    run eagerly, twice (the eager step must repeat itself bit for bit for the
    comparison to mean anything): losses, parameters and moments bit-equal. At
    p > 0 the two steps' Philox words differ and so do the bits they give a
    flash call and a fused call, and the restored state gives step 1's word
    again."""
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import TrainStep, make_train_step
    step = make_train_step(model, loss_fn, opt)
    eager = eager_train_step(TrainStep)(model, loss_fn, opt)
    params = [t for t in model.parameters() if t.requires_grad]
    moments = lambda: [a for t in params
                       for a in opt._get_accumulators(t).values()]
    with ctx():
        step(*batches[0])                 # the build; later calls replay
        torch.cuda.synchronize()
        saved = ([t.detach().clone() for t in params],
                 [a.clone() for a in moments()], opt._step_count,
                 prandom.get_rng_state())

        def two_steps(fn):
            with torch.no_grad():
                for t, v in zip(params + moments(), saved[0] + saved[1]):
                    t.copy_(v)
            opt._step_count = saved[2]
            prandom.set_rng_state(saved[3])
            losses, words = [], []
            for b in batches:
                losses.append(fn(*b)[0])
                words.append(prandom.RNG.word(params[0].device).clone())
            torch.cuda.synchronize()
            return (losses, [t.detach().clone() for t in params],
                    [a.clone() for a in moments()], words)
        e1, e2 = two_steps(eager), two_steps(eager)
        replays = step.replays
        g = two_steps(step)
        require(step.replays == replays + len(batches),
                "%s: the captured steps did not replay" % label)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    for i, what in enumerate(("losses", "parameters", "moments")):
        require(same(e1[i], e2[i]), "%s p=%g: two eager runs from one state "
                "differ in their %s (the eager step is not deterministic)"
                % (label, p, what))
        require(same(g[i], e1[i]), "%s p=%g: the captured step's %s differ "
                "from the eager bodies'" % (label, p, what))
    note = ""
    if p > 0:
        w1, w2 = g[3][:2]
        require(not torch.equal(w1, w2), "%s: steps 1 and 2 ran on one "
                "Philox word %s" % (label, w1.tolist()))
        require(torch.equal(w1, e1[3][0]) and torch.equal(w2, e1[3][1]),
                "%s: the restored RNG state did not give step 1's word "
                "again" % label)
        bits = [(ck.attn_dropout_bits(w, 0, 12, 64, 64),
                 ck.fused_dropout_bits(w, 1, 64, 768)) for w in (w1, w2)]
        require(not torch.equal(bits[0][0], bits[1][0])
                and not torch.equal(bits[0][1], bits[1][1]),
                "%s: steps 1 and 2 drew the same masks" % label)
        note = (", words (seed, base) %s then %s: a flash call's and a "
                "fused call's bits differ between the steps, the restored "
                "state repeats step 1's" % (w1.tolist()[1], w2.tolist()[1]))
    say("%s graph against eager p=%g: %d steps from one state, losses %s, "
        "parameters and moments bit-equal to the eager bodies (which repeat "
        "themselves bit for bit)%s"
        % (label, p, len(batches), ["%.6f" % float(x) for x in g[0]], note))


def free_memory(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_main(torch, ck, flags, card, fused=False, dtype="bfloat16"):
    """The GPT-2 training path, with both fused flags (use_fused_dropout_ln,
    fused_block) off (phase 10) or on (path B), through `run_path`; then
    the captured step against its eager bodies at the path's dropout 0.1
    and, on a fresh model, at 0. With dtype float16 (phase 18 (a)):
    decorate O2 float16 and every step under auto_cast(O2, float16), the
    kernels' float16 instances counted (names + ck.F16), the check at 0
    left out. Returns (launch counts, parameter shapes, median step
    ms)."""
    import contextlib
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.io.prefetch import FEED_STALL
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small

    f16 = dtype == "float16"
    label = ("train fused" if fused else "train") + (" f16" if f16 else "")
    sfx = ck.F16 if f16 else ""
    ctx = ((lambda: amp.auto_cast(level="O2", dtype="float16")) if f16
           else contextlib.nullcontext)
    saved = flags.get_flags(["use_fused_dropout_ln", "fused_block"])
    flags.set_flags({"use_fused_dropout_ln": fused, "fused_block": fused})
    crit = GPTPretrainingCriterion()
    loss_fn = lambda o, l: crit(o, l)  # noqa: E731

    def build(**kw):
        prandom.seed(0)
        model = gpt2_small(seed=0, **kw)
        model.train()
        opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              parameters=model.parameters())
        return amp.decorate(model, opt, level="O2", dtype=dtype)
    try:
        t0 = time.perf_counter()
        model, opt = build()
        vocab = model.gpt.vocab_size
        loader = io.DataLoader(token_stream(io, vocab, TRAIN_T),
                               batch_size=TRAIN_B, prefetch_to_device=2)
        it = iter(loader)

        def batch():
            ids = next(it)
            return [ids[:, :-1]], [ids[:, 1:]]
        n_params = sum(p.numel() for p in model.parameters())
        n_tensors = len(list(model.parameters()))
        say("%s: gpt2-small %d parameters (%d tensors) in %s, built in %.1f "
            "s, use_fused_dropout_ln and fused_block %s"
            % (label, n_params, n_tensors, next(model.parameters()).dtype,
               time.perf_counter() - t0, "on" if fused else "off"))
        L = len(model.gpt.layers)
        want = {"flash_fwd_train" + sfx: L, "flash_bwd_dq" + sfx: L,
                "flash_bwd_dkv" + sfx: L, "adamw" + sfx: n_tensors,
                "fused_dropout_ln_fwd" + sfx: L if fused else 0,
                "fused_dropout_residual_fwd" + sfx: L if fused else 0,
                "fused_dropout_ln_bwd" + sfx: 2 * L if fused else 0,
                # the hidden dropouts (2 a layer, unfused) and the
                # embeddings' dropout
                "dropout_keep": 1 if fused else 2 * L + 1}
        if f16:                         # and no bfloat16 instance runs
            want.update({k: 0 for k in (
                "flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv", "adamw",
                "fused_dropout_ln_fwd", "fused_dropout_residual_fwd",
                "fused_dropout_ln_bwd")})
        tokens = TRAIN_B * TRAIN_T
        d = model.gpt.hidden_size
        flops = 6 * n_params * tokens + 12 * L * d * TRAIN_T * tokens
        stall0 = (FEED_STALL.sum, FEED_STALL.count)
        launches, paths, step_ms, _, _ = run_path(
            torch, ck, label, card, model, opt, loss_fn, batch, ctx, tokens,
            flops, want)
        say("%s feed stall %.3f ms a batch" % (label, (
            FEED_STALL.sum - stall0[0]) / (FEED_STALL.count - stall0[1])))
        require(paths["flash_dropout"] > 0 and paths["xla_sdpa"] == 0,
                "%s: attention paths %s" % (label, paths))
        fixed = [batch() for _ in range(2)]
        it.close()
        free_memory(torch)
        graph_against_eager_train(torch, ck, label, model, opt, loss_fn,
                                  fixed, ctx, DROPOUT)
        shapes = [tuple(p.shape) for p in model.parameters()]
        del model, opt
        free_memory(torch)
        if not f16:
            model, opt = build(attn_dropout_prob=0.0,
                               hidden_dropout_prob=0.0)
            graph_against_eager_train(torch, ck, label, model, opt, loss_fn,
                                      fixed, ctx, 0.0)
            del model, opt
            free_memory(torch)
    finally:
        flags.set_flags(saved)
    return launches, shapes, step_ms


def compare_runs(torch, ck, flags, label, build, kernel_flags, must_launch,
                 steps=3, noise_floor=None):
    """Kernels vs plain versions on the card. `build()` makes the seeded
    float32 model without dropout, its optimizer and a closure that runs
    train step i; it runs once with `kernel_flags` on and once with all of
    them off (which must launch nothing). The losses must agree within
    1e-4 relative and the parameters within TRAIN_PARAM_TOL, which the
    plain run's own movement must exceed.

    With `noise_floor`, an element whose first-step gradient in the plain
    run is at most that in magnitude is held within 2 * steps * lr
    instead, and the elements are counted: where |g| is at Adam's epsilon
    (1e-8), its step lr * g / (|g| + eps) follows the gradient's rounding
    noise, which two correct summation orders do not share (ERNIE-base's
    upper query/key projections start with gradients of 1e-9 to 1e-5)."""
    saved = flags.get_flags(list(kernel_flags))

    def run(on):
        flags.set_flags({f: on for f in kernel_flags})
        try:
            model, opt, step = build()
            start = None if on else [p.detach().clone()
                                     for p in model.parameters()]
            first = []
            if noise_floor is not None and not on:
                apply = opt.apply_updates

                def recording(pairs):
                    # the step's first run is its eager build
                    pairs = list(pairs)
                    if not first:
                        first.extend(g.abs() <= noise_floor for _, g in pairs)
                    return apply(pairs)
                opt.apply_updates = recording
            ck.launch_counts(reset=True)
            losses = [float(step(i)[0]) for i in range(steps)]
            torch.cuda.synchronize()
            launches = ck.launch_counts()
        finally:
            flags.set_flags(saved)
        return (losses, [p.detach() for p in model.parameters()], launches,
                start, first)
    kl, kp, kla, _, _ = run(True)
    pl, pp, pla, start, quiet = run(False)
    require(sum(pla.values()) == 0, "%s: the plain run launched %s"
            % (label, pla))
    require(all(kla[k] > 0 for k in must_launch),
            "%s: the kernel run launched %s" % (label, kla))
    rel = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    diffs = [(a - b).abs() for a, b in zip(kp, pp)]
    if quiet:
        noisy = max(d[q].max().item() if bool(q.any()) else 0.0
                    for d, q in zip(diffs, quiet))
        diffs = [d.masked_fill(q, 0.0) for d, q in zip(diffs, quiet)]
    diff = max(d.max().item() for d in diffs)
    # control: what a kernel run that never updated would differ by
    moved = max((a - b).abs().max().item() for a, b in zip(pp, start))
    say("%s kernels vs plain (float32, no dropout, %d steps, flags %s): "
        "losses %s vs %s, max rel diff %.3g (tol 1e-4); max parameter diff "
        "%.3g (tol %.0e), against the plain run's own movement %.3g"
        % (label, steps, "+".join(kernel_flags), ["%.6f" % x for x in kl],
           ["%.6f" % x for x in pl], rel, diff, TRAIN_PARAM_TOL, moved))
    if quiet:
        n = sum(int(q.sum()) for q in quiet)
        total = sum(q.numel() for q in quiet)
        say("%s: %d of %d elements with a first-step |g| <= %.0e (Adam's "
            "step follows their rounding noise) held within %.0e: max diff "
            "%.3g" % (label, n, total, noise_floor, 2 * steps * TRAIN_LR,
                      noisy))
        require(noisy <= 2 * steps * TRAIN_LR, "%s: a near-zero-gradient "
                "element moved %.3g apart" % (label, noisy))
    require(rel <= 1e-4, "%s: kernel and plain losses differ by %.3g"
            % (label, rel))
    require(moved > TRAIN_PARAM_TOL, "%s: the parameters moved %.3g, "
            "within the tolerance: the check would not see a skipped update"
            % (label, moved))
    require(diff <= TRAIN_PARAM_TOL, "%s: parameters differ by %.3g"
            % (label, diff))


def train_compare(torch, ck, flags, fused=False):
    """GPT-2 kernels vs plain: the same float32 weights, no dropout, B=4,
    T=512, 3 AdamW steps; with `fused`, the kernel run has both fused
    flags on too."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import (GPT_CONFIGS, GPTPretrainingCriterion,
                                         gpt2_small)
    B, lr = 4, TRAIN_LR
    vocab = GPT_CONFIGS["gpt2-small"]["vocab_size"]
    data = [torch.from_numpy(token_stream_batch(np, vocab, B, TRAIN_T, s))
            .cuda() for s in range(3)]

    def build():
        prandom.seed(0)
        model = gpt2_small(seed=0, attn_dropout_prob=0.0,
                           hidden_dropout_prob=0.0)
        model.train()
        opt = optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                              parameters=model.parameters())
        crit = GPTPretrainingCriterion()
        step = make_train_step(model, lambda o, l: crit(o, l), opt)
        return model, opt, lambda i: step([data[i][:, :-1]],
                                          [data[i][:, 1:]])
    kernel_flags = ("use_flash_attention", "use_fused_optimizer")
    must = ("flash_fwd_train", "flash_bwd_dkv", "adamw")
    if fused:
        kernel_flags += ("use_fused_dropout_ln", "fused_block")
        must += FUSED_KERNELS
    compare_runs(torch, ck, flags, "train fused" if fused else "train",
                 build, kernel_flags, must)


def token_stream_batch(np, vocab, B, T, n):
    """Batch n of the bench's token stream: samples n*B .. n*B+B-1."""
    return np.stack([np.random.RandomState(i).randint(0, vocab, (T + 1,))
                     for i in range(n * B, n * B + B)]).astype(np.int64)


# ---------------------------------------------------------------------------
# fused bias + dropout + residual (+ LayerNorm): rows 4-6


FDRLN_MODES = ("upscale_in_train", "downscale_in_infer")


def fdrln_scale(p, mode):
    """The kernels' keep scale for dropout p in training (reference:
    fused_bias_dropout_residual_ln_arrays)."""
    if mode == "downscale_in_infer":
        return 1.0
    return float(np.float32(1.0 / (1.0 - p))) if p < 1.0 else 0.0


def check_fused(torch, ck, flags, gen):
    """Rows 4-6 against their plain versions fed the kernels' own bits:
    float32, bfloat16 and mixed x/residual types, Hd 64, 768 and 1000,
    p 0, 0.1 and 1, both modes; row 6 also at path B's shape; the keep
    decisions bit-equal; the gates raising on inputs the kernels do not
    take."""
    names = ("fused_dropout_ln_fwd", "fused_dropout_residual_fwd",
             "fused_dropout_ln_bwd")
    names += tuple(n + ck.F16 for n in names)
    worst = {n: 0.0 for n in names}             # relative, for the checks
    worst_abs = {n: 0.0 for n in names}         # absolute, for the table

    def hold(what, name, pairs, tol):
        # the instance launched is named by the rows' type (x, or z)
        if pairs and pairs[0][0].dtype == torch.float16:
            name += ck.F16
        torch.cuda.synchronize()
        for a, b in pairs:
            require(a.dtype == b.dtype and a.shape == b.shape
                    and bool(torch.isfinite(a.float()).all()),
                    what + ": type, shape or non-finite")
        ea, er = (max(v) for v in zip(*(abs_rel_err(a, b) for a, b in pairs)))
        require(er <= tol, what + ": rel err %.3g > %.3g" % (er, tol))
        worst[name] = max(worst[name], er)
        worst_abs[name] = max(worst_abs[name], ea)

    types = (("float32", torch.float32, torch.float32),
             ("bfloat16", torch.bfloat16, torch.bfloat16),
             ("mixed", torch.bfloat16, torch.float32),
             ("mixed", torch.float32, torch.bfloat16),
             ("float16", torch.float16, torch.float16),
             ("mixed", torch.float16, torch.float32),
             ("mixed", torch.float32, torch.float16))
    n = 0
    for N, Hd in ((301, 64), (4096, 768), (67, 1000)):
        bits = ck.fused_dropout_bits(WORD, DELTA, N, Hd)
        require(torch.equal(bits, ck.fused_dropout_bits_plain(
            SEED, OFFSET, N, Hd, device="cuda")), "fused_dropout_bits "
            "[%d, %d] differ from the plain Philox" % (N, Hd))
        for tname, xdt, rdt in types:
            tol = FDRLN_F32_REL_TOL if xdt == torch.float32 else \
                FDRLN_BF16_REL_TOL
            x = torch.randn((N, Hd), generator=gen, device="cuda").to(xdt)
            res = torch.randn((N, Hd), generator=gen, device="cuda").to(rdt)
            vec = lambda s, o: (torch.randn(Hd, generator=gen, device="cuda")
                                * s + o).to(rdt)
            bias, gamma, beta = vec(1.0, 0.0), vec(0.1, 1.0), vec(1.0, 0.0)
            dy = torch.randn((N, Hd), generator=gen, device="cuda").to(xdt)
            dz = torch.randn((N, Hd), generator=gen, device="cuda").to(rdt)
            for p in (0.0, DROPOUT, 1.0):
                for mode in FDRLN_MODES:
                    s = fdrln_scale(p, mode)
                    what = "%s x=%s res=%s N=%d Hd=%d p=%g %s" % (
                        "%s", xdt, rdt, N, Hd, p, mode)
                    y, z = ck.fused_dropout_ln_fwd(x, res, bias, gamma, beta,
                                                   p, s, 1e-5, WORD, DELTA)
                    z1 = ck.fused_dropout_residual_fwd(x, res, bias, p, s,
                                                       WORD, DELTA)
                    yp, zp = ck.fused_dropout_ln_fwd_plain(
                        x, res, bias, gamma, beta, p, s, 1e-5, bits=bits)
                    z1p = ck.fused_dropout_residual_fwd_plain(
                        x, res, bias, p, s, bits=bits)
                    outs = {"fused_dropout_ln_fwd": [(y, yp), (z, zp)],
                            "fused_dropout_residual_fwd": [(z1, z1p)],
                            "fused_dropout_ln_bwd": []}
                    for g, dzx in ((gamma, dz), (None, dz), (gamma, None)):
                        got = ck.fused_dropout_ln_bwd(z, dy, dzx, g, p, s,
                                                      1e-5, WORD, DELTA)
                        want = ck.fused_dropout_ln_bwd_plain(
                            z, dy, dzx, g, p, s, 1e-5, bits=bits)
                        outs["fused_dropout_ln_bwd"] += [
                            (a, b) for a, b in zip(got, want)
                            if b is not None]
                        require(all(a is None for a, b in zip(got, want)
                                    if b is None),
                                "fused_dropout_ln_bwd: dgamma without LN")
                        # keep decisions: the dropped dx are exactly 0
                        keep = bits >= min(int(p * 2 ** 32), 2 ** 32 - 1)
                        if p > 0.0 and s > 0.0:
                            nz = (got[1] != 0) & keep
                            require(torch.equal(got[0] != 0, nz),
                                    (what % "fused_dropout_ln_bwd")
                                    + ": keep mask differs from the bits")
                    for name, pairs in outs.items():
                        hold(what % name, name, pairs, tol)
                    n += 1
        # the forward's keep decisions: ones + 0 residual is 0 where dropped
        ones, zeros = (torch.ones((N, Hd), device="cuda"),
                       torch.zeros((N, Hd), device="cuda"))
        for p in (DROPOUT, 0.5):
            z1 = ck.fused_dropout_residual_fwd(ones, zeros, None, p, 1.0,
                                               WORD, DELTA)
            require(torch.equal(z1 != 0, bits >= int(p * 2 ** 32)),
                    "fused_dropout_residual_fwd: keep mask differs from the "
                    "bits at p=%g" % p)
    # the backward at path B's shape, the only one of these where a warp
    # takes two 4-row groups (2048 groups on a grid of one CTA of 8 warps
    # an SM): its column sums run across groups, and it loads the next
    # group's first row ahead. With LN and dz_extra, and without LN, as
    # the main path calls it; also without LN with dz_extra, and float32.
    # The forward with LN there too (bf16 is path B's own case; path A's,
    # N=4096 f32, is in the cases above), where a warp of its persistent
    # grid may take more than one group.
    N, Hd, s = 8192, 768, fdrln_scale(DROPOUT, "upscale_in_train")
    bits = ck.fused_dropout_bits(WORD, DELTA, N, Hd)
    nb = 0
    for dt in (torch.bfloat16, torch.float32, torch.float16):
        tol = FDRLN_F32_REL_TOL if dt == torch.float32 else FDRLN_BF16_REL_TOL
        x, res, beta = (torch.randn(shape, generator=gen, device="cuda")
                        .to(dt) for shape in ((N, Hd), (N, Hd), Hd))
        gamma = (torch.randn(Hd, generator=gen, device="cuda") * 0.1
                 + 1.0).to(dt)
        got = ck.fused_dropout_ln_fwd(x, res, None, gamma, beta, DROPOUT, s,
                                      1e-5, WORD, DELTA)
        want = ck.fused_dropout_ln_fwd_plain(x, res, None, gamma, beta,
                                             DROPOUT, s, 1e-5, bits=bits)
        hold("fused_dropout_ln_fwd %s N=%d Hd=%d p=%g" % (dt, N, Hd, DROPOUT),
             "fused_dropout_ln_fwd", list(zip(got, want)), tol)
        z, dy, dz = (torch.randn((N, Hd), generator=gen, device="cuda").to(dt)
                     for _ in range(3))
        for g, dzx in ((gamma, dz), (None, None), (None, dz)):
            got = ck.fused_dropout_ln_bwd(z, dy, dzx, g, DROPOUT, s, 1e-5,
                                          WORD, DELTA)
            want = ck.fused_dropout_ln_bwd_plain(z, dy, dzx, g, DROPOUT, s,
                                                 1e-5, bits=bits)
            hold("fused_dropout_ln_bwd %s N=%d Hd=%d p=%g LN=%s dz_extra=%s"
                 % (dt, N, Hd, DROPOUT, g is not None, dzx is not None),
                 "fused_dropout_ln_bwd",
                 [(a, b) for a, b in zip(got, want) if b is not None], tol)
            nb += 1
    check_mask_identity(torch, ck)
    extra = {"fused_dropout_ln_fwd": " and 3 at path B's N=8192, Hd=768, "
             "p=%g (bf16, f32, f16)" % DROPOUT,
             "fused_dropout_ln_bwd": " and %d at path B's N=8192, Hd=768, "
             "p=%g (bf16, f32, f16; with LN and dz_extra, without LN with "
             "and without dz_extra)" % (nb, DROPOUT)}
    for name in names:
        say("check %s: max rel err %.3g (tol f32 %.0e, bf16 and f16 %.0e, "
            "by the output's type), max abs err %.3g, over %d cases (f32, "
            "bf16, f16, mixed with f32; Hd 64, 768, 1000; p 0, %g, 1; both "
            "modes; the _f16 instance where the rows are float16)%s"
            % (name, worst[name], FDRLN_F32_REL_TOL, FDRLN_BF16_REL_TOL,
               worst_abs[name], n, DROPOUT,
               extra.get(name.replace(ck.F16, ""), "")))
    # the drop rate and the gates
    bits = ck.fused_dropout_bits(WORD, DELTA, 8192, 768)
    rate = (bits < int(DROPOUT * 2 ** 32)).double().mean().item()
    require(abs(rate - DROPOUT) <= DROP_RATE_TOL,
            "fused dropout rate %.5f, want %.3f +- %.3f"
            % (rate, DROPOUT, DROP_RATE_TOL))
    say("check fused_dropout_bits: bit-equal to the plain Philox; drop rate "
        "%.5f at [8192, 768] (want %.3f +- %.3f); keep decisions of the "
        "forward and backward bit-equal to the bits" % (rate, DROPOUT,
                                                        DROP_RATE_TOL))
    big = torch.zeros((4, ck.FDRLN_MAX_HD + 1), device="cuda")
    x = torch.zeros((8, 64), device="cuda")
    v = torch.ones(64, device="cuda")
    saved = flags.get_flags(["use_fused_dropout_ln"])
    flags.set_flags({"use_fused_dropout_ln": True})
    gate = ck.fused_dropout_residual_ln_or_none
    bad = [("Hd above the limit", lambda: gate(big, big, None, None, None,
                                                0.1, 1e-5, True,
                                                "upscale_in_train")),
           ("bfloat16 with float16", lambda: gate(
               x.half(), x.bfloat16(), None, v, v, 0.1, 1e-5, True,
               "upscale_in_train")),
           ("mismatched shapes", lambda: gate(x, x[:4], None, v, v, 0.1,
                                              1e-5, True,
                                              "upscale_in_train")),
           ("gamma of another width",
            lambda: ck.fused_bias_dropout_residual_ln(
                x, x, None, v[:32], v, 0.1, 1e-5, True,
                "upscale_in_train")),
           ("bfloat16 with float16 backward", lambda: ck.fused_dropout_ln_bwd(
               x.half(), x.half(), None, v.bfloat16(), 0.1, 1.0, 1e-5)),
           ("float64", lambda: gate(x.double(), x, None, v, v, 0.1, 1e-5,
                                    True, "upscale_in_train"))]
    before = ck.launch_counts()
    try:
        for what, call in bad:
            try:
                call()
            except ValueError:
                continue
            raise SystemExit("chip_smoke FAILED: a fused gate took %s on the "
                             "card without raising" % what)
    finally:
        flags.set_flags(saved)
    require(ck.launch_counts() == before, "a rejected input launched")
    say("check fused gates: %d inputs the kernels do not take raise on the "
        "card" % len(bad))
    return worst_abs


def check_mask_identity(torch, ck):
    """Row 6 regenerates row 4's mask: at path B's shape (bf16, N=8192) and
    path A's (f32, N=4096), the forward with LN drops h = 1 (x = 1, no
    bias, residual 0) exactly where the bits say, so z is 0 exactly there;
    the backward with LN from the same (seed, offset), fed dy = 0 and
    dz_extra = 1 (so dz = 1), gives dx = 0 exactly there too."""
    s = fdrln_scale(DROPOUT, "upscale_in_train")
    for N, dt in ((8192, torch.bfloat16), (4096, torch.float32)):
        Hd = 768
        ones = torch.ones((N, Hd), device="cuda", dtype=dt)
        zeros = torch.zeros((N, Hd), device="cuda", dtype=dt)
        g, b = ones[0].clone(), zeros[0].clone()
        _, z = ck.fused_dropout_ln_fwd(ones, zeros, None, g, b, DROPOUT, s,
                                       1e-5, WORD, DELTA)
        dropped = z == 0
        bits = ck.fused_dropout_bits(WORD, DELTA, N, Hd)
        require(torch.equal(dropped, bits < int(DROPOUT * 2 ** 32)),
                "fused_dropout_ln_fwd %s N=%d: dropped elements differ from "
                "the bits" % (dt, N))
        dx = ck.fused_dropout_ln_bwd(z, zeros, ones, g, DROPOUT, s, 1e-5,
                                     WORD, DELTA)[0]
        require(torch.equal(dx == 0, dropped),
                "fused_dropout_ln_bwd %s N=%d: dx is not zero exactly where "
                "the forward dropped h" % (dt, N))
        say("check mask identity %s N=%d Hd=%d p=%g: the forward with LN "
            "dropped %d elements, the bits' own; the backward's dx is zero "
            "at exactly those" % (str(dt).split(".")[-1], N, Hd, DROPOUT,
                                  int(dropped.sum())))


def time_fused(torch, ck, timer, gen, N, Hd, dtype, dz_extra, label):
    """Device times of rows 4-6 at one path's shape: x, residual and the
    LN vectors in `dtype`, no bias (the model's tails pass none), p=0.1,
    upscale_in_train; the backward with LN (dz_extra: whether z's own
    cotangent is passed, as the fused_block pair does and the post-LN
    tail does not) and without. The yardstick is the composed route the
    flag replaces, in PyTorch's own ops: residual +
    torch.nn.functional.dropout(x), then torch.nn.functional.layer_norm,
    and its autograd backward."""
    tF = torch.nn.functional
    mk = lambda: torch.randn((N, Hd), generator=gen, device="cuda").to(dtype)
    x, res, dy, dz = mk(), mk(), mk(), mk()
    g = (1.0 + 0.1 * torch.randn(Hd, generator=gen, device="cuda")).to(dtype)
    b = torch.randn(Hd, generator=gen, device="cuda").to(dtype)
    p, s = DROPOUT, fdrln_scale(DROPOUT, "upscale_in_train")
    bits = ck.fused_dropout_bits(WORD, DELTA, N, Hd)
    y, z = ck.fused_dropout_ln_fwd(x, res, None, g, b, p, s, 1e-5, WORD,
                                   DELTA)
    dzx = dz if dz_extra else None
    esize = x.element_size()
    rows = N * Hd * esize
    vecs = Hd * esize
    flop = N * Hd

    lx, lr, lg, lb = (t.detach().clone().requires_grad_()
                      for t in (x, res, g, b))
    lz = lr + tF.dropout(lx, p)
    ly = tF.layer_norm(lz, (Hd,), lg, lb, 1e-5)
    cot = (dy, dz) if dz_extra else (dy,)
    outs = (ly, lz) if dz_extra else (ly,)
    out = {}
    # row 4: reads x, res, gamma, beta; writes y, z; ~10 flops an element
    bound, by = bound_ms(4 * rows + 2 * vecs, 10 * flop, "float32")
    out["fused_dropout_ln_fwd"] = {
        "ms": timer.ms(lambda: ck.fused_dropout_ln_fwd(
            x, res, None, g, b, p, s, 1e-5, WORD, DELTA)),
        "plain_ms": timer.ms(lambda: ck.fused_dropout_ln_fwd_plain(
            x, res, None, g, b, p, s, 1e-5, bits=bits)),
        "library_ms": timer.ms(lambda: tF.layer_norm(
            res + tF.dropout(x, p), (Hd,), g, b, 1e-5)),
        "bound_ms": bound, "bound_by": by}
    # row 5: reads x, res; writes z; 2 flops an element
    bound, by = bound_ms(3 * rows, 2 * flop, "float32")
    out["fused_dropout_residual_fwd"] = {
        "ms": timer.ms(lambda: ck.fused_dropout_residual_fwd(
            x, res, None, p, s, WORD, DELTA)),
        "plain_ms": timer.ms(lambda: ck.fused_dropout_residual_fwd_plain(
            x, res, None, p, s, bits=bits)),
        "library_ms": timer.ms(lambda: res + tF.dropout(x, p)),
        "bound_ms": bound, "bound_by": by}
    # row 6 with LN: reads z, dy (, dz_extra), gamma; writes dx, dres and
    # dbias, dgamma, dbeta; ~16 flops an element
    nrows = 4 + (1 if dz_extra else 0)
    bound, by = bound_ms(nrows * rows + 4 * vecs, 16 * flop, "float32")
    out["fused_dropout_ln_bwd"] = {
        "ms": timer.ms(lambda: ck.fused_dropout_ln_bwd(
            z, dy, dzx, g, p, s, 1e-5, WORD, DELTA)),
        "plain_ms": timer.ms(lambda: ck.fused_dropout_ln_bwd_plain(
            z, dy, dzx, g, p, s, 1e-5, bits=bits)),
        "library_ms": timer.ms(lambda: torch.autograd.grad(
            outs, (lx, lr, lg, lb), cot, retain_graph=True)),
        "bound_ms": bound, "bound_by": by}
    noln = {"ms": timer.ms(lambda: ck.fused_dropout_ln_bwd(
                z, dy, None, None, p, s, 1e-5, WORD, DELTA)),
            "bound_ms": bound_ms(3 * rows + vecs, 2 * flop, "float32")[0]}
    for name, t in out.items():
        say("time %s %s N=%d Hd=%d %s p=%g%s: %.4f ms, plain %.4f ms, "
            "composed torch route %.4f ms, bound %.4f ms (%s)"
            % (name, label, N, Hd, str(dtype).split(".")[-1], p,
               " dz_extra" if dz_extra and name.endswith("bwd") else "",
               t["ms"], t["plain_ms"], t["library_ms"], t["bound_ms"],
               t["bound_by"]))
    say("time fused_dropout_ln_bwd without LN %s N=%d Hd=%d: %.4f ms, bound "
        "%.4f ms (bytes)" % (label, N, Hd, noln["ms"], noln["bound_ms"]))
    # the backward's partial rows (one float32 row per column sum and CTA,
    # written by the kernel and read by its column-sum kernel), which the
    # bound above does not count
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = ck._fdrln_bwd_grid(N, "cuda")
    for what, nacc in (("with LN", 3), ("without LN", 1)):
        say("fused_dropout_ln_bwd %s %s N=%d Hd=%d: grid %d CTAs on %d SMs, "
            "partial rows %d x %d x %d float32 = %d bytes written, then read "
            "by the column-sum kernel"
            % (what, label, N, Hd, grid, sms, grid, nacc, Hd,
               4 * grid * nacc * Hd))
    return out


# ---------------------------------------------------------------------------
# ERNIE-base pretraining (path A)


def ernie_batch(torch, vocab, B, T):
    """The ERNIE bench's batch (benchmarks/train_bench.py bench_ernie):
    ids from RandomState(0), every fifth MLM label -100, random NSP
    labels."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (B, T)).astype(np.int64)
    labels = ids.copy()
    labels[:, ::5] = -100
    nsp = rs.randint(0, 2, (B,)).astype(np.int64)
    to = lambda a: torch.from_numpy(a).cuda()
    return [to(ids)], [to(labels), to(nsp)]


def ernie_main(torch, ck, flags, card):
    """Path A: the JAX package's ERNIE bench on the port: ernie_base at full
    width and depth (seeded weights, dropouts 0.1), B=32, T=128,
    AdamW(lr=1e-4, weight_decay=0.01), make_train_step with the MLM + NSP
    criterion, under amp.auto_cast(level="O2") with float32 parameters,
    FLAGS_use_fused_dropout_ln on, through `run_path`; then the captured
    step against its eager bodies at dropout 0.1 and, on a fresh model, at
    0. Returns the launch counts."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_base

    saved = flags.get_flags(["use_fused_dropout_ln"])
    flags.set_flags({"use_fused_dropout_ln": True})
    crit = BertPretrainingCriterion()
    loss_fn = lambda lg, nl, y1, y2: crit(lg, nl, y1, y2)  # noqa: E731
    ctx = lambda: amp.auto_cast(level="O2")  # noqa: E731

    def build(**kw):
        net = ernie_base(seed=0, **kw)
        net.train()
        prandom.seed(0)
        return net, optimizer.AdamW(parameters=net.parameters(),
                                    learning_rate=1e-4, weight_decay=0.01)
    try:
        t0 = time.perf_counter()
        net, opt = build()
        vocab = net.bert.embeddings.word_embeddings.weight.shape[0]
        batch = ernie_batch(torch, vocab, ERNIE_B, ERNIE_T)
        n_params = sum(p.numel() for p in net.parameters())
        n_tensors = len(list(net.parameters()))
        say("ernie: ernie-base %d parameters (%d tensors) in %s, built in "
            "%.1f s" % (n_params, n_tensors, next(net.parameters()).dtype,
                        time.perf_counter() - t0))
        L = len(net.bert.layers)
        want = {"fused_dropout_ln_fwd": 2 * L, "fused_dropout_ln_bwd": 2 * L,
                "flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "adamw": n_tensors, "fused_dropout_residual_fwd": 0,
                # the feed-forward's activation dropout a layer and the
                # embeddings' dropout
                "dropout_keep": L + 1}
        tokens = ERNIE_B * ERNIE_T
        d = net.bert.hidden_size
        flops = 6 * n_params * tokens + 12 * L * d * ERNIE_T * tokens
        launches, paths, _, (logits, _), bodies = run_path(
            torch, ck, "ernie", card, net, opt, loss_fn, lambda: batch, ctx,
            tokens, flops, want)
        require(logits.dtype == torch.float32
                and tuple(logits.shape) == (ERNIE_B, ERNIE_T, vocab),
                "ernie: logits %s %s" % (logits.dtype, tuple(logits.shape)))
        # the path counters count bodies run in Python, as the reference's
        # count rises at trace time
        require(paths["flash_dropout"] == L * bodies
                and paths["xla_sdpa"] == 0 and paths["flash"] == 0,
                "ernie: attention paths %s" % paths)
        free_memory(torch)
        graph_against_eager_train(torch, ck, "ernie", net, opt, loss_fn,
                                  [batch, batch], ctx, DROPOUT)
        ernie_masked(torch, ck, flags, net, batch[0][0], ctx)
        del net, opt
        free_memory(torch)
        net, opt = build(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
        graph_against_eager_train(torch, ck, "ernie", net, opt, loss_fn,
                                  [batch, batch], ctx, 0.0)
        del net, opt
        free_memory(torch)
    finally:
        flags.set_flags(saved)
    return launches


def ernie_masked(torch, ck, flags, net, ids, ctx):
    """One ERNIE forward in eval mode with a [B, T] padding mask (half of
    row 1 padded) and use_flash_attention on: every layer takes the plain
    attention (path xla_sdpa), as the reference's gate hands a masked call
    to its composed attention; no flash kernel launches; the output is
    bit-equal to the same call with the flag off."""
    B, T = ids.shape
    pad = torch.ones((B, T), dtype=torch.int64, device="cuda")
    pad[1, T // 2:] = 0
    L = len(net.bert.layers)
    outs = {}
    net.eval()
    try:
        for on in (True, False):
            flags.set_flags({"use_flash_attention": on})
            launches0 = ck.launch_counts()
            paths0 = ck.attention_path_counts()
            with torch.no_grad(), ctx():
                seq, _ = net.bert(ids, attention_mask=pad)
            torch.cuda.synchronize()
            paths = {k: v - paths0[k]
                     for k, v in ck.attention_path_counts().items()}
            outs[on] = (seq, ck.launch_delta(launches0), paths)
    finally:
        flags.set_flags({"use_flash_attention": True})
        net.train()
    seq, launches, paths = outs[True]
    require(paths["xla_sdpa"] == L and paths["flash"] == 0
            and paths["flash_dropout"] == 0,
            "ernie masked forward: attention paths %s, want %d xla_sdpa"
            % (paths, L))
    require(not any(n for k, n in launches.items() if k.startswith("flash")),
            "ernie masked forward launched a flash kernel: %s" % launches)
    require(torch.equal(seq, outs[False][0]),
            "ernie masked forward: flag on and off differ")
    require(bool(torch.isfinite(seq).all()), "ernie masked forward: "
            "non-finite output")
    say("ernie masked forward: [B=%d, T=%d] padding mask (row 1 half "
        "padded), use_flash_attention on: %d xla_sdpa, no flash launch, "
        "output %s %s bit-equal to the flag off"
        % (B, T, paths["xla_sdpa"], tuple(seq.shape), seq.dtype))


def ernie_compare(torch, ck, flags):
    """Path A's kernels against the plain versions on the card: the same
    float32 ernie-base weights, no dropout, the bench's batch, 3 AdamW
    steps at lr 1e-4, without auto_cast."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_base

    def build():
        prandom.seed(0)
        net = ernie_base(seed=0, hidden_dropout_prob=0.0,
                         attention_dropout_prob=0.0)
        net.train()
        opt = optimizer.AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                              parameters=net.parameters())
        crit = BertPretrainingCriterion()
        step = make_train_step(
            net, lambda lg, nl, y1, y2: crit(lg, nl, y1, y2), opt)
        vocab = net.bert.embeddings.word_embeddings.weight.shape[0]
        batch = ernie_batch(torch, vocab, ERNIE_B, ERNIE_T)
        return net, opt, lambda i: step(*batch)
    compare_runs(torch, ck, flags, "ernie", build,
                 ("use_flash_attention", "use_fused_optimizer",
                  "use_fused_dropout_ln"),
                 ("flash_fwd_train", "flash_bwd_dkv", "adamw",
                  "fused_dropout_ln_fwd", "fused_dropout_ln_bwd"),
                 noise_floor=ADAM_NOISE_FLOOR)
# ---------------------------------------------------------------------------
# guards and eval on the training main path (phase 16)

GUARD_WATCHDOG_S, GUARD_HANG_S = 0.5, 1.5
EVAL_STEPS = 10
# make_eval_step's bfloat16 logits against the same forward through the
# plain attention: each of the 12 layers rounds its attention output to
# bfloat16 from float32 sums in another order (REL_TOL["bfloat16"] for one
# call), and the residual stream carries every layer's difference on to
# the logits, so the whole forward is held to four times one call's
# tolerance, relative to the largest logit
EVAL_LOGITS_REL_TOL = 4 * REL_TOL["bfloat16"]


def check_all_finite(torch, all_finite):
    """The guard's test on the card: no NaN, no inf, with float32 and
    bfloat16 gradients, alone or in one of 150 tensors (several launches
    of the multi-tensor pass); 3e38 (finite, where a norm or a sum
    overflows) is no false skip."""
    big = torch.full((4096,), 3e38, device="cuda")
    one = torch.ones((), device="cuda")
    require(bool(all_finite(one, [big, big.bfloat16()])),
            "all_finite: 3e38 read as non-finite")
    for bad in (float("nan"), float("inf"), -float("inf")):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(768 * 768, device="cuda").to(dtype)
            g[12345] = bad
            require(not bool(all_finite(one, [big, g])),
                    "all_finite missed %r in %s" % (bad, dtype))
            many = [torch.randn(65536 + i, device="cuda").to(dtype)
                    for i in range(150)]
            require(bool(all_finite(one, many)),
                    "all_finite: finite %s tensors read as non-finite"
                    % dtype)
            many[97][40000] = bad
            require(not bool(all_finite(one, many)),
                    "all_finite missed %r in tensor 97 of 150 %s"
                    % (bad, dtype))
        require(not bool(all_finite(torch.tensor(bad, device="cuda"),
                                    [big])),
                "all_finite missed a %r loss" % bad)


def gpu_state():
    """The card's SM clock, its maximum, temperature and power draw, as
    nvidia-smi reads them now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (smi.stdout.strip().splitlines() or ["not read"])[0] \
        if smi.returncode == 0 else "not read"


def replay_ms(torch, programs, n):
    """Device ms of each of n replays of `programs`' one graph (CUDA
    events around the replay alone), with no host work between them."""
    (graph,) = programs._graphs.values()
    out = []
    for _ in range(n):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def guard_profile(torch, steps, batch):
    """One profiled step made with the guard off and one with it on:
    ({on: (kernel ms, kernels launched)}, the guard-on step's kernels
    that the guard-off step does not run, as (us, count, name) rows)."""
    out, rows = {}, {}
    for on in (False, True):
        dev_ms, rows[on] = profile_step(torch, steps[on], batch)
        out[on] = (dev_ms, sum(n for _, _, n in rows[on]))
    known = {key for _, key, _ in rows[False]}
    return out, [(t, n, key) for t, key, n in rows[True] if key not in known]


def guards_main(torch, ck, flags, card, off_ms, off_launches):
    """Phase 16 (see the module's note): the non-finite guard, its NaN
    drill, the watchdog and OOM drills through the captured GPT-2 step,
    and make_eval_step, on phase 10's configuration built again."""
    import glob
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import (EvalStep, TrainStep, make_eval_step,
                                      make_train_step)
    from paddle_tpu_torch.jit.engine import all_finite
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small
    from paddle_tpu_torch.observability import flight, metrics, tracing
    from paddle_tpu_torch.resilience import chaos, watchdog

    check_all_finite(torch, all_finite)
    names = ["skip_nonfinite_steps", "step_watchdog_s",
             "step_watchdog_action"]
    saved = flags.get_flags(names)
    crit = GPTPretrainingCriterion()
    loss_fn = lambda o, l: crit(o, l)  # noqa: E731
    prandom.seed(0)
    model = gpt2_small(seed=0)
    model.train()
    opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                          parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    L = len(model.gpt.layers)
    n_tensors = len(list(model.parameters()))
    loader = io.DataLoader(token_stream(io, model.gpt.vocab_size, TRAIN_T),
                           batch_size=TRAIN_B, prefetch_to_device=2)
    it = iter(loader)

    def batch():
        ids = next(it)
        return [ids[:, :-1]], [ids[:, 1:]]
    params = list(model.parameters())

    def snapshot():
        moments = [a for p in params
                   for a in opt._get_accumulators(p).values()]
        return ([p.detach().clone() for p in params],
                [m.clone() for m in moments])

    def restore(state, rng):
        with torch.no_grad():
            moments = [a for p in params
                       for a in opt._get_accumulators(p).values()]
            for t, v in zip(params + moments, state[0] + state[1]):
                t.copy_(v)
        opt._step_count = 0
        prandom.set_rng_state(rng)

    same = lambda a, b: all(torch.equal(x, y)  # noqa: E731
                            for x, y in zip(a[0] + a[1], b[0] + b[1]))
    counters0 = (tracing.RETRACES.labels("jit_train").value,
                 tracing.RETRACES.labels("jit_eval").value,
                 tracing.TRAIN_STEPS.value)
    ran = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_guards_")
    try:
        # (1) the guard's cost: steps made with the guard off and on, each
        # first run as phase 10's (3 warm-up + 10 timed; its launches
        # checked against phase 10's), then in pairs, one step of each
        # with the order flipped every pair, so that a card or a host that
        # drifts during the phase moves both alike
        steps = {}
        for on in (False, True):
            flags.set_flags({"skip_nonfinite_steps": on})
            steps[on] = make_train_step(model, loss_fn, opt)
        n = TRAIN_WARMUP + TRAIN_STEPS
        for on in (False, True):
            before = ck.launch_counts()
            losses, _, _ = timed_steps(torch, steps[on], batch, TRAIN_WARMUP,
                                       TRAIN_STEPS)
            launches = ck.launch_delta(before)
            ran += n
            require(all(math.isfinite(x) for x in losses),
                    "guards (1): losses %s" % losses)
            require(launches == off_launches,
                    "guards (1) guard %s: launches %s, phase 10's %s"
                    % (on, launches, off_launches))
        state0 = gpu_state()
        times = {False: [], True: []}
        for i in range(2 * TRAIN_STEPS):
            for on in (False, True) if i % 2 == 0 else (True, False):
                times[on] += timed_steps(torch, steps[on], batch, 0, 1)[1]
                ran += 1
        # the replays alone, in the same pairs: the step's device time with
        # the gaps between its kernels, and none of the host's work
        rep = {False: [], True: []}
        for i in range(2 * TRAIN_STEPS):
            for on in (False, True) if i % 2 == 0 else (True, False):
                rep[on] += replay_ms(torch, steps[on].programs, 1)
        state1 = gpu_state()
        require(steps[True].skipped_steps == 0,
                "guards (1): %d steps skipped" % steps[True].skipped_steps)
        step_g = steps[True]
        off_t, on_t = (statistics.median(times[k]) for k in (False, True))
        off_r, on_r = (statistics.median(rep[k]) for k in (False, True))
        pair_t = statistics.median(b - a for a, b in zip(times[False],
                                                        times[True]))
        pair_r = statistics.median(b - a for a, b in zip(rep[False],
                                                        rep[True]))
        prof, added = guard_profile(torch, steps, batch)
        ran += 2
        progs = step_g.programs
        (key,) = progs.builds
        say("guards (1) captured step, skip_nonfinite_steps off / on, %d "
            "pairs of steps: %.2f / %.2f ms median, the pairs' difference "
            "%+.3f ms median (%+.2f %%); phase 10's guard off %.2f ms; the "
            "graph's replay alone (CUDA events, %d pairs) %.3f / %.3f ms "
            "median, difference %+.3f ms median; port kernel launches a "
            "step %s, as phase 10's, both ways; captured in %.1f ms, graph "
            "pool %.1f MiB; card (SM clock, max SM clock, temperature, "
            "power draw) before the pairs %s, after %s (%s)"
            % (2 * TRAIN_STEPS, off_t, on_t, pair_t, 100.0 * pair_t / off_t,
               off_ms, 2 * TRAIN_STEPS, off_r, on_r, pair_r,
               {k: v // n for k, v in launches.items() if v},
               progs.capture_s[key] * 1e3, progs.pool_bytes() / 2 ** 20,
               state0, state1, card))
        if prof[False][0] > 0 and prof[True][0] > 0:
            (off_dev, off_n), (on_dev, on_n) = prof[False], prof[True]
            say("guards (1) one profiled step each way (torch.profiler): "
                "kernels %.3f / %.3f ms (%+.3f ms; the kernels only the "
                "guard-on step runs %.3f ms), %d / %d kernels launched "
                "(%+d); device idle against the median steps %.3f / %.3f "
                "ms (%+.3f ms) (%s)"
                % (off_dev, on_dev, on_dev - off_dev,
                   sum(t for t, _, _ in added) / 1e3, off_n, on_n,
                   on_n - off_n, off_t - off_dev, on_t - on_dev,
                   (on_t - on_dev) - (off_t - off_dev), card))
            for t_us, cnt, name in sorted(added, reverse=True):
                say("  guard kernel %9.1f us/step %4d launches  %s"
                    % (t_us, cnt, name[:90]))
        else:
            say("guards (1) step profiles: not measured (the profiler saw "
                "no device activity)")
        train_built = steps[False].compiles
        del steps
        free_memory(torch)

        # (2) the NaN drill, captured and through the eager bodies
        state0, rng0 = snapshot(), prandom.get_rng_state()
        fixed = [batch() for _ in range(5)]
        it.close()
        chaos.configure("nan_at_step:3")

        def drill(step):
            out = {"loss": [], "skipped": [], "adamw": [], "state": []}
            for b in fixed:
                mark = ck.launch_counts()
                loss, _ = step(*b)
                torch.cuda.synchronize()
                out["adamw"].append(ck.launch_delta(mark)["adamw"])
                out["loss"].append(loss)
                out["skipped"].append(step.last_step_skipped)
                out["state"].append(snapshot())
            return out
        restore(state0, rng0)
        step_n = make_train_step(model, loss_fn, opt)
        require(step_n.guard and step_n.nan_step == 3,
                "guards (2): the step did not read the drill")
        g = drill(step_n)
        restore(state0, rng0)
        e = drill(eager_train_step(TrainStep)(model, loss_fn, opt))
        chaos.reset()
        ran += 10
        nan = [math.isnan(float(x)) for x in g["loss"]]
        require(nan == [False, False, True, False, False],
                "guards (2): NaN losses at %s" % nan)
        require(g["skipped"] == e["skipped"] == nan
                and step_n.skipped_steps == 1,
                "guards (2): skipped %s (eager %s), skipped_steps %d"
                % (g["skipped"], e["skipped"], step_n.skipped_steps))
        require(same(g["state"][2], g["state"][1]),
                "guards (2): the skipped step changed parameters or moments")
        require(not same(g["state"][3], g["state"][2]),
                "guards (2): step 4 did not move the model")
        require(g["adamw"] == [n_tensors] * 5,
                "guards (2): AdamW launches a step %s" % g["adamw"])
        same_loss = lambda a, b: (torch.equal(a, b)  # noqa: E731
                                  or bool(a.isnan() and b.isnan()))
        require(all(same_loss(a, b) for a, b in zip(g["loss"], e["loss"]))
                and all(same(a, b) for a, b in zip(g["state"], e["state"])),
                "guards (2): the captured drill differs from the eager "
                "bodies'")
        say("guards (2) NaN drill (nan_at_step:3, 5 steps through the "
            "captured graph): losses %s, skipped %s, skipped_steps %d; "
            "parameters and moments after step 3 bit-equal to after step 2; "
            "AdamW launches a step %s; every step's loss, parameters and "
            "moments bit-equal to the eager bodies' drill"
            % (["%.4f" % float(x) for x in g["loss"]], g["skipped"],
               step_n.skipped_steps, g["adamw"]))
        del step_n, g, e
        free_memory(torch)

        # (3) the watchdog
        restore(state0, rng0)
        dump = os.path.join(tmp, "watchdog.txt")
        os.environ[watchdog.ENV_FILE] = dump
        flags.set_flags({"step_watchdog_s": GUARD_WATCHDOG_S,
                         "step_watchdog_action": "warn"})
        chaos.configure("hang_at_step:2:%g" % GUARD_HANG_S)
        try:
            wd = [step_g(*fixed[i]) for i in range(2)]
        finally:
            chaos.reset()
            flags.set_flags({"step_watchdog_s": 0.0})
            os.environ.pop(watchdog.ENV_FILE, None)
        ran += 2
        text = open(dump).read() if os.path.exists(dump) else ""
        require("'compiled train step 2' exceeded" in text,
                "guards (3): no watchdog dump names compiled train step 2")
        require(all(math.isfinite(float(x[0])) for x in wd),
                "guards (3): losses %s" % [float(x[0]) for x in wd])
        say("guards (3) watchdog: step_watchdog_s=%g, hang_at_step:2:%g, "
            "warn: %s dumps %d bytes naming compiled train step 2; losses "
            "%s" % (GUARD_WATCHDOG_S, GUARD_HANG_S, os.path.basename(dump),
                    len(text), ["%.4f" % float(x[0]) for x in wd]))

        # (4) the OOM drill
        restore(state0, rng0)
        flight_dir = os.path.join(tmp, "flight")
        os.environ[flight.ENV_DIR] = flight_dir
        flight.reset()
        oom = metrics.REGISTRY.get("pt_oom_total")
        oom0 = oom.value if oom is not None else 0
        chaos.configure("oom:2")
        try:
            step_g(*fixed[0])
            try:
                step_g(*fixed[1])
                raised = None
            except RuntimeError as err:    # the drill's expected failure
                raised = str(err)
            built = (step_g.compiles, step_g.replays)
            after, _ = step_g(*fixed[2])
        finally:
            chaos.reset()
        ran += 2
        require(raised is not None and "RESOURCE_EXHAUSTED" in raised,
                "guards (4): the oom:2 call raised %r" % raised)
        require((step_g.compiles, step_g.replays) == (built[0], built[1] + 1)
                and math.isfinite(float(after)),
                "guards (4): the call after the OOM built %d programs"
                % (step_g.compiles - built[0]))
        bundles = glob.glob(os.path.join(flight_dir, "crash", "*"))
        require(len(bundles) == 1 and os.path.exists(
            os.path.join(bundles[0], "memory.json")),
            "guards (4): bundles %s" % bundles)
        with open(os.path.join(bundles[0], "memory.json")) as f:
            mem = json.load(f)
        n_oom = metrics.REGISTRY.get("pt_oom_total").value - oom0
        require(mem["engine"] == "jit_train" and mem["step"] == 2
                and n_oom == 1 and mem.get("buffers"),
                "guards (4): memory.json engine %s step %s, pt_oom_total "
                "+%d" % (mem["engine"], mem["step"], n_oom))
        say("guards (4) OOM drill (oom:2): the call raised RESOURCE_EXHAUSTED"
            ", bundle %s with memory.json (engine %s, step %d, %d live "
            "blocks, %.1f MiB; jit_train banked %.1f MiB held + %.1f MiB "
            "pool), pt_oom_total +%d; the next call replayed with no build"
            % (os.path.basename(bundles[0]), mem["engine"], mem["step"],
               mem["buffers"]["n_arrays"],
               mem["buffers"]["total_bytes"] / 2 ** 20,
               mem["executables"]["jit_train"]["args_bytes"] / 2 ** 20,
               mem["executables"]["jit_train"]["temp_bytes"] / 2 ** 20,
               n_oom))
        last = dict(flight._last_dispatch or {})
        require(last.get("engine") == "jit_train"
                and last.get("step") == opt._step_count,
                "guards (6): the flight recorder's last dispatch %s, last "
                "step %d" % (last, opt._step_count))
        flight.reset()
        os.environ.pop(flight.ENV_DIR, None)
        train_built += step_g.compiles + 1         # step_n's one program
        del step_g
        free_memory(torch)

        # (5) make_eval_step
        model.eval()
        ev = make_eval_step(model, loss_fn)
        x, y = fixed[0]
        w0 = [p.detach().clone() for p in params]
        mark = ck.launch_counts()
        t0 = time.perf_counter()
        ev(x, y)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        times = []
        for _ in range(EVAL_STEPS):
            t0 = time.perf_counter()
            loss, (logits,) = ev(x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = ck.launch_delta(mark)
        progs = ev.programs
        (key,) = progs.builds
        replayed = {k: progs.replays[key] * v
                    for k, v in progs.launches[key].items()}
        eager_loss, _ = eager_train_step(EvalStep)(model, loss_fn)(x, y)
        # the same forward through the plain attention (the flag off):
        # holds the flash forward's 12 calls a replay to their plain
        # version, through the whole model
        flags.set_flags({"use_flash_attention": False})
        try:
            paths0 = ck.attention_path_counts()
            mark_plain = ck.launch_counts()
            plain_loss, (plain_logits,) = eager_train_step(EvalStep)(
                model, loss_fn)(x, y)
            torch.cuda.synchronize()
            plain_paths = {k: v - paths0[k]
                           for k, v in ck.attention_path_counts().items()}
            plain_launches = ck.launch_delta(mark_plain)
        finally:
            flags.set_flags({"use_flash_attention": True})
        model.train()
        loss_err = abs(float(loss) - float(plain_loss)) / abs(
            float(plain_loss))
        _, logits_err = abs_rel_err(logits, plain_logits)
        del plain_logits
        require(ev.compiles == 1 and ev.replays == EVAL_STEPS,
                "guards (5): %d programs, %d replays" % (ev.compiles,
                                                         ev.replays))
        require(progs.launches[key]["flash_fwd"] == L
                and replayed["flash_fwd"] == EVAL_STEPS * L,
                "guards (5): flash forward launches %s, through replays %s"
                % (progs.launches[key], replayed))
        require(not any(launches[k] for k in ("flash_fwd_train",
                                              "flash_bwd_dq",
                                              "flash_bwd_dkv", "adamw")),
                "guards (5): the eval step launched %s" % launches)
        require(torch.equal(loss, eager_loss)
                and math.isfinite(float(loss)),
                "guards (5): loss %r, eager body %r" % (float(loss),
                                                        float(eager_loss)))
        require(plain_paths["xla_sdpa"] == L and plain_paths["flash"] == 0
                and not any(n for k, n in plain_launches.items()
                            if k.startswith("flash")),
                "guards (5): the flag-off forward took paths %s, launched %s"
                % (plain_paths, plain_launches))
        require(loss_err <= REL_TOL["bfloat16"]
                and logits_err <= EVAL_LOGITS_REL_TOL,
                "guards (5): against the plain attention, loss %.4g vs %.4g "
                "(relative %.3g > %.0e) or logits relative %.3g > %.0e"
                % (float(loss), float(plain_loss), loss_err,
                   REL_TOL["bfloat16"], logits_err, EVAL_LOGITS_REL_TOL))
        require(all(torch.equal(a, b) for a, b in zip(params, w0)),
                "guards (5): the eval step changed a parameter")
        eval_ms = statistics.median(times)
        say("guards (5) make_eval_step gpt2-small B=%d T=%d O2 bf16, eval "
            "mode, with the criterion: built in %.1f s, %.2f ms median over "
            "%d replays (%.2f mean), %.0f tokens/s; loss %.4f bit-equal to "
            "the eager body; against the plain attention (flag off, %d "
            "xla_sdpa): loss %.4f (relative %.3g, tol %.0e), logits max "
            "abs err %.3g of the largest (tol %.0e); logits %s %s; "
            "launches %s (through replays %s); parameters unchanged (%s)"
            % (TRAIN_B, TRAIN_T, build_s, eval_ms, EVAL_STEPS,
               statistics.mean(times), TRAIN_B * TRAIN_T / (eval_ms / 1e3),
               float(loss), plain_paths["xla_sdpa"], float(plain_loss),
               loss_err, REL_TOL["bfloat16"], logits_err,
               EVAL_LOGITS_REL_TOL, tuple(logits.shape), logits.dtype,
               {k: v for k, v in launches.items() if v},
               {k: v for k, v in replayed.items() if v}, card))
        eval_built = ev.compiles
        del ev

        # (6) telemetry
        got = (tracing.RETRACES.labels("jit_train").value - counters0[0],
               tracing.RETRACES.labels("jit_eval").value - counters0[1],
               tracing.TRAIN_STEPS.value - counters0[2])
        require(got == (train_built, eval_built, ran),
                "guards (6): retraces jit_train %d, jit_eval %d, train steps "
                "%d; want %d, %d, %d" % (got + (train_built, eval_built,
                                                ran)))
        say("guards (6) telemetry: jit_train retraces %d = programs built, "
            "jit_eval %d = programs built, pt_train_steps_total +%d = steps "
            "run; the flight recorder's last dispatch named the last step"
            % got)
    finally:
        chaos.reset()
        flags.set_flags(saved)
        os.environ.pop(watchdog.ENV_FILE, None)
        os.environ.pop(flight.ENV_DIR, None)
        shutil.rmtree(tmp, ignore_errors=True)
    del model, opt
    free_memory(torch)
    return on_t, eval_ms


# ---------------------------------------------------------------------------
# resumable training on the training main path (phase 17)

# the resume drill: epochs x steps a run; the preempted run's SIGTERM
# lands before this global step (0-based, in epoch 1), so the run saves
# epoch 1 and stops at its boundary
DRILL_EPOCHS, DRILL_STEPS, DRILL_SIGTERM_STEP = 3, 2, 3
DRILL_TIMEOUT_S = 600
CLIP_PAIRS = 20
# steps timed while an async save's write is in flight, at least
INFLIGHT_STEPS_MIN = 3


def gpt2_recipe(optimizer, parameters, device="cuda", clip=True):
    """The GPT-2 configuration's optimizer: the bench's AdamW(1e-4, weight
    decay 0.01) with the public GPT-2 recipe's warm-up, cosine schedule
    and global-norm clip (nanoGPT's train.py). Returns (optimizer,
    scheduler); the caller steps the scheduler after each train step."""
    from paddle_tpu_torch.optimizer import lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=100),
                            warmup_steps=4, start_lr=0.0, end_lr=1e-4)
    opt = optimizer.AdamW(
        learning_rate=sched, weight_decay=0.01, parameters=parameters,
        grad_clip=optimizer.ClipGradByGlobalNorm(1.0) if clip else None,
        device=device)
    return opt, sched


def state_digest(torch, model, opt):
    """sha256 of every parameter and both its moments, in parameter
    order, bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for p in model.parameters():
        for t in [p] + list(opt._get_accumulators(p).values()):
            h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()


def epoch_tokens(io, stream, start, n):
    class EpochTokens(io.Dataset):
        """Items start .. start + n of the bench's token stream: epoch e
        of the drill reads the same batches in every run."""

        def __len__(self):
            return n

        def __getitem__(self, i):
            return stream[start + i]
    return EpochTokens()


def resume_drill(cfg):
    """One run of the resume drill (`--resume-drill JSON`; phase 17 (c)
    and (d), and tests/test_torch_resilience.py on the CPU): the GPT-2
    configuration (`cfg["model"]` from paddle_tpu_torch.models at
    cfg["device"], seed 0, dropouts 0.1, `amp.decorate` O2 when
    cfg["dtype"] is bfloat16, `gpt2_recipe`, make_train_step) in a
    TrainEpochRange of cfg["epochs"] epochs under cfg["root"], each epoch
    cfg["steps"] batches of cfg["B"] x cfg["T"] from a DataLoader over its
    slice of the bench's token stream. It restores the newest intact
    epoch (and the RNG state in its meta), calls chaos.step_hook with the
    global step before each step (as Model.fit does), appends each step's
    loss to cfg["log"], saves every epoch with the RNG state in its meta,
    and prints DRILL_RESTORED <epoch> <step count>, DRILL_SAVED <epoch>
    and, at the end, DRILL_DONE or DRILL_PREEMPTED with `state_digest`."""
    import torch
    from paddle_tpu_torch import amp, io, models, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.resilience import chaos

    dev, B, T, per = cfg["device"], cfg["B"], cfg["T"], cfg["steps"]
    prandom.seed(0)
    model = getattr(models, cfg["model"])(seed=0, device=dev)
    model.train()
    opt, sched = gpt2_recipe(optimizer, model.parameters(), dev)
    if cfg["dtype"] == "bfloat16":
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    crit = models.GPTPretrainingCriterion()
    step = make_train_step(model, lambda o, l: crit(o, l), opt, device=dev)
    tr = TrainEpochRange(cfg["epochs"], "drill", checkpoint_dir=cfg["root"])
    meta = tr.restore(model, opt)
    if meta:
        prandom.set_rng_state(meta["rng"])
    say("DRILL_RESTORED %d %d" % (tr.restored_epoch, opt._step_count))
    stream = token_stream(io, model.gpt.vocab_size, T)
    with open(cfg["log"], "a") as log:
        for epoch in tr.get():
            loader = io.DataLoader(
                epoch_tokens(io, stream, epoch * per * B, per * B),
                batch_size=B, device=dev,
                prefetch_to_device=2 if dev == "cuda" else 0)
            for i, ids in enumerate(loader):
                g = epoch * per + i
                chaos.step_hook(g)
                loss, _ = step([ids[:, :-1]], [ids[:, 1:]])
                sched.step()
                log.write(json.dumps({"step": g, "loss": float(loss)})
                          + "\n")
                log.flush()
            tr.save(layer=model, optimizer=opt,
                    meta={"rng": prandom.get_rng_state()})
            say("DRILL_SAVED %d" % epoch)
    say("DRILL_%s %s" % ("PREEMPTED" if tr.preempted else "DONE",
                         state_digest(torch, model, opt)))
    return 0


def run_drill(root, log, chaos_spec="", **cfg):
    """`resume_drill` in a fresh process (this script with --resume-drill)
    under PADDLE_TPU_CHAOS=chaos_spec: (exit code, stdout, stderr, wall
    seconds, its losses by step from the log)."""
    cfg = dict(cfg, root=root, log=log)
    env = dict(os.environ, PADDLE_TPU_CHAOS=chaos_spec)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--resume-drill",
         json.dumps(cfg)], env=env, capture_output=True, text=True,
        timeout=DRILL_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(
            __file__)))
    losses = {}
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                rec = json.loads(line)
                losses[rec["step"]] = rec["loss"]
    return (out.returncode, out.stdout, out.stderr,
            time.perf_counter() - t0, losses)


def drill_digest(stdout, word):
    """The digest of the DRILL_<word> line of a drill's output, or None."""
    for line in stdout.splitlines():
        if line.startswith("DRILL_%s " % word):
            return line.split()[1]
    return None


def ckpt_counters(metrics):
    """The pt_ckpt_* counters of the registry, by name (and mode)."""
    out = {}
    for name in ("pt_ckpt_bytes_total", "pt_ckpt_corrupt_total",
                 "pt_ckpt_fallback_total", "pt_ckpt_gc_total"):
        m = metrics.REGISTRY.get(name)
        out[name] = m.value if m is not None else 0.0
    saves = metrics.REGISTRY.get("pt_ckpt_saves_total")
    for mode in ("sync", "async"):
        out["pt_ckpt_saves_total{%s}" % mode] = (
            saves.labels(mode).value if saves is not None else 0.0)
    return out


def timed_step(torch, step, sched, batch):
    t0 = time.perf_counter()
    loss, _ = step(*batch)
    torch.cuda.synchronize()
    sched.step()
    return float(loss), (time.perf_counter() - t0) * 1e3


def resume_main(torch, ck, card, off_ms, off_launches):
    """Phase 17 (see the module's note): the GPT-2 configuration's captured
    step and the clip's cost, sync and async saves and a load into the
    built step, the resume drill and the corruption drills."""
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.checkpoint import engine, store
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.resilience import chaos

    tmp = tempfile.mkdtemp(prefix="pt-resume-")
    crit = GPTPretrainingCriterion()
    loss_fn = lambda o, l: crit(o, l)  # noqa: E731
    try:
        prandom.seed(0)
        model = gpt2_small(seed=0)
        model.train()
        opt, sched = gpt2_recipe(optimizer, model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        loader = io.DataLoader(token_stream(io, model.gpt.vocab_size,
                                            TRAIN_T),
                               batch_size=TRAIN_B, prefetch_to_device=2)
        it = iter(loader)

        def batch():
            ids = next(it)
            return [ids[:, :-1]], [ids[:, 1:]]

        # (a) the captured step with the schedule and the clip
        step = make_train_step(model, loss_fn, opt)
        ck.launch_counts(reset=True)
        res = [timed_step(torch, step, sched, batch())
               for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
        launches = ck.launch_counts()
        losses = [r[0] for r in res]
        times = [r[1] for r in res[TRAIN_WARMUP:]]
        require(all(math.isfinite(x) for x in losses),
                "resume (a): non-finite loss %s" % losses)
        require(step.compiles == 1 and step.replays
                == TRAIN_WARMUP + TRAIN_STEPS - 1,
                "resume (a): %d programs built, %d replays"
                % (step.compiles, step.replays))
        for k in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv",
                  "adamw", "dropout_keep"):
            require(launches[k] == off_launches[k],
                    "resume (a): %s launched %d times, phase 10 %d"
                    % (k, launches[k], off_launches[k]))
        scale = float(opt._scalars[ck.SCALE])
        require(0.0 < scale <= 1.0, "resume (a): clip scale %g" % scale)
        step_ms = statistics.median(times)
        say("resume (a) gpt2-small B=%d T=%d O2 bf16, LinearWarmup(4) over "
            "CosineAnnealingDecay(1e-4, 100), ClipGradByGlobalNorm(1.0), "
            "captured: step %.2f ms median over %d timed steps (%.2f mean), "
            "%.0f tokens/s; phase 10's step (constant lr, no clip) %.2f ms; "
            "launches as phase 10's %s; lr staged %.4g at step %d, last "
            "clip scale %.4f; losses %s (%s)"
            % (TRAIN_B, TRAIN_T, step_ms, len(times), statistics.mean(times),
               TRAIN_B * TRAIN_T / (step_ms / 1e3), off_ms,
               {k: v for k, v in launches.items() if v},
               float(opt._scalars[0]), opt._step_count, scale,
               ["%.4f" % x for x in losses], card))

        # the clip's cost: the same model under an optimizer without the
        # clip (its own moments), one step each way a pair, order flipped
        opt_off, sched_off = gpt2_recipe(optimizer, model.parameters(),
                                         clip=False)
        step_off = make_train_step(model, loss_fn, opt_off)
        for _ in range(TRAIN_WARMUP):
            timed_step(torch, step_off, sched_off, batch())
        on_t, off_t = [], []
        state0 = gpu_state()
        for i in range(CLIP_PAIRS):
            ways = ((step, sched, on_t), (step_off, sched_off, off_t))
            for st, sc, acc in (ways if i % 2 else ways[::-1]):
                acc.append(timed_step(torch, st, sc, batch())[1])
        # the replays alone, in the same pairs: device time and the gaps
        # between the kernels, none of the host's work
        rep = {True: [], False: []}
        for i in range(CLIP_PAIRS):
            for on in ((True, False) if i % 2 else (False, True)):
                rep[on] += replay_ms(torch, (step if on else
                                             step_off).programs, 1)
        state1 = gpu_state()
        diffs = [a - b for a, b in zip(on_t, off_t)]
        rdiffs = [a - b for a, b in zip(rep[True], rep[False])]
        say("resume (a) the clip's cost, %d pairs of steps in turns: on "
            "%.2f ms, off %.2f ms median, pair difference %+.3f ms median "
            "(%+.2f %%), min %+.3f, max %+.3f; the graph's replay alone "
            "(CUDA events, %d pairs) on %.3f, off %.3f ms median, "
            "difference %+.3f ms median; card (SM clock, max SM clock, "
            "temperature, power draw) before %s, after %s (%s)"
            % (CLIP_PAIRS, statistics.median(on_t), statistics.median(off_t),
               statistics.median(diffs),
               100 * statistics.median(diffs) / statistics.median(off_t),
               min(diffs), max(diffs), CLIP_PAIRS,
               statistics.median(rep[True]), statistics.median(rep[False]),
               statistics.median(rdiffs), state0, state1, card))
        prof, added = guard_profile(torch, {False: step_off, True: step},
                                    batch)
        if prof[False][0] > 0 and prof[True][0] > 0:
            (off_dev, off_n), (on_dev, on_n) = prof[False], prof[True]
            say("resume (a) one profiled step each way (torch.profiler): "
                "kernels clip off %.3f / on %.3f ms (%+.3f ms; the kernels "
                "only the clipped step runs %.3f ms), %d / %d kernels (%+d) "
                "(%s)" % (off_dev, on_dev, on_dev - off_dev,
                          sum(t for t, _, _ in added) / 1e3, off_n, on_n,
                          on_n - off_n, card))
            for t_us, cnt, name in sorted(added, reverse=True):
                say("  clip kernel %9.1f us/step %4d launches  %s"
                    % (t_us, cnt, name[:90]))
        del step_off, opt_off
        free_memory(torch)

        # (b) saves and a load into the built step
        c0 = ckpt_counters(metrics)
        fixed = batch()
        it.close()
        capture_s = []
        for _ in range(2):          # the first allocates the pinned buffer
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = engine.snapshot(model, opt)
            capture_s.append(time.perf_counter() - t0)
            snap_bytes = sum(int(a.numel()) * a.element_size()
                             for a in snap["arrays"].values())
            n_arrays = len(snap["arrays"])
            del snap
        sync_path = os.path.join(tmp, "sync")
        meta = {"rng": prandom.get_rng_state()}
        saved = state_digest(torch, model, opt)
        saved_t = opt._step_count
        t0 = time.perf_counter()
        engine.save_checkpoint(sync_path, model, opt, meta)
        sync_s = time.perf_counter() - t0
        c1 = ckpt_counters(metrics)
        sync_bytes = c1["pt_ckpt_bytes_total"] - c0["pt_ckpt_bytes_total"]
        require(sync_bytes == snap_bytes and store.is_complete(sync_path),
                "resume (b): %d bytes committed, snapshot %d"
                % (sync_bytes, snap_bytes))
        after_loss, _ = timed_step(torch, step, sched, fixed)
        after = state_digest(torch, model, opt)
        # the same batch's steps with no write in flight, for the in-flight
        # ones below (no loader in either)
        quiet = [timed_step(torch, step, sched, fixed)[1]
                 for _ in range(TRAIN_STEPS)]
        t0 = time.perf_counter()
        pending = engine.save_checkpoint(os.path.join(tmp, "async"), model,
                                         opt, meta, async_=True)
        blocked_s = time.perf_counter() - t0
        inflight = []
        while not pending.done or len(inflight) < INFLIGHT_STEPS_MIN:
            inflight.append(timed_step(torch, step, sched, fixed)[1])
            if len(inflight) >= 200:
                break
        pending.wait(120)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_meta = engine.load_checkpoint(sync_path, model, opt)
        load_s = time.perf_counter() - t0
        prandom.set_rng_state(got_meta["rng"])
        require(state_digest(torch, model, opt) == saved
                and opt._step_count == saved_t,
                "resume (b): the load did not restore the saved state")
        again_loss, _ = timed_step(torch, step, sched, fixed)
        require(again_loss == after_loss
                and state_digest(torch, model, opt) == after
                and step.compiles == 1,
                "resume (b): the step after the load gave loss %r (%r "
                "after the save), %d programs built"
                % (again_loss, after_loss, step.compiles))
        c2 = ckpt_counters(metrics)
        say("resume (b) sync save: %d arrays, %d bytes (%.3f GB), host "
            "capture %.3f s (the first, which allocates the pinned buffer, "
            "%.3f s), total %.3f s (%.2f GB/s); async save: blocked %.3f s, "
            "committed after %.3f s, %d steps on one batch while its write "
            "was in flight, %.2f ms median (%.2f max) against %.2f ms with "
            "no write (%d steps, the same batch); load %.3f s (verified, "
            "copied into the built step); the step after the load bit-equal "
            "to the step after the save (loss %.6f, parameters and moments), "
            "%d program built; counters %s (%s)"
            % (n_arrays, sync_bytes, sync_bytes / 1e9, capture_s[1],
               capture_s[0], sync_s, sync_bytes / 1e9 / sync_s, blocked_s,
               write_s, len(inflight), statistics.median(inflight),
               max(inflight), statistics.median(quiet), len(quiet), load_s,
               after_loss, step.compiles,
               {k: v - c0[k] for k, v in c2.items() if v != c0[k]}, card))
        n_state = len(model.state_dict())
        n_params = len(list(model.parameters()))
        del step, model, opt, fixed, loader, it
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        free_memory(torch)

        # (c) the resume drill, each run a fresh process
        cfg = dict(device="cuda", model="gpt2_small", B=TRAIN_B, T=TRAIN_T,
                   epochs=DRILL_EPOCHS, steps=DRILL_STEPS, dtype="bfloat16")
        total = DRILL_EPOCHS * DRILL_STEPS

        def drill(name, spec="", root=None):
            rc, out, err, wall, losses = run_drill(
                root or os.path.join(tmp, name),
                os.path.join(tmp, name + ".jsonl"), spec, **cfg)
            return rc, out, err, wall, losses

        rc, out, err, wall_u, ref = drill("uninterrupted")
        ref_digest = drill_digest(out, "DONE")
        require(rc == 0 and ref_digest and len(ref) == total,
                "resume (c) uninterrupted run: rc %d, %d losses\n%s"
                % (rc, len(ref), err[-2000:]))
        shutil.rmtree(os.path.join(tmp, "uninterrupted"), ignore_errors=True)
        root = os.path.join(tmp, "preempted")
        rc, out, err, wall_p, part1 = drill(
            "preempted", "sigterm_at_step:%d" % DRILL_SIGTERM_STEP, root)
        stop = (DRILL_SIGTERM_STEP // DRILL_STEPS + 1) * DRILL_STEPS
        require(rc == 0 and drill_digest(out, "PREEMPTED")
                and "DRILL_SAVED %d" % (stop // DRILL_STEPS - 1) in out
                and sorted(part1) == list(range(stop)),
                "resume (c) preempted run: rc %d, steps %s\n%s"
                % (rc, sorted(part1), err[-2000:]))
        rc, out, err, wall_r, both = drill("preempted", root=root)
        restored = "DRILL_RESTORED %d %d" % (stop // DRILL_STEPS - 1, stop)
        got_digest = drill_digest(out, "DONE")
        require(rc == 0 and restored in out,
                "resume (c) relaunch: rc %d, want %r\n%s\n%s"
                % (rc, restored, out[-1000:], err[-2000:]))
        require(both == ref and got_digest == ref_digest,
                "resume (c) relaunch differs from the uninterrupted run: "
                "losses %s against %s, digest %s against %s"
                % (both, ref, got_digest, ref_digest))
        say("resume (c) drill, gpt2-small B=%d T=%d O2 bf16, dropout %g, %d "
            "epochs x %d steps, a fresh process each: the uninterrupted run "
            "(%.1f s); under PADDLE_TPU_CHAOS=sigterm_at_step:%d the run "
            "saved epoch %d and exited 0 at its boundary (%.1f s); the "
            "relaunch restored it (step count %d) and ran on (%.1f s): "
            "losses %s bit-equal, final parameters and moments sha256 %s "
            "equal to the uninterrupted run's (%s)"
            % (TRAIN_B, TRAIN_T, DROPOUT, DRILL_EPOCHS, DRILL_STEPS, wall_u,
               DRILL_SIGTERM_STEP, stop // DRILL_STEPS - 1, wall_p, stop,
               wall_r, [ref[k] for k in sorted(ref)], ref_digest[:16], card))
        shutil.rmtree(root, ignore_errors=True)

        # (d) bitflip: load_latest quarantines and falls back
        prandom.seed(0)
        model = gpt2_small(seed=0)
        opt, _ = gpt2_recipe(optimizer, model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        p0, p1 = os.path.join(tmp, "epoch_0"), os.path.join(tmp, "epoch_1")
        good = state_digest(torch, model, opt)       # makes the moments
        engine.save_checkpoint(p0, model, opt, {"epoch": 0})
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(2)
        chaos.configure("bitflip_ckpt:1")
        try:
            engine.save_checkpoint(p1, model, opt, {"epoch": 1})
        finally:
            chaos.reset()
        c0 = ckpt_counters(metrics)
        path, got = engine.load_latest([p1, p0], model, opt)
        c1 = ckpt_counters(metrics)
        corrupt = c1["pt_ckpt_corrupt_total"] - c0["pt_ckpt_corrupt_total"]
        fallback = (c1["pt_ckpt_fallback_total"]
                    - c0["pt_ckpt_fallback_total"])
        require(path == p0 and got == {"epoch": 0} and corrupt == 1
                and fallback == 1 and os.path.isdir(p1 + ".corrupt")
                and state_digest(torch, model, opt) == good,
                "resume (d) bitflip: loaded %s, corrupt +%d, fallback +%d"
                % (path, corrupt, fallback))
        del model, opt
        free_memory(torch)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        # torn write: the blob after one and a half saves, in epoch 1's
        blobs = n_state + 2 * n_params
        spec = "torn_write:%d" % (blobs + blobs // 2)
        root = os.path.join(tmp, "torn")
        rc, out, err, wall_t, part1 = drill("torn", spec, root)
        require(rc == -9 and "DRILL_SAVED 0" in out
                and "DRILL_SAVED 1" not in out,
                "resume (d) torn write: rc %d (want -9, SIGKILL)\n%s\n%s"
                % (rc, out[-1000:], err[-2000:]))
        os.remove(os.path.join(tmp, "torn.jsonl"))
        rc, out, err, wall_t2, again = drill("torn", root=root)
        require(rc == 0 and "DRILL_RESTORED 0 %d" % DRILL_STEPS in out
                and again == {k: v for k, v in ref.items()
                              if k >= DRILL_STEPS}
                and drill_digest(out, "DONE") == ref_digest,
                "resume (d) torn-write relaunch: rc %d, losses %s\n%s"
                % (rc, again, err[-2000:]))
        say("resume (d) bitflip_ckpt:1 on epoch 1's save: load_latest "
            "quarantined it and fell back to epoch 0 (pt_ckpt_corrupt_total "
            "+%d, pt_ckpt_fallback_total +%d), state bit-equal to epoch 0's; "
            "PADDLE_TPU_CHAOS=%s (%d blobs a save): the run died by SIGKILL "
            "in epoch 1's save (%.1f s), the relaunch resumed from epoch 0 "
            "(%.1f s) and its losses and final state equal the "
            "uninterrupted run's (%s)"
            % (corrupt, fallback, spec, blobs, wall_t, wall_t2, card))
    finally:
        chaos.reset()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 18: float16 on the card, GradScaler, the other optimizers


# (b): the eager GradScaler loop's steps, and the overflow drill's scale
# phase 19: bench_resnet50's on-chip shapes (train_bench.py:317-388)
RESNET_B, RESNET_HW, RESNET_CLASSES = 64, 224, 100
RESNET_WARMUP, RESNET_STEPS = 3, 20
RESNET_LR, RESNET_MOMENTUM = 0.01, 0.9
# train_bench.py:379-381: a 224x224 forward is ~4.1 GFLOPs, a step 3x that
RESNET_FLOPS_PER_IMAGE = 3 * 4.1e9
RESNET_PARITY_B, RESNET_PARITY_STEPS = 8, 3
RESNET_GUARD_B, RESNET_GUARD_NAN, RESNET_GUARD_STEPS = 16, 2, 3
RESNET_EVAL_REPLAYS = 10
# kernel-name patterns of the ResNet step's profile groups, first match:
# cuDNN's convolution kernels (implicit GEMMs, their layout transforms)
# before cuBLAS's GEMMs (the classifier)
RESNET_PROFILE_GROUPS = (
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                              "implicit", "nchwToNhwc", "nhwcToNchw")),
    ("pooling", ("max_pool", "avg_pool", "adaptive")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cublas", "cutlass")),
    ("reductions (batch norm statistics)", ("reduce_kernel",)),
    ("elementwise (batch norm, ReLU, casts, Momentum)",
     ("elementwise", "vectorized")))


def resnet_batch(torch, B, seed=0):
    """bench_resnet50's feed on the card: RandomState(seed) images
    rand(B, 3, 224, 224) float32 and labels randint(0, 100, (B, 1))
    int64."""
    rs = np.random.RandomState(seed)
    x = rs.rand(B, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rs.randint(0, RESNET_CLASSES, (B, 1)).astype(np.int64)
    return [torch.from_numpy(x).cuda()], [torch.from_numpy(y).cuda()]


def resnet_setup(seed=0):
    """resnet50(num_classes=100) on the card in train() mode, seeded, with
    Momentum(0.01, 0.9) and the cross entropy over [B, 1] labels."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(num_classes=RESNET_CLASSES, seed=seed)
    model.train()
    opt = optimizer.Momentum(learning_rate=RESNET_LR,
                             momentum=RESNET_MOMENTUM,
                             parameters=model.parameters())
    return model, opt, lambda o, y: F.cross_entropy(o, y)


def resnet_tensors(model, opt):
    """The tensors a step updates: parameters, their velocities, the
    running statistics."""
    params = list(model.parameters())
    return (params + [opt._get_accumulators(p)["velocity"] for p in params]
            + list(model.buffers()))


def resnet_copies(model, opt):
    """Copies of `resnet_tensors`, detached: a copy with autograd history
    would keep the parameters' gradient accumulators alive, made on the
    stream of the step that made them, and a later capture's backward on
    the capture stream would then fail."""
    return [t.detach().clone() for t in resnet_tensors(model, opt)]


def resnet_parity(torch, label, model, opt, loss_fn, batches):
    """From one saved state, the steps of `batches` through a captured step
    and twice through its eager bodies: (the eager runs equal each other,
    the captured run equal the first eager one, the runs' losses and
    tensors)."""
    from paddle_tpu_torch.jit import TrainStep, make_train_step
    step = make_train_step(model, loss_fn, opt)
    step(*batches[0])                        # the build; later calls replay
    torch.cuda.synchronize()
    saved = resnet_copies(model, opt), opt._step_count

    def run(fn):
        with torch.no_grad():
            for t, v in zip(resnet_tensors(model, opt), saved[0]):
                t.copy_(v)
        opt._step_count = saved[1]
        losses = [fn(*b)[0] for b in batches]
        torch.cuda.synchronize()
        return losses, resnet_copies(model, opt)
    eager = eager_train_step(TrainStep)(model, loss_fn, opt)
    e1, e2 = run(eager), run(eager)
    replays = step.replays
    g = run(step)
    require(step.replays == replays + len(batches) and step.compiles == 1,
            "%s: the captured steps did not replay" % label)
    same = lambda a, b: all(torch.equal(x, y)  # noqa: E731
                            for x, y in zip(a[0] + a[1], b[0] + b[1]))
    return same(e1, e2), same(g, e1), g, e1


def resnet_float32_parity(torch, card):
    """Phase 19 (a): float32 ResNet-50 at B=8, captured against eager."""
    model, opt, loss_fn = resnet_setup()
    batches = [resnet_batch(torch, RESNET_PARITY_B, seed=s)
               for s in range(RESNET_PARITY_STEPS)]
    eager_same, graph_same, g, e = resnet_parity(
        torch, "resnet (a)", model, opt, loss_fn, batches)
    note = "cudnn.deterministic off"
    if not (eager_same and graph_same):
        # cuDNN's weight-gradient algorithms may sum with atomics, in an
        # order that changes from run to run: this check alone runs with
        # deterministic algorithms, the timed run (b) without
        worst = max(float((a.double() - b.double()).abs().max())
                    for a, b in zip(g[1], e[1]))
        say("resnet (a) float32: with cudnn.deterministic off the two eager "
            "runs are %s and the captured run %s the eager one (largest "
            "difference %.3g): made again with "
            "torch.backends.cudnn.deterministic = True for this check only"
            % ("equal" if eager_same else "not equal",
               "equals" if graph_same else "differs from", worst))
        note = "cudnn.deterministic on for this check"
        torch.backends.cudnn.deterministic = True
        try:
            eager_same, graph_same, g, e = resnet_parity(
                torch, "resnet (a)", model, opt, loss_fn, batches)
        finally:
            torch.backends.cudnn.deterministic = False
    require(eager_same, "resnet (a): two eager runs from one state differ "
            "with deterministic cuDNN algorithms")
    require(graph_same, "resnet (a): the captured step's losses, parameters, "
            "velocities or running statistics differ from its eager "
            "bodies'")
    n_buf = len(list(model.buffers()))
    say("resnet (a) float32 resnet50 B=%d %dx%d, %d steps from one state "
        "(%s): losses %s; parameters (%d), velocities and running "
        "statistics (%d buffers) bit-equal to the eager bodies, which "
        "repeat themselves bit for bit (%s)"
        % (RESNET_PARITY_B, RESNET_HW, RESNET_HW, RESNET_PARITY_STEPS, note,
           ["%.6f" % float(x) for x in g[0]],
           len(list(model.parameters())), n_buf, card))
    del model, opt


def momentum_ms(torch, model, n=20):
    """Device ms of one Momentum update over `model`'s parameter shapes,
    replayed from a CUDA graph as in the captured step (CUDA events around
    the replay, median of n), on copies of the parameters."""
    from paddle_tpu_torch import optimizer
    params = [torch.nn.Parameter(p.detach().clone())
              for p in model.parameters()]
    pairs = [(p, torch.full_like(p, 1e-3)) for p in params]
    opt = optimizer.Momentum(learning_rate=RESNET_LR,
                             momentum=RESNET_MOMENTUM, parameters=params)
    opt.stage_step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        opt.apply_updates(pairs)             # the velocities made, warm
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.apply_updates(pairs)
    out = []
    for _ in range(n):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out), len(params)


def resnet_timed(torch, ck, card):
    """Phase 19 (b): the bench's run under auto_cast O1 bfloat16."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    model, opt, loss_fn = resnet_setup()
    n_params = sum(p.numel() for p in model.parameters())
    batch = resnet_batch(torch, RESNET_B)
    step = make_train_step(model, loss_fn, opt)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.launch_counts(reset=True)
        F.conv_path_counts(reset=True)
        losses, times, outs = timed_steps(torch, step, lambda: batch,
                                          RESNET_WARMUP, RESNET_STEPS)
        launches = ck.launch_counts()
        convs = F.conv_path_counts()
        peak = torch.cuda.max_memory_allocated()
        dev_ms, top = profile_step(torch, step, lambda: batch)
    n_steps = RESNET_WARMUP + RESNET_STEPS
    require(step.compiles == 1 and step.replays == n_steps,
            "resnet (b): %d programs, %d replays in %d + 1 steps"
            % (step.compiles, step.replays, n_steps))
    require(all(math.isfinite(x) for x in losses),
            "resnet (b): non-finite loss %s" % losses)
    require(sum(launches.values()) == 0,
            "resnet (b): the port's kernels launched on a path that reaches "
            "none: %s" % {k: n for k, n in launches.items() if n})
    n_conv = sum(1 for m in model.modules()
                 if type(m).__name__ == "Conv2D")
    # the body runs in Python at the build (its eager run and its capture)
    # on the card, at every step on the CPU
    bodies = 2 if batch[0][0].is_cuda else n_steps
    require(convs == {"direct": bodies * n_conv, "im2col": 0, "nhwc": 0},
            "resnet (b): conv paths %s (want direct, %d convs in each of "
            "%d body runs)" % (convs, n_conv, bodies))
    dtypes = {str(t.dtype) for t in resnet_tensors(model, opt)}
    require(dtypes == {"torch.float32"} and outs[0].dtype == torch.float32,
            "resnet (b): parameter, velocity or buffer dtypes %s, logits %s "
            "(auto_cast O1 keeps them float32)" % (dtypes, outs[0].dtype))
    progs = step.programs
    (key,) = progs.builds
    step_ms = statistics.median(times)
    mfu = (RESNET_FLOPS_PER_IMAGE * RESNET_B / (step_ms / 1e3)
           / PEAK_FLOPS["bfloat16"])
    say("resnet (b) main path: resnet50 %d parameters, %d convs (conv_algo "
        "direct: %s), B=%d %dx%d, auto_cast O1 bf16, Momentum(%g, %g); "
        "%d timed and warm-up steps (and 1 profiled), losses %s; launches "
        "of the port's kernels %d (no Pallas counterpart on this path)"
        % (n_params, n_conv, convs, RESNET_B, RESNET_HW, RESNET_HW,
           RESNET_LR, RESNET_MOMENTUM, n_steps,
           ["%.4f" % x for x in losses], sum(launches.values())))
    say("resnet (b) program: 1 build + %d replays, captured in %.1f ms, "
        "graph pool %.1f MiB (%s)"
        % (progs.replays[key], progs.capture_s[key] * 1e3,
           progs.pool_bytes() / 2 ** 20, card))
    idle = ("device idle %.1f %% (%.3f ms of kernels in one profiled step)"
            % (100.0 * (1.0 - dev_ms / step_ms), dev_ms) if dev_ms > 0
            else "device idle not measured (the profiler saw no device "
            "activity)")
    say("resnet (b) captured step: %.2f ms median (%.2f mean, min %.2f, max "
        "%.2f) over %d timed steps after %d warm-up, %.1f images/s, MFU "
        "%.4f of 989 TFLOP/s bf16 (3 x 4.1e9 x %d FLOPs a step), peak "
        "memory %.1f MiB, %s (%s)"
        % (step_ms, statistics.mean(times), min(times), max(times),
           len(times), RESNET_WARMUP, RESNET_B / (step_ms / 1e3), mfu,
           RESNET_B, peak / 2 ** 20, idle, card))
    report_profile("resnet (b) captured", dev_ms, step_ms, top,
                   RESNET_PROFILE_GROUPS)
    by_group = {}
    for t_us, name, count in top:            # largest first
        by_group.setdefault(group_of(name, RESNET_PROFILE_GROUPS),
                            []).append((t_us, count, name))
    for group, rows in by_group.items():
        for t_us, count, name in rows[:3]:
            say("  %-10s %9.1f us/step %5d launches  %s"
                % (group.split()[0], t_us, count, name[:110]))
    mom_ms, n_tensors = momentum_ms(torch, model)
    say("resnet (b) Momentum update alone: %.4f ms a step over %d tensors "
        "(%.1f M float32 elements), replayed from a CUDA graph (%s)"
        % (mom_ms, n_tensors, n_params / 1e6, card))
    return model, step_ms


def resnet_guard(torch, ck, flags, card, model):
    """Phase 19 (c): the NaN drill on the trained network at B=16."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.resilience import chaos
    opt = optimizer.Momentum(learning_rate=RESNET_LR,
                             momentum=RESNET_MOMENTUM,
                             parameters=model.parameters())
    loss_fn = lambda o, y: F.cross_entropy(o, y)  # noqa: E731
    saved = flags.get_flags(["skip_nonfinite_steps"])
    flags.set_flags({"skip_nonfinite_steps": True})
    chaos.reset()
    chaos.configure("nan_at_step:%d" % RESNET_GUARD_NAN)
    try:
        step = make_train_step(model, loss_fn, opt)
        require(step.guard and step.nan_step == RESNET_GUARD_NAN,
                "resnet (c): the step did not read the drill")
        states, losses, skipped = [], [], []
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            for s in range(RESNET_GUARD_STEPS):
                loss, _ = step(*resnet_batch(torch, RESNET_GUARD_B, seed=s))
                torch.cuda.synchronize()
                losses.append(float(loss))
                skipped.append(step.last_step_skipped)
                states.append(resnet_copies(model, opt))
    finally:
        chaos.reset()
        flags.set_flags(saved)
    want = [i + 1 == RESNET_GUARD_NAN for i in range(RESNET_GUARD_STEPS)]
    require([math.isnan(x) for x in losses] == want and skipped == want
            and step.skipped_steps == 1,
            "resnet (c): losses %s, skipped %s" % (losses, skipped))
    k = RESNET_GUARD_NAN - 1
    n_p = len(list(model.parameters()))
    groups = (("parameters", 0, n_p), ("velocities", n_p, 2 * n_p),
              ("running statistics", 2 * n_p, len(states[k])))
    for name, a, b in groups:
        require(all(torch.equal(x, y) for x, y in
                    zip(states[k][a:b], states[k - 1][a:b])),
                "resnet (c): the skipped step changed the %s" % name)
        require(not all(torch.equal(x, y) for x, y in
                        zip(states[k + 1][a:b], states[k][a:b])),
                "resnet (c): the step after the skip did not move the %s"
                % name)
    say("resnet (c) guard drill, B=%d, nan_at_step:%d: losses %s, skipped "
        "%s; after the skipped step the parameters, velocities and %d "
        "running statistics are bit-equal to their values before it, and "
        "the next step moves each group (%s)"
        % (RESNET_GUARD_B, RESNET_GUARD_NAN, ["%.4f" % x for x in losses],
           skipped, len(list(model.buffers())), card))


def resnet_eval(torch, ck, card, model):
    """Phase 19 (d): make_eval_step in eval() mode against the eager
    forward."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import make_eval_step
    from paddle_tpu_torch.nn import functional as F
    model.eval()
    loss_fn = lambda o, y: F.cross_entropy(o, y)  # noqa: E731
    x, y = resnet_batch(torch, RESNET_B, seed=7)
    bufs = [b.clone() for b in model.buffers()]
    ev = make_eval_step(model, loss_fn)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        ck.launch_counts(reset=True)
        loss, outs = ev(x, y)
        times = []
        for _ in range(RESNET_EVAL_REPLAYS):
            t0 = time.perf_counter()
            loss, outs = ev(x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = ck.launch_counts()
        with torch.no_grad():
            want = model(*x)
            want_loss = loss_fn(want, *y)
    require(ev.compiles == 1 and ev.replays == RESNET_EVAL_REPLAYS,
            "resnet (d): %d programs, %d replays" % (ev.compiles,
                                                     ev.replays))
    require(sum(launches.values()) == 0,
            "resnet (d): the port's kernels launched: %s" % launches)
    require(all(torch.equal(a, b) for a, b in zip(model.buffers(), bufs)),
            "resnet (d): the eval step wrote a running statistic")
    _, err = abs_rel_err(outs[0], want)
    lerr = abs(float(loss) - float(want_loss)) / max(1.0,
                                                     abs(float(want_loss)))
    require(err <= REL_TOL["bfloat16"] and lerr <= REL_TOL["bfloat16"],
            "resnet (d): eval logits %.3g, loss %.3g from the eager forward "
            "(tolerance %g)" % (err, lerr, REL_TOL["bfloat16"]))
    ms = statistics.median(times)
    say("resnet (d) make_eval_step, eval() mode, B=%d O1 bf16: 1 program, "
        "%d replays, %.2f ms median, %.1f images/s; logits %s the eager "
        "eval forward (max error %.3g of the largest, tolerance %g), loss "
        "%.6f (eager %.6f); no running statistic written (%s)"
        % (RESNET_B, RESNET_EVAL_REPLAYS, ms, RESNET_B / (ms / 1e3),
           "bit-equal to" if torch.equal(outs[0], want) else "within",
           err, REL_TOL["bfloat16"], float(loss), float(want_loss), card))
    model.train()


def resnet_main(torch, ck, flags, card):
    """Phase 19: ResNet-50 training and evaluation on the card, (a)-(d)
    (see the module's docstring). Returns (b)'s median step ms."""
    t0 = time.perf_counter()
    resnet_float32_parity(torch, card)
    free_memory(torch)
    model, step_ms = resnet_timed(torch, ck, card)
    free_memory(torch)
    resnet_guard(torch, ck, flags, card, model)
    free_memory(torch)
    resnet_eval(torch, ck, card, model)
    del model
    free_memory(torch)
    say("resnet phase 19: %.1f s" % (time.perf_counter() - t0))
    return step_ms


SCALER_STEPS = 20
SCALER_DRILL_SCALE = 2.0 ** 24
# (d): the rules through the captured step at reduced depth; each with
# the lr of LinearWarmup(CosineAnnealingDecay(base lr, 100), 2) from base
# lr / 10
OPT_LAYERS, OPT_STEPS = 2, 3
OPT_RULES = (("SGD", {}, 1e-3), ("Momentum", {"momentum": 0.9}, 1e-3),
             ("Momentum", {"momentum": 0.9, "use_nesterov": True}, 1e-3),
             ("Lars", {"lars_weight_decay": 5e-4}, 1e-2),
             ("Adamax", {}, 1e-4), ("Adagrad", {}, 1e-3),
             ("Adadelta", {}, 1.0), ("RMSProp", {"momentum": 0.9}, 1e-4),
             ("RMSProp", {"centered": True}, 1e-4),
             ("Ftrl", {"l1": 1e-4, "l2": 1e-4}, 1e-2),
             ("DecayedAdagrad", {}, 1e-3),
             ("ProximalGD", {"l1": 1e-5, "l2": 1e-5}, 1e-3),
             ("ProximalAdagrad", {"l1": 1e-5, "l2": 1e-5}, 1e-3))


def no_decay(p):
    """LayerNorm weights and every bias, by qualified name: the weight
    decay exclusion of BERT's LAMB recipe."""
    name = getattr(p, "qualname", "") or ""
    return name.endswith(".bias") or "norm" in name or ".ln_" in name


def f16_main(torch, ck, F, flags, timer, gen, shapes, card):
    """Phase 18 (a): the float16 instances' device times at the main
    path's shapes (rows 1t, 2, 3 at B=16, H=12, T=512, D=64, causal,
    p=0.1; row 7 over every gpt2-small parameter; rows 4-6 at path B's
    N=8192, Hd=768), each beside its bound (the same bytes as bfloat16)
    and PyTorch's float16 call; then GPT-2 training in float16 (decorate
    O2 float16, auto_cast O2 float16) through `train_main` with the fused
    flags off and on (path B). Returns (times, launches flags off,
    launches path B)."""
    sfx = ck.F16
    times = {"flash_fwd_train" + sfx: fwd_timings(
        torch, ck, F, timer, gen, TRAIN_B, TRAIN_T, True, DROPOUT,
        "float16")}
    times.update({k + sfx: v for k, v in bwd_timings(
        torch, ck, F, timer, gen, TRAIN_B, TRAIN_T, True, DROPOUT,
        "float16").items()})
    times["adamw" + sfx] = time_adamw(torch, ck, timer, gen, shapes, card,
                                      "float16")
    times.update({k + sfx: v for k, v in time_fused(
        torch, ck, timer, gen, TRAIN_B * TRAIN_T, 768, torch.float16, True,
        "gpt2 (path B)").items()})
    free_memory(torch)
    off, _, off_ms = train_main(torch, ck, flags, card, dtype="float16")
    on, _, on_ms = train_main(torch, ck, flags, card, fused=True,
                              dtype="float16")
    say("train step, gpt2-small B=%d T=%d O2 f16 under auto_cast f16 (%s): "
        "fused flags off %.2f ms, on %.2f ms (median of %d steps each, this "
        "run)" % (TRAIN_B, TRAIN_T, card, off_ms, on_ms, TRAIN_STEPS))
    return times, off, on


def scaler_main(torch, ck, card):
    """Phase 18 (b): the reference's dygraph AMP recipe at full width:
    gpt2-small (dropouts 0.1), decorate O2 float16, AdamW(lr=1e-4,
    weight_decay=0.01), GradScaler(init_loss_scaling=2**15), the bench's
    token stream through DataLoader(prefetch_to_device=2), each step
    `scaler.scale(loss).backward(); scaler.step(opt); opt.clear_grad()`,
    SCALER_STEPS steps, the launch counters zeroed just before and read
    just after: the skipped steps and the scale history, the step ms
    (eager: one found_inf read on the host a step). No auto_cast, as the
    recipe runs in the reference (its eager tape fails under auto_cast,
    ROADMAP.md section 3): the loss is float16, and a float16 loss near
    11 times 2^15 overflows, so the first steps are skipped until the
    scale has halved enough, as in the reference. Then the overflow
    drill: the scale set to 2^24, one step: it must be skipped
    (found_inf), the parameters and moments bit-equal to before it, the
    optimizer's step count unmoved and the scale halved."""
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small

    prandom.seed(0)
    model = gpt2_small(seed=0)
    model.train()
    opt = optimizer.AdamW(learning_rate=TRAIN_LR, weight_decay=0.01,
                          parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    crit = GPTPretrainingCriterion()
    loader = io.DataLoader(token_stream(io, model.gpt.vocab_size, TRAIN_T),
                           batch_size=TRAIN_B, prefetch_to_device=2)
    it = iter(loader)
    params = list(model.parameters())

    def one_step():
        ids = next(it)
        loss = crit(model(ids[:, :-1]), ids[:, 1:])
        scaler.scale(loss).backward()
        t = opt._step_count
        scaler.step(opt)
        opt.clear_grad()
        return loss.detach(), opt._step_count == t

    torch.cuda.synchronize()
    ck.launch_counts(reset=True)
    losses, skipped, times = [], [], []
    scales = [scaler.get_init_loss_scaling()]
    for _ in range(SCALER_STEPS):
        t0 = time.perf_counter()
        loss, sk = one_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        skipped.append(sk)
        scales.append(scaler.get_init_loss_scaling())
    launches = ck.launch_counts()
    taken = SCALER_STEPS - sum(skipped)
    require(all(math.isfinite(x) for x in losses) and taken > 0,
            "scaler (b): losses %s, %d steps taken" % (losses, taken))
    require(launches["adamw" + ck.F16] == len(params) * taken
            and launches["flash_fwd_train" + ck.F16] > 0
            and launches["adamw"] == 0,
            "scaler (b): launches %s for %d steps taken" % (launches, taken))
    say("scaler (b) eager GradScaler loop, gpt2-small B=%d T=%d O2 f16 (a "
        "float16 loss), %d steps: skipped %d (steps %s), scale history %s, "
        "losses %.4f .. %.4f, step %.2f ms median (eager, one found_inf read "
        "a step), %.0f tokens/s, launches %s (%s)"
        % (TRAIN_B, TRAIN_T, SCALER_STEPS, sum(skipped),
           [i + 1 for i, s in enumerate(skipped) if s], scales,
           losses[0], losses[-1], statistics.median(times),
           TRAIN_B * TRAIN_T / (statistics.median(times) / 1e3),
           {k: n for k, n in launches.items() if n}, card))
    # the overflow drill
    moments = [a for p in params for a in opt._get_accumulators(p).values()]
    before = [t.detach().clone() for t in params + moments]
    count = opt._step_count
    scaler.set_init_loss_scaling(SCALER_DRILL_SCALE)
    loss, sk = one_step()
    torch.cuda.synchronize()
    it.close()
    require(sk and opt._step_count == count,
            "scaler (b) drill: a scale of 2^24 did not skip the step")
    require(all(torch.equal(a, b) for a, b in zip(params + moments, before)),
            "scaler (b) drill: the skipped step changed parameters or "
            "moments")
    require(scaler.get_init_loss_scaling() == SCALER_DRILL_SCALE / 2,
            "scaler (b) drill: scale %g after the skip"
            % scaler.get_init_loss_scaling())
    say("scaler (b) overflow drill: scale 2^24, loss %.4f, the step skipped "
        "(found_inf), parameters and moments (%d tensors) bit-equal to "
        "before it, step count %d unmoved, scale now %g"
        % (float(loss), len(params + moments), count,
           scaler.get_init_loss_scaling()))
    del model, opt, params, moments, before
    free_memory(torch)
    return launches


def ernie_lamb(torch, ck, flags, card):
    """Phase 18 (c): ERNIE-base pretraining with LAMB (You et al. 2019,
    its own use): path A's setup (ernie_base at full width and depth,
    seeded, dropouts 0.1, B=32, T=128, auto_cast(level="O2"),
    FLAGS_use_fused_dropout_ln on) with Lamb(learning_rate=1e-4,
    lamb_weight_decay=0.01, exclude_from_weight_decay_fn=no_decay),
    through `run_path` (no AdamW launch), then the captured step against
    its eager bodies over 3 steps from one state: bit-equal. Returns the
    launch counts."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_base

    saved = flags.get_flags(["use_fused_dropout_ln"])
    flags.set_flags({"use_fused_dropout_ln": True})
    crit = BertPretrainingCriterion()
    loss_fn = lambda lg, nl, y1, y2: crit(lg, nl, y1, y2)  # noqa: E731
    ctx = lambda: amp.auto_cast(level="O2")  # noqa: E731
    try:
        net = ernie_base(seed=0)
        net.train()
        prandom.seed(0)
        opt = optimizer.Lamb(learning_rate=1e-4, lamb_weight_decay=0.01,
                             exclude_from_weight_decay_fn=no_decay,
                             parameters=net.parameters())
        vocab = net.bert.embeddings.word_embeddings.weight.shape[0]
        batch = ernie_batch(torch, vocab, ERNIE_B, ERNIE_T)
        n_params = sum(p.numel() for p in net.parameters())
        excluded = sum(1 for p in net.parameters() if no_decay(p))
        L = len(net.bert.layers)
        want = {"fused_dropout_ln_fwd": 2 * L, "fused_dropout_ln_bwd": 2 * L,
                "flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "adamw": 0, "fused_dropout_residual_fwd": 0,
                "dropout_keep": L + 1}
        tokens = ERNIE_B * ERNIE_T
        d = net.bert.hidden_size
        flops = 6 * n_params * tokens + 12 * L * d * ERNIE_T * tokens
        say("ernie lamb: ernie-base %d parameters, %d of %d tensors excluded "
            "from the decay (LayerNorm, biases)"
            % (n_params, excluded, len(list(net.parameters()))))
        launches, _, _, _, _ = run_path(
            torch, ck, "ernie lamb", card, net, opt, loss_fn, lambda: batch,
            ctx, tokens, flops, want)
        free_memory(torch)
        graph_against_eager_train(torch, ck, "ernie lamb", net, opt,
                                  loss_fn, [batch] * 3, ctx, DROPOUT)
        del net, opt
        free_memory(torch)
    finally:
        flags.set_flags(saved)
    return launches


def optimizer_sweep(torch, ck, flags, card):
    """Phase 18 (d): each capturable rule but Adam/AdamW (OPT_RULES) in the
    captured step on gpt2-small at OPT_LAYERS layers and full width (768),
    B=16, T=512, dropouts 0.1, decorate O2 bfloat16, the lr from
    LinearWarmup over CosineAnnealingDecay stepped after every step; from
    one state (parameters, accumulators, step count, schedule, RNG),
    OPT_STEPS steps through the captured step and twice through its
    bodies run eagerly: losses, parameters and accumulators bit-equal
    (the eager runs to each other first), one program; then a step made
    with FLAGS_skip_nonfinite_steps and nan_at_step:2 from the same
    state: step 2 skipped, its parameters and accumulators bit-equal to
    after step 1, step 3 moving them again. Dpsgd: OPT_STEPS eager steps
    (finite, the parameters moved) and make_train_step's first call must
    raise NotImplementedError."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import TrainStep, make_train_step
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small
    from paddle_tpu_torch.optimizer import lr as tlr
    from paddle_tpu_torch.resilience import chaos

    prandom.seed(0)
    model = gpt2_small(seed=0, num_layers=OPT_LAYERS)
    model.train()
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    params = [p for p in model.parameters() if p.requires_grad]
    init = [p.detach().clone() for p in params]
    vocab = model.gpt.vocab_size
    batches = []
    for n in range(OPT_STEPS):
        ids = torch.from_numpy(token_stream_batch(
            np, vocab, TRAIN_B, TRAIN_T, n)).cuda()
        batches.append(([ids[:, :-1]], [ids[:, 1:]]))
    crit = GPTPretrainingCriterion()
    loss_fn = lambda o, l: crit(o, l)  # noqa: E731
    rng0 = prandom.get_rng_state()
    Eager = eager_train_step(TrainStep)
    same = lambda a, b: all(torch.equal(x, y)  # noqa: E731
                            for x, y in zip(a, b))
    rows = []
    t_all = time.perf_counter()
    for name, kw, base_lr in OPT_RULES:
        label = name + "".join(" %s=%s" % kv for kv in kw.items()
                               if kv[0] in ("use_nesterov", "centered"))
        sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(base_lr, T_max=100),
                                 warmup_steps=2, start_lr=base_lr / 10,
                                 end_lr=base_lr)
        opt = getattr(optimizer, name)(learning_rate=sched,
                                       parameters=params, **kw)
        accs = [a for p in params for a in opt._get_accumulators(p).values()]
        accs0 = [a.clone() for a in accs]
        sched0 = sched.state_dict()

        def run(step):
            with torch.no_grad():
                for t, v in zip(params + accs, init + accs0):
                    t.copy_(v)
            opt._step_count = 0
            sched.set_state_dict(dict(sched0))
            prandom.set_rng_state(rng0)
            losses, states, skips, lrs = [], [], [], []
            for b in batches:
                loss, _ = step(*b)
                lrs.append(opt.get_lr())
                sched.step()
                losses.append(loss)
                states.append([t.detach().clone() for t in params + accs])
                skips.append(step.last_step_skipped
                             if isinstance(step, TrainStep) else False)
            torch.cuda.synchronize()
            return losses, states, skips, lrs

        t0 = time.perf_counter()
        step = make_train_step(model, loss_fn, opt)
        g = run(step)
        e1, e2 = run(Eager(model, loss_fn, opt)), run(Eager(model, loss_fn,
                                                            opt))
        require(same(e1[0], e2[0]) and all(same(a, b) for a, b in
                                           zip(e1[1], e2[1])),
                "optimizers (d) %s: two eager runs from one state differ"
                % label)
        require(same(g[0], e1[0]) and all(same(a, b) for a, b in
                                          zip(g[1], e1[1])),
                "optimizers (d) %s: the captured steps differ from the eager "
                "bodies'" % label)
        require(step.compiles == 1 and step.replays == OPT_STEPS - 1,
                "optimizers (d) %s: %d programs, %d replays"
                % (label, step.compiles, step.replays))
        require(not same(g[1][-1][:len(params)], init)
                and all(math.isfinite(float(x)) for x in g[0]),
                "optimizers (d) %s: the parameters did not move, or a loss "
                "is not finite" % label)
        del step
        flags.set_flags({"skip_nonfinite_steps": True})
        chaos.configure("nan_at_step:2")
        try:
            gstep = make_train_step(model, loss_fn, opt)
        finally:
            chaos.reset()
            flags.set_flags({"skip_nonfinite_steps": False})
        d = run(gstep)
        require(d[2] == [False, True, False] and gstep.skipped_steps == 1,
                "optimizers (d) %s drill: skipped %s" % (label, d[2]))
        require(same(d[1][1], d[1][0]) and not same(d[1][2], d[1][1]),
                "optimizers (d) %s drill: the skipped step changed the state, "
                "or step 3 did not move it" % label)
        rows.append((label, ["%.4f" % float(x) for x in g[0]],
                     ["%.3g" % x for x in g[3]], len(accs),
                     (time.perf_counter() - t0) * 1e3))
        del gstep, opt, accs, accs0, g, e1, e2, d
        free_memory(torch)
    for label, losses, lrs, n_acc, ms in rows:
        say("optimizers (d) %s: %d captured steps bit-equal to the eager "
            "bodies (losses %s, lr %s), %d accumulators; nan_at_step:2 "
            "skipped with the state bit-equal across it (%.0f ms for the "
            "rule's runs)" % (label, OPT_STEPS, losses, lrs, n_acc, ms))
    # Dpsgd: eager only
    with torch.no_grad():
        for p, v in zip(params, init):
            p.copy_(v)
    opt = optimizer.Dpsgd(learning_rate=1e-3, clip=10.0,
                          batch_size=float(TRAIN_B), sigma=1e-3,
                          parameters=params, seed=5)
    dl = []
    for x, y in batches:
        loss = loss_fn(model(*x), *y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        dl.append(float(loss.detach()))
    require(all(math.isfinite(x) for x in dl)
            and not same(params, init), "optimizers (d) Dpsgd: %s" % dl)
    try:
        make_train_step(model, loss_fn, opt)(*batches[0])
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise SystemExit("chip_smoke FAILED: make_train_step took Dpsgd")
    say("optimizers (d) Dpsgd: %d eager steps, losses %s; make_train_step "
        "refused it: %s" % (OPT_STEPS, ["%.4f" % x for x in dl], refused))
    say("optimizers (d): %d rules on gpt2-small at %d layers, B=%d T=%d bf16 "
        "O2, in %.1f s (%s)" % (len(OPT_RULES), OPT_LAYERS, TRAIN_B, TRAIN_T,
                                time.perf_counter() - t_all, card))
    del model, opt, params, init
    free_memory(torch)


# ---------------------------------------------------------------------------
# serving


def make_requests(np, n=16):
    """16 prompts of 2-256 tokens asking 16-64 new tokens, from
    RandomState(0); requests 2 and 6 share a 128-token head."""
    rs = np.random.RandomState(0)
    lengths = rs.randint(2, 257, n)
    news = rs.randint(16, 65, n)
    head = rs.randint(1, VOCAB_TOKENS, 128)
    prompts = [rs.randint(1, VOCAB_TOKENS, int(L)) for L in lengths]
    for i in (2, 6):
        tail = rs.randint(1, VOCAB_TOKENS, int(rs.randint(1, 129)))
        prompts[i] = np.concatenate([head, tail])
    return [(p, int(m)) for p, m in zip(prompts, news)]


def recording_engine(torch, GenerationEngine):
    class RecordingEngine(GenerationEngine):
        """Keeps each request's top-2 logit gap at every step (plain
        comparison runs only), keyed by the request's prompt object. The
        step programs write the gaps into a static buffer, which each
        step's replay overwrites: it is read right after the step."""

        batcher = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gaps = {}
            self._gap = torch.zeros(self.max_batch, device=self.device)

        def _logits(self, hidden):
            logits = super()._logits(hidden)
            top = torch.topk(logits.float(), 2, dim=-1).values
            gap = (top[..., 0] - top[..., 1]).reshape(-1)
            self._gap[:gap.numel()].copy_(gap)
            return logits

        def prefill(self, slot, prompt):
            tok = super().prefill(slot, prompt)
            self.gaps.setdefault(id(prompt), []).append(float(self._gap[0]))
            return tok

        def decode(self):
            out = super().decode()
            gap = self._gap.cpu()
            for s, req in enumerate(self.batcher.slots):
                if req is not None:
                    self.gaps.setdefault(id(req.prompt), []).append(
                        float(gap[s]))
            return out
    return RecordingEngine


def eager_engine(GenerationEngine):
    class EagerEngine(GenerationEngine):
        """The engine's step bodies run eagerly on every call: no program
        is built, captured or replayed."""

        def _run(self, key, body):
            body()
    return EagerEngine


def serve(serving, engine, reqs):
    """Serve `reqs` through ContinuousBatcher; returns (requests, wall s,
    the run's decode step wall times in ms)."""
    batcher = serving.ContinuousBatcher(engine)
    engine.batcher = batcher
    steps = []
    decode = engine.decode

    def timed_decode():
        t0 = time.perf_counter()
        out = decode()
        steps.append((time.perf_counter() - t0) * 1e3)
        return out
    engine.decode = timed_decode
    rs = [serving.Request(prompt=p.copy(), max_new_tokens=m)
          for p, m in reqs]
    t0 = time.perf_counter()
    try:
        for r in rs:
            batcher.submit(r)
        batcher.run_until_idle(max_steps=10_000)
    finally:
        # later decode steps (the profile, a second pass) are not this run's
        engine.decode = decode
    wall = time.perf_counter() - t0
    for r in rs:
        require(r.outcome == "completed" and len(r.tokens) == r.max_new_tokens,
                "request %d did not complete (%s, %d/%d tokens)"
                % (r.rid, r.outcome, len(r.tokens), r.max_new_tokens))
    return rs, wall, steps


def profile_decode(torch, engine, n=10):
    """Device time of `n` decode steps from torch.profiler: (kernel ms per
    step, the 5 kernels with most device time). 0 ms when the profiler
    saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine.decode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            engine.decode()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    total_us = sum(t for t, _, _ in rows)
    return total_us / n / 1e3, rows[:5]


def program_launches(engines, launches):
    """Launch accounting through the engines' step programs: each
    program's runs (its build's eager run and its replays) times its
    launches a run must add up to `launches`, the counts of the run.
    Returns (the flash forward's launches by prefill bucket, the launches
    that replays made)."""
    total = dict.fromkeys(launches, 0)
    replayed = dict.fromkeys(launches, 0)
    by_t = {}
    for progs in (eng._programs for eng in engines):
        for key, per_run in progs.launches.items():
            for name, n in per_run.items():
                total[name] += progs.runs(key) * n
                replayed[name] += progs.replays[key] * n
            if key[0] == "prefill":
                by_t[key[1]] = (by_t.get(key[1], 0)
                                + progs.runs(key) * per_run["flash_fwd"])
    require(total == launches,
            "launch counts %s are not the programs' runs x launches %s"
            % (launches, total))
    return by_t, replayed


def report_programs(label, eng, card):
    """The compile-once contract and each program's build."""
    progs = eng._programs
    for key in sorted(progs.builds, key=str):
        say("%s program %s: %d replays, launches a run %s, captured in "
            "%.1f ms (%s)" % (label, key, progs.replays[key],
                              {k: n for k, n in progs.launches[key].items()
                               if n}, progs.capture_s[key] * 1e3, card))
    say("%s programs: %d prefill, %d suffix, %d decode; graph pool %.1f "
        "MiB (%s)" % (label, eng.prefill_compiles,
                      eng.suffix_prefill_compiles, eng.decode_compiles,
                      progs.pool_bytes() / 2**20, card))
    require(eng.decode_compiles == 1,
            "%s: %d decode programs" % (label, eng.decode_compiles))
    require(eng.prefill_compiles <= len(BUCKETS),
            "%s: %d prefill programs" % (label, eng.prefill_compiles))
    require(eng.suffix_prefill_compiles >= 1,
            "%s: no suffix program (requests 2 and 6 share a head)" % label)
    require(all(progs.replays[key] > 0 for key in progs.builds
                if key[0] == "decode"), "%s: decode never replayed" % label)


def serve_line(label, rs, wall, steps, card):
    ntok = sum(len(r.tokens) for r in rs)
    say("%s: %d requests, %d tokens in %.3f s: %.1f tokens/s; TTFT p50 %.1f "
        "ms; %d decode steps, %.2f ms/step median, %.2f ms/step mean (%s)"
        % (label, len(rs), ntok, wall, ntok / wall,
           statistics.median(r.ttft_s for r in rs) * 1e3, len(steps),
           statistics.median(steps), statistics.mean(steps), card))


def serve_again(serving, eng, rq, first, label, card):
    """The same requests again on the same engine, its slots dirty, with a
    fresh prefix cache: every program is built, so every call replays;
    the tokens must be the first pass's."""
    built = dict(eng._programs.builds)
    eng.prefix_cache = serving.PrefixCache(eng.prefix_cache.max_bytes,
                                           eng.buckets)
    rs, wall, steps = serve(serving, eng, rq)
    require(eng._programs.builds == built,
            "%s: the second pass built a program" % label)
    require([r.tokens for r in rs] == [r.tokens for r in first],
            "%s: the second pass gave other tokens" % label)
    serve_line("%s again (every program built, same tokens)" % label, rs,
               wall, steps, card)
    return sum(len(r.tokens) for r in rs) / wall


def graph_against_eager(torch, serving, model, cfg, rq, graph_reqs,
                        graph_state, label, card, **kw):
    """The same requests through the engine's step bodies run eagerly:
    tokens identical and the final cache (k, v, scales, lens) bit-equal
    to the graph-replayed run's."""
    e = eager_engine(serving.GenerationEngine)(model, **cfg, **kw)
    ereqs, wall, steps = serve(serving, e, rq)
    for a, b in zip(graph_reqs, ereqs):
        require(a.tokens == b.tokens,
                "%s: request %d's tokens differ between the replayed "
                "programs and the eager bodies" % (label, a.rid))
    names = ("k", "v", "k_scale", "v_scale", "lens")
    if len(graph_state) == 3:
        names = ("k", "v", "lens")
    for name, g, t in zip(names, graph_state, e.kv.state()):
        require(g.dtype == t.dtype and torch.equal(g, t),
                "%s: the cache's %s differs between the replayed programs "
                "and the eager bodies" % (label, name))
    say("%s graph against eager: %d requests token-identical, %s bit-equal"
        % (label, len(ereqs), ", ".join(names)))
    serve_line("%s eager bodies" % label, ereqs, wall, steps, card)


def report_decode_profile(label, dev_ms, step_ms, top, card):
    if dev_ms > 0:
        say("%s decode step profile: %.3f ms of kernels per step (torch."
            "profiler, 10 steps) vs %.2f ms wall: device idle %.1f %% (%s)"
            % (label, dev_ms, step_ms, 100.0 * (1.0 - dev_ms / step_ms),
               card))
        for t_us, key, count in top:
            say("  %8.1f us/step  %5d launches  %s"
                % (t_us / 10, count, key[:90]))
    else:
        say("%s decode step profile: not measured (the profiler saw no "
            "device activity)" % label)


def compare_tokens(kernel_reqs, plain_reqs, gaps, kv_dtype):
    same = 0
    for a, b in zip(kernel_reqs, plain_reqs):
        if a.tokens == b.tokens:
            same += 1
            continue
        i = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                 if x != y)
        gap = float(gaps[id(b.prompt)][i])
        say("request %d: tokens first differ at step %d, plain top-2 "
            "logit gap %.3g (tie tolerance %.0e)"
            % (a.rid, i, gap, TIE_TOL[kv_dtype]))
        require(gap < TIE_TOL[kv_dtype],
                "request %d differs from the plain run at step %d where "
                "the plain top-2 gap %.3g is no near tie" % (a.rid, i, gap))
    say("compare %s: %d/%d requests token-identical to the plain run, the "
        "rest first differ at near ties" % (kv_dtype, same, len(kernel_reqs)))
    return same


# ---------------------------------------------------------------------------
# the server: InferenceServer on the card


# request i is submitted from thread i % SERVER_THREADS, each thread pausing
# SERVER_STAGGER_S between its submissions
SERVER_THREADS = 4
SERVER_STAGGER_S = 0.005
TELEMETRY_STEPS = 50


def scrape(url, route):
    """(status, body) of a GET on the server's live plane."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url + route, timeout=30) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def statusz(url):
    code, body = scrape(url, "/statusz")
    require(code == 200, "/statusz answered %d" % code)
    return json.loads(body)


def submit_from_threads(srv, reqs):
    """Submit `reqs` from SERVER_THREADS threads; the handles in request
    order."""
    import threading
    handles = [None] * len(reqs)

    def submitter(k):
        for i in range(k, len(reqs), SERVER_THREADS):
            p, m = reqs[i]
            handles[i] = srv.submit(p.tolist(), max_new_tokens=m)
            time.sleep(SERVER_STAGGER_S)
    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(SERVER_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    require(all(h is not None for h in handles),
            "a submitting thread did not submit its requests")
    return handles


def timed_decodes(engines):
    """Record each engine's decode step wall times (ms) into one list."""
    steps = []
    for eng in engines:
        def timed(decode=eng.decode):
            t0 = time.perf_counter()
            out = decode()
            steps.append((time.perf_counter() - t0) * 1e3)
            return out
        eng.decode = timed
    return steps


def server_pass(torch, srv, reqs, plain, gaps, label, kv_dtype, steps,
                card):
    """Serve `reqs` once through the started server `srv`, submitted from
    SERVER_THREADS threads; scrape /healthz and /metrics while it serves
    and /statusz before and after; hold the tokens to the plain run's rule
    and /statusz's serving and hbm blocks to the run. Returns (tokens/s,
    /statusz before, after)."""
    url = srv._http.url
    before = statusz(url)
    del steps[:]
    t0 = time.perf_counter()
    handles = submit_from_threads(srv, reqs)
    code, _ = scrape(url, "/healthz")
    require(code == 200, "%s: /healthz answered %d while serving"
            % (label, code))
    code, text = scrape(url, "/metrics")
    require(code == 200 and "pt_serve_queue_depth" in text,
            "%s: /metrics answered %d without the queue gauge"
            % (label, code))
    rs = [h.request for h in handles]
    for h, (_, m) in zip(handles, reqs):
        require(len(h.result(timeout=600)) == m,
                "%s: request %d gave %d of %d tokens"
                % (label, h.request.rid, len(h.request.tokens), m))
    wall = time.perf_counter() - t0
    after = statusz(url)
    reserved = torch.cuda.memory_reserved()
    code, body = scrape(url, "/healthz")
    require(code == 200, "%s: /healthz answered %d after serving: %s"
            % (label, code, body))
    ntok = sum(len(r.tokens) for r in rs)
    now, then = after["serving"], before["serving"]
    done = now["completed"] - then.get("completed", 0)
    toks = now["tokens"] - then.get("tokens", 0)
    require(done == len(reqs) and toks == ntok,
            "%s: /statusz counted %d requests and %d tokens, the handles "
            "%d and %d" % (label, done, toks, len(reqs), ntok))
    require("ttft_ms" in now, "%s: /statusz has no ttft_ms" % label)
    hbm = after.get("hbm_bytes", {})
    require(0 < hbm.get("in_use", 0) <= reserved,
            "%s: /statusz hbm in_use %s not in (0, reserved %d]"
            % (label, hbm.get("in_use"), reserved))
    compare_tokens(rs, plain, gaps, kv_dtype)
    say("%s: %d requests from %d threads, %d tokens in %.3f s: %.1f "
        "tokens/s; TTFT p50 %.1f ms; %d decode steps, %.2f ms/step median; "
        "/statusz: TTFT p50 %s ms, hbm in_use %.1f MiB (%s)"
        % (label, len(rs), SERVER_THREADS, ntok, wall, ntok / wall,
           statistics.median(r.ttft_s for r in rs) * 1e3, len(steps),
           statistics.median(steps), now["ttft_ms"].get("p50"),
           hbm["in_use"] / 2**20, card))
    return ntok / wall, before, after


def programs_built(engines):
    """Programs the engines built, by StepTelemetry engine label."""
    built = {"serve_prefill": sum(e.prefill_compiles for e in engines),
             "serve_suffix": sum(e.suffix_prefill_compiles for e in engines),
             "serve_decode": sum(e.decode_compiles for e in engines)}
    return {k: n for k, n in built.items() if n}


def retraced(before, after):
    """Programs built between two /statusz reads, by engine."""
    then = before.get("train", {}).get("retraces", {})
    now = after.get("train", {}).get("retraces", {})
    return {e: n - then.get(e, 0) for e, n in now.items() if n - then.get(e, 0)}


def server_run(torch, ck, serving, model, cfg, reqs, plain, gaps, label,
               card, hb_path, workers=1, kv_dtype="float32"):
    """`reqs` through a fresh InferenceServer(workers, http_port=0) twice:
    on fresh engines (each builds its programs), then again with fresh
    prefix caches (one worker: every program built). /statusz's retraces
    must equal the programs built, the heartbeat must be fresh, and the
    launch counts,
    zeroed before the first pass and read after the second, must add up
    to the programs' runs, with the kernels launched through replays.
    Returns (the server, its launches, tokens/s of each pass)."""
    from paddle_tpu_torch.resilience import health
    srv = serving.InferenceServer(model, workers=workers, http_port=0,
                                  kv_dtype=kv_dtype, **cfg)
    engines = srv.engines
    steps = timed_decodes(engines)
    srv.start()
    try:
        torch.cuda.reset_peak_memory_stats()
        ck.launch_counts(reset=True)
        tps1, before, after = server_pass(torch, srv, reqs, plain, gaps,
                                          label, kv_dtype, steps, card)
        built = programs_built(engines)
        require(retraced(before, after) == built,
                "%s: /statusz retraces %s are not the programs built %s"
                % (label, retraced(before, after), built))
        require(all(e.decode_compiles == 1 for e in engines),
                "%s: an engine built no decode program: %s"
                % (label, [e.decode_compiles for e in engines]))
        for e in engines:
            e.prefix_cache = serving.PrefixCache(e.prefix_cache.max_bytes,
                                                 e.buckets)
        # two workers may deal the requests out otherwise the second time,
        # and a worker then builds a program for a bucket new to it
        tps2, before2, after2 = server_pass(
            torch, srv, reqs, plain, gaps, label + " again", kv_dtype,
            steps, card)
        built2 = programs_built(engines)
        new = {k: n - built.get(k, 0) for k, n in built2.items()
               if n != built.get(k, 0)}
        require(retraced(before2, after2) == new,
                "%s: /statusz retraces %s of the second pass are not the "
                "programs it built %s" % (label, retraced(before2, after2),
                                          new))
        require(workers > 1 or not new,
                "%s: the second pass built programs %s" % (label, new))
        say("%s: the second pass built %s" % (label, new or "nothing"))
        launches = ck.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        srv.stop()
    hb = health.read_heartbeat(hb_path)
    stale = health.stale_seconds(hb_path)
    require(hb is not None and hb["pid"] == os.getpid() and stale < 30,
            "%s: heartbeat %s is stale (%s s)" % (label, hb, stale))
    _, replayed = program_launches(engines, launches)
    say("%s launches (both passes) %s, through replays %s" % (
        label, {k: n for k, n in launches.items() if n},
        {k: n for k, n in replayed.items() if n}))
    kernel = "paged_decode_int8" if kv_dtype == "int8" else "paged_decode"
    for name in ("flash_fwd", kernel):
        require(launches[name] > 0 and replayed[name] > 0,
                "%s: %s launched %d times, %d through replays"
                % (label, name, launches[name], replayed[name]))
    say("%s: retraces %s; graph pools %s MiB; peak memory %.1f MiB over "
        "both passes (%s)"
        % (label, retraced(before, after),
           ", ".join("%.1f" % (e._programs.pool_bytes() / 2**20)
                     for e in engines), peak / 2**20, card))
    return srv, launches, tps1, tps2


def crash_drill(serving, model, cfg, flight_dir):
    """A worker whose decode raises on its third call: its handles fail
    with the fault chained, a crash bundle with memory.json is written,
    /healthz reads 503 naming the dead worker, then 200 after stop()."""
    import glob

    class InjectedFault(RuntimeError):
        pass
    srv = serving.InferenceServer(model, workers=1, http_port=0, **cfg)
    eng = srv.engines[0]
    calls = []

    def failing_decode(decode=eng.decode):
        calls.append(1)
        if len(calls) == 3:
            raise InjectedFault("injected decode fault (crash drill)")
        return decode()
    eng.decode = failing_decode
    srv.start()
    try:
        url = srv._http.url
        handles = [srv.submit([1, 2, 3 + i], max_new_tokens=8)
                   for i in range(2)]
        for h in handles:
            try:
                h.result(timeout=120)
                cause = None
            except RuntimeError as e:     # the drill's expected failure
                cause = e.__cause__
            require(isinstance(cause, InjectedFault),
                    "crash drill: a handle did not fail with the fault")
        srv._threads[0].join(30)
        code, body = scrape(url, "/healthz")
        check = json.loads(body)["checks"]["serve_loop"]
        require(code == 503 and "pt-serve-0" in check["detail"],
                "crash drill: /healthz answered %d: %s" % (code, check))
    finally:
        srv.stop()
    code, _ = scrape(url, "/healthz")
    require(code == 200, "crash drill: /healthz answered %d after stop()"
            % code)
    bundles = glob.glob(os.path.join(flight_dir, "crash", "*"))
    files = sorted(os.listdir(bundles[0])) if len(bundles) == 1 else []
    require(files == sorted(["MANIFEST.json", "ring.jsonl", "stacks.txt",
                             "metrics.json", "env.json", "memory.json"]),
            "crash drill: bundles %s, files %s" % (bundles, files))
    with open(os.path.join(bundles[0], "memory.json")) as f:
        memory = json.load(f)
    require(memory.get("device_kind") and memory.get("buffers"),
            "crash drill: memory.json lacks the device or its buffers")
    say("crash drill: both handles failed with the injected fault, "
        "/healthz 503 (%s), 200 after stop(); bundle %s with %s; "
        "memory.json: %d live blocks, %.1f MiB, %d samples"
        % (check["detail"], os.path.basename(bundles[0]), ", ".join(files),
           memory["buffers"]["n_arrays"],
           memory["buffers"]["total_bytes"] / 2**20,
           len(memory["hbm_history"])))


def telemetry_cost(torch, tracing, eng, card):
    """The built engine's decode step wall time with telemetry off and on,
    in turns (off, on, on, off), TELEMETRY_STEPS steps each way. On, the
    phase samples device memory after every step, telemetry's dearest
    setting (the default samples every 0.5 s)."""
    times = {False: [], True: []}
    decode = type(eng).decode          # not the server run's timing wrapper
    for on in (False, True, True, False):
        tracing.enable(on)
        try:
            for _ in range(TELEMETRY_STEPS // 2):
                t0 = time.perf_counter()
                decode(eng)
                times[on].append((time.perf_counter() - t0) * 1e3)
        finally:
            tracing.enable(True)
    off, on = (statistics.median(times[k]) for k in (False, True))
    say("telemetry cost: decode step %.4f ms with tracing off, %.4f ms on "
        "(median of %d each, in turns): %+.2f %% (%s)"
        % (off, on, TELEMETRY_STEPS, 100.0 * (on - off) / off, card))
    # the same steps' kernels: idle slots keep decoding into their tails,
    # so the paged kernel's work grows with each step here
    dev_ms, top = profile_decode(torch, eng)
    report_decode_profile("server (a) engine, idle slots", dev_ms, on, top,
                          card)


# ---------------------------------------------------------------------------
# 20. Model.fit on the card

FIT_ITERS = 13                  # (a): fit's steps, num_iters
FIT_TIMED = 10                  # (a): the last 10 step intervals
FIT_WORKERS = 2                 # (a): DataLoader worker processes
FIT_DRILL = dict(layers=2, B=TRAIN_B, T=TRAIN_T, epochs=2, steps=4,
                 sigterm=5)     # (b): 2 epochs x 4 steps, SIGTERM before 6
FIT_RESNET_WARMUP, FIT_RESNET_STEPS = 3, 20     # (c)
FIT_RESNET_WORKERS = 4
FIT_RESNET_EVAL, FIT_RESNET_PREDICT = 4, 2      # batches
LENET_B, LENET_WARMUP, LENET_STEPS = 256, 2, 50  # (d): bench.py:27-53
LENET_SYNTH = "8192"            # bench.py:17's PADDLE_TPU_SYNTH_SAMPLES


class TokenPairs:
    """The bench's synthetic token stream (benchmarks/train_bench.py) as
    (input ids, next ids) pairs, items start .. start + n: a class at
    module level, so that spawned DataLoader workers can unpickle it."""

    def __init__(self, vocab, T, n=100000, start=0):
        self.vocab, self.T, self.n, self.start = vocab, T, n, start

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rs = np.random.RandomState(self.start + i)
        ids = rs.randint(0, self.vocab, (self.T + 1,)).astype(np.int64)
        return ids[:-1], ids[1:]


class ImageSet:
    """bench_resnet50's data as a map-style dataset: sample i is
    RandomState(i)'s float32 rand(3, 224, 224) image and a [1] int64
    label below 100, or the image alone (`labels=False`, for predict); a
    class at module level, for spawned workers."""

    def __init__(self, n, hw=224, classes=100, labels=True):
        self.n, self.hw, self.classes = n, hw, classes
        self.labels = labels

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        x = rs.rand(3, self.hw, self.hw).astype(np.float32)
        if not self.labels:
            return x
        return x, np.array([rs.randint(0, self.classes)], np.int64)


def fit_recorder(Callback):
    from paddle_tpu_torch.io.prefetch import FEED_STALL

    class Recorder(Callback):
        """Each train batch's logs, the host clock at its end and the feed
        stall histogram's (sum, count) then; with `profile_at`, a
        torch.profiler trace of that batch (its wall ms and kernel
        rows)."""

        def __init__(self, torch=None, profile_at=None):
            super().__init__()
            self.logs, self.ends, self.stalls = [], [], []
            self.torch, self.profile_at = torch, profile_at
            self.prof = self.prof_ms = None

        def on_train_batch_begin(self, step, logs=None):
            if step == self.profile_at:
                from torch.profiler import ProfilerActivity, profile
                self.torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self._t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            if step == self.profile_at and self.prof is not None:
                self.torch.cuda.synchronize()
                self.prof_ms = (time.perf_counter() - self._t0) * 1e3
                self.prof.__exit__(None, None, None)
            self.logs.append(dict(logs or {}))
            self.ends.append(time.perf_counter())
            self.stalls.append((FEED_STALL.sum, FEED_STALL.count))

        def stall_after_first(self):
            """pt_feed_stall_ms a batch over the batches after the first
            (whose wait holds the workers' start)."""
            (s0, n0), (s1, n1) = self.stalls[0], self.stalls[-1]
            return (s1 - s0) / (n1 - n0) if n1 > n0 else float("nan")

        def step_ms(self, last):
            gaps = [(b - a) * 1e3 for a, b in zip(self.ends, self.ends[1:])]
            return statistics.median(gaps[-last:]), gaps[-last:]

        def profile_rows(self):
            from torch.autograd import DeviceType
            rows = sorted(((e.self_device_time_total, e.key, e.count)
                           for e in self.prof.key_averages()
                           if e.device_type == DeviceType.CUDA),
                          reverse=True)
            return sum(t for t, _, _ in rows) / 1e3, rows
    return Recorder


def first_batches(loader, n):
    """The loader's first n host batches; its workers stopped after."""
    it = loader._host_iter()
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def stall_since(FEED_STALL, before):
    n = FEED_STALL.count - before[1]
    return (FEED_STALL.sum - before[0]) / n if n else float("nan")


def gpt2_fit_setup(torch, dev="cuda", name="gpt2_small", **kw):
    """Phase 10's GPT-2 setup for fit: seed 0, gpt2_small (dropouts 0.1;
    `name`: another factory of paddle_tpu_torch.models), AdamW(LinearWarmup
    to 1e-4 over 4 steps, weight_decay=0.01), decorate O2 bfloat16, the
    criterion."""
    from paddle_tpu_torch import amp, models, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.optimizer import lr
    prandom.seed(0)
    model = getattr(models, name)(seed=0, device=dev, **kw)
    model.train()
    sched = lr.LinearWarmup(TRAIN_LR, warmup_steps=4, start_lr=0.0,
                            end_lr=TRAIN_LR)
    opt = optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                          parameters=model.parameters(), device=dev)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model, opt, sched, models.GPTPretrainingCriterion()


def fit_gpt2(torch, ck, card, off_ms, off_launches):
    """Phase 20 (a): GPT-2-small at full width and depth through
    Model.fit, against a make_train_step loop over the same batches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io
    from paddle_tpu_torch.hapi.callbacks import Callback, LRScheduler
    from paddle_tpu_torch.io.prefetch import FEED_STALL
    from paddle_tpu_torch.jit import make_train_step
    Recorder = fit_recorder(Callback)
    model, opt, sched, crit = gpt2_fit_setup(torch)
    vocab = model.gpt.vocab_size
    data = TokenPairs(vocab, TRAIN_T)
    L, n_tensors = len(model.gpt.layers), len(list(model.parameters()))
    want = {"flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "adamw": n_tensors, "dropout_keep": 2 * L + 1}
    # the loader's batches: 2 workers against the consumer's own, in order
    loaders = [io.DataLoader(data, batch_size=TRAIN_B, num_workers=w)
               for w in (FIT_WORKERS, 0)]
    t0 = time.perf_counter()
    host = [first_batches(ld, FIT_ITERS) for ld in loaders]
    mp_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for x, y in zip(*host)
               for a, b in zip(x, y))
    require(len(host[0]) == len(host[1]) == FIT_ITERS and same,
            "fit (a): the batches of %d workers differ from those of 0"
            % FIT_WORKERS)
    say("fit (a): %d batches from %d worker processes (start method %s) "
        "bit-equal to num_workers=0's, in order; pinned: %s"
        % (FIT_ITERS, FIT_WORKERS, "spawn" if torch.cuda.is_initialized()
           else "fork", host[0][0][0].is_pinned()))
    del host
    rec = Recorder(torch, profile_at=FIT_ITERS - 1)
    net = paddle.Model(model)
    net.prepare(opt, crit)
    tdir = tempfile.mkdtemp(prefix="fit_tele_")
    try:
        stall0 = (FEED_STALL.sum, FEED_STALL.count)
        ck.launch_counts(reset=True)
        t0 = time.perf_counter()
        net.fit(data, batch_size=TRAIN_B, shuffle=False,
                num_workers=FIT_WORKERS, num_iters=FIT_ITERS, verbose=0,
                telemetry_dir=tdir,
                callbacks=[LRScheduler(by_step=True), rec])
        fit_s = time.perf_counter() - t0
        launches = ck.launch_counts()
        stall_mp = stall_since(FEED_STALL, stall0)
        doctor = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "tools", "ptdoctor.py"),
             "summary", tdir], capture_output=True, text=True, timeout=120)
    finally:
        shutil.rmtree(tdir, ignore_errors=True)
    step = net._train_step_fn
    progs = step.programs
    (key,) = progs.builds
    replayed = {k: progs.replays[key] * n for k, n in
                progs.launches[key].items()}
    losses = [lg["loss"] for lg in rec.logs]
    require(len(losses) == FIT_ITERS and all(map(math.isfinite, losses)),
            "fit (a): losses %s" % losses)
    require(step.compiles == 1 and step.replays == FIT_ITERS - 1,
            "fit (a): %d programs and %d replays in %d steps"
            % (step.compiles, step.replays, FIT_ITERS))
    per_step = {k: launches[k] / FIT_ITERS for k in want}
    require(per_step == {k: float(v) for k, v in want.items()},
            "fit (a): launches a step %s, want %s (phase 10's)"
            % (per_step, want))
    if off_launches is not None:
        ten = {k: off_launches[k] / (TRAIN_WARMUP + TRAIN_STEPS)
               for k in want}
        require(per_step == ten, "fit (a): launches a step %s, phase 10's "
                "step %s" % (per_step, ten))
    require(all(replayed[k] == v * (FIT_ITERS - 1) for k, v in want.items()),
            "fit (a): launches through replays %s" % replayed)
    require(doctor.returncode == 0, "fit (a): ptdoctor summary failed: "
            + doctor.stderr[-400:])
    require("retraces: jit_train=1" in doctor.stdout
            and "last-alive step=%d" % FIT_ITERS in doctor.stdout,
            "fit (a): ptdoctor summary: " + doctor.stdout[-600:])
    fit_ms, gaps = rec.step_ms(FIT_TIMED)
    dev_ms, top = rec.profile_rows()
    lr_seen = opt.get_lr()
    say("fit (a) GPT-2-small B=%d T=%d O2 bf16 through Model.fit "
        "(num_workers=%d, LRScheduler by step, telemetry_dir): %d steps in "
        "%.1f s, losses %s, lr after %.3g; one program (%d replays), "
        "launches a step %s, all through replays; ptdoctor: %s"
        % (TRAIN_B, TRAIN_T, FIT_WORKERS, FIT_ITERS, fit_s,
           ["%.4f" % x for x in losses], lr_seen, step.replays,
           {k: int(v) for k, v in per_step.items()},
           " | ".join(ln.strip() for ln in doctor.stdout.splitlines()
                      if "retraces" in ln or "last-alive" in ln)))
    del net, step, progs
    model, opt = None, None
    free_memory(torch)

    # the same batches through a make_train_step loop from the same seed
    model, opt, sched, crit = gpt2_fit_setup(torch)
    loop = make_train_step(model, lambda o, y: crit(o, y), opt)
    loader = io.DataLoader(data, batch_size=TRAIN_B, prefetch_to_device=2)
    stall0 = (FEED_STALL.sum, FEED_STALL.count)
    ref, ends = [], []
    feed = iter(loader)
    for _ in range(FIT_ITERS):
        x, y = next(feed)
        loss, _ = loop([x], [y])
        ref.append(float(loss))
        sched.step()
        ends.append(time.perf_counter())
    feed.close()
    stall_0 = stall_since(FEED_STALL, stall0)
    loop_gaps = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])][-FIT_TIMED:]
    loop_ms = statistics.median(loop_gaps)
    require(losses == ref, "fit (a): fit's losses %s differ from the "
            "make_train_step loop's %s" % (losses, ref))
    say("fit (a): the per-step losses bit-equal to a make_train_step loop "
        "over the same batches from the same seed and RNG state (%d steps)"
        % FIT_ITERS)
    idle = ("%.1f %% (%.3f ms of kernels in a %.2f ms profiled fit step)"
            % (100.0 * (1.0 - dev_ms / rec.prof_ms), dev_ms, rec.prof_ms)
            if dev_ms > 0 else "not measured (the profiler saw no device "
            "activity)")
    say("fit (a) step %.2f ms (host clock between batch ends, median of the "
        "last %d; min %.2f max %.2f), the make_train_step loop over the "
        "same batches %.2f ms (the same clock)%s; pt_feed_stall_ms %.3f a "
        "batch at %d workers (%.3f after the first batch, whose wait holds "
        "the workers' start), %.3f at 0 (the loop); device idle in one "
        "profiled fit step %s (%s)"
        % (fit_ms, FIT_TIMED, min(gaps), max(gaps), loop_ms,
           "" if off_ms is None else ", phase 10's captured step %.2f ms"
           % off_ms, stall_mp, FIT_WORKERS, rec.stall_after_first(),
           stall_0, idle, card))
    report_profile("fit (a) profiled", dev_ms, rec.prof_ms, top)
    say("fit (a) host read of the batches from %d workers: %.2f s for %d "
        "batches (with the workers' start)" % (FIT_WORKERS, mp_s, FIT_ITERS))
    del loop, model, opt
    free_memory(torch)
    return {"fit_ms": fit_ms, "loop_ms": loop_ms, "stall_mp": stall_mp,
            "stall_0": stall_0, "stall_later": rec.stall_after_first(),
            "idle": idle}


def fit_drill(cfg):
    """One run of phase 20 (b)'s drill (`--fit-drill JSON`): gpt2_small
    (or cfg["model"]) cut to cfg["layers"] layers at full width (phase
    10's setup otherwise: `gpt2_fit_setup`) through Model.fit over cfg["epochs"] epochs of
    cfg["steps"] batches of cfg["B"] x cfg["T"], with auto_checkpoint_dir
    cfg["root"] and the LRScheduler callback; each step's loss is appended
    to cfg["log"] under its global step (the optimizer's count). Under
    PADDLE_TPU_CHAOS=sigterm_at_step:K fit checkpoints and exits 0; a
    finished fit prints DRILL_DONE with `state_digest`."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.hapi.callbacks import Callback, LRScheduler

    dev, B = cfg["device"], cfg["B"]
    model, opt, _, crit = gpt2_fit_setup(
        torch, dev, cfg.get("model", "gpt2_small"), num_layers=cfg["layers"])

    class Log(Callback):
        def on_train_batch_end(self, step, logs=None):
            with open(cfg["log"], "a") as f:
                f.write(json.dumps({"step": opt._step_count - 1,
                                    "loss": logs["loss"]}) + "\n")

    net = paddle.Model(model, device=dev)
    net.prepare(opt, crit)
    net.fit(TokenPairs(model.gpt.vocab_size, cfg["T"], n=cfg["steps"] * B),
            batch_size=B, epochs=cfg["epochs"], shuffle=False, verbose=0,
            auto_checkpoint_dir=cfg["root"],
            callbacks=[LRScheduler(by_step=True), Log()])
    say("DRILL_DONE %s" % state_digest(torch, model, opt))
    return 0


def run_fit_drill(root, log, chaos_spec="", **cfg):
    """`fit_drill` in a fresh process: (exit code, stdout, stderr, wall s,
    losses by step)."""
    cfg = dict(cfg, root=root, log=log)
    env = dict(os.environ, PADDLE_TPU_CHAOS=chaos_spec)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--fit-drill",
         json.dumps(cfg)], env=env, capture_output=True, text=True,
        timeout=DRILL_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(
            __file__)))
    losses = {}
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                rec = json.loads(line)
                losses[rec["step"]] = rec["loss"]
    return (out.returncode, out.stdout, out.stderr,
            time.perf_counter() - t0, losses)


def fit_preempt(torch, card, **over):
    """Phase 20 (b): the preemption drill, each run a fresh process
    (`over`: settings of the drill's JSON to change, for a rehearsal)."""
    d = FIT_DRILL
    cfg = dict(dict(device="cuda", layers=d["layers"], B=d["B"], T=d["T"],
                    epochs=d["epochs"], steps=d["steps"]), **over)
    total = d["epochs"] * d["steps"]
    with tempfile.TemporaryDirectory() as tmp:
        rc, out, err, s_ref, ref = run_fit_drill(
            os.path.join(tmp, "ref"), os.path.join(tmp, "ref.log"), **cfg)
        require(rc == 0 and sorted(ref) == list(range(total)),
                "fit (b): the uninterrupted fit failed (rc %d, steps %s): %s"
                % (rc, sorted(ref), err[-1500:]))
        want = drill_digest(out, "DONE")
        root, log = os.path.join(tmp, "run"), os.path.join(tmp, "run.log")
        rc1, out1, err1, s1, first = run_fit_drill(
            root, log, "sigterm_at_step:%d" % d["sigterm"], **cfg)
        ckpt = os.path.join(root, "preempt_ckpt")
        require(rc1 == 0 and drill_digest(out1, "DONE") is None
                and sorted(first) == list(range(d["sigterm"] + 1))
                and os.path.isfile(os.path.join(ckpt, "COMMIT")),
                "fit (b): the preempted fit (rc %d, steps %s, checkpoint %s)"
                ": %s" % (rc1, sorted(first), os.path.isdir(ckpt),
                          err1[-1500:]))
        rc2, out2, err2, s2, losses = run_fit_drill(root, log, **cfg)
        got = drill_digest(out2, "DONE")
        require(rc2 == 0 and got is not None,
                "fit (b): the relaunch failed (rc %d): %s" % (rc2,
                                                             err2[-1500:]))
        require(losses == ref, "fit (b): losses %s, uninterrupted %s"
                % (losses, ref))
        require(got == want, "fit (b): the resumed fit's parameters and "
                "moments differ from the uninterrupted fit's")
        require(not os.path.exists(ckpt), "fit (b): preempt_ckpt left "
                "after the clean end")
    say("fit (b) preemption drill (gpt2-small cut to %d layers at full "
        "width, B=%d T=%d, dropouts 0.1, %d epochs x %d steps, "
        "auto_checkpoint_dir): SIGTERM before global step %d -> rc 0 and a "
        "committed preempt_ckpt after step %d; the relaunch resumed at "
        "epoch %d step %d: losses and the sha256 of parameters and AdamW "
        "moments bit-equal to the uninterrupted fit's, preempt_ckpt gone; "
        "runs %.1f / %.1f / %.1f s (%s)"
        % (d["layers"], d["B"], d["T"], d["epochs"], d["steps"],
           d["sigterm"], d["sigterm"], (d["sigterm"] + 1) // d["steps"],
           (d["sigterm"] + 1) % d["steps"], s_ref, s1, s2, card))


def stable_rank(torch, logits, labels):
    """Each row's label's place among its logits, largest first, ties by
    the lower class index: the order of a stable descending sort, counted
    without sorting."""
    p = logits.float()
    lab = labels.reshape(-1).long()
    own = p.gather(1, lab[:, None])
    idx = torch.arange(p.shape[1], device=p.device)
    return ((p > own).sum(1)
            + ((p == own) & (idx[None, :] < lab[:, None])).sum(1))


def fit_resnet(torch, ck, card, resnet_ms):
    """Phase 20 (c): ResNet-50 through fit, evaluate and predict."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, metric
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io.prefetch import FEED_STALL

    class SeenAccuracy(metric.Accuracy):
        """Accuracy that keeps the last logits and labels it was given."""

        def compute(self, pred, label, *args):
            self.last = (pred.detach().clone(), label.detach().clone())
            return super().compute(pred, label, *args)

    Recorder = fit_recorder(Callback)

    class TopK(Recorder):
        def on_train_batch_end(self, step, logs=None):
            pred, lab = acc.last
            rank = stable_rank(torch, pred, lab)
            n = rank.numel()
            want = [int((rank < k).sum()) / n for k in (1, 5)]
            require(logs["acc_top1"] == want,
                    "fit (c) step %d: top-1/top-5 %s, from the logits %s"
                    % (step, logs["acc_top1"], want))
            super().on_train_batch_end(step, logs)

    model, opt, loss_fn = resnet_setup()
    acc = SeenAccuracy(topk=(1, 5))
    net = paddle.Model(model)
    net.prepare(opt, loss_fn, metrics=acc)
    n_fit = (FIT_RESNET_WARMUP + FIT_RESNET_STEPS) * RESNET_B
    rec = TopK()
    eval_set = ImageSet(FIT_RESNET_EVAL * RESNET_B, RESNET_HW,
                        RESNET_CLASSES)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        stall0 = (FEED_STALL.sum, FEED_STALL.count)
        t0 = time.perf_counter()
        net.fit(ImageSet(n_fit, RESNET_HW, RESNET_CLASSES),
                batch_size=RESNET_B, shuffle=False,
                num_workers=FIT_RESNET_WORKERS, verbose=0, callbacks=[rec])
        fit_s = time.perf_counter() - t0
        stall = stall_since(FEED_STALL, stall0)
        step = net._train_step_fn
        bufs = [b.detach().clone() for b in model.buffers()]
        result = net.evaluate(eval_set, batch_size=RESNET_B,
                              num_workers=FIT_RESNET_WORKERS, verbose=0)
        kept = all(torch.equal(a, b) for a, b in zip(model.buffers(), bufs))
        # the eager eval forward over the same batches
        model.eval()
        losses, hits, n, logits = [], [0, 0], 0, []
        with torch.no_grad():
            for b in range(FIT_RESNET_EVAL):
                xs, ys = zip(*[eval_set[i] for i in range(
                    b * RESNET_B, (b + 1) * RESNET_B)])
                x = torch.from_numpy(np.stack(xs)).cuda()
                y = torch.from_numpy(np.stack(ys)).cuda()
                out = model(x)
                losses.append(float(loss_fn(out, y)))
                rank = stable_rank(torch, out, y)
                hits = [h + int((rank < k).sum())
                        for h, k in zip(hits, (1, 5))]
                n += rank.numel()
                if b < FIT_RESNET_PREDICT:
                    logits.append(out.float().cpu().numpy())
        pred = net.predict(ImageSet(FIT_RESNET_PREDICT * RESNET_B,
                                    RESNET_HW, RESNET_CLASSES, False),
                           batch_size=RESNET_B, stack_outputs=True,
                           verbose=0)
    model.train()
    steps = FIT_RESNET_WARMUP + FIT_RESNET_STEPS
    require(len(rec.logs) == steps and step.compiles == 1
            and step.replays == steps - 1,
            "fit (c): %d steps, %d programs, %d replays"
            % (len(rec.logs), step.compiles, step.replays))
    want = {"loss": float(np.mean(losses)),
            "acc_top1": [hits[0] / n, hits[1] / n]}
    require(result == want, "fit (c): evaluate %s, the eager eval forward "
            "over the same batches %s" % (result, want))
    require(kept, "fit (c): evaluate changed a running statistic")
    require(len(pred) == 1 and np.array_equal(pred[0],
                                              np.concatenate(logits)),
            "fit (c): predict's logits differ from the eager forward's")
    fit_ms, gaps = rec.step_ms(FIT_RESNET_STEPS)
    say("fit (c) ResNet-50 B=%d %dx%d O1 bf16 Momentum through Model.fit "
        "(num_workers=%d, %.1f MB a batch through shared memory, "
        "Accuracy(topk=(1, 5))): %d steps in %.1f s, one program (%d "
        "replays); every step's top-1/top-5 equal to the stable rank of "
        "its labels among its logits; last losses %s"
        % (RESNET_B, RESNET_HW, RESNET_HW, FIT_RESNET_WORKERS,
           RESNET_B * 3 * RESNET_HW * RESNET_HW * 4 / 1e6, steps, fit_s,
           step.replays, ["%.4f" % lg["loss"] for lg in rec.logs[-3:]]))
    say("fit (c) evaluate over %d batches %s, bit-equal to the eager eval "
        "forward; no running statistic written; predict over %d batches "
        "bit-equal to the eager forward's logits" % (
            FIT_RESNET_EVAL, result, FIT_RESNET_PREDICT))
    say("fit (c) step %.2f ms (median of the last %d batch-end gaps, min "
        "%.2f max %.2f): %.1f images/s%s; pt_feed_stall_ms %.3f a batch "
        "(%.3f after the first batch) (%s)"
        % (fit_ms, FIT_RESNET_STEPS, min(gaps), max(gaps),
           RESNET_B / (fit_ms / 1e3), "" if resnet_ms is None else
           " beside phase 19's captured step %.2f ms (%.1f images/s)"
           % (resnet_ms, RESNET_B / (resnet_ms / 1e3)), stall,
           rec.stall_after_first(), card))
    del net, step, model, opt
    free_memory(torch)
    return {"fit_ms": fit_ms, "stall": stall}


def fit_lenet(torch, card):
    """Phase 20 (d): bench.py's bench_lenet_fit, then a one-epoch fit with
    Accuracy and ModelCheckpoint, and Model.load into a fresh Model."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    old = os.environ.get("PADDLE_TPU_SYNTH_SAMPLES")
    os.environ["PADDLE_TPU_SYNTH_SAMPLES"] = LENET_SYNTH
    try:
        train, test = MNIST(mode="train"), MNIST(mode="test")
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_SYNTH_SAMPLES")
        else:
            os.environ["PADDLE_TPU_SYNTH_SAMPLES"] = old

    def build(seed):
        prandom.seed(seed)
        net = LeNet(seed=seed)
        model = paddle.Model(net)
        model.prepare(optimizer.Adam(parameters=model.parameters(),
                                     learning_rate=1e-3),
                      CrossEntropyLoss(), metrics=paddle.metric.Accuracy())
        return model
    model = build(0)
    x = np.stack([train[i][0] for i in range(LENET_B)]).astype(np.float32)
    y = np.asarray([train[i][1] for i in range(LENET_B)], np.int64)
    for _ in range(LENET_WARMUP):
        model.train_batch([x], [y])
    t0 = time.perf_counter()
    for _ in range(LENET_STEPS):
        logs = model.train_batch([x], [y])
    dt = time.perf_counter() - t0
    ips = LENET_STEPS * LENET_B / dt
    require(math.isfinite(logs["loss"]), "fit (d): loss %s" % logs)
    say("fit (d) bench.py bench_lenet_fit on the port: LeNet, Adam(1e-3), "
        "CrossEntropyLoss, B=%d, %d warm-up + %d train_batch calls: %.1f "
        "images/s (%.3f ms a call, host clock; %s)"
        % (LENET_B, LENET_WARMUP, LENET_STEPS, ips, dt / LENET_STEPS * 1e3,
           card))
    with tempfile.TemporaryDirectory() as save_dir:
        model = build(0)
        t0 = time.perf_counter()
        model.fit(train, batch_size=LENET_B, epochs=1, verbose=0,
                  num_workers=FIT_WORKERS, save_dir=save_dir)
        fit_s = time.perf_counter() - t0
        trained = model.evaluate(test, batch_size=LENET_B, verbose=0)
        files = sorted(os.listdir(save_dir))
        fresh = build(1)
        fresh.load(os.path.join(save_dir, "final"))
        loaded = fresh.evaluate(test, batch_size=LENET_B, verbose=0)
    require(files == ["0.pdopt", "0.pdparams", "final.pdopt",
                      "final.pdparams"], "fit (d): save_dir holds %s" % files)
    require(loaded == trained, "fit (d): evaluate after Model.load %s, the "
            "trained model's %s" % (loaded, trained))
    n = len(train)
    say("fit (d) one-epoch LeNet fit (%d samples, B=%d, %d workers, "
        "Accuracy, ModelCheckpoint): %.1f s, %.1f images/s with the "
        "workers' start; save_dir %s; evaluate %s, bit-equal after "
        "Model.load of final.pdparams/.pdopt into a fresh Model (%s)"
        % (n, LENET_B, FIT_WORKERS, fit_s, n / fit_s, files, trained, card))
    return ips


def fit_main(torch, ck, card, off_ms=None, off_launches=None,
             resnet_ms=None):
    """Phase 20: Model.fit on the card, (a)-(d) (see the module's
    docstring)."""
    t0 = time.perf_counter()
    out = {"gpt2": fit_gpt2(torch, ck, card, off_ms, off_launches)}
    t1 = time.perf_counter()
    fit_preempt(torch, card)
    t2 = time.perf_counter()
    out["resnet"] = fit_resnet(torch, ck, card, resnet_ms)
    t3 = time.perf_counter()
    out["lenet_ips"] = fit_lenet(torch, card)
    free_memory(torch)
    say("fit phase 20: %.1f s ((a) %.1f, (b) %.1f, (c) %.1f, (d) %.1f)"
        % (time.perf_counter() - t0, t1 - t0, t2 - t1, t3 - t2,
           time.perf_counter() - t3))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, check them against their "
                    "plain versions and stop")
    ap.add_argument("--resnet-only", action="store_true",
                    help="name the card, then run phase 19 (ResNet-50) "
                    "alone: it launches none of the port's kernels, so "
                    "nothing is built")
    ap.add_argument("--resume-drill", metavar="JSON",
                    help="one run of phase 17's resume drill, its settings "
                    "as JSON (see resume_drill); phase 17 starts these")
    ap.add_argument("--fit-only", action="store_true",
                    help="name the card, build the kernels, then run phase "
                    "20 (Model.fit) alone")
    ap.add_argument("--fit-drill", metavar="JSON",
                    help="one run of phase 20's preemption drill, its "
                    "settings as JSON (see fit_drill); phase 20 starts "
                    "these")
    opts = ap.parse_args()
    if opts.resume_drill:
        return resume_drill(json.loads(opts.resume_drill))
    if opts.fit_drill:
        return fit_drill(json.loads(opts.fit_drill))

    import torch
    require(torch.cuda.is_available(), "CUDA is not available")
    import torch.nn.functional as F

    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import cuda_kernels as ck

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, "nvidia-smi failed: " + smi.stderr)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say("torch %s, CUDA %s, %s x%d, tf32 matmul %s"
        % (torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0), torch.cuda.device_count(),
           torch.backends.cuda.matmul.allow_tf32))

    if opts.resnet_only:
        resnet_main(torch, ck, flags, card)
        say("resnet-only run: phase 19 passed")
        return 0

    # 2. build
    secs = _build.build()
    say("build: %d kernel sources in %.1f s (parallel nvcc%s)"
        % (len(_build.KERNEL_SOURCES), secs,
           ", " + " ".join(_build._split_flag()) if _build._split_flag()
           else ""))
    for name, log in sorted(_build.build_logs().items()):
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                say("ptxas %s: %s" % (name, line.strip()))
    for src, entry, regs, spill in ptxas_registers(
            _build.build_logs(), ("paged_split_kernel", "flash_fwd_f32")):
        say("registers %s %s: %d (%s)" % (src, entry, regs, spill))

    if opts.fit_only:
        fit_main(torch, ck, card)
        say("fit-only run: phase 20 passed")
        return 0

    # 3. kernels against their plain versions
    from paddle_tpu_torch.framework.random import philox_word
    global WORD
    WORD = philox_word(SEED, OFFSET - DELTA, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_fwd": check_flash(torch, ck, gen),
            "paged_decode": check_paged(torch, ck, False, gen),
            "paged_decode_int8": check_paged(torch, ck, True, gen)}
    check_dropout_bits(torch, ck)
    errs.update(check_flash_train(torch, ck, gen))
    check_flash_f16_range(torch, ck, gen)
    errs.update(check_adamw(torch, ck, gen))
    errs["dropout_keep"] = check_dropout_keep(torch, ck)
    check_gates(torch, ck, gen)
    errs.update(check_fused(torch, ck, flags, gen))
    if opts.kernels_only:
        say("kernels-only run: checks passed")
        return 0

    # 4. kernel timings at the main path's shapes
    timer = Timer(torch)
    times = {}
    flash_t = {}                        # by prefill bucket
    for T in BUCKETS:
        t = time_flash(torch, ck, F, timer, gen, T)
        say("time flash_fwd B=1 H=12 T=%d D=64 f32 causal: %.4f ms, plain "
            "%.4f ms, sdpa %.4f ms, bound %.4f ms (%s)"
            % (T, t["ms"], t["plain_ms"], t["library_ms"], t["bound_ms"],
               t["bound_by"]))
        flash_t[T] = t
    times["flash_fwd"] = dict(flash_t[BUCKETS[-1]])   # the row's time
    decode_lens = [int(x) for x in
                   np.random.RandomState(1).randint(2, 320, 8)]
    for name, quantized in (("paged_decode", False),
                            ("paged_decode_int8", True)):
        t = time_paged(torch, ck, F, timer, gen, quantized, decode_lens)
        say("time %s B=8 H=12 T=512 D=64 lens=%s: %.4f ms, plain %.4f ms, "
            "sdpa %s, bound %.4f ms (%s)"
            % (name, decode_lens, t["ms"], t["plain_ms"],
               "n/a" if t["library_ms"] is None
               else "%.4f ms" % t["library_ms"], t["bound_ms"],
               t["bound_by"]))
        times[name] = t

    # 5. main path: gpt2-small behind the engine and the batcher
    t0 = time.perf_counter()
    model = gpt2_small(seed=0)
    say("gpt2-small: %d parameters, built in %.1f s"
        % (sum(p.numel() for p in model.parameters()),
           time.perf_counter() - t0))
    cfg = dict(max_batch=8, max_seq_len=512, prefill_buckets=BUCKETS)
    warm = serving.GenerationEngine(model, **cfg)
    serve(serving, warm, [(np.arange(1, 6), 4), (np.arange(1, 101), 4)])
    del warm
    reqs = make_requests(np)
    torch.cuda.reset_peak_memory_stats()
    eng = serving.GenerationEngine(model, **cfg)
    ck.launch_counts(reset=True)
    ck.attention_path_counts(reset=True)
    kreqs, wall, steps = serve(serving, eng, reqs)
    launches = ck.launch_counts()
    paths = ck.attention_path_counts()
    kstate = [t.clone() for t in eng.kv.state()]
    peak = torch.cuda.max_memory_allocated()
    serve_line("main path (16 submitted at once on 8 slots, step programs "
               "replayed)", kreqs, wall, steps, card)
    direct_tps = sum(len(r.tokens) for r in kreqs) / wall
    say("main path: prefix hits %d; peak memory %.1f MiB (KV cache %.1f "
        "MiB)" % (sum(1 for r in kreqs if r.prefix_len > 0), peak / 2**20,
                  eng.kv.nbytes / 2**20))
    say("main path launches %s, attention paths %s" % (launches, paths))
    require(launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
            "the main path did not launch both kernels: %s" % launches)
    require(paths["xla_sdpa"] == 0 and paths["xla_paged"] == 0,
            "the main path took a plain attention path: %s" % paths)
    require(any(r.prefix_len > 0 for r in kreqs),
            "no prefix-cache hit: the suffix path did not run")
    report_programs("float32", eng, card)
    flash_by_t, replayed = program_launches([eng], launches)
    say("main path launches through replays %s"
        % {k: n for k, n in replayed.items() if n})
    require(replayed["flash_fwd"] > 0 and replayed["paged_decode"] > 0,
            "the main path launched its kernels in no replay: %s" % replayed)
    require(sum(flash_by_t.values()) == launches["flash_fwd"]
            and set(flash_by_t) <= set(BUCKETS),
            "flash_fwd launches by bucket %s do not add up to %d"
            % (flash_by_t, launches["flash_fwd"]))
    over = sum(flash_by_t.get(T, 0) * (flash_t[T]["ms"]
                                       - flash_t[T]["bound_ms"])
               for T in BUCKETS)
    say("flash_fwd launches by bucket %s: launches x (time - bound) %.3f "
        "ms over the run" % (flash_by_t, over))
    times["flash_fwd"]["buckets"] = [
        dict(T=T, launches=flash_by_t.get(T, 0), **{
            k: flash_t[T][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "library_ms")}) for T in BUCKETS]
    dev_ms, top = profile_decode(torch, eng)
    report_decode_profile("float32", dev_ms, statistics.median(steps), top,
                          card)
    direct_again_tps = serve_again(serving, eng, reqs, kreqs, "main path",
                                   card)
    del eng
    graph_against_eager(torch, serving, model, cfg, reqs, kreqs, kstate,
                        "float32", card)

    # 6. the same requests on the plain versions
    Recording = recording_engine(torch, serving.GenerationEngine)
    saved = flags.get_flags(["use_flash_attention", "paged_flash_decode"])

    def plain_run(rq, **kw):
        flags.set_flags({"use_flash_attention": False,
                         "paged_flash_decode": False})
        ck.launch_counts(reset=True)
        try:
            e = Recording(model, **cfg, **kw)
            out, _, _ = serve(serving, e, rq)
        finally:
            flags.set_flags(saved)
        require(sum(ck.launch_counts().values()) == 0,
                "a kernel launched with its flag off")
        return out, e.gaps

    preqs, gaps = plain_run(reqs)
    compare_tokens(kreqs, preqs, gaps, "float32")

    # 7. int8 cache: kernel run, then the plain int8 path
    ireqs = [(p, min(m, 24)) for p, m in reqs[:8]]
    e8 = serving.GenerationEngine(model, kv_dtype="int8", **cfg)
    ck.launch_counts(reset=True)
    ck.attention_path_counts(reset=True)
    k8, wall8, steps8 = serve(serving, e8, ireqs)
    launches8 = ck.launch_counts()
    paths8 = ck.attention_path_counts()
    state8 = [t.clone() for t in e8.kv.state()]
    serve_line("int8 run (8 submitted at once on 8 slots, step programs "
               "replayed)", k8, wall8, steps8, card)
    say("int8 run launches %s, attention paths %s" % (launches8, paths8))
    require(launches8["paged_decode_int8"] > 0 and
            launches8["flash_fwd"] > 0,
            "the int8 run did not launch its kernels: %s" % launches8)
    require(paths8["xla_sdpa"] == 0 and paths8["xla_paged"] == 0,
            "the int8 run took a plain attention path: %s" % paths8)
    report_programs("int8", e8, card)
    _, replayed8 = program_launches([e8], launches8)
    say("int8 run launches through replays %s"
        % {k: n for k, n in replayed8.items() if n})
    require(replayed8["paged_decode_int8"] > 0,
            "the int8 run launched its kernel in no replay: %s" % replayed8)
    dev8, top8 = profile_decode(torch, e8)
    report_decode_profile("int8", dev8, statistics.median(steps8), top8,
                          card)
    serve_again(serving, e8, ireqs, k8, "int8 run", card)
    del e8
    graph_against_eager(torch, serving, model, cfg, ireqs, k8, state8, "int8",
                        card, kv_dtype="int8")
    p8, gaps8 = plain_run(ireqs, kv_dtype="int8")
    compare_tokens(k8, p8, gaps8, "int8")

    # 8. the server: InferenceServer on the card, its live plane scraped
    from paddle_tpu_torch.observability import flight, httpd, tracing
    from paddle_tpu_torch.resilience import health
    with tempfile.TemporaryDirectory() as tele_dir:
        # a memory sample after every step, so /statusz's is the run's last
        env = {flight.ENV_DIR: tele_dir, health.ENV_DIR: tele_dir,
               flight.ENV_HBM_INTERVAL: "0"}
        os.environ.update(env)
        hb_path = health.heartbeat_path(tele_dir, 0)
        try:
            srv, slaunch_a, tps_a, tps_a2 = server_run(
                torch, ck, serving, model, cfg, reqs, preqs, gaps,
                "server (a), 1 worker", card, hb_path)
            say("server (a) against the engine alone (phase 5, 16 "
                "submitted at once): fresh %.1f / %.1f tokens/s = %.3f; "
                "built %.1f / %.1f = %.3f"
                % (tps_a, direct_tps, tps_a / direct_tps, tps_a2,
                   direct_again_tps, tps_a2 / direct_again_tps))
            telemetry_cost(torch, tracing, srv.engines[0], card)
            del srv
            srv, slaunch_b, tps_b, tps_b2 = server_run(
                torch, ck, serving, model, cfg, reqs, preqs, gaps,
                "server (b), 2 workers", card, hb_path, workers=2)
            say("server (b) against (a): fresh %.1f / %.1f tokens/s = "
                "%.3f; built %.1f / %.1f = %.3f"
                % (tps_b, tps_a, tps_b / tps_a, tps_b2, tps_a2,
                   tps_b2 / tps_a2))
            del srv
            srv, slaunch_c, _, _ = server_run(
                torch, ck, serving, model, cfg, ireqs, p8, gaps8,
                "server (c), int8 cache", card, hb_path, kv_dtype="int8")
            del srv
            crash_drill(serving, model, cfg, tele_dir)
        finally:
            httpd.shutdown()
            for var in env:
                os.environ.pop(var, None)

    # 9-11. training: kernel times, the main path, kernels vs plain
    times.update(train_timings(torch, ck, F, timer, gen))
    tlaunches, shapes, off_ms = train_main(torch, ck, flags, card)
    times["adamw"] = time_adamw(torch, ck, timer, gen, shapes, card)
    times["dropout_keep"] = time_dropout_keep(torch, ck, timer,
                                              (TRAIN_B, TRAIN_T, 768))
    train_compare(torch, ck, flags)

    # 12-13. rows 4-6 at the paths' shapes; path B: GPT-2 training with
    # both fused flags on, then its kernels vs the flags-off plain run
    times.update(time_fused(torch, ck, timer, gen, TRAIN_B * TRAIN_T, 768,
                            torch.bfloat16, True, "gpt2 (path B)"))
    time_fused(torch, ck, timer, gen, ERNIE_B * ERNIE_T, 768, torch.float32,
               False, "ernie (path A)")
    blaunches, _, on_ms = train_main(torch, ck, flags, card, fused=True)
    say("train step, gpt2-small B=%d T=%d O2 bf16 (%s): fused flags off "
        "%.2f ms, on %.2f ms (median of %d steps each, this run)"
        % (TRAIN_B, TRAIN_T, card, off_ms, on_ms, TRAIN_STEPS))
    train_compare(torch, ck, flags, fused=True)

    # 14-15. path A: ERNIE-base pretraining, then kernels vs plain
    alaunches = ernie_main(torch, ck, flags, card)
    ernie_compare(torch, ck, flags)

    # 16. guards and eval on the training main path
    free_memory(torch)
    guards_main(torch, ck, flags, card, off_ms, tlaunches)

    # 17. resumable training: schedule, clip, checkpoints, preemption
    free_memory(torch)
    resume_main(torch, ck, card, off_ms, tlaunches)

    # 18. float16 on the card, GradScaler, the other optimizers
    free_memory(torch)
    f16_times, f16_off, f16_on = f16_main(torch, ck, F, flags, timer, gen,
                                          shapes, card)
    times.update(f16_times)
    scaler_main(torch, ck, card)
    ernie_lamb(torch, ck, flags, card)
    optimizer_sweep(torch, ck, flags, card)

    # 19. ResNet-50 on the card
    free_memory(torch)
    resnet_ms = resnet_main(torch, ck, flags, card)

    # 20. Model.fit on the card
    free_memory(torch)
    fit_main(torch, ck, card, off_ms, tlaunches, resnet_ms)

    counts = {"flash_fwd": (launches["flash_fwd"] + slaunch_a["flash_fwd"]
                            + slaunch_b["flash_fwd"]
                            + slaunch_c["flash_fwd"]),
              "paged_decode": (launches["paged_decode"]
                               + slaunch_a["paged_decode"]
                               + slaunch_b["paged_decode"]),
              "paged_decode_int8": (launches8["paged_decode_int8"]
                                    + slaunch_c["paged_decode_int8"])}
    for name in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv",
                 "adamw", "dropout_keep"):
        counts[name] = tlaunches[name]
    for name in FUSED_KERNELS:
        counts[name] = blaunches[name] + alaunches[name]
        say("launches %s: %d on path B (gpt2, fused flags), %d on path A "
            "(ernie)" % (name, blaunches[name], alaunches[name]))
    for name in F16_ORDER:
        counts[name] = f16_off[name] + f16_on[name]
        say("launches %s: %d with the fused flags off, %d on path B (gpt2 "
            "f16)" % (name, f16_off[name], f16_on[name]))
    table = [{"name": name, "route": "cuda",
              "source": SOURCES[name.replace(ck.F16, "")],
              "replaces": TPU_KERNELS[name.replace(ck.F16, "")],
              "launches": counts[name],
              "max_abs_err": errs[name], "ms": times[name]["ms"],
              "plain_ms": times[name]["plain_ms"],
              "bound_ms": times[name]["bound_ms"],
              "bound_by": times[name]["bound_by"],
              "library_ms": times[name]["library_ms"]}
             for name in KERNEL_ORDER + F16_ORDER]
    next(e for e in table if e["name"] == "flash_fwd")["buckets"] = \
        times["flash_fwd"]["buckets"]
    say(card)
    say(json.dumps({"kernels": table, "no_pallas_counterpart": {
        "19": "ResNet-50: cuDNN convolutions, composed batch norm and "
              "pooling; the reference reaches no pl.pallas_call on this "
              "path, so phase 19 launches none of the kernels above"}}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
