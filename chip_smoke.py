#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the whole run, one card
    python3 chip_smoke.py --kernels-only   # build + kernel checks only

Phases, each of which fails the run (non-zero exit, no result line):
  1. the card: name and power limit as nvidia-smi reports them, torch and
     CUDA versions; no CUDA is a failure;
  2. build: every kernel source in paddle_tpu_torch/ops/csrc, one nvcc
     each, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     serving shapes and at the edge cases (ragged T, idle slot, block
     edge, the paged kernel's chunk edges for each cache, T-1, full clamp,
     every slot full, NaN tail, a 16384-row cache), and the fused
     dropout-residual(+LN) kernels at float32, bfloat16 and mixed input
     types, Hd 64, 768 and 1000, p 0, 0.1 and 1, both dropout modes, and
     at the training paths' shapes, fed the kernels' own dropout bits,
     with the tolerances stated below; the dropout kernels read their key
     from a Philox word on the card (seed, base) and a delta, held to the
     plain versions at (seed, base + delta); AdamW reads lr, c1 and c2
     from a scalar buffer on the card, also over t = 1..5 with the lr
     changed; F.dropout's keep-mask kernel against its plain version;
     the backward's mask equal to the forward's; and each gate raising
     on inputs its kernel does not take;
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
     replayed from one CUDA graph, and enqueued one by one); the flash
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
     bodies, captured step and graph against eager as in 10;
 15. path A's kernels vs plain: float32, no dropout, 3 steps, as in 11.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import json
import math
import os
import re
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12,
              "int32": 67e12 / 2 / 2}
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
}
# AdamW: the kernel rounds every operation on its own, as the plain rule
# does (no FMA contraction), so the parameter must be bit-equal; each
# moment element may differ from the plain one by at most this share of
# its size (one float32 ulp)
ADAMW_MOMENT_REL_TOL = 2 ** -23
# the bfloat16 cases at lr 1e-2 on parameters of size ~1e-2 must move at
# least this share of the elements, or the bit-equality shows nothing
ADAMW_MOVED_MIN = 0.9
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
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(1, T, T, 12, 64, True) for T in (32, 128, 256)] + [
        (2, 40, 40, 12, 64, True),           # ragged edge
        (1, 16, 48, 4, 64, True),            # bottom-right causal, Tq < Tk
        (1, 100, 100, 4, 64, False),
        (1, 64, 64, 2, 128, True),           # widest head the kernel takes
        (1, 33, 33, 2, 24, True)]            # head_dim not a multiple of 32
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for B, Tq, Tk, H, D, causal in cases:
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
        say("check flash_fwd %s: max abs err %.3g (tol %.0e) over %d cases"
            % (name, err, TOL[name], len(cases)))
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
    versions take the kernel's o and lse, so each kernel is held alone."""
    names = ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv")
    worst = {n: 0.0 for n in names}            # relative, for the checks
    worst_abs = {n: 0.0 for n in names}        # absolute, for the table
    worst_at = {n: "" for n in names}          # the case of the worst
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
    n = 0
    for dtype_name, dtype, (B, Tq, Tk, H, D, causal), p in runs:
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
        pairs = {"flash_fwd_train": ((o, o_ref), (lse, lse_ref)),
                 "flash_bwd_dq": ((dq, dq_ref), (delta, delta_ref)),
                 "flash_bwd_dkv": ((dk, dk_ref), (dv, dv_ref))}
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
        n += 1
    for name, err in worst.items():
        say("check %s: max rel err %.3g at %s (tol f32 %.0e, bf16 %.0e), "
            "max abs err %.3g, over %d cases, p in {0, %g}"
            % (name, err, worst_at[name], REL_TOL["float32"],
               REL_TOL["bfloat16"], worst_abs[name], n, DROPOUT))
    return worst_abs


def step_scalars(torch, ck, lr, t):
    """A scalar buffer on the card holding the step's (lr, c1, c2), as the
    optimizer stages it."""
    from paddle_tpu_torch.framework.device import write_values
    sc = torch.empty(3, device="cuda")
    write_values(sc, ck.adam_step_scalars(lr, t, 0.9, 0.999))
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
    worst_p = worst_m = 0.0
    moved_min = 1.0
    n = 0
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
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
                        worst_p = max(worst_p, err_p)
                        err_m = max(((ka[i] - pa[i]).abs()
                                     / pa[i].abs().clamp_min(1e-30)).max()
                                    .item() for i in (2, 3))
                        require(err_m <= ADAMW_MOMENT_REL_TOL,
                                "%s: moment rel err %.3g > %.3g"
                                % (what, err_m, ADAMW_MOMENT_REL_TOL))
                        worst_m = max(worst_m, err_m)
                        if dtype == torch.bfloat16 and lr == 1e-2 \
                                and numel > 7:
                            moved = (ka[0] != p).double().mean().item()
                            require(moved >= ADAMW_MOVED_MIN,
                                    "%s: only %.3f of the parameter moved"
                                    % (what, moved))
                            moved_min = min(moved_min, moved)
                        n += 1
    say("check adamw: parameters bit-equal to the plain rule, moments max "
        "rel err %.3g (tol %.3g) over %d cases; bfloat16 at lr 1e-2 moved "
        ">= %.4f of the elements (want >= %.2f)"
        % (worst_m, ADAMW_MOMENT_REL_TOL, n, moved_min, ADAMW_MOVED_MIN))
    from paddle_tpu_torch.framework.device import write_values
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)
    for dtype in (torch.float32, torch.bfloat16):
        numel = 2304 * 768
        p = (torch.randn(numel, generator=gen, device="cuda") * 1e-2).to(dtype)
        ka, sa, pa = ([p.clone(), torch.zeros(numel, device="cuda"),
                       torch.zeros(numel, device="cuda")] for _ in range(3))
        sc = torch.empty(3, device="cuda")
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
        "the scalar buffer, float32 and bfloat16: kernel parameters and the "
        "plain rule on the buffer bit-equal to the plain rule with host lr "
        "and t")
    return worst_p


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
    flag is off: an input its kernel does not take raises."""
    q, k, v = qkv_views(torch, 1, 32, 2, 64, torch.float32, gen)
    bad = [("additive mask", lambda: ck.flash_attention_or_none(
                q, k, v, torch.zeros(32, 32, device="cuda"), True)),
           ("float16", lambda: ck.flash_attention_or_none(
                q.half(), k.half(), v.half(), None, True)),
           ("D=160", lambda: ck.flash_attention_or_none(
                *qkv_views(torch, 1, 8, 1, 160, torch.float32, gen), None,
                True))]
    bad.append(("dropout p=1", lambda: ck.flash_attention_or_none(
        q, k, v, None, True, dropout_p=1.0)))
    qh = q.detach().half()
    bad.append(("float16 backward", lambda: ck.flash_bwd_dq(
        qh, qh, qh, qh, qh, torch.zeros(64, device="cuda"), True)))
    w = torch.zeros(16, device="cuda", dtype=torch.float16)
    m = torch.zeros(16, device="cuda")
    sc = torch.zeros(3, device="cuda")
    bad.append(("float16 adamw", lambda: ck.fused_adamw_or_none(
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
    require(ck.launch_counts() == before, "a rejected input launched")
    say("check gates: %d inputs the kernels do not take raise on the card"
        % len(bad))


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


def bwd_timings(torch, ck, F, timer, gen, B, T, causal, p):
    """Device times of the flash backward kernels (rows 2 and 3) at
    B x 12 heads x T x 64, bfloat16, beside their plain versions, their
    bounds and PyTorch's sdpa backward (dq, dk and dv in one call) on the
    same inputs."""
    H, D, dt = 12, 64, torch.bfloat16
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
                         "bfloat16")
        out[name] = {"ms": timer.ms(fn), "plain_ms": timer.ms(plain),
                     "library_ms": lib_bwd, "bound_ms": b, "bound_by": by}
    shape = "B=%d H=%d T=%d D=%d bf16 %s p=%g" % (
        B, H, T, D, "causal" if causal else "not causal", p)
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


def fwd_timings(torch, ck, F, timer, gen, B, T, causal, p):
    """Device time of the training flash forward (row 1t: lse and
    in-kernel dropout) at B x 12 heads x T x 64, bfloat16, beside its plain
    version, its bound and PyTorch's sdpa forward on the same inputs."""
    H, D = 12, 64
    q, k, v = qkv_views(torch, B, T, H, D, torch.bfloat16, gen)
    bits = ck.attn_dropout_bits(WORD, DELTA, B * H, T, T) if p else None
    bhtd, bht = B * H * T * D * 2, B * H * T * 4
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    # reads q, k, v; writes o, lse; 2 products of 2 D flops a live pair
    b, by = bound_ms(4 * bhtd + bht, 4 * D * pairs, "bfloat16")
    t = {"ms": timer.ms(lambda: ck.flash_fwd_train(q, k, v, causal, p, WORD,
                                                   DELTA)),
         "plain_ms": timer.ms(lambda: ck.flash_fwd_train_plain(
             q, k, v, causal, p, bits)),
         "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
             q, k, v, is_causal=causal, dropout_p=p)),
         "bound_ms": b, "bound_by": by}
    say("time flash_fwd_train B=%d H=%d T=%d D=%d bf16 %s p=%g: %.4f ms, "
        "plain %.4f ms, torch sdpa fwd %.4f ms, bound %.4f ms (%s)"
        % (B, H, T, D, "causal" if causal else "not causal", p, t["ms"],
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


def time_adamw(torch, ck, timer, gen, shapes):
    """One AdamW step over tensors shaped like every gpt2-small parameter,
    bfloat16 parameters and gradients, float32 moments, as the O2 main
    path runs it: one launch per parameter, lr and the bias corrections
    from the scalar buffer. The row's time is the launches replayed from
    one CUDA graph, as the captured train step runs them: device time
    alone. The same launches enqueued one by one from the host are timed
    too (the time this row reported before the step was captured)."""
    ps = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
          for s in shapes]
    gs = [(torch.randn(s, generator=gen, device="cuda") * 1e-2).to(
        torch.bfloat16) for s in shapes]
    m1 = [torch.zeros(s, device="cuda") for s in shapes]
    m2 = [torch.zeros(s, device="cuda") for s in shapes]
    sc = step_scalars(torch, ck, 1e-4, 10)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)

    def run(fn, *args):
        for p, g, a, b in zip(ps, gs, m1, m2):
            fn(p, g, a, b, *args, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(ck.adamw, sc)                 # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(ck.adamw, sc)
    lib_p = [p.clone().requires_grad_() for p in ps]
    for p, g in zip(lib_p, gs):
        p.grad = g.clone()
    lib = torch.optim.AdamW(lib_p, lr=1e-4, weight_decay=0.01, fused=True)
    n = sum(p.numel() for p in ps)
    # each element: param read + write (2 + 2), grad read (2), m1 and m2
    # read + write (8 + 8)
    b, by = bound_ms(22 * n, 10 * n, "float32")
    eager_ms = timer.ms(lambda: run(ck.adamw, sc))
    out = {"ms": timer.ms(graph.replay),
           "plain_ms": timer.ms(lambda: run(ck.adamw_plain, 1e-4, 10)),
           "library_ms": timer.ms(lib.step), "bound_ms": b, "bound_by": by}
    say("time adamw %d parameters, %d elements, bf16 param+grad, f32 "
        "moments: %.4f ms/step replayed from a CUDA graph (%.4f ms enqueued "
        "one launch at a time), plain %.4f ms, torch AdamW(fused=True) "
        "%.4f ms, bound %.4f ms (%s)" % (len(shapes), n, out["ms"], eager_ms,
                                         out["plain_ms"], out["library_ms"],
                                         b, by))
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


def profile_groups(rows):
    """Device ms per PROFILE_GROUPS group (and "other") of profiler rows."""
    out = {}
    for t_us, key, _ in rows:
        name = next((g for g, pats in PROFILE_GROUPS
                     if any(p in key for p in pats)), "other")
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


def report_profile(label, dev_ms, step_ms, top):
    """Print one profiled step: its kernel time against the median step
    (the device's idle share), the groups and the largest kernels."""
    if dev_ms <= 0:
        say("%s step profile: not measured (the profiler saw no device "
            "activity)" % label)
        return
    say("%s step profile: %.3f ms of kernels in one step (torch.profiler) "
        "vs %.2f ms median step: device idle %.1f %%"
        % (label, dev_ms, step_ms, 100.0 * (1.0 - dev_ms / step_ms)))
    for name, ms in sorted(profile_groups(top).items(),
                           key=lambda kv: -kv[1]):
        say("  group %-26s %8.3f ms/step" % (name, ms))
    for t_us, key, count in top[:12]:
        say("  %9.1f us/step  %5d launches  %s" % (t_us, count, key[:90]))


def eager_train_step(TrainStep):
    class EagerTrainStep(TrainStep):
        """The train step's body run eagerly on every call: no program is
        built, captured or replayed (the step as it ran before it was
        captured, and the reference the programs are held to)."""

        def _run(self, key, body):
            return body()
    return EagerTrainStep


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
    """From one saved state (parameters, moments, step count, RNG), the two
    steps of `batches` through the captured step and through its bodies
    run eagerly, twice (the eager step must repeat itself bit for bit for
    the comparison to mean anything): losses, parameters and moments
    bit-equal. At p > 0 the two steps' Philox words differ and so do the
    bits they give a flash call and a fused call, and the restored state
    gives step 1's word again."""
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
        w1, w2 = g[3]
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
    say("%s graph against eager p=%g: 2 steps from one state, losses %s, "
        "parameters and moments bit-equal to the eager bodies (which repeat "
        "themselves bit for bit)%s"
        % (label, p, ["%.6f" % float(x) for x in g[0]], note))


def free_memory(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_main(torch, ck, flags, card, fused=False):
    """The GPT-2 training path, with both fused flags (use_fused_dropout_ln,
    fused_block) off (phase 10) or on (path B), through `run_path`; then
    the captured step against its eager bodies at the path's dropout 0.1
    and, on a fresh model, at 0. Returns (launch counts, parameter shapes,
    median step ms)."""
    import contextlib
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.io.prefetch import FEED_STALL
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small

    label = "train fused" if fused else "train"
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
        return amp.decorate(model, opt, level="O2", dtype="bfloat16")
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
        want = {"flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "adamw": n_tensors,
                "fused_dropout_ln_fwd": L if fused else 0,
                "fused_dropout_residual_fwd": L if fused else 0,
                "fused_dropout_ln_bwd": 2 * L if fused else 0,
                # the hidden dropouts (2 a layer, unfused) and the
                # embeddings' dropout
                "dropout_keep": 1 if fused else 2 * L + 1}
        tokens = TRAIN_B * TRAIN_T
        d = model.gpt.hidden_size
        flops = 6 * n_params * tokens + 12 * L * d * TRAIN_T * tokens
        stall0 = (FEED_STALL.sum, FEED_STALL.count)
        launches, paths, step_ms, _, _ = run_path(
            torch, ck, label, card, model, opt, loss_fn, batch,
            contextlib.nullcontext, tokens, flops, want)
        say("%s feed stall %.3f ms a batch" % (label, (
            FEED_STALL.sum - stall0[0]) / (FEED_STALL.count - stall0[1])))
        require(paths["flash_dropout"] > 0 and paths["xla_sdpa"] == 0,
                "%s: attention paths %s" % (label, paths))
        fixed = [batch() for _ in range(2)]
        it.close()
        free_memory(torch)
        graph_against_eager_train(torch, ck, label, model, opt, loss_fn,
                                  fixed, contextlib.nullcontext, DROPOUT)
        shapes = [tuple(p.shape) for p in model.parameters()]
        del model, opt
        free_memory(torch)
        model, opt = build(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)
        graph_against_eager_train(torch, ck, label, model, opt, loss_fn,
                                  fixed, contextlib.nullcontext, 0.0)
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
    worst = {n: 0.0 for n in names}             # relative, for the checks
    worst_abs = {n: 0.0 for n in names}         # absolute, for the table

    def hold(what, name, pairs, tol):
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
             ("mixed", torch.float32, torch.bfloat16))
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
    for dt in (torch.bfloat16, torch.float32):
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
    extra = {"fused_dropout_ln_fwd": " and 2 at path B's N=8192, Hd=768, "
             "p=%g (bf16, f32)" % DROPOUT,
             "fused_dropout_ln_bwd": " and %d at path B's N=8192, Hd=768, "
             "p=%g (bf16, f32; with LN and dz_extra, without LN with and "
             "without dz_extra)" % (nb, DROPOUT)}
    for name in names:
        say("check %s: max rel err %.3g (tol f32 %.0e, bf16 %.0e, by the "
            "output's type), max abs err %.3g, over %d cases (f32, bf16, "
            "mixed; Hd 64, 768, 1000; p 0, %g, 1; both modes)%s"
            % (name, worst[name], FDRLN_F32_REL_TOL, FDRLN_BF16_REL_TOL,
               worst_abs[name], n, DROPOUT, extra.get(name, "")))
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
           ("float16", lambda: gate(x.half(), x, None, v, v, 0.1, 1e-5, True,
                                    "upscale_in_train")),
           ("mismatched shapes", lambda: gate(x, x[:4], None, v, v, 0.1,
                                              1e-5, True,
                                              "upscale_in_train")),
           ("gamma of another width",
            lambda: ck.fused_bias_dropout_residual_ln(
                x, x, None, v[:32], v, 0.1, 1e-5, True,
                "upscale_in_train")),
           ("float16 backward", lambda: ck.fused_dropout_ln_bwd(
               x.half(), x.half(), None, v, 0.1, 1.0, 1e-5))]
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels, check them against their "
                    "plain versions and stop")
    opts = ap.parse_args()

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

    # 2. build
    secs = _build.build()
    say("build: %d kernel sources in %.1f s (parallel nvcc)"
        % (len(_build.KERNEL_SOURCES), secs))
    for name, log in sorted(_build.build_logs().items()):
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                say("ptxas %s: %s" % (name, line.strip()))
    for src, entry, regs, spill in ptxas_registers(
            _build.build_logs(), ("paged_split_kernel", "flash_fwd_f32")):
        say("registers %s %s: %d (%s)" % (src, entry, regs, spill))

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
    errs["adamw"] = check_adamw(torch, ck, gen)
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
    times["adamw"] = time_adamw(torch, ck, timer, gen, shapes)
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
    table = [{"name": name, "route": "cuda", "source": SOURCES[name],
              "replaces": TPU_KERNELS[name], "launches": counts[name],
              "max_abs_err": errs[name], "ms": times[name]["ms"],
              "plain_ms": times[name]["plain_ms"],
              "bound_ms": times[name]["bound_ms"],
              "bound_by": times[name]["bound_by"],
              "library_ms": times[name]["library_ms"]}
             for name in KERNEL_ORDER]
    next(e for e in table if e["name"] == "flash_fwd")["buckets"] = \
        times["flash_fwd"]["buckets"]
    say(card)
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
