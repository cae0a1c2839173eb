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
     edge, T-1, full clamp, NaN tail), and the fused dropout-residual(+LN)
     kernels at float32, bfloat16 and mixed input types, Hd 64, 768 and
     1000, p 0, 0.1 and 1, both dropout modes, fed the kernels' own
     dropout bits, with the tolerances stated below; and each gate
     raising on inputs its kernel does not take;
  4. each kernel's device time (CUDA events, median of 25 runs of 10
     back-to-back launches queued behind a sleep kernel) beside its bound,
     its plain version's time and one library call's time;
  5. the main path: gpt2-small at full width and depth (seeded weights)
     behind GenerationEngine(max_batch=8, max_seq_len=512, buckets
     (32, 128, 256)) and ContinuousBatcher with the prefix cache on,
     serving 16 requests; the kernel launch counters are zeroed just
     before and read just after;
  6. the same requests with both kernel flags off (the plain versions on
     the card): tokens must agree, or first differ where the plain run's
     top-2 logit gap is a near tie;
  7. a shorter int8-cache run, held to the plain int8 path the same way;
  8. the training kernels' device times at the training main path's
     shapes (flash forward with lse and dropout, flash backward dq and
     dk/dv: B=16, H=12, T=512, D=64, bfloat16, causal, p=0.1; AdamW over
     every gpt2-small parameter), each beside its bound, its plain
     version's time and one library call's time; the flash backward also
     at p=0 (its Philox share) and at ERNIE's attention (B=32, T=128, not
     causal, p=0.1);
  9. the training main path: the JAX package's GPT-2 train bench
     (benchmarks/train_bench.py) on the port: gpt2-small at full width and
     depth (seeded weights, both dropouts 0.1) -> amp.decorate(O2,
     bfloat16) -> AdamW(lr=1e-4, weight_decay=0.01) -> make_train_step,
     fed by DataLoader(prefetch_to_device=2) over the bench's synthetic
     token stream, B=16, T=512, 3 warm-up and 10 timed steps; the launch
     and path counters are zeroed just before and read just after; then a
     torch.profiler breakdown of one step;
 10. the same float32 weights with both dropouts 0, B=4, T=512, 3 steps,
     once with the kernels and once with use_flash_attention and
     use_fused_optimizer off (which must launch nothing): the losses and
     the parameters must agree within the stated tolerances;
 11. the fused dropout-residual(+LN) kernels' device times at path B's
     shape (N=8192, Hd=768, bfloat16) and path A's (N=4096, Hd=768,
     float32), beside their bounds, their plain versions and the composed
     PyTorch route the flag replaces;
 12. path B: phase 9 with FLAGS_use_fused_dropout_ln and FLAGS_fused_block
     on (12 / 12 / 24 launches of the fused forward, no-LN forward and
     backward a step), its step beside phase 9's; then phase 10 with the
     fused flags on in the kernel run;
 13. path A: the JAX package's ERNIE bench (train_bench.py bench_ernie)
     on the port: ernie-base at full width and depth (seeded weights,
     dropouts 0.1), B=32, T=128, AdamW(lr=1e-4, weight_decay=0.01),
     make_train_step with the MLM + NSP criterion, under
     amp.auto_cast(level="O2"), FLAGS_use_fused_dropout_ln on, 3 warm-up
     and 10 timed steps, counters zeroed just before and read just after,
     one step profiled;
 14. path A's kernels vs plain: float32, no dropout, 3 steps, as in 10.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# tolerances of the kernel-vs-plain checks (max abs error)
TOL = {
    # float32 sums over up to 512 keys in another order
    "float32": 1e-4,
    # one bfloat16 rounding of outputs of magnitude up to ~3
    "bfloat16": 2e-2,
}
# greedy tokens may first differ only where the plain run's top-2 logit
# gap is below this: a near tie that summation order can flip. int8 adds
# the chance that a K/V element rounds to the other int8 neighbour.
TIE_TOL = {"float32": 1e-3, "int8": 1e-2}

# NVIDIA H100 SXM data-sheet peaks (dense), as the bound's denominators
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# training-kernel checks, max abs error relative to the largest |value| of
# the plain version's output (at least 1):
REL_TOL = {
    # float32 sums over up to 512 keys in another order
    "float32": 2e-4,
    # bfloat16 outputs, rounded once on each side: a float32 difference
    # under one bfloat16 ulp of the largest value (2^-8 to 2^-7 of it)
    # shows as at most that one ulp, which this passes and two fail. The
    # tensor-core flash backward keeps its difference far below that by
    # taking M o p (P without dropout) and dS as bfloat16 hi + lo pairs
    # (tests/test_torch_flash_bwd.py mirrors its rounding on the CPU)
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
    "paged_decode": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
    "paged_decode_int8": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
}
KERNEL_ORDER = ("flash_fwd", "flash_fwd_train", "flash_bwd_dq",
                "flash_bwd_dkv", "fused_dropout_ln_fwd",
                "fused_dropout_residual_fwd", "fused_dropout_ln_bwd", "adamw",
                "paged_decode", "paged_decode_int8")
FUSED_KERNELS = ("fused_dropout_ln_fwd", "fused_dropout_residual_fwd",
                 "fused_dropout_ln_bwd")

# the training main path: the JAX package's GPT-2 train bench
TRAIN_B, TRAIN_T, TRAIN_WARMUP, TRAIN_STEPS = 16, 512, 3, 10
# the ERNIE-base pretraining path: the JAX package's ERNIE bench
ERNIE_B, ERNIE_T = 32, 128
DROPOUT = 0.1
SEED, OFFSET = 0x1234_5678_9ABC_DEF0, 7       # kernel checks' dropout key

VOCAB_TOKENS = 50257          # GPT-2's tokenizer; the table is padded


def say(*parts):
    print(*parts, flush=True)


def require(cond, msg):
    if not cond:
        raise SystemExit("chip_smoke FAILED: " + msg)


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
        got = ck.attn_dropout_bits(SEED, OFFSET, BH, Tq, Tk)
        want = ck.attn_dropout_bits_plain(SEED, OFFSET, BH, Tq, Tk,
                                          device="cuda")
        require(torch.equal(got, want), "attn_dropout_bits %s differ from "
                "the plain Philox" % ((BH, Tq, Tk),))
    bits = ck.attn_dropout_bits(SEED, OFFSET, TRAIN_B * 12, TRAIN_T, TRAIN_T)
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
        bits = (ck.attn_dropout_bits(SEED, OFFSET, B * H, Tq, Tk)
                if p else None)
        o, lse = ck.flash_fwd_train(q, k, v, causal, p, SEED, OFFSET)
        dq, delta = ck.flash_bwd_dq(q, k, v, o, do, lse, causal, p, SEED,
                                    OFFSET)
        dk, dv = ck.flash_bwd_dkv(q, k, v, do, lse, delta, causal, p, SEED,
                                  OFFSET)
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


def check_adamw(torch, ck, gen):
    """The kernel against the plain rule: parameter bit-equal, moments
    within one float32 ulp. Each case runs at lr 1e-4 on parameters of
    size ~1 (the main path's lr, where a bfloat16 parameter mostly does
    not move) and at lr 1e-2 on parameters of size ~1e-2, where it
    must."""
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
                        ck.adamw(*ka, lr, t, **kw)
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
    return worst_p


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
    mid length, T-1 and T (full clamp), NaN garbage past every lens; then
    a cache depth and head width no power-of-two block tiles (T=100,
    D=24), which the gate also sends to the kernel."""
    name = "paged_decode_int8" if quantized else "paged_decode"
    worst = 0.0
    for lens, shape in (([0, 5, 127, 128, 300, 511, 512, 200],
                         dict(B=8, H=12, T=512, D=64)),
                        ([0, 57, 99, 100], dict(B=4, H=2, T=100, D=24))):
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
    bad.append(("float16 adamw", lambda: ck.fused_adamw_or_none(
        w, w, 1e-3, 1, m, m, beta1=0.9, beta2=0.999, epsilon=1e-8,
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
    bits = ck.attn_dropout_bits(SEED, OFFSET, B * H, T, T) if p else None
    o, lse = ck.flash_fwd_train(q, k, v, causal, p, SEED, OFFSET)
    _, delta = ck.flash_bwd_dq(q, k, v, o, do, lse, causal, p, SEED, OFFSET)
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
         lambda: ck.flash_bwd_dq(q, k, v, o, do, lse, causal, p, SEED,
                                 OFFSET),
         lambda: ck.flash_bwd_dq_plain(q, k, v, o, do, lse, causal, p,
                                       bits)),
        ("flash_bwd_dkv", 4,
         lambda: ck.flash_bwd_dkv(q, k, v, do, lse, delta, causal, p, SEED,
                                  OFFSET),
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


def train_timings(torch, ck, F, timer, gen):
    """Device times of the training kernels at the main path's shapes; the
    flash backward also at GPT-2's shape without dropout (the Philox share)
    and at ERNIE's attention shape (path A)."""
    B, H, T, D = TRAIN_B, 12, TRAIN_T, 64
    dt = torch.bfloat16
    q, k, v = qkv_views(torch, B, T, H, D, dt, gen)
    bits = ck.attn_dropout_bits(SEED, OFFSET, B * H, T, T)
    bhtd, bht = B * H * T * D * 2, B * H * T * 4
    pairs = B * H * (T * (T + 1) // 2)          # live (row, key) pairs
    args = (q, k, v, True, DROPOUT, SEED, OFFSET)
    out = {}
    b, by = bound_ms(4 * bhtd + bht, 4 * D * pairs, "bfloat16")
    out["flash_fwd_train"] = {
        "ms": timer.ms(lambda: ck.flash_fwd_train(*args)),
        "plain_ms": timer.ms(lambda: ck.flash_fwd_train_plain(
            q, k, v, True, DROPOUT, bits)),
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=DROPOUT)),
        "bound_ms": b, "bound_by": by}
    t = out["flash_fwd_train"]
    say("time flash_fwd_train B=%d H=%d T=%d D=%d bf16 causal p=%g: %.4f "
        "ms, plain %.4f ms, torch sdpa fwd %.4f ms, bound %.4f ms (%s)"
        % (B, H, T, D, DROPOUT, t["ms"], t["plain_ms"], t["library_ms"],
           t["bound_ms"], t["bound_by"]))
    out.update(bwd_timings(torch, ck, F, timer, gen, B, T, True, DROPOUT))
    bwd_timings(torch, ck, F, timer, gen, B, T, True, 0.0)
    bwd_timings(torch, ck, F, timer, gen, ERNIE_B, ERNIE_T, False, DROPOUT)
    return out


def time_adamw(torch, ck, timer, gen, shapes):
    """One AdamW step over tensors shaped like every gpt2-small parameter,
    bfloat16 parameters and gradients, float32 moments, as the O2 main
    path runs it: one launch per parameter."""
    ps = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
          for s in shapes]
    gs = [(torch.randn(s, generator=gen, device="cuda") * 1e-2).to(
        torch.bfloat16) for s in shapes]
    m1 = [torch.zeros(s, device="cuda") for s in shapes]
    m2 = [torch.zeros(s, device="cuda") for s in shapes]
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01)

    def run(fn):
        for p, g, a, b in zip(ps, gs, m1, m2):
            fn(p, g, a, b, 1e-4, 10, **kw)
    lib_p = [p.clone().requires_grad_() for p in ps]
    for p, g in zip(lib_p, gs):
        p.grad = g.clone()
    lib = torch.optim.AdamW(lib_p, lr=1e-4, weight_decay=0.01, fused=True)
    n = sum(p.numel() for p in ps)
    # each element: param read + write (2 + 2), grad read (2), m1 and m2
    # read + write (8 + 8)
    b, by = bound_ms(22 * n, 10 * n, "float32")
    out = {"ms": timer.ms(lambda: run(ck.adamw)),
           "plain_ms": timer.ms(lambda: run(ck.adamw_plain)),
           "library_ms": timer.ms(lib.step), "bound_ms": b, "bound_by": by}
    say("time adamw %d parameters, %d elements, bf16 param+grad, f32 "
        "moments: %.4f ms/step, plain %.4f ms, torch AdamW(fused=True) "
        "%.4f ms, bound %.4f ms (%s)" % (len(shapes), n, out["ms"],
                                         out["plain_ms"], out["library_ms"],
                                         b, by))
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
PROFILE_GROUPS = (("flash kernels (port)", ("flash_fwd_kernel",
                                            "flash_bwd_")),
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


def train_main(torch, ck, flags, card, fused=False):
    """The GPT-2 training path, with both fused flags (use_fused_dropout_ln,
    fused_block) off (phase 9) or on (path B); returns (launch counts,
    parameter shapes, median step ms)."""
    from paddle_tpu_torch import amp, io, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.io.prefetch import FEED_STALL
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import GPTPretrainingCriterion, gpt2_small

    label = "train fused" if fused else "train"
    saved = flags.get_flags(["use_fused_dropout_ln", "fused_block"])
    flags.set_flags({"use_fused_dropout_ln": fused, "fused_block": fused})
    try:
        prandom.seed(0)
        t0 = time.perf_counter()
        model = gpt2_small(seed=0)
        model.train()
        opt = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              parameters=model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        crit = GPTPretrainingCriterion()
        step = make_train_step(model, lambda o, l: crit(o, l), opt)
        vocab = model.gpt.vocab_size
        loader = io.DataLoader(token_stream(io, vocab, TRAIN_T),
                               batch_size=TRAIN_B, prefetch_to_device=2)
        it = iter(loader)

        def batch():
            ids = next(it)
            return [ids[:, :-1]], [ids[:, 1:]]
        n_params = sum(p.numel() for p in model.parameters())
        say("%s: gpt2-small %d parameters (%d tensors) in %s, built in %.1f "
            "s, use_fused_dropout_ln and fused_block %s"
            % (label, n_params, len(list(model.parameters())),
               next(model.parameters()).dtype, time.perf_counter() - t0,
               "on" if fused else "off"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.launch_counts(reset=True)
        ck.attention_path_counts(reset=True)
        losses, times = [], []
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                stall0 = (FEED_STALL.sum, FEED_STALL.count)
            t0 = time.perf_counter()
            loss, _ = step(*batch())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        stall_ms = (FEED_STALL.sum - stall0[0]) / (FEED_STALL.count
                                                   - stall0[1])
        launches = ck.launch_counts()
        paths = ck.attention_path_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in losses]
        require(all(math.isfinite(x) for x in losses),
                "%s: non-finite loss %s" % (label, losses))
        n_steps = TRAIN_WARMUP + TRAIN_STEPS
        say("%s main path: %d steps, losses %s" % (
            label, n_steps, ["%.4f" % x for x in losses]))
        say("%s main path launches %s, attention paths %s"
            % (label, launches, paths))
        require(paths["flash_dropout"] > 0 and paths["xla_sdpa"] == 0,
                "%s: attention paths %s" % (label, paths))
        L = len(model.gpt.layers)
        per_step = {k: launches[k] / n_steps for k in launches}
        want = {"flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "adamw": len(list(model.parameters())),
                "fused_dropout_ln_fwd": L if fused else 0,
                "fused_dropout_residual_fwd": L if fused else 0,
                "fused_dropout_ln_bwd": 2 * L if fused else 0}
        require(all(per_step[k] == v for k, v in want.items()),
                "%s: launches per step %s, want %s" % (label, per_step, want))
        step_ms = statistics.median(times[TRAIN_WARMUP:])
        tokens = TRAIN_B * TRAIN_T
        d = model.gpt.hidden_size
        flops = 6 * n_params * tokens + 12 * L * d * TRAIN_T * tokens
        mfu = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
        say("%s main path: B=%d T=%d, step %.2f ms median (%.2f mean) over "
            "%d timed steps, %.0f tokens/s, MFU %.4f of 989 TFLOP/s bf16 "
            "(%s), peak memory %.1f MiB, feed stall %.3f ms a batch, "
            "launches per step %s"
            % (label, TRAIN_B, TRAIN_T, step_ms,
               statistics.mean(times[TRAIN_WARMUP:]), TRAIN_STEPS,
               tokens / (step_ms / 1e3), mfu, card, peak / 2 ** 20, stall_ms,
               {k: v for k, v in per_step.items() if v}))
        dev_ms, top = profile_step(torch, step, batch)
        it.close()
        report_profile(label, dev_ms, step_ms, top)
    finally:
        flags.set_flags(saved)
    shapes = [tuple(p.shape) for p in model.parameters()]
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
                apply = opt.apply_gradients

                def recording(pairs):
                    pairs = list(pairs)
                    if not first:
                        first.extend(g.abs() <= noise_floor for _, g in pairs)
                    return apply(pairs)
                opt.apply_gradients = recording
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
    p 0, 0.1 and 1, both modes; the keep decisions bit-equal; the gates
    raising on inputs the kernels do not take."""
    names = ("fused_dropout_ln_fwd", "fused_dropout_residual_fwd",
             "fused_dropout_ln_bwd")
    worst = {n: 0.0 for n in names}             # relative, for the checks
    worst_abs = {n: 0.0 for n in names}         # absolute, for the table
    types = (("float32", torch.float32, torch.float32),
             ("bfloat16", torch.bfloat16, torch.bfloat16),
             ("mixed", torch.bfloat16, torch.float32),
             ("mixed", torch.float32, torch.bfloat16))
    n = 0
    for N, Hd in ((301, 64), (4096, 768), (67, 1000)):
        bits = ck.fused_dropout_bits(SEED, OFFSET, N, Hd)
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
                                                   p, s, 1e-5, SEED, OFFSET)
                    z1 = ck.fused_dropout_residual_fwd(x, res, bias, p, s,
                                                       SEED, OFFSET)
                    yp, zp = ck.fused_dropout_ln_fwd_plain(
                        x, res, bias, gamma, beta, p, s, 1e-5, bits=bits)
                    z1p = ck.fused_dropout_residual_fwd_plain(
                        x, res, bias, p, s, bits=bits)
                    outs = {"fused_dropout_ln_fwd": [(y, yp), (z, zp)],
                            "fused_dropout_residual_fwd": [(z1, z1p)],
                            "fused_dropout_ln_bwd": []}
                    for g, dzx in ((gamma, dz), (None, dz), (gamma, None)):
                        got = ck.fused_dropout_ln_bwd(z, dy, dzx, g, p, s,
                                                      1e-5, SEED, OFFSET)
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
                    torch.cuda.synchronize()
                    for name, pairs in outs.items():
                        for a, b in pairs:
                            require(a.dtype == b.dtype and a.shape == b.shape
                                    and bool(torch.isfinite(a.float()).all()),
                                    (what % name) + ": type, shape or "
                                    "non-finite")
                        ea, er = (max(v) for v in zip(*(abs_rel_err(a, b)
                                                        for a, b in pairs)))
                        require(er <= tol, (what % name) + ": rel err %.3g > "
                                "%.3g" % (er, tol))
                        worst[name] = max(worst[name], er)
                        worst_abs[name] = max(worst_abs[name], ea)
                    n += 1
        # the forward's keep decisions: ones + 0 residual is 0 where dropped
        ones, zeros = (torch.ones((N, Hd), device="cuda"),
                       torch.zeros((N, Hd), device="cuda"))
        for p in (DROPOUT, 0.5):
            z1 = ck.fused_dropout_residual_fwd(ones, zeros, None, p, 1.0,
                                               SEED, OFFSET)
            require(torch.equal(z1 != 0, bits >= int(p * 2 ** 32)),
                    "fused_dropout_residual_fwd: keep mask differs from the "
                    "bits at p=%g" % p)
    for name in names:
        say("check %s: max rel err %.3g (tol f32 %.0e, bf16 %.0e, by the "
            "output's type), max abs err %.3g, over %d cases (f32, bf16, "
            "mixed; Hd 64, 768, 1000; p 0, %g, 1; both modes)"
            % (name, worst[name], FDRLN_F32_REL_TOL, FDRLN_BF16_REL_TOL,
               worst_abs[name], n, DROPOUT))
    # the drop rate and the gates
    bits = ck.fused_dropout_bits(SEED, OFFSET, 8192, 768)
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
    bits = ck.fused_dropout_bits(SEED, OFFSET, N, Hd)
    y, z = ck.fused_dropout_ln_fwd(x, res, None, g, b, p, s, 1e-5, SEED,
                                   OFFSET)
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
            x, res, None, g, b, p, s, 1e-5, SEED, OFFSET)),
        "plain_ms": timer.ms(lambda: ck.fused_dropout_ln_fwd_plain(
            x, res, None, g, b, p, s, 1e-5, bits=bits)),
        "library_ms": timer.ms(lambda: tF.layer_norm(
            res + tF.dropout(x, p), (Hd,), g, b, 1e-5)),
        "bound_ms": bound, "bound_by": by}
    # row 5: reads x, res; writes z; 2 flops an element
    bound, by = bound_ms(3 * rows, 2 * flop, "float32")
    out["fused_dropout_residual_fwd"] = {
        "ms": timer.ms(lambda: ck.fused_dropout_residual_fwd(
            x, res, None, p, s, SEED, OFFSET)),
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
            z, dy, dzx, g, p, s, 1e-5, SEED, OFFSET)),
        "plain_ms": timer.ms(lambda: ck.fused_dropout_ln_bwd_plain(
            z, dy, dzx, g, p, s, 1e-5, bits=bits)),
        "library_ms": timer.ms(lambda: torch.autograd.grad(
            outs, (lx, lr, lg, lb), cot, retain_graph=True)),
        "bound_ms": bound, "bound_by": by}
    noln = {"ms": timer.ms(lambda: ck.fused_dropout_ln_bwd(
                z, dy, None, None, p, s, 1e-5, SEED, OFFSET)),
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
    FLAGS_use_fused_dropout_ln on; 3 warm-up and 10 timed steps, the
    counters zeroed just before and read just after; then one step under
    torch.profiler. Returns the launch counts."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.models import BertPretrainingCriterion, ernie_base

    saved = flags.get_flags(["use_fused_dropout_ln"])
    flags.set_flags({"use_fused_dropout_ln": True})
    try:
        t0 = time.perf_counter()
        net = ernie_base(seed=0)
        net.train()
        prandom.seed(0)
        crit = BertPretrainingCriterion()
        opt = optimizer.AdamW(parameters=net.parameters(),
                              learning_rate=1e-4, weight_decay=0.01)
        step = make_train_step(
            net, lambda lg, nl, y1, y2: crit(lg, nl, y1, y2), opt)
        vocab = net.bert.embeddings.word_embeddings.weight.shape[0]
        batch = ernie_batch(torch, vocab, ERNIE_B, ERNIE_T)
        n_params = sum(p.numel() for p in net.parameters())
        n_tensors = len(list(net.parameters()))
        say("ernie: ernie-base %d parameters (%d tensors) in %s, built in "
            "%.1f s" % (n_params, n_tensors, next(net.parameters()).dtype,
                        time.perf_counter() - t0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.launch_counts(reset=True)
        ck.attention_path_counts(reset=True)
        losses, times = [], []
        with amp.auto_cast(level="O2"):
            for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
                t0 = time.perf_counter()
                loss, (logits, _) = step(*batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss)
            launches = ck.launch_counts()
            paths = ck.attention_path_counts()
            peak = torch.cuda.max_memory_allocated()
            dev_ms, top = profile_step(torch, step, lambda: batch)
        losses = [float(x) for x in losses]
        require(all(math.isfinite(x) for x in losses),
                "ernie: non-finite loss %s" % losses)
        require(logits.dtype == torch.float32
                and tuple(logits.shape) == (ERNIE_B, ERNIE_T, vocab),
                "ernie: logits %s %s" % (logits.dtype, tuple(logits.shape)))
        n_steps = TRAIN_WARMUP + TRAIN_STEPS
        L = len(net.bert.layers)
        per_step = {k: launches[k] / n_steps for k in launches}
        say("ernie main path: %d steps, losses %s" % (
            n_steps, ["%.4f" % x for x in losses]))
        say("ernie main path launches per step %s, attention paths %s"
            % ({k: v for k, v in per_step.items() if v}, paths))
        want = {"fused_dropout_ln_fwd": 2 * L, "fused_dropout_ln_bwd": 2 * L,
                "flash_fwd_train": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "adamw": n_tensors, "fused_dropout_residual_fwd": 0}
        require(all(per_step[k] == v for k, v in want.items()),
                "ernie: launches per step %s, want %s" % (per_step, want))
        require(paths["flash_dropout"] == L * n_steps
                and paths["xla_sdpa"] == 0 and paths["flash"] == 0,
                "ernie: attention paths %s" % paths)
        step_ms = statistics.median(times[TRAIN_WARMUP:])
        tokens = ERNIE_B * ERNIE_T
        d = net.bert.hidden_size
        flops = 6 * n_params * tokens + 12 * L * d * ERNIE_T * tokens
        mfu = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
        say("ernie main path: B=%d T=%d, step %.2f ms median (%.2f mean) "
            "over %d timed steps, %.0f tokens/s, MFU %.4f of 989 TFLOP/s "
            "bf16 (%s), peak memory %.1f MiB"
            % (ERNIE_B, ERNIE_T, step_ms,
               statistics.mean(times[TRAIN_WARMUP:]), TRAIN_STEPS,
               tokens / (step_ms / 1e3), mfu, card, peak / 2 ** 20))
        report_profile("ernie", dev_ms, step_ms, top)
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
        comparison runs only), keyed by the request's prompt object."""

        batcher = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gaps = {}
            self._gap = None

        def _logits(self, hidden):
            logits = super()._logits(hidden)
            top = torch.topk(logits.float(), 2, dim=-1).values
            self._gap = (top[..., 0] - top[..., 1]).reshape(-1)
            return logits

        def prefill(self, slot, prompt):
            tok = super().prefill(slot, prompt)
            self.gaps.setdefault(id(prompt), []).append(self._gap[0])
            return tok

        def decode(self):
            out = super().decode()
            for s, req in enumerate(self.batcher.slots):
                if req is not None:
                    self.gaps.setdefault(id(req.prompt), []).append(
                        self._gap[s])
            return out
    return RecordingEngine


def serve(serving, engine, reqs):
    """Serve `reqs` through ContinuousBatcher; returns (requests, wall s,
    decode step wall times in ms)."""
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
    for r in rs:
        batcher.submit(r)
    batcher.run_until_idle(max_steps=10_000)
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

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_fwd": check_flash(torch, ck, gen),
            "paged_decode": check_paged(torch, ck, False, gen),
            "paged_decode_int8": check_paged(torch, ck, True, gen)}
    check_dropout_bits(torch, ck)
    errs.update(check_flash_train(torch, ck, gen))
    errs["adamw"] = check_adamw(torch, ck, gen)
    check_gates(torch, ck, gen)
    errs.update(check_fused(torch, ck, flags, gen))
    if opts.kernels_only:
        say("kernels-only run: checks passed")
        return 0

    # 4. kernel timings at the main path's shapes
    timer = Timer(torch)
    times = {}
    for T in (32, 128, 256):
        t = time_flash(torch, ck, F, timer, gen, T)
        say("time flash_fwd B=1 H=12 T=%d D=64 f32 causal: %.4f ms, plain "
            "%.4f ms, sdpa %.4f ms, bound %.4f ms (%s)"
            % (T, t["ms"], t["plain_ms"], t["library_ms"], t["bound_ms"],
               t["bound_by"]))
        times["flash_fwd"] = t                    # the 256 bucket is kept
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
    cfg = dict(max_batch=8, max_seq_len=512, prefill_buckets=(32, 128, 256))
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
    peak = torch.cuda.max_memory_allocated()
    ntok = sum(len(r.tokens) for r in kreqs)
    ttft = sorted(r.ttft_s for r in kreqs)
    say("main path: %d requests, %d tokens in %.3f s: %.1f tokens/s; TTFT "
        "p50 %.1f ms (16 submitted at once on 8 slots); %d decode steps, "
        "%.2f ms/step median, %.2f ms/step mean; prefix hits %d; peak "
        "memory %.1f MiB (KV cache %.1f MiB)"
        % (len(kreqs), ntok, wall, ntok / wall,
           statistics.median(ttft) * 1e3, len(steps),
           statistics.median(steps), statistics.mean(steps),
           sum(1 for r in kreqs if r.prefix_len > 0), peak / 2**20,
           eng.kv.nbytes / 2**20))
    say("main path launches %s, attention paths %s" % (launches, paths))
    require(launches["flash_fwd"] > 0 and launches["paged_decode"] > 0,
            "the main path did not launch both kernels: %s" % launches)
    require(paths["xla_sdpa"] == 0 and paths["xla_paged"] == 0,
            "the main path took a plain attention path: %s" % paths)
    require(any(r.prefix_len > 0 for r in kreqs),
            "no prefix-cache hit: the suffix path did not run")
    dev_ms, top = profile_decode(torch, eng)
    step_ms = statistics.median(steps)
    if dev_ms > 0:
        say("decode step profile: %.3f ms of kernels per step (torch."
            "profiler, 10 steps) vs %.2f ms wall: device idle %.1f %%"
            % (dev_ms, step_ms, 100.0 * (1.0 - dev_ms / step_ms)))
        for t_us, key, count in top:
            say("  %8.1f us/step  %5d launches  %s"
                % (t_us / 10, count, key[:90]))
    else:
        say("decode step profile: not measured (the profiler saw no "
            "device activity)")
    del eng

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
    k8, wall8, _ = serve(serving, e8, ireqs)
    launches8 = ck.launch_counts()
    paths8 = ck.attention_path_counts()
    say("int8 run: %d requests in %.3f s, launches %s, attention paths %s"
        % (len(k8), wall8, launches8, paths8))
    require(launches8["paged_decode_int8"] > 0 and
            launches8["flash_fwd"] > 0,
            "the int8 run did not launch its kernels: %s" % launches8)
    require(paths8["xla_sdpa"] == 0 and paths8["xla_paged"] == 0,
            "the int8 run took a plain attention path: %s" % paths8)
    del e8
    p8, gaps8 = plain_run(ireqs, kv_dtype="int8")
    compare_tokens(k8, p8, gaps8, "int8")

    # 8-10. training: kernel times, the main path, kernels vs plain
    times.update(train_timings(torch, ck, F, timer, gen))
    tlaunches, shapes, off_ms = train_main(torch, ck, flags, card)
    times["adamw"] = time_adamw(torch, ck, timer, gen, shapes)
    train_compare(torch, ck, flags)

    # 11-12. rows 4-6 at the paths' shapes; path B: GPT-2 training with
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

    # 13-14. path A: ERNIE-base pretraining, then kernels vs plain
    alaunches = ernie_main(torch, ck, flags, card)
    ernie_compare(torch, ck, flags)

    counts = {"flash_fwd": launches["flash_fwd"],
              "paged_decode": launches["paged_decode"],
              "paged_decode_int8": launches8["paged_decode_int8"]}
    for name in ("flash_fwd_train", "flash_bwd_dq", "flash_bwd_dkv",
                 "adamw"):
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
    say(card)
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
