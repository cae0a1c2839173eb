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
     edge, T-1, full clamp, NaN tail), with the tolerances stated below;
     and each gate raising on inputs its kernel does not take;
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
  7. a shorter int8-cache run, held to the plain int8 path the same way.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time

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

TPU_KERNELS = {
    "flash_fwd": "paddle_tpu/ops/pallas_kernels.py:324",
    "paged_decode": "paddle_tpu/ops/pallas_kernels.py:1738",
    "paged_decode_int8": "paddle_tpu/ops/pallas_kernels.py:1746",
}
SOURCES = {
    "flash_fwd": "paddle_tpu_torch/ops/csrc/flash_fwd.cu",
    "paged_decode": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
    "paged_decode_int8": "paddle_tpu_torch/ops/csrc/paged_decode.cu",
}

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
    import numpy as np
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
            if "registers" in line or "spill" in line:
                say("ptxas %s: %s" % (name, line.strip()))

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_fwd": check_flash(torch, ck, gen),
            "paged_decode": check_paged(torch, ck, False, gen),
            "paged_decode_int8": check_paged(torch, ck, True, gen)}
    check_gates(torch, ck, gen)
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

    counts = {"flash_fwd": launches["flash_fwd"],
              "paged_decode": launches["paged_decode"],
              "paged_decode_int8": launches8["paged_decode_int8"]}
    table = [{"name": name, "route": "cuda", "source": SOURCES[name],
              "replaces": TPU_KERNELS[name], "launches": counts[name],
              "max_abs_err": errs[name], "ms": times[name]["ms"],
              "plain_ms": times[name]["plain_ms"],
              "bound_ms": times[name]["bound_ms"],
              "bound_by": times[name]["bound_by"],
              "library_ms": times[name]["library_ms"]}
             for name in ("flash_fwd", "paged_decode", "paged_decode_int8")]
    say(card)
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
