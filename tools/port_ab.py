#!/usr/bin/env python3
"""Parent-against-change timing of the port's serving kernels, one GPU.

    python3 tools/port_ab.py TREE LABEL [--tiles | --train]

TREE is a checkout of this repository (for example a commit's `git
archive` unpacked into a directory that .gitignore lists). The script
imports that tree's chip_smoke.py and paddle_tpu_torch, builds its kernels
and prints, each line tagged LABEL:
  * the float32 flash forward (PERF.md row 1) at the serving buckets
    (B=1, H=12, T = 32, 128, 256, D=64, causal), beside sdpa;
  * the paged-decode kernel on both caches (rows 8f and 8q) at
    chip_smoke.py's timed shape;
  * gpt2-small served as chip_smoke.py's main path serves it, with a
    float32 and then an int8 cache: the decode step's wall time three ways
    (as the main path takes it; with the device queue drained before each
    step, so no prefill work left in the queue is counted; in a loop of
    decode steps with no prefill between them) and its kernel time a step
    (torch.profiler), with the paged kernel's share; and the main path's
    tokens/s and TTFT p50.
With --tiles (a tree whose float32 flash forward takes a tile size), the
float32 flash forward also runs at every tile size its kernel takes, at 12
heads and at 1, three times in turn. With --train, only the training
kernels are timed instead, through the tree's own chip_smoke.py (so each
tree passes its dropout key its own way): rows 1t, 2 and 3 at GPT-2's and
ERNIE's shapes (`train_timings`), rows 4-6 at path B's and path A's
(`time_fused`). All times are CUDA-event or
torch.profiler device times unless called wall. Run it in turns (change,
parent, parent, change, ...) in one command to compare two trees on one
card; each tree builds its own kernels.
"""
import ctypes
import os
import statistics
import sys
import time


def serving_lines(torch, np, cs, serving, model, tag):
    med = statistics.median
    reqs = cs.make_requests(np)
    cfg = dict(max_batch=8, max_seq_len=512, prefill_buckets=(32, 128, 256))
    warm = serving.GenerationEngine(model, **cfg)
    cs.serve(serving, warm, [(np.arange(1, 6), 4), (np.arange(1, 101), 4)])
    del warm
    for kv in ("float32", "int8"):
        rq = reqs if kv == "float32" else [(p, min(m, 24))
                                           for p, m in reqs[:8]]
        eng = serving.GenerationEngine(model, kv_dtype=kv, **cfg)
        done, wall, steps = cs.serve(serving, eng, rq)
        ntok = sum(len(r.tokens) for r in done)
        ttft = med(r.ttft_s for r in done) * 1e3
        drained_eng = serving.GenerationEngine(model, kv_dtype=kv, **cfg)
        decode = drained_eng.decode

        def drained():
            torch.cuda.synchronize()
            return decode()
        drained_eng.decode = drained
        _, _, drained_steps = cs.serve(serving, drained_eng, rq)
        loop = []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode()
            loop.append((time.perf_counter() - t0) * 1e3)
        dev_ms, top = cs.profile_decode(torch, eng)
        paged = ["%.1f us" % (t_us / 10) for t_us, key, _ in top
                 if "paged" in key]
        print("%s: %s decode step wall %.2f ms (main path), %.2f ms "
              "(drained), %.2f ms (loop); kernels %.3f ms a step, paged %s; "
              "%.1f tokens/s, TTFT p50 %.1f ms"
              % (tag, kv, med(steps), med(drained_steps), med(loop[5:]),
                 dev_ms, paged, ntok / wall, ttft), flush=True)
        del eng, drained_eng


def tile_lines(torch, cs, ck, timer, gen, tag):
    lib = ck._build.load("flash_fwd")
    for T in (32, 128, 256):
        for H in (12, 1):
            q, k, v = cs.qkv_views(torch, 1, T, H, 64, torch.float32, gen)
            want = ck.flash_attention_plain(q, k, v, True)
            o = ck._bhtd_empty(1, H, T, 64, q)
            st = ck._strides(q, k, v, o)
            warps, chosen = ck.flash_f32_geometry(T, T, 64, True)
            res = {}
            for _ in range(3):
                for tile in (8, 16):
                    def run(tile=tile):
                        err = lib.flash_fwd(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), None, ctypes.addressof(st), 1, H,
                            T, T, 64, 1, 0.125, 0, warps, tile, 0, 0, 1.0,
                            0, 0, ck._stream(q))
                        assert err == 0, err
                    run()
                    torch.cuda.synchronize()
                    assert (o - want).abs().max().item() <= cs.TOL["float32"]
                    res.setdefault(tile, []).append(timer.ms(run))
            print("%s: flash f32 T=%d H=%d tiles %s (geometry: %d)"
                  % (tag, T, H, "; ".join(
                      "%d keys %s ms" % (t, "/".join("%.4f" % x for x in v))
                      for t, v in res.items()), chosen), flush=True)


def train_lines(torch, cs, ck, F, timer, gen):
    """The training kernels' times, as the tree's chip_smoke.py prints
    them ("time ..." lines)."""
    if hasattr(cs, "WORD"):             # the dropout key in device memory
        from paddle_tpu_torch.framework.random import philox_word
        cs.WORD = philox_word(cs.SEED, cs.OFFSET - cs.DELTA, "cuda")
    cs.train_timings(torch, ck, F, timer, gen)
    cs.time_fused(torch, ck, timer, gen, cs.TRAIN_B * cs.TRAIN_T, 768,
                  torch.bfloat16, True, "gpt2 (path B)")
    cs.time_fused(torch, ck, timer, gen, cs.ERNIE_B * cs.ERNIE_T, 768,
                  torch.float32, False, "ernie (path A)")


def main():
    tree, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.models import gpt2_small
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        raise SystemExit("port_ab: no CUDA device")
    print("%s: %s, build %.1f s" % (tag, torch.cuda.get_device_name(0),
                                    _build.build()), flush=True)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "--train" in sys.argv:
        train_lines(torch, cs, ck, F, timer, gen)
        return
    for T in (32, 128, 256):
        t = cs.time_flash(torch, ck, F, timer, gen, T)
        print("%s: row 1 T=%d %.4f ms (sdpa %.4f ms)"
              % (tag, T, t["ms"], t["library_ms"]), flush=True)
    lens = [int(x) for x in np.random.RandomState(1).randint(2, 320, 8)]
    for quant in (False, True):
        t = cs.time_paged(torch, ck, F, timer, gen, quant, lens)
        print("%s: row 8%s %.4f ms" % (tag, "q" if quant else "f", t["ms"]),
              flush=True)
    if "--tiles" in sys.argv:
        tile_lines(torch, cs, ck, timer, gen, tag)
    serving_lines(torch, np, cs, serving, gpt2_small(seed=0), tag)


if __name__ == "__main__":
    main()
