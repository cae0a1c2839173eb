#!/usr/bin/env python3
"""What `chip_smoke.py`'s kernels-against-plain comparison of Transformer-
base training (phase 23 (b), `nmt_compare`) can and cannot see, on the
card.

    python3 tools/port_train_compare_probe.py

1. The two float32 runs (kernels on, then off) of NMT_COMPARE_STEPS
   steps, every element kept: for the elements whose parameters end more
   than TRAIN_PARAM_TOL apart, the largest |g| of the plain run's first
   step over its parameter's gradient RMS; and, for a few shares of that
   RMS, how many elements a near-zero rule at that share sets aside and
   the largest difference left outside them.
2. `nmt_compare` itself with the flash backward's dK / dV made wrong on
   purpose (scaled by 1.002 and by 1.01, dropped, swapped with dV, by
   wrapping `cuda_kernels.flash_bwd_dkv` in this process only): each must
   be refused, and the line says by what.

Builds the kernels first; needs one card.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def runs(torch, ck, flags, batches):
    """Both runs' first-step gradients and final parameters."""
    from paddle_tpu_torch.jit import make_train_step
    from paddle_tpu_torch.nn import functional as PF
    kernel_flags = ("use_flash_attention", "use_fused_dropout_ln",
                    "use_fused_optimizer")
    saved = flags.get_flags(list(kernel_flags))
    out = []
    for on in (True, False):
        flags.set_flags({f: on for f in kernel_flags})
        try:
            model, opt, _ = cs.nmt_build("float32", 0.0, cs.TRAIN_LR)
            step = make_train_step(
                model, lambda o, l: cs.seq2seq_loss(PF, o, l), opt)
            first, apply = [], opt.apply_updates

            def recording(pairs, first=first, apply=apply):
                pairs = list(pairs)
                if not first:
                    first.extend(g.detach().clone() for _, g in pairs)
                return apply(pairs)
            opt.apply_updates = recording
            for i in range(cs.NMT_COMPARE_STEPS):
                step(*batches[i])
            torch.cuda.synchronize()
            out.append((first, [p.detach().clone()
                                for p in model.parameters()]))
            del model, opt, step
            cs.free_memory(torch)
        finally:
            flags.set_flags(saved)
    return out


def main():
    import torch

    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.framework.random import philox_word
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import cuda_kernels as ck
    cs.require(torch.cuda.is_available(), "CUDA is not available")
    _build.build()
    cs.WORD = philox_word(cs.SEED, cs.OFFSET - cs.DELTA, "cuda")
    batches = cs.nmt_batches(torch, cs.NMT_BATCHES)

    (_, kp), (pg, pp) = runs(torch, ck, flags, batches)
    share = [g.abs() / g.float().pow(2).mean().sqrt().clamp_min(1e-30)
             for g in pg]
    diffs = [(a - b).abs() for a, b in zip(kp, pp)]
    apart = [d > cs.TRAIN_PARAM_TOL for d in diffs]
    n = sum(int(a.sum()) for a in apart)
    worst = max((s[a].max().item() for s, a in zip(share, apart)
                 if bool(a.any())), default=0.0)
    total = sum(d.numel() for d in diffs)
    cs.say("nmt compare probe: %d of %d elements more than %.0e apart after "
           "%d steps; their largest first-step |g| is %.4g of their "
           "parameter's gradient RMS"
           % (n, total, cs.TRAIN_PARAM_TOL, cs.NMT_COMPARE_STEPS, worst))
    for near in (0.01, 0.03, 0.1):
        quiet = [s <= near for s in share]
        left = max(d.masked_fill(q, 0.0).max().item()
                   for d, q in zip(diffs, quiet))
        cs.say("nmt compare probe: near zero at %g of the RMS sets aside %d "
               "elements (%.1f %%); the largest difference left %.3g"
               % (near, sum(int(q.sum()) for q in quiet),
                  100.0 * sum(int(q.sum()) for q in quiet) / total, left))
    del pg, pp, kp, share, diffs, apart
    cs.free_memory(torch)

    orig = ck.flash_bwd_dkv
    wrong = {"dK x 1.002": lambda dk, dv: (dk * 1.002, dv),
             "dK x 1.01": lambda dk, dv: (dk * 1.01, dv),
             "dK dropped": lambda dk, dv: (torch.zeros_like(dk), dv),
             "dK and dV swapped": lambda dk, dv: (dv, dk)}
    refused = 0
    saved = flags.get_flags(["use_fused_dropout_ln"])
    for name, f in wrong.items():
        ck.flash_bwd_dkv = lambda *a, _f=f, **k: _f(*orig(*a, **k))
        flags.set_flags({"use_fused_dropout_ln": True})
        try:
            cs.nmt_compare(torch, ck, flags, batches)
            cs.say("nmt compare probe: %s NOT refused" % name)
        except SystemExit as e:
            refused += 1
            cs.say("nmt compare probe: %s refused (%s)" % (name, e))
        finally:
            ck.flash_bwd_dkv = orig
            flags.set_flags(saved)
            cs.free_memory(torch)
    cs.require(refused == len(wrong), "a wrong dK / dV passed nmt_compare")


if __name__ == "__main__":
    main()
