#!/usr/bin/env python3
"""Probe of the AdamW kernel (row 7) and the dropout keep-mask kernel
(row K) alone, on the card.

    python3 tools/port_adamw_keep_probe.py [--check]

Builds the two sources (`ops/csrc/adamw.cu`, `ops/csrc/fused_dropout_ln.cu`)
and prints the AdamW kernels' and the keep-mask kernels' registers and
spills (ptxas), the card and the AdamW table's layout; runs
chip_smoke.py's `check_adamw` (the single-tensor cases, the guard and
scale words, the multi-tensor launch over 324 mixed tensors eagerly and
from a CUDA graph) and `check_dropout_keep` at `keep_cases()`; and,
without --check, times the keep mask at [16, 512, 768] p 0.1, [128, 128,
32, 32] p 0.3 and [20, 35, 1500] p 0.1 and 0.65 (`time_dropout_keep`)
and the one-launch AdamW step over the parameter shapes of gpt2-small,
Transformer-base and GPT-2-small-MoE (bfloat16) and of the improved-DDPM
UNet (float32) (`time_adamw`: beside its bound, the plain rule and
`torch.optim.AdamW(fused=True)`). Not part of chip_smoke.py and not run
by the tests: the quick measurement after a change to either kernel
(about 140 s of command with the build on an H100).
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.framework.random import philox_word  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import cuda_kernels as ck  # noqa: E402


def main():
    cs.require(torch.cuda.is_available(), "CUDA is not available")
    t0 = time.time()
    print("build %.1f s" % _build.build(["adamw", "fused_dropout_ln"]))
    for name, log in _build.build_logs().items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "adamw_kernel" in line or "fdrln_bits" in line:
                print(name, "\n  ".join(lines[i:i + 4]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda)
    print("layout", ck._adamw_layout())
    cs.WORD = philox_word(cs.SEED, cs.OFFSET - cs.DELTA, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t1 = time.time()
    cs.check_adamw(torch, ck, gen)
    t2 = time.time()
    cs.check_dropout_keep(torch, ck, cs.keep_cases())
    print("checks: adamw %.1f s, keep %.1f s" % (t2 - t1, time.time() - t2))
    if "--check" in sys.argv:
        return 0
    timer = cs.Timer(torch)
    for shape, p in (((16, 512, 768), 0.1), ((128, 128, 32, 32), 0.3),
                     ((20, 35, 1500), 0.1), ((20, 35, 1500), 0.65)):
        cs.time_dropout_keep(torch, ck, timer, shape, p)
    from paddle_tpu_torch.models import gpt2_small
    sets = []
    for name, build, dt in (("gpt2", lambda: gpt2_small(seed=0), "bfloat16"),
                            ("nmt", lambda: cs.seq2seq_model(seed=0),
                             "bfloat16"),
                            ("moe", cs.moe_model, "bfloat16"),
                            ("unet", cs.unet_model, "float32")):
        model = build()
        sets.append((name, [tuple(q.shape) for q in model.parameters()],
                     dt))
        del model
    cs.free_memory(torch)
    for name, shapes, dt in sets:
        print("set", name, len(shapes))
        cs.time_adamw(torch, ck, timer, gen, shapes, card, dt_name=dt)
        cs.free_memory(torch)
    print("total %.1f s" % (time.time() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
