#!/usr/bin/env python3
"""Probe of the port's fused recurrence against cuDNN's, on the card.

    python3 tools/port_rnn_probe.py [--batches 20,128]

For the large LSTM language model's recurrence (LSTM(1500, 1500, 2),
T=35) and a 2-layer bidirectional GRU(512, 512) (T=128, every row at
full length), at each batch size: a training step of the recurrence
(forward and the gradients of the input, the states and the weights)
run by the port eagerly and replayed from a CUDA graph, and cuDNN's
(torch.nn.LSTM / GRU) for the same work, each timed with CUDA events
(chip_smoke.Timer); the kernels one graph replay launches, counted by
torch.profiler; the step's FLOP bound at 67 TFLOP/s float32. TF32 is off
(the port's import turns it off) for both. Not part of chip_smoke.py and
not run by the tests: a yardstick for work on the recurrence's speed.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CASES = (("LSTM", cs.PTB_HIDDEN, cs.PTB_LAYERS, 1, cs.PTB_T),
         ("GRU", cs.GRU_H, cs.GRU_LAYERS, 2, cs.GRU_T))


def graph_kernels(torch, graph):
    """Kernels launched by one replay of `graph`, as torch.profiler sees
    them (None when the profiler records no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA)
    return n or None


def probe(torch, timer, mode, H, L, dirs, T, B, card):
    from paddle_tpu_torch import nn
    gen = torch.Generator(device="cuda").manual_seed(0)
    cls = nn.LSTM if mode == "LSTM" else nn.GRU
    port = cls(H, H, L, direction="bidirect" if dirs == 2 else "forward",
               generator=torch.Generator().manual_seed(0)).cuda()
    ref = getattr(torch.nn, mode)(H, H, L, batch_first=True,
                                  bidirectional=dirs == 2).cuda()
    cs.copy_rnn_weights(torch, port, ref)
    x = torch.randn(B, T, H, generator=gen, device="cuda",
                    requires_grad=True)
    h0 = torch.zeros(L * dirs, B, H, device="cuda", requires_grad=True)
    states = (h0, torch.zeros_like(h0, requires_grad=True)) \
        if mode == "LSTM" else h0
    leaves = [x] + (list(states) if mode == "LSTM" else [states])

    def step(m):
        def call():
            y = m(x, states)[0]
            torch.autograd.grad(y, leaves + list(m.parameters()),
                                torch.ones_like(y))
        return call
    eager_ms = timer.ms(step(port), 5, 1)
    cudnn_ms = timer.ms(step(ref), 9, 3)
    graph = cs.graph_of(torch, step(port))
    graph_ms = timer.ms(graph.replay)
    kernels = graph_kernels(torch, graph)
    flops = 3 * cs.rnn_flops(mode, B, T, H, H, L, dirs)
    cs.say("%s(%d, %d, %d%s) B=%d T=%d step (forward + backward): port %.3f "
           "ms eager, %.3f ms from a graph of %s kernels, cuDNN %.3f ms "
           "(port graph / cuDNN %.2f), bound %.3f ms (%.1f GFLOP at 67 "
           "TFLOP/s float32; %s)"
           % (mode, H, H, L, ", bidirect" if dirs == 2 else "", B, T,
              eager_ms, graph_ms, kernels, cudnn_ms, graph_ms / cudnn_ms,
              flops / cs.PEAK_FLOPS["float32"] * 1e3, flops / 1e9, card))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="%d,128" % cs.PTB_B,
                    help="batch sizes, comma-separated")
    opts = ap.parse_args()
    import torch
    import paddle_tpu_torch  # noqa: F401  (TF32 off)
    cs.require(torch.cuda.is_available(), "CUDA is not available")
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cs.say(card)
    timer = cs.Timer(torch)
    for mode, H, L, dirs, T in CASES:
        for B in (int(b) for b in opts.batches.split(",")):
            probe(torch, timer, mode, H, L, dirs, T, B, card)
            cs.free_memory(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
