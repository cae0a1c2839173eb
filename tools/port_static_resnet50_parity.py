#!/usr/bin/env python3
"""ResNet-50's static training (train_bench.py bench_resnet50's body) in
the JAX package and in the port, each in float32 and float64, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/port_static_resnet50_parity.py \
        [--hw 32] [--batch 4] [--steps 5]

All four runs start from the reference's `paddle.seed(0)` weights (made in
float64 and rounded to float32 for the float32 runs) and take the same
batch at every step, as the bench does. Prints each run's losses and their
distance from the reference's float64 losses (|a - b| / |b|): what the
reference's own float32 run shows beside its float64 one is the rounding
that the configuration amplifies, against which the port's float32 run
can be read.
"""
from __future__ import annotations

import argparse

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")


def program(pkg, st, net, dtype, hw):
    img = st.data("image", [-1, 3, hw, hw], dtype)
    label = st.data("label", [-1, 1], "int64")
    loss = pkg.nn.functional.cross_entropy(net(img), label)
    pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    opts = ap.parse_args()

    import paddle_tpu as jpaddle
    from paddle_tpu import static as jstatic
    from paddle_tpu.vision.models import resnet50 as jresnet50
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models import load_reference_state
    from paddle_tpu_torch.vision.models import resnet50

    paddle.set_device("cpu")
    hw, B = opts.hw, opts.batch
    rs = np.random.RandomState(0)
    x = rs.rand(B, 3, hw, hw)
    y = rs.randint(0, 100, (B, 1)).astype(np.int64)
    with jax.enable_x64(True):
        jpaddle.seed(0)
        r = jresnet50(num_classes=100)
        r.to(dtype="float64")
        state = {k: np.asarray(v.numpy())
                 for k, v in r.state_dict().items()}
    losses = {}
    for dt in ("float64", "float32"):
        weights = {k: v.astype(dt) for k, v in state.items()}
        feed = {"image": x.astype(dt), "label": y}
        with jax.enable_x64(dt == "float64"):
            jpaddle.disable_static()
            ref = jresnet50(num_classes=100)
            if dt == "float64":
                ref.to(dtype="float64")
            ref.set_state_dict(weights)
            jpaddle.enable_static()
            jstatic.reset_default_programs()
            jl = program(jpaddle, jstatic, ref, dt, hw)
            exe = jstatic.Executor()
            losses["reference " + dt] = [
                float(exe.run(feed=feed, fetch_list=[jl])[0])
                for _ in range(opts.steps)]
            jpaddle.disable_static()
        paddle.enable_static()
        static.reset_default_programs()
        port = resnet50(num_classes=100)
        if dt == "float64":
            port = port.double()
        load_reference_state(port, weights)
        pl = program(paddle, static, port, dt, hw)
        exe = static.Executor()
        losses["port " + dt] = [float(exe.run(feed=feed, fetch_list=[pl])[0])
                                for _ in range(opts.steps)]
        paddle.disable_static()
    base = np.array(losses["reference float64"])
    print("ResNet-50 static training, %dx%d, B=%d, Momentum(0.01, 0.9), "
          "%d steps on one batch" % (hw, hw, B, opts.steps))
    for name, ls in losses.items():
        rel = np.abs(np.array(ls) - base) / np.abs(base)
        print("%-18s losses %s" % (name, " ".join("%.9g" % v for v in ls)))
        print("%-18s rel to reference float64 %s"
              % ("", " ".join("%.2g" % v for v in rel)))


if __name__ == "__main__":
    main()
