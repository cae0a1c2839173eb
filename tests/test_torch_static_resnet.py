"""bench_resnet50's static body (train_bench.py) on the port and against the
JAX package, on the CPU: the float32 body as written, its program op for
op the reference's, and both packages' static training in float64 (the
tolerances and the reason for float64 are tests/test_torch_static.py's
docstring's). A file of its own so that pytest-xdist, which runs the
files with the most tests first, runs these two long tests beside the
other files' last ones.
"""
import jax
import numpy as np
import torch

import paddle_tpu as jpaddle
from paddle_tpu import static as jstatic
import paddle_tpu_torch as paddle
from paddle_tpu_torch import static
from paddle_tpu_torch.models import load_reference_state
from test_torch_static import (F64_STEPS, F64_TOL, _rel,  # noqa: F401
                               _resnet_program, _state, _types,
                               static_modes)
import torch_threads  # noqa: F401  (one intra-op thread a worker)


def test_bench_resnet50_static_body_on_the_port_and_against_the_reference():
    """The bench's ResNet-50 static body on the port (5 float32 steps at
    32x32, B=4: one program, replayed), and its program op for op the
    reference's (53 training batch norms). The float64 comparison of the
    two packages' static training is the next test."""
    from paddle_tpu.vision.models import resnet50 as jresnet50
    from paddle_tpu_torch.vision.models import resnet50
    hw, B = 32, 4
    rs = np.random.RandomState(0)
    x = rs.rand(B, 3, hw, hw)
    y = rs.randint(0, 100, (B, 1)).astype(np.int64)
    # the bench's body as written (its CPU branch), on the port
    paddle.seed(0)
    img = static.data("image", [-1, 3, hw, hw], "float32")
    label = static.data("label", [-1, 1], "int64")
    net = resnet50(num_classes=100)
    logits = net(img)
    loss = paddle.nn.functional.cross_entropy(logits, label)
    opt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    opt.minimize(loss)
    exe = static.Executor()
    exe.run(static.default_startup_program())
    mean0 = net.bn1._mean.clone()
    feed = {"image": x.astype(np.float32), "label": y}
    losses = [float(exe.run(feed=feed, fetch_list=[loss])[0])
              for _ in range(3)]
    for _ in range(2):
        (lv,) = exe.run(feed=feed, fetch_list=[loss], return_numpy=False)
        losses.append(float(lv.numpy()))
    assert np.isfinite(losses).all()
    (cp,) = exe._cache.values()
    assert cp.step.compiles == 1 and cp.step.replays == 4
    assert not torch.equal(net.bn1._mean, mean0)
    port_types = _types(static.default_main_program())
    assert port_types.count("batch_norm_train_stats") == 53
    # the reference records the same program (recorded, not run)
    jpaddle.seed(0)
    _resnet_program(jpaddle, jstatic, jresnet50(num_classes=100),
                      "float32", hw)
    assert _types(jstatic.default_main_program()) == port_types


def test_static_float64_training_steps_match_the_reference():
    """The bench body's program (cross entropy, Momentum.minimize) in
    float64, the reference against the port from the same weights, 3 steps
    of fresh batches: every loss, and every parameter and running
    statistic after each update, within 1e-8. ResNet-18 at 64x64, B=8:
    its last stage's batch norms see 32 values a channel, as ResNet-50's
    do at that size, at a third of the depth that the reference's float64
    program compiles (the ResNet-50 program's op types are the test
    above's)."""
    from paddle_tpu.vision.models import resnet18 as jresnet18
    from paddle_tpu_torch.vision.models import resnet18
    rs = np.random.RandomState(1)
    hw, B = 64, 8
    xs = [rs.rand(B, 3, hw, hw) for _ in range(F64_STEPS)]
    ys = [rs.randint(0, 100, (B, 1)).astype(np.int64)
          for _ in range(F64_STEPS)]
    with jax.enable_x64(True):
        jpaddle.disable_static()
        jpaddle.seed(0)
        ref = jresnet18(num_classes=100)
        ref.to(dtype="float64")
        state = {k: np.asarray(v.numpy())
                 for k, v in ref.state_dict().items()}
        jpaddle.enable_static()
        jloss = _resnet_program(jpaddle, jstatic, ref, "float64", hw)
        jexe = jstatic.Executor()
        want, after = [], []
        for x, y in zip(xs, ys):
            (lv,) = jexe.run(feed={"image": x, "label": y},
                             fetch_list=[jloss])
            want.append(float(lv))
            after.append(_state(ref, False))
        ref_types = _types(jstatic.default_main_program())
    port = resnet18(num_classes=100).double()
    load_reference_state(port, state)
    ploss = _resnet_program(paddle, static, port, "float64", hw)
    assert ref_types == _types(static.default_main_program())
    assert ref_types.count("batch_norm_train_stats") == 20
    pexe = static.Executor()
    # each step's loss, then every parameter and running statistic after
    # its update
    for step, (x, y) in enumerate(zip(xs, ys)):
        (got,) = pexe.run(feed={"image": x, "label": y}, fetch_list=[ploss])
        assert abs(float(got) - want[step]) <= F64_TOL * abs(want[step])
        got_state = _state(port, True)
        for k in after[step]:
            assert _rel(got_state[k], after[step][k]) <= F64_TOL, (step, k)
