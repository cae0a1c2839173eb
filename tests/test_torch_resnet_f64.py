"""ResNet-18 and ResNet-50 forward and backward in float64, and ResNet-50's
float32 eval forward, the port's against the JAX package's, on the CPU
(the sizes, tolerances and the reason for float64 are
tests/test_torch_resnet.py's docstring's). A file of its own so that
pytest-xdist, which runs the files with the most tests first, runs these
long tests beside the other files' last ones.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.vision.models import resnet50 as jresnet50
from paddle_tpu_torch.models import (export_reference_state,
                                     load_reference_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision import models as vision
from test_torch_resnet import (B, CLASSES, F64_TOL, SIZE, TOL,  # noqa: F401
                               _close, _numpy, _pair, reference18)
import torch_threads  # noqa: F401  (one intra-op thread a worker)


def _forward_backward_float64(ref, port, x, y):
    """One training-mode forward and backward of each in float64 (the
    reference under JAX's x64, then cast back to float32): logits, loss,
    gradients and the state dict after the forward, as numpy."""
    port.double()
    to = port(torch.from_numpy(x))
    tl = F.cross_entropy(to, torch.from_numpy(y))
    tl.backward()
    got = (to.detach().numpy(), tl.item(),
           {n: p.grad.numpy() for n, p in port.named_parameters()},
           export_reference_state(port))
    with jax.enable_x64(True):
        ref.to(dtype="float64")
        try:
            jo = ref(paddle.to_tensor(x, dtype="float64"))
            jl = JF.cross_entropy(jo, paddle.to_tensor(y))
            jl.backward()
            want = (jo.numpy(), float(jl.numpy()),
                    {n: p.grad.numpy() for n, p in ref.named_parameters()},
                    _numpy(ref.state_dict()))
        finally:
            ref.clear_gradients()
            ref.to(dtype="float32")
    return got, want


@pytest.mark.parametrize("depth", [18, 50])
def test_forward_backward_float64_matches_the_reference(depth, reference18):
    """ResNet-18 (basic blocks) and ResNet-50 (bottleneck blocks, 53 batch
    norms) at B=2, 64x64 in training mode, in float64: the same function
    as the reference's, to rounding."""
    if depth == 18:
        ref, port = _pair(reference18)
    else:
        paddle.seed(0)
        ref = jresnet50(num_classes=CLASSES)
        port = vision.resnet50(num_classes=CLASSES, device="cpu", seed=1)
        load_reference_state(port, _numpy(ref.state_dict()))
    rs = np.random.RandomState(6)
    x = rs.rand(B, 3, SIZE, SIZE)
    y = rs.randint(0, CLASSES, (B, 1)).astype(np.int64)
    (to, tl, tg, tstate), (jo, jl, jg, jstate) = _forward_backward_float64(
        ref, port, x, y)
    _close(to, jo, F64_TOL, "logits")
    _close(tl, jl, F64_TOL, "loss")
    for n, g in tg.items():
        _close(g, jg[n], F64_TOL, "grad " + n)
    assert sorted(tstate) == sorted(jstate)
    assert sum(k.endswith("._mean") for k in tstate) == \
        {18: 20, 50: 53}[depth]
    for k in jstate:
        _close(tstate[k], jstate[k], F64_TOL, k)


def test_resnet50_float32_eval_forward_matches_the_reference():
    """ResNet-50 in eval mode (running statistics set to seeded values),
    float32, B=2, 32x32: the logits."""
    paddle.seed(0)
    ref = jresnet50(num_classes=CLASSES)
    state = _numpy(ref.state_dict())
    rs = np.random.RandomState(7)
    for k in state:
        if k.endswith(("._mean", "._variance")):
            state[k] = (0.5 + rs.rand(*state[k].shape)).astype(np.float32)
    ref.set_state_dict(state)
    port = vision.resnet50(num_classes=CLASSES, device="cpu", seed=1)
    load_reference_state(port, state)
    ref.eval()
    port.eval()
    x = rs.rand(2, 3, 32, 32).astype(np.float32)
    want = ref(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, want, TOL, "logits")
