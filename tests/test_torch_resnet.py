"""The port's ResNet against the JAX package's, on the CPU: weights and
batch-norm buffers carried across by models/convert.py, the train step
with Momentum (float32, and one step under auto_cast O1 bfloat16), the
non-finite guard's skipped step, make_eval_step, and (in
tests/test_torch_resnet_f64.py, which imports this file's helpers) the
forward and backward of ResNet-18 (basic blocks) and ResNet-50
(bottleneck blocks).

Exactness is shown in float64 (the reference with JAX's x64 on for that
test only): ResNet-18 and ResNet-50 at B=2, 64x64, in training mode
(batch statistics, running statistics written): logits, loss, every
gradient and running statistic within 1e-9 of the largest value
(measured: 5e-12). In float32 the same networks are ill-conditioned: a
batch norm in training moves its output by up to 1/sqrt(eps) = 316 times
a change of its input where a channel's values nearly coincide, and the
reference's variance E[x^2] - E[x]^2 cancels. At 32x32 the last stage's
maps are 1x1 (2 values a channel at B=2): float32 rounding in another
order (2.7e-5 after the stem's batch norm) reaches 0.03 in the logits,
and ResNet-50's ten such norms take even float64 rounding to 7e-8;
ResNet-50's deepest weight gradients at 64x64 differ from float64 by up
to 48 % in the reference's float32 (5 % in the port's). So the float32
training checks run ResNet-18 at B=2 and 64x64 (2x2 maps, 8 values a
channel), ResNet-50 in eval mode.

Tolerances, absolute, scaled by the largest |value| of the reference's
tensor (at least 1):
  * float32 logits, losses, parameters and running statistics: 2e-4
    (measured: 5e-5 over three steps); velocities, the raw gradients
    summed: 2e-3 (measured: 4e-4, the stem conv's weight gradient, a sum
    over 2048 positions through 17 layers). The trajectory runs at lr
    1e-3: at the bench's 0.01 (the loss rising from 2.8 to 4.3 in three
    steps on random labels) the steps amplify float32 rounding past any
    tolerance by the third step, in both packages alike;
  * auto_cast O1 bfloat16: every conv and the classifier's matmul round
    their outputs once to bfloat16 (oneDNN here, XLA there, one ulp apart
    where the float32 sums straddle a rounding step). In eval mode the
    logits agree to 2 bfloat16 ulps of each value (measured: 1). In a
    training step the batch norms amplify those ulps as they amplify
    float32 rounding, so the port's step is held to the reference's own
    bfloat16 noise: |port O1 - ref O1| <= 3 |ref O1 - ref float32| (per
    tensor, largest elements; measured ratios 1.0-1.5) plus 1e-6 of the
    tensor's scale;
  * the guard's skipped step: the port's parameters, velocities and
    buffers bit-equal to their values before it.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.jit.engine import make_eval_step as jmake_eval_step
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu.vision.models import resnet18 as jresnet18
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.jit import make_eval_step, make_train_step
from paddle_tpu_torch.models import (export_reference_state,
                                     load_reference_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.vision import models as vision
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

B, SIZE, CLASSES, LR = 2, 64, 10, 1e-3
TOL, VEL_TOL, F64_TOL = 2e-4, 2e-3, 1e-9
BF16_ULP = 2.0 ** -7          # one ulp of a bfloat16 value in [1, 2)
O1_NOISE = 3.0


def _numpy(state):
    return {k: np.asarray(v.numpy()) for k, v in state.items()}


@pytest.fixture(scope="module")
def reference18():
    """The reference's ResNet-18 (built once: about 12 s) and its state
    dict as numpy arrays, the running statistics set to seeded values so
    that eval mode reads something other than zeros and ones."""
    paddle.seed(0)
    ref = jresnet18(num_classes=CLASSES)
    state = _numpy(ref.state_dict())
    rs = np.random.RandomState(5)
    for k in state:
        if k.endswith("._mean"):
            state[k] = (0.1 * rs.randn(*state[k].shape)).astype(np.float32)
        elif k.endswith("._variance"):
            state[k] = (0.5 + rs.rand(*state[k].shape)).astype(np.float32)
    return ref, state


def _pair(reference18):
    """The reference model at the snapshot, and a port model loaded from
    it."""
    ref, state = reference18
    ref.set_state_dict(state)
    ref.train()
    port = vision.resnet18(num_classes=CLASSES, device="cpu", seed=1)
    load_reference_state(port, state)
    return ref, port


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.rand(B, 3, SIZE, SIZE).astype(np.float32),
             rs.randint(0, CLASSES, (B, 1)).astype(np.int64))
            for _ in range(n)]


def _steps(ref, port, lr=LR):
    jopt = paddle.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                     parameters=ref.parameters())
    topt = optimizer.Momentum(learning_rate=lr, momentum=0.9,
                              parameters=port.parameters(), device="cpu")
    jstep = jmake_train_step(ref, lambda o, y: JF.cross_entropy(o, y), jopt)
    tstep = make_train_step(port, lambda o, y: F.cross_entropy(o, y), topt,
                            device="cpu")
    return (jstep, jopt), (tstep, topt)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def _velocities(opt, model, port):
    if port:
        return {n: opt._get_accumulators(p)["velocity"].detach().numpy()
                for n, p in model.named_parameters()}
    return {n: np.asarray(opt._get_accumulators(p)["velocity"])
            for n, p in model.named_parameters()}


def _state(model, opt, port):
    """Parameters, buffers and velocities by name, as numpy."""
    out = (export_reference_state(model) if port
           else _numpy(model.state_dict()))
    out.update({n + "@velocity": v
                for n, v in _velocities(opt, model, port).items()})
    return out


def test_state_dict_carries_buffers_both_ways(reference18):
    """Every reference name (parameters and the 2 x 20 batch-norm buffers
    of ResNet-18) maps one to one; a missing or unexpected name, or a
    shape that differs, raises."""
    ref, state = reference18
    port = vision.resnet18(num_classes=CLASSES, device="cpu", seed=1)
    assert sorted(port.state_dict()) == sorted(state)
    assert len(state) == 102
    assert sum(k.endswith(("._mean", "._variance")) for k in state) == 40
    load_reference_state(port, state)
    back = export_reference_state(port)
    assert sorted(back) == sorted(state)
    for k in state:
        assert np.array_equal(back[k], state[k]), k
    held = port.layer1[0].bn1._mean
    for bad, err in (({k: v for k, v in state.items()
                       if k != "layer1.0.bn1._mean"}, KeyError),
                     (dict(state, **{"layer1.0.bn1._count": state[
                         "layer1.0.bn1._mean"]}), KeyError),
                     (dict(state, **{"layer1.0.bn1._mean": np.zeros(
                         3, np.float32)}), ValueError)):
        with pytest.raises(err):
            load_reference_state(port, bad)
    assert port.layer1[0].bn1._mean is held


def test_momentum_three_steps_match_the_reference(reference18):
    """Three float32 steps of make_train_step with Momentum (0.9): loss,
    logits, every parameter, velocity and running statistic after each."""
    ref, port = _pair(reference18)
    (jstep, jopt), (tstep, topt) = _steps(ref, port)
    for i, (x, y) in enumerate(_batches(3)):
        jl, jo = jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        tl, to = tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
        _close(tl.item(), float(jl.numpy()), TOL, "loss %d" % i)
        _close(to[0].numpy(), jo[0].numpy(), TOL, "logits %d" % i)
        want, got = _state(ref, jopt, False), _state(port, topt, True)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], VEL_TOL if "@" in k else TOL,
                   "%s after step %d" % (k, i))
    # the running statistics moved, and the step was one program
    assert not np.array_equal(got["bn1._mean"],
                              reference18[1]["bn1._mean"])
    assert tstep.compiles == 1 and tstep.replays == 2


def test_auto_cast_o1_step_matches_the_reference(reference18):
    """One step under auto_cast(level="O1", dtype="bfloat16"), the bench's
    precision recipe: conv and the classifier's matmul in bfloat16, every
    parameter, velocity and running statistic float32 in both packages,
    the port's values within the reference's own bfloat16 noise."""
    x, y = _batches(1)[0]
    ref, port = _pair(reference18)
    (jstep, jopt), _ = _steps(ref, port, lr=0.01)
    jl32, jo32 = jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
    want32 = _state(ref, jopt, False)
    ref, port = _pair(reference18)
    (jstep, jopt), (tstep, topt) = _steps(ref, port, lr=0.01)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jl, jo = jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        tl, to = tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
    want, got = _state(ref, jopt, False), _state(port, topt, True)
    assert tl.dtype == to[0].dtype == torch.float32
    assert jl.numpy().dtype == jo[0].numpy().dtype == np.float32
    assert {v.dtype for v in want.values()} == {np.dtype(np.float32)}
    assert {v.dtype for v in got.values()} == {np.dtype(np.float32)}
    pairs = [("loss", tl.numpy(), jl.numpy(), jl32.numpy()),
             ("logits", to[0].numpy(), jo[0].numpy(), jo32[0].numpy())]
    pairs += [(k, got[k], want[k], want32[k]) for k in want]
    for what, g, w, w32 in pairs:
        noise = np.abs(w.astype(np.float64) - w32).max()
        err = np.abs(g.astype(np.float64) - w).max()
        assert err <= O1_NOISE * noise + 1e-6 * max(1.0, np.abs(w).max()), \
            (what, err, noise)


def test_auto_cast_o1_eval_logits_within_two_bf16_ulps(reference18):
    """Eval mode (the running statistics normalise, nothing amplifies):
    the O1 logits agree to 2 bfloat16 ulps of each value."""
    ref, port = _pair(reference18)
    ref.eval()
    port.eval()
    x = _batches(1, seed=3)[0][0]
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        want = ref(paddle.to_tensor(x)).numpy()
    with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
        got = port(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2 ** -20)))) \
        * BF16_ULP
    assert (np.abs(got - want) <= 2 * ulp).all(), np.abs(got - want).max()


@pytest.fixture
def guard_on():
    saved = flags.get_flags(["skip_nonfinite_steps"])
    flags.set_flags({"skip_nonfinite_steps": True})
    jset_flags({"FLAGS_skip_nonfinite_steps": True})
    for mod in (chaos, jchaos):
        mod.reset()
        mod.configure("nan_at_step:2")
    yield
    flags.set_flags(saved)
    jset_flags({"FLAGS_skip_nonfinite_steps": False})
    for mod in (chaos, jchaos):
        mod.reset()


def test_guard_skipped_step_keeps_parameters_velocity_and_buffers(
        reference18, guard_on):
    """FLAGS_skip_nonfinite_steps with nan_at_step:2: the NaN step is
    skipped in both packages; the port's parameters, velocities and batch
    norm buffers after it are bit-equal to their values after step 1, and
    every step's state matches the reference's."""
    ref, port = _pair(reference18)
    (jstep, jopt), (tstep, topt) = _steps(ref, port)
    before = None
    for i, (x, y) in enumerate(_batches(3, seed=1)):
        jl, _ = jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        tl, _ = tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
        got = _state(port, topt, True)
        assert tstep.last_step_skipped == (i == 1)
        if i == 1:
            assert np.isnan(tl.item()) and np.isnan(float(jl.numpy()))
            for k in before:
                assert np.array_equal(got[k], before[k]), k
        else:
            _close(tl.item(), float(jl.numpy()), TOL, "loss %d" % i)
        want = _state(ref, jopt, False)
        for k in want:
            _close(got[k], want[k], VEL_TOL if "@" in k else TOL,
                   "%s after step %d" % (k, i))
        before = got
    assert tstep.skipped_steps == 1


def test_eval_step_matches_the_reference_and_writes_no_buffer(reference18):
    """make_eval_step in eval() mode: the running statistics normalise;
    logits and loss against the reference's eval step. In train() mode the
    eval step normalises by the batch and, as the reference's, writes no
    running statistic."""
    ref, port = _pair(reference18)
    x, y = _batches(1, seed=2)[0]
    for mode in ("eval", "train"):
        getattr(ref, mode)()
        getattr(port, mode)()
        jev = jmake_eval_step(ref, lambda o, l: JF.cross_entropy(o, l))
        tev = make_eval_step(port, lambda o, l: F.cross_entropy(o, l),
                             device="cpu")
        jl, jo = jev([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        tl, to = tev([torch.from_numpy(x)], [torch.from_numpy(y)])
        _close(to[0].numpy(), jo[0].numpy(), TOL, "logits " + mode)
        _close(tl.item(), float(jl.numpy()), TOL, "loss " + mode)
        state = export_reference_state(port)
        for k, v in reference18[1].items():
            assert np.array_equal(state[k], v), (mode, k)


def test_eager_train_mode_writes_running_statistics_at_once(reference18):
    """Outside a step (eager), a training forward writes the running
    statistics in place, as the reference's eager batch norm does."""
    ref, port = _pair(reference18)
    x = _batches(1, seed=4)[0][0]
    held = port.bn1._mean
    ref(paddle.to_tensor(x))
    port(torch.from_numpy(x))
    assert port.bn1._mean is held
    want = _numpy(ref.state_dict())
    got = export_reference_state(port)
    for k in want:
        _close(got[k], want[k], TOL, k)


def test_rebinding_a_buffer_makes_the_step_raise():
    """The step holds the buffers' addresses: a buffer rebound (not copied
    into) makes the next call raise, as a rebound parameter does."""
    port = vision.resnet18(num_classes=CLASSES, device="cpu")
    topt = optimizer.Momentum(learning_rate=LR, parameters=port.parameters(),
                              device="cpu")
    tstep = make_train_step(port, lambda o, y: F.cross_entropy(o, y), topt,
                            device="cpu")
    x, y = _batches(1)[0]
    tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
    port.bn1._mean = port.bn1._mean.clone()
    with pytest.raises(RuntimeError, match="moved"):
        tstep([torch.from_numpy(x)], [torch.from_numpy(y)])


@pytest.mark.parametrize("name,params", [
    ("resnet18", 11689512), ("resnet34", 21797672), ("resnet50", 25557032),
    ("resnet101", 44549160), ("resnet152", 60192808),
    ("wide_resnet50_2", 68883240), ("wide_resnet101_2", 126886696)])
def test_resnet_family_parameter_counts(name, params):
    """Each factory's architecture at 1000 classes: its parameter count
    (conv weights, batch-norm weights and biases, the classifier) is the
    published one for the same network."""
    model = getattr(vision, name)(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == params
    with pytest.raises(ValueError, match="pretrained"):
        getattr(vision, name)(pretrained=True, device="cpu")


def test_o2_reference_turns_bfloat16_state_float32_port_keeps_it(
        reference18):
    """Red reference behaviour (ROADMAP.md section 3): after one O2 step
    (decorate O2 bfloat16, auto_cast O2) the reference's conv weights and
    batch-norm buffers are float32: Momentum's rule ends without a cast
    back (paddle_tpu/optimizer/__init__.py:353) and the running update
    m * bf16 + (1 - m) * float32 batch statistic is float32
    (paddle_tpu/nn/functional/__init__.py:456-457). The port keeps every
    parameter and buffer bfloat16 (a captured step holds their addresses;
    decorate O2 promises the amp dtype)."""
    ref, port = _pair(reference18)
    try:
        jopt = paddle.optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                         parameters=ref.parameters())
        ref, jopt = paddle.amp.decorate(ref, jopt, level="O2",
                                        dtype="bfloat16")
        topt = optimizer.Momentum(learning_rate=LR, momentum=0.9,
                                  parameters=port.parameters(),
                                  device="cpu")
        port, topt = amp.decorate(port, topt, level="O2", dtype="bfloat16")
        jstep = jmake_train_step(ref, lambda o, y: JF.cross_entropy(o, y),
                                 jopt)
        tstep = make_train_step(port, lambda o, y: F.cross_entropy(o, y),
                                topt, device="cpu")
        x, y = _batches(1)[0]
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            tl, _ = tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
        jdt = {k: str(v.dtype) for k, v in ref.state_dict().items()}
        assert jdt["conv1.weight"].endswith("float32")
        assert jdt["bn1._mean"].endswith("float32")
        assert jdt["layer1.0.bn1._variance"].endswith("float32")
        assert {t.dtype for t in port.state_dict().values()} == \
            {torch.bfloat16}
        assert np.isfinite(tl.item())
    finally:
        ref.to(dtype="float32")
