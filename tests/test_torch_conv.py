"""The port's convolution, batch norm, pooling, ReLU and flatten against the
JAX package's, on the CPU.

The same seeded numpy inputs go through the reference's functions
(paddle_tpu.nn.functional over ops/nn_ops.py, its eager tape for the
gradients) and the port's. Forward and backward: each test pulls the
output against a fixed numpy cotangent and compares the gradients of every
input.

Tolerances (absolute, scaled by the largest |value| of the reference's
tensor, at least 1):
  * float32 convolutions, pools and their gradients: 1e-5 (float32 sums
    over up to 144 taps in another order; im2col's patches against XLA's
    convolution, the same products summed otherwise);
  * batch norm: 2e-5 on y and the gradients, 1e-6 on the running
    statistics (the reference's E[x^2] - E[x]^2 in float32, whose
    cancellation scales the sums' rounding by mean^2 / var);
  * bfloat16 convolutions under auto_cast: both sides round the float32
    sum once to bfloat16 (oneDNN here, XLA there), so an element may
    differ by one bfloat16 ulp of its value where the two float32 sums
    straddle a rounding step: |port - ref| <= 2^-8 |ref| elementwise (one
    ulp is 2^-8 to 2^-7 of the value; the bound is the lower one, plus
    1e-6 for values near 0), and no element differs by more.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.flags import get_flags as jget_flags
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.tensor import flatten as jflatten
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.tensor import flatten
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

TOL = 1e-5
BN_TOL, BN_STAT_TOL = 2e-5, 1e-6
BF16_REL = 2.0 ** -8


@pytest.fixture(autouse=True)
def conv_algo_restored():
    saved = flags.get_flags(["conv_algo"])
    jsaved = jget_flags(["FLAGS_conv_algo"])
    yield
    flags.set_flags(saved)
    jset_flags(jsaved)


def _set_algo(algo):
    flags.set_flags({"conv_algo": algo})
    jset_flags({"FLAGS_conv_algo": algo})


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    # equal elements (an infinity too: a ceil_mode window that lies in the
    # padding alone is -inf in both) count 0
    with np.errstate(invalid="ignore"):
        diff = np.where(got == want, 0.0, np.abs(got - want))
    finite = np.abs(want[np.isfinite(want)])
    err = diff.max() if want.size else 0.0
    scale = max(1.0, finite.max()) if finite.size else 1.0
    assert err <= tol * scale, (what, err)


def _both(fn_ref, fn_port, arrays, seed=1):
    """Forward and backward of both: outputs, and the gradients of every
    input against one numpy cotangent. `arrays` are numpy inputs, every
    one differentiable."""
    jin = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    jout = fn_ref(*jin)
    tin = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = fn_port(*tin)
    cot = np.random.RandomState(seed).randn(*tout.shape).astype(np.float32)
    (jout * paddle.to_tensor(cot)).sum().backward()
    (tout * torch.from_numpy(cot)).sum().backward()
    return ((jout.numpy(), [t.grad.numpy() for t in jin]),
            (tout.detach().numpy(), [t.grad.numpy() for t in tin]))


def _check(fn_ref, fn_port, arrays, tol=TOL):
    (jo, jg), (to, tg) = _both(fn_ref, fn_port, arrays)
    _close(to, jo, tol, "output")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, tol, "grad %d" % i)


# -- convolution ------------------------------------------------------------

# (x shape, w shape, stride, padding, dilation, groups)
CONV2D_CASES = [
    ((2, 4, 9, 9), (6, 4, 3, 3), 1, 1, 1, 1),
    ((2, 4, 9, 9), (6, 4, 3, 3), 2, [1, 2], 1, 1),
    ((2, 4, 9, 8), (6, 4, 3, 2), [2, 1], [1, 0, 2, 1], 1, 1),
    ((2, 4, 9, 9), (6, 4, 3, 3), 1, [[0, 1], [2, 0]], 1, 1),
    ((2, 4, 10, 9), (6, 4, 3, 3), 2, "SAME", 1, 1),
    ((2, 4, 9, 9), (6, 4, 3, 3), 1, "VALID", 2, 1),
    ((2, 4, 11, 11), (6, 4, 3, 3), 2, "SAME", 2, 1),
    ((2, 4, 9, 9), (6, 2, 3, 3), 1, 1, 1, 2),
    ((2, 4, 9, 9), (4, 1, 3, 3), 2, 1, 1, 4),
    ((2, 3, 16, 16), (8, 3, 7, 7), 2, 3, 1, 1),
]


def _conv_inputs(xs, ws, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*xs).astype(np.float32),
            (0.3 * rs.randn(*ws)).astype(np.float32)]


@pytest.mark.parametrize("algo", ["auto", "direct", "im2col", "nhwc"])
@pytest.mark.parametrize("case", range(len(CONV2D_CASES)))
def test_conv2d_matches_the_reference(case, algo):
    xs, ws, stride, padding, dilation, groups = CONV2D_CASES[case]
    _set_algo(algo)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    _check(lambda x, w: JF.conv2d(x, w, **kw),
           lambda x, w: F.conv2d(x, w, **kw), _conv_inputs(xs, ws))


@pytest.mark.parametrize("algo", ["direct", "im2col"])
@pytest.mark.parametrize("n,xs,ws,fmt", [
    (1, (2, 4, 11), (5, 4, 3), "NCL"),
    (3, (2, 3, 6, 7, 5), (4, 3, 3, 2, 3), "NCDHW"),
])
def test_conv1d_and_conv3d_match_the_reference(n, xs, ws, fmt, algo):
    _set_algo(algo)
    kw = dict(stride=2, padding=1, dilation=1, data_format=fmt)
    jfn = {1: JF.conv1d, 3: JF.conv3d}[n]
    tfn = {1: F.conv1d, 3: F.conv3d}[n]
    _check(lambda x, w: jfn(x, w, **kw), lambda x, w: tfn(x, w, **kw),
           _conv_inputs(xs, ws))


@pytest.mark.parametrize("algo", ["direct", "im2col"])
def test_conv2d_channel_last_and_bias_match_the_reference(algo):
    """NHWC input with the reference's channel-last weight (HWIO), and a
    bias added in the channel axis."""
    _set_algo(algo)
    rs = np.random.RandomState(3)
    arrays = [rs.randn(2, 9, 8, 4).astype(np.float32),
              (0.3 * rs.randn(3, 3, 4, 5)).astype(np.float32),
              rs.randn(5).astype(np.float32)]
    kw = dict(stride=2, padding="SAME", data_format="NHWC")
    _check(lambda x, w, b: JF.conv2d(x, w, b, **kw),
           lambda x, w, b: F.conv2d(x, w, b, **kw), arrays)


def test_conv2d_bias_nchw_matches_the_reference():
    rs = np.random.RandomState(4)
    arrays = [rs.randn(2, 4, 7, 7).astype(np.float32),
              (0.3 * rs.randn(6, 4, 3, 3)).astype(np.float32),
              rs.randn(6).astype(np.float32)]
    _check(lambda x, w, b: JF.conv2d(x, w, b, padding=1),
           lambda x, w, b: F.conv2d(x, w, b, padding=1), arrays)


def test_nhwc_takes_only_4d_nchw_and_unknown_algo_raises():
    x = torch.zeros(2, 4, 9)
    w = torch.zeros(3, 4, 3)
    _set_algo("nhwc")
    with pytest.raises(ValueError, match="nhwc"):
        F.conv1d(x, w)
    with pytest.raises(ValueError, match="nhwc"):
        F.conv2d(torch.zeros(1, 5, 5, 4), torch.zeros(3, 3, 4, 2),
                 data_format="NHWC")
    _set_algo("winograd")
    with pytest.raises(ValueError, match="conv_algo"):
        F.conv2d(torch.zeros(1, 4, 5, 5), torch.zeros(2, 4, 3, 3))


def test_conv_path_counts_follow_the_reference():
    """One count a call by lowering; auto counts direct off a TPU, and a
    grouped call under im2col runs direct but counts im2col, as the
    reference's _note_conv_path does."""
    x = torch.randn(1, 4, 6, 6)
    w = torch.randn(4, 2, 3, 3)
    F.conv_path_counts(reset=True)
    counter = metrics.REGISTRY.get("pt_conv_path_total")
    before = counter.labels("im2col").value
    for algo in ("auto", "direct", "nhwc", "im2col"):
        _set_algo(algo)
        F.conv2d(x, torch.randn(3, 4, 3, 3))
    _set_algo("im2col")
    grouped = F.conv2d(x, w, groups=2)
    _set_algo("direct")
    direct = F.conv2d(x, w, groups=2)
    assert F.conv_path_counts() == {"direct": 3, "im2col": 2, "nhwc": 1}
    assert counter.labels("im2col").value == before + 2
    assert torch.equal(grouped, direct)


def test_bfloat16_conv_returns_float32_within_one_ulp():
    """Under auto_cast O1 (bfloat16) conv2d_op takes bfloat16 input and
    weight and returns float32 in both packages; float16 and float32
    inputs keep their dtype."""
    x, w = _conv_inputs((2, 8, 12, 12), (16, 8, 3, 3), seed=5)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jout = JF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                         padding=1).numpy()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        tout = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert tout.dtype == torch.float32 and jout.dtype == np.float32
    diff = np.abs(tout.numpy() - jout)
    assert (diff <= BF16_REL * np.abs(jout) + 1e-6).all(), diff.max()
    # the port's output is bfloat16-valued (rounded once, then widened)
    assert torch.equal(tout, tout.to(torch.bfloat16).float())
    tb = F.conv2d(torch.from_numpy(x).bfloat16(),
                  torch.from_numpy(w).bfloat16(), padding=1)
    assert tb.dtype == torch.float32
    th = F.conv2d(torch.from_numpy(x).half(), torch.from_numpy(w).half(),
                  padding=1)
    assert th.dtype == torch.float16
    _set_algo("im2col")
    ti = F.conv2d(torch.from_numpy(x).bfloat16(),
                  torch.from_numpy(w).bfloat16(), padding=1)
    assert ti.dtype == torch.float32
    assert F.conv2d(torch.from_numpy(x).half(), torch.from_numpy(w).half(),
                    padding=1).dtype == torch.float16


# -- batch norm -------------------------------------------------------------


def _bn_pair(c, fmt, training, momentum=0.9, global_stats=None):
    rm = np.zeros(c, np.float32)
    rv = np.ones(c, np.float32)
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    kw = dict(training=training, momentum=momentum, data_format=fmt,
              use_global_stats=global_stats)
    return ((jrm, jrv), (trm, trv),
            lambda x, w, b: JF.batch_norm(x, jrm, jrv, w, b, **kw),
            lambda x, w, b: F.batch_norm(x, trm, trv, w, b, **kw))


def _bn_inputs(shape, c, seed):
    rs = np.random.RandomState(seed)
    return [(2.0 * rs.randn(*shape) + 1.5).astype(np.float32),
            (1.0 + 0.1 * rs.randn(c)).astype(np.float32),
            (0.1 * rs.randn(c)).astype(np.float32)]


@pytest.mark.parametrize("fmt,shape", [("NCHW", (4, 6, 5, 5)),
                                       ("NHWC", (4, 5, 5, 6)),
                                       ("NCL", (8, 6, 7))])
def test_batch_norm_training_two_steps_match_the_reference(fmt, shape):
    """Two training calls: y and the gradients each time, and the running
    statistics m * run + (1 - m) * batch with the biased variance after
    each."""
    (jrm, jrv), (trm, trv), jfn, tfn = _bn_pair(6, fmt, True)
    for step in range(2):
        arrays = _bn_inputs(shape, 6, seed=10 + step)
        _check(jfn, tfn, arrays, BN_TOL)
        _close(trm.numpy(), jrm.numpy(), BN_STAT_TOL, "mean %d" % step)
        _close(trv.numpy(), jrv.numpy(), BN_STAT_TOL, "var %d" % step)


def test_batch_norm_running_statistics_are_not_torchs():
    """torch.nn.functional.batch_norm's running update, (1 - m) * run +
    m * unbiased batch variance, lands far outside the tolerance of the
    parity test above after two steps: that test tells the two apart."""
    (jrm, jrv), _, jfn, _ = _bn_pair(6, "NCHW", True)
    trm, trv = torch.zeros(6), torch.ones(6)
    for step in range(2):
        x, w, b = _bn_inputs((4, 6, 5, 5), 6, seed=10 + step)
        jfn(paddle.to_tensor(x), paddle.to_tensor(w), paddle.to_tensor(b))
        torch.nn.functional.batch_norm(
            torch.from_numpy(x), trm, trv, torch.from_numpy(w),
            torch.from_numpy(b), training=True, momentum=0.9)
    assert np.abs(trv.numpy() - jrv.numpy()).max() > 100 * BN_STAT_TOL
    assert np.abs(trm.numpy() - jrm.numpy()).max() > 100 * BN_STAT_TOL


@pytest.mark.parametrize("training,global_stats", [(False, None),
                                                   (True, True)])
def test_batch_norm_inference_matches_the_reference(training, global_stats):
    """The running statistics normalise and are not written: eval mode,
    and use_global_stats in training."""
    (jrm, jrv), (trm, trv), jfn, tfn = _bn_pair(6, "NCHW", training,
                                                global_stats=global_stats)
    rs = np.random.RandomState(7)
    stats = [rs.randn(6).astype(np.float32),
             (0.5 + rs.rand(6)).astype(np.float32)]
    jrm.set_value(stats[0])
    jrv.set_value(stats[1])
    trm.copy_(torch.from_numpy(stats[0]))
    trv.copy_(torch.from_numpy(stats[1]))
    _check(jfn, tfn, _bn_inputs((4, 6, 5, 5), 6, seed=8), BN_TOL)
    assert np.array_equal(trm.numpy(), stats[0])
    assert np.array_equal(trv.numpy(), stats[1])
    _close(trv.numpy(), jrv.numpy(), 0.0)


def test_deferred_updates_collect_instead_of_writing():
    """Inside deferred_buffer_updates the running statistics stay as they
    were and the block hands out their new values (a second call sees the
    pending value); outside, the same call writes them at once."""
    x, w, b = [torch.from_numpy(a) for a in _bn_inputs((4, 6, 5, 5), 6, 9)]
    rm, rv = torch.zeros(6), torch.ones(6)
    with F.deferred_buffer_updates() as updates:
        F.batch_norm(x, rm, rv, w, b, training=True)
        F.batch_norm(x, rm, rv, w, b, training=True)
    assert torch.equal(rm, torch.zeros(6)) and torch.equal(rv, torch.ones(6))
    assert [buf for buf, _ in updates.values()] == [rm, rv]
    erm, erv = torch.zeros(6), torch.ones(6)
    F.batch_norm(x, erm, erv, w, b, training=True)
    F.batch_norm(x, erm, erv, w, b, training=True)
    assert torch.equal(updates[id(rm)][1], erm)
    assert torch.equal(updates[id(rv)][1], erv)


# -- pooling, ReLU, flatten -------------------------------------------------

POOL_CASES = [
    # kernel, stride, padding, ceil_mode
    (3, 2, 1, False),
    (2, 2, 0, False),
    (3, 2, 0, True),
    (3, 2, [1, 0], True),
    (3, 2, "SAME", False),
    (2, 3, "VALID", True),
    ([3, 2], [2, 1], [[1, 0], [0, 1]], False),
]


@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_max_pool2d_matches_the_reference(case):
    k, s, p, ceil = POOL_CASES[case]
    x = np.random.RandomState(case).randn(2, 3, 9, 10).astype(np.float32)
    _check(lambda t: JF.max_pool2d(t, k, s, p, ceil_mode=ceil),
           lambda t: F.max_pool2d(t, k, s, p, ceil_mode=ceil), [x])


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_avg_pool2d_matches_the_reference(case, exclusive):
    k, s, p, ceil = POOL_CASES[case]
    x = np.random.RandomState(case).randn(2, 3, 9, 10).astype(np.float32)
    _check(lambda t: JF.avg_pool2d(t, k, s, p, ceil_mode=ceil,
                                   exclusive=exclusive),
           lambda t: F.avg_pool2d(t, k, s, p, ceil_mode=ceil,
                                  exclusive=exclusive), [x])


def test_pools_channel_last_match_the_reference():
    x = np.random.RandomState(2).randn(2, 9, 10, 3).astype(np.float32)
    _check(lambda t: JF.max_pool2d(t, 3, 2, 1, data_format="NHWC"),
           lambda t: F.max_pool2d(t, 3, 2, 1, data_format="NHWC"), [x])
    _check(lambda t: JF.avg_pool2d(t, 3, 2, 1, ceil_mode=True,
                                   data_format="NHWC"),
           lambda t: F.avg_pool2d(t, 3, 2, 1, ceil_mode=True,
                                  data_format="NHWC"), [x])


def test_max_pool_ties_route_the_gradient_as_the_reference():
    """ResNet's stem: relu output (ties of exact zeros, and ties of equal
    positive values) into max_pool2d(3, 2, 1). Each window's gradient goes
    to one maximum, the same element in both packages, exactly."""
    rs = np.random.RandomState(11)
    x = rs.choice([-1.0, 0.0, 0.5, 2.0], size=(2, 3, 12, 12),
                  p=[0.4, 0.3, 0.2, 0.1]).astype(np.float32)
    (jo, jg), (to, tg) = _both(lambda t: JF.max_pool2d(JF.relu(t), 3, 2, 1),
                               lambda t: F.max_pool2d(F.relu(t), 3, 2, 1),
                               [x])
    assert np.array_equal(to, jo)
    assert np.array_equal(tg[0], jg[0])
    # ties with the zeros relu made: each window sends its gradient to one
    # element, so no element of an all-zero window's input gets a share
    (jo, jg), (to, tg) = _both(lambda t: JF.max_pool2d(t, 3, 2, 1),
                               lambda t: F.max_pool2d(t, 3, 2, 1),
                               [np.maximum(x, 0)])
    assert np.array_equal(tg[0], jg[0])


@pytest.mark.parametrize("size,out", [((7, 7), (1, 1)), ((7, 7), (3, 3)),
                                      ((6, 9), (None, 2)), ((8, 6), 4)])
def test_adaptive_avg_pool2d_matches_the_reference(size, out):
    x = np.random.RandomState(3).randn(2, 5, *size).astype(np.float32)
    _check(lambda t: JF.adaptive_avg_pool2d(t, out),
           lambda t: F.adaptive_avg_pool2d(t, out), [x])


def test_relu_gradient_at_zero_is_the_references_half():
    """The reference's relu is max(x, 0): its gradient at exactly 0 is
    1/2 (torch.relu gives 0); the port's matches it."""
    x = np.array([-2.0, -0.0, 0.0, 1e-30, 3.0], np.float32)
    (jo, jg), (to, tg) = _both(JF.relu, F.relu, [x])
    assert np.array_equal(to, jo)
    assert np.array_equal(tg[0], jg[0])
    cot = np.random.RandomState(1).randn(5).astype(np.float32)
    assert tg[0][1] == 0.5 * cot[1] and tg[0][2] == 0.5 * cot[2]


@pytest.mark.parametrize("shape,start,stop", [
    ((2, 3, 4, 5), 1, -1), ((2, 3, 4, 5), 0, -1), ((2, 3, 4, 5), 1, 2),
    ((2, 3, 4, 5), -2, -1), ((6,), 0, -1), ((), 0, -1)])
def test_flatten_matches_the_reference(shape, start, stop):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    want = jflatten(paddle.to_tensor(x), start, stop).numpy()
    got = flatten(torch.from_numpy(x), start, stop).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    layer = tnn.Flatten()
    if len(shape) >= 2:
        assert layer(torch.from_numpy(x)).shape == (shape[0], int(
            np.prod(shape[1:])))


def test_cross_entropy_takes_resnet_labels_b_by_1():
    """ResNet's criterion: logits [64, 100], int64 labels [64, 1]
    (softmax_with_cross_entropy squeezes the trailing axis): the loss and
    the logits' gradient against the reference's, and the same loss from
    the labels one-hot as soft labels."""
    rs = np.random.RandomState(12)
    logits = rs.randn(64, 100).astype(np.float32)
    label = rs.randint(0, 100, (64, 1)).astype(np.int64)
    jin = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(jin, paddle.to_tensor(label))
    jl.backward()
    tin = torch.tensor(logits, requires_grad=True)
    tl = tnn.CrossEntropyLoss()(tin, torch.from_numpy(label))
    tl.backward()
    assert tl.shape == () and jl.shape in ([], ())
    _close(tl.item(), float(jl.numpy()), TOL)
    _close(tin.grad.numpy(), jin.grad.numpy(), TOL)
    # soft labels (the same labels one-hot) give the same loss
    soft = np.eye(100, dtype=np.float32)[label[:, 0]]
    ts = tnn.CrossEntropyLoss(soft_label=True)(
        torch.from_numpy(logits), torch.from_numpy(soft))
    _close(ts.item(), float(jl.numpy()), TOL)


# -- layers -----------------------------------------------------------------


def test_layers_names_layouts_and_init():
    """The reference's names and layouts: OIHW conv weights from
    Uniform(-k, k), k = 1 / sqrt(fan_in), no bias with bias_attr=False;
    batch norm weight ones, bias zeros, buffers _mean zeros and _variance
    ones; Sequential names its layers 0, 1, ... or by the pairs given."""
    gen = torch.Generator().manual_seed(0)
    conv = tnn.Conv2D(8, 16, 3, groups=2, generator=gen)
    assert conv.weight.shape == (16, 4, 3, 3) and conv.bias.shape == (16,)
    k = 1.0 / np.sqrt(4 * 9)
    assert conv.weight.abs().max() <= k and conv.weight.abs().max() > k / 2
    assert tnn.Conv2D(8, 16, 1, bias_attr=False).bias is None
    bn = tnn.BatchNorm2D(5)
    names = dict(bn.named_parameters()), dict(bn.named_buffers())
    assert sorted(names[0]) == ["bias", "weight"]
    assert sorted(names[1]) == ["_mean", "_variance"]
    assert torch.equal(bn._mean, torch.zeros(5))
    assert torch.equal(bn._variance, torch.ones(5))
    seq = tnn.Sequential(tnn.Conv2D(3, 4, 1), tnn.BatchNorm2D(4))
    assert sorted(seq.state_dict()) == ["0.bias", "0.weight", "1._mean",
                                        "1._variance", "1.bias", "1.weight"]
    pairs = tnn.Sequential(("conv", tnn.Conv2D(3, 4, 1)), ("act", tnn.ReLU()))
    assert [n for n, _ in pairs.named_children()] == ["conv", "act"]
    legacy = tnn.BatchNorm(4, act="relu")
    legacy.eval()
    x = torch.randn(2, 4, 3, 3)
    assert torch.equal(legacy(x), torch.relu(x / np.sqrt(1 + 1e-5)))
    x = torch.randn(2, 3, 8, 8)
    assert tnn.MaxPool2D(3, 2, 1)(x).shape == (2, 3, 4, 4)
    assert tnn.AvgPool2D(2)(x).shape == (2, 3, 4, 4)
    assert tnn.AdaptiveAvgPool2D((1, 1))(x).shape == (2, 3, 1, 1)
    assert tnn.Conv1D(3, 4, 3)(torch.randn(2, 3, 9)).shape == (2, 4, 7)
    assert tnn.Conv3D(3, 4, 3)(torch.randn(1, 3, 5, 5, 5)).shape == \
        (1, 4, 3, 3, 3)
