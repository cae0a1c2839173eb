"""The port's activations, losses, sequence helpers and containers against
the JAX package, on the CPU.

Each activation and loss gets the same numpy inputs in both packages, with
points at its thresholds and ties (where the reference's jnp.clip,
jnp.maximum and jnp.abs give a gradient of 1/2 or 1 that torch.clamp and
torch.abs do not), and is held forward and in its input's gradient under
one cotangent. The losses run every reduction and option; under
auto_cast O1 the black-listed ones give a bfloat16 input float32 as the
reference does. Containers: parameter names of every form and of slices,
carried across with `load_reference_state`.

Tolerances: float32 values and gradients within 1e-5 of the largest
|value| of each array (one or two float32 ops in another order).
"""
import collections

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.amp import auto_cast as jauto_cast
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as F
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

TOL = 1e-5


def _rel(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), np.finfo(np.float32).tiny)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, (what, err, scale)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy(), np.float32)


def _rand(*shape, seed=0, scale=2.0):
    return np.asarray(scale * np.random.RandomState(seed).randn(*shape),
                      np.float32)


def _with_points(points, n=44, seed=0):
    """[2, n] float32: the points (thresholds, ties), then random values
    (one shape for every activation, so that the reference compiles its
    cotangent's product and sum once)."""
    row = np.concatenate([np.asarray(points, np.float32),
                          _rand(n - len(points), seed=seed, scale=4.0)])
    return np.stack([row, row[::-1]])


def _fwd_bwd(jfn, tfn, arrays, grad_of=(0,), what=""):
    """Both functions on the same arrays: the output, then the gradients of
    the arrays at `grad_of` under one random cotangent."""
    jin = [paddle.to_tensor(a, stop_gradient=i not in grad_of)
           for i, a in enumerate(arrays)]
    tin = [torch.tensor(a, requires_grad=i in grad_of)
           for i, a in enumerate(arrays)]
    jo, to = jfn(*jin), tfn(*tin)
    _rel(_np(to), _np(jo), what=what + " forward")
    ct = _rand(*_np(jo).shape, seed=7, scale=1.0)
    (jo * paddle.to_tensor(ct)).sum().backward()
    (to * torch.from_numpy(ct)).sum().backward()
    for i in grad_of:
        _rel(_np(tin[i].grad), _np(jin[i].grad), what="%s d%d" % (what, i))


# name: (kwargs, threshold points)
ACTS = {
    "relu6": ({}, [0.0, 6.0]),
    "leaky_relu": ({"negative_slope": 0.1}, [0.0]),
    "elu": ({"alpha": 0.7}, [0.0]),
    "selu": ({}, [0.0]),
    "celu": ({"alpha": 1.3}, [0.0]),
    "sigmoid": ({}, [0.0]),
    "silu": ({}, [0.0]),
    "swish": ({}, [0.0]),
    "hardtanh": ({"min": -0.5, "max": 1.5}, [-0.5, 1.5]),
    "hardshrink": ({"threshold": 0.5}, [-0.5, 0.5]),
    "softshrink": ({"threshold": 0.5}, [-0.5, 0.5]),
    "tanhshrink": ({}, [0.0]),
    # slope 1/6 is not a float32 number, so the default's edges at -3 and 3
    # are not exact: they are taken at 1/4, where they are
    "hardsigmoid": ({"slope": 0.25, "offset": 0.5}, [-2.0, 2.0]),
    "hardsigmoid_default": ({}, []),
    "hardswish": ({}, [-3.0, 3.0]),
    "mish": ({}, [0.0, 25.0]),
    "softplus": ({"beta": 2.0, "threshold": 10.0}, [5.0, 25.0, -30.0]),
    "softsign": ({}, [0.0]),
    "thresholded_relu": ({"threshold": 1.0}, [1.0]),
    "log_sigmoid": ({}, [0.0, -30.0]),
}


@pytest.mark.parametrize("name", sorted(ACTS))
def test_activation_and_its_gradient_match_the_reference(name):
    kw, points = ACTS[name]
    fn = name.replace("_default", "")
    _fwd_bwd(lambda x: getattr(JF, fn)(x, **kw),
             lambda x: getattr(F, fn)(x, **kw), [_with_points(points)],
             what=name)


@pytest.mark.parametrize("fmt,n", [("NCHW", 3), ("NHWC", 3), ("NCHW", 1)])
def test_prelu_matches_the_reference(fmt, n):
    """One slope or one per channel (axis 1 for NCHW, the last for NHWC),
    the gradients of x (with zeros) and of the slopes."""
    x = _rand(2, 3, 4, 3)
    x[0, 0, 0] = 0.0
    w = np.array([0.25, -0.5, 2.0][:n], np.float32)
    _fwd_bwd(lambda a, b: JF.prelu(a, b, data_format=fmt),
             lambda a, b: F.prelu(a, b, data_format=fmt), [x, w],
             grad_of=(0, 1), what="prelu")


@pytest.mark.parametrize("groups,axis", [(2, 1), (3, 2)])
def test_maxout_with_ties_matches_the_reference(groups, axis):
    """The max over groups of channels; tied maxima share the gradient as
    the reference's max reduction shares it. (A negative axis counts from
    the end in the port; the reference's reshape misplaces it: ROADMAP
    queue 3.)"""
    x = np.round(_rand(2, 6, 6), 0)           # integers: many ties
    _fwd_bwd(lambda a: JF.maxout(a, groups, axis),
             lambda a: F.maxout(a, groups, axis), [x], what="maxout")


@pytest.mark.parametrize("axis", [-1, 1])
def test_glu_matches_the_reference(axis):
    _fwd_bwd(lambda a: JF.glu(a, axis), lambda a: F.glu(a, axis),
             [_rand(2, 4, 6)], what="glu")


# the layers whose constructors take arguments (SELU's, which the
# reference drops), and two that take none
LAYERS = [("ReLU6", ()), ("LeakyReLU", (0.2,)), ("ELU", (0.5,)),
          ("SELU", (2.0, 2.0)), ("CELU", (2.0,)), ("GELU", (True,)),
          ("Hardtanh", (-2.0, 2.0)), ("Hardshrink", (0.3,)),
          ("Softshrink", (0.3,)), ("Softplus", (1.5, 5.0)),
          ("Softmax", (0,)), ("LogSoftmax", (1,)), ("Maxout", (2,)),
          ("ThresholdedReLU", (0.5,)), ("GLU", (1,)), ("Mish", ())]


def test_activation_layers_match_the_reference():
    """Each activation layer, its constructor's arguments passed on as the
    reference's `_act_layer` passes them, forward on one input; every
    layer class of the reference's list exists in the port."""
    for name in ("Sigmoid", "Silu", "Swish", "Tanhshrink", "Hardsigmoid",
                 "Hardswish", "Softsign", "LogSigmoid", "PReLU"):
        assert isinstance(getattr(nn, name)(), torch.nn.Module), name
    x = _rand(2, 4, 3)
    for name, args in LAYERS:
        want = getattr(jnn, name)(*args)(paddle.to_tensor(x))
        got = getattr(nn, name)(*args)(torch.from_numpy(x))
        _rel(_np(got), _np(want), what=name)


def test_prelu_layer_parameter_matches_the_reference():
    ref, port = jnn.PReLU(3, init=0.1), nn.PReLU(3, init=0.1)
    assert [n for n, _ in port.named_parameters()] == ["weight"]
    np.testing.assert_array_equal(_np(port.weight), _np(ref.weight))
    x = _rand(2, 3, 4)
    _rel(_np(port(torch.from_numpy(x))), _np(ref(paddle.to_tensor(x))))


# ---------------------------------------------------------------------------
# losses

N, C = 6, 5
REDUCTIONS = ("none", "mean", "sum")


def _probs(seed=0):
    p = np.random.RandomState(seed).rand(N, C).astype(np.float32)
    p[0, :2] = [0.0, 1e-13]                   # under the clip's edge
    return p


def _labels01(seed=1):
    return (np.random.RandomState(seed).rand(N, C) > 0.5).astype(np.float32)


def _loss_case(name):
    """(reference fn, port fn, arrays, indices to differentiate) of one
    loss, with its options, the reduction as the last argument."""
    x, y = _rand(N, C), _rand(N, C, seed=1)
    y[0, :3] = x[0, :3]                       # |x - y| = 0: abs's tie
    y[1, 0] = x[1, 0] + 0.5                   # r == delta
    logp = np.log(np.random.RandomState(2).dirichlet(np.ones(C), N)).astype(
        np.float32)
    lab = np.array([0, 4, -100, 2, 1, 3], np.int64)
    if name == "mse_loss":
        return JF.mse_loss, F.mse_loss, [x, y], (0, 1)
    if name == "l1_loss":
        return JF.l1_loss, F.l1_loss, [x, y], (0, 1)
    if name == "smooth_l1_loss":
        return (lambda a, b, reduction: JF.smooth_l1_loss(
                    a, b, reduction, delta=0.5),
                lambda a, b, reduction: F.smooth_l1_loss(
                    a, b, reduction, delta=0.5),
                [x, y], (0, 1))
    if name == "nll_loss":
        return JF.nll_loss, F.nll_loss, [logp, lab], (0,)
    if name == "nll_loss_ignore_1":
        return (lambda a, b, reduction: JF.nll_loss(
                    a, b, ignore_index=1, reduction=reduction),
                lambda a, b, reduction: F.nll_loss(
                    a, b, ignore_index=1, reduction=reduction),
                [logp, np.where(lab < 0, 1, lab)], (0,))
    if name == "binary_cross_entropy":
        return (JF.binary_cross_entropy, F.binary_cross_entropy,
                [_probs(), _labels01()], (0,))
    if name == "binary_cross_entropy_weight":
        w = np.linspace(0.5, 2.0, C).astype(np.float32)
        return (lambda a, b, reduction: JF.binary_cross_entropy(
                    a, b, paddle.to_tensor(w), reduction),
                lambda a, b, reduction: F.binary_cross_entropy(
                    a, b, torch.from_numpy(w), reduction),
                [_probs(), _labels01()], (0,))
    if name == "bce_with_logits":
        return (lambda a, b, reduction: JF.binary_cross_entropy_with_logits(
                    a, b, reduction=reduction),
                lambda a, b, reduction: F.binary_cross_entropy_with_logits(
                    a, b, reduction=reduction), [x, _labels01()], (0,))
    if name == "bce_with_logits_weights":
        w = np.linspace(0.5, 2.0, C).astype(np.float32)
        pw = np.linspace(3.0, 0.5, C).astype(np.float32)
        return (lambda a, b, reduction: JF.binary_cross_entropy_with_logits(
                    a, b, paddle.to_tensor(w), reduction,
                    paddle.to_tensor(pw)),
                lambda a, b, reduction: F.binary_cross_entropy_with_logits(
                    a, b, torch.from_numpy(w), reduction,
                    torch.from_numpy(pw)),
                [x, _labels01()], (0, 1))
    if name == "kl_div":
        t = np.random.RandomState(3).dirichlet(np.ones(C), N).astype(
            np.float32)
        t[0, 0] = 0.0                         # target 0 gives 0
        return JF.kl_div, F.kl_div, [logp, t], (0, 1)
    if name == "margin_ranking_loss":
        other = x.copy()
        other[:, 1] = _rand(N, seed=4)
        other[2, 2] = x[2, 2] + 0.1           # the hinge's tie at margin
        sign = np.where(_labels01(5) > 0, 1.0, -1.0).astype(np.float32)
        sign[2, 2] = 1.0
        return (lambda a, b, c, reduction: JF.margin_ranking_loss(
                    a, b, c, 0.1, reduction),
                lambda a, b, c, reduction: F.margin_ranking_loss(
                    a, b, c, 0.1, reduction),
                [x, other, sign], (0, 1))
    if name == "hinge_embedding_loss":
        sign = np.where(_labels01(6) > 0, 1.0, -1.0).astype(np.float32)
        return (lambda a, b, reduction: JF.hinge_embedding_loss(
                    a, b, 0.7, reduction),
                lambda a, b, reduction: F.hinge_embedding_loss(
                    a, b, 0.7, reduction),
                [x, sign], (0,))
    if name == "sigmoid_focal_loss":
        norm = np.array([3.0], np.float32)
        return (lambda a, b, reduction: JF.sigmoid_focal_loss(
                    a, b, paddle.to_tensor(norm), 0.3, 1.5, reduction),
                lambda a, b, reduction: F.sigmoid_focal_loss(
                    a, b, torch.from_numpy(norm), 0.3, 1.5, reduction),
                [x, _labels01()], (0,))
    raise KeyError(name)


LOSSES = ("mse_loss", "l1_loss", "smooth_l1_loss", "nll_loss",
          "nll_loss_ignore_1", "binary_cross_entropy",
          "binary_cross_entropy_weight", "bce_with_logits",
          "bce_with_logits_weights", "kl_div", "margin_ranking_loss",
          "hinge_embedding_loss", "sigmoid_focal_loss")


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_its_gradient_match_the_reference(name, reduction):
    jfn, tfn, arrays, grad_of = _loss_case(name)
    _fwd_bwd(lambda *a: jfn(*a, reduction=reduction),
             lambda *a: tfn(*a, reduction=reduction), arrays, grad_of,
             what="%s %s" % (name, reduction))


def test_kl_div_batchmean_square_error_cost_and_log_loss():
    """kl_div's "batchmean" (the sum over input.shape[0]); the elementwise
    square_error_cost and log_loss (epsilon 1e-3)."""
    jfn, tfn, arrays, _ = _loss_case("kl_div")
    _fwd_bwd(lambda a, b: jfn(a, b, reduction="batchmean"),
             lambda a, b: tfn(a, b, reduction="batchmean"), arrays, (0, 1),
             what="batchmean")
    x, y = _rand(N, C), _rand(N, C, seed=1)
    _fwd_bwd(JF.square_error_cost, F.square_error_cost, [x, y], (0, 1),
             what="square_error_cost")
    _fwd_bwd(lambda a, b: JF.log_loss(a, b, 1e-3),
             lambda a, b: F.log_loss(a, b, 1e-3), [_probs(), _labels01()],
             (0,), what="log_loss")


LOSS_LAYERS = [("MSELoss", (), "mse_loss"), ("L1Loss", ("sum",), "l1_loss"),
               ("NLLLoss", (None, -100, "sum"), "nll_loss"),
               ("BCELoss", (None, "none"), "binary_cross_entropy"),
               ("BCEWithLogitsLoss", (), "bce_with_logits"),
               ("KLDivLoss", ("batchmean",), "kl_div"),
               ("SmoothL1Loss", ("mean", 0.5), "smooth_l1_loss"),
               ("HingeEmbeddingLoss", (0.7,), "hinge_embedding_loss")]


def test_loss_layers_match_the_reference():
    """Each loss layer with its options, forward on the loss's inputs."""
    for cls, args, case in LOSS_LAYERS:
        _, _, arrays, _ = _loss_case(case)
        want = getattr(jnn, cls)(*args)(*map(paddle.to_tensor, arrays))
        got = getattr(nn, cls)(*args)(*map(torch.from_numpy, arrays))
        _rel(_np(got), _np(want), what=cls)
    _, _, arrays, _ = _loss_case("margin_ranking_loss")
    want = jnn.MarginRankingLoss(0.1, "sum")(*map(paddle.to_tensor, arrays))
    got = nn.MarginRankingLoss(0.1, "sum")(*map(torch.from_numpy, arrays))
    _rel(_np(got), _np(want), what="MarginRankingLoss")


def test_smooth_l1_op_is_registered_as_the_references():
    """smooth_l1_op (which F.smooth_l1_loss does not reach, as in the
    reference) resolves in the registry and computes the reference's."""
    from paddle_tpu.framework.dispatch import OPS as JOPS
    from paddle_tpu_torch.framework.dispatch import OPS
    _, _, (x, y), _ = _loss_case("smooth_l1_loss")
    want = JOPS["smooth_l1_op"].fn(x, y, delta=0.5)
    got = OPS["smooth_l1_op"](torch.from_numpy(x), torch.from_numpy(y),
                              delta=0.5)
    _rel(_np(got), np.asarray(want))


def test_nll_loss_with_a_weight_raises():
    """The reference takes nll_loss's weight and ignores it; the port
    refuses one (ROADMAP queue 3)."""
    with pytest.raises(NotImplementedError):
        F.nll_loss(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
                   weight=torch.ones(3))


# the losses whose ops are on auto_cast's black list
BLACK = ("mse_loss", "nll_loss", "binary_cross_entropy", "bce_with_logits",
         "kl_div")


@pytest.mark.parametrize("name", BLACK)
def test_black_listed_loss_under_auto_cast_runs_in_float32(name):
    """auto_cast O1 bfloat16: bfloat16 inputs give a float32 loss in both
    packages (square_error_cost_op, nll_loss_op, bce_loss_op,
    bce_with_logits_op, kldiv_loss_op), to the same value."""
    jfn, tfn, arrays, _ = _loss_case(name)
    jin = [paddle.to_tensor(a).astype("bfloat16")
           if a.dtype == np.float32 else paddle.to_tensor(a) for a in arrays]
    tin = [torch.from_numpy(a).to(torch.bfloat16)
           if a.dtype == np.float32 else torch.from_numpy(a) for a in arrays]
    with jauto_cast(level="O1", dtype="bfloat16"):
        want = jfn(*jin, reduction="none")
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = tfn(*tin, reduction="none")
    assert str(want.dtype).endswith("float32") and got.dtype == torch.float32
    _rel(_np(got), _np(want), what=name)
    # outside auto_cast the same inputs stay bfloat16
    assert tfn(*tin, reduction="none").dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# sequences and containers


@pytest.mark.parametrize("maxlen,dtype", [(None, "int64"), (6, "float32"),
                                          (3, "bool")])
def test_sequence_mask_matches_the_reference(maxlen, dtype):
    lens = np.array([[2, 0], [5, 3]], np.int64)
    want = JF.sequence_mask(paddle.to_tensor(lens), maxlen, dtype)
    got = F.sequence_mask(torch.from_numpy(lens), maxlen, dtype)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert str(got.dtype).split(".")[-1] == str(want.dtype).split(".")[-1]


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_unstack_matches_the_reference(axis):
    x = _rand(2, 3, 4)
    want = JF.unstack(paddle.to_tensor(x), axis)
    got = F.unstack(torch.from_numpy(x), axis)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def _names(layer):
    return [n for n, _ in layer.named_parameters()]


def _containers(pkg):
    """Each container form in one package: name -> layer."""
    lin = lambda i, o: pkg.Linear(i, o)  # noqa: E731
    return {
        "seq": pkg.Sequential(lin(2, 3), pkg.ReLU(), lin(3, 4)),
        "seq_dict": pkg.Sequential(collections.OrderedDict(
            [("inp", lin(2, 3)), ("act", pkg.Tanh()), ("out", lin(3, 4))])),
        "seq_pairs": pkg.Sequential(("inp", lin(2, 3)), pkg.ReLU6(),
                                    ("out", lin(3, 4))),
        "list": pkg.LayerList([lin(2, 2), lin(2, 3)]).append(lin(3, 1)),
        "dict": pkg.LayerDict({"b": lin(2, 2), "a": lin(2, 3)}),
    }


def test_containers_name_their_parameters_as_the_reference():
    """Every form of Sequential, LayerList (append, extend, insert),
    LayerDict and ParameterList: the parameter names, the slices' names,
    and the reference's state carried across and run."""
    paddle.seed(0)
    refs, ports = _containers(jnn), _containers(nn)
    for key in refs:
        assert _names(ports[key]) == _names(refs[key]), key
        load_reference_state(ports[key], {
            k: np.asarray(v.numpy()) for k, v in
            refs[key].state_dict().items()})
    x = _rand(3, 2)
    for key in ("seq", "seq_dict", "seq_pairs"):
        want = refs[key](paddle.to_tensor(x))
        _rel(_np(ports[key](torch.from_numpy(x))), _np(want), what=key)
        assert _names(ports[key][1:]) == _names(refs[key][1:])
        assert type(ports[key][0]).__name__ == type(refs[key][0]).__name__
    assert len(ports["seq"][:2]) == 2 and len(ports["list"]) == 3
    assert _names(ports["list"][1:]) == _names(refs["list"][1:])
    for pkg, box in ((jnn, refs), (nn, ports)):
        box["list"].insert(0, pkg.Linear(1, 1))
        box["list"].extend([pkg.Linear(1, 2)])
        box["params"] = pkg.ParameterList(
            [box["list"][0].weight, box["list"][1].bias])
    assert _names(ports["list"]) == _names(refs["list"])
    assert _names(ports["params"]) == _names(refs["params"]) == ["0", "1"]
    assert list(ports["dict"].keys()) == list(refs["dict"].keys())
    assert "a" in ports["dict"] and len(ports["dict"]) == 2
