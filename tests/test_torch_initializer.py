"""The port's initializers, `ParamAttr`, `Embedding(padding_idx)` and the
layers' `weight_attr` / `bias_attr` against the JAX package, on the CPU.

The random initializers draw from torch generators, the reference's from
jax.random, so their values differ; each is held to the reference's
formula exactly (fans with a Linear weight [in, out] and a convolution's
[out, in, *kernel], the limits, the stds) and its draw to the
distribution: a uniform draw inside its limits, and on a [512, 2048] draw
the mean and the std of both packages' draws within 1e-2 of the
distribution's std of each other and of the formula (sampling noise there
is ~1e-3 of the std). The deterministic ones (Constant, Assign, Dirac)
are equal to the reference's; Orthogonal's Q^T Q (Q Q^T for a wide
shape) is the identity within 1e-5, gain^2 times it with a gain.

A layer built without weight_attr / bias_attr draws what it drew before
they existed: a Linear's weight N(0, sqrt(2 / (in + out))) and an
Embedding's N(0, std) straight from the generator, and GPT, BERT and
ResNet-50 bit-equal whether the attrs are passed as None or left out.
Training through both packages' make_train_step (float32, 3 steps):
parameters within 1e-5 relative.
"""
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import (bert_tiny, export_reference_state,
                                     gpt_tiny, load_reference_state)
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.vision import models as vision
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

BIG = (512, 2048)
CONV = (64, 32, 3, 3)
MOMENT_TOL = 1e-2


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _ref_draw(lib_init, shape):
    paddle.seed(0)
    return np.asarray(lib_init(shape, "float32"), np.float64)


def _expected(name, kw, shape):
    """(kind, parameter) of the reference's formula: "normal" and its std,
    "uniform" and its limit."""
    fi, fo = JI._fans(shape)
    fi_k = kw.get("fan_in") or fi
    gain = kw.get("gain", 1.0)
    if name == "XavierNormal":
        return "normal", gain * math.sqrt(2.0 / (fi_k + (kw.get("fan_out")
                                                         or fo)))
    if name == "XavierUniform":
        return "uniform", gain * math.sqrt(6.0 / (fi_k + (kw.get("fan_out")
                                                          or fo)))
    slope = kw.get("negative_slope", 0.0)
    kgain = (math.sqrt(2.0) if kw.get("nonlinearity", "relu") == "relu"
             else math.sqrt(2.0 / (1 + slope ** 2)))
    if name == "KaimingNormal":
        return "normal", kgain / math.sqrt(fi_k)
    if name == "KaimingUniform":
        return "uniform", kgain * math.sqrt(3.0 / fi_k)
    raise KeyError(name)


FAN_CASES = [("XavierNormal", {}), ("XavierNormal", {"gain": 2.0}),
             ("XavierNormal", {"fan_in": 100, "fan_out": 300}),
             ("XavierUniform", {}), ("XavierUniform", {"gain": 1.5}),
             ("KaimingNormal", {}),
             ("KaimingNormal", {"nonlinearity": "leaky_relu",
                                "negative_slope": 0.2}),
             ("KaimingNormal", {"fan_in": 64}),
             ("KaimingUniform", {}),
             ("KaimingUniform", {"nonlinearity": "tanh"})]


@pytest.mark.parametrize("shape", [BIG, CONV], ids=["linear", "conv"])
@pytest.mark.parametrize("name,kw", FAN_CASES,
                         ids=["%s-%d" % (n, i) for i, (n, _) in
                              enumerate(FAN_CASES)])
def test_fan_initializers_follow_the_reference_formula(name, kw, shape):
    kind, want = _expected(name, kw, shape)
    port = getattr(I, name)(**kw)
    got = port.std(shape) if kind == "normal" else port.limit(shape)
    assert got == pytest.approx(want, rel=1e-12)
    draw = port(shape, generator=_gen()).double().numpy()
    ref = _ref_draw(getattr(JI, name)(**kw), shape)
    if kind == "uniform":
        assert np.abs(draw).max() <= want and np.abs(ref).max() <= want
    if shape == BIG:
        s = want / math.sqrt(3.0) if kind == "uniform" else want
        for x in (draw, ref):
            assert abs(x.mean()) <= MOMENT_TOL * s
            assert abs(x.std() - s) <= MOMENT_TOL * s
        assert abs(draw.std() - ref.std()) <= MOMENT_TOL * s


@pytest.mark.parametrize("name,args,std", [
    ("Normal", (0.5, 2.0), 2.0), ("Uniform", (-0.3, 0.7), 1.0 / math.sqrt(
        12.0)), ("TruncatedNormal", (0.1, 0.5), None)])
def test_plain_random_initializers_match_the_reference_distribution(
        name, args, std):
    draw = getattr(I, name)(*args)(BIG, generator=_gen()).double().numpy()
    ref = _ref_draw(getattr(JI, name)(*args), BIG)
    if name == "Uniform":
        for x in (draw, ref):
            assert x.min() >= args[0] and x.max() <= args[1]
    if name == "TruncatedNormal":
        mean, sd = args
        for x in (draw, ref):
            assert x.min() >= mean - 2 * sd - 1e-6
            assert x.max() <= mean + 2 * sd + 1e-6
        std = ref.std()
    for stat in (np.mean, np.std):
        assert abs(stat(draw) - stat(ref)) <= MOMENT_TOL * std


@pytest.mark.parametrize("value", [0.0, 1.0, -2.5])
def test_constant_equals_the_reference(value):
    np.testing.assert_array_equal(
        I.Constant(value)((3, 4)).numpy(),
        np.asarray(JI.Constant(value)((3, 4), "float32")))


@pytest.mark.parametrize("kind", ["list", "numpy", "tensor"])
def test_assign_equals_the_reference(kind):
    a = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    v = {"list": a.tolist(), "numpy": a, "tensor": torch.from_numpy(a)}[kind]
    jv = paddle.to_tensor(a) if kind == "tensor" else v
    np.testing.assert_array_equal(
        I.Assign(v)((4, 3)).numpy(),
        np.asarray(JI.Assign(jv)((4, 3), "float32")))


@pytest.mark.parametrize("shape,groups", [((4, 4, 3, 3), 1),
                                          ((6, 2, 3, 3), 2),
                                          ((4, 6, 3), 1),
                                          ((8, 2, 3, 3, 3), 4)])
def test_dirac_equals_the_reference(shape, groups):
    np.testing.assert_array_equal(
        I.Dirac(groups)(shape).numpy(),
        np.asarray(JI.Dirac(groups)(shape, "float32")))


@pytest.mark.parametrize("gain", [1.0, 2.0])
@pytest.mark.parametrize("shape", [(64, 32), (32, 64), (8, 4, 16)],
                         ids=["tall", "wide", "3d"])
def test_orthogonal_is_orthonormal_as_the_reference(shape, gain):
    for q in (I.Orthogonal(gain)(shape, generator=_gen()).double().numpy(),
              _ref_draw(JI.Orthogonal(gain), shape)):
        m = q.reshape(-1, shape[-1])
        g = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(g, gain ** 2 * np.eye(len(g)),
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16", None])
def test_initializers_take_the_dtype(dtype):
    for init in (I.Normal(), I.Uniform(), I.XavierNormal(), I.Constant(2.0),
                 I.TruncatedNormal(), I.Orthogonal(), I.Dirac(),
                 I.Assign(np.ones((4, 4, 1)))):
        t = init((4, 4, 1), dtype, _gen())
        assert t.dtype == (getattr(torch, dtype) if dtype
                           else torch.float32)


def test_draws_come_from_the_generator():
    a = I.XavierUniform()((8, 8), generator=_gen(3))
    b = I.XavierUniform()((8, 8), generator=_gen(3))
    c = I.XavierUniform()((8, 8), generator=_gen(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_calculate_gain_and_the_global_default():
    for nl in ("sigmoid", "tanh", "relu", "leaky_relu", "selu"):
        assert I.calculate_gain(nl) == JI.calculate_gain(nl)
    assert I.calculate_gain("leaky_relu", 0.3) == JI.calculate_gain(
        "leaky_relu", 0.3)
    layer = nn.Layer()
    try:
        I.set_global_initializer(I.Constant(0.25))
        p = layer.create_parameter((2, 3))
        assert torch.equal(p.detach(), torch.full((2, 3), 0.25))
        # a bias keeps Constant(0), a layer's own default wins
        assert not layer.create_parameter((3,), is_bias=True).any()
    finally:
        I.set_global_initializer(I.XavierNormal())


# ---------------------------------------------------------------------------
# ParamAttr


@pytest.mark.parametrize("attr", ["none", "name", "init", "false", "attr"])
def test_param_attr_conversion_matches_the_reference(attr):
    make = {"none": lambda lib, init: None,
            "name": lambda lib, init: "w0",
            "init": lambda lib, init: init.Constant(0.5),
            "false": lambda lib, init: False,
            "attr": lambda lib, init: lib.ParamAttr(
                name="w1", learning_rate=0.5, trainable=False,
                need_clip=False)}[attr]
    got = nn.ParamAttr._to_attr(make(nn, I))
    want = jnn.ParamAttr._to_attr(make(jnn, JI))
    if want is False:
        assert got is False
        return
    for field in ("name", "learning_rate", "trainable", "need_clip",
                  "regularizer"):
        assert getattr(got, field) == getattr(want, field), field
    assert type(got.initializer).__name__ == type(want.initializer).__name__


def test_param_attr_refuses_other_types():
    with pytest.raises(TypeError):
        nn.ParamAttr._to_attr(3.5)


@pytest.mark.parametrize("layer", ["Linear", "LayerNorm"])
def test_layer_attrs_match_the_reference(layer):
    """weight_attr / bias_attr reach the parameters: the initializer's
    values, name, trainable (requires_grad), optimize_attr, regularizer
    and need_clip as in the reference; bias_attr False gives no bias."""
    def attrs(lib, init, reg):
        return dict(weight_attr=lib.ParamAttr(
            name="w", initializer=init.Constant(0.3), learning_rate=0.5,
            regularizer=reg.L2Decay(0.1), trainable=False, need_clip=False),
            bias_attr=False)
    args = (4, 3) if layer == "Linear" else (4,)
    port = getattr(nn, layer)(*args, **attrs(nn, I, optimizer))
    ref = getattr(jnn, layer)(*args, **attrs(jnn, JI, paddle.optimizer))
    assert port.bias is None and ref.bias is None
    p, r = port.weight, ref.weight
    np.testing.assert_array_equal(p.detach().numpy(), r.numpy())
    assert p.name == r.name == "w"
    assert p.requires_grad is False and r.stop_gradient is True
    assert p.trainable is False and p.optimize_attr == r.optimize_attr
    assert p.need_clip is False and r.need_clip is False
    assert p.regularizer.coeff == r.regularizer.coeff == 0.1


def test_default_layers_carry_the_default_attrs():
    lin = nn.Linear(4, 3)
    for p in (lin.weight, lin.bias):
        assert p.requires_grad and p.trainable and p.need_clip
        assert p.optimize_attr == {"learning_rate": 1.0}
        assert p.regularizer is None and p.name is None
    ln = nn.LayerNorm(4, weight_attr=False)
    assert ln.weight is None and ln.bias is not None
    x = torch.randn(2, 4)
    want = torch.nn.functional.layer_norm(x, (4,), None, None, 1e-5)
    torch.testing.assert_close(ln(x), want)


def _mlp(lib, need_clip, trainable, lr):
    return lib.Sequential(
        lib.Linear(4, 8, weight_attr=lib.ParamAttr(need_clip=need_clip,
                                                   learning_rate=lr)),
        lib.ReLU(),
        lib.Linear(8, 3, bias_attr=lib.ParamAttr(trainable=trainable)))


@pytest.mark.parametrize("case", ["need_clip", "trainable", "lr"])
def test_param_attrs_in_the_train_step_match_the_reference(case):
    """A ParamAttr's need_clip (under ClipGradByGlobalNorm), trainable and
    learning_rate through both packages' make_train_step, AdamW at 1e-2,
    3 steps: parameters within 1e-5 relative; a parameter that is not
    trainable does not move."""
    kw = dict(need_clip=case != "need_clip", trainable=case != "trainable",
              lr=0.25 if case == "lr" else 1.0)
    paddle.seed(0)
    ref = _mlp(jnn, **kw)
    port = _mlp(nn, **kw)
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    start = export_reference_state(port)

    def opt(lib, params, **extra):
        return lib.AdamW(learning_rate=1e-2, weight_decay=0.01,
                         parameters=params,
                         grad_clip=lib.ClipGradByGlobalNorm(0.05), **extra)
    jopt = opt(paddle.optimizer, ref.parameters())
    topt = opt(optimizer, port.parameters(), device="cpu")

    def loss(lib_sum):
        return lambda o, y: lib_sum((o - y) * (o - y))
    jstep = jmake_train_step(ref, loss(paddle.sum), jopt)
    tstep = make_train_step(port, loss(torch.sum), topt, device="cpu")
    rs = np.random.RandomState(1)
    for _ in range(3):
        x = rs.randn(5, 4).astype(np.float32)
        y = rs.randn(5, 3).astype(np.float32)
        jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
    got = export_reference_state(port)
    for k, v in ref.state_dict().items():
        want = np.asarray(v.numpy())
        err = np.abs(got[k] - want).max()
        assert err <= 1e-5 * max(1.0, np.abs(want).max()), (k, err)
    if case == "trainable":
        np.testing.assert_array_equal(got["2.bias"], start["2.bias"])
        assert not port[2].bias.requires_grad


# ---------------------------------------------------------------------------
# Embedding(padding_idx)


@pytest.mark.parametrize("padding_idx", [None, 0, 3, -1, -4])
def test_embedding_padding_idx_matches_the_reference(padding_idx):
    """The padding row (a negative index counts from the end) is zero
    after the draw, its lookups return zeros and pass the row no
    gradient: outputs and the weight's gradient equal to the
    reference's."""
    V = 10
    paddle.seed(0)
    ref = jnn.Embedding(V, 6, padding_idx=padding_idx)
    port = nn.Embedding(V, 6, padding_idx=padding_idx, generator=_gen())
    row = None if padding_idx is None else padding_idx % V
    if row is not None:
        assert not port.weight[row].any()
        assert not np.asarray(ref.weight.numpy())[row].any()
    # non-zero everywhere, the padding row too, so that the masking shows
    w = np.random.RandomState(2).randn(V, 6).astype(np.float32)
    load_reference_state(port, {"weight": w})
    ref.weight.set_value(w)
    ids = np.array([[0, 3, 9, 3], [1, 6, 0, 2]], np.int64)
    g = np.random.RandomState(3).randn(2, 4, 6).astype(np.float32)
    jo = ref(paddle.to_tensor(ids))
    to = port(torch.from_numpy(ids))
    np.testing.assert_array_equal(to.detach().numpy(), np.asarray(jo.numpy()))
    if row is not None:
        assert not to.detach().numpy()[ids == row].any()
    (jo * paddle.to_tensor(g)).sum().backward()
    (to * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(port.weight.grad.numpy(),
                               ref.weight.grad.numpy(), atol=1e-6)
    if row is not None:
        assert not port.weight.grad[row].any()


def test_embedding_sparse_is_refused():
    # row-sparse gradients are ported now: sparse=True is no longer
    # refused, and the table's gradient is the reference's SelectedRows
    ids = np.array([[0, 3, 3, 1]], np.int64)
    port = nn.Embedding(4, 2, sparse=True)
    ref = paddle.nn.Embedding(4, 2, sparse=True)
    ref.weight.set_value(port.weight.detach().numpy().copy())
    port(torch.from_numpy(ids)).sum().backward()
    ref(paddle.to_tensor(ids)).sum().backward()
    g, jg = port.weight.grad, ref.weight.grad
    assert type(g).__name__ == type(jg).__name__ == "SelectedRows"
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_allclose(g.numpy(), jg.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# what a layer built without the attrs draws


def test_linear_and_embedding_draw_what_they_drew_before():
    lin = nn.Linear(16, 8, generator=_gen(7))
    want = torch.empty(16, 8).normal_(0.0, math.sqrt(2.0 / 24),
                                      generator=_gen(7))
    assert torch.equal(lin.weight.detach(), want)
    assert not lin.bias.any()
    emb = nn.Embedding(10, 4, weight_attr=I.Normal(0.0, 0.02),
                       generator=_gen(8))
    assert torch.equal(emb.weight.detach(), torch.empty(10, 4).normal_(
        0.0, 0.02, generator=_gen(8)))
    emb = nn.Embedding(10, 4, generator=_gen(9))
    assert torch.equal(emb.weight.detach(), torch.empty(10, 4).normal_(
        0.0, 1.0, generator=_gen(9)))
    ln = nn.LayerNorm(5)
    assert torch.equal(ln.weight.detach(), torch.ones(5))
    assert torch.equal(ln.bias.detach(), torch.zeros(5))


def _with_explicit_none(monkeypatch):
    """Every Linear, Embedding and LayerNorm built while this holds is
    given weight_attr=None (and bias_attr=None) explicitly."""
    for cls, keys in ((nn.Linear, ("weight_attr", "bias_attr")),
                      (nn.Embedding, ("weight_attr",)),
                      (nn.LayerNorm, ("weight_attr", "bias_attr"))):
        orig = cls.__init__

        def init(self, *a, _orig=orig, _keys=keys, **k):
            for key in _keys:
                k.setdefault(key, None)
            _orig(self, *a, **k)
        monkeypatch.setattr(cls, "__init__", init)


@pytest.mark.parametrize("model", ["gpt", "bert", "resnet50"])
def test_models_are_bit_equal_with_the_attrs_passed_as_none(model,
                                                            monkeypatch):
    build = {"gpt": lambda: gpt_tiny(device="cpu"),
             "bert": lambda: bert_tiny(device="cpu"),
             "resnet50": lambda: vision.resnet50(num_classes=10,
                                                 device="cpu")}[model]
    import paddle_tpu_torch as tpaddle
    tpaddle.seed(11)
    before = {k: v.clone() for k, v in build().state_dict().items()}
    with monkeypatch.context() as m:
        _with_explicit_none(m)
        tpaddle.seed(11)
        after = build().state_dict()
    assert sorted(before) == sorted(after)
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
