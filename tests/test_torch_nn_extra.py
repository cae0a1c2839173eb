"""The second part of nn in the port against the JAX package, on the CPU:
transposed convolutions, group / instance / local-response norms and
normalize, the 1-D and 3-D pools, the adaptive max pools, max pooling
with indices and its inverse, interpolate in every mode, grid sampling,
the shuffles, unfold, the pads, the dropouts, the small layers, CTC and
the other losses, the decoding helpers, sparse attention, the rest of
`Layer`, `io.RandomSampler` and the weight carry of `models.convert`.

The same seeded numpy inputs go through the reference's functions (its
eager tape for the gradients) and the port's; each test pulls the output
against a fixed numpy cotangent and compares the gradients of every
differentiable input.

Tolerances (absolute, scaled by the largest |value| of the reference's
tensor, at least 1):
  * elementwise ops, shuffles, pads, gathers: 1e-5;
  * reductions, norms, convolutions, resampling, attention, the losses
    and every gradient: 1e-4 (float32 sums in another order);
  * integer outputs (indices, decoded tokens, lengths): exact.

Differences by design (ROADMAP queue 3), each held here: dropout2d /
dropout3d and Dropout(axis) drop whole channels where the reference drops
single elements; avg_pool2d(divisor_override) and conv_transpose's
output_size act, where the reference ignores them; interpolate with
align_corners keeps x's dtype where the reference's (under its x64) is
float64; a channel-last transposed convolution keeps paddle's weight
layout, where the reference's raises.
"""
import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread a worker)

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.dispatch import OPS as REF_OPS
import paddle_tpu_torch as pp
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.framework.dispatch import OPS as PORT_OPS
from paddle_tpu_torch.models import (export_reference_state,
                                     load_reference_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import nn_ops

jax.config.update("jax_platforms", "cpu")

ELEM, RED = 1e-5, 1e-4


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size == 0:
        return
    with np.errstate(invalid="ignore"):
        diff = np.where(got == want, 0.0, np.abs(got - want))
    finite = np.abs(want[np.isfinite(want)])
    scale = max(1.0, finite.max()) if finite.size else 1.0
    assert diff.max() <= tol * scale, (what, float(diff.max()))


def _both(fn_ref, fn_port, arrays, diff=None, seed=1):
    """(reference outputs, gradients), (port outputs, gradients): the
    gradients of the inputs `diff` (default: every float input) against
    one numpy cotangent of the first output."""
    if diff is None:
        diff = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    jin = [jp.to_tensor(a, stop_gradient=i not in diff)
           for i, a in enumerate(arrays)]
    tin = [torch.tensor(a, requires_grad=i in diff)
           for i, a in enumerate(arrays)]
    jout, tout = fn_ref(*jin), fn_port(*tin)
    jl = list(jout) if isinstance(jout, (tuple, list)) else [jout]
    tl = list(tout) if isinstance(tout, (tuple, list)) else [tout]
    cot = np.asarray(np.random.RandomState(seed).randn(*tl[0].shape),
                     np.float32)
    jg = tg = []
    if diff:
        (jl[0] * jp.to_tensor(cot.astype(_np(jl[0]).dtype))).sum().backward()
        (tl[0] * torch.from_numpy(cot).to(tl[0].dtype)).sum().backward()
        jg = [_np(jin[i].grad) for i in diff]
        tg = [_np(tin[i].grad) for i in diff]
    return ([_np(o) for o in jl], jg), ([_np(o) for o in tl], tg)


def _check(fn_ref, fn_port, arrays, tol=RED, diff=None, exact_ints=True):
    (jo, jg), (to, tg) = _both(fn_ref, fn_port, arrays, diff)
    assert len(jo) == len(to)
    for i, (a, b) in enumerate(zip(to, jo)):
        if exact_ints and b.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg="output %d" % i)
        else:
            _close(a, b, tol, "output %d" % i)
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, RED, "grad %d" % i)


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


# -- the name diff ----------------------------------------------------------

NEW_OPS = [
    "conv2d_transpose_op", "interp_op", "group_norm_op", "instance_norm_op",
    "local_response_norm_op", "pixel_shuffle_op", "pixel_unshuffle_op",
    "channel_shuffle_op", "unfold_op", "pad2d_zero_op",
    "max_pool2d_with_index", "max_unpool2d_op", "bilinear_op",
    "hsigmoid_loss_op", "warpctc", "alpha_dropout_op", "grid_sample_op",
    "affine_grid_op", "gumbel_softmax_op", "margin_cross_entropy_op",
    "l2_normalize_op", "sequence_conv_op", "sequence_pool_op",
    "sequence_reverse_op", "sequence_softmax_op", "ctc_align_op",
    "gather_tree_op", "log_softmax_op", "masked_sdpa",
    "fused_bias_dropout_residual", "fused_bias_dropout_residual_layer_norm",
    "fused_bias_dropout_residual_ln_pair", "batch_norm_train",
    "scaled_dot_product_attention"]


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


@pytest.mark.parametrize("what", ["nn", "functional", "Layer", "OPS"])
def test_the_name_diff_of_nn_is_closed(what):
    if what == "nn":
        assert _public(jnn) - _public(pnn) == set()
    elif what == "functional":
        assert _public(JF) - _public(F) - {"Tensor", "jax", "state"} == set()
    elif what == "Layer":
        assert _public(jnn.Layer) - _public(pnn.Layer) == set()
    else:
        for op in NEW_OPS:
            assert op in PORT_OPS and op in REF_OPS, op


# -- transposed convolution -------------------------------------------------

# (x shape, w shape, stride, padding, output_padding, dilation, groups)
CONVT_CASES = [
    ((2, 4, 5, 5), (4, 3, 3, 3), 1, 0, 0, 1, 1),
    ((2, 4, 5, 5), (4, 3, 3, 3), 2, 1, 1, 1, 1),
    ((2, 4, 5, 6), (4, 3, 3, 2), (2, 3), [[1, 0], [2, 1]], (0, 2), 1, 1),
    ((2, 4, 5, 5), (4, 2, 3, 3), 2, 1, 0, 2, 2),
    ((2, 4, 5, 5), (4, 1, 3, 3), 2, [1, 2], 1, 1, 4),
    ((2, 4, 5, 5), (4, 3, 3, 3), 3, 2, 4, 1, 1),
    ((2, 3, 7), (3, 4, 5), 2, 2, 1, 1, 1),
    ((1, 2, 3, 4, 3), (2, 3, 3, 2, 3), 2, 1, 0, 1, 1),
]


@pytest.mark.parametrize("case", CONVT_CASES, ids=[str(i) for i in range(
    len(CONVT_CASES))])
def test_conv_transpose_against_the_reference(case):
    xs, ws, st, pad, op, dil, g = case
    n = len(xs) - 2
    name = "conv%dd_transpose" % n
    fmt = {1: "NCL", 2: "NCHW", 3: "NCDHW"}[n]
    kw = dict(stride=st, padding=pad, output_padding=op, dilation=dil,
              groups=g, data_format=fmt)
    x, w, b = _rand(*xs), _rand(*ws, seed=1, scale=0.3), _rand(
        ws[1] * g, seed=2)
    _check(lambda a, c, d: getattr(JF, name)(a, c, d, **kw),
           lambda a, c, d: getattr(F, name)(a, c, d, **kw), [x, w, b])


def test_conv_transpose_output_size_sets_the_output_padding():
    """The port's output_size picks the output_padding that reaches it
    (paddle's meaning); the reference takes it and ignores it, so the
    port's call equals the reference's with that output_padding."""
    x, w = _rand(2, 4, 5, 5), _rand(4, 3, 3, 3, seed=1, scale=0.3)
    want = JF.conv2d_transpose(jp.to_tensor(x), jp.to_tensor(w), stride=2,
                               padding=1, output_padding=1)
    got = F.conv2d_transpose(torch.tensor(x), torch.tensor(w), stride=2,
                             padding=1, output_size=[10, 10])
    _close(_np(got), _np(want), RED)
    same = F.conv2d_transpose(torch.tensor(x), torch.tensor(w), stride=2,
                              padding=1, output_size=[9, 9])
    assert tuple(same.shape) == (2, 3, 9, 9)
    with pytest.raises(ValueError):
        F.conv2d_transpose(torch.tensor(x), torch.tensor(w), stride=2,
                           padding=1, output_size=[11, 11])
    layer = pnn.Conv2DTranspose(4, 3, 3, stride=2, padding=1)
    assert tuple(layer(torch.tensor(x), output_size=[10, 10]).shape) == (
        2, 3, 10, 10)


def test_conv_transpose_channel_last_keeps_paddles_weight_layout():
    """NHWC input, weight [in, out / groups, kh, kw] as for NCHW; the
    reference's channel-last call raises (it reads the weight as HWIO)."""
    x, w = _rand(2, 4, 5, 5), _rand(4, 3, 3, 3, seed=1, scale=0.3)
    want = F.conv2d_transpose(torch.tensor(x), torch.tensor(w), stride=2,
                              padding=1)
    got = F.conv2d_transpose(torch.tensor(x).permute(0, 2, 3, 1),
                             torch.tensor(w), stride=2, padding=1,
                             data_format="NHWC")
    _close(_np(got.permute(0, 3, 1, 2)), _np(want), ELEM)
    with pytest.raises(Exception):
        JF.conv2d_transpose(jp.to_tensor(x.transpose(0, 2, 3, 1)),
                            jp.to_tensor(w), stride=2, padding=1,
                            data_format="NHWC")


def test_conv_transpose_under_auto_cast_and_the_bf16_pass():
    """conv2d_transpose_op is on the white list: bfloat16 inputs and a
    bfloat16 result, as the reference's; amp_bf16_pass matches it."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.static.passes import AmpBf16Pass
    from paddle_tpu.static.passes import AmpBf16Pass as JPass
    x, w = _rand(1, 4, 5, 5), _rand(4, 3, 3, 3, seed=1, scale=0.3)
    with amp.auto_cast(level="O1"):
        got = F.conv2d_transpose(torch.tensor(x), torch.tensor(w), stride=2)
    with jp.amp.auto_cast(level="O1"):
        want = JF.conv2d_transpose(jp.to_tensor(x), jp.to_tensor(w), stride=2)
    assert got.dtype == torch.bfloat16
    assert str(want.dtype).endswith("bfloat16")
    _close(_np(got.float()), np.asarray(want.astype("float32").numpy()),
           2.0 ** -7)
    assert "conv2d_transpose_op" in AmpBf16Pass.DEFAULT_LIST
    assert "conv2d_transpose_op" in JPass.DEFAULT_LIST


# -- norms ------------------------------------------------------------------

NORM_CASES = {
    "group_nchw": (lambda P, x, w, b: P.group_norm(x, 3, 1e-5, w, b),
                   (2, 6, 4, 5)),
    "group_nhwc": (lambda P, x, w, b: P.group_norm(
        x, 2, 1e-5, w, b, data_format="NHWC"), (2, 4, 5, 6)),
    "group_3d": (lambda P, x, w, b: P.group_norm(x, 6, 1e-3, w, b),
                 (2, 6, 3, 2, 4)),
    "instance_1d": (lambda P, x, w, b: P.instance_norm(
        x, weight=w, bias=b), (2, 6, 7)),
    "instance_2d": (lambda P, x, w, b: P.instance_norm(
        x, weight=w, bias=b, eps=1e-3), (2, 6, 4, 5)),
    "instance_3d": (lambda P, x, w, b: P.instance_norm(
        x, weight=w, bias=b), (1, 6, 3, 2, 4)),
}


@pytest.mark.parametrize("name", sorted(NORM_CASES))
def test_norms_against_the_reference(name):
    fn, shape = NORM_CASES[name]
    c = shape[-1] if name.endswith("nhwc") else shape[1]
    x = _rand(*shape, scale=2.0) + 0.5
    w, b = _rand(c, seed=1) + 1.0, _rand(c, seed=2)
    _check(lambda *a: fn(JF, *a), lambda *a: fn(F, *a), [x, w, b])


@pytest.mark.parametrize("kw", [dict(size=3), dict(size=4, alpha=1e-2,
                                                    beta=0.5, k=2.0),
                                dict(size=5, alpha=0.1)])
def test_local_response_norm(kw):
    x = _rand(2, 7, 3, 4, scale=2.0)
    _check(lambda a: JF.local_response_norm(a, **kw),
           lambda a: F.local_response_norm(a, **kw), [x])


@pytest.mark.parametrize("kw", [dict(), dict(p=1, axis=-1),
                                dict(p=3, axis=0, epsilon=1e-3)])
def test_normalize(kw):
    x = _rand(4, 5, 3)
    _check(lambda a: JF.normalize(a, **kw), lambda a: F.normalize(a, **kw),
           [x])


# -- pools ------------------------------------------------------------------

POOL_CASES = {
    "max1d": (lambda P, x: P.max_pool1d(x, 3, 2, 1), (2, 3, 11)),
    "max1d_ceil": (lambda P, x: P.max_pool1d(x, 2, 2, 0, ceil_mode=True),
                   (2, 3, 9)),
    "avg1d": (lambda P, x: P.avg_pool1d(x, 3, 2, 1), (2, 3, 11)),
    "avg1d_incl": (lambda P, x: P.avg_pool1d(x, 3, 2, 1, exclusive=False),
                   (2, 3, 11)),
    "max3d": (lambda P, x: P.max_pool3d(x, 2, 2, [0, 1, 1]), (1, 2, 4, 5, 6)),
    "avg3d": (lambda P, x: P.avg_pool3d(x, 3, 2, 1, ceil_mode=True),
              (1, 2, 5, 6, 5)),
    "avg3d_ndhwc": (lambda P, x: P.avg_pool3d(x, 2, 2, 0,
                                              data_format="NDHWC"),
                    (1, 4, 4, 6, 3)),
    "adaptive_avg1d": (lambda P, x: P.adaptive_avg_pool1d(x, 4), (2, 3, 10)),
    "adaptive_avg3d": (lambda P, x: P.adaptive_avg_pool3d(x, (2, 3, None)),
                       (1, 2, 5, 6, 4)),
    "adaptive_max1d": (lambda P, x: P.adaptive_max_pool1d(x, 3), (2, 3, 10)),
    "adaptive_max2d": (lambda P, x: P.adaptive_max_pool2d(x, (3, 2)),
                       (2, 3, 7, 6)),
    "adaptive_max2d_div": (lambda P, x: P.adaptive_max_pool2d(x, 2),
                           (2, 3, 6, 4)),
    "adaptive_max3d": (lambda P, x: P.adaptive_max_pool3d(x, 2),
                       (1, 2, 5, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(POOL_CASES))
def test_pools_against_the_reference(name):
    fn, shape = POOL_CASES[name]
    _check(lambda a: fn(JF, a), lambda a: fn(F, a), [_rand(*shape)])


@pytest.mark.parametrize("cfg", [(2, None, 0, False), (3, 2, 1, False),
                                 (3, 2, "SAME", False), (2, 2, 0, True)])
def test_max_pool_with_indices_and_unpool(cfg):
    k, s, p, ceil = cfg
    x = _rand(2, 3, 7, 8)
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil)
    _check(lambda a: JF.max_pool2d(a, return_mask=True, **kw),
           lambda a: F.max_pool2d(a, return_mask=True, **kw), [x])
    if p == "SAME" or ceil:
        return
    jv, ji = JF.max_pool2d(jp.to_tensor(x), return_mask=True, **kw)
    ukw = dict(kernel_size=k, stride=s, padding=p)
    if s is None or s >= k:   # non-overlapping windows: unique indices
        _check(lambda a: JF.max_unpool2d(a, ji, **ukw),
               lambda a: F.max_unpool2d(a, torch.from_numpy(_np(ji)), **ukw),
               [_np(jv)])
    layer_v, layer_i = pnn.MaxPool2D(k, s, p, return_mask=True)(
        torch.tensor(x))
    np.testing.assert_array_equal(_np(layer_i), _np(ji))
    with pytest.raises(ValueError):
        F.max_unpool2d(layer_v, layer_i, k, s, p, output_size=[2, 2])


def test_avg_pool_divisor_override_by_design():
    """paddle's divisor_override divides each window's sum; the reference
    takes it and ignores it (equal to the port's call without it)."""
    x = _rand(2, 3, 6, 6)
    want_sum = F.avg_pool2d(torch.tensor(x), 2, exclusive=False) * 4.0
    got = F.avg_pool2d(torch.tensor(x), 2, divisor_override=3)
    _close(_np(got), _np(want_sum) / 3.0, ELEM)
    ref = JF.avg_pool2d(jp.to_tensor(x), 2, divisor_override=3)
    _close(_np(F.avg_pool2d(torch.tensor(x), 2)), _np(ref), ELEM)
    layer = pnn.AvgPool3D(2, divisor_override=2)
    x3 = _rand(1, 2, 4, 4, 4)
    _close(_np(layer(torch.tensor(x3))),
           _np(F.avg_pool3d(torch.tensor(x3), 2)) * 4.0, ELEM)


# -- interpolate ------------------------------------------------------------

INTERP_SIZES = {"up_int": dict(scale_factor=2), "up_frac": dict(
    size=[10, 9]), "down_int": dict(scale_factor=0.5), "down_frac": dict(
    size=[3, 4]), "up_scale_frac": dict(scale_factor=[1.5, 2.5])}


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("size", sorted(INTERP_SIZES))
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic", "area"])
def test_interpolate_every_mode_up_and_down(mode, size, align):
    """Half-pixel centres, the antialias when downsampling, Keys' cubic
    (a = -0.5), area as linear, the align_corners taps and a scale factor
    turned into a size: the reference's numbers, values and gradients.
    With align_corners the reference's result is float64 (its linspace
    under x64); the port keeps x's dtype."""
    x = _rand(2, 3, 6, 8)
    kw = dict(INTERP_SIZES[size], mode=mode, align_corners=align)
    _check(lambda a: JF.interpolate(a, **kw),
           lambda a: F.interpolate(a, **kw), [x])
    assert F.interpolate(torch.tensor(x), **kw).dtype == torch.float32


@pytest.mark.parametrize("case", [
    ("linear", (2, 3, 9), dict(scale_factor=1.7), "NCW"),
    ("linear", (2, 3, 9), dict(size=4), "NCW"),
    ("trilinear", (1, 2, 4, 5, 6), dict(size=[3, 7, 4]), "NCDHW"),
    ("nearest", (1, 2, 4, 5, 6), dict(scale_factor=2), "NCDHW"),
    ("bilinear", (2, 7, 6, 3), dict(size=[5, 9]), "NHWC"),
    ("nearest", (2, 7, 6, 3), dict(size=[5, 9]), "NHWC")],
    ids=lambda c: "%s-%s" % (c[0], c[3]))
def test_interpolate_other_ranks_and_channel_last(case):
    mode, shape, kw, fmt = case
    _check(lambda a: JF.interpolate(a, mode=mode, data_format=fmt, **kw),
           lambda a: F.interpolate(a, mode=mode, data_format=fmt, **kw),
           [_rand(*shape)])


@pytest.mark.parametrize("case", [
    ("bilinear", dict(size=[3, 4])), ("bicubic", dict(scale_factor=1.5)),
    ("area", dict(size=[10, 9])),
    ("bilinear", dict(size=[9, 11], align_corners=True)),
    ("bicubic", dict(size=[4, 3], align_corners=True))],
    ids=lambda c: "%s-%s" % (c[0], "-".join(sorted(c[1]))))
def test_resize_constants_are_built_on_the_tensors_device(case, monkeypatch):
    """interp_op's weights and taps, and affine_grid's base grid, come from
    torch ops on the input's device, never from a host array copied over:
    such a copy cannot run inside a captured step (make_train_step)."""
    def host_copy(*a, **k):
        raise AssertionError("a host array was copied in")
    mode, kw = case
    x = torch.tensor(_rand(2, 3, 6, 8))
    theta = torch.tensor(_rand(2, 2, 3))
    want = F.interpolate(x, mode=mode, **kw), F.affine_grid(theta,
                                                            [2, 3, 4, 5])
    for name in ("from_numpy", "tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, host_copy)
    got = F.interpolate(x, mode=mode, **kw), F.affine_grid(theta,
                                                           [2, 3, 4, 5])
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("layer", ["Upsample", "UpsamplingNearest2D",
                                   "UpsamplingBilinear2D"])
def test_upsample_layers(layer):
    x = _rand(2, 3, 5, 4)
    _check(lambda a: getattr(jnn, layer)(scale_factor=2)(a),
           lambda a: getattr(pnn, layer)(scale_factor=2)(a), [x])


def test_interp_resize_weights_are_jax_images():
    from jax._src.image.scale import (_fill_keys_cubic_kernel,
                                      _fill_triangle_kernel,
                                      compute_weight_mat)
    for m, n in ((6, 13), (13, 6), (8, 3), (5, 5 * 3)):
        for method, kern in (("linear", _fill_triangle_kernel),
                             ("cubic", _fill_keys_cubic_kernel)):
            want = np.asarray(compute_weight_mat(m, n, n / m, 0.0, kern,
                                                 True))
            _close(nn_ops.resize_weights(m, n, method), want, 1e-12)


# -- grids ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align", [True, False])
def test_grid_sample(mode, padding_mode, align):
    x = _rand(2, 3, 5, 6)
    grid = (1.3 * np.random.RandomState(4).rand(2, 4, 7, 2) - 0.65).astype(
        np.float32)
    kw = dict(mode=mode, padding_mode=padding_mode, align_corners=align)
    diff = [0, 1] if mode == "bilinear" else [0]
    _check(lambda a, g: JF.grid_sample(a, g, **kw),
           lambda a, g: F.grid_sample(a, g, **kw), [x, grid], diff=diff)


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid(align):
    theta = _rand(2, 2, 3, scale=0.5)
    _check(lambda t: JF.affine_grid(t, [2, 3, 4, 5], align_corners=align),
           lambda t: F.affine_grid(t, [2, 3, 4, 5], align_corners=align),
           [theta])


# -- shuffles, unfold, pads -------------------------------------------------

SHAPE_CASES = {
    "pixel_shuffle": (lambda P, x: P.pixel_shuffle(x, 2), (2, 8, 3, 4)),
    "pixel_shuffle_nhwc": (lambda P, x: P.pixel_shuffle(
        x, 2, data_format="NHWC"), (2, 3, 4, 8)),
    "pixel_unshuffle": (lambda P, x: P.pixel_unshuffle(x, 2), (2, 3, 4, 6)),
    "pixel_unshuffle_nhwc": (lambda P, x: P.pixel_unshuffle(
        x, 3, data_format="NHWC"), (1, 6, 3, 2)),
    "channel_shuffle": (lambda P, x: P.channel_shuffle(x, 3), (2, 6, 3, 2)),
    "channel_shuffle_nhwc": (lambda P, x: P.channel_shuffle(
        x, 2, data_format="NHWC"), (2, 3, 2, 6)),
    "unfold": (lambda P, x: P.unfold(x, 3), (2, 3, 5, 6)),
    "unfold_strided": (lambda P, x: P.unfold(x, [2, 3], strides=2,
                                             paddings=1, dilations=[1, 2]),
                       (2, 2, 7, 8)),
    "unfold_pad4": (lambda P, x: P.unfold(x, 2, paddings=[1, 0, 2, 1]),
                    (1, 2, 4, 5)),
    "zeropad2d": (lambda P, x: P.zeropad2d(x, [1, 2, 0, 3]), (2, 3, 4, 5)),
    "zeropad2d_nhwc": (lambda P, x: P.zeropad2d(
        x, [1, 0, 2, 1], data_format="NHWC"), (2, 4, 5, 3)),
    "diag_embed": (lambda P, x: P.diag_embed(x, 1), (2, 3)),
}
for _mode in ("constant", "reflect", "replicate", "circular"):
    SHAPE_CASES["pad_" + _mode] = (
        lambda P, x, m=_mode: P.pad(x, [1, 2, 2, 1], mode=m, value=0.5),
        (2, 3, 4, 5))
SHAPE_CASES["pad_3d_reflect"] = (
    lambda P, x: P.pad(x, [1, 1, 2, 0, 0, 1], mode="reflect",
                       data_format="NCDHW"), (1, 2, 3, 4, 5))
SHAPE_CASES["pad_1d_replicate"] = (
    lambda P, x: P.pad(x, [2, 1], mode="replicate", data_format="NCL"),
    (2, 3, 5))


@pytest.mark.parametrize("name", sorted(SHAPE_CASES))
def test_shuffles_unfold_and_pads(name):
    fn, shape = SHAPE_CASES[name]
    _check(lambda a: fn(JF, a), lambda a: fn(F, a), [_rand(*shape)],
           tol=ELEM)


def test_temporal_shift():
    """Values against the reference's (whose result leaves its tape: no
    gradient to compare), the gradient against the shift run backwards."""
    x = _rand(6, 8, 2, 3)
    _check(lambda a: JF.temporal_shift(a, 3, 0.25),
           lambda a: F.temporal_shift(a, 3, 0.25), [x], tol=ELEM, diff=[])
    t = torch.tensor(x, requires_grad=True)
    cot = _rand(6, 8, 2, 3, seed=9)
    (F.temporal_shift(t, 3, 0.25) * torch.tensor(cot)).sum().backward()
    c = cot.reshape(2, 3, 8, 2, 3)
    want = np.zeros_like(c)
    want[:, 1:, :2] = c[:, :-1, :2]
    want[:, :-1, 2:4] = c[:, 1:, 2:4]
    want[:, :, 4:] = c[:, :, 4:]
    _close(_np(t.grad), want.reshape(x.shape), 0.0)


PAD_LAYERS = [("Pad1D", (2, 3, 5), [1, 2], "reflect"),
              ("Pad2D", (2, 3, 4, 5), [1, 0, 2, 1], "replicate"),
              ("Pad3D", (1, 2, 3, 4, 5), [1, 0, 0, 1, 1, 1], "constant"),
              ("ZeroPad2D", (2, 3, 4, 5), [1, 2, 0, 1], None)]


@pytest.mark.parametrize("case", PAD_LAYERS, ids=[c[0] for c in PAD_LAYERS])
def test_pad_layers(case):
    name, shape, pad, mode = case
    kw = {} if mode is None else {"mode": mode}
    _check(lambda a: getattr(jnn, name)(pad, **kw)(a),
           lambda a: getattr(pnn, name)(pad, **kw)(a), [_rand(*shape)],
           tol=ELEM)


# -- dropouts ---------------------------------------------------------------

@pytest.mark.parametrize("fn", ["dropout2d", "dropout3d"])
def test_dropout_nd_drops_whole_channels_by_design(fn):
    """Paddle's dropout2d/3d: one draw a (sample, channel), the mask
    constant over the spatial axes, kept values scaled by 1 / (1 - p);
    the reference's drops single elements. At p = 0 and in eval the two
    agree."""
    shape = (4, 6, 5, 7) if fn == "dropout2d" else (3, 5, 2, 3, 4)
    x = np.abs(_rand(*shape)) + 0.5
    out = getattr(F, fn)(torch.tensor(x), 0.5)
    kept = (_np(out) != 0)
    sp = tuple(range(2, len(shape)))
    assert (kept.all(axis=sp) | ~kept.any(axis=sp)).all()
    _close(_np(out)[kept], (x / 0.5)[kept], ELEM)
    assert 0 < kept.all(axis=sp).sum() < shape[0] * shape[1]
    for kw in (dict(p=0.0), dict(p=0.5, training=False)):
        _close(_np(getattr(F, fn)(torch.tensor(x), **kw)),
               _np(getattr(JF, fn)(jp.to_tensor(x), **kw)), 0.0)
    layer = getattr(pnn, fn.replace("dropout", "Dropout").upper()
                    .replace("DROPOUT", "Dropout"))(0.5)
    layer.eval()
    _close(_np(layer(torch.tensor(x))), x, 0.0)


def test_dropout_axis_shares_a_draw_along_the_other_axes():
    x = np.ones((6, 5, 4), np.float32)
    out = _np(F.dropout(torch.tensor(x), 0.5, axis=1))
    col = out[0, :, 0]
    assert (out == col[None, :, None]).all()
    assert set(np.unique(out)) <= {0.0, 2.0}
    out2 = _np(pnn.Dropout(0.5, axis=[0, 2])(torch.tensor(x)))
    assert (out2 == out2[:, :1, :]).all()
    _close(_np(F.dropout(torch.tensor(x), 0.5, axis=1, training=False)),
           _np(JF.dropout(jp.to_tensor(x), 0.5, axis=1, training=False)), 0)


def test_alpha_dropout_with_a_given_mask(monkeypatch):
    """The alpha dropout's affine rule on a fixed keep mask against the
    reference's formula (ops/nn_ops.py:583); eval and p = 0 are the
    identity in both."""
    x = _rand(4, 6)
    mask = np.random.RandomState(3).rand(4, 6) >= 0.3
    monkeypatch.setattr(F, "_keep", lambda shape, p, device:
                        torch.from_numpy(mask))
    got = F.alpha_dropout(torch.tensor(x), 0.3)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = 0.7
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    _close(_np(got), a * np.where(mask, x, alpha_p) + b, ELEM)
    for kw in (dict(p=0.0), dict(p=0.3, training=False)):
        _close(_np(F.alpha_dropout(torch.tensor(x), **kw)),
               _np(JF.alpha_dropout(jp.to_tensor(x), **kw)), 0.0)
    layer = pnn.AlphaDropout(0.3)
    layer.eval()
    _close(_np(layer(torch.tensor(x))), x, 0.0)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_with_shared_noise(hard, monkeypatch):
    """The same Gumbel noise on both sides (the reference's
    jax.random.gumbel and the port's `_gumbel` replaced): the soft sample,
    or the straight-through one-hot, and their gradients."""
    x = _rand(3, 5)
    g = np.random.RandomState(7).gumbel(size=(3, 5)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=None: jax.numpy.asarray(g))
    monkeypatch.setattr(nn_ops, "_gumbel", lambda shape, dtype, device:
                        torch.from_numpy(g))
    _check(lambda a: JF.gumbel_softmax(a, 0.7, hard=hard),
           lambda a: F.gumbel_softmax(a, 0.7, hard=hard), [x])


# -- small layers and functions ---------------------------------------------

def test_identity_cosine_pairwise_and_inplace_names():
    x, y = _rand(3, 4), _rand(3, 4, seed=1)
    _close(_np(pnn.Identity(5, foo=1)(torch.tensor(x))), x, 0.0)
    _check(lambda a, b: jnn.CosineSimilarity(axis=1)(a, b),
           lambda a, b: pnn.CosineSimilarity(axis=1)(a, b), [x, y])
    for kw in (dict(), dict(p=1.0, keepdim=True), dict(p=3.0,
                                                      epsilon=1e-3)):
        _check(lambda a, b: jnn.PairwiseDistance(**kw)(a, b),
               lambda a, b: pnn.PairwiseDistance(**kw)(a, b), [x, y])
    for name in ("relu_", "elu_", "softmax_"):
        _check(lambda a: getattr(JF, name)(a),
               lambda a: getattr(F, name)(a), [x])


def _carry(jlayer, player):
    state = {k: np.asarray(v.numpy()) for k, v in
             jlayer.state_dict().items()}
    load_reference_state(player, state)
    back = export_reference_state(player)
    assert set(back) == set(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])


def _layer_check(jlayer, player, inputs, tol=RED, diff=None):
    """Weights carried across, then outputs and the gradients of the
    inputs and of every trainable parameter."""
    _carry(jlayer, player)
    if diff is None:
        diff = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"]
    jin = [jp.to_tensor(a, stop_gradient=i not in diff)
           for i, a in enumerate(inputs)]
    tin = [torch.tensor(a, requires_grad=i in diff)
           for i, a in enumerate(inputs)]
    jo, to = jlayer(*jin), player(*tin)
    _close(_np(to), _np(jo), tol, "output")
    cot = np.random.RandomState(5).randn(*to.shape).astype(np.float32)
    (jo * jp.to_tensor(cot)).sum().backward()
    (to * torch.from_numpy(cot)).sum().backward()
    for i in diff:
        _close(_np(tin[i].grad), _np(jin[i].grad), RED, "input %d" % i)
    jparams = dict(jlayer.named_parameters())
    for name, p in player.named_parameters():
        if p.requires_grad:
            _close(_np(p.grad), _np(jparams[name].grad), RED, name)


LAYER_CASES = {
    "Conv1DTranspose": (lambda M: M.Conv1DTranspose(3, 4, 3, stride=2,
                                                    padding=1), [(2, 3, 6)]),
    "Conv2DTranspose": (lambda M: M.Conv2DTranspose(4, 6, 3, stride=2,
                                                    groups=2,
                                                    output_padding=1),
                        [(2, 4, 4, 5)]),
    "Conv3DTranspose": (lambda M: M.Conv3DTranspose(2, 3, 2, stride=2),
                        [(1, 2, 2, 3, 2)]),
    "GroupNorm": (lambda M: M.GroupNorm(2, 6), [(2, 6, 3, 4)]),
    "InstanceNorm1D": (lambda M: M.InstanceNorm1D(4), [(2, 4, 7)]),
    "InstanceNorm2D": (lambda M: M.InstanceNorm2D(4), [(2, 4, 3, 5)]),
    "InstanceNorm3D": (lambda M: M.InstanceNorm3D(3), [(1, 3, 2, 3, 4)]),
    "LocalResponseNorm": (lambda M: M.LocalResponseNorm(3),
                          [(2, 5, 3, 3)]),
    "Bilinear": (lambda M: M.Bilinear(4, 3, 5), [(6, 4), (6, 3)]),
    "PReLU": (lambda M: M.PReLU(4, 0.1), [(2, 4, 3)]),
    "SyncBatchNorm": (lambda M: M.SyncBatchNorm(4), [(3, 4, 2, 2)]),
    "Unfold": (lambda M: M.Unfold(2, strides=2), [(2, 3, 4, 6)]),
    "PixelShuffle": (lambda M: M.PixelShuffle(2), [(1, 8, 2, 3)]),
    "ChannelShuffle": (lambda M: M.ChannelShuffle(2), [(1, 4, 2, 3)]),
    "MaxPool1D": (lambda M: M.MaxPool1D(2), [(2, 3, 8)]),
    "MaxPool3D": (lambda M: M.MaxPool3D(2), [(1, 2, 4, 4, 2)]),
    "AvgPool1D": (lambda M: M.AvgPool1D(3, 2, 1), [(2, 3, 8)]),
    "AvgPool3D": (lambda M: M.AvgPool3D(2), [(1, 2, 4, 4, 2)]),
    "AdaptiveAvgPool1D": (lambda M: M.AdaptiveAvgPool1D(3), [(2, 3, 8)]),
    "AdaptiveAvgPool3D": (lambda M: M.AdaptiveAvgPool3D(2),
                          [(1, 2, 4, 5, 3)]),
    "AdaptiveMaxPool1D": (lambda M: M.AdaptiveMaxPool1D(3), [(2, 3, 8)]),
    "AdaptiveMaxPool2D": (lambda M: M.AdaptiveMaxPool2D(2), [(2, 3, 5, 4)]),
    "AdaptiveMaxPool3D": (lambda M: M.AdaptiveMaxPool3D(2),
                          [(1, 2, 4, 5, 3)]),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layers_with_carried_weights(name):
    build, shapes = LAYER_CASES[name]
    jp.seed(3)
    inputs = [_rand(*s, seed=i) + (0.5 if "Norm" in name else 0.0)
              for i, s in enumerate(shapes)]
    _layer_check(build(jnn), build(pnn), inputs)


def test_hsigmoid_loss_default_and_custom_trees():
    jp.seed(1)
    x = _rand(5, 4)
    label = np.array([0, 3, 5, 6, 2], np.int64)
    _layer_check(jnn.HSigmoidLoss(4, 7), pnn.HSigmoidLoss(4, 7),
                 [x, label], diff=[0])
    table = np.array([[0, 2, -1], [1, 3, 4], [0, 1, -1], [4, 2, 3],
                      [1, -1, -1]], np.int64)
    code = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 1],
                     [1, 0, 0]], np.int64)
    jl, pl = (jnn.HSigmoidLoss(4, 5, is_custom=True),
              pnn.HSigmoidLoss(4, 5, is_custom=True))
    _carry(jl, pl)
    _check(lambda a, w, b: JF.hsigmoid_loss(a, jp.to_tensor(label), 5, w, b,
                                            jp.to_tensor(table),
                                            jp.to_tensor(code)),
           lambda a, w, b: F.hsigmoid_loss(a, torch.tensor(label), 5, w, b,
                                           torch.tensor(table),
                                           torch.tensor(code)),
           [x, _np(jl.weight), _np(jl.bias)])


def test_spectral_norm_forward_and_its_vectors():
    """weight / sigma and the power iteration's u and v after each
    forward, carried from the reference's initial u and v; two forwards
    (the second starts from the first's vectors)."""
    jp.seed(2)
    shape = (4, 3, 2, 2)
    jl = jnn.SpectralNorm(shape, dim=1, power_iters=2)
    pl = pnn.SpectralNorm(shape, dim=1, power_iters=2)
    _carry(jl, pl)
    w = _rand(*shape)
    for _ in range(2):
        jo = jl(jp.to_tensor(w))
        po = pl(torch.tensor(w))
        _close(_np(po), _np(jo), RED)
        _close(_np(pl.weight_u), _np(jl.weight_u), RED)
        _close(_np(pl.weight_v), _np(jl.weight_v), RED)
    assert not pl.weight_u.requires_grad and not pl.weight_v.requires_grad
    wt = torch.tensor(w, requires_grad=True)
    pl(wt).sum().backward()
    assert wt.grad is not None and torch.isfinite(wt.grad).all()


def test_bilinear_and_hsigmoid_functions():
    x1, x2, w, b = _rand(3, 4), _rand(3, 2, seed=1), _rand(5, 4, 2, seed=2), \
        _rand(5, seed=3)
    _check(lambda a, c, d, e: JF.bilinear(a, c, d, e),
           lambda a, c, d, e: F.bilinear(a, c, d, e), [x1, x2, w, b])


# -- CTC and the other losses -----------------------------------------------

def _ctc_inputs(seed=0):
    rs = np.random.RandomState(seed)
    T, B, C, L = 12, 4, 6, 4
    logits = rs.randn(T, B, C).astype(np.float32)
    labels = rs.randint(1, C, (B, L)).astype(np.int64)
    labels[2, 1] = labels[2, 0]           # a repeat needs a blank between
    in_len = np.array([12, 9, 12, 7], np.int64)
    lab_len = np.array([4, 3, 2, 0], np.int64)
    return logits, labels, in_len, lab_len


@pytest.mark.parametrize("kw", [dict(), dict(reduction="sum"),
                                dict(reduction="none"),
                                dict(norm_by_times=True, blank=0),
                                dict(blank=5, reduction="none")])
def test_ctc_loss(kw):
    logits, labels, in_len, lab_len = _ctc_inputs()
    if kw.get("blank") == 5:
        labels = labels - 1
    _check(lambda a, b, c, d: JF.ctc_loss(a, b, c, d, **kw),
           lambda a, b, c, d: F.ctc_loss(a, b, c, d, **kw),
           [logits, labels, in_len, lab_len], diff=[0])


def test_ctc_masked_positions_have_exactly_zero_gradient():
    """Steps past a sample's input length take no gradient: exactly 0 in
    both (the -1e4 surrogate under the renormalised alpha)."""
    logits, labels, in_len, lab_len = _ctc_inputs(1)
    t = torch.tensor(logits, requires_grad=True)
    pnn.CTCLoss()(t, torch.tensor(labels), torch.tensor(in_len),
                  torch.tensor(lab_len)).backward()
    j = jp.to_tensor(logits, stop_gradient=False)
    jnn.CTCLoss()(j, jp.to_tensor(labels), jp.to_tensor(in_len),
                  jp.to_tensor(lab_len)).backward()
    g, jg = _np(t.grad), _np(j.grad)
    for b, n in enumerate(in_len):
        assert (g[n:, b] == 0).all() and (jg[n:, b] == 0).all()
    _close(g, jg, RED)


@pytest.mark.parametrize("kw", [dict(), dict(margin1=1.0, margin2=0.3,
                                             margin3=0.1, scale=16.0,
                                             reduction="sum"),
                                dict(return_softmax=True,
                                     reduction="none")])
def test_margin_cross_entropy(kw):
    cos = np.clip(_rand(5, 7, scale=0.4), -0.95, 0.95)
    label = np.array([0, 3, 6, 2, 2], np.int64)
    _check(lambda a, b: JF.margin_cross_entropy(a, b, **kw),
           lambda a, b: F.margin_cross_entropy(a, b, **kw), [cos, label])


def test_class_center_sample():
    label = np.array([3, 1, 3, 7, 1], np.int64)
    # every positive fits: the sampled set is the positives, deterministic
    jr, js = JF.class_center_sample(jp.to_tensor(label), 10, 3)
    pr, ps = F.class_center_sample(torch.tensor(label), 10, 3)
    np.testing.assert_array_equal(_np(pr), _np(jr))
    np.testing.assert_array_equal(_np(ps), _np(js))
    pr, ps = F.class_center_sample(torch.tensor(label), 10, 6)
    s = _np(ps)
    assert len(s) == 6 and (np.sort(s) == s).all()
    assert {1, 3, 7} <= set(s.tolist()) and len(set(s.tolist())) == 6
    np.testing.assert_array_equal(s[_np(pr)], label)


def test_ctc_align_greedy_decoder_edit_distance_gather_tree():
    rs = np.random.RandomState(2)
    x = rs.randint(0, 4, (3, 9)).astype(np.int64)
    n = np.array([[9], [6], [0]], np.int64)
    for kw in (dict(), dict(blank=2, merge_repeated=False,
                            padding_value=-1)):
        j = JF.ctc_align(jp.to_tensor(x), jp.to_tensor(n), **kw)
        p = F.ctc_align(torch.tensor(x), torch.tensor(n), **kw)
        for a, b in zip(p, j):
            np.testing.assert_array_equal(_np(a), _np(b))
    probs = rs.rand(3, 8, 5).astype(np.float32)
    j = JF.ctc_greedy_decoder(jp.to_tensor(probs), 0)
    p = F.ctc_greedy_decoder(torch.tensor(probs), 0)
    for a, b in zip(p, j):
        np.testing.assert_array_equal(_np(a), _np(b))
    hyp = rs.randint(0, 5, (4, 7)).astype(np.int64)
    ref = rs.randint(0, 5, (4, 6)).astype(np.int64)
    hl, rl = np.array([7, 5, 3, 0]), np.array([6, 6, 2, 4])
    for kw in (dict(), dict(normalized=False, ignored_tokens=[0])):
        j = JF.edit_distance(jp.to_tensor(hyp), jp.to_tensor(ref),
                             input_length=jp.to_tensor(hl),
                             label_length=jp.to_tensor(rl), **kw)
        p = F.edit_distance(torch.tensor(hyp), torch.tensor(ref),
                            input_length=torch.tensor(hl),
                            label_length=torch.tensor(rl), **kw)
        for a, b in zip(p, j):
            np.testing.assert_array_equal(_np(a), _np(b))
    ids = rs.randint(0, 9, (5, 2, 3)).astype(np.int64)
    parents = rs.randint(0, 3, (5, 2, 3)).astype(np.int64)
    np.testing.assert_array_equal(
        _np(F.gather_tree(torch.tensor(ids), torch.tensor(parents))),
        _np(JF.gather_tree(jp.to_tensor(ids), jp.to_tensor(parents))))


@pytest.mark.parametrize("masks", ["none", "attn", "both"])
def test_sparse_attention(masks):
    rs = np.random.RandomState(6)
    B, H, M, D = 2, 2, 5, 4
    q, k, v = (rs.randn(B, H, M, D).astype(np.float32) for _ in range(3))
    offs, cols = np.zeros((B, H, M + 1), np.int64), []
    for b in range(B):
        for h in range(H):
            row_cols = [sorted(rs.choice(M, rs.randint(0 if r == 3 else 1,
                                                       M), replace=False))
                        for r in range(M)]
            offs[b, h, 1:] = np.cumsum([len(c) for c in row_cols])
            cols.append(sum(row_cols, []))
    nnz = max(len(c) for c in cols)
    colm = np.zeros((B, H, nnz), np.int64)
    for i, c in enumerate(cols):
        colm[i // H, i % H, :len(c)] = c
    am = (rs.rand(M, M) > 0.2).astype(np.float32) if masks != "none" else None
    kpm = (np.where(rs.rand(B, M) > 0.8, -1e9, 0.0).astype(np.float32)
           if masks == "both" else None)

    def call(P, T, a, b, c):
        return P.sparse_attention(
            a, b, c, T(offs), T(colm),
            key_padding_mask=None if kpm is None else T(kpm),
            attn_mask=None if am is None else T(am))
    _check(lambda a, b, c: call(JF, jp.to_tensor, a, b, c),
           lambda a, b, c: call(F, torch.tensor, a, b, c), [q, k, v])


# -- the rest of Layer ------------------------------------------------------

class _Net:
    @staticmethod
    def build(M):
        net = M.Sequential(M.Conv2D(3, 4, 3, padding=1), M.BatchNorm2D(4),
                           M.GroupNorm(2, 4), M.Conv2DTranspose(4, 2, 2, 2))
        net.add_sublayer("head", M.InstanceNorm2D(2))
        return net


def test_layer_methods_against_the_reference():
    jp.seed(4)
    jnet, pnet = _Net.build(jnn), _Net.build(pnn)
    js, ps = jnet.state_dict(), pnet.state_dict()
    assert set(ps) == set(js)
    assert [n for n, _ in pnet.named_sublayers()] == \
        [n for n, _ in jnet.named_sublayers()]
    assert len(pnet.sublayers()) == len(jnet.sublayers())
    assert len(pnet.sublayers(include_self=True)) == len(jnet.sublayers()) + 1
    assert pnet.full_name() == jnet.full_name()
    arrays = {k: np.asarray(v.numpy()) + 0.25 for k, v in js.items()}
    arrays["bogus"] = np.zeros(2, np.float32)
    missing, unexpected = pnet.set_state_dict(arrays)
    jm, ju = jnet.set_state_dict(arrays)
    assert (missing, unexpected) == (jm, ju) == ([], ["bogus"])
    for k, v in pnet.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), arrays[k])
    with pytest.raises(ValueError):
        pnet.set_dict({"0.weight": np.zeros((1,), np.float32)})
    assert pnet.load_dict.__func__ is pnet.set_state_dict.__func__
    x = _rand(2, 3, 4, 4)
    seen = []
    h = pnet.register_forward_post_hook(
        lambda layer, inputs, out: seen.append(out.shape) or out * 2.0)
    jh = jnet.register_forward_post_hook(
        lambda layer, inputs, out: out * 2.0)
    _close(_np(pnet(torch.tensor(x))), _np(jnet(jp.to_tensor(x))), RED)
    h.remove()
    jh.remove()
    assert len(seen) == 1
    _close(_np(pnet(torch.tensor(x))), _np(jnet(jp.to_tensor(x))), RED)
    pnet(torch.tensor(x)).sum().backward()
    assert pnet[0].weight.grad is not None
    pnet.clear_gradients()
    assert all(p.grad is None for p in pnet.parameters())
    p = pnet.add_parameter("extra", torch.nn.Parameter(torch.ones(3)))
    assert pnet.extra is p and "extra" in pnet.state_dict()
    with pytest.raises(TypeError):
        pnet.add_parameter("bad", torch.ones(3))
    pnet.astype("bfloat16")
    assert pnet[0].weight.dtype == torch.bfloat16
    assert pnet[1]._mean.dtype == torch.bfloat16


def test_conv_and_batch_norm_take_param_attrs():
    from paddle_tpu_torch.nn import ParamAttr, initializer as I
    conv = pnn.Conv2D(3, 4, 3, weight_attr=ParamAttr(
        name="cw", initializer=I.Constant(0.5)), bias_attr=ParamAttr(
        learning_rate=2.0, trainable=False))
    assert conv.weight.name == "cw" and (conv.weight == 0.5).all()
    assert not conv.bias.requires_grad
    assert conv.bias.optimize_attr["learning_rate"] == 2.0
    bn = pnn.BatchNorm2D(4, weight_attr=I.Constant(2.0),
                         bias_attr=ParamAttr(initializer=I.Constant(-1.0)))
    assert (bn.weight == 2.0).all() and (bn.bias == -1.0).all()
    assert pnn.BatchNorm2D(4, bias_attr=False).bias is None
    with pytest.raises(NotImplementedError):
        pnn.Conv2D(3, 4, 3, padding_mode="reflect")


def test_sync_batch_norm_converts_a_model():
    jp.seed(0)
    net = pnn.Sequential(pnn.Conv2D(3, 4, 1), pnn.BatchNorm2D(4))
    with torch.no_grad():
        net[1]._mean.fill_(0.3)
    conv = pnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], pnn.SyncBatchNorm)
    assert (conv[1]._mean == 0.3).all()
    x = torch.tensor(_rand(2, 3, 4, 4))
    net.eval()
    conv.eval()
    _close(_np(conv(x)), _np(net(x)), 0.0)


# -- io.RandomSampler -------------------------------------------------------

def test_random_sampler_takes_its_options():
    data = list(range(10))
    g = torch.Generator().manual_seed(3)
    idx = list(pio.RandomSampler(data, generator=g))
    assert sorted(idx) == data
    s = pio.RandomSampler(data, num_samples=4,
                          generator=torch.Generator().manual_seed(3))
    assert len(s) == 4 and list(s) == idx[:4]
    r = pio.RandomSampler(data, replacement=True, num_samples=25,
                          generator=torch.Generator().manual_seed(1))
    got = list(r)
    assert len(got) == 25 == len(r) and set(got) <= set(data)
    assert len(set(got)) < 25
    assert list(pio.RandomSampler(data, replacement=True, num_samples=25,
                                  generator=torch.Generator().manual_seed(
                                      1))) == got
    js = jp.io.RandomSampler(data, replacement=True, num_samples=25)
    assert len(js) == len(r)
