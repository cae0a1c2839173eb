"""The second part of the `nn` ops (counterpart of the ops of
paddle_tpu/ops/nn_ops.py behind nn's conv transposes, group, instance and
local-response norms, resampling, shuffles, pads, index pools, CTC and the
small losses; and of `ctc_align_op` / `gather_tree_op` of
paddle_tpu/ops/misc_ops.py).

Each op is registered under the reference's op type with the reference's
attrs, so a static program records it and a saved program names it. None
of them has a Pallas kernel in the reference (each is XLA ops there), so
each is torch ops here: cuDNN for the transposed convolution, as
`conv2d_op` is. The formulas are the reference's, with its tie rules: a
max or a clip shares the gradient between tied operands (torch.maximum /
minimum / amax do, as jnp's do).

`interp_op` is written from `jax.image.resize`'s definition, not from
torch's `interpolate`, whose sampling differs (see `interp`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..amp import amp_cast_inputs
from ..framework.dispatch import primitive
from ..framework.random import RNG

__all__ = ["conv_transpose", "interp", "group_norm", "instance_norm",
           "local_response_norm", "normalize", "pixel_shuffle",
           "pixel_unshuffle", "channel_shuffle", "unfold", "zero_pad",
           "max_pool2d_with_index", "max_unpool2d", "bilinear",
           "hsigmoid_loss", "ctc_loss", "alpha_dropout", "grid_sample",
           "affine_grid", "gumbel_softmax", "margin_cross_entropy",
           "masked_sdpa", "ctc_align", "gather_tree", "resize_weights",
           "patches", "pad_pairs", "clip_ties", "lookup_rows",
           "embedding_lookup_sparse"]


def clip_ties(x, lo=None, hi=None):
    """jnp.clip: min(max(x, lo), hi), whose gradient at lo or hi is 1/2 as
    jnp.clip's is (torch.clamp's is 1). The bounds are filled on x's
    device (`new_full`), not copied from the host: a captured step cannot
    copy from the host."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def pad_pairs(x, pairs, value=0.0):
    """x padded (or, for a negative pair, cropped) on its trailing axes by
    (lo, hi) pairs, the first pair the first of those axes."""
    if all(lo == 0 and hi == 0 for lo, hi in pairs):
        return x
    flat = [v for lo, hi in reversed(pairs) for v in (lo, hi)]
    return torch.nn.functional.pad(x, flat, value=value)


# ---------------------------------------------------------------------------
# transposed convolution (reference: ops/nn_ops.py:305)


@primitive("conv2d_transpose_op")
def conv_transpose(x, w, stride=(1, 1), padding=(0, 0),
                   output_padding=(0, 0), dilation=(1, 1), groups=1,
                   channel_last=False):
    """The gradient of a convolution: weight (in, out / groups, *k), as in
    paddle and in torch's conv_transpose. The reference computes it as a
    convolution of the input dilated by `stride`, padded by k_eff - 1 - lo
    before and k_eff - 1 - hi + output_padding after: that is torch's
    full transposed convolution (no padding) cropped by `lo` at the start
    and by hi - output_padding at the end (zeros where that is negative),
    which takes asymmetric padding and any output_padding. Under
    auto_cast its inputs are cast (white list); a bfloat16 call returns
    bfloat16, as the reference's does. `channel_last`: x is [N, *sp, C],
    the weight keeps paddle's layout."""
    n = x.ndim - 2
    x, w = amp_cast_inputs("conv2d_transpose_op", [x, w])
    pads = [(p, p) if isinstance(p, int) else tuple(p) for p in padding]
    outpad = ((output_padding,) * n if isinstance(output_padding, int)
              else tuple(output_padding))
    if channel_last:
        x = x.movedim(-1, 1)
    conv = getattr(torch.nn.functional, "conv_transpose%dd" % n)
    full = conv(x, w, None, tuple(stride), 0, 0, int(groups),
                tuple(dilation))
    out = pad_pairs(full, [(-lo, -hi + op) for (lo, hi), op
                           in zip(pads, outpad)])
    return out.movedim(1, -1) if channel_last else out


# ---------------------------------------------------------------------------
# resampling (reference: ops/nn_ops.py interpolate :746, over
# jax.image.resize)

_INTERP_METHODS = {"nearest": "nearest", "bilinear": "linear",
                   "linear": "linear", "trilinear": "linear",
                   "bicubic": "cubic", "area": "linear"}


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 (jax.image's; torch's bicubic has
    a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return out.masked_fill(x >= 2.0, 0.0)


def _triangle(x):
    return (1.0 - x.abs()).clamp_min(0.0)


def resize_weights(in_size, out_size, method, device="cpu"):
    """jax.image's `compute_weight_mat` (scale out / in, no translation,
    antialias on) in float64 on `device`: [in, out], column j the weights
    of the input samples for output j. Output j samples the input at its
    half-pixel centre (j + 0.5) * in / out - 0.5; the kernel is stretched
    by in / out when downsampling (the antialias), the weights of each
    column are divided by their sum (so the edges renormalise rather than
    clamp), and a column whose centre lies outside the input is zero.
    Built with torch ops on the device, so that a captured step computes
    it in the graph (a copy from the host cannot be captured)."""
    kernel = _triangle if method == "linear" else _keys_cubic
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f64 = dict(dtype=torch.float64, device=device)
    sample = (torch.arange(out_size, **f64) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(in_size, **f64)[:, None]).abs()
    weights = kernel(dist / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    weights = (weights / total.masked_fill(total == 0, 1.0)).masked_fill(
        total.abs() <= 1000.0 * float(np.finfo(np.float32).eps), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return weights.masked_fill(~inside[None, :], 0.0)


def _nearest_index(in_size, out_size, device):
    """jax.image's nearest offsets: floor((j + 0.5) * in / out), computed
    in float32 in that order."""
    j = torch.arange(out_size, dtype=torch.float32, device=device)
    return torch.floor((j + 0.5) * float(in_size) / float(out_size)).long()


def _resize_nearest(x, size, axes):
    sp = [x.shape[a] for a in axes]
    if all((o % i == 0) or (i % o == 0) for i, o in zip(sp, size)):
        # an integer ratio on every axis: torch's nearest-exact picks
        # floor((j + 0.5) * in / out) exactly, and its backward sums the
        # repeats in a fixed order
        return torch.nn.functional.interpolate(x, size=tuple(size),
                                               mode="nearest-exact")
    out = x
    for a, n in zip(axes, size):
        if out.shape[a] != n:
            out = out.index_select(a, _nearest_index(out.shape[a], n,
                                                     x.device))
    return out


def _resize_kernel(x, size, axes, method):
    out = x
    for a, n in zip(axes, size):
        m = out.shape[a]
        if m == n:
            continue
        w = resize_weights(m, n, method, x.device).to(x.dtype)
        out = torch.tensordot(out, w, dims=([a], [0])).movedim(-1, a)
    return out


def _resize_align_corners(x, size, axes):
    """The reference's align_corners path (ops/nn_ops.py:759-770): linear
    taps at linspace(0, in - 1, out), axis by axis, for every mode but
    nearest; the taps are computed on x's device."""
    out = x
    for a, n in zip(axes, size):
        m = x.shape[a]
        idx = torch.linspace(0.0, m - 1, n, dtype=torch.float64,
                             device=x.device)
        lo = idx.floor().long()
        hi = (lo + 1).clamp(0, m - 1)
        w = (idx - lo).to(x.dtype).reshape((-1,) + (1,) * (out.ndim - a - 1))
        out = out.index_select(a, lo) * (1 - w) + out.index_select(a, hi) * w
    return out


@primitive("interp_op")
def interp(x, size, mode="nearest", align_corners=False, channel_last=False):
    """Resize the spatial axes to `size` as jax.image.resize does (the
    reference's interp_op): "nearest" picks floor((j + 0.5) * in / out);
    "linear" / "bilinear" / "trilinear" / "area" and "bicubic" weigh the
    input by the triangle or Keys (a = -0.5) kernel at half-pixel centres,
    antialiased when downsampling (see `resize_weights`); an axis whose
    size stays is left as it is. With align_corners, every mode but
    nearest takes the reference's linear taps at linspace(0, in - 1,
    out). The result keeps x's dtype."""
    n = x.ndim - 2
    size = tuple(int(s) for s in size)
    if mode not in _INTERP_METHODS:
        raise ValueError("interpolate mode %r (one of %s)"
                         % (mode, sorted(_INTERP_METHODS)))
    axes = tuple(range(1, 1 + n)) if channel_last else tuple(range(2, 2 + n))
    method = _INTERP_METHODS[mode]
    if align_corners and method != "nearest":
        return _resize_align_corners(x, size, axes)
    if method == "nearest":
        if channel_last:
            return _resize_nearest(x.movedim(-1, 1), size,
                                   tuple(range(2, 2 + n))).movedim(1, -1)
        return _resize_nearest(x, size, axes)
    if not x.is_floating_point():
        x = x.float()
    return _resize_kernel(x, size, axes, method)


@primitive("pixel_shuffle_op")
def pixel_shuffle(x, upscale_factor, channel_last=False):
    r = upscale_factor
    if channel_last:
        n, h, w, c = x.shape
        out = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h * r, w * r, c // (r * r))
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return out.reshape(n, c // (r * r), h * r, w * r)


@primitive("pixel_unshuffle_op")
def pixel_unshuffle(x, downscale_factor, channel_last=False):
    r = downscale_factor
    if channel_last:
        n, h, w, c = x.shape
        out = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h // r, w // r, c * r * r)
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return out.reshape(n, c * r * r, h // r, w // r)


@primitive("channel_shuffle_op")
def channel_shuffle(x, groups, channel_last=False):
    if channel_last:
        n, h, w, c = x.shape
        return x.reshape(n, h, w, groups, c // groups).transpose(-1, -2) \
            .reshape(n, h, w, c)
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


def patches(x, ks, stride, pairs, dilation):
    """im2col of an NC* tensor: [N, C * prod(ks), *out], features in
    (channel, *taps) order, as lax.conv_general_dilated_patches gives
    them."""
    n = len(ks)
    x = pad_pairs(x, pairs)
    for i in range(n):
        x = x.unfold(2 + i, (ks[i] - 1) * dilation[i] + 1, stride[i])
        if dilation[i] > 1:
            x = x[..., ::dilation[i]]
    out_sp = tuple(x.shape[2:2 + n])
    x = x.permute(0, 1, *range(2 + n, 2 + 2 * n), *range(2, 2 + n))
    return x.reshape(x.shape[0], -1, *out_sp)


@primitive("unfold_op")
def unfold(x, kernel_sizes, strides=(1, 1), paddings=(0, 0),
           dilations=(1, 1)):
    """[N, C * kh * kw, L] sliding blocks; 2 paddings pad both sides of
    each axis, 4 or more are (h_lo, h_hi, w_lo, w_hi) as the reference
    reads them."""
    p = tuple(paddings)
    pairs = (((p[0], p[0]), (p[1], p[1])) if len(p) == 2
             else ((p[0], p[1]), (p[2], p[3])))
    out = patches(x, tuple(kernel_sizes), tuple(strides), pairs,
                  tuple(dilations))
    return out.reshape(out.shape[0], out.shape[1], -1)


@primitive("pad2d_zero_op")
def zero_pad(x, padding, channel_last=False):
    left, right, top, bottom = padding
    if channel_last:
        return torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))
    return torch.nn.functional.pad(x, (left, right, top, bottom))


# ---------------------------------------------------------------------------
# normalization (reference: ops/nn_ops.py:516-567)


def _channel_shape(ndim):
    return (1, -1) + (1,) * (ndim - 2)


@primitive("instance_norm_op")
def instance_norm(x, weight, bias, epsilon=1e-5):
    """(x - mean) * rsqrt(var + eps) over each sample's channel (the
    spatial axes), then the channel's weight and bias."""
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight.reshape(_channel_shape(x.ndim))
    if bias is not None:
        y = y + bias.reshape(_channel_shape(x.ndim))
    return y


@primitive("group_norm_op")
def group_norm(x, weight, bias, num_groups, epsilon=1e-5, channel_last=False):
    """(x - mean) * rsqrt(var + eps) over each sample's group of C / G
    channels and the spatial axes, then the channel's weight and bias;
    channel_last moves C in front and back."""
    if channel_last:
        x = x.movedim(-1, 1)
    n, c = x.shape[:2]
    xr = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xr.ndim))
    mean = xr.mean(dim=axes, keepdim=True)
    var = (xr - mean).square().mean(dim=axes, keepdim=True)
    y = ((xr - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    if weight is not None:
        y = y * weight.reshape(_channel_shape(x.ndim))
    if bias is not None:
        y = y + bias.reshape(_channel_shape(x.ndim))
    return y.movedim(1, -1) if channel_last else y


@primitive("l2_normalize_op")
def normalize(x, p=2.0, axis=1, epsilon=1e-12):
    """x / max(||x||_p, eps) along `axis`."""
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.maximum(norm, norm.new_full((), epsilon))


@primitive("local_response_norm_op")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    """x / (k + alpha * mean of x^2 over `size` neighbouring channels)^beta,
    the window size // 2 channels before and the rest after."""
    sq = x.square()
    half = size // 2
    c = x.shape[1]
    pairs = [(half, size - 1 - half)] + [(0, 0)] * (x.ndim - 2)
    padded = pad_pairs(sq, pairs)
    acc = padded.narrow(1, 0, c)
    for i in range(1, size):
        acc = acc + padded.narrow(1, i, c)
    return x / torch.pow(k + alpha * acc / size, beta)


# ---------------------------------------------------------------------------
# index pools (reference: ops/nn_ops.py:1003-1048)


@primitive("max_pool2d_with_index")
def max_pool2d_with_index(x, kernel, stride, padding):
    """(max over each window, the flat h * W + w index of its first
    maximum in the unpadded input). The padding holds the dtype's lowest
    finite value; a tie shares the values' gradient, as jnp.max's."""
    n, c, h, w = x.shape
    kh, kw = kernel
    sh, sw = stride
    (ph0, ph1), (pw0, pw1) = padding
    low = (torch.finfo(x.dtype).min if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    xp = torch.nn.functional.pad(x, (pw0, pw1, ph0, ph1), value=low)
    win = xp.unfold(2, kh, sh).unfold(3, kw, sw)          # n c oh ow kh kw
    oh, ow = win.shape[2], win.shape[3]
    win = win.reshape(n, c, oh, ow, kh * kw)
    vals = win.amax(dim=-1)
    arg = win.detach().argmax(dim=-1)
    base_h = torch.arange(oh, device=x.device)[:, None] * sh
    base_w = torch.arange(ow, device=x.device)[None, :] * sw
    src_h = (base_h + arg // kw - ph0).clamp(0, h - 1)
    src_w = (base_w + arg % kw - pw0).clamp(0, w - 1)
    return vals, (src_h * w + src_w).to(torch.int64)


@primitive("max_unpool2d_op")
def max_unpool2d(x, indices, out_h, out_w):
    """Each pooled value written back at its flat index of an [out_h,
    out_w] plane of zeros."""
    n, c, oh, ow = x.shape
    flat = indices.reshape(n, c, oh * ow).long()
    out = x.new_zeros((n, c, out_h * out_w))
    out = out.scatter(2, flat, x.reshape(n, c, oh * ow))
    return out.reshape(n, c, out_h, out_w)


# ---------------------------------------------------------------------------
# small layers' ops and losses (reference: ops/nn_ops.py:1051-1199, :583,
# :175)


@primitive("bilinear_op")
def bilinear(x1, x2, weight, bias=None):
    """out[b, o] = x1[b, i] W[o, i, j] x2[b, j] (+ bias)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


@primitive("hsigmoid_loss_op")
def hsigmoid_loss(x, label, weight, bias=None, path_table=None,
                  path_code=None, num_classes=2):
    """The hierarchical sigmoid loss [B, 1]: the sum over a label's path of
    log(1 + exp(-sign * logit)), the logit x . W[node] (+ bias[node]),
    sign +1 where the path's code bit is set. The default tree is the
    complete binary heap of num_classes leaves (leaf label + C - 1, the
    internal nodes its ancestors, a left child at an odd index); a custom
    tree comes as (path_table, path_code), padded with -1."""
    if path_table is None:
        depth = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
        cur = label.long() + (num_classes - 1)
        tables, codes = [], []
        for _ in range(depth):
            parent = torch.div(cur - 1, 2, rounding_mode="floor")
            valid = cur > 0
            tables.append(torch.where(valid, parent, -1))
            codes.append(valid & (cur % 2 == 1))
            cur = parent.clamp(min=0)
        path_table = torch.stack(tables, dim=-1)
        path_code = torch.stack(codes, dim=-1)
    else:
        path_table = path_table.long()
        path_code = path_code.bool()
    mask = path_table >= 0
    safe = path_table.clamp(min=0)
    logit = torch.einsum("bd,bpd->bp", x, weight[safe])
    if bias is not None:
        logit = logit + bias.reshape(-1)[safe]
    sign = torch.where(path_code, 1.0, -1.0).to(logit.dtype)
    z = -sign * logit
    losses = torch.logaddexp(z.new_zeros(()), z)
    losses = torch.where(mask, losses, 0.0)
    return losses.sum(dim=-1, keepdim=True)


@primitive("alpha_dropout_op", out_like=0)
def alpha_dropout(x, key=None, p=0.5):
    """SELU's dropout: a * (x where kept, else -alpha * scale) + b, with a
    and b keeping the mean and variance. `key` is the reference's PRNG key
    input, taken and ignored: the keep mask comes from nn.functional's
    `_keep` (the Philox bits kernel on CUDA)."""
    from ..nn.functional import _keep
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    mask = _keep(x.shape, p, x.device)
    return a * torch.where(mask, x, alpha_p) + b


def _gumbel(shape, dtype, device):
    """Standard Gumbel draws -log(-log(U)), U from the device's generator
    (framework.random), in (0, 1)."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=RNG.generator(device), device=device,
                   dtype=dtype).clamp(min=tiny, max=1.0 - 2 ** -24)
    return -torch.log(-torch.log(u))


@primitive("gumbel_softmax_op", out_like=0)
def gumbel_softmax(x, key=None, temperature=1.0, hard=False, axis=-1):
    """softmax((x + g) / temperature) along `axis`, g standard Gumbel
    noise; `hard`: the one-hot of its argmax in the forward and the soft
    sample's gradient (straight-through). `key` is the reference's PRNG
    key input, taken and ignored."""
    g = _gumbel(x.shape, x.dtype, x.device)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + (-y).detach() + y
    return y


@primitive("margin_cross_entropy_op")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0,
                         scale=64.0, return_softmax=False):
    """The ArcFace-family loss [B, 1]: the target class's cosine
    cos(theta) becomes cos(m1 * theta + m2) - m3, all classes times
    `scale`, then the softmax cross entropy; with return_softmax also the
    softmax."""
    lab = label.long().reshape(-1)
    onehot = torch.nn.functional.one_hot(lab, logits.shape[-1]) > 0
    cos = clip_ties(logits, -1.0, 1.0)
    adjusted = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    z = scale * torch.where(onehot, adjusted, cos)
    logp = torch.log_softmax(z, dim=-1)
    loss = -logp.gather(-1, lab[:, None])
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


# ---------------------------------------------------------------------------
# sampling grids (reference: ops/nn_ops.py:1101-1180)


@primitive("affine_grid_op")
def affine_grid(theta, out_h, out_w, align_corners=True):
    """[N, H, W, 2] sampling grid in [-1, 1] from [N, 2, 3] affines:
    (x, y, 1) at each output pixel's centre (align_corners: the corner
    pixels at -1 and 1) times theta."""
    f64 = dict(dtype=torch.float64, device=theta.device)

    def coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, **f64)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size, **f64)
    gx, gy = torch.meshgrid(coords(out_w), coords(out_h), indexing="xy")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).to(theta.dtype)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def _taps(x, ix, iy):
    """x [N, C, H, W] at integer (iy, ix) [N, H', W'], zero outside."""
    n, c, h, w = x.shape
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, 1, -1)
    v = x.reshape(n, c, h * w).gather(2, flat.expand(n, c, flat.shape[-1]))
    v = v.reshape((n, c) + tuple(ix.shape[1:]))
    return torch.where(valid[:, None], v, 0.0)


@primitive("grid_sample_op")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """x [N, C, H, W] sampled at grid [N, H', W', 2] ((x, y) in [-1, 1]),
    bilinear or nearest (round half to even), zeros outside or the
    coordinates clipped to the border."""
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError("grid_sample mode=%r: bilinear/nearest "
                                  "only, as the reference" % (mode,))
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError("grid_sample padding_mode=%r: zeros/"
                                  "border only, as the reference"
                                  % (padding_mode,))
    h, w = x.shape[2], x.shape[3]

    def unnorm(v, size):
        if align_corners:
            return (v + 1.0) * (size - 1) / 2.0
        return ((v + 1.0) * size - 1.0) / 2.0
    fx = unnorm(grid[..., 0], w)
    fy = unnorm(grid[..., 1], h)
    if padding_mode == "border":
        fx = clip_ties(fx, 0, w - 1)
        fy = clip_ties(fy, 0, h - 1)
    if mode == "nearest":
        return _taps(x, torch.round(fx).long(), torch.round(fy).long())
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    top = _taps(x, x0, y0) * (1 - wx) + _taps(x, x0 + 1, y0) * wx
    bot = _taps(x, x0, y0 + 1) * (1 - wx) + _taps(x, x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


# ---------------------------------------------------------------------------
# attention with an additive mask (reference: ops/nn_ops.py:909)


@primitive("masked_sdpa")
def masked_sdpa(q, k, v, add_mask):
    """Dense attention, q/k/v [B, H, T, D], with an additive mask; keys
    whose mask is <= -1e29 get weight 0, so a row with no live key gives
    zeros (the reference's sparse kernel's empty rows)."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * (float(d) ** -0.5) + add_mask
    m = s.amax(dim=-1, keepdim=True).detach()
    e = torch.where(add_mask <= -1e29, 0.0, torch.exp(s - m))
    denom = e.sum(dim=-1, keepdim=True)
    w = e / torch.clamp_min(denom, 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


# ---------------------------------------------------------------------------
# CTC (reference: ops/nn_ops.py warpctc :924, misc_ops.py ctc_align_op :58)


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


@primitive("warpctc")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0):
    """Per-sample CTC negative log-likelihood [B] of log-probabilities
    [T, B, C] against padded labels [B, L], by the reference's forward
    recursion: over the 2L + 1 blank-extended states, alpha renormalised
    at every step (its maximum subtracted and kept apart), impossible
    states held at -1e4 relative to it, so masked paths have exactly zero
    gradient in float32; a sample stops at its input length."""
    T, B, C = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    neg = torch.tensor(-1e4, dtype=torch.float32, device=dev)
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    label_lengths = label_lengths.long().reshape(B)
    input_lengths = input_lengths.long().reshape(B)
    valid = torch.arange(S, device=dev)[None, :] < (
        2 * label_lengths[:, None] + 1)
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long, device=dev),
                        ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    b_range = torch.arange(B, device=dev)
    lp0 = log_probs[0]
    alpha = neg.expand(B, S).clone()
    alpha[:, 0] = lp0[b_range, ext[:, 0]]
    alpha[:, 1] = torch.where(label_lengths > 0, lp0[b_range, ext[:, 1]],
                              neg)
    m0 = alpha.amax(dim=1)
    alpha = torch.where(valid, alpha - m0[:, None], neg)
    shift = m0
    pad1 = neg.expand(B, 1)
    pad2 = neg.expand(B, 2)
    for t in range(1, T):
        s1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        s2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                         neg)
        em = log_probs[t].gather(1, ext)
        new = _lse3(alpha, s1, s2) + em
        m = torch.maximum(new.amax(dim=1), neg)
        new = torch.where(valid, new - m[:, None], neg)
        keep = t < input_lengths
        alpha = torch.where(keep[:, None], new, alpha)
        shift = torch.where(keep, shift + m, shift)
    endb = 2 * label_lengths
    endl = (endb - 1).clamp(min=0)
    a_b = alpha[b_range, endb]
    a_l = torch.where(label_lengths > 0, alpha[b_range, endl], neg)
    m = torch.maximum(a_b, a_l)
    ll = shift + m + torch.log(torch.exp(a_b - m) + torch.exp(a_l - m))
    return -ll


@primitive("ctc_align_op", nondiff=True)
def ctc_align(x, input_length, blank=0, merge_repeated=True,
              padding_value=0):
    """Merge repeats (between blanks), then drop blanks: ([B, T] with the
    kept tokens first, in order, the tail `padding_value`; the counts
    [B, 1] in x's dtype)."""
    B, T = x.shape
    pos = torch.arange(T, device=x.device)[None, :]
    valid = pos < input_length.reshape(B, 1)
    keep = valid & (x != blank)
    if merge_repeated:
        same = torch.cat([torch.zeros((B, 1), dtype=torch.bool,
                                      device=x.device),
                          x[:, 1:] == x[:, :-1]], dim=1)
        keep = keep & ~(same & valid)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    gathered = x.gather(1, order)
    out_len = keep.sum(dim=1)
    out = torch.where(pos < out_len[:, None], gathered,
                      torch.tensor(padding_value, dtype=x.dtype,
                                   device=x.device))
    return out, out_len.reshape(B, 1).to(x.dtype)


@primitive("gather_tree_op", nondiff=True)
def gather_tree(ids, parents):
    """Beam-search backtrace: ids / parents [T, B, W] -> [T, B, W], out[:,
    b, w] the tokens of the hypothesis that ends in beam w."""
    T = ids.shape[0]
    W = ids.shape[2]
    beam = torch.arange(W, device=ids.device).expand(ids.shape[1], W) \
        .to(parents.dtype)
    toks = []
    for t in range(T - 1, -1, -1):
        b = beam.long()
        toks.append(ids[t].gather(1, b))
        beam = parents[t].gather(1, b)
    return torch.stack(toks[::-1])


# ---------------------------------------------------------------------------
# the row-sparse embedding (reference: ops/nn_ops.py:608, its backward
# `_embedding_sparse_vjp` :618)


def lookup_rows(weight, ids, padding_idx=None):
    """The rows of weight at ids, zero where an id is padding_idx (ops
    lookup_table_v2 and lookup_table_v2_sparse)."""
    out = weight[ids.long()]
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return out


class _SparseLookup(torch.autograd.Function):
    """The lookup whose table gradient is row-sparse: one row per id,
    duplicates kept, rows at padding_idx zeroed, as an uncoalesced COO
    tensor that torch accumulates by appending (framework/selected_rows)."""

    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        ctx.save_for_backward(ids)
        ctx.height, ctx.dtype = weight.shape[0], weight.dtype
        ctx.padding_idx = padding_idx
        return lookup_rows(weight, ids, padding_idx)

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        rows = ids.reshape(-1).long()
        vals = ct.reshape(-1, ct.shape[-1]).to(ctx.dtype)
        if ctx.padding_idx is not None and ctx.padding_idx >= 0:
            vals = torch.where((rows == ctx.padding_idx)[:, None], 0.0, vals)
        g = torch.sparse_coo_tensor(rows[None], vals,
                                    (ctx.height, vals.shape[1]),
                                    check_invariants=False)
        return g, None, None


@primitive("lookup_table_v2_sparse")
def embedding_lookup_sparse(weight, ids, padding_idx=None):
    """lookup_table_v2's forward; the table's gradient is row-sparse (a
    SelectedRows when read from `.grad`) where `sparse_allowed(weight)`,
    else dense (a captured step, a table that is not a leaf)."""
    from ..framework.selected_rows import sparse_allowed
    if not sparse_allowed(weight):
        return lookup_rows(weight, ids, padding_idx)
    return _SparseLookup.apply(weight, ids, padding_idx)
