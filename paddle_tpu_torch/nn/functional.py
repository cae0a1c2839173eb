"""Functional ops (counterpart of paddle_tpu/nn/functional and the
primitives in paddle_tpu/ops/nn_ops.py): those GPT, BERT, ResNet and the
Transformer reach, the activations, the losses, `sequence_mask` and
`unstack`.

Weights follow paddle's layout: a linear weight is [in, out] and the op is
x @ W + b, not torch.nn.Linear's [out, in]; a convolution's weight is
OIHW (for a channel-last call the reference's HWIO). Inside
`amp.auto_cast` the ops that the reference lists cast their inputs by the
reference's op names (`amp_cast_inputs`).

`batch_norm` in training writes its running statistics in place, at once,
as the reference's eager batch norm does; inside
`deferred_buffer_updates()` (a train step's body) it hands them to the
caller instead, which writes them after its non-finite guard decided.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ..amp import amp_cast_inputs
from ..framework.dispatch import OPS, primitive
from ..framework.dtype import convert_dtype
from ..framework.flags import flag
from ..framework.random import RNG
from ..framework.state import staging
from ..observability import metrics
from ..ops import cuda_kernels as ck
from ..ops import math as _math
from ..ops.ring_attention import blockwise_attention
from ..tensor import add, mean, reshape, squeeze

__all__ = ["linear", "matmul", "gelu", "relu", "tanh", "softmax",
           "log_softmax", "layer_norm", "dropout",
           "scaled_dot_product_attention", "cross_entropy",
           "softmax_with_cross_entropy", "one_hot", "label_smooth",
           "embedding", "conv1d", "conv2d",
           "conv3d", "batch_norm", "max_pool2d", "avg_pool2d",
           "adaptive_avg_pool2d", "conv_path_counts", "deferred_buffer_updates", "CONV_ALGOS",
           "relu6", "leaky_relu", "prelu", "elu", "selu", "celu", "sigmoid",
           "silu", "swish", "hardtanh", "hardshrink", "softshrink",
           "tanhshrink", "hardsigmoid", "hardswish", "mish", "softplus",
           "softsign", "thresholded_relu", "log_sigmoid", "maxout", "glu",
           "square_error_cost", "mse_loss", "l1_loss", "nll_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "kl_div", "smooth_l1_loss", "margin_ranking_loss",
           "hinge_embedding_loss", "log_loss", "sigmoid_focal_loss",
           "sequence_mask", "unstack", "cosine_similarity"]


def matmul(x, y, transpose_x=False, transpose_y=False):
    """paddle.matmul (reference: ops/math.py matmul, op matmul_v2) with
    the transposes of the last two axes."""
    return _math.matmul(x, y, transpose_x=bool(transpose_x),
                        transpose_y=bool(transpose_y))


def linear(x, weight, bias=None):
    """x @ weight + bias with weight [in, out] (paddle layout): the matmul
    is matmul_v2 under auto_cast, the bias add on neither list."""
    y = matmul(x, weight)
    return y if bias is None else y + bias


@primitive("relu")
def relu(x):
    """relu as the reference computes it, max(x, 0) (ops/nn_ops.py:21):
    its gradient at exactly 0 is 1/2 (torch.relu's is 0), which
    torch.maximum's tie rule gives too."""
    return torch.maximum(x, x.new_zeros(()))


@primitive("tanh")
def tanh(x):
    """tanh (reference: ops/nn_ops.py:84)."""
    return torch.tanh(x)


@primitive("softmax_op")
def _softmax(x, axis=-1):
    (x,) = amp_cast_inputs("softmax_op", [x])
    return torch.softmax(x, dim=axis)


def softmax(x, axis=-1, dtype=None, name=None):
    """softmax along `axis` (reference: ops/nn_ops.py:165, softmax_op),
    x cast to `dtype` first when one is given."""
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return _softmax(x, axis=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    """log-softmax along `axis` (reference: ops/nn_ops.py:170,
    log_softmax_op), x cast to `dtype` first when one is given."""
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    (x,) = amp_cast_inputs("log_softmax_op", [x])
    return torch.log_softmax(x, dim=axis)


@primitive("gelu")
def _gelu(x, approximate=False):
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    """GELU; approximate=True is the tanh form (jax.nn.gelu's
    approximate=True, reference: ops/nn_ops.py gelu)."""
    return _gelu(x, approximate=bool(approximate))


@primitive("layer_norm_op")
def _layer_norm(x, weight, bias, epsilon=1e-5, begin_norm_axis=-1):
    x, weight, bias = amp_cast_inputs("layer_norm_op", [x, weight, bias])
    begin = begin_norm_axis % x.ndim
    last = begin == x.ndim - 1
    dims = -1 if last else tuple(range(begin, x.ndim))
    mu = x.mean(dim=dims, keepdim=True)
    var = (x - mu).square().mean(dim=dims, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * (weight if last else weight.reshape(x.shape[begin:]))
    if bias is not None:
        y = y + (bias if last else bias.reshape(x.shape[begin:]))
    return y


def layer_norm(x, weight, bias, epsilon=1e-5):
    """LayerNorm over the last axis with the reference's formula
    (ops/nn_ops.py layer_norm): mean, then the mean of squared deviations,
    then (x - mean) * rsqrt(var + eps) * weight + bias; layer_norm_op
    under auto_cast."""
    return _layer_norm(x, weight, bias, epsilon=float(epsilon),
                       begin_norm_axis=x.ndim - 1)


def _keep(shape, p, device):
    """Bernoulli(1 - p) keep mask. On CUDA the Philox bits kernel draws it
    from the device's Philox word (`ck.dropout_keep`: keep iff bits >=
    floor(p * 2^32), the fused kernels' rule), so every draw of a train
    step reads the step's word and a captured step draws new masks on
    replay; on the CPU it comes from the CPU generator."""
    if device.type == "cuda":
        return ck.dropout_keep(*RNG.draw(device), shape, p)
    u = torch.rand(shape, generator=RNG.cpu, device=device)
    return u >= p


def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    """paddle's dropout (reference: nn/functional dropout, ops/nn_ops.py
    _dropout). upscale_in_train: kept values scaled by 1/(1-p) in
    training, the identity in eval. downscale_in_infer: kept values as
    they are in training, x * (1-p) in eval. The mask is drawn by `_keep`
    (framework/random.py's Philox word on CUDA, its CPU generator on the
    CPU), so it is not the reference's jax.random mask."""
    if mode not in ck.DROPOUT_MODES:
        raise ValueError("dropout mode %r (one of %s)" % (mode,
                                                          ck.DROPOUT_MODES))
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * torch.zeros_like(x)
    return _dropout(x, None, p=float(p), mode=mode)


@primitive("dropout_op", out_like=0)
def _dropout(x, key=None, p=0.5, mode="upscale_in_train"):
    """The random branch of `dropout`: a fresh keep mask at each call (in a
    program, at each run). `key` is the reference's PRNG key input, taken
    and ignored: the mask comes from `_keep`."""
    keep = _keep(x.shape, p, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, return_weights=False):
    """Attention entry point, q/k/v [B, H, T, D]; returns out [B, H, Tq, D],
    or (out, weights) with return_weights.

    Gate order of the reference (nn/functional/__init__.py
    scaled_dot_product_attention :873, ops/nn_ops.py sdpa :854):
    attention dropout counts only in training; a call that asks for the
    weights takes the dense plain version at once, and returns them
    ([B, H, Tq, Tk] in q's dtype, after the dropout, as the reference's
    are); else first the flash kernels (`FlashAttentionFunction`, dropout
    drawn in the kernel) while the flag `use_flash_attention` is on and
    the call has no additive mask and p < 1, their gate raising on a
    shape or dtype the kernels do not take; then, while
    `FLAGS_sdpa_chunked_threshold` (read per call) is non-zero and the key
    length is at or above it, the blockwise online-softmax tier
    (`ops.ring_attention.blockwise_attention`, path xla_chunked), for a
    call with no mask, p < 1, and Tq == Tk when causal; else the dense
    plain version `flash_attention_plain` (path xla_sdpa), which adds the
    mask and drops the probabilities with a mask from `_keep` (all of them
    at p >= 1), as the reference's XLA path does."""
    p = float(dropout_p) if training else 0.0
    if not return_weights:
        out = ck.flash_attention_or_none(query, key, value, attn_mask,
                                         is_causal, dropout_p=p)
        if out is not None:
            return out
    B, H, Tq, _ = query.shape
    Tk = key.shape[2]
    thr = flag("sdpa_chunked_threshold")
    if (not return_weights and thr and Tk >= thr and attn_mask is None
            and p < 1.0 and (not is_causal or Tq == Tk)):
        ck._note_attn_path("xla_chunked")
        return blockwise_attention(query, key, value, bool(is_causal),
                                   dropout_p=p)
    ck._note_attn_path("xla_sdpa")
    keep = _keep((B, H, Tq, Tk), p, query.device) if p > 0.0 else None
    return ck.flash_attention_plain(query, key, value, bool(is_causal),
                                    attn_mask, keep=keep, dropout_p=p,
                                    return_weights=return_weights)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """-log_softmax(logits) along `axis` against the label, keeping that
    axis with size 1, computed in the logits' dtype as the reference
    computes it (ops/nn_ops.py:648): a hard label picks its class
    (positions whose label is `ignore_index` give 0; a label with a
    trailing size-1 axis is taken as it is); a soft label (a distribution
    over the classes, soft_label=True) gives -sum(label * log_softmax).
    With return_softmax, (loss, softmax)."""
    loss = _softmax_with_cross_entropy(logits, label,
                                       soft_label=bool(soft_label),
                                       ignore_index=int(ignore_index),
                                       axis=int(axis))
    if return_softmax:
        return loss, softmax(logits, axis)
    return loss


@primitive("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(logits, label, soft_label=False,
                                ignore_index=-100, axis=-1):
    if soft_label:
        logits, label = amp_cast_inputs("softmax_with_cross_entropy",
                                        [logits, label])
        logp = torch.log_softmax(logits, dim=axis)
        return -(label * logp).sum(dim=axis, keepdim=True)
    (logits,) = amp_cast_inputs("softmax_with_cross_entropy", [logits])
    axis = axis % logits.ndim
    lab = label.long()
    if lab.ndim == logits.ndim and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    logp = torch.log_softmax(logits, dim=axis)
    picked = torch.gather(logp, axis,
                          lab.clamp(min=0).unsqueeze(axis))
    return torch.where(lab.unsqueeze(axis) == ignore_index,
                       torch.zeros_like(picked), -picked)


@primitive("one_hot_v2")
def _one_hot(x, num_classes):
    return (x.long().unsqueeze(-1) == torch.arange(
        num_classes, device=x.device)).to(torch.float32)


def one_hot(x, num_classes):
    """float32 one-hot rows on a new last axis (reference: ops/nn_ops.py
    one_hot, jax.nn.one_hot): an id outside [0, num_classes) gives a row
    of zeros."""
    return _one_hot(x, num_classes=int(num_classes))


@primitive("label_smooth_op")
def _label_smooth(label, epsilon=0.1):
    (label,) = amp_cast_inputs("label_smooth_op", [label])
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


def label_smooth(label, prior_dist=None, epsilon=0.1):
    """(1 - epsilon) * label + epsilon / K over the last axis of K classes
    (reference: nn/functional/__init__.py:664 over ops/nn_ops.py:737).
    The reference takes `prior_dist` and ignores it; the port refuses
    one rather than ignore it."""
    if prior_dist is not None:
        raise NotImplementedError("label_smooth(prior_dist=...): the "
                                  "reference ignores it; not ported")
    return _label_smooth(label, epsilon=float(epsilon))


def _log_probs_loss(input, label, soft_label, axis):
    """use_softmax=False: -sum(log(input) * target) along `axis`, kept, the
    target the soft label or one_hot(label) on a new last axis (ops log
    and reduce_sum, both on auto_cast's black list)."""
    (x,) = amp_cast_inputs("log", [input])
    target = label if soft_label else one_hot(label, input.shape[axis])
    prod = torch.log(x) * target
    (prod,) = amp_cast_inputs("reduce_sum", [prod])
    return -prod.sum(dim=axis, keepdim=True)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Cross entropy as the reference computes it (nn/functional/
    __init__.py:548-572): the per-position loss of
    softmax_with_cross_entropy (or, with use_softmax=False, of `input`
    taken as probabilities), the class axis squeezed, then:
      * with a class `weight` [C] and hard labels, each loss times its
        label's weight, and "mean" is sum(loss) / sum(weights) (the
        reference ignores `weight` with soft labels, and so does the
        port); an ignored label weighs 0 (the reference looks it up
        outside the weight);
      * else "mean" with ignore_index >= 0 and hard labels divides by the
        count of labels that are not ignored;
      * else "none", "sum" or the plain mean."""
    if reduction not in ("none", "sum", "mean"):
        raise ValueError("reduction %r" % (reduction,))
    if use_softmax:
        loss = softmax_with_cross_entropy(input, label, soft_label,
                                          ignore_index, axis=axis)
    else:
        loss = _log_probs_loss(input, label, soft_label, axis)
    if loss.ndim > 1 and loss.shape[axis] == 1:
        loss = squeeze(loss, axis)
    if weight is not None and not soft_label:
        lab = label.reshape(loss.shape)
        w = torch.where(lab == ignore_index, 0.0,
                        embedding(lab.clamp(min=0), weight))
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum()
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if ignore_index >= 0 and not soft_label:
        valid = (label.reshape(loss.shape) != ignore_index).to(input.dtype)
        return loss.sum() / torch.clamp_min(valid.sum(), 1e-8)
    return mean(loss)


@primitive("fc_op")
def _fc(x, w, b, transpose_x=False, transpose_y=False):
    """matmul_v2 then the bias add: the op `fc_fuse_pass` makes
    (reference: ops/nn_ops.py :831)."""
    return _math.matmul.fn(x, w, transpose_x=transpose_x,
                           transpose_y=transpose_y) + b


@primitive("fused_elemwise_add_act")
def _fused_elemwise_add_act(x, y, act="relu", act_attrs=None):
    """act(x + y): the op `fuse_elewise_add_act_pass` makes (reference:
    ops/nn_ops.py :840); `act` an op type of the registry."""
    return OPS[act].fn(x + y, **(act_attrs or {}))


@primitive("lookup_table_v2")
def _lookup(weight, ids, padding_idx=None):
    out = weight[ids.long()]
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None], 0.0, out)
    return out


def embedding(x, weight, padding_idx=None):
    """Rows of `weight` at the ids `x` (op lookup_table_v2, reference:
    ops/nn_ops.py :599); rows at `padding_idx` come back zero."""
    if padding_idx is None:
        return _lookup(weight, x)
    return _lookup(weight, x, padding_idx=int(padding_idx))


# ---------------------------------------------------------------------------
# convolution (reference: nn/functional/__init__.py:118-170 over
# ops/nn_ops.py conv :270)

CONV_ALGOS = ("auto", "direct", "im2col", "nhwc")
_CONV_PATHS = {"direct": 0, "im2col": 0, "nhwc": 0}
_CONV_COUNTER = metrics.counter(
    "pt_conv_path_total", "conv lowerings traced, by algorithm",
    labelnames=("algo",))


def _note_conv_path(algo):
    _CONV_PATHS[algo] += 1
    _CONV_COUNTER.labels(algo).inc()


def conv_path_counts(reset=False):
    """Convolutions run by lowering (pt_conv_path_total{algo}): bodies that
    ran in Python, so a captured program counts its build, not a replay,
    as the reference counts a trace."""
    out = dict(_CONV_PATHS)
    if reset:
        for k in _CONV_PATHS:
            _CONV_PATHS[k] = 0
    return out


def _pair(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    return v if len(v) == n else v * n


def _norm_padding(padding, n):
    """paddle padding: int, list of n ints, list of 2n ints (lo, hi per
    axis), list of n pairs, or 'SAME'/'VALID'."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return ((int(padding), int(padding)),) * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 2 * n:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    return tuple(tuple(int(q) for q in p) for p in padding)


def _same_pairs(in_sp, ks, st):
    """XLA's SAME: out = ceil(in / stride), the padding split lo <= hi."""
    pairs = []
    for size, k, s in zip(in_sp, ks, st):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pairs.append((total // 2, total - total // 2))
    return tuple(pairs)


def _pad(x, pairs, value=0.0):
    """x padded (or, for a negative pair, cropped) on its trailing axes by
    (lo, hi) pairs, the first pair the first of those axes."""
    if all(lo == 0 and hi == 0 for lo, hi in pairs):
        return x
    flat = [v for lo, hi in reversed(pairs) for v in (lo, hi)]
    return torch.nn.functional.pad(x, flat, value=value)


def _symmetric(pairs):
    return all(lo == hi and lo >= 0 for lo, hi in pairs)


def _conv_direct(x, w, stride, pairs, dilation, groups):
    conv = getattr(torch.nn.functional, "conv%dd" % (x.ndim - 2))
    if _symmetric(pairs):
        return conv(x, w, None, stride, [lo for lo, _ in pairs], dilation,
                    groups)
    return conv(_pad(x, pairs), w, None, stride, 0, dilation, groups)


def _patches(x, ks, stride, pairs, dilation):
    """im2col: [N, C, *sp] -> [N, C * prod(ks), *out], features in
    (channel, *taps) order, as lax.conv_general_dilated_patches gives
    them."""
    n = len(ks)
    x = _pad(x, pairs)
    for i in range(n):
        x = x.unfold(2 + i, (ks[i] - 1) * dilation[i] + 1, stride[i])
        if dilation[i] > 1:
            x = x[..., ::dilation[i]]
    out_sp = tuple(x.shape[2:2 + n])
    x = x.permute(0, 1, *range(2 + n, 2 + 2 * n), *range(2, 2 + n))
    return x.reshape(x.shape[0], -1, *out_sp)


def _conv_im2col(x, w, stride, pairs, dilation):
    """The reference's `_conv_im2col` (ops/nn_ops.py:199): the patches,
    then one matmul over (cin * prod(kernel)) taps with a float32 result
    (its preferred_element_type), rounded back to x's dtype unless x is
    bfloat16."""
    p = _patches(x, tuple(w.shape[2:]), stride, pairs, dilation)
    out_sp = p.shape[2:]
    w2 = w.reshape(w.shape[0], -1).float()
    out = torch.matmul(w2, p.reshape(p.shape[0], p.shape[1], -1).float())
    out = out.reshape(out.shape[0], out.shape[1], *out_sp)
    return out if x.dtype == torch.bfloat16 else out.to(x.dtype)


def _conv(x, w, stride, padding, dilation, groups, channel_last, algo):
    """ops/nn_ops.py conv: `algo` of CONV_ALGOS (auto is direct, as the
    reference's auto is everywhere but a TPU); im2col with groups > 1 runs
    direct, counted as im2col, as in the reference. A bfloat16 conv
    returns float32, every other dtype its own."""
    if algo not in CONV_ALGOS:
        raise ValueError("conv_algo %r (one of %s)" % (algo, CONV_ALGOS))
    n = x.ndim - 2
    if algo == "auto":
        algo = "direct"
    if algo == "nhwc" and (n != 2 or channel_last):
        raise ValueError("conv_algo 'nhwc' takes a 4-D NCHW input, not "
                         "%d-D %s" % (x.ndim,
                                      "channel-last" if channel_last
                                      else "channel-first"))
    _note_conv_path(algo)
    if channel_last:
        # the reference's channel-last spec: input [N, *sp, C], weight
        # [*k, I, O]
        x = x.movedim(-1, 1)
        w = w.permute(n + 1, n, *range(n))
    if isinstance(padding, str):
        eff = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dilation)]
        pairs = (_same_pairs(x.shape[2:], eff, stride)
                 if padding == "SAME" else ((0, 0),) * n)
    else:
        pairs = padding
    if algo == "im2col" and groups == 1:
        out = _conv_im2col(x, w, stride, pairs, dilation)
    elif algo == "nhwc":
        cl = torch.channels_last
        out = _conv_direct(_pad(x, pairs).contiguous(memory_format=cl),
                           w.contiguous(memory_format=cl), stride,
                           ((0, 0),) * n, dilation, groups)
    else:
        out = _conv_direct(x, w, stride, pairs, dilation, groups)
    if channel_last:
        out = out.movedim(1, -1)
    return out.float() if out.dtype == torch.bfloat16 else out


@primitive("conv2d_op")
def _conv_op(x, w, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1,
             channel_last=False, algo="direct"):
    """The reference's conv2d_op (ops/nn_ops.py conv :269, any spatial
    rank) under auto_cast (input and weight)."""
    n = x.ndim - 2
    x, w = amp_cast_inputs("conv2d_op", [x, w])
    return _conv(x, w, _pair(stride, n), _norm_padding(padding, n),
                 _pair(dilation, n), int(groups), bool(channel_last),
                 str(algo))


def _convnd(x, weight, bias, stride, padding, dilation, groups,
            data_format, n):
    """conv1d/2d/3d: conv2d_op with the flag's algorithm, then the bias in
    the layout's channel axis (reshape2, elementwise_add)."""
    channel_last = data_format[-1] == "C" and len(data_format) > 2
    out = _conv_op(x, weight, stride=_pair(stride, n),
                   padding=_norm_padding(padding, n),
                   dilation=_pair(dilation, n), groups=int(groups),
                   channel_last=channel_last, algo=str(flag("conv_algo")))
    if bias is not None:
        shape = ((1,) * (n + 1) + (-1,)) if channel_last \
            else ((1, -1) + (1,) * n)
        out = add(out, reshape(bias, shape))
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _convnd(x, weight, bias, stride, padding, dilation, groups,
                   data_format, 3)


# ---------------------------------------------------------------------------
# batch norm (reference: nn/functional/__init__.py:421 over ops/nn_ops.py
# batch_norm_infer :461 and batch_norm_train :476)

_DEFERRED = threading.local()


@contextlib.contextmanager
def deferred_buffer_updates():
    """Inside the block, this thread's running-statistics updates are
    collected instead of written: yields a dict whose values are
    (buffer, new value) pairs, one a buffer (the last value), for the
    caller to write. A later read of the buffer inside the block sees its
    pending value, as a second use of the layer would see it in the
    reference's trace."""
    prev = getattr(_DEFERRED, "updates", None)
    prev_held = getattr(_DEFERRED, "held", None)
    updates = _DEFERRED.updates = {}
    _DEFERRED.held = {}
    try:
        yield updates
    finally:
        _DEFERRED.updates = prev
        _DEFERRED.held = prev_held


def _deferring():
    """Whether this thread is inside `deferred_buffer_updates` (a train
    step's body)."""
    return getattr(_DEFERRED, "updates", None) is not None


def _hold(owner, value):
    """Keep `value` (a tensor in the autograd graph) for `owner` until the
    train step's body ends: a reference that outlived the body would keep
    that step's graph, and its gradient accumulators, alive into the next
    capture, which then fails. False outside a body."""
    if not _deferring():
        return False
    _DEFERRED.held[id(owner)] = value
    return True


def _held(owner):
    """What `_hold` kept for `owner` in this body, else None."""
    held = getattr(_DEFERRED, "held", None) if _deferring() else None
    return None if held is None else held.get(id(owner))


def _running(buf):
    updates = getattr(_DEFERRED, "updates", None)
    if updates is not None and id(buf) in updates:
        return updates[id(buf)][1]
    return buf


def _set_running(buf, value):
    updates = getattr(_DEFERRED, "updates", None)
    if updates is None:
        buf.copy_(value)
    else:
        updates[id(buf)] = (buf, value)


def _bn_shape(x, channel_last):
    shape = [1] * x.ndim
    shape[x.ndim - 1 if channel_last else 1] = -1
    return shape


def _bn_apply(x, mean, var, weight, bias, epsilon, shape):
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


def _bn_batch(x, weight, bias, epsilon, channel_last):
    """Training batch norm: (y, batch mean, biased batch variance)."""
    shape = _bn_shape(x, channel_last)
    c_axis = x.ndim - 1 if channel_last else 1
    axes = [i for i in range(x.ndim) if i != c_axis]
    mean = x.mean(dim=axes)
    var = x.square().mean(dim=axes) - mean.square()
    return _bn_apply(x, mean, var, weight, bias, epsilon, shape), mean, var


def _moved(run, batch, momentum):
    return momentum * run + (1 - momentum) * batch.detach()


@primitive("batch_norm_infer")
def batch_norm_infer(x, weight, bias, mean, var, epsilon=1e-5,
                     channel_last=False):
    """Batch norm by given statistics (reference: ops/nn_ops.py :460)."""
    return _bn_apply(x, mean, var, weight, bias, epsilon,
                     _bn_shape(x, channel_last))


@primitive("batch_norm_train_stats")
def batch_norm_train_stats(x, weight, bias, run_mean, run_var, momentum=0.9,
                           epsilon=1e-5, channel_last=False):
    """Training batch norm that also returns the new running statistics,
    the static graph's form (reference: ops/nn_ops.py :493): (y,
    new mean, new variance)."""
    y, mean, var = _bn_batch(x, weight, bias, epsilon, channel_last)
    m = float(momentum)
    with torch.no_grad():
        return y, _moved(run_mean, mean, m), _moved(run_var, var, m)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Batch norm with the reference's formulas: in training the batch
    mean and the biased variance mean(x^2) - mean(x)^2 over every axis
    but the channel's, y = (x - mean) * rsqrt(var + eps) * weight + bias,
    and the running statistics m * run + (1 - m) * batch (m = momentum,
    0.9: the weight of the old value; torch.nn.functional.batch_norm
    reads it the other way round and feeds the unbiased variance); with
    use_global_stats (default: not training) the running statistics
    normalise (op batch_norm_infer) and nothing is written. Recorded into
    a static program, training records batch_norm_train_stats and hands
    its new statistics to the program's `buffer_updates`, which a run
    writes into the buffers (reference nn/functional/__init__.py:432-442)."""
    channel_last = data_format[-1] == "C" and len(data_format) > 2
    if use_global_stats is None:
        use_global_stats = not training
    if use_global_stats:
        return batch_norm_infer(x, weight, bias, _running(running_mean),
                                _running(running_var),
                                epsilon=float(epsilon),
                                channel_last=channel_last)
    if staging() and running_mean is not None:
        from ..static.program import Variable
        if isinstance(x, Variable):
            y, new_mean, new_var = batch_norm_train_stats(
                x, weight, bias, running_mean, running_var,
                momentum=float(momentum), epsilon=float(epsilon),
                channel_last=channel_last)
            x.program.buffer_updates.append((running_mean, new_mean.name))
            x.program.buffer_updates.append((running_var, new_var.name))
            return y
    y, mean, var = _bn_batch(x, weight, bias, epsilon, channel_last)
    if running_mean is not None:
        m = float(momentum)
        with torch.no_grad():
            _set_running(running_mean,
                         _moved(_running(running_mean), mean, m))
            _set_running(running_var, _moved(_running(running_var), var, m))
    return y


# ---------------------------------------------------------------------------
# pooling (reference: nn/functional/__init__.py:215-372 over ops/nn_ops.py
# pool :339 and adaptive_pool :400)


def _ceil_extend(in_sp, ks, st, pairs):
    """paddle's ceil_mode: the high padding extended so that the trailing
    partial window counts."""
    ext = []
    for size, k, s, (lo, hi) in zip(in_sp, ks, st, pairs):
        padded = size + lo + hi
        out = -(-(padded - k) // s) + 1
        ext.append((lo, hi + max((out - 1) * s + k - padded, 0)))
    return tuple(ext)


def _pool2d(x, ptype, kernel, stride, padding, ceil_mode, exclusive,
            data_format):
    """ops/nn_ops.py pool over NCHW or NHWC: the padding resolved as the
    reference resolves it (SAME, VALID, pairs; ceil_mode extends the high
    side), max over -inf padding, avg as window sums divided by the count
    of input elements in each window (exclusive) or by the window's
    size."""
    channel_last = data_format[-1] == "C" and len(data_format) > 2
    ks = _pair(kernel, 2)
    st = _pair(stride if stride is not None else kernel, 2)
    if channel_last:
        x = x.movedim(-1, 1)
    sp = tuple(x.shape[2:])
    pad = _norm_padding(padding, 2)
    if pad == "VALID":
        pairs = ((0, 0),) * 2
    elif pad == "SAME":
        pairs = _same_pairs(sp, ks, st)
    else:
        pairs = pad
    if ceil_mode:
        pairs = _ceil_extend(sp, ks, st, pairs)
    F = torch.nn.functional
    if ptype == "max":
        if _symmetric(pairs) and all(lo <= k // 2
                                     for (lo, _), k in zip(pairs, ks)):
            out = F.max_pool2d(x, ks, st, [lo for lo, _ in pairs])
        else:
            low = (float("-inf") if x.is_floating_point()
                   else torch.iinfo(x.dtype).min)
            out = F.max_pool2d(_pad(x, pairs, low), ks, st)
    else:
        out = F.avg_pool2d(_pad(x, pairs), ks, st, divisor_override=1)
        if exclusive:
            ones = torch.ones((1, 1) + sp, dtype=out.dtype, device=x.device)
            count = F.avg_pool2d(_pad(ones, pairs), ks, st,
                                 divisor_override=1)
            out = out / count.clamp_min(1)
        else:
            out = out / float(np.prod(ks))
    return out.movedim(1, -1) if channel_last else out


@primitive("pool2d_op")
def _pool2d_op(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
               padding=(0, 0), ceil_mode=False, exclusive=True,
               channel_last=False):
    """The reference's pool2d_op (ops/nn_ops.py pool :338)."""
    return _pool2d(x, pool_type, kernel, stride, padding, ceil_mode,
                   exclusive, "NHWC" if channel_last else "NCHW")


def _pool_call(x, ptype, kernel_size, stride, padding, ceil_mode, exclusive,
               data_format):
    kernel = _pair(kernel_size, 2)
    return _pool2d_op(
        x, pool_type=ptype, kernel=kernel,
        stride=_pair(stride, 2) if stride is not None else kernel,
        padding=_norm_padding(padding, 2), ceil_mode=bool(ceil_mode),
        exclusive=bool(exclusive),
        channel_last=data_format[-1] == "C" and len(data_format) > 2)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    """Max pool; the gradient goes to the first maximum of a window in
    row-major order, as XLA's select-and-scatter (>=) sends it."""
    return _pool_call(x, "max", kernel_size, stride, padding, ceil_mode,
                      True, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    return _pool_call(x, "avg", kernel_size, stride, padding, ceil_mode,
                      exclusive, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """ops/nn_ops.py adaptive_pool: axis by axis, a mean over equal blocks
    where the size divides, else over the buckets [floor(i * in / out),
    ceil((i + 1) * in / out)); an output size of None keeps the axis."""
    if isinstance(output_size, (int, np.integer)) or output_size is None:
        sizes = (output_size,) * 2
    else:
        sizes = tuple(output_size)
    return _adaptive_pool2d(
        x, output_size=tuple(None if s is None else int(s) for s in sizes),
        pool_type="avg",
        channel_last=data_format[-1] == "C" and len(data_format) > 2)


@primitive("adaptive_pool2d_op")
def _adaptive_pool2d(x, output_size, pool_type="avg", channel_last=False):
    """The reference's adaptive_pool2d_op (ops/nn_ops.py :399), average
    pooling only."""
    if pool_type != "avg":
        raise NotImplementedError("adaptive_pool2d_op: pool_type %r is not "
                                  "ported" % (pool_type,))
    sizes = tuple(output_size)
    axes = (1, 2) if channel_last else (2, 3)
    out = x
    for ax, out_s in zip(axes, sizes):
        in_s = out.shape[ax]
        if out_s is None or out_s == in_s:
            continue
        out_s = int(out_s)
        if in_s % out_s == 0:
            shape = (tuple(out.shape[:ax]) + (out_s, in_s // out_s)
                     + tuple(out.shape[ax + 1:]))
            out = out.reshape(shape).mean(dim=ax + 1)
        else:
            starts = (np.arange(out_s) * in_s) // out_s
            ends = ((np.arange(out_s) + 1) * in_s + out_s - 1) // out_s
            out = torch.cat([out.narrow(ax, int(a), int(b - a))
                             .mean(dim=ax, keepdim=True)
                             for a, b in zip(starts, ends)], dim=ax)
    return out


# ---------------------------------------------------------------------------
# activations (reference: nn/functional/__init__.py:17-84 over ops/nn_ops.py
# :21-157). Each is the reference's formula with the same tie rules: a
# clip is min(max(x, lo), hi), whose gradient at lo or hi is 1/2 as
# jnp.clip's is (torch.clamp's is 1); a where() keeps its branch's
# gradient.

def _clip(x, lo=None, hi=None):
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def _softplus1(x):
    """jax.nn.softplus: log(1 + exp(x)) = logaddexp(x, 0), exact for every
    x (torch's softplus turns to x above its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


@primitive("relu6")
def _relu6(x, threshold=6.0):
    return _clip(x, 0.0, threshold)


def relu6(x):
    """min(max(x, 0), 6) (reference: ops/nn_ops.py:26)."""
    return _relu6(x)


@primitive("leaky_relu")
def _leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _leaky_relu(x, negative_slope=float(negative_slope))


@primitive("prelu_op")
def _prelu(x, weight, data_format="NCHW"):
    if weight.numel() == 1:
        w = weight.reshape(())
    elif data_format == "NCHW" and x.ndim >= 2:
        w = weight.reshape((1, -1) + (1,) * (x.ndim - 2))
    else:
        w = weight.reshape((1,) * (x.ndim - 1) + (-1,))
    return torch.where(x >= 0, x, w * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """x where x >= 0, else weight * x: one weight, or one per channel
    (axis 1 for NCHW, the last axis otherwise)."""
    return _prelu(x, weight, data_format=data_format)


def _expm1_neg(x):
    """expm1 of x where x <= 0, of 0 elsewhere (the reference's `safe`)."""
    return torch.expm1(torch.where(x > 0, 0.0, x))


@primitive("elu")
def _elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * _expm1_neg(x))


def elu(x, alpha=1.0, name=None):
    return _elu(x, alpha=float(alpha))


@primitive("selu")
def _selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * _expm1_neg(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _selu(x, scale=float(scale), alpha=float(alpha))


@primitive("celu")
def _celu(x, alpha=1.0):
    zero = x.new_zeros(())
    return torch.maximum(x, zero) + torch.minimum(
        zero, alpha * torch.expm1(torch.minimum(x, zero) / alpha))


def celu(x, alpha=1.0, name=None):
    return _celu(x, alpha=float(alpha))


@primitive("sigmoid")
def sigmoid(x):
    """1 / (1 + exp(-x)) (reference: ops/nn_ops.py:69)."""
    return torch.sigmoid(x)


@primitive("silu")
def silu(x):
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


@primitive("swish")
def swish(x):
    """x * sigmoid(x), under the op name swish."""
    return x * torch.sigmoid(x)


@primitive("hardtanh")
def _hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return _clip(x, min, max)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return _hardtanh(x, min=float(min), max=float(max))


@primitive("hardshrink")
def _hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, 0.0)


def hardshrink(x, threshold=0.5, name=None):
    return _hardshrink(x, threshold=float(threshold))


@primitive("softshrink")
def _softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def softshrink(x, threshold=0.5, name=None):
    return _softshrink(x, threshold=float(threshold))


@primitive("tanhshrink")
def tanhshrink(x):
    """x - tanh(x)."""
    return x - torch.tanh(x)


@primitive("hardsigmoid")
def _hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return _clip(slope * x + offset, 0.0, 1.0)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    """clip(slope * x + offset, 0, 1), slope 1/6 and offset 0.5 by
    default (the reference's, not torch's 1/6 and 1/2 by another
    formula)."""
    return _hardsigmoid(x, slope=float(slope), offset=float(offset))


@primitive("hardswish")
def _hardswish(x, threshold=6.0, scale=6.0, offset=3.0):
    return x * _clip(x + offset, 0.0, threshold) / scale


def hardswish(x):
    """x * clip(x + 3, 0, 6) / 6."""
    return _hardswish(x)


@primitive("mish")
def mish(x):
    """x * tanh(softplus(x))."""
    return x * torch.tanh(_softplus1(x))


@primitive("softplus")
def _softplus(x, beta=1.0, threshold=20.0):
    scaled = beta * x
    return torch.where(scaled > threshold, x, _softplus1(scaled) / beta)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """log(1 + exp(beta * x)) / beta, x itself where beta * x > threshold
    (20 by default)."""
    return _softplus(x, beta=float(beta), threshold=float(threshold))


@primitive("softsign")
def softsign(x):
    """x / (1 + |x|)."""
    return x / (1.0 + x.abs())


@primitive("thresholded_relu")
def _thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, 0.0)


def thresholded_relu(x, threshold=1.0, name=None):
    return _thresholded_relu(x, threshold=float(threshold))


@primitive("log_sigmoid")
def log_sigmoid(x):
    """log(sigmoid(x)) = -softplus(-x)."""
    return -_softplus1(-x)


@primitive("maxout_op")
def _maxout(x, groups, axis=1):
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    # amax shares the gradient among tied maxima, as the reference's max
    # reduction does
    return x.reshape(shape).amax(dim=axis + 1)


def maxout(x, groups, axis=1, name=None):
    """The max over `groups` consecutive channels of `axis`."""
    return _maxout(x, groups=int(groups), axis=int(axis))


@primitive("glu_op")
def _glu(x, axis=-1):
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def glu(x, axis=-1, name=None):
    """a * sigmoid(b), a and b the halves of `axis`."""
    return _glu(x, axis=int(axis))


# ---------------------------------------------------------------------------
# losses (reference: nn/functional/__init__.py:540-700 over ops/nn_ops.py
# :666-735). The per-element ops cast their inputs by the reference's op
# names under auto_cast (bce_loss_op, bce_with_logits_op, kldiv_loss_op,
# nll_loss_op and square_error_cost_op are on its black list: bfloat16
# and float16 inputs run in float32); so do the reductions (reduce_mean,
# reduce_sum) and log.

def _reduce_loss(loss, reduction):
    """The reference's `_reduce_loss`: "mean" (op reduce_mean), "sum" (op
    reduce_sum), anything else the loss as it is."""
    if reduction == "mean":
        (loss,) = amp_cast_inputs("reduce_mean", [loss])
        return mean(loss)
    if reduction == "sum":
        (loss,) = amp_cast_inputs("reduce_sum", [loss])
        return loss.sum()
    return loss


@primitive("square_error_cost_op")
def _square_error_cost(input, label):
    input, label = amp_cast_inputs("square_error_cost_op", [input, label])
    return (input - label).square()


def square_error_cost(input, label):
    """(input - label)^2 elementwise."""
    return _square_error_cost(input, label)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce_loss(_square_error_cost(input, label), reduction)


def _abs(x):
    """|x| with jnp.abs's gradient at 0 (1, where torch.abs's is 0)."""
    return torch.where(x >= 0, x, -x)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce_loss(_abs(input - label), reduction)


@primitive("nll_loss_op")
def _nll_loss(log_prob, label, ignore_index=-100):
    log_prob, = amp_cast_inputs("nll_loss_op", [log_prob])
    lab = label.long()
    picked = torch.gather(log_prob, 1, lab.clamp(min=0)[:, None])[:, 0]
    return torch.where(lab == ignore_index, 0.0, -picked)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """-input[i, label[i]] for log-probabilities input [N, C], 0 where the
    label is `ignore_index`; "mean" over all N positions, ignored ones
    too, as the reference's. The reference takes `weight` and ignores
    it; the port refuses one rather than ignore it."""
    if weight is not None:
        raise NotImplementedError("nll_loss(weight=...): the reference "
                                  "ignores it; not ported")
    return _reduce_loss(_nll_loss(input, label,
                                  ignore_index=int(ignore_index)), reduction)


@primitive("bce_loss_op")
def _bce_loss(input, label):
    input, label = amp_cast_inputs("bce_loss_op", [input, label])
    x = _clip(input, 1e-12, 1.0 - 1e-12)
    return -(label * torch.log(x) + (1.0 - label) * torch.log1p(-x))


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """-(y log p + (1 - y) log(1 - p)), p clipped to [1e-12, 1 - 1e-12],
    times `weight` (broadcast), then the reduction."""
    loss = _bce_loss(input, label)
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


@primitive("bce_with_logits_op")
def _bce_with_logits(logit, label, pos_weight=None):
    logit, label, pos_weight = amp_cast_inputs(
        "bce_with_logits_op", [logit, label, pos_weight])
    max_val = _clip(-logit, 0.0)
    soft = torch.log1p(torch.exp(-_abs(logit)))
    if pos_weight is None:
        return (1.0 - label) * logit + max_val + soft
    log_w = (pos_weight - 1.0) * label + 1.0
    return (1.0 - label) * logit + log_w * (soft + max_val)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable sigmoid cross entropy of the reference's
    bce_with_logits_op; `pos_weight` [C] weighs the positive term, `weight`
    the loss."""
    loss = _bce_with_logits(logit, label, pos_weight)
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


@primitive("kldiv_loss_op")
def _kldiv_loss(x, target):
    x, target = amp_cast_inputs("kldiv_loss_op", [x, target])
    safe = torch.where(target > 0, target, 1.0)
    return torch.where(target > 0, target * (torch.log(safe) - x), 0.0)


def kl_div(input, label, reduction="mean", name=None):
    """target * (log target - input) where target > 0, else 0;
    "batchmean" is the sum over the batch size (input.shape[0])."""
    loss = _kldiv_loss(input, label)
    if reduction == "batchmean":
        return _reduce_loss(loss, "sum") / float(input.shape[0])
    return _reduce_loss(loss, reduction)


@primitive("huber_loss_op")
def _huber_loss(input, label, delta=1.0):
    (input, label) = amp_cast_inputs("huber_loss_op", [input, label])
    r = _abs(input - label)
    return torch.where(r <= delta, 0.5 * r * r, delta * (r - 0.5 * delta))


@primitive("smooth_l1_op")
def _smooth_l1(input, label, delta=1.0):
    """The reference's smooth_l1_op (ops/nn_ops.py:699), which its
    F.smooth_l1_loss does not reach (that is huber_loss_op): registered
    so that a program that names it loads."""
    (input, label) = amp_cast_inputs("smooth_l1_op", [input, label])
    r = _abs(input - label)
    return torch.where(r < delta, 0.5 * r * r / delta, r - 0.5 * delta)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """The Huber loss of the reference's F.smooth_l1_loss (op
    huber_loss_op): 0.5 r^2 where r = |input - label| <= delta, else
    delta (r - delta / 2)."""
    return _reduce_loss(_huber_loss(input, label, delta=float(delta)),
                        reduction)


@primitive("margin_ranking_loss_op")
def _margin_ranking_loss(input, other, label, margin=0.0):
    return _clip(-label * (input - other) + margin, 0.0)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce_loss(_margin_ranking_loss(input, other, label,
                                             margin=float(margin)),
                        reduction)


@primitive("hinge_embedding_loss_op")
def _hinge_embedding_loss(input, label, margin=1.0):
    return torch.where(label == 1.0, input, _clip(margin - input, 0.0))


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce_loss(_hinge_embedding_loss(input, label,
                                              margin=float(margin)),
                        reduction)


def _log(x):
    (x,) = amp_cast_inputs("log", [x])
    return torch.log(x)


def log_loss(input, label, epsilon=1e-4, name=None):
    """-(y log(p + eps) + (1 - y) log(1 + eps - p)), elementwise."""
    eps = float(epsilon)
    return -(label * _log(input + eps)
             + (1.0 - label) * _log(1.0 + eps - input))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """alpha_t (1 - p_t)^gamma times the sigmoid cross entropy, divided by
    `normalizer`, then the reduction ("sum" by default)."""
    p = sigmoid(logit)
    ce = _bce_with_logits(logit, label)
    p_t = p * label + (1.0 - p) * (1.0 - label)
    a_t = label * alpha + (1.0 - label) * (1.0 - alpha)
    loss = a_t * torch.pow(1.0 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


# ---------------------------------------------------------------------------
# sequences (reference: nn/functional/__init__.py:735, :860)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """mask[..., j] = j < x[...], on x's device, in `dtype`. Without
    `maxlen` the mask is max(x) wide, which reads x on the host (as the
    reference does); with it, nothing is read, so a captured program can
    hold the call."""
    if maxlen is None:
        maxlen = int(x.max())
    r = torch.arange(int(maxlen), device=x.device)
    return (r < x[..., None]).to(convert_dtype(dtype))


def unstack(x, axis=0, num=None):
    """The slices of x along `axis`, as a list (torch.unbind)."""
    if num is not None and num != x.shape[axis]:
        raise ValueError("unstack: num %d, axis of size %d"
                         % (num, x.shape[axis]))
    return list(torch.unbind(x, dim=axis))


@primitive("cosine_similarity_op")
def _cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp_min(n1 * n2, eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """sum(x1 * x2) / max(|x1| |x2|, eps) along `axis` (reference:
    ops/nn_ops.py:716)."""
    return _cosine_similarity(x1, x2, axis=int(axis), eps=float(eps))
