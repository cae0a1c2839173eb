"""Functional ops (counterpart of paddle_tpu/nn/functional and the
primitives in paddle_tpu/ops/nn_ops.py): every public function of the
reference's nn.functional. The ops GPT, BERT, ResNet and the Transformer
reach, the activations and the losses are registered here; the second
part's (transposed convolutions, norms, resampling, pads, CTC, ...) in
ops/nn_ops.py, and the sequence ops in functional_sequence.py (bound as
`sequence`).

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
from ..ops import manipulation as _manip
from ..ops import nn_ops as _nn
from ..tensor import (add, cast, clip, equal, maximum, mean, not_equal,
                      reshape, squeeze, where)

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
    x cast to `dtype` first when one is given (op cast)."""
    if dtype is not None:
        x = cast(x, dtype)
    return _softmax(x, axis=int(axis))


@primitive("log_softmax_op")
def _log_softmax(x, axis=-1):
    (x,) = amp_cast_inputs("log_softmax_op", [x])
    return torch.log_softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    """log-softmax along `axis` (reference: ops/nn_ops.py:170,
    log_softmax_op), x cast to `dtype` first when one is given (op
    cast)."""
    if dtype is not None:
        x = cast(x, dtype)
    return _log_softmax(x, axis=int(axis))


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
    if device.type == "meta":            # a static program's shapes
        return torch.empty(shape, dtype=torch.bool, device=device)
    u = torch.rand(shape, generator=RNG.cpu, device=device)
    return u >= p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """paddle's dropout (reference: nn/functional dropout, ops/nn_ops.py
    _dropout). upscale_in_train: kept values scaled by 1/(1-p) in
    training, the identity in eval. downscale_in_infer: kept values as
    they are in training, x * (1-p) in eval. The mask is drawn by `_keep`
    (framework/random.py's Philox word on CUDA, its CPU generator on the
    CPU), so it is not the reference's jax.random mask. `axis` (an int or
    a list): one draw for each index along those axes, shared by the rest,
    as in paddle (the reference takes `axis` and drops single elements)."""
    if mode not in ck.DROPOUT_MODES:
        raise ValueError("dropout mode %r (one of %s)" % (mode,
                                                          ck.DROPOUT_MODES))
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * torch.zeros_like(x)
    if axis is not None:
        axis = tuple(sorted(int(a) % x.ndim for a in (
            axis if isinstance(axis, (list, tuple)) else [axis])))
    return _dropout(x, None, p=float(p), mode=mode, axis=axis)


@primitive("dropout_op", out_like=0)
def _dropout(x, key=None, p=0.5, mode="upscale_in_train", axis=None):
    """The random branch of `dropout`: a fresh keep mask at each call (in a
    program, at each run). `key` is the reference's PRNG key input, taken
    and ignored: the mask comes from `_keep`. `axis`: the mask has x's
    size on those axes and 1 on the others."""
    shape = x.shape if axis is None else tuple(
        x.shape[i] if i in axis else 1 for i in range(x.ndim))
    keep = _keep(shape, p, x.device)
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
    Tq, Tk = query.shape[2], key.shape[2]
    thr = flag("sdpa_chunked_threshold")
    chunked = bool(not return_weights and thr and Tk >= thr
                   and attn_mask is None and p < 1.0
                   and (not is_causal or Tq == Tk))
    return _sdpa(query, key, value, attn_mask, None, dropout_p=p,
                 causal=bool(is_causal), return_weights=bool(return_weights),
                 chunked=chunked)


@primitive("scaled_dot_product_attention")
def _sdpa(q, k, v, mask, key=None, dropout_p=0.0, causal=False,
          return_weights=False, chunked=False):
    """The op of attention's plain routes (reference: ops/nn_ops.py sdpa
    :853): the blockwise tier when `chunked`, else the dense plain
    version. `key` is the reference's PRNG key input, taken and ignored:
    the dropout mask comes from `_keep`."""
    counted = q.device.type != "meta"      # not a static program's shapes
    if chunked:
        if counted:
            ck._note_attn_path("xla_chunked")
        return blockwise_attention(q, k, v, bool(causal), dropout_p=dropout_p)
    if counted:
        ck._note_attn_path("xla_sdpa")
    B, H, Tq, _ = q.shape
    keep = (_keep((B, H, Tq, k.shape[2]), dropout_p, q.device)
            if dropout_p > 0.0 else None)
    return ck.flash_attention_plain(q, k, v, bool(causal), mask, keep=keep,
                                    dropout_p=dropout_p,
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
        lab = reshape(label, loss.shape)
        w = where(equal(lab, ignore_index), 0.0,
                  embedding(clip(lab, 0), weight))
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum()
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if ignore_index >= 0 and not soft_label:
        valid = cast(not_equal(reshape(label, loss.shape), ignore_index),
                     input.dtype)
        return loss.sum() / maximum(valid.sum(), 1e-8)
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
    return _nn.lookup_rows(weight, ids, padding_idx)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids `x` (op lookup_table_v2, reference:
    ops/nn_ops.py :599); rows at `padding_idx` come back zero. `sparse`:
    in dygraph the table's gradient is row-sparse (op
    lookup_table_v2_sparse; `weight.grad` reads as a SelectedRows); a
    static program records the dense op, as the reference's does."""
    attrs = {} if padding_idx is None else {"padding_idx": int(padding_idx)}
    if sparse and not staging():
        return _nn.embedding_lookup_sparse(weight, x, **attrs)
    return _lookup(weight, x, **attrs)


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


_pad = _nn.pad_pairs


def _symmetric(pairs):
    return all(lo == hi and lo >= 0 for lo, hi in pairs)


def _conv_direct(x, w, stride, pairs, dilation, groups):
    conv = getattr(torch.nn.functional, "conv%dd" % (x.ndim - 2))
    if _symmetric(pairs):
        return conv(x, w, None, stride, [lo for lo, _ in pairs], dilation,
                    groups)
    return conv(_pad(x, pairs), w, None, stride, 0, dilation, groups)


def _conv_im2col(x, w, stride, pairs, dilation):
    """The reference's `_conv_im2col` (ops/nn_ops.py:199): the patches,
    then one matmul over (cin * prod(kernel)) taps with a float32 result
    (its preferred_element_type), rounded back to x's dtype unless x is
    bfloat16."""
    p = _nn.patches(x, tuple(w.shape[2:]), stride, pairs, dilation)
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


@primitive("batch_norm_train")
def batch_norm_train(x, weight, bias, epsilon=1e-5, channel_last=False):
    """Training batch norm (reference: ops/nn_ops.py :474): (y, batch
    mean, biased batch variance); the caller moves the running
    statistics."""
    return _bn_batch(x, weight, bias, epsilon, channel_last)


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
    y, mean, var = batch_norm_train(x, weight, bias, epsilon=float(epsilon),
                                    channel_last=channel_last)
    if running_mean is not None:
        m = float(momentum)
        with torch.no_grad():
            _set_running(running_mean,
                         _moved(_running(running_mean), mean, m))
            _set_running(running_var, _moved(_running(running_var), var, m))
    return y


# ---------------------------------------------------------------------------
# pooling (reference: nn/functional/__init__.py:209-400 over ops/nn_ops.py
# pool :339, adaptive_pool :400 and max_pool2d_with_index :1003)


def _ceil_extend(in_sp, ks, st, pairs):
    """paddle's ceil_mode: the high padding extended so that the trailing
    partial window counts."""
    ext = []
    for size, k, s, (lo, hi) in zip(in_sp, ks, st, pairs):
        padded = size + lo + hi
        out = -(-(padded - k) // s) + 1
        ext.append((lo, hi + max((out - 1) * s + k - padded, 0)))
    return tuple(ext)


def _window_sums(x, ks, st):
    """Sums over each window of an NC* tensor (no padding)."""
    F = torch.nn.functional
    if x.ndim == 3:
        return F.avg_pool2d(x[:, :, None], (1,) + ks, (1,) + st,
                            divisor_override=1)[:, :, 0]
    pool = F.avg_pool2d if x.ndim == 4 else F.avg_pool3d
    return pool(x, ks, st, divisor_override=1)


def _window_max(x, ks, st):
    F = torch.nn.functional
    if x.ndim == 3:
        return F.max_pool2d(x[:, :, None], (1,) + ks, (1,) + st)[:, :, 0]
    return (F.max_pool2d if x.ndim == 4 else F.max_pool3d)(x, ks, st)


def _pool_cfg(sp, kernel, stride, padding, ceil_mode):
    """(kernel, stride, (lo, hi) pairs) of a pool over the spatial sizes
    `sp`, the padding resolved as the reference resolves it (SAME, VALID,
    pairs; ceil_mode extends the high side)."""
    n = len(sp)
    ks = _pair(kernel, n)
    st = _pair(stride if stride is not None else kernel, n)
    pad = _norm_padding(padding, n)
    if pad == "VALID":
        pairs = ((0, 0),) * n
    elif pad == "SAME":
        pairs = _same_pairs(sp, ks, st)
    else:
        pairs = tuple(tuple(p) for p in pad)
    if ceil_mode:
        pairs = _ceil_extend(sp, ks, st, pairs)
    return ks, st, pairs


def _pool(x, ptype, kernel, stride, padding, ceil_mode, exclusive,
          channel_last, divisor=None):
    """ops/nn_ops.py pool over N C *sp (or N *sp C), any spatial rank:
    the padding resolved as the reference resolves it (SAME, VALID, pairs;
    ceil_mode extends the high side), max over -inf padding, avg as window
    sums divided by the count of input elements in each window
    (exclusive), by the window's size, or by `divisor`."""
    n = x.ndim - 2
    if channel_last:
        x = x.movedim(-1, 1)
    sp = tuple(x.shape[2:])
    ks, st, pairs = _pool_cfg(sp, kernel, stride, padding, ceil_mode)
    if ptype == "max":
        if (n == 2 and _symmetric(pairs)
                and all(lo <= k // 2 for (lo, _), k in zip(pairs, ks))):
            out = torch.nn.functional.max_pool2d(x, ks, st,
                                                 [lo for lo, _ in pairs])
        else:
            low = (float("-inf") if x.is_floating_point()
                   else torch.iinfo(x.dtype).min)
            out = _window_max(_pad(x, pairs, low), ks, st)
    else:
        out = _window_sums(_pad(x, pairs), ks, st)
        if divisor is not None:
            out = out / float(divisor)
        elif exclusive:
            ones = torch.ones((1, 1) + sp, dtype=out.dtype, device=x.device)
            count = _window_sums(_pad(ones, pairs), ks, st)
            out = out / count.clamp_min(1)
        else:
            out = out / float(np.prod(ks))
    return out.movedim(1, -1) if channel_last else out


@primitive("pool2d_op")
def _pool_op(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
             padding=(0, 0), ceil_mode=False, exclusive=True,
             channel_last=False, divisor_override=None):
    """The reference's pool2d_op (ops/nn_ops.py pool :338), any spatial
    rank. `divisor_override` is the port's: paddle's avg_pool2d/3d take
    it, the reference's ignore it."""
    return _pool(x, pool_type, kernel, stride, padding, ceil_mode,
                 exclusive, channel_last, divisor_override)


def _pool_call(x, ptype, kernel_size, stride, padding, ceil_mode, exclusive,
               data_format, n, divisor_override=None):
    kernel = _pair(kernel_size, n)
    extra = ({} if divisor_override is None
             else {"divisor_override": float(divisor_override)})
    return _pool_op(
        x, pool_type=ptype, kernel=kernel,
        stride=_pair(stride, n) if stride is not None else kernel,
        padding=_norm_padding(padding, n), ceil_mode=bool(ceil_mode),
        exclusive=bool(exclusive),
        channel_last=data_format[-1] == "C" and len(data_format) > 2,
        **extra)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, name=None):
    """Max pool over [N, C, L] (`return_mask` taken and ignored, as the
    reference does)."""
    return _pool_call(x, "max", kernel_size, stride, padding, ceil_mode,
                      True, "NCL", 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Max pool; the gradient goes to the first maximum of a window in
    row-major order, as XLA's select-and-scatter (>=) sends it. With
    return_mask (NCHW only), (values, the flat h * W + w index of each
    window's first maximum) through op max_pool2d_with_index."""
    if return_mask:
        if data_format != "NCHW":
            raise ValueError("return_mask requires NCHW")
        ks, st, pairs = _pool_cfg(tuple(x.shape[2:]), kernel_size, stride,
                                  padding, ceil_mode)
        return _nn.max_pool2d_with_index(x, kernel=ks, stride=st,
                                         padding=pairs)
    return _pool_call(x, "max", kernel_size, stride, padding, ceil_mode,
                      True, data_format, 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    return _pool_call(x, "max", kernel_size, stride, padding, ceil_mode,
                      True, data_format, 3)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool_call(x, "avg", kernel_size, stride, padding, ceil_mode,
                      exclusive, "NCL", 1)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Average pool; `divisor_override` divides each window's sum by
    itself, as paddle's does (the reference takes it and ignores it)."""
    return _pool_call(x, "avg", kernel_size, stride, padding, ceil_mode,
                      exclusive, data_format, 2, divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_call(x, "avg", kernel_size, stride, padding, ceil_mode,
                      exclusive, data_format, 3, divisor_override)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """The inverse of max_pool2d(return_mask=True): each value written at
    its index of an output plane of zeros (op max_unpool2d_op). Its size is
    `output_size`, else (in - 1) * stride - pads + kernel. Eagerly (not in
    a static program or a capture) an index outside the plane raises, as
    the reference's eager check does."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d supports NCHW only")
    oh, ow = x.shape[2], x.shape[3]
    if output_size is None:
        ks = _pair(kernel_size, 2)
        st = _pair(stride if stride is not None else kernel_size, 2)
        pad = _norm_padding(padding, 2)
        if isinstance(pad, str):
            raise ValueError("max_unpool2d with SAME/VALID padding needs an "
                             "explicit output_size (the inverse shape is "
                             "ambiguous)")
        out_h = (oh - 1) * st[0] - (pad[0][0] + pad[0][1]) + ks[0]
        out_w = (ow - 1) * st[1] - (pad[1][0] + pad[1][1]) + ks[1]
    else:
        out_h, out_w = [int(v) for v in output_size[-2:]]
    from ..static.program import Variable
    if not isinstance(indices, Variable) and not (
            indices.is_cuda and torch.cuda.is_current_stream_capturing()):
        mx = int(indices.max()) if indices.numel() else 0
        if mx >= out_h * out_w:
            raise ValueError("max_unpool2d: index %d out of range for output "
                             "%dx%d: output_size smaller than the pooled "
                             "input" % (mx, out_h, out_w))
    return _nn.max_unpool2d(x, indices, out_h=int(out_h), out_w=int(out_w))


def _adp_size(v, n):
    if isinstance(v, (int, np.integer)) or v is None:
        return (v if v is None else int(v),) * n
    return tuple(None if s is None else int(s) for s in v)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size=_adp_size(output_size, 1),
                          pool_type="avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """ops/nn_ops.py adaptive_pool: axis by axis, a mean over equal blocks
    where the size divides, else over the buckets [floor(i * in / out),
    ceil((i + 1) * in / out)); an output size of None keeps the axis."""
    return _adaptive_pool(
        x, output_size=_adp_size(output_size, 2), pool_type="avg",
        channel_last=data_format[-1] == "C" and len(data_format) > 2)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(
        x, output_size=_adp_size(output_size, 3), pool_type="avg",
        channel_last=data_format[-1] == "C" and len(data_format) > 2)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """The max over each bucket (`return_mask` taken and ignored, as the
    reference does)."""
    return _adaptive_pool(x, output_size=_adp_size(output_size, 1),
                          pool_type="max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size=_adp_size(output_size, 2),
                          pool_type="max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size=_adp_size(output_size, 3),
                          pool_type="max")


@primitive("adaptive_pool2d_op")
def _adaptive_pool(x, output_size, pool_type="avg", channel_last=False):
    """The reference's adaptive_pool2d_op (ops/nn_ops.py :399), any
    spatial rank, mean or max (a max shares the gradient between tied
    elements, as jnp.max's does)."""
    n = x.ndim - 2
    axes = tuple(range(1, 1 + n)) if channel_last else tuple(range(2, 2 + n))
    red = ((lambda t, d, keep=False: t.mean(dim=d, keepdim=keep))
           if pool_type == "avg"
           else (lambda t, d, keep=False: t.amax(dim=d, keepdim=keep)))
    out = x
    for ax, out_s in zip(axes, tuple(output_size)):
        in_s = out.shape[ax]
        if out_s is None or out_s == in_s:
            continue
        out_s = int(out_s)
        if in_s % out_s == 0:
            shape = (tuple(out.shape[:ax]) + (out_s, in_s // out_s)
                     + tuple(out.shape[ax + 1:]))
            out = red(out.reshape(shape), ax + 1)
        else:
            starts = (np.arange(out_s) * in_s) // out_s
            ends = ((np.arange(out_s) + 1) * in_s + out_s - 1) // out_s
            out = torch.cat([red(out.narrow(ax, int(a), int(b - a)), ax,
                                 True)
                             for a, b in zip(starts, ends)], dim=ax)
    return out


# ---------------------------------------------------------------------------
# activations (reference: nn/functional/__init__.py:17-84 over ops/nn_ops.py
# :21-157). Each is the reference's formula with the same tie rules: a
# clip is min(max(x, lo), hi), whose gradient at lo or hi is 1/2 as
# jnp.clip's is (torch.clamp's is 1); a where() keeps its branch's
# gradient.

_clip = _nn.clip_ties


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
    """|input - label| (op abs, as the reference's), then the
    reduction."""
    return _reduce_loss(_math.abs_(input - label), reduction)


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


# ---------------------------------------------------------------------------
# the second part of nn (reference: nn/functional/__init__.py:172-208,
# :461-511, :686-996), over ops/nn_ops.py


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL", name=None, output_size=None):
    return _convnd_t(x, weight, bias, stride, padding, output_padding,
                     dilation, groups, data_format, output_size, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW", name=None, output_size=None):
    """The transposed convolution, weight [in, out / groups, *k] (op
    conv2d_transpose_op, any spatial rank), then the bias in the layout's
    channel axis. `output_size` (the spatial sizes) sets the
    output_padding that reaches it, as paddle's does (the reference takes
    it and ignores it); it must lie within one stride of the size without
    it."""
    return _convnd_t(x, weight, bias, stride, padding, output_padding,
                     dilation, groups, data_format, output_size, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW", name=None, output_size=None):
    return _convnd_t(x, weight, bias, stride, padding, output_padding,
                     dilation, groups, data_format, output_size, 3)


def _convnd_t(x, weight, bias, stride, padding, output_padding, dilation,
              groups, data_format, output_size, n):
    channel_last = data_format[-1] == "C" and len(data_format) > 2
    pad = _norm_padding(padding, n)
    if isinstance(pad, str):
        raise ValueError("SAME/VALID not supported for conv_transpose")
    st, dil = _pair(stride, n), _pair(dilation, n)
    outpad = _pair(output_padding, n)
    if output_size is not None:
        sizes = _pair(output_size, n) if not isinstance(
            output_size, (list, tuple)) else tuple(
                int(s) for s in output_size)[-n:]
        sp = x.shape[1:1 + n] if channel_last else x.shape[2:2 + n]
        k = weight.shape[2:]
        outpad = []
        for i in range(n):
            # the size without output_padding
            base = ((sp[i] - 1) * st[i] - pad[i][0] - pad[i][1]
                    + dil[i] * (k[i] - 1) + 1)
            extra = sizes[i] - base
            if not 0 <= extra < max(st[i], dil[i]):
                raise ValueError(
                    "conv_transpose output_size %s: axis %d can be %d to "
                    "%d" % (tuple(sizes), i, base,
                            base + max(st[i], dil[i]) - 1))
            outpad.append(extra)
        outpad = tuple(outpad)
    out = _nn.conv_transpose(x, weight, stride=st, padding=pad,
                             output_padding=outpad, dilation=dil,
                             groups=int(groups), channel_last=channel_last)
    if bias is not None:
        shape = ((1,) * (n + 1) + (-1,)) if channel_last \
            else ((1, -1) + (1,) * n)
        out = add(out, reshape(bias, shape))
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channels normalised over their spatial axes (op
    instance_norm_op); the running statistics are taken and not used, as
    the reference's are."""
    return _nn.instance_norm(x, weight, bias, epsilon=float(eps))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    return _nn.group_norm(
        x, weight, bias, num_groups=int(num_groups), epsilon=float(epsilon),
        channel_last=data_format[-1] == "C" and len(data_format) > 2)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    return _nn.local_response_norm(x, size=int(size), alpha=float(alpha),
                                   beta=float(beta), k=float(k))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p, epsilon) along `axis` (op l2_normalize_op)."""
    return _nn.normalize(x, p=float(p), axis=int(axis),
                         epsilon=float(epsilon))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: one keep draw for each (sample, channel),
    the mask [N, C, 1, 1] (NHWC: [N, 1, 1, C]), as paddle's. The
    reference drops single elements (it calls dropout with no axis)."""
    return dropout(x, p, axis=[0, 3] if data_format == "NHWC" else [0, 1],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Whole channels dropped, the mask [N, C, 1, 1, 1] (NDHWC: [N, 1, 1,
    1, C]); see dropout2d."""
    return dropout(x, p, axis=[0, 4] if data_format == "NDHWC" else [0, 1],
                   training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout (op alpha_dropout_op); the identity in eval or at
    p = 0."""
    if not training or p == 0.0:
        return x
    return _nn.alpha_dropout(x, None, p=float(p))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    return _nn.gumbel_softmax(x, None, temperature=float(temperature),
                              hard=bool(hard), axis=int(axis))


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """Matrices whose `offset` diagonal (dims dim1, dim2) holds the last
    axis of x (op diag_embed)."""
    from ..ops.creation import diag_embed as _de
    return _de(x, offset=int(offset), dim1=int(dim1), dim2=int(dim2))


# the reference's in-place names: its tensors are values, so these are
# the functions themselves (nn/functional/__init__.py:985-989)
relu_ = relu
elu_ = elu
softmax_ = softmax


def bilinear(x1, x2, weight, bias=None, name=None):
    """x1ᵀ W[o] x2 (+ bias) for each output o (op bilinear_op)."""
    return _nn.bilinear(x1, x2, weight, bias)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """The hierarchical sigmoid loss [B, 1] (op hsigmoid_loss_op)."""
    return _nn.hsigmoid_loss(input, label, weight, bias, path_table,
                             path_code, num_classes=int(num_classes))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Sliding blocks [N, C * kh * kw, L] (op unfold_op)."""
    return _nn.unfold(x, kernel_sizes=_pair(kernel_sizes, 2),
                      strides=_pair(strides, 2), paddings=_pair(paddings, 2),
                      dilations=_pair(dilations, 2))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes (op interp_op, jax.image.resize's sampling:
    see ops/nn_ops.py `interp`). A `scale_factor` becomes the size
    int(in * factor), and the sampling follows that size, as in the
    reference; `align_mode` is taken and ignored, as there."""
    channel_last = data_format[-1] == "C" and len(data_format) > 2
    nsp = x.ndim - 2
    if size is None:
        sf = (list(scale_factor) if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * nsp)
        sp = x.shape[1:-1] if channel_last else x.shape[2:]
        size = [int(s * f) for s, f in zip(sp, sf)]
    elif isinstance(size, torch.Tensor):
        size = [int(s) for s in size.reshape(-1).tolist()]
    else:
        size = [int(s) for s in (size if isinstance(size, (list, tuple))
                                 else [size])]
    return _nn.interp(x, size=tuple(size), mode=mode,
                      align_corners=bool(align_corners),
                      channel_last=channel_last)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _nn.pixel_shuffle(x, upscale_factor=int(upscale_factor),
                             channel_last=data_format == "NHWC")


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _nn.pixel_unshuffle(x, downscale_factor=int(downscale_factor),
                               channel_last=data_format == "NHWC")


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    return _nn.channel_shuffle(x, groups=int(groups),
                               channel_last=data_format == "NHWC")


# paddle's F.pad (op pad3d_op): constant, reflect, replicate or circular
pad = _manip.pad


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zeros around H and W by (left, right, top, bottom) (op
    pad2d_zero_op)."""
    return _nn.zero_pad(x, padding=tuple(int(p) for p in padding),
                        channel_last=data_format == "NHWC")


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM's shift over [N * T, C, H, W]: the first C * ratio channels move
    one segment back in time, the next as many one forward, zeros where
    nothing arrives; the rest stay."""
    nt, c, h, w = x.shape
    n = nt // seg_num
    data = reshape(x, (n, seg_num, c, h, w))
    c1 = int(c * shift_ratio)
    zero = torch.zeros_like(data[:, :1, :c1])
    left = torch.cat([data[:, 1:, :c1], zero], dim=1)
    right = torch.cat([torch.zeros_like(data[:, :1, c1:2 * c1]),
                       data[:, :-1, c1:2 * c1]], dim=1)
    out = torch.cat([left, right, data[:, :, 2 * c1:]], dim=2)
    return reshape(out, (nt, c, h, w))


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC loss of [T, B, C] scores (log-softmax taken here) against padded
    labels [B, L] (op warpctc); "mean" divides each sample's loss by its
    label length (at least 1), then averages, as paddle and the reference
    do; norm_by_times divides by the input lengths first."""
    lp = log_softmax(log_probs, axis=-1)
    nll = _nn.ctc_loss(lp, labels, input_lengths, label_lengths,
                       blank=int(blank))
    if norm_by_times:
        nll = nll / cast(input_lengths, nll.dtype)
    if reduction == "mean":
        denom = maximum(cast(label_lengths, nll.dtype), 1.0)
        return mean(nll / denom)
    return _reduce_loss(nll, reduction)


def ctc_align(x, input_length, blank=0, merge_repeated=True, padding_value=0,
              name=None):
    """Merge repeats, then drop blanks (op ctc_align_op): ([B, T], the
    counts [B, 1])."""
    return _nn.ctc_align(x, input_length, blank=int(blank),
                         merge_repeated=bool(merge_repeated),
                         padding_value=int(padding_value))


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """The best path of [B, T, C] probabilities: the argmax of each step,
    then ctc_align."""
    idx = _math.argmax(input, axis=-1)
    if input_length is None:
        B, T = input.shape[0], input.shape[1]
        input_length = torch.full((B, 1), T, dtype=torch.int64,
                                  device=input.device)
    return ctc_align(idx, input_length, blank=blank,
                     padding_value=padding_value)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """The Levenshtein distance of each row, on the host as the reference
    computes it: (distance [B, 1] float32, sequence count [1] float32);
    normalized divides by the reference's length (an empty one raises).
    It reads the tokens on the host, so it refuses a CUDA graph
    capture."""
    from ..ops.math import no_capture
    no_capture("edit_distance")
    host = lambda t: None if t is None else t.detach().cpu().numpy()  # noqa
    hyp, ref = host(input), host(label)
    B = hyp.shape[0]
    hyp_len = (np.full((B,), hyp.shape[1], np.int64) if input_length is None
               else host(input_length).reshape(B).astype(np.int64))
    ref_len = (np.full((B,), ref.shape[1], np.int64) if label_length is None
               else host(label_length).reshape(B).astype(np.int64))
    ignored = set(ignored_tokens) if ignored_tokens else None
    out = np.zeros((B, 1), np.float32)
    for b in range(B):
        h = [v for v in hyp[b][:hyp_len[b]] if not ignored or v not in ignored]
        r = [v for v in ref[b][:ref_len[b]] if not ignored or v not in ignored]
        row = np.arange(len(r) + 1, dtype=np.int64)
        for i in range(1, len(h) + 1):
            diag, row[0] = row[0], i
            for j in range(1, len(r) + 1):
                cur = min(row[j] + 1, row[j - 1] + 1,
                          diag + (h[i - 1] != r[j - 1]))
                diag, row[j] = row[j], cur
        d = float(row[len(r)])
        if normalized:
            if not r:
                raise ValueError("edit_distance: empty reference with "
                                 "normalized=True (division by zero)")
            d /= len(r)
        out[b, 0] = d
    dev = input.device
    return (torch.from_numpy(out).to(dev),
            torch.tensor([B], dtype=torch.float32, device=dev))


def gather_tree(ids, parents):
    """Beam-search backtrace [T, B, W] (op gather_tree_op)."""
    return _nn.gather_tree(ids, parents)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over a CSR pattern (q/k/v [B, H, M, D], offsets [B, H,
    M + 1], columns [B, H, nnz]): the pattern becomes an additive mask (0
    where kept, -1e30 elsewhere), `attn_mask` ([M, M], 0 drops) ANDed in
    and `key_padding_mask` ([B, M]) added, then op masked_sdpa (a row
    with no kept key gives zeros), as in the reference. The mask is built
    on the device from the pattern, with no host read."""
    B, H, M, _ = query.shape
    offs = sparse_csr_offset.long()
    cols = sparse_csr_columns.long()
    nnz = cols.shape[-1]
    idx = torch.arange(nnz, device=query.device)
    rows = torch.searchsorted(offs[..., 1:].contiguous(),
                              idx.expand(B, H, nnz).contiguous(),
                              right=True)
    valid = idx < (offs[..., -1:] - offs[..., :1])
    flat = (rows.clamp(max=M - 1) * M + cols.clamp(0, M - 1))
    hits = torch.zeros((B, H, M * M), dtype=torch.int32, device=query.device)
    hits = hits.scatter_add(2, torch.where(valid, flat, 0),
                            valid.to(torch.int32))
    keep = (hits > 0).reshape(B, H, M, M)
    if attn_mask is not None:
        keep = keep & (attn_mask != 0)[None, None]
    add_mask = torch.where(keep, 0.0, -1e30).to(query.dtype)
    if key_padding_mask is not None:
        add_mask = add_mask + key_padding_mask.to(query.dtype)[:, None,
                                                                None, :]
    return _nn.masked_sdpa(query, key, value, add_mask)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """The ArcFace-family loss on one process (op margin_cross_entropy_op);
    `group` (the sharded classifier) waits for the distributed queue."""
    if group is not None:
        raise NotImplementedError("margin_cross_entropy(group=...): the "
                                  "sharded classifier is not ported")
    out = _nn.margin_cross_entropy(logits, label, margin1=float(margin1),
                                   margin2=float(margin2),
                                   margin3=float(margin3),
                                   scale=float(scale),
                                   return_softmax=bool(return_softmax))
    loss, soft = out if return_softmax else (out, None)
    if reduction == "mean":
        loss = mean(loss)
    elif reduction == "sum":
        loss = loss.sum()
    return (loss, soft) if return_softmax else loss


def class_center_sample(label, num_classes, num_samples, group=None):
    """The positive classes plus uniform negatives up to `num_samples`, on
    the host as the reference samples them: (the labels remapped into the
    sampled set, the sampled class ids, sorted). The negatives come from
    the CPU generator (framework.random), not the reference's key. It
    reads the labels on the host, so it refuses a CUDA graph capture."""
    from ..ops.math import no_capture
    no_capture("class_center_sample")
    if group is not None:
        raise NotImplementedError("class_center_sample(group=...): the "
                                  "sharded classifier is not ported")
    lab = label.detach().cpu().numpy().astype(np.int64).reshape(-1)
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        pool = np.setdiff1d(np.arange(num_classes, dtype=np.int64), pos)
        need = min(num_samples - len(pos), len(pool))
        pick = torch.randperm(len(pool), generator=RNG.cpu)[:need].numpy()
        sampled = np.sort(np.concatenate([pos, pool[pick]]))
    remap = np.searchsorted(sampled, lab)
    dev = label.device
    return (torch.from_numpy(remap.astype(np.int64)).to(dev),
            torch.from_numpy(sampled.astype(np.int64)).to(dev))


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The [N, H, W, 2] sampling grid of [N, 2, 3] affines (op
    affine_grid_op); 4-D out_shape only, as in the reference."""
    out_shape = [int(s) for s in (out_shape.tolist() if isinstance(
        out_shape, torch.Tensor) else out_shape)]
    if len(out_shape) != 4:
        raise NotImplementedError("affine_grid supports 4-D out_shape [N, C, "
                                  "H, W] (got %d dims)" % len(out_shape))
    return _nn.affine_grid(theta, out_h=out_shape[2], out_w=out_shape[3],
                           align_corners=bool(align_corners))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return _nn.grid_sample(x, grid, mode=mode, padding_mode=padding_mode,
                           align_corners=bool(align_corners))


from . import functional_sequence as sequence  # noqa: E402
from .functional_sequence import (sequence_concat, sequence_conv,  # noqa
                                  sequence_enumerate, sequence_erase,
                                  sequence_expand, sequence_expand_as,
                                  sequence_pad, sequence_pool,
                                  sequence_reshape, sequence_reverse,
                                  sequence_scatter, sequence_slice,
                                  sequence_softmax, sequence_unpad)

__all__ += [
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "max_pool1d", "max_pool3d", "avg_pool1d", "avg_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d", "max_unpool2d",
    "instance_norm", "group_norm", "local_response_norm", "normalize",
    "dropout2d", "dropout3d", "alpha_dropout", "gumbel_softmax",
    "diag_embed", "relu_", "elu_", "softmax_", "bilinear", "hsigmoid_loss",
    "unfold", "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
    "channel_shuffle", "pad", "zeropad2d", "temporal_shift", "ctc_loss",
    "ctc_align", "ctc_greedy_decoder", "edit_distance", "gather_tree",
    "sparse_attention", "margin_cross_entropy", "class_center_sample",
    "affine_grid", "grid_sample", "sequence"] + sequence.__all__
