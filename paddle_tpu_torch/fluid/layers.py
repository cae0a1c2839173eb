"""fluid.layers, the legacy functional surface (counterpart of
paddle_tpu/fluid/layers.py): thin delegations to the port's layers,
functionals, tensor ops and the long-tail ops of ops/misc_ops.py.

A layer that makes parameters (fc, embedding, conv2d, batch_norm,
layer_norm) made with a `name` is cached per program (static) or per
process (dygraph), so a second call with the name reuses its weights as
the reference's LayerHelper does; without a name each call makes new
ones. The detection layers (`iou_similarity`, `box_coder`, `yolo_box`,
...) come with `vision.ops`, not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch

from .. import nn as _nn
from .. import tensor as _t
from ..framework import state as _state
from ..nn import functional as F
from ..ops import misc_ops as _misc

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "dropout", "softmax", "relu", "sigmoid", "tanh", "cross_entropy",
    "softmax_with_cross_entropy", "mean", "reduce_sum", "reduce_mean",
    "reduce_max", "reduce_min", "reduce_prod", "matmul", "mul",
    "transpose", "reshape", "squeeze", "unsqueeze", "concat", "split",
    "cast", "fill_constant", "zeros", "ones", "one_hot", "topk",
    "gather", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "accuracy", "data", "sequence_pool", "sequence_conv",
    "sequence_softmax", "l2_normalize", "clip", "pad", "label_smooth",
    "affine_channel", "edit_distance", "ctc_greedy_decoder",
    "continuous_value_model", "center_loss", "squared_l2_distance",
    "teacher_student_sigmoid_loss", "fused_embedding_seq_pool",
    "create_array", "array_write", "array_read", "array_length", "Print",
    "squared_l2_norm", "hinge_loss", "rank_loss", "bpr_loss", "fsp_matrix",
    "pad_constant_like", "shuffle_batch", "conv_shift", "row_conv",
    "correlation", "positive_negative_pair", "filter_by_instag",
    "beam_search", "py_func", "data_norm", "linear_chain_crf", "nce",
]

_PROGRAM_CACHES = weakref.WeakKeyDictionary()
_DYGRAPH_CACHE: Dict[tuple, object] = {}


def _scope_cache():
    if not _state.in_static_mode():
        return _DYGRAPH_CACHE
    from ..static.program import default_main_program
    return _PROGRAM_CACHES.setdefault(default_main_program(), {})


def _cached(name: Optional[str], kind: str, build):
    if name is None:
        return build()
    cache = _scope_cache()
    key = (kind, name)
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _act(out, act):
    return getattr(F, act)(out) if act else out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """A Linear over the trailing dims after num_flatten_dims."""
    in_dim = 1
    for d in input.shape[num_flatten_dims:]:
        in_dim *= int(d)
    lin = _cached(name, "fc", lambda: _nn.Linear(
        in_dim, size, weight_attr=param_attr, bias_attr=bias_attr))
    flat = (_t.flatten(input, num_flatten_dims)
            if input.ndim > num_flatten_dims + 1 else input)
    return _act(lin(flat), act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None):
    """An Embedding(size[0], size[1]); is_sparse gives the table a
    row-sparse gradient in dygraph (nn.Embedding(sparse=True))."""
    emb = _cached(name, "embedding", lambda: _nn.Embedding(
        size[0], size[1], padding_idx=padding_idx, sparse=is_sparse,
        weight_attr=param_attr))
    return emb(input)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    cin = int(input.shape[1 if data_format == "NCHW" else -1])
    conv = _cached(name, "conv2d", lambda: _nn.Conv2D(
        cin, num_filters, filter_size, stride=stride, padding=padding,
        dilation=dilation, groups=groups, weight_attr=param_attr,
        bias_attr=bias_attr, data_format=data_format))
    return _act(conv(input), act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCHW", name=None):
    if global_pooling:
        axes = [2, 3] if data_format == "NCHW" else [1, 2]
        red = _t.max if pool_type == "max" else _t.mean
        return red(input, axis=axes, keepdim=True)
    fn = F.max_pool2d if pool_type == "max" else F.avg_pool2d
    kw = {} if pool_type == "max" else {"exclusive": exclusive}
    return fn(input, kernel_size=pool_size, stride=pool_stride,
              padding=pool_padding, ceil_mode=ceil_mode, **kw)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               is_test=False, name=None):
    cin = int(input.shape[1 if data_layout == "NCHW" else -1])
    bn = _cached(name, "batch_norm", lambda: _nn.BatchNorm2D(
        cin, momentum=momentum, epsilon=epsilon, weight_attr=param_attr,
        bias_attr=bias_attr, data_format=data_layout))
    if is_test:
        bn.eval()
    return _act(bn(input), act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, name=None):
    shape = [int(d) for d in input.shape[begin_norm_axis:]]
    ln = _cached(name, "layer_norm", lambda: _nn.LayerNorm(
        shape, epsilon=epsilon,
        weight_attr=param_attr if scale else False,
        bias_attr=bias_attr if shift else False))
    return ln(input)


def dropout(x, dropout_prob, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", name=None):
    mode = ("downscale_in_infer"
            if dropout_implementation == "downgrade_in_infer"
            else dropout_implementation)
    return F.dropout(x, p=dropout_prob, training=not is_test, mode=mode)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    return _act(_misc.affine_channel(x, scale, bias,
                                     data_layout=data_layout), act)


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    return F.edit_distance(input, label, normalized, ignored_tokens,
                           input_length, label_length)


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    return F.ctc_greedy_decoder(input, blank, input_length, padding_value)


def softmax(input, axis=-1, name=None):
    return F.softmax(input, axis=axis)


def relu(x, name=None):
    return F.relu(x)


def sigmoid(x, name=None):
    return F.sigmoid(x)


def tanh(x, name=None):
    return F.tanh(x)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """The classic cross entropy of PROBABILITIES (after a softmax), not
    of logits: -sum(label log(input + 1e-12)), [..., 1]."""
    eps = 1e-12
    if soft_label:
        return -_t.sum(label * _t.log(input + eps), axis=-1, keepdim=True)
    lab = _t.squeeze(label, -1) if label.ndim == input.ndim else label
    onehot = _t.cast(F.one_hot(lab, input.shape[-1]), input.dtype)
    return -_t.sum(onehot * _t.log(input + eps), axis=-1, keepdim=True)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1):
    return F.softmax_with_cross_entropy(logits, label, soft_label=soft_label,
                                        ignore_index=ignore_index)


def mean(x, name=None):
    return _t.mean(x)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _t.sum(input, axis=dim, keepdim=keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _t.mean(input, axis=dim, keepdim=keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _t.max(input, axis=dim, keepdim=keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _t.min(input, axis=dim, keepdim=keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _t.prod(input, axis=dim, keepdim=keep_dim)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    out = _t.matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)
    return out * alpha if alpha != 1.0 else out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    xf = _t.flatten(x, x_num_col_dims) if x.ndim > x_num_col_dims + 1 else x
    return _t.matmul(xf, y)


def transpose(x, perm, name=None):
    return _t.transpose(x, perm)


def reshape(x, shape, name=None):
    return _t.reshape(x, shape)


def squeeze(input, axes=None, name=None):
    return _t.squeeze(input, axes)


def unsqueeze(input, axes, name=None):
    if isinstance(axes, (list, tuple)):
        out = input
        for a in sorted(axes):
            out = _t.unsqueeze(out, a)
        return out
    return _t.unsqueeze(input, axes)


def concat(input, axis=0, name=None):
    return _t.concat(input, axis=axis)


def split(input, num_or_sections, dim=-1, name=None):
    return _t.split(input, num_or_sections, axis=dim)


def cast(x, dtype):
    return _t.cast(x, dtype)


def fill_constant(shape, dtype, value, name=None):
    return _t.full(shape, value, dtype=dtype)


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0)


def one_hot(input, depth, name=None):
    x = (_t.squeeze(input, -1) if input.ndim > 1
         and int(input.shape[-1]) == 1 else input)
    return F.one_hot(x, depth)


def topk(input, k, name=None):
    return _t.topk(input, k)


def gather(input, index, overwrite=True, name=None):
    return _t.gather(input, index)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _act(x + y, act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _act(x - y, act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _act(x * y, act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _act(x / y, act)


def accuracy(input, label, k=1, name=None):
    from ..metric import accuracy as _acc
    return _acc(input, label, k=k)


def l2_normalize(x, axis=-1, epsilon=1e-12, name=None):
    return F.normalize(x, p=2, axis=axis, epsilon=epsilon)


def clip(x, min, max, name=None):  # noqa: A002
    return _t.clip(x, min, max)


def pad(x, paddings, pad_value=0.0, name=None):
    return F.pad(x, paddings, value=pad_value)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    n = int(label.shape[-1])
    return label * (1.0 - epsilon) + epsilon / n


def sequence_pool(x, pool_type, lengths=None, name=None):
    return F.sequence_pool(x, pool_type, lengths)


def sequence_conv(x, weight, lengths=None, context_length=3,
                  context_start=None, name=None):
    return F.sequence_conv(x, weight, lengths, context_length, context_start)


def sequence_softmax(x, lengths=None, name=None):
    return F.sequence_softmax(x, lengths)


def data(name, shape, dtype="float32", lod_level=0):
    from ..static.program import data as _data
    return _data(name, shape, dtype)


# the CTR and metric-learning long tail (ops/misc_ops.py)


def continuous_value_model(input, cvm, use_cvm=True):  # noqa: A002
    return _misc.cvm(input, cvm, use_cvm=bool(use_cvm))


def center_loss(input, label, num_classes, alpha, centers,  # noqa: A002
                update_center=True):
    """(loss [N, 1], the sample-center differences, the updated centers):
    the caller writes the centers back (the reference's kernel writes its
    Centers var)."""
    return _misc.center_loss(input, label, centers, alpha,
                             cluster_num=int(num_classes),
                             need_update=bool(update_center))


def squared_l2_distance(x, y):
    return _misc.squared_l2_distance(x, y)[1]


def teacher_student_sigmoid_loss(input, label,  # noqa: A002
                                 soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _misc.teacher_student_sigmoid_loss(
        input, label, soft_max_up_bound=float(soft_max_up_bound),
        soft_max_lower_bound=float(soft_max_lower_bound))


def fused_embedding_seq_pool(input, size, ids, lengths=None,  # noqa: A002
                             combiner="sum", padding_idx=-1):
    """`input` is the table [vocab, dim] (its shape checked against
    `size`), ids [B, L] with lengths [B] (all L where None)."""
    if size is not None and tuple(size) != tuple(input.shape):
        raise ValueError("fused_embedding_seq_pool: size %s does not match "
                         "the embedding table shape %s"
                         % (tuple(size), tuple(input.shape)))
    if lengths is None:
        lengths = torch.full((ids.shape[0],), ids.shape[1],
                             dtype=torch.int32, device=ids.device)
    return _misc.fused_embedding_seq_pool(input, ids, lengths,
                                          combiner=combiner,
                                          padding_idx=int(padding_idx))


# the TensorArray family and Print: in dygraph a list, as the reference's
# dygraph branch


def create_array(dtype="float32", initialized_list=None):
    return list(initialized_list or [])


def array_write(x, i, array=None):
    idx = int(i)
    array = [] if array is None else array
    if idx > len(array):
        raise IndexError("array_write index %d beyond array length %d"
                         % (idx, len(array)))
    if idx == len(array):
        array.append(x)
    else:
        array[idx] = x
    return array


def array_read(array, i):
    return array[int(i)]


def array_length(array):
    return torch.tensor([len(array)], dtype=torch.int64)


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002,N802
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=False,
          print_tensor_lod=False, print_phase="both"):
    """Print the values now (summarize < 0: all of them) and return the
    input."""
    head = message or "Print"
    if print_tensor_shape:
        head += " shape=%s" % (tuple(input.shape),)
    if print_tensor_type:
        head += " dtype=%s" % (input.dtype,)
    flat = input.detach().reshape(-1).cpu()
    n = flat.numel() if summarize is None or summarize < 0 \
        else min(int(summarize), flat.numel())
    print("%s value=%s" % (head, flat[:n].numpy()))
    return input


def _seed(seed):
    """An explicit seed, else one drawn from torch's generator (which
    paddle.seed sets): the key input of shuffle_batch and nce."""
    if seed is not None:
        return int(seed)
    return int(torch.randint(0, 2 ** 62, (1,)))


def squared_l2_norm(x):
    return _misc.squared_l2_norm(x)


def hinge_loss(input, label):  # noqa: A002
    return _misc.hinge_loss(input, label)


def rank_loss(label, left, right, name=None):
    return _misc.rank_loss(label, left, right)


def bpr_loss(input, label, name=None):  # noqa: A002
    return _misc.bpr_loss(input, label)


def fsp_matrix(x, y):
    return _misc.fsp_matrix(x, y)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _misc.pad_constant_like(x, y, pad_value=float(pad_value))


def shuffle_batch(x, seed=None):
    """(x's rows permuted, the permutation), drawn from `seed` or from
    torch's generator."""
    return _misc.shuffle_batch(x, _seed(seed))


def conv_shift(x, y, name=None):
    return _misc.conv_shift(x, y)


def row_conv(input, future_context_size=None, filter=None, name=None):  # noqa: A002
    """Dense [B, T, D] form; the caller passes the [future_len, D]
    filter."""
    if filter is None:
        raise ValueError("row_conv: pass the [future_len, D] filter tensor")
    return _misc.row_conv(input, filter)


def correlation(x1, x2, max_displacement=4, pad_size=4, name=None):
    return _misc.correlation(x1, x2, max_displacement=int(max_displacement),
                             pad_size=int(pad_size))


def positive_negative_pair(score, label, query_id):
    return _misc.positive_negative_pair(score, label, query_id)


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0):
    return _misc.filter_by_instag(ins, ins_tag, filter_tag,
                                  out_val_if_empty=int(out_val_if_empty))


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=True):
    """One dense-layout beam step (ops/misc_ops.py beam_search_step);
    `ids` is taken for the signature and unused."""
    token, total, parent = _misc.beam_search_step(
        pre_ids, pre_scores, scores, beam_size=int(beam_size),
        end_id=int(end_id), is_accumulated=bool(is_accumulated))
    return (token, total, parent) if return_parent_idx else (token, total)


def py_func(func, x, out_shape, out_dtype="float32"):
    return _misc.py_func_call(x, func=func,
                              out_shape=tuple(int(s) for s in out_shape),
                              out_dtype=str(out_dtype))


def data_norm(input, batch_size, batch_sum, batch_square_sum,  # noqa: A002
              epsilon=1e-4, name=None):
    return _misc.data_norm(input, batch_size, batch_sum, batch_square_sum,
                           epsilon=float(epsilon))


def linear_chain_crf(input, transition, label, length, name=None):  # noqa: A002
    return _misc.linear_chain_crf(input, transition, label, length)


def nce(input, label, num_total_classes, weight, bias=None,  # noqa: A002
        num_neg_samples=5, name=None, sampler="uniform",
        custom_dist=None, seed=None):
    """The dense-weight form (the caller owns weight and bias), the
    uniform sampler only."""
    if sampler != "uniform" or custom_dist is not None:
        raise NotImplementedError("nce: only the uniform sampler is "
                                  "implemented")
    if bias is None:
        bias = torch.zeros(int(num_total_classes), dtype=torch.float32,
                           device=input.device)
    return _misc.nce(input, weight, bias, label, _seed(seed),
                     num_neg_samples=int(num_neg_samples),
                     num_total_classes=int(num_total_classes))
