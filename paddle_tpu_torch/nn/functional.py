"""Functional ops of the serving and training paths (counterpart of
paddle_tpu/nn/functional and the primitives in paddle_tpu/ops/nn_ops.py
that GPT and BERT reach).

Weights follow paddle's layout: a linear weight is [in, out] and the op is
x @ W + b, not torch.nn.Linear's [out, in]. Inside `amp.auto_cast` the ops
that the reference lists cast their inputs by the reference's op names
(`amp_cast_inputs`).
"""
from __future__ import annotations

import torch

from ..amp import amp_cast_inputs
from ..framework.random import RNG
from ..ops import cuda_kernels as ck

__all__ = ["linear", "matmul", "gelu", "relu", "tanh", "softmax",
           "log_softmax", "layer_norm", "dropout",
           "scaled_dot_product_attention", "cross_entropy",
           "softmax_with_cross_entropy"]


def matmul(x, y, transpose_x=False, transpose_y=False):
    """paddle.matmul (reference: ops/math.py matmul, op matmul_v2) with
    the transposes of the last two axes."""
    x, y = amp_cast_inputs("matmul_v2", [x, y])
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def linear(x, weight, bias=None):
    """x @ weight + bias with weight [in, out] (paddle layout): the matmul
    is matmul_v2 under auto_cast, the bias add on neither list."""
    y = matmul(x, weight)
    return y if bias is None else y + bias


def relu(x):
    """relu (reference: ops/nn_ops.py:21), TransformerEncoderLayer's
    default activation."""
    return torch.relu(x)


def tanh(x):
    """tanh (reference: ops/nn_ops.py:84)."""
    return torch.tanh(x)


def softmax(x, axis=-1):
    """softmax along `axis` (reference: ops/nn_ops.py:165, softmax_op)."""
    (x,) = amp_cast_inputs("softmax_op", [x])
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    """log-softmax along `axis` (reference: ops/nn_ops.py:170,
    log_softmax_op)."""
    (x,) = amp_cast_inputs("log_softmax_op", [x])
    return torch.log_softmax(x, dim=axis)


def gelu(x, approximate=False):
    """GELU; approximate=True is the tanh form (jax.nn.gelu's
    approximate=True, reference: ops/nn_ops.py gelu)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def layer_norm(x, weight, bias, epsilon=1e-5):
    """LayerNorm over the last axis with the reference's formula
    (ops/nn_ops.py layer_norm): mean, then the mean of squared deviations,
    then (x - mean) * rsqrt(var + eps) * weight + bias; layer_norm_op
    under auto_cast."""
    x, weight, bias = amp_cast_inputs("layer_norm_op", [x, weight, bias])
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


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
    keep = _keep(x.shape, p, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention entry point, q/k/v [B, H, T, D]; returns out [B, H, Tq, D].

    Gate order of the reference (nn/functional/__init__.py
    scaled_dot_product_attention): attention dropout counts only in
    training; the flash kernels (`FlashAttentionFunction`, dropout drawn in
    the kernel) while the flag `use_flash_attention` is on and the call
    has no additive mask and p < 1, their gate raising on a shape or dtype
    the kernels do not take; else the dense plain version
    `flash_attention_plain` (path xla_sdpa), which adds the mask and drops
    the probabilities with a mask from `_keep` (all of them at p >= 1), as
    the reference's XLA path does. The
    reference's blockwise tier for keys >= 2048 is not ported: no shape of
    the ported paths reaches it (max_position_embeddings is 1024)."""
    p = float(dropout_p) if training else 0.0
    out = ck.flash_attention_or_none(query, key, value, attn_mask,
                                     is_causal, dropout_p=p)
    if out is not None:
        return out
    ck._note_attn_path("xla_sdpa")
    B, H, Tq, _ = query.shape
    keep = (_keep((B, H, Tq, key.shape[2]), p, query.device) if p > 0.0
            else None)
    return ck.flash_attention_plain(query, key, value, bool(is_causal),
                                    attn_mask, keep=keep, dropout_p=p)


def softmax_with_cross_entropy(logits, label, ignore_index=-100, axis=-1):
    """-log_softmax(logits)[label] along `axis`, keeping that axis with
    size 1, computed in the logits' dtype as the reference computes it
    (ops/nn_ops.py softmax_with_cross_entropy); positions whose label is
    `ignore_index` give 0. A label with a trailing size-1 axis is taken
    as it is."""
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


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1):
    """Hard-label softmax cross entropy (reference: nn/functional
    cross_entropy with use_softmax=True, no weight, no soft labels):
    the per-position loss with the class axis squeezed, then "none",
    "sum", or "mean". As in the reference, "mean" with ignore_index >= 0
    divides by the count of labels that are not ignored; with a negative
    ignore_index it is the plain mean, ignored positions counting 0."""
    if reduction not in ("none", "sum", "mean"):
        raise ValueError("reduction %r" % (reduction,))
    loss = softmax_with_cross_entropy(input, label, ignore_index, axis)
    loss = loss.squeeze(axis % input.ndim)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if ignore_index >= 0:
        valid = (label.reshape(loss.shape) != ignore_index).to(input.dtype)
        return loss.sum() / torch.clamp_min(valid.sum(), 1e-8)
    return loss.mean()
