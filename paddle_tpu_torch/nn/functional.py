"""Functional ops of the serving path (counterpart of
paddle_tpu/nn/functional and the primitives in paddle_tpu/ops/nn_ops.py
that GPT reaches).

Weights follow paddle's layout: a linear weight is [in, out] and the op is
x @ W + b, not torch.nn.Linear's [out, in].
"""
from __future__ import annotations

import torch

from ..ops import cuda_kernels as ck

__all__ = ["linear", "gelu", "layer_norm", "dropout",
           "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """x @ weight + bias with weight [in, out] (paddle layout)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def gelu(x, approximate=False):
    """GELU; approximate=True is the tanh form (jax.nn.gelu's
    approximate=True, reference: ops/nn_ops.py gelu)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def layer_norm(x, weight, bias, epsilon=1e-5):
    """LayerNorm over the last axis with the reference's formula
    (ops/nn_ops.py layer_norm): mean, then the mean of squared deviations,
    then (x - mean) * rsqrt(var + eps) * weight + bias."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def dropout(x, p=0.5, training=True):
    """The identity in eval or at p=0. Training-mode dropout (paddle's
    upscale_in_train, drawn from an explicit torch.Generator) comes with
    the training slice of the port; until then it raises."""
    if not training or p == 0.0:
        return x
    raise NotImplementedError(
        "training-mode dropout is not ported yet: call model.eval() or "
        "set the dropout probabilities to 0")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """Attention entry point, q/k/v [B, H, T, D]; returns out [B, H, Tq, D].

    Gate order of the reference (nn/functional/__init__.py
    scaled_dot_product_attention): the flash kernel while the flag
    `use_flash_attention` is on (its gate raises on an additive mask or a
    shape the kernel does not take), else the dense plain version
    `flash_attention_plain`, which also takes an additive mask. The reference's
    blockwise tier for keys >= 2048 is not ported: no serving shape reaches
    it (max_position_embeddings is 1024)."""
    if training and dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout in training is not ported yet: call "
            "model.eval() or set attn_dropout_prob to 0")
    out = ck.flash_attention_or_none(query, key, value, attn_mask,
                                     is_causal)
    if out is not None:
        return out
    ck._note_attn_path("xla_sdpa")
    return ck.flash_attention_plain(query, key, value, bool(is_causal),
                                    attn_mask)
