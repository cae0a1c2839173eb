"""Fused transformer functions (counterpart of
paddle_tpu/incubate/nn/functional/fused_transformer.py).

The residual tails (:57-126) compute z = residual + dropout(x + bias), and
the first and last also y = LayerNorm(z), in one pass of the hand-written
kernels (ops/csrc/fused_dropout_ln.cu, behind
`FusedDropoutResidualLNFunction`), with the dropout mask drawn in the
kernel. `fused_bias_dropout_residual` and
`fused_bias_dropout_residual_layer_norm` take the composed PyTorch ops
when `use_fused_dropout_ln` is off; the pair is the decoder-block fusion,
gated by its caller's `fused_block` alone, as in the reference. An input
the kernels do not take raises ValueError: no shape is handed to the
composed ops on the quiet. The kernel routes are the reference's
registered ops (`fused_bias_dropout_residual_layer_norm`,
`fused_bias_dropout_residual`, `fused_bias_dropout_residual_ln_pair`),
so a static program records them under those types.

`fused_feedforward` and `fused_multi_head_attention` (:129-209) are the
reference's block functions: a transformer layer's feed-forward or
attention block from its weights, post-LN through
`fused_bias_dropout_residual_layer_norm` (so through the fused kernels
while the flag is on) and pre-LN through composed ops, as the reference
writes them; the attention core is F.scaled_dot_product_attention (the
flash kernels where its gate takes the call).
"""
from __future__ import annotations

import torch

from ....framework.dispatch import primitive
from ....framework.flags import flag
from ....nn import functional as F
from ....ops import cuda_kernels as ck

__all__ = ["fused_bias_dropout_residual",
           "fused_bias_dropout_residual_layer_norm",
           "fused_bias_dropout_residual_ln_pair", "fused_feedforward",
           "fused_multi_head_attention"]


def _composed_z(x, residual, bias, dropout_rate, training, mode):
    h = x if bias is None else x + bias
    return residual + F.dropout(h, dropout_rate, training=training, mode=mode)


def _ln_params(x, ln_scale, ln_bias):
    """The kernels' gamma and beta: ones / zeros in x's dtype where the
    caller passes None."""
    d = x.shape[-1]
    return (torch.ones(d, dtype=x.dtype, device=x.device)
            if ln_scale is None else ln_scale,
            torch.zeros(d, dtype=x.dtype, device=x.device)
            if ln_bias is None else ln_bias)


# the reference's registered ops (its fused_transformer.py :23-56); `key`
# is its PRNG key input, taken and ignored: the kernels draw from the
# Philox word


@primitive("fused_bias_dropout_residual_layer_norm", out_like=0)
def _fbdrln_op(x, residual, bias, ln_scale, ln_bias, key=None,
               dropout_rate=0.5, ln_epsilon=1e-5, training=True,
               mode="upscale_in_train"):
    return ck.fused_bias_dropout_residual_ln(
        x, residual, bias, ln_scale, ln_bias, dropout_rate, ln_epsilon,
        training, mode)[0]


@primitive("fused_bias_dropout_residual", out_like=0)
def _fbdr_op(x, residual, bias, key=None, dropout_rate=0.5, training=True,
             mode="upscale_in_train"):
    return ck.fused_bias_dropout_residual_ln(
        x, residual, bias, None, None, dropout_rate, 1e-5, training, mode)


@primitive("fused_bias_dropout_residual_ln_pair", out_like=(0, 0))
def _fbdrln_pair_op(x, residual, bias, ln_scale, ln_bias, key=None,
                    dropout_rate=0.5, ln_epsilon=1e-5, training=True,
                    mode="upscale_in_train"):
    return ck.fused_bias_dropout_residual_ln(
        x, residual, bias, ln_scale, ln_bias, dropout_rate, ln_epsilon,
        training, mode)


def fused_bias_dropout_residual_ln_pair(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """(LN(z), z) with z = residual + dropout(x + bias), both outputs of
    one kernel pass: the decoder-block tail of GPTDecoderLayer under
    FLAGS_fused_block (y feeds the MLP, z carries the residual stream).
    ln_scale / ln_bias default to ones / zeros in x's dtype."""
    return _fbdrln_pair_op(
        x, residual, bias, *_ln_params(x, ln_scale, ln_bias), None,
        dropout_rate=float(dropout_rate), ln_epsilon=float(ln_epsilon),
        training=bool(training), mode=str(mode))


def fused_bias_dropout_residual(x, residual, bias=None, dropout_rate=0.5,
                                training=True, mode="upscale_in_train",
                                name=None):
    """residual + dropout(x + bias): the pre-LN residual tail, one kernel
    pass while `use_fused_dropout_ln` is on, else the composed ops."""
    if not flag("use_fused_dropout_ln"):
        return _composed_z(x, residual, bias, dropout_rate, training, mode)
    return _fbdr_op(x, residual, bias, None,
                    dropout_rate=float(dropout_rate),
                    training=bool(training), mode=str(mode))


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """LayerNorm(residual + dropout(x + bias)): the post-LN residual tail,
    one kernel pass while `use_fused_dropout_ln` is on, else the composed
    ops. ln_scale / ln_bias default to ones / zeros in x's dtype."""
    if not flag("use_fused_dropout_ln"):
        z = _composed_z(x, residual, bias, dropout_rate, training, mode)
        return F.layer_norm(z, ln_scale, ln_bias, ln_epsilon)
    return _fbdrln_op(x, residual, bias, *_ln_params(x, ln_scale, ln_bias),
                      None, dropout_rate=float(dropout_rate),
                      ln_epsilon=float(ln_epsilon), training=bool(training),
                      mode=str(mode))


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", name=None):
    """The feed-forward block (reference: fused_transformer.py:129):
    h = dropout1(act(ln(x) W1 + b1)) W2, then post-LN
    LN2(x + dropout2(h + b2)) through the fused tail, or pre-LN (x taken
    through LN1 first) x + dropout2(h + b2) by composed ops. Weights are
    [in, out]."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, ln1_scale, ln1_bias, ln1_epsilon)
    h = F.linear(x, linear1_weight, linear1_bias)
    h = getattr(F, activation)(h)
    h = F.dropout(h, dropout1_rate, training=training, mode=mode)
    h = F.linear(h, linear2_weight)
    if not pre_layer_norm:
        return fused_bias_dropout_residual_layer_norm(
            h, residual, linear2_bias, ln2_scale, ln2_bias, dropout2_rate,
            ln2_epsilon, training, mode)
    return _composed_z(h, residual, linear2_bias, dropout2_rate, training,
                       mode)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, mode="upscale_in_train",
                               ring_id=-1, name=None, is_causal=False):
    """The self-attention block (reference: fused_transformer.py:158).
    x [B, T, E]; qkv_weight [3, H, head_dim, E] (the fused layout:
    qkv_weight[j, h, d] is the column h * head_dim + d of the j-th of the
    q, k, v projections' [E, E] weights, transposed; `models.pack_qkv`
    builds it), qkv_bias [3, H, head_dim], linear_weight [E, E] [in, out].
    cache_kv [2, B, H, Tc, head_dim]: keys and values put before the
    step's (the grown cache is not returned, as in the reference).
    is_causal: the bottom-right-aligned causal mask without a mask
    tensor, so that the call stays on the flash kernels (an additive
    attn_mask takes the plain attention). Post-LN: LN(x + dropout(out +
    linear_bias)) through the fused tail; pre-LN: x + dropout(out +
    linear_bias) by composed ops, x taken through the pre-LN first."""
    B, T, E = x.shape
    three, H, Dh, _ = qkv_weight.shape
    if three != 3 or H * Dh != E or tuple(qkv_weight.shape[3:]) != (E,):
        raise ValueError("qkv_weight %s: [3, H, head_dim, %d] with H * "
                         "head_dim = %d" % (tuple(qkv_weight.shape), E, E))
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    qkv = F.matmul(x, qkv_weight.reshape(3 * E, E), transpose_y=True)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.reshape(3 * E)
    q, k, v = qkv.reshape(B, T, 3, H, Dh).permute(2, 0, 3, 1, 4).unbind(0)
    if cache_kv is not None:
        k = torch.cat([cache_kv[0], k], dim=2)
        v = torch.cat([cache_kv[1], v], dim=2)
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=attn_dropout_rate,
        is_causal=is_causal, training=training)
    out = F.linear(out.transpose(1, 2).reshape(B, T, E), linear_weight)
    if not pre_layer_norm:
        return fused_bias_dropout_residual_layer_norm(
            out, residual, linear_bias, ln_scale, ln_bias, dropout_rate,
            ln_epsilon, training, mode)
    return _composed_z(out, residual, linear_bias, dropout_rate, training,
                       mode)
