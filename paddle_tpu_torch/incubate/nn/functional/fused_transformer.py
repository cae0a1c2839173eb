"""Fused residual tails (counterpart of
paddle_tpu/incubate/nn/functional/fused_transformer.py:57-126).

Each function computes z = residual + dropout(x + bias), and the first and
last also y = LayerNorm(z), in one pass of the hand-written kernels
(ops/csrc/fused_dropout_ln.cu, behind `FusedDropoutResidualLNFunction`),
with the dropout mask drawn in the kernel. `fused_bias_dropout_residual`
and `fused_bias_dropout_residual_layer_norm` take the composed PyTorch ops
when `use_fused_dropout_ln` is off; the pair is the decoder-block fusion,
gated by its caller's `fused_block` alone, as in the reference. An input
the kernels do not take raises ValueError: no shape is handed to the
composed ops on the quiet.

Not ported yet (ROADMAP.md): `fused_feedforward` and
`fused_multi_head_attention`.
"""
from __future__ import annotations

from ....nn import functional as F
from ....ops import cuda_kernels as ck

__all__ = ["fused_bias_dropout_residual",
           "fused_bias_dropout_residual_layer_norm",
           "fused_bias_dropout_residual_ln_pair"]


def _composed_z(x, residual, bias, dropout_rate, training, mode):
    h = x if bias is None else x + bias
    return residual + F.dropout(h, dropout_rate, training=training, mode=mode)


def _ln_params(x, ln_scale, ln_bias):
    """The kernels' gamma and beta: ones / zeros in x's dtype where the
    caller passes None."""
    d = x.shape[-1]
    return (x.new_ones(d) if ln_scale is None else ln_scale,
            x.new_zeros(d) if ln_bias is None else ln_bias)


def fused_bias_dropout_residual_ln_pair(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """(LN(z), z) with z = residual + dropout(x + bias), both outputs of
    one kernel pass: the decoder-block tail of GPTDecoderLayer under
    FLAGS_fused_block (y feeds the MLP, z carries the residual stream).
    ln_scale / ln_bias default to ones / zeros in x's dtype."""
    return ck.fused_bias_dropout_residual_ln(
        x, residual, bias, *_ln_params(x, ln_scale, ln_bias), dropout_rate,
        ln_epsilon, training, mode)


def fused_bias_dropout_residual(x, residual, bias=None, dropout_rate=0.5,
                                training=True, mode="upscale_in_train",
                                name=None):
    """residual + dropout(x + bias): the pre-LN residual tail, one kernel
    pass while `use_fused_dropout_ln` is on, else the composed ops."""
    z = ck.fused_dropout_residual_ln_or_none(
        x, residual, bias, None, None, dropout_rate, 1e-5, training, mode)
    if z is None:
        return _composed_z(x, residual, bias, dropout_rate, training, mode)
    return z


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """LayerNorm(residual + dropout(x + bias)): the post-LN residual tail,
    one kernel pass while `use_fused_dropout_ln` is on, else the composed
    ops. ln_scale / ln_bias default to ones / zeros in x's dtype."""
    out = ck.fused_dropout_residual_ln_or_none(
        x, residual, bias, *_ln_params(x, ln_scale, ln_bias), dropout_rate,
        ln_epsilon, training, mode)
    if out is None:
        z = _composed_z(x, residual, bias, dropout_rate, training, mode)
        return F.layer_norm(z, ln_scale, ln_bias, ln_epsilon)
    return out[0]
