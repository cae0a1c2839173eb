"""Transformer encoder layers (counterpart of paddle_tpu/nn/transformer.py:
`_convert_attention_mask`, `MultiHeadAttention`, `_residual_tail`,
`TransformerEncoderLayer`, `TransformerEncoder`).

Attention runs through F.scaled_dot_product_attention: the flash kernels
while `use_flash_attention` is on and no mask is given; a call with an
additive mask takes the plain attention, which adds it (path xla_sdpa),
as the reference's masked attention is composed XLA ops outside its flash
kernel. Mask semantics follow the reference: bool/int masks keep
True/nonzero positions, float masks are added to the scores.

Not ported yet: MultiHeadAttention's caches (`Cache`, `StaticCache`,
`gen_cache`) and `need_weights`, and the decoder classes.
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from .layers import Dropout, LayerNorm, Linear

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


def _convert_attention_mask(attn_mask, dtype):
    """bool/int mask -> additive float mask, (1 - mask) * -1e9; a float mask
    is cast to `dtype` (reference: transformer.py:24)."""
    if attn_mask is None:
        return None
    if attn_mask.dtype in (torch.bool, torch.int32, torch.int64):
        return (1.0 - attn_mask.to(dtype)) * -1e9
    return attn_mask.to(dtype)


class MultiHeadAttention(nn.Module):
    """reference: nn/transformer.py:34, without the caches."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, generator=None):
        super().__init__()
        if need_weights:
            raise NotImplementedError("MultiHeadAttention(need_weights=True)"
                                      " is not ported (see ROADMAP.md)")
        if embed_dim <= 0 or num_heads <= 0 or embed_dim % num_heads:
            raise ValueError("embed_dim %d must be a positive multiple of "
                             "num_heads %d" % (embed_dim, num_heads))
        self.embed_dim = embed_dim
        self.kdim = kdim if kdim is not None else embed_dim
        self.vdim = vdim if vdim is not None else embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        self.q_proj = Linear(embed_dim, embed_dim, generator)
        self.k_proj = Linear(self.kdim, embed_dim, generator)
        self.v_proj = Linear(self.vdim, embed_dim, generator)
        self.out_proj = Linear(embed_dim, embed_dim, generator)

    def _split_heads(self, x):
        B, T = x.shape[0], x.shape[1]
        return x.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        attn_mask = _convert_attention_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        B, T = out.shape[0], out.shape[2]
        return self.out_proj(out.transpose(1, 2).reshape(B, T,
                                                         self.embed_dim))


def _residual_tail(layer, h, residual, drop, norm):
    """The residual tail of an encoder layer (reference:
    transformer.py:119, off a mesh): post-LN (normalize_before False)
    LayerNorm(residual + dropout(h)), pre-LN residual + dropout(h), each
    one fused kernel pass while `use_fused_dropout_ln` is on. The
    Dropout's own mode is passed on."""
    # imported here, as in the reference: incubate imports this package
    from ..incubate.nn.functional import (
        fused_bias_dropout_residual, fused_bias_dropout_residual_layer_norm)
    if layer.normalize_before:
        return fused_bias_dropout_residual(
            h, residual, None, drop.p, training=layer.training,
            mode=drop.mode)
    return fused_bias_dropout_residual_layer_norm(
        h, residual, None, norm.weight, norm.bias, drop.p, norm._epsilon,
        training=layer.training, mode=drop.mode)


class TransformerEncoderLayer(nn.Module):
    """reference: nn/transformer.py:149. Parameters are drawn from
    `generator` (see nn/layers.py)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, generator=None):
        super().__init__()
        self._config = dict(d_model=d_model, nhead=nhead,
                            dim_feedforward=dim_feedforward, dropout=dropout,
                            activation=activation, attn_dropout=attn_dropout,
                            act_dropout=act_dropout,
                            normalize_before=normalize_before,
                            generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, generator)
        self.dropout = Dropout(act_dropout, mode="upscale_in_train")
        self.linear2 = Linear(dim_feedforward, d_model, generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout, mode="upscale_in_train")
        self.dropout2 = Dropout(dropout, mode="upscale_in_train")
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        src_mask = _convert_attention_mask(src_mask, src.dtype)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = _residual_tail(self, src, residual, self.dropout1, self.norm1)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        return _residual_tail(self, src, residual, self.dropout2, self.norm2)


class TransformerEncoder(nn.Module):
    """reference: nn/transformer.py:196: `encoder_layer` and num_layers - 1
    new layers of its configuration."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        cfg = encoder_layer._config
        self.layers = nn.ModuleList([
            encoder_layer if i == 0 else TransformerEncoderLayer(**cfg)
            for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        src_mask = _convert_attention_mask(src_mask, src.dtype)
        output = src
        for mod in self.layers:
            output = mod(output, src_mask=src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output
