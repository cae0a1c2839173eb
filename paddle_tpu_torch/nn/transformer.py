"""Transformer layers (counterpart of paddle_tpu/nn/transformer.py:
`_convert_attention_mask`, `MultiHeadAttention` with its caches,
`_residual_tail`, the encoder and decoder layers and stacks, and
`Transformer`).

Attention runs through F.scaled_dot_product_attention: the flash kernels
while `use_flash_attention` is on and no mask is given; a call with an
additive mask takes the plain attention, which adds it (path xla_sdpa),
as the reference's masked attention is composed XLA ops outside its flash
kernel. So in training the decoder's self-attention under
`generate_square_subsequent_mask`'s float mask is plain, and the encoder's
and the cross-attention flash; in cached decoding (one query against the
cache, no mask) both are flash. `need_weights=True` asks sdpa for the
weights, which takes the plain path as in the reference. Mask semantics
follow the reference: bool/int masks keep True/nonzero positions, float
masks are added to the scores.

Caches (reference :37-91): `MultiHeadAttention.Cache` (k, v) grows by the
step's keys and values on each call (incremental self-attention);
`StaticCache` (k, v) holds the projected memory and is used as it is
(cross-attention). Both are [B, H, T, head_dim].

Every residual tail, the encoder's and the decoder's, runs through the
fused dropout-residual(-LayerNorm) functions (`_residual_tail`), so
through the fused kernels while `use_fused_dropout_ln` is on.

Parameters are drawn from `generator` (see nn/layers.py); `weight_attr`
and `bias_attr` reach every Linear, as in the reference (its LayerNorms
take their defaults).
"""
from __future__ import annotations

import collections

import torch
from torch import nn

from . import functional as F
from .layers import Dropout, LayerNorm, Linear
from ..ops.manipulation import cast

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    """bool/int mask -> additive float mask, (1 - mask) * -1e9; a float mask
    is cast to `dtype` (reference: transformer.py:24)."""
    if attn_mask is None:
        return None
    if attn_mask.dtype in (torch.bool, torch.int32, torch.int64):
        return (1.0 - cast(attn_mask, dtype)) * -1e9
    return cast(attn_mask, dtype)


class MultiHeadAttention(nn.Module):
    """reference: nn/transformer.py:34."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, generator=None):
        super().__init__()
        if embed_dim <= 0 or num_heads <= 0 or embed_dim % num_heads:
            raise ValueError("embed_dim %d must be a positive multiple of "
                             "num_heads %d" % (embed_dim, num_heads))
        self.embed_dim = embed_dim
        self.kdim = kdim if kdim is not None else embed_dim
        self.vdim = vdim if vdim is not None else embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **attrs)
        self.k_proj = Linear(self.kdim, embed_dim, **attrs)
        self.v_proj = Linear(self.vdim, embed_dim, **attrs)
        self.out_proj = Linear(embed_dim, embed_dim, **attrs)

    def _split_heads(self, x):
        B, T = x.shape[0], x.shape[1]
        return x.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

    def _prepare_qkv(self, query, key, value, cache=None):
        """q, k, v [B, H, T, head_dim]: k and v the StaticCache's as they
        are, or the projections, appended to an incremental Cache's (the
        grown Cache returned as well)."""
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=2)
            v = torch.cat([cache.v, v], dim=2)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):
        """reference: transformer.py:69. type StaticCache (or, with no
        type, a `value` other than `key`): the projected key and value.
        Otherwise a Cache: empty ([B, H, 0, head_dim] in key's dtype) when
        no value is given, else (key, value) as they are."""
        if type == self.StaticCache or (type is None and value is not None
                                        and value is not key):
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None
                                              else key))
            return self.StaticCache(k, v)
        if value is None:
            k = key.new_zeros((key.shape[0], self.num_heads, 0,
                               self.head_dim))
            return self.Cache(k, k)
        return self.Cache(key, value)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """out, or a tuple of out, the weights (need_weights) and the cache
        (when one was given; an incremental one grown by this call)."""
        key = query if key is None else key
        value = key if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        attn_mask = _convert_attention_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training, return_weights=self.need_weights)
        weights = None
        if self.need_weights:
            out, weights = out
        B, T = out.shape[0], out.shape[2]
        out = self.out_proj(out.transpose(1, 2).reshape(B, T,
                                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


def _residual_tail(layer, h, residual, drop, norm):
    """The residual tail of an encoder or decoder layer (reference:
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
    """reference: nn/transformer.py:149."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 generator=None):
        super().__init__()
        self._config = dict(d_model=d_model, nhead=nhead,
                            dim_feedforward=dim_feedforward, dropout=dropout,
                            activation=activation, attn_dropout=attn_dropout,
                            act_dropout=act_dropout,
                            normalize_before=normalize_before,
                            weight_attr=weight_attr, bias_attr=bias_attr,
                            generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout, **attrs)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs)
        self.dropout = Dropout(act_dropout, mode="upscale_in_train")
        self.linear2 = Linear(dim_feedforward, d_model, **attrs)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout, mode="upscale_in_train")
        self.dropout2 = Dropout(dropout, mode="upscale_in_train")
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        """src, or (src, the grown incremental cache) when `cache` (from
        `gen_cache`) is given."""
        src_mask = _convert_attention_mask(src_mask, src.dtype)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = _residual_tail(self, src, residual, self.dropout1, self.norm1)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = _residual_tail(self, src, residual, self.dropout2, self.norm2)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        """An empty incremental Cache for the self-attention."""
        return self.self_attn.gen_cache(src, type=MultiHeadAttention.Cache)


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

    def forward(self, src, src_mask=None, cache=None):
        src_mask = _convert_attention_mask(src_mask, src.dtype)
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """reference: nn/transformer.py:228: self-attention, cross-attention
    over `memory`, the feed-forward block, each with its residual tail,
    post-LN or (normalize_before) pre-LN."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 generator=None):
        super().__init__()
        self._config = dict(d_model=d_model, nhead=nhead,
                            dim_feedforward=dim_feedforward, dropout=dropout,
                            activation=activation, attn_dropout=attn_dropout,
                            act_dropout=act_dropout,
                            normalize_before=normalize_before,
                            weight_attr=weight_attr, bias_attr=bias_attr,
                            generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout, **attrs)
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             dropout=attn_dropout, **attrs)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs)
        self.dropout = Dropout(act_dropout, mode="upscale_in_train")
        self.linear2 = Linear(dim_feedforward, d_model, **attrs)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout, mode="upscale_in_train")
        self.dropout2 = Dropout(dropout, mode="upscale_in_train")
        self.dropout3 = Dropout(dropout, mode="upscale_in_train")
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """tgt, or (tgt, (incremental Cache, StaticCache)) when `cache`
        (from `gen_cache`) is given."""
        tgt_mask = _convert_attention_mask(tgt_mask, tgt.dtype)
        memory_mask = _convert_attention_mask(memory_mask, tgt.dtype)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = _residual_tail(self, tgt, residual, self.dropout1, self.norm1)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = _residual_tail(self, tgt, residual, self.dropout2, self.norm2)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = _residual_tail(self, tgt, residual, self.dropout3, self.norm3)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        """(an empty incremental Cache, the StaticCache of `memory`)."""
        incremental_cache = self.self_attn.gen_cache(
            memory, type=MultiHeadAttention.Cache)
        static_cache = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental_cache, static_cache


class TransformerDecoder(nn.Module):
    """reference: nn/transformer.py:305."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        cfg = decoder_layer._config
        self.layers = nn.ModuleList([
            decoder_layer if i == 0 else TransformerDecoderLayer(**cfg)
            for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        tgt_mask = _convert_attention_mask(tgt_mask, tgt.dtype)
        memory_mask = _convert_attention_mask(memory_mask, tgt.dtype)
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask=tgt_mask,
                             memory_mask=memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask=tgt_mask,
                                        memory_mask=memory_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """Each layer's (Cache, StaticCache); with do_zip, the list of
        Caches and the list of StaticCaches."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(nn.Module):
    """reference: nn/transformer.py:343. The defaults are
    Transformer-base's (Vaswani et al. 2017, Table 3)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, generator=None):
        super().__init__()
        cfg = dict(d_model=d_model, nhead=nhead,
                   dim_feedforward=dim_feedforward, dropout=dropout,
                   activation=activation, attn_dropout=attn_dropout,
                   act_dropout=act_dropout,
                   normalize_before=normalize_before,
                   weight_attr=weight_attr, bias_attr=bias_attr,
                   generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(**cfg), num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(**cfg), num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        src_mask = _convert_attention_mask(src_mask, src.dtype)
        memory = self.encoder(src, src_mask=src_mask)
        tgt_mask = _convert_attention_mask(tgt_mask, tgt.dtype)
        memory_mask = _convert_attention_mask(memory_mask, tgt.dtype)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        """The additive causal mask [length, length] (reference:
        transformer.py:386): 0 on and below the diagonal, -inf above, in
        float32 on the device of the model's parameters."""
        dev = next(self.parameters()).device
        return torch.full((length, length), float("-inf"),
                          device=dev).triu(1)
