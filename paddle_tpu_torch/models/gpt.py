"""GPT decoder-only LM for serving (counterpart of paddle_tpu/models/gpt.py,
GPTEmbeddings through GPTForPretraining).

Off a mesh the reference's ColumnParallelLinear / RowParallelLinear /
VocabParallelEmbedding are plain Linear / Embedding, which is what the port
uses. MoE blocks, the pipeline classes, `generate` and the sequence-parallel
constraints are not part of this port.

Attention takes three routes, as in the reference:
  * no cache, or a zero-length legacy cache (cold prefill):
    F.scaled_dot_product_attention, causal -> the flash kernel;
  * a non-empty legacy (k, v) cache with several queries (suffix prefill
    after a prefix-cache hit): `_prefix_concat_attention`, plain torch with
    the bottom-right causal mask;
  * a LayerCacheView (decode): `_paged_decode_attention` -> the
    paged-decode kernel, which appends the step's K/V in place.
"""
from __future__ import annotations

import torch
from torch import nn

from ..framework.device import resolve_device
from ..nn import functional as F
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..ops import cuda_kernels as ck

__all__ = ["GPTModel", "GPTForPretraining", "GPTEmbeddings",
           "GPTDecoderLayer", "GPT_CONFIGS", "gpt_tiny", "gpt2_small"]


class GPTEmbeddings(nn.Module):
    """Word + learned-position embeddings, both N(0, initializer_range)."""

    def __init__(self, vocab_size, hidden_size, max_position_embeddings,
                 hidden_dropout_prob=0.1, initializer_range=0.02,
                 generator=None):
        super().__init__()
        self.word_embeddings = Embedding(vocab_size, hidden_size,
                                         initializer_range, generator)
        self.position_embeddings = Embedding(
            max_position_embeddings, hidden_size, initializer_range,
            generator)
        self.dropout = Dropout(hidden_dropout_prob)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        x = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)
        return self.dropout(x)


def _paged_decode_attention(q, k, v, view):
    """Single-token attention against the static-shape paged KV cache.

    q/k/v: [B, nh, 1, hd]; view (inference/serving/cache.LayerCacheView)
    carries this layer's k/v buffers [B, nh, T_max, hd] (+ int8 scales) and
    the per-slot lengths int32 [B]. The kernel appends k/v at each slot's
    length IN PLACE and attends over positions <= lens (path counter
    paged_flash). With `paged_flash_decode` off the plain PyTorch version
    does the same over the full T_max (path counter xla_paged); the
    reference's windowed einsum attends a bucket-sized window instead,
    which gives the same result."""
    out = ck.paged_decode_attention_or_none(
        q, view.k, view.v, view.lens, k, v, view.k_scale, view.v_scale)
    if out is None:
        ck._note_attn_path("xla_paged")
        out = ck.paged_decode_plain(q, view.k, view.v, view.lens, k, v,
                                    view.k_scale, view.v_scale)
    return out.to(q.dtype)


def _prefix_concat_attention(q, k, v, prefix_len):
    """Suffix-prefill attention: Tq suffix queries over prefix+suffix keys.

    Query i sits at absolute position prefix_len + i and attends keys
    j <= prefix_len + i: the bottom-right-aligned causal mask of the plain
    attention, since Tk = prefix_len + Tq. Float32, as the reference's
    einsum. Right-padding within the suffix bucket stays exact: a pad key
    is visible only to queries that are themselves pad."""
    assert k.shape[2] == prefix_len + q.shape[2]
    return ck.flash_attention_plain(q, k, v, causal=True)


class GPTAttention(nn.Module):
    """Causal self-attention with a fused QKV projection."""

    def __init__(self, hidden_size, num_heads, attn_dropout_prob=0.1,
                 generator=None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError("hidden_size %d is not a multiple of num_heads "
                             "%d" % (hidden_size, num_heads))
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.hidden_size = hidden_size
        self.attn_dropout_prob = attn_dropout_prob
        self.qkv_proj = Linear(hidden_size, 3 * hidden_size, generator)
        self.out_proj = Linear(hidden_size, hidden_size, generator)

    def _merge(self, out, B, T):
        return self.out_proj(out.transpose(1, 2).reshape(
            B, T, self.hidden_size))

    def forward(self, x, cache=None):
        B, T = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(B, T, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)   # [B, nh, T, hd]
        if cache is not None and hasattr(cache, "lens"):
            # serving decode: T == 1, the write lands at each slot's length
            return self._merge(_paged_decode_attention(q, k, v, cache),
                               B, T), cache
        if cache is not None:
            prefix_len = cache[0].shape[2]
            k = torch.cat([cache[0], k], dim=2)
            v = torch.cat([cache[1], v], dim=2)
            cache = (k, v)
            if T > 1 and prefix_len > 0:
                out = _prefix_concat_attention(q, k, v, prefix_len)
                return self._merge(out, B, T), cache
        causal = cache is None or T > 1
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, dropout_p=self.attn_dropout_prob,
            training=self.training)
        out = self._merge(out, B, T)
        return out if cache is None else (out, cache)


class GPTMLP(nn.Module):
    def __init__(self, hidden_size, intermediate_size, generator=None):
        super().__init__()
        self.fc1 = Linear(hidden_size, intermediate_size, generator)
        self.fc2 = Linear(intermediate_size, hidden_size, generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTDecoderLayer(nn.Module):
    """Pre-LN transformer decoder block: x + dropout(attn(ln_1(x))), then
    x + dropout(mlp(ln_2(x)))."""

    def __init__(self, hidden_size, num_heads, intermediate_size=None,
                 attn_dropout_prob=0.1, hidden_dropout_prob=0.1,
                 layer_norm_epsilon=1e-5, generator=None):
        super().__init__()
        inter = intermediate_size or 4 * hidden_size
        self.ln_1 = LayerNorm(hidden_size, epsilon=layer_norm_epsilon)
        self.attn = GPTAttention(hidden_size, num_heads, attn_dropout_prob,
                                 generator)
        self.ln_2 = LayerNorm(hidden_size, epsilon=layer_norm_epsilon)
        self.mlp = GPTMLP(hidden_size, inter, generator)
        self.dropout = Dropout(hidden_dropout_prob)

    def forward(self, x, cache=None):
        if cache is None:
            x = x + self.dropout(self.attn(self.ln_1(x)))
        else:
            a, cache = self.attn(self.ln_1(x), cache)
            x = x + self.dropout(a)
        x = x + self.dropout(self.mlp(self.ln_2(x)))
        return x if cache is None else (x, cache)


class GPTModel(nn.Module):
    """Embeddings + N decoder blocks + final LN -> hidden states."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, attn_dropout_prob=0.1,
                 hidden_dropout_prob=0.1, layer_norm_epsilon=1e-5,
                 initializer_range=0.02, generator=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.embeddings = GPTEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            hidden_dropout_prob, initializer_range, generator)
        self.layers = nn.ModuleList([
            GPTDecoderLayer(hidden_size, num_heads, intermediate_size,
                            attn_dropout_prob, hidden_dropout_prob,
                            layer_norm_epsilon, generator)
            for _ in range(num_layers)])
        self.ln_f = LayerNorm(hidden_size, epsilon=layer_norm_epsilon)

    def forward(self, input_ids, position_ids=None, caches=None):
        x = self.embeddings(input_ids, position_ids)
        if caches is None:
            for blk in self.layers:
                x = blk(x)
            return self.ln_f(x)
        new_caches = []
        for blk, c in zip(self.layers, caches):
            x, c = blk(x, c)
            new_caches.append(c)
        return self.ln_f(x), new_caches


def _lm_logits(hidden, word_embedding_weight):
    """Tied LM head: logits = h @ W_e^T."""
    return torch.matmul(hidden, word_embedding_weight.t())


class GPTForPretraining(nn.Module):
    def __init__(self, gpt: GPTModel):
        super().__init__()
        self.gpt = gpt

    def forward(self, input_ids, position_ids=None):
        hidden = self.gpt(input_ids, position_ids)
        return _lm_logits(hidden, self.gpt.embeddings.word_embeddings.weight)


GPT_CONFIGS = {
    # test-scale
    "gpt-tiny": dict(vocab_size=128, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=256,
                     max_position_embeddings=128),
    # GPT-2 124M
    "gpt2-small": dict(vocab_size=50304, hidden_size=768, num_layers=12,
                       num_heads=12, intermediate_size=3072,
                       max_position_embeddings=1024),
}


def _make(name, pretraining=True, seed=0, device="cuda", **overrides):
    """Build a config with weights drawn on the CPU from a torch.Generator
    seeded with `seed`, then move it to `device` (resolved first, so a
    missing CUDA raises before any work)."""
    dev = resolve_device(device)
    cfg = dict(GPT_CONFIGS[name])
    cfg.update(overrides)
    gen = torch.Generator().manual_seed(int(seed))
    model = GPTModel(generator=gen, **cfg)
    if pretraining:
        model = GPTForPretraining(model)
    return model.to(dev)


def gpt_tiny(**kw):
    return _make("gpt-tiny", **kw)


def gpt2_small(**kw):
    return _make("gpt2-small", **kw)
