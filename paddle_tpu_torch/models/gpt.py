"""GPT decoder-only LM for serving and training (counterpart of
paddle_tpu/models/gpt.py, GPTEmbeddings through GPTPretrainingCriterion).

Off a mesh the reference's ColumnParallelLinear / RowParallelLinear /
VocabParallelEmbedding are plain Linear / Embedding, which is what the port
uses. `GPTModel(moe_every_n_layers=n)` puts an `incubate.MoELayer` in
place of every n-th block's MLP (GShard's every-other-block layout at
n=2), its load-balancing losses summed by `moe_aux_loss()`. The pipeline
classes, `generate` and the sequence-parallel constraints are not part of
this port.

Attention takes three routes, as in the reference:
  * no cache, or a zero-length legacy cache (cold prefill, and training):
    F.scaled_dot_product_attention, causal -> the flash kernels, with
    attention dropout drawn in the kernel in train();
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
from ..framework.random import init_seed
from ..framework.flags import flag
from ..incubate.moe import MoELayer
from ..incubate.nn.functional import (fused_bias_dropout_residual,
                                      fused_bias_dropout_residual_ln_pair)
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..ops import cuda_kernels as ck

__all__ = ["GPTModel", "GPTForPretraining", "GPTEmbeddings",
           "GPTDecoderLayer", "GPTPretrainingCriterion",
           "ParallelCrossEntropy", "GPT_CONFIGS", "gpt_tiny", "gpt2_small"]


class GPTEmbeddings(nn.Module):
    """Word + learned-position embeddings, both N(0, initializer_range)."""

    def __init__(self, vocab_size, hidden_size, max_position_embeddings,
                 hidden_dropout_prob=0.1, initializer_range=0.02,
                 generator=None):
        super().__init__()
        init = Normal(0.0, initializer_range)
        self.word_embeddings = Embedding(vocab_size, hidden_size,
                                         weight_attr=init,
                                         generator=generator)
        self.position_embeddings = Embedding(
            max_position_embeddings, hidden_size, weight_attr=init,
            generator=generator)
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
    carries this layer's k/v buffers [B, nh, T_max, hd] (+ int8 scales),
    the per-slot lengths int32 [B] and the kernel's workspace, which the
    cache owns so that a captured decode step holds no memory the kernel
    module may replace. The kernel appends k/v at each slot's
    length IN PLACE and attends over positions <= lens (path counter
    paged_flash). With `paged_flash_decode` off the plain PyTorch version
    does the same over the full T_max (path counter xla_paged); the
    reference's windowed einsum attends a bucket-sized window instead,
    which gives the same result."""
    out = ck.paged_decode_attention_or_none(
        q, view.k, view.v, view.lens, k, v, view.k_scale, view.v_scale,
        view.workspace)
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
        self.qkv_proj = Linear(hidden_size, 3 * hidden_size,
                               generator=generator)
        self.out_proj = Linear(hidden_size, hidden_size, generator=generator)

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
        self.fc1 = Linear(hidden_size, intermediate_size, generator=generator)
        self.fc2 = Linear(intermediate_size, hidden_size, generator=generator)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTDecoderLayer(nn.Module):
    """Pre-LN transformer decoder block: x + dropout(attn(ln_1(x))), then
    x + dropout(mlp(ln_2(x))); moe_num_experts > 0 makes the MLP an
    MoELayer (reference: paddle_tpu/models/gpt.py:300-321). Each residual
    tail is `_residual_dropout`:
    one fused kernel pass while FLAGS_use_fused_dropout_ln is on, else the
    composed ops. Under FLAGS_fused_block (training and prefill without a
    cache) the attention tail and ln_2 are one pass with two outputs."""

    def __init__(self, hidden_size, num_heads, intermediate_size=None,
                 attn_dropout_prob=0.1, hidden_dropout_prob=0.1,
                 layer_norm_epsilon=1e-5, generator=None, moe_num_experts=0,
                 moe_top_k=2, moe_capacity_factor=1.25):
        super().__init__()
        inter = intermediate_size or 4 * hidden_size
        self.ln_1 = LayerNorm(hidden_size, epsilon=layer_norm_epsilon)
        self.attn = GPTAttention(hidden_size, num_heads, attn_dropout_prob,
                                 generator)
        self.ln_2 = LayerNorm(hidden_size, epsilon=layer_norm_epsilon)
        if moe_num_experts:
            self.mlp = MoELayer(hidden_size, inter, moe_num_experts,
                                top_k=moe_top_k,
                                capacity_factor=moe_capacity_factor,
                                generator=generator)
        else:
            self.mlp = GPTMLP(hidden_size, inter, generator)
        self.dropout = Dropout(hidden_dropout_prob)

    def _residual_dropout(self, h, residual):
        """Pre-LN residual tail: residual + dropout(h) (reference:
        paddle_tpu/models/gpt.py:326-337, off a mesh)."""
        return fused_bias_dropout_residual(
            h, residual, None, self.dropout.p, training=self.training,
            mode=self.dropout.mode)

    def _fused_block_ok(self):
        """Decoder-block fusion opt-in (FLAGS_fused_block): the attention
        epilogue and ln_2 as one fused_bias_dropout_residual_ln_pair
        pass."""
        return flag("fused_block")

    def forward(self, x, cache=None):
        if cache is None and self._fused_block_ok():
            a = self.attn(self.ln_1(x))
            # y = ln_2(z), z = x + dropout(a): one pass, two outputs
            y, z = fused_bias_dropout_residual_ln_pair(
                a, x, None, self.ln_2.weight, self.ln_2.bias,
                self.dropout.p, self.ln_2._epsilon, self.training,
                self.dropout.mode)
            return self._residual_dropout(self.mlp(y), z)
        if cache is None:
            x = self._residual_dropout(self.attn(self.ln_1(x)), x)
        else:
            a, cache = self.attn(self.ln_1(x), cache)
            x = self._residual_dropout(a, x)
        x = self._residual_dropout(self.mlp(self.ln_2(x)), x)
        return x if cache is None else (x, cache)


class GPTModel(nn.Module):
    """Embeddings + N decoder blocks + final LN -> hidden states."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None,
                 max_position_embeddings=1024, attn_dropout_prob=0.1,
                 hidden_dropout_prob=0.1, layer_norm_epsilon=1e-5,
                 initializer_range=0.02, generator=None,
                 moe_every_n_layers=0, moe_num_experts=8, moe_top_k=2,
                 moe_capacity_factor=1.25):
        super().__init__()
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.embeddings = GPTEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            hidden_dropout_prob, initializer_range, generator)
        # every moe_every_n_layers-th block's MLP is an MoELayer
        self.layers = nn.ModuleList([
            GPTDecoderLayer(
                hidden_size, num_heads, intermediate_size,
                attn_dropout_prob, hidden_dropout_prob, layer_norm_epsilon,
                generator,
                moe_num_experts=(moe_num_experts if moe_every_n_layers
                                 and (i + 1) % moe_every_n_layers == 0
                                 else 0),
                moe_top_k=moe_top_k,
                moe_capacity_factor=moe_capacity_factor)
            for i in range(num_layers)])
        self.ln_f = LayerNorm(hidden_size, epsilon=layer_norm_epsilon)

    def moe_aux_loss(self):
        """The sum of the MoE blocks' load-balancing losses of the latest
        forward (add coef * moe_aux_loss() to the training loss); a 0-d
        float32 zero on the model's device without MoE blocks."""
        total = None
        for blk in self.layers:
            if isinstance(blk.mlp, MoELayer):
                total = blk.mlp.l_aux if total is None \
                    else total + blk.mlp.l_aux
        if total is None:
            return torch.zeros((), dtype=torch.float32,
                               device=self.ln_f.weight.device)
        return total

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
    """Tied LM head: logits = h @ W_e^T, the op matmul_v2 (white-listed
    under amp.auto_cast), as the reference's `m.matmul`."""
    return F.matmul(hidden, word_embedding_weight, transpose_y=True)


class GPTForPretraining(nn.Module):
    def __init__(self, gpt: GPTModel):
        super().__init__()
        self.gpt = gpt

    def forward(self, input_ids, position_ids=None):
        hidden = self.gpt(input_ids, position_ids)
        return _lm_logits(hidden, self.gpt.embeddings.word_embeddings.weight)


class ParallelCrossEntropy(nn.Module):
    """Per-position softmax cross entropy, [B, T] (reference:
    distributed/fleet/meta_parallel/mp_layers.py ParallelCrossEntropy,
    which is plain cross entropy off a mesh)."""

    def __init__(self, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, reduction="none",
                               ignore_index=self.ignore_index)


class GPTPretrainingCriterion(nn.Module):
    """Masked next-token cross entropy: the mean over positions, or the
    loss_mask-weighted mean (reference: paddle_tpu/models/gpt.py
    GPTPretrainingCriterion)."""

    def __init__(self):
        super().__init__()
        self.ce = ParallelCrossEntropy()

    def forward(self, logits, labels, loss_mask=None):
        loss = self.ce(logits, labels)                 # [B, T]
        if loss_mask is not None:
            mask = loss_mask.reshape(loss.shape).to(loss.dtype)
            return (loss * mask).sum() / torch.clamp_min(mask.sum(), 1e-6)
        return loss.mean()


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


def _make(name, pretraining=True, seed=None, device=None, **overrides):
    """Build a config with weights drawn on the CPU from a torch.Generator
    seeded with `seed` (default: the last paddle.seed's), then move it to
    `device` (default the current place; resolved first, so a missing CUDA
    raises before any work). Each parameter's `qualname` is its
    qualified name, which the optimizer hands to apply_decay_param_fun."""
    dev = resolve_device(device)
    cfg = dict(GPT_CONFIGS[name])
    cfg.update(overrides)
    gen = torch.Generator().manual_seed(init_seed(seed))
    model = GPTModel(generator=gen, **cfg)
    if pretraining:
        model = GPTForPretraining(model)
    model = model.to(dev)
    for pname, p in model.named_parameters():
        p.qualname = pname
    return model


def gpt_tiny(**kw):
    return _make("gpt-tiny", **kw)


def gpt2_small(**kw):
    return _make("gpt2-small", **kw)
