"""BERT / ERNIE encoder with the MLM + NSP pretraining heads (counterpart of
paddle_tpu/models/bert.py, the whole file).

Post-LN encoder layers (nn/transformer.py): each residual tail is
LayerNorm(residual + dropout(h)), one fused kernel pass while
FLAGS_use_fused_dropout_ln is on; attention takes the flash kernels
(non-causal, dropout in the kernel in train()). The MLM decoder weight is
the word-embedding table itself (one parameter, two uses): the embeddings
are registered before the heads, so `named_parameters` lists it once,
under `bert.embeddings.word_embeddings.weight`, as the reference does.

With an `attention_mask` the attention takes the plain route (path
xla_sdpa), as the reference's does (see nn/transformer.py).
"""
from __future__ import annotations

import torch
from torch import nn

from ..framework.device import resolve_device
from ..framework.random import init_seed
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear, Tanh
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["BertModel", "BertForPretraining", "BertPretrainingCriterion",
           "BertEmbeddings", "BertPooler", "BertPretrainingHeads",
           "BERT_CONFIGS", "bert_base", "bert_tiny", "ernie_base",
           "ErnieModel"]


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings, N(0, initializer_range),
    then LayerNorm and dropout."""

    def __init__(self, vocab_size, hidden_size, max_position_embeddings,
                 type_vocab_size=2, dropout=0.1, initializer_range=0.02,
                 generator=None):
        super().__init__()
        init = Normal(0.0, initializer_range)
        self.word_embeddings = Embedding(vocab_size, hidden_size,
                                         weight_attr=init,
                                         generator=generator)
        self.position_embeddings = Embedding(
            max_position_embeddings, hidden_size, weight_attr=init,
            generator=generator)
        self.token_type_embeddings = Embedding(
            type_vocab_size, hidden_size, weight_attr=init,
            generator=generator)
        self.layer_norm = LayerNorm(hidden_size)
        self.dropout = Dropout(dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        T = input_ids.shape[-1]
        if position_ids is None:
            position_ids = torch.arange(T, device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Module):
    def __init__(self, hidden_size, generator=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, generator=generator)
        self.activation = Tanh()

    def forward(self, hidden):
        return self.activation(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Embeddings + post-LN TransformerEncoder (exact GELU) + pooler ->
    (sequence output, pooled output)."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                 generator=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.embeddings = BertEmbeddings(
            vocab_size, hidden_size, max_position_embeddings,
            type_vocab_size, hidden_dropout_prob, generator=generator)
        layer = TransformerEncoderLayer(
            hidden_size, num_heads, intermediate_size,
            dropout=hidden_dropout_prob,
            attn_dropout=attention_dropout_prob, activation="gelu",
            generator=generator)
        self.encoder = TransformerEncoder(layer, num_layers)
        self.pooler = BertPooler(hidden_size, generator)

    @property
    def layers(self):
        return self.encoder.layers

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        if attention_mask is not None and attention_mask.ndim == 2:
            # [B, T] key padding mask -> additive [B, 1, 1, T]
            m = attention_mask.to(torch.float32)
            attention_mask = (1.0 - m)[:, None, None, :] * -1e4
        seq = self.encoder(x, src_mask=attention_mask)
        return seq, self.pooler(seq)


class BertPretrainingHeads(nn.Module):
    """MLM head (transform, GELU, LayerNorm, the tied decoder plus its own
    bias) and the NSP classifier."""

    def __init__(self, hidden_size, vocab_size, word_embedding_weight,
                 generator=None):
        super().__init__()
        self.transform = Linear(hidden_size, hidden_size, generator=generator)
        self.layer_norm = LayerNorm(hidden_size)
        self.decoder_weight = word_embedding_weight          # tied
        self.decoder_bias = nn.Parameter(torch.zeros(vocab_size))
        self.seq_relationship = Linear(hidden_size, 2, generator=generator)

    def forward(self, sequence_output, pooled_output):
        h = self.layer_norm(F.gelu(self.transform(sequence_output)))
        logits = F.matmul(h, self.decoder_weight,
                          transpose_y=True) + self.decoder_bias
        return logits, self.seq_relationship(pooled_output)


class BertForPretraining(nn.Module):
    def __init__(self, bert: BertModel, generator=None):
        super().__init__()
        self.bert = bert
        w = bert.embeddings.word_embeddings.weight
        self.cls = BertPretrainingHeads(bert.hidden_size, w.shape[0], w,
                                        generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                attention_mask)
        return self.cls(seq, pooled)


class BertPretrainingCriterion(nn.Module):
    """MLM + NSP loss; MLM labels of -100 are ignored. The MLM term is the
    reference's raw array code (mean over the labels kept, at least 1),
    which auto_cast does not cast; the log-softmax and the NSP cross
    entropy are ops that it does."""

    def forward(self, prediction_logits, nsp_logits, mlm_labels,
                nsp_labels=None):
        logp = F.log_softmax(prediction_logits, axis=-1)
        valid = mlm_labels >= 0
        safe = torch.where(valid, mlm_labels, torch.zeros_like(mlm_labels))
        picked = torch.gather(logp, -1, safe[..., None].long())[..., 0]
        denom = torch.clamp_min(valid.sum(), 1)
        loss = -(torch.where(valid, picked, 0.0).sum() / denom)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits, nsp_labels)
        return loss


BERT_CONFIGS = {
    "bert-tiny": dict(vocab_size=1024, hidden_size=64, num_layers=2,
                      num_heads=4, intermediate_size=128,
                      max_position_embeddings=128),
    "bert-base": dict(vocab_size=30522, hidden_size=768, num_layers=12,
                      num_heads=12, intermediate_size=3072,
                      max_position_embeddings=512),
}


def _make(name, pretraining=True, seed=None, device=None, **overrides):
    """Build a config with weights drawn on the CPU from a torch.Generator
    seeded with `seed` (default: the last paddle.seed's), then move it to
    `device` (default the current place; resolved first, so a missing CUDA
    raises before any work); each parameter's `qualname` is
    its qualified name, as in models/gpt.py."""
    dev = resolve_device(device)
    cfg = dict(BERT_CONFIGS[name])
    cfg.update(overrides)
    gen = torch.Generator().manual_seed(init_seed(seed))
    model = BertModel(generator=gen, **cfg)
    if pretraining:
        model = BertForPretraining(model, gen)
    model = model.to(dev)
    for pname, p in model.named_parameters():
        p.qualname = pname
    return model


def bert_tiny(**kw):
    return _make("bert-tiny", **kw)


def bert_base(**kw):
    return _make("bert-base", **kw)


def ernie_base(**kw):
    """ERNIE-base shares the bert-base architecture (BASELINE.md config
    3)."""
    return _make("bert-base", **kw)


ErnieModel = BertModel
