"""The port's encoder-decoder Transformer against the JAX package, on the
CPU: MultiHeadAttention (weights, masks, kdim / vdim, the incremental
`Cache` and the `StaticCache`, `gen_cache`), the encoder's and decoder's
layers and stacks with their caches, `Transformer` post-LN and pre-LN with
`generate_square_subsequent_mask`, `scaled_dot_product_attention`'s
weights, and the Transformer-base-shaped translation model of
`chip_smoke.py` phase 23 (`seq2seq_model`) trained 2 Adam + Noam steps
through both packages' make_train_step.

Size: d_model 32, 4 heads, 2 + 2 layers, FFN 64, vocab 97, B = 2, source
length 12, target length 9 (Tq != Tk in the cross-attention). Each port
module gets the reference's weights (`load_reference_state`) and the same
numpy inputs; dropout is 0 on both sides (the two frameworks' random bits
differ). Both packages run with `use_flash_attention` off (the reference's
plain XLA attention; the port's plain version) except where a test turns
it on: the reference then runs its Pallas kernel in interpret mode and the
port its kernels' plain versions through FlashAttentionFunction.

Tolerances: float32 outputs within 1e-5 absolute (at most two layers of
float32 sums in another order); gradients, losses, parameters and Adam's
moments after the steps within 1e-4 relative to the largest |value| of
each array. A gradient that is 0 in exact arithmetic (the key projections'
biases: softmax ignores a constant added to a row of scores) is float32
rounding noise below NOISE on both sides and is held within NOISE
absolute, Adam's moments at that level within NOISE and NOISE**2.
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import (export_reference_state,
                                     load_reference_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.optimizer import lr as tlr
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

D, H, LAYERS, FFN, VOCAB, B, S, T = 32, 4, 2, 64, 97, 2, 12, 9
ATOL = 1e-5
REL = 1e-4
# a gradient at float32 rounding level of the layers' sums
NOISE = 1e-7


def _set_both(name, on):
    flags.set_flags({name: on})
    paddle.set_flags({"FLAGS_" + name: on})


@pytest.fixture(autouse=True)
def plain_attention():
    _set_both("use_flash_attention", False)
    yield
    _set_both("use_flash_attention", True)
    _set_both("use_fused_dropout_ln", False)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy())


def _state(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _carry(ref, port):
    load_reference_state(port, _state(ref))
    return port


def _rel(got, want, tol=REL, what="", noise=None, within=None):
    """|got - want| <= tol * max |want|, the array's own largest value (at
    least float32's smallest normal, for an all-zero array). Elements
    where `noise` (a bool mask) is set are held within `within` absolute
    instead: a sum that is 0 in exact arithmetic is float32 rounding noise,
    which two summation orders do not share."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    if noise is not None:
        assert err[noise].max(initial=0.0) <= within, (what, "noise")
        err, want = err[~noise], want[~noise]
    scale = max(np.abs(want).max(initial=0.0), np.finfo(np.float32).tiny)
    assert err.max(initial=0.0) <= tol * scale, (what, err.max(), scale)


def _grad_rel(got, want, what=""):
    """A gradient: elements of the reference's at rounding level (|g| <=
    NOISE, the key projections' biases) within NOISE, the rest within REL
    of the array's largest |g|."""
    _rel(got, want, what=what, noise=np.abs(want) <= NOISE, within=NOISE)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL,
                               err_msg=what)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(a):
    return paddle.to_tensor(a), torch.from_numpy(a)


def _mask(kind, Tq, Tk, seed=1):
    """A [B, 1, Tq, Tk] mask of `kind` (None, bool, int, float), no row
    empty."""
    if kind is None:
        return None, None
    keep = np.random.RandomState(seed).rand(B, 1, Tq, Tk) < 0.7
    keep[..., 0] = True
    m = {"bool": keep, "int": keep.astype(np.int64),
         "float": np.where(keep, 0.0, -1e4).astype(np.float32)}[kind]
    return _both(m)


# ---------------------------------------------------------------------------
# MultiHeadAttention


@pytest.mark.parametrize("kdims", [None, (24, 20)], ids=["self", "kvdim"])
@pytest.mark.parametrize("mask", [None, "bool", "int", "float"])
@pytest.mark.parametrize("need_weights", [False, True],
                         ids=["out", "weights"])
def test_mha_matches_the_reference(need_weights, mask, kdims):
    """Outputs (and the weights, [B, H, Tq, Tk], which the reference
    returns after dropout and the mask) with every mask kind, and with key
    and value widths of their own."""
    kd, vd = kdims or (None, None)
    paddle.seed(0)
    ref = jnn.MultiHeadAttention(D, H, kdim=kd, vdim=vd,
                                 need_weights=need_weights)
    port = _carry(ref, nn.MultiHeadAttention(D, H, kdim=kd, vdim=vd,
                                             need_weights=need_weights))
    jq, tq = _both(_rand(B, T, D))
    jk, tk = _both(_rand(B, S, kd or D, seed=2))
    jv, tv = _both(_rand(B, S, vd or D, seed=3))
    jm, tm = _mask(mask, T, S)
    want = ref(jq, jk, jv, attn_mask=jm)
    got = port(tq, tk, tv, attn_mask=tm)
    if need_weights:
        (want, jw), (got, tw) = want, got
        _close(tw, jw, "weights")
        assert tuple(tw.shape) == (B, H, T, S)
        np.testing.assert_allclose(_np(tw).sum(-1), 1.0, atol=1e-5)
    _close(got, want)


def test_mha_weights_take_the_plain_path_with_flash_on():
    """need_weights with use_flash_attention on: the plain attention
    (xla_sdpa), no flash call, as the reference's sdpa with
    return_weights."""
    _set_both("use_flash_attention", True)
    mha = nn.MultiHeadAttention(D, H, need_weights=True)
    before = ck.attention_path_counts()
    out, w = mha(torch.from_numpy(_rand(B, T, D)))
    after = ck.attention_path_counts()
    assert after["xla_sdpa"] == before["xla_sdpa"] + 1
    assert after["flash"] == before["flash"]
    assert tuple(w.shape) == (B, H, T, T)


@pytest.mark.parametrize("steps", [1, 3])
def test_mha_incremental_cache_matches_the_reference(steps):
    """gen_cache(x, type=Cache) is empty; each call appends the step's keys
    and values: outputs and caches equal to the reference's."""
    paddle.seed(0)
    ref = jnn.MultiHeadAttention(D, H)
    port = _carry(ref, nn.MultiHeadAttention(D, H))
    x = _rand(B, steps, D)
    jc = ref.gen_cache(paddle.to_tensor(x), type=ref.Cache)
    tc = port.gen_cache(torch.from_numpy(x), type=port.Cache)
    assert isinstance(tc, nn.MultiHeadAttention.Cache)
    assert tuple(tc.k.shape) == tuple(jc.k.shape) == (B, H, 0, D // H)
    for t in range(steps):
        jx, tx = _both(x[:, t:t + 1])
        jo, jc = ref(jx, jx, jx, None, jc)
        to, tc = port(tx, tx, tx, None, tc)
        _close(to, jo, "step %d" % t)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert tc.k.shape[2] == steps


@pytest.mark.parametrize("how", ["type", "value"])
def test_mha_static_cache_matches_the_reference(how):
    """A StaticCache (by type, or by a value other than the key) holds the
    projected memory; a call with it attends to it, the cache returned as
    it was."""
    paddle.seed(0)
    ref = jnn.MultiHeadAttention(D, H)
    port = _carry(ref, nn.MultiHeadAttention(D, H))
    jm, tm = _both(_rand(B, S, D, seed=4))
    jv, tv = _both(_rand(B, S, D, seed=5))
    if how == "type":
        jc = ref.gen_cache(jm, jm, type=ref.StaticCache)
        tc = port.gen_cache(tm, tm, type=port.StaticCache)
    else:
        jc = ref.gen_cache(jm, jv)
        tc = port.gen_cache(tm, tv)
    assert isinstance(tc, nn.MultiHeadAttention.StaticCache)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    jq, tq = _both(_rand(B, T, D))
    jo, jc2 = ref(jq, jm, jm, None, jc)
    to, tc2 = port(tq, tm, tm, None, tc)
    _close(to, jo)
    assert tc2 is tc


def test_mha_gen_cache_of_given_key_and_value():
    """type Cache with a value: the (key, value) given, as they are."""
    mha = nn.MultiHeadAttention(D, H)
    k = torch.randn(B, H, 3, D // H)
    c = mha.gen_cache(k, k, type=mha.Cache)
    assert isinstance(c, mha.Cache) and c.k is k and c.v is k


# ---------------------------------------------------------------------------
# layers and stacks

LAYER = dict(d_model=D, nhead=H, dim_feedforward=FFN, dropout=0.0)


def _src_tgt():
    return _both(_rand(B, S, D, seed=6)), _both(_rand(B, T, D, seed=7))


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_encoder_cache_matches_the_reference(pre):
    """TransformerEncoderLayer.forward(cache=gen_cache(src)) and
    TransformerEncoder's: the output and the grown caches."""
    paddle.seed(0)
    ref = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        normalize_before=pre, **LAYER), LAYERS)
    port = _carry(ref, nn.TransformerEncoder(nn.TransformerEncoderLayer(
        normalize_before=pre, **LAYER), LAYERS))
    (js, ts), _ = _src_tgt()
    jo, jcs = ref(js, cache=ref.gen_cache(js))
    to, tcs = port(ts, cache=port.gen_cache(ts))
    _close(to, jo)
    _close(to, port(ts))                  # an empty cache changes nothing
    assert len(tcs) == LAYERS
    for tc, jc in zip(tcs, jcs):
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    jo, jc = ref.layers[0](js, cache=ref.layers[0].gen_cache(js))
    to, tc = port.layers[0](ts, cache=port.layers[0].gen_cache(ts))
    _close(to, jo)
    _close(tc.k, jc.k)


@pytest.mark.parametrize("masks", ["none", "tgt", "both"])
@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_decoder_layer_matches_the_reference(pre, masks):
    """TransformerDecoderLayer post-LN and pre-LN, with the causal target
    mask and a memory mask."""
    paddle.seed(0)
    ref = jnn.TransformerDecoderLayer(normalize_before=pre, **LAYER)
    port = _carry(ref, nn.TransformerDecoderLayer(normalize_before=pre,
                                                  **LAYER))
    (jm, tm), (jt, tt) = _src_tgt()
    causal = np.triu(np.full((T, T), -1e9, np.float32), 1)
    jtm, ttm = _both(causal) if masks != "none" else (None, None)
    jmm, tmm = _mask("bool", T, S) if masks == "both" else (None, None)
    _close(port(tt, tm, ttm, tmm), ref(jt, jm, jtm, jmm))


@pytest.mark.parametrize("do_zip", [False, True], ids=["list", "zipped"])
def test_decoder_gen_cache_structure_matches_the_reference(do_zip):
    """TransformerDecoder.gen_cache: each layer's (Cache, StaticCache), or
    with do_zip the Caches and the StaticCaches, the values the
    reference's."""
    paddle.seed(0)
    ref = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(**LAYER),
                                 LAYERS)
    port = _carry(ref, nn.TransformerDecoder(nn.TransformerDecoderLayer(
        **LAYER), LAYERS))
    (jm, tm), _ = _src_tgt()
    jc = ref.gen_cache(jm, do_zip=do_zip)
    tc = port.gen_cache(tm, do_zip=do_zip)
    assert len(tc) == len(jc) == (2 if do_zip else LAYERS)
    pairs = (zip(tc[0] + tc[1], jc[0] + jc[1]) if do_zip else
             ((a, b) for t, j in zip(tc, jc) for a, b in zip(t, j)))
    for t, j in pairs:
        assert type(t).__name__ == type(j).__name__
        _close(t.k, j.k)
        _close(t.v, j.v)


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_decoder_incremental_decode_matches_the_full_pass(pre):
    """The decoder with its caches, one token a step, against the
    reference's same steps and against the port's full pass under the
    causal mask (the reference's test_decoder_cache_incremental)."""
    paddle.seed(0)
    norm = (lambda lib: lib.LayerNorm(D)) if pre else (lambda lib: None)
    ref = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
        normalize_before=pre, **LAYER), LAYERS, norm(jnn))
    port = _carry(ref, nn.TransformerDecoder(nn.TransformerDecoderLayer(
        normalize_before=pre, **LAYER), LAYERS, norm(nn)))
    ref.eval()
    port.eval()
    (jm, tm), (jt, tt) = _src_tgt()
    full = port(tt, tm, tgt_mask=nn.Transformer(
        **LAYER).generate_square_subsequent_mask(T))
    jc, tc = ref.gen_cache(jm), port.gen_cache(tm)
    for t in range(T):
        jo, jc = ref(paddle.to_tensor(_np(jt)[:, t:t + 1]), jm, cache=jc)
        to, tc = port(tt[:, t:t + 1], tm, cache=tc)
        _close(to, jo, "step %d" % t)
        _close(to[:, 0], full[:, t], "step %d against the full pass" % t)
    assert tc[0][0].k.shape[2] == T and tc[0][1].k.shape[2] == S


def _transformer_pair(pre, **kw):
    paddle.seed(0)
    cfg = dict(d_model=D, nhead=H, num_encoder_layers=LAYERS,
               num_decoder_layers=LAYERS, dim_feedforward=FFN, dropout=0.0,
               normalize_before=pre, **kw)
    ref = jnn.Transformer(**cfg)
    return ref, _carry(ref, nn.Transformer(**cfg))


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_transformer_output_and_gradients_match(pre):
    """nn.Transformer's output and every parameter's gradient (of
    mean(out * g)) against the reference's eager tape, with
    generate_square_subsequent_mask as the target mask."""
    ref, port = _transformer_pair(pre)
    (js, ts), (jt, tt) = _src_tgt()
    g = _rand(B, T, D, seed=8)
    jmask = ref.generate_square_subsequent_mask(T)
    tmask = port.generate_square_subsequent_mask(T)
    np.testing.assert_array_equal(_np(tmask), _np(jmask))
    jout = ref(js, jt, tgt_mask=jmask)
    tout = port(ts, tt, tgt_mask=tmask)
    _close(tout, jout)
    (jout * paddle.to_tensor(g)).mean().backward()
    (tout * torch.from_numpy(g)).mean().backward()
    jg = {n: p.grad.numpy() for n, p in ref.named_parameters()}
    tg = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert sorted(tg) == sorted(jg)
    for name, want in jg.items():
        _grad_rel(tg[name], want, what=name)


def test_transformer_names_cross_both_ways():
    """The reference's state dict loads into the port and comes back
    equal, names and values (encoder/decoder layers, norm1-norm3, the
    pre-LN stacks' final norms)."""
    ref, port = _transformer_pair(True)
    state = _state(ref)
    back = export_reference_state(port)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
    assert "decoder.layers.1.norm3.weight" in state
    assert "encoder.norm.weight" in state


def test_generate_square_subsequent_mask_lies_with_the_parameters():
    mask = nn.Transformer(**LAYER).generate_square_subsequent_mask(4)
    assert mask.dtype == torch.float32 and mask.device.type == "cpu"
    assert np.isneginf(_np(mask)[0, 1]) and _np(mask)[1, 0] == 0


# ---------------------------------------------------------------------------
# scaled_dot_product_attention


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mask", [None, "float"])
def test_sdpa_return_weights_matches_the_reference(mask, causal):
    """return_weights: (out, weights) from the plain attention, the mask
    added, the causal mask aligned bottom-right (Tq != Tk)."""
    q = _rand(B, H, T, 8)
    k, v = _rand(B, H, S, 8, seed=2), _rand(B, H, S, 8, seed=3)
    jm, tm = _mask(mask, T, S)
    jo, jw = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), attn_mask=jm,
        is_causal=causal, return_weights=True)
    to, tw = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), attn_mask=tm,
        is_causal=causal, return_weights=True)
    _close(to, jo)
    _close(tw, jw)


@pytest.mark.parametrize("Tq", [T, 1], ids=["cross", "decode"])
def test_flash_path_at_tq_other_than_tk_matches_the_reference(Tq):
    """With use_flash_attention on, not causal, Tq queries against S keys
    (the cross-attention's, and a decode step's single query): the
    reference's Pallas kernel in interpret mode against the port's
    FlashAttentionFunction (its kernels' plain versions on the CPU),
    outputs and gradients."""
    _set_both("use_flash_attention", True)
    q = _rand(B, H, Tq, 8)
    k, v = _rand(B, H, S, 8, seed=2), _rand(B, H, S, 8, seed=3)
    g = _rand(B, H, Tq, 8, seed=4)
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False)
                  for a in (q, k, v))
    jo, _ = JF.scaled_dot_product_attention(jq, jk, jv, training=True)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = ck.attention_path_counts()
    to = F.scaled_dot_product_attention(tq, tk, tv, training=True)
    assert ck.attention_path_counts()["flash"] == before["flash"] + 1
    _close(to, jo)
    (jo * paddle.to_tensor(g)).sum().backward()
    (to * torch.from_numpy(g)).sum().backward()
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        _grad_rel(_np(t.grad), _np(j.grad))


# ---------------------------------------------------------------------------
# the Transformer-base-shaped translation model of chip_smoke.py phase 23


class RefSeq2Seq(jnn.Layer):
    """chip_smoke.seq2seq_model on the JAX package: the same layers under
    the same names."""

    def __init__(self, pre):
        super().__init__()
        self.d_model = D
        self.embedding = jnn.Embedding(
            VOCAB, D, padding_idx=chip_smoke.NMT_PAD,
            weight_attr=jnn.ParamAttr(initializer=jnn.initializer.Normal(
                0.0, D ** -0.5)))
        self.register_buffer("pos_table", paddle.to_tensor(
            chip_smoke.position_table(S, D)))
        self.dropout = jnn.Dropout(0.0)
        self.transformer = jnn.Transformer(D, H, LAYERS, LAYERS, FFN, 0.0,
                                           normalize_before=pre)

    def embed(self, ids):
        x = self.embedding(ids) * (self.d_model ** 0.5)
        return self.dropout(x + self.pos_table[:ids.shape[1]])

    def forward(self, src, tgt):
        mask = self.transformer.generate_square_subsequent_mask(
            tgt.shape[1])
        h = self.transformer(self.embed(src), self.embed(tgt), tgt_mask=mask)
        return paddle.matmul(h, self.embedding.weight, transpose_y=True)


def _seq2seq_pair(pre):
    paddle.seed(0)
    ref = RefSeq2Seq(pre)
    port = chip_smoke.seq2seq_model(VOCAB, D, H, LAYERS, FFN, 0.0, S,
                                    normalize_before=pre, seed=1,
                                    device="cpu")
    return ref, _carry(ref, port)


def _loss(lib_f):
    return lambda logits, label: chip_smoke.seq2seq_loss(lib_f, logits,
                                                         label, VOCAB)


def _nmt_batches(n):
    return [chip_smoke.nmt_batch(B, S, T, VOCAB, seed) for seed in range(n)]


def test_seq2seq_padding_row_and_names():
    """The shared embedding's padding row is zero after the draw in both
    packages; the names (embedding, pos_table, transformer.*) match."""
    ref, port = _seq2seq_pair(False)
    assert sorted(export_reference_state(port)) == sorted(_state(ref))
    assert not port.embedding.weight[chip_smoke.NMT_PAD].any()
    fresh = chip_smoke.seq2seq_model(VOCAB, D, H, LAYERS, FFN, 0.0, S,
                                     seed=5, device="cpu")
    assert not fresh.embedding.weight[chip_smoke.NMT_PAD].any()
    assert fresh.embedding.weight[2].abs().max() > 0


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_seq2seq_two_adam_noam_steps_match(pre):
    """The model's label-smoothed loss, its first-step gradients (of the
    reference's eager tape) and 2 Adam (0.9, 0.98, 1e-9) steps under
    NoamDecay through both packages' make_train_step: losses, parameters
    and both moments. Elements whose first gradient is at rounding level
    (|g| <= NOISE: the key projections' biases, whose gradient is 0 in
    exact arithmetic, since softmax ignores a constant added to a row)
    take Adam's normalised step at the sign of that noise, which the two
    packages do not share: they are held within 2 x the steps' summed lr
    (moments at rounding level, |m1| <= NOISE or |m2| <= NOISE**2, within
    that), the rest within REL of the array's largest |value|."""
    ref, port = _seq2seq_pair(pre)
    src, tin, lab = _nmt_batches(1)[0]
    jl = _loss(JF)(ref(paddle.to_tensor(src), paddle.to_tensor(tin)),
                   paddle.to_tensor(lab))
    tl = _loss(F)(port(torch.from_numpy(src), torch.from_numpy(tin)),
                  torch.from_numpy(lab))
    _rel(float(tl.detach()), float(jl.numpy()), what="loss")
    jl.backward()
    tl.backward()
    quiet = {}
    for n, p in ref.named_parameters():
        g = p.grad.numpy()
        _grad_rel(dict(port.named_parameters())[n].grad.numpy(), g, what=n)
        quiet[n] = np.abs(g) <= NOISE
        p.clear_gradient()
    port.zero_grad(set_to_none=True)

    adam = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)
    jsched, tsched = jlr.NoamDecay(D, 10), tlr.NoamDecay(D, 10)
    lrs = 0.0
    jopt = paddle.optimizer.Adam(learning_rate=jsched,
                                 parameters=ref.parameters(), **adam)
    topt = optimizer.Adam(learning_rate=tsched, parameters=port.parameters(),
                          device="cpu", **adam)
    jstep = jmake_train_step(ref, _loss(JF), jopt)
    tstep = make_train_step(port, _loss(F), topt, device="cpu")
    for src, tin, lab in _nmt_batches(2):
        jloss, _ = jstep([paddle.to_tensor(src), paddle.to_tensor(tin)],
                         [paddle.to_tensor(lab)])
        tloss, _ = tstep([torch.from_numpy(src), torch.from_numpy(tin)],
                         [torch.from_numpy(lab)])
        _rel(float(tloss), float(jloss.numpy()), what="step loss")
        lrs += jsched.get_lr()
        jsched.step()
        tsched.step()
    tparams = export_reference_state(port)
    for n, p in ref.named_parameters():
        want = p.numpy()
        _rel(tparams[n], want, what=n, noise=quiet[n], within=2 * lrs)
        tp = dict(port.named_parameters())[n]
        for acc, within in (("moment1", NOISE), ("moment2", NOISE ** 2)):
            want = np.asarray(jopt._get_accumulators(p)[acc])
            _rel(topt._get_accumulators(tp)[acc].numpy(), want,
                 what=n + "@" + acc, noise=np.abs(want) <= within,
                 within=within)
