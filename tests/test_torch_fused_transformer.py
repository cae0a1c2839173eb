"""The port's `fused_multi_head_attention` and `fused_feedforward` against
the JAX package's, on the CPU, and `models.pack_qkv`, which packs a
MultiHeadAttention's q/k/v projections into the functions' [3, H,
head_dim, E] layout from the same numpy arrays for both packages.

Each case runs with `use_fused_dropout_ln` off (composed tails on both
sides) and on (the reference's Pallas kernels in interpret mode, the
port's kernels' plain versions through FusedDropoutResidualLNFunction),
with `use_flash_attention` off (the plain attention on both sides) except
where a case turns it on; dropout 0. The chip_smoke.py phase 23 stack
(`fused_encoder`) is held against nn.TransformerEncoder post-LN and
pre-LN.

Size: E = 32, 4 heads, B = 2, T = 9, a cache of 5 steps. Tolerances:
float32 outputs within 1e-5 absolute, gradients within 1e-4 relative to
their largest value (at least 1).
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JFF
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.incubate.nn import functional as FF
from paddle_tpu_torch.models import load_reference_state, pack_qkv
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

E, H, B, T, TC, FFN = 32, 4, 2, 9, 5, 64
ATOL = 1e-5


def _set_both(name, on):
    flags.set_flags({name: on})
    paddle.set_flags({"FLAGS_" + name: on})


@pytest.fixture(autouse=True)
def restore_flags():
    _set_both("use_flash_attention", False)
    yield
    _set_both("use_flash_attention", True)
    _set_both("use_fused_dropout_ln", False)


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _grads_close(got, want):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        err = np.abs(g - w).max()
        assert err <= 1e-4 * max(1.0, np.abs(w).max()), err


def _attn_weights():
    """q/k/v/out [in, out] weights and biases, LayerNorm vectors."""
    w = {n: _rand(E, E, seed=i, scale=E ** -0.5)
         for i, n in enumerate(("q", "k", "v", "out"))}
    b = {n: _rand(E, seed=10 + i, scale=0.1)
         for i, n in enumerate(("q", "k", "v", "out"))}
    ln = [_rand(E, seed=20 + i, scale=0.1) + (1.0 - i) for i in range(4)]
    return w, b, ln


def test_pack_qkv_is_the_same_for_numpy_and_torch():
    w, b, _ = _attn_weights()
    ws, bs = [w[n] for n in "qkv"], [b[n] for n in "qkv"]
    nw, nb = pack_qkv(ws, bs, H)
    tw, tb = pack_qkv([torch.from_numpy(a) for a in ws],
                      [torch.from_numpy(a) for a in bs], H)
    assert nw.shape == (3, H, E // H, E) and nb.shape == (3, H, E // H)
    np.testing.assert_array_equal(tw.numpy(), nw)
    np.testing.assert_array_equal(tb.numpy(), nb)
    # row (j, h, d) of the packed weight is column h * head_dim + d of
    # projection j
    np.testing.assert_array_equal(nw[1, 2, 3], w["k"][:, 2 * (E // H) + 3])


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_packed_block_equals_multi_head_attention(pre):
    """fused_multi_head_attention with pack_qkv's weights equals
    MultiHeadAttention followed by the block's residual tail."""
    mha = nn.MultiHeadAttention(E, H)
    ln = nn.LayerNorm(E)
    projs = (mha.q_proj, mha.k_proj, mha.v_proj)
    qkv_w, qkv_b = pack_qkv([p.weight for p in projs],
                            [p.bias for p in projs], H)
    x = torch.from_numpy(_rand(B, T, E))
    got = FF.fused_multi_head_attention(
        x, qkv_w, mha.out_proj.weight, pre_layer_norm=pre,
        pre_ln_scale=ln.weight, pre_ln_bias=ln.bias, ln_scale=ln.weight,
        ln_bias=ln.bias, qkv_bias=qkv_b, linear_bias=mha.out_proj.bias,
        dropout_rate=0.0, attn_dropout_rate=0.0)
    want = x + mha(ln(x)) if pre else ln(x + mha(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


MHA_CASES = [(pre, cache, causal, mask)
             for pre in (False, True) for cache in (False, True)
             for causal in (False, True) for mask in (False, True)]


def _mha_case_id(c):
    return "-".join(n for n, on in zip(("pre", "cache", "causal", "mask"), c)
                    if on) or "plain"


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
@pytest.mark.parametrize("pre,cache,causal,mask", MHA_CASES,
                         ids=[_mha_case_id(c) for c in MHA_CASES])
def test_fused_multi_head_attention_matches_the_reference(pre, cache,
                                                          causal, mask,
                                                          fused):
    """pre_layer_norm both ways, a cache_kv put before the step's keys and
    values, is_causal (bottom-right aligned with a cache) and an additive
    mask; the output and the input's and weights' gradients."""
    _set_both("use_fused_dropout_ln", fused)
    w, b, ln = _attn_weights()
    qkv_w, qkv_b = pack_qkv([w[n] for n in "qkv"], [b[n] for n in "qkv"], H)
    Tk = T + (TC if cache else 0)
    arrays = dict(
        x=_rand(B, T, E, seed=30), qkv_weight=qkv_w,
        linear_weight=w["out"], pre_ln_scale=ln[0], pre_ln_bias=ln[1],
        ln_scale=ln[2], ln_bias=ln[3], qkv_bias=qkv_b, linear_bias=b["out"])
    if cache:
        arrays["cache_kv"] = _rand(2, B, H, TC, E // H, seed=31)
    if mask:
        keep = np.random.RandomState(32).rand(B, 1, T, Tk) < 0.8
        keep[..., 0] = True
        arrays["attn_mask"] = np.where(keep, 0.0, -1e4).astype(np.float32)
    kw = dict(pre_layer_norm=pre, dropout_rate=0.0, attn_dropout_rate=0.0,
              is_causal=causal)
    grad_of = ("x", "qkv_weight", "linear_weight")
    jin = {k: paddle.to_tensor(v, stop_gradient=k not in grad_of)
           for k, v in arrays.items()}
    tin = {k: torch.from_numpy(v).requires_grad_(k in grad_of)
           for k, v in arrays.items()}
    jout = JFF.fused_multi_head_attention(**jin, **kw)
    tout = FF.fused_multi_head_attention(**tin, **kw)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)
    g = _rand(B, T, E, seed=33)
    (jout * paddle.to_tensor(g)).sum().backward()
    (tout * torch.from_numpy(g)).sum().backward()
    _grads_close([tin[k].grad for k in grad_of],
                 [jin[k].grad for k in grad_of])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_multi_head_attention_on_the_flash_path(causal):
    """With use_flash_attention on and no mask the call takes the flash
    path (the reference's interpret-mode Pallas kernel, the port's
    plain versions through FlashAttentionFunction), also with a cache."""
    _set_both("use_flash_attention", True)
    w, b, ln = _attn_weights()
    qkv_w, qkv_b = pack_qkv([w[n] for n in "qkv"], [b[n] for n in "qkv"], H)
    arrays = dict(x=_rand(B, T, E, seed=40), qkv_weight=qkv_w,
                  linear_weight=w["out"], ln_scale=ln[2], ln_bias=ln[3],
                  qkv_bias=qkv_b, linear_bias=b["out"],
                  cache_kv=_rand(2, B, H, TC, E // H, seed=41))
    kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0, is_causal=causal)
    before = ck.attention_path_counts()
    tout = FF.fused_multi_head_attention(
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, **kw)
    assert ck.attention_path_counts()["flash"] == before["flash"] + 1
    jout = JFF.fused_multi_head_attention(
        **{k: paddle.to_tensor(v) for k, v in arrays.items()}, **kw)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)


def test_fused_multi_head_attention_refuses_a_bad_layout():
    with pytest.raises(ValueError):
        FF.fused_multi_head_attention(torch.zeros(B, T, E),
                                      torch.zeros(3, H, E // H, E + 1),
                                      torch.zeros(E, E))


FFN_CASES = [(pre, act, bias) for pre in (False, True)
             for act in ("relu", "gelu") for bias in (False, True)]


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
@pytest.mark.parametrize("pre,act,bias", FFN_CASES,
                         ids=["%s-%s-%s" % ("pre" if p else "post", a,
                                            "bias" if b else "nobias")
                              for p, a, b in FFN_CASES])
def test_fused_feedforward_matches_the_reference(pre, act, bias, fused):
    """pre_layer_norm both ways, relu and gelu, with and without the
    linear biases: the output and the gradients."""
    _set_both("use_fused_dropout_ln", fused)
    arrays = dict(x=_rand(B, T, E, seed=50),
                  linear1_weight=_rand(E, FFN, seed=51, scale=E ** -0.5),
                  linear2_weight=_rand(FFN, E, seed=52, scale=FFN ** -0.5),
                  ln1_scale=_rand(E, seed=53, scale=0.1) + 1.0,
                  ln1_bias=_rand(E, seed=54, scale=0.1),
                  ln2_scale=_rand(E, seed=55, scale=0.1) + 1.0,
                  ln2_bias=_rand(E, seed=56, scale=0.1))
    if bias:
        arrays.update(linear1_bias=_rand(FFN, seed=57, scale=0.1),
                      linear2_bias=_rand(E, seed=58, scale=0.1))
    kw = dict(pre_layer_norm=pre, activation=act, dropout1_rate=0.0,
              dropout2_rate=0.0)
    grad_of = ("x", "linear1_weight", "linear2_weight")
    jin = {k: paddle.to_tensor(v, stop_gradient=k not in grad_of)
           for k, v in arrays.items()}
    tin = {k: torch.from_numpy(v).requires_grad_(k in grad_of)
           for k, v in arrays.items()}
    jout = JFF.fused_feedforward(**jin, **kw)
    tout = FF.fused_feedforward(**tin, **kw)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=ATOL)
    g = _rand(B, T, E, seed=59)
    (jout * paddle.to_tensor(g)).sum().backward()
    (tout * torch.from_numpy(g)).sum().backward()
    _grads_close([tin[k].grad for k in grad_of],
                 [jin[k].grad for k in grad_of])


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_fused_encoder_stack_equals_the_encoder(pre, fused):
    """chip_smoke.fused_encoder (phase 23 (d)): an nn.TransformerEncoder's
    weights through the fused block functions equal the encoder's output,
    post-LN and pre-LN, and the reference's encoder with the same
    weights."""
    _set_both("use_fused_dropout_ln", fused)
    paddle.seed(0)
    ref = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        E, H, FFN, dropout=0.0, normalize_before=pre), 2)
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        E, H, FFN, dropout=0.0, normalize_before=pre), 2)
    load_reference_state(enc, {k: np.asarray(v.numpy())
                               for k, v in ref.state_dict().items()})
    x = _rand(B, T, E, seed=60)
    got = chip_smoke.fused_encoder(FF, pack_qkv, enc, torch.from_numpy(x),
                                   pre)
    np.testing.assert_allclose(_np(got), _np(enc(torch.from_numpy(x))),
                               atol=ATOL)
    np.testing.assert_allclose(_np(got), _np(ref(paddle.to_tensor(x))),
                               atol=ATOL)
