"""The fused bias + dropout + residual (+ LayerNorm) slice of the PyTorch
port against the JAX package, on the CPU.

The port's kernel wrappers run their plain PyTorch versions on CPU
tensors; the JAX side runs `_fbdrln_call` in interpret mode with explicit
uint32 mask bits (has_rng=False), the way its own tests run it. The two
packages draw different dropout bits, so a dropout case hands both sides
the same numpy bits, or runs at p = 0.

Tolerances, the reference's own (tests/test_pallas_fused.py:187-211), at
float32: y 1e-5 (an LN over up to 200 columns, summed in another order),
z 1e-6 (one add), gradients 2e-4 (the LN backward's row means); keep
decisions exactly. The GPT model cases: loss and first-step gradients at
rtol 1e-4 / atol 1e-5, as in tests/test_torch_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

FLAGS = ("use_fused_dropout_ln", "fused_block")


@pytest.fixture(autouse=True)
def flags_off():
    """Each test starts and ends with both fused flags off, in both
    packages."""
    def off():
        flags.set_flags({f: False for f in FLAGS})
        paddle.set_flags({"FLAGS_" + f: False for f in FLAGS})
    off()
    yield
    off()


def _rows(N, Hd, seed):
    rs = np.random.RandomState(seed)
    x, res, dy, dz = (rs.randn(N, Hd).astype(np.float32) for _ in range(4))
    bias, gamma, beta = (rs.randn(Hd).astype(np.float32) for _ in range(3))
    bits = rs.randint(0, 2 ** 32, (N, Hd), dtype=np.uint64) \
        .astype(np.uint32)
    return dict(x=x, res=res, dy=dy, dz=dz, bias=bias, gamma=1.0 + 0.1 * gamma,
                beta=beta, bits=bits)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits_t(bits):
    return _t(bits.astype(np.int64))


def _scale(p, mode):
    if mode == "downscale_in_infer":
        return 1.0
    return float(np.float32(1.0 / (1.0 - p))) if p < 1.0 else 0.0


CASES = [(N, Hd, p, mode)
         for N, Hd in ((13, 64), (16, 128), (21, 200))
         for p, mode in ((0.0, "upscale_in_train"),
                         (0.3, "upscale_in_train"),
                         (0.3, "downscale_in_infer"),
                         (1.0, "upscale_in_train"))]


@pytest.mark.parametrize("N,Hd,p,mode", CASES)
def test_forward_kernels_match_the_reference(N, Hd, p, mode):
    d = _rows(N, Hd, seed=N + Hd)
    scale = _scale(p, mode)
    v = lambda a: jnp.asarray(a).reshape(1, Hd)
    jy, jz = pk._fbdrln_call(
        pk._fbdrln_fwd_kernel, 2, jnp.asarray(d["bits"]),
        [jnp.asarray(d["x"]), jnp.asarray(d["res"]), v(d["bias"]),
         v(d["gamma"]), v(d["beta"])], [jnp.float32] * 2, p=p, scale=scale,
        eps=1e-5, has_rng=False, with_ln=True, interpret=True)
    (jz1,) = pk._fbdrln_call(
        pk._fbdrln_fwd_noln_kernel, 1, jnp.asarray(d["bits"]),
        [jnp.asarray(d["x"]), jnp.asarray(d["res"]), v(d["bias"]),
         v(d["gamma"]), v(d["beta"])], [jnp.float32], p=p, scale=scale,
        eps=1e-5, has_rng=False, with_ln=False, interpret=True)
    bits = _bits_t(d["bits"])
    y, z = ck.fused_dropout_ln_fwd_plain(
        _t(d["x"]), _t(d["res"]), _t(d["bias"]), _t(d["gamma"]),
        _t(d["beta"]), p, scale, 1e-5, bits=bits)
    z1 = ck.fused_dropout_residual_fwd_plain(_t(d["x"]), _t(d["res"]),
                                             _t(d["bias"]), p, scale,
                                             bits=bits)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(z1.numpy(), np.asarray(jz1), rtol=1e-6,
                               atol=1e-6)
    # the same elements dropped: there z is exactly the residual
    dropped = z.numpy() == d["res"]
    np.testing.assert_array_equal(dropped, np.asarray(jz) == d["res"])
    if p == 1.0:
        assert dropped.all()
    elif p == 0.0:
        assert not dropped.any()
    # the CPU wrapper is the plain version, and launches nothing
    before = ck.launch_counts()
    wy, wz = ck.fused_dropout_ln_fwd(
        _t(d["x"]), _t(d["res"]), _t(d["bias"]), _t(d["gamma"]),
        _t(d["beta"]), p, scale, 1e-5, word=prandom.philox_word(5, 7, "cpu"),
        delta=2)
    want = ck.fused_dropout_ln_fwd_plain(
        _t(d["x"]), _t(d["res"]), _t(d["bias"]), _t(d["gamma"]),
        _t(d["beta"]), p, scale, 1e-5, seed=5, offset=9)
    torch.testing.assert_close((wy, wz), want, rtol=0, atol=0)
    assert ck.launch_counts() == before


@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("N,Hd,p,mode", CASES[::2])
def test_backward_kernel_matches_the_reference(N, Hd, p, mode, with_ln):
    d = _rows(N, Hd, seed=3 * N + Hd)
    scale = _scale(p, mode)
    z = jnp.asarray(d["res"])                 # any stored z
    g = jnp.asarray(d["gamma"]).reshape(1, Hd) if with_ln else None
    jdx, jdres, jdb, jdg, jdbeta, _ = pk._fbdrln_vjp_bwd(
        p, scale, 1e-5, False, True, None,
        (z, g, jnp.asarray(d["bits"]), jax.random.PRNGKey(0)),
        (jnp.asarray(d["dy"]), jnp.asarray(d["dz"])))
    dx, dres, db, dg, dbeta = ck.fused_dropout_ln_bwd_plain(
        _t(d["res"]), _t(d["dy"]), _t(d["dz"]),
        _t(d["gamma"]) if with_ln else None, p, scale, 1e-5,
        bits=_bits_t(d["bits"]))
    pairs = [(dx, jdx), (dres, jdres), (db, jdb)]
    if with_ln:
        pairs += [(dg, jdg), (dbeta, jdbeta)]
    else:
        assert dg is None and dbeta is None and jdg is None
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy().ravel(),
                                   np.asarray(want).ravel(), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_array_equal(dx.numpy() == 0, np.asarray(jdx) == 0)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("training", [True, False])
def test_array_entry_modes_match_the_reference(mode, training):
    # eval runs the kernels at p = 0 (downscale_in_infer scaling x and
    # bias by 1 - p first) and draws no seed; training is held at p = 0
    d = _rows(24, 64, seed=1)
    p = 0.3 if not training else 0.0
    jy, jz = pk.fused_bias_dropout_residual_ln_arrays(
        jnp.asarray(d["x"]), jnp.asarray(d["res"]), jnp.asarray(d["bias"]),
        jnp.asarray(d["gamma"]), jnp.asarray(d["beta"]),
        jax.random.PRNGKey(0), p, 1e-5, training, mode)
    prandom.seed(3)
    offset0 = prandom.RNG._offset
    y, z = ck.fused_bias_dropout_residual_ln(
        _t(d["x"]), _t(d["res"]), _t(d["bias"]), _t(d["gamma"]),
        _t(d["beta"]), p, 1e-5, training, mode)
    assert prandom.RNG._offset == offset0
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        ck.fused_bias_dropout_residual_ln(_t(d["x"]), _t(d["res"]), None,
                                          None, None, p, 1e-5, training,
                                          "upscale")


@pytest.mark.parametrize("with_ln,with_bias", [(True, True), (True, False),
                                               (False, True)])
def test_function_gradients_match_jax_grad(with_ln, with_bias):
    # both outputs get a cotangent: y (the LN output) and z (the residual
    # stream); without LN the reference's y is z, and both sum into z's
    d = _rows(3 * 7, 64, seed=11)
    cy, cz = d["dy"].reshape(3, 7, 64), d["dz"].reshape(3, 7, 64)
    x, res = d["x"].reshape(3, 7, 64), d["res"].reshape(3, 7, 64)
    bias = d["bias"] if with_bias else None
    gamma, beta = (d["gamma"], d["beta"]) if with_ln else (None, None)

    def jloss(x, res, bias, gamma, beta):
        y, z = pk.fused_bias_dropout_residual_ln_arrays(
            x, res, bias, gamma, beta, jax.random.PRNGKey(0), 0.0, 1e-5,
            True, "upscale_in_train")
        return (y * cy).sum() + (z * cz).sum()
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (x, res, bias, gamma, beta)]
    argnums = [i for i, a in enumerate(jargs) if a is not None]
    jgrads = jax.grad(jloss, argnums=argnums)(*jargs)

    targs = [None if a is None else _t(a).requires_grad_()
             for a in (x, res, bias, gamma, beta)]
    out = ck.fused_bias_dropout_residual_ln(*targs, 0.0, 1e-5, True,
                                            "upscale_in_train")
    y, z = out if with_ln else (out, out)
    ((y * _t(cy)).sum() + (z * _t(cz)).sum()).backward()
    for i, want in zip(argnums, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy().ravel(),
                                   np.asarray(want).ravel(), rtol=2e-4,
                                   atol=2e-4)


def test_mask_rate_and_backward_mask_equal_forward():
    p, N, Hd = 0.1, 512, 768
    bits = ck.fused_dropout_bits_plain(123, 4, N, Hd)
    assert bits.dtype == torch.int64 and tuple(bits.shape) == (N, Hd)
    assert 0 <= int(bits.min()) and int(bits.max()) < 2 ** 32
    thr = int(p * 2 ** 32)
    rate = (bits < thr).double().mean().item()
    assert abs(rate - p) <= 0.002
    # another offset, another mask; the attention bits of the same
    # (seed, offset) are another function
    assert not torch.equal(bits, ck.fused_dropout_bits_plain(123, 5, N, Hd))
    assert not torch.equal(bits[:4, :8], ck.attn_dropout_bits_plain(
        123, 4, 1, 4, 8)[0])
    # through the Function: the backward regenerates the forward's mask
    rs = np.random.RandomState(0)
    x = _t(rs.rand(40, 96).astype(np.float32) + 0.5).requires_grad_()
    res = torch.zeros(40, 96)
    prandom.seed(9)
    z = ck.fused_bias_dropout_residual_ln(x, res, None, None, None, p, 1e-5,
                                          True, "upscale_in_train")
    z.backward(torch.ones_like(z))
    kept = z.detach() != 0
    assert 0 < kept.double().mean().item() < 1
    torch.testing.assert_close(x.grad != 0, kept, rtol=0, atol=0)
    scale = float(np.float32(1 / (1 - p)))
    torch.testing.assert_close(x.grad[kept], torch.full_like(x.grad[kept],
                                                             scale))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 16)
    v = torch.zeros(16)
    bad = [lambda: ck.fused_dropout_ln_fwd(x.half(), x.bfloat16(), v, v, v,
                                           0.0, 1.0, 1e-5),
           lambda: ck.fused_dropout_residual_fwd(x, torch.zeros(4, 8), v, 0.0,
                                                 1.0),
           lambda: ck.fused_dropout_residual_fwd(
               torch.zeros(2, ck.FDRLN_MAX_HD + 1),
               torch.zeros(2, ck.FDRLN_MAX_HD + 1), None, 0.0, 1.0),
           lambda: ck.fused_dropout_ln_fwd(x, x, v, torch.zeros(8), v, 0.0,
                                           1.0, 1e-5),
           lambda: ck.fused_dropout_ln_bwd(x, x.t(), None, v, 0.0, 1.0, 1e-5),
           lambda: ck.fused_dropout_residual_fwd(x, x, v, 1.5, 1.0),
           lambda: ck.fused_dropout_residual_fwd(
               x.to("meta"), x.to("meta"), None, 0.0, 1.0)]
    for call in bad:
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# the flags and the routes they choose

@pytest.mark.parametrize("name", FLAGS)
@pytest.mark.parametrize("value", [True, False])
def test_flag_accepts_both_values(name, value, monkeypatch):
    flags.set_flags({"FLAGS_" + name: value})
    assert flags.flag(name) is value
    assert flags.get_flags("FLAGS_" + name) == {"FLAGS_" + name: value}
    monkeypatch.setenv("FLAGS_" + name, "1" if value else "0")
    assert flags.define_flag(name, False) is value
    assert flags.flag(name) is value


def _count_function(monkeypatch):
    calls = []
    apply = ck.FusedDropoutResidualLNFunction.apply

    def counting(*a):
        calls.append(a[3] is not None)           # with LN
        return apply(*a)
    monkeypatch.setattr(ck.FusedDropoutResidualLNFunction, "apply",
                        counting)
    return calls


@pytest.mark.parametrize("on", [True, False])
def test_use_fused_dropout_ln_routes_its_entry_points(on, monkeypatch):
    flags.set_flags({"use_fused_dropout_ln": on})
    calls = _count_function(monkeypatch)
    dropouts = []
    real = F.dropout
    monkeypatch.setattr(F, "dropout",
                        lambda *a, **k: dropouts.append(1) or real(*a, **k))
    x, res, v = torch.randn(6, 16), torch.randn(6, 16), torch.ones(16)
    z = IF.fused_bias_dropout_residual(x, res, v, 0.0, training=True)
    y = IF.fused_bias_dropout_residual_layer_norm(x, res, v, v, v, 0.0)
    assert calls == ([False, True] if on else [])
    assert len(dropouts) == (0 if on else 2)
    torch.testing.assert_close(z, res + x + v)
    torch.testing.assert_close(y, F.layer_norm(res + x + v, v, v))


@pytest.mark.parametrize("on", [True, False])
def test_fused_block_routes_the_decoder_layer(on, monkeypatch):
    flags.set_flags({"fused_block": on})
    calls = _count_function(monkeypatch)
    model = tgpt_tiny(device="cpu", seed=0, attn_dropout_prob=0.0,
                      hidden_dropout_prob=0.0)
    model(torch.randint(0, 128, (1, 8)))
    # the pair once a layer; the MLP tail keeps the composed route while
    # use_fused_dropout_ln is off
    assert calls == ([True] * 2 if on else [])


def _old_layer_forward(layer, x):
    """GPTDecoderLayer's forward before the fused tails, written out."""
    x = x + layer.dropout(layer.attn(layer.ln_1(x)))
    return x + layer.dropout(layer.mlp(layer.ln_2(x)))


def test_flags_off_output_is_bit_equal_to_the_unfused_layer():
    model = tgpt_tiny(device="cpu", seed=0)          # dropout 0.1
    model.train()
    ids = torch.randint(0, 128, (2, 16), generator=torch.Generator()
                        .manual_seed(0))
    prandom.seed(4)
    got = model(ids)
    prandom.seed(4)
    gpt = model.gpt
    x = gpt.embeddings(ids)
    for blk in gpt.layers:
        x = _old_layer_forward(blk, x)
    want = torch.matmul(gpt.ln_f(x),
                        gpt.embeddings.word_embeddings.weight.t())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# gpt_tiny with the flags against the reference with the same flags

B, T, VOCAB = 2, 64, 128
NO_DROPOUT = dict(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)


@pytest.mark.parametrize("on", [("use_fused_dropout_ln",), ("fused_block",),
                                FLAGS])
def test_gpt_tiny_with_fused_flags_matches_the_reference(on, monkeypatch):
    flags.set_flags({f: True for f in on})
    paddle.set_flags({"FLAGS_" + f: True for f in on})
    calls = _count_function(monkeypatch)
    paddle.seed(0)
    ref = jgpt_tiny(**NO_DROPOUT)
    port = tgpt_tiny(device="cpu", seed=1, **NO_DROPOUT)
    load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    rs = np.random.RandomState(0)
    ids = rs.randint(0, VOCAB, (B, T + 1)).astype(np.int64)
    x, y = ids[:, :-1], ids[:, 1:]
    jloss = JCriterion()(ref(paddle.to_tensor(x)), paddle.to_tensor(y))
    jloss.backward()
    tloss = GPTPretrainingCriterion()(port(torch.from_numpy(x)),
                                      torch.from_numpy(y))
    tloss.backward()
    # per layer: two fused tails, or the pair alone (fused_block without
    # use_fused_dropout_ln: the MLP tail is composed), or the pair and the
    # MLP tail
    assert len(calls) == (2 if on == ("fused_block",) else 4)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()),
                               rtol=1e-4, atol=1e-5)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in
              ref.named_parameters()}
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], rtol=1e-4,
                                   atol=1e-5, err_msg=n)
