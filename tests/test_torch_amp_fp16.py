"""float16 mixed precision and GradScaler in the port, against the JAX
package on the CPU.

  * make_train_step under amp.decorate(O2, float16) and
    auto_cast(O2, float16) on gpt_tiny (no dropout; attention through the
    Pallas flash kernel in interpret mode on the JAX side, the flash
    kernels' plain versions on the port's): the losses at rtol 1e-4, the
    parameters (float16 on both sides) within 5 * lr, as
    tests/test_torch_train.py holds its AdamW runs (Adam's normalised step
    turns rounding noise of either sign into +-lr where a gradient is near
    0; a float16 parameter's ulp at |p| ~ 1 is about lr here).
  * the float16 plain versions of the flash kernels, the fused
    dropout-residual-LN kernels and AdamW against the reference's Pallas
    kernels in interpret mode (and the jnp rule): outputs at 2e-2 (one
    float16 rounding of outputs of magnitude up to ~4, 2^-9 ulp there,
    and float16 operands the two packages round at other places), the
    AdamW parameter bit-equal; the masked dense attention at float16,
    where the reference fills masked scores with -1e9 rounded to float16
    (-inf), against the port's -1e30 in float32 (both weights 0).
  * GradScaler's state machine against the reference's with gradients
    set by hand (as tests/test_resilience.py does): found_inf, skipped
    steps, scale history under decr_every_n_nan_or_inf and
    incr_every_n_steps, the floor at 1.0, the state dict; unscale_ at
    2^15 and at 1000.0, bit-equal to the reference's g * (1 / scale) with
    1 / scale rounded to the gradient's dtype.
  * the eager float16 O2 loop without auto_cast (the reference's eager
    AMP tape fails under auto_cast, ROADMAP.md section 3) on gpt_tiny:
    a float16 loss times 2^15 overflows, so every step is skipped and the
    scale halves each time, on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt
from paddle_tpu.framework.tensor import Parameter as JParam
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models import gpt_tiny as jgpt_tiny
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.models import gpt_tiny as tgpt_tiny
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

VOCAB, B, T, LR = 128, 2, 64, 1e-3
NO_DROPOUT = dict(attn_dropout_prob=0.0, hidden_dropout_prob=0.0)
F16_ATOL = 2e-2


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return t if dtype is None else t.to(dtype)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().copy()
    return np.array(jnp.asarray(x, jnp.float32), copy=True)


def _gpt_pair():
    paddle.seed(0)
    ref = jgpt_tiny(**NO_DROPOUT)
    port = tgpt_tiny(device="cpu", seed=1, **NO_DROPOUT)
    load_reference_state(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (n, B, T + 1)).astype(np.int64)
    return [(x[:, :-1], x[:, 1:]) for x in ids]


# ---------------------------------------------------------------------------
# float16 in amp and the train step


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_amp_takes_the_reference_dtypes(dtype):
    """auto_cast, AmpState and decorate take float16 (which raised before);
    a white-listed op gets float16 inputs, a black-listed one float32."""
    net = torch.nn.Linear(4, 4)
    out = amp.decorate(net, level="O2", dtype=dtype)
    assert out is net and net.weight.dtype == getattr(torch, dtype)
    x = torch.ones(2, 4, dtype=getattr(torch, dtype))
    with amp.auto_cast(level="O1", dtype=dtype):
        (w,) = amp.amp_cast_inputs("matmul_v2", [x.float()])
        (b,) = amp.amp_cast_inputs("softmax_op", [x])
    assert w.dtype == getattr(torch, dtype) and b.dtype == torch.float32
    with pytest.raises(ValueError, match="float16"):
        amp.AmpState(dtype="float64")


def test_float16_train_step_matches_the_reference():
    """make_train_step, AdamW, decorate O2 float16 and auto_cast O2
    float16 on both sides, 3 steps."""
    ref, port = _gpt_pair()
    jo = jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                    parameters=ref.parameters())
    to = topt.AdamW(learning_rate=LR, weight_decay=0.01,
                    parameters=port.parameters(), device="cpu")
    ref, jo = jamp.decorate(ref, jo, level="O2", dtype="float16")
    port, to = amp.decorate(port, to, level="O2", dtype="float16")
    jc, tc = JCriterion(), GPTPretrainingCriterion()
    jstep = jmake_train_step(ref, lambda o, l: jc(o, l), jo)
    tstep = make_train_step(port, lambda o, l: tc(o, l), to, device="cpu")
    start = [p.detach().clone() for p in port.parameters()]
    for x, y in _batches(3):
        with jamp.auto_cast(level="O2", dtype="float16"):
            jl, _ = jstep([paddle.to_tensor(x)], [paddle.to_tensor(y)])
        with amp.auto_cast(level="O2", dtype="float16"):
            tl, _ = tstep([torch.from_numpy(x)], [torch.from_numpy(y)])
        np.testing.assert_allclose(float(tl), float(np.asarray(jl.numpy())),
                                   rtol=1e-4)
    assert tstep.compiles == 1
    jp = dict(ref.named_parameters())
    for n, p in port.named_parameters():
        assert p.dtype == torch.float16 and str(jp[n].dtype).endswith(
            "float16")
        np.testing.assert_allclose(_np32(p), _np32(jp[n]._data),
                                   atol=5 * LR, rtol=0, err_msg=n)
    assert any(not torch.equal(a, b)
               for a, b in zip(start, port.parameters()))


# ---------------------------------------------------------------------------
# the float16 plain versions against the reference's kernels


def _qkv(B_, H, Tq, Tk, D, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B_, H, Tq, D).astype(np.float32),
            rs.randn(B_, H, Tk, D).astype(np.float32),
            rs.randn(B_, H, Tk, D).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T_", [16, 40])
def test_flash_plain_float16_matches_pallas(causal, T_):
    q, k, v = _qkv(2, 3, T_, T_, 16, seed=T_)
    jq, jk, jv = (jnp.asarray(a, jnp.float16) for a in (q, k, v))
    want, _ = pk._flash_fwd(jq, jk, jv, causal, interpret=True,
                            need_lse=False)
    got = ck.flash_attention(*(_t(a, torch.float16) for a in (q, k, v)),
                             causal)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_np32(got), _np32(want), atol=F16_ATOL,
                               rtol=F16_ATOL)


# (B, H, Tq, Tk, D, causal, block_q, block_k), as test_torch_kernels.py's
@pytest.mark.parametrize("cfg", [(2, 3, 32, 32, 16, True, 128, 128),
                                 (1, 2, 16, 48, 8, True, 128, 128),
                                 (1, 2, 64, 64, 16, True, 16, 16)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_flash_train_plain_float16_matches_pallas(cfg, p):
    B_, H, Tq, Tk, D, causal, bq, bk = cfg
    rs = np.random.RandomState(1)
    q, k, v = _qkv(B_, H, Tq, Tk, D, 1)
    g = rs.randn(B_, H, Tq, D).astype(np.float32)
    bits = rs.randint(0, 2 ** 32, (B_ * H, Tq, Tk), dtype=np.uint64)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.float16) for a in (q, k, v, g))
    jbits = jnp.asarray(bits.astype(np.uint32)) if p else None
    jo, jlse = pk._flash_fwd(jq, jk, jv, causal, block_q=bq, block_k=bk,
                             interpret=True, dropout_p=p, rng=jbits)
    jgrads = pk._flash_bwd(jq, jk, jv, jo, jlse, jg, causal, block_q=bq,
                           block_k=bk, interpret=True, dropout_p=p,
                           rng=jbits)
    tq, tk, tv, tg = (_t(a, torch.float16) for a in (q, k, v, g))
    tbits = _t(bits.astype(np.int64)) if p else None
    o, lse = ck.flash_fwd_train_plain(tq, tk, tv, causal, p, tbits)
    dq, delta = ck.flash_bwd_dq_plain(tq, tk, tv, o, tg, lse, causal, p,
                                      tbits)
    dk, dv = ck.flash_bwd_dkv_plain(tq, tk, tv, tg, lse, delta, causal, p,
                                    tbits)
    for t in (o, dq, dk, dv):
        assert t.dtype == torch.float16
    np.testing.assert_allclose(_np32(o), _np32(jo), atol=F16_ATOL,
                               rtol=F16_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=1e-3, rtol=1e-3)
    for got, want in zip((dq, dk, dv), jgrads):
        np.testing.assert_allclose(_np32(got), _np32(want), atol=F16_ATOL,
                                   rtol=F16_ATOL)


@pytest.mark.parametrize("masked", ["causal", "padding"])
def test_masked_dense_attention_float16(masked):
    """The reference's dense attention fills masked float16 scores with
    jnp.asarray(-1e9, float16), which is -inf (its run warns "overflow
    encountered in cast"); the port's plain attention scores in float32
    with -1e30. Both give the masked keys weight 0: the outputs agree.
    With a padding mask from the port's transformer helper ((1 - m) *
    -1e9 computed in float32: -0 where kept, -inf where padded), a row
    whose keys are all padded is NaN on both sides. The reference's own
    helper computes (1 - m) * -1e9 in float16, 0 * -inf, and gives NaN
    where a key is kept (ROADMAP.md section 3); the port's does not."""
    q, k, v = _qkv(2, 2, 8, 8, 16, seed=3)
    jq, jk, jv = (paddle.to_tensor(np.asarray(a, np.float16))
                  for a in (q, k, v))
    tq, tk, tv = (_t(a, torch.float16) for a in (q, k, v))
    jF = paddle.nn.functional
    saved = flags.get_flags(["use_flash_attention"])
    flags.set_flags({"use_flash_attention": False})
    paddle.set_flags({"FLAGS_use_flash_attention": False})
    try:
        if masked == "causal":
            with np.errstate(over="ignore"):
                want, _ = jF.scaled_dot_product_attention(jq, jk, jv,
                                                          is_causal=True)
            got = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
        else:
            from paddle_tpu.nn.transformer import \
                _convert_attention_mask as jconvert
            from paddle_tpu_torch.nn.transformer import \
                _convert_attention_mask as tconvert
            keep = np.ones((2, 1, 1, 8), bool)
            keep[0, ..., 5:] = False
            keep[1] = False                      # every key padded
            tmask = tconvert(torch.from_numpy(keep), torch.float16)
            assert not torch.isnan(tmask).any()
            with np.errstate(over="ignore", invalid="ignore"):
                jown = jconvert(paddle.to_tensor(keep), "float16")
                assert np.isnan(_np32(jown._data)[keep]).all()
                want, _ = jF.scaled_dot_product_attention(
                    jq, jk, jv, attn_mask=paddle.to_tensor(tmask.numpy()))
            got = F.scaled_dot_product_attention(tq, tk, tv,
                                                 attn_mask=tmask)
    finally:
        flags.set_flags(saved)
        paddle.set_flags({"FLAGS_use_flash_attention": True})
    assert got.dtype == torch.float16
    w, g = _np32(want._data), _np32(got)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    fin = ~np.isnan(w)
    np.testing.assert_allclose(g[fin], w[fin], atol=F16_ATOL, rtol=F16_ATOL)
    if masked == "padding":
        assert np.isnan(g[1]).all() and not np.isnan(g[0]).any()


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_fused_dropout_ln_plain_float16_matches_the_reference(p):
    rs = np.random.RandomState(7)
    N, Hd = 16, 128
    x, res, dy, dz = (rs.randn(N, Hd).astype(np.float32) for _ in range(4))
    bias, beta = (rs.randn(Hd).astype(np.float32) for _ in range(2))
    gamma = 1.0 + 0.1 * rs.randn(Hd).astype(np.float32)
    bits = rs.randint(0, 2 ** 32, (N, Hd), dtype=np.uint64).astype(np.uint32)
    scale = float(np.float32(1.0 / (1.0 - p)))
    h = lambda a: jnp.asarray(a, jnp.float16)
    v = lambda a: h(a).reshape(1, Hd)
    jy, jz = pk._fbdrln_call(
        pk._fbdrln_fwd_kernel, 2, jnp.asarray(bits),
        [h(x), h(res), v(bias), v(gamma), v(beta)], [jnp.float16] * 2, p=p,
        scale=scale, eps=1e-5, has_rng=False, with_ln=True, interpret=True)
    tb = _t(bits.astype(np.int64))
    f = lambda a: _t(a, torch.float16)
    y, z = ck.fused_dropout_ln_fwd_plain(f(x), f(res), f(bias), f(gamma),
                                         f(beta), p, scale, 1e-5, bits=tb)
    assert y.dtype == z.dtype == torch.float16
    np.testing.assert_allclose(_np32(y), _np32(jy), atol=F16_ATOL,
                               rtol=F16_ATOL)
    np.testing.assert_allclose(_np32(z), _np32(jz), atol=F16_ATOL,
                               rtol=F16_ATOL)
    jdx, jdres, jdb, jdg, jdbeta, _ = pk._fbdrln_vjp_bwd(
        p, scale, 1e-5, False, True, None,
        (jz, v(gamma), jnp.asarray(bits), jax.random.PRNGKey(0)),
        (h(dy), h(dz)))
    got = ck.fused_dropout_ln_bwd_plain(z, f(dy), f(dz), f(gamma), p, scale,
                                        1e-5, bits=tb)
    for a, b in zip(got, (jdx, jdres, jdb, jdg, jdbeta)):
        assert a.dtype == torch.float16
        np.testing.assert_allclose(_np32(a).ravel(), _np32(b).ravel(),
                                   atol=0.1, rtol=F16_ATOL)


def test_adamw_float16_param_matches_jnp_rule():
    """A float16 parameter and gradient with float32 moments: the plain
    rule's parameter bit-equal to the reference's jnp rule (float32
    arithmetic, rounded once to float16), moments at 1e-6."""
    rs = np.random.RandomState(2)
    p, g = rs.randn(3, 50).astype(np.float32), rs.randn(3, 50) \
        .astype(np.float32)
    m1, m2 = rs.rand(3, 50).astype(np.float32), rs.rand(3, 50) \
        .astype(np.float32)
    jp, jg = jnp.asarray(p, jnp.float16), jnp.asarray(g, jnp.float16)
    ref = jopt.AdamW._update_rule((0.9, 0.999, 1e-8, 0.01), jp, jg,
                                  jnp.float32(1e-3), jnp.int32(3), m1, m2)
    got = [_t(p, torch.float16), _t(g, torch.float16), _t(m1.copy()),
           _t(m2.copy())]
    ck.adamw_plain(*got, 1e-3, 3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                   coeff=0.01)
    assert got[0].dtype == torch.float16
    np.testing.assert_array_equal(_np32(got[0]), _np32(ref[0]))
    for a, b in zip(got[2:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# GradScaler


def _scaler_pair(**kw):
    return jamp.GradScaler(**kw), amp.GradScaler(**kw)


def _opt_pair(dtype="float32", n=5, seed=0):
    rs = np.random.RandomState(seed)
    init = [rs.randn(n).astype(np.float32), rs.randn(2, n).astype(np.float32)]
    jd = getattr(jnp, dtype)
    jps = [JParam(a) for a in init]
    for p in jps:
        p._data = jnp.asarray(p._data).astype(jd)
    tps = [torch.nn.Parameter(_t(a, getattr(torch, dtype))) for a in init]
    # Adagrad keeps a float16 parameter's dtype on both sides (the
    # reference's SGD returns float32 from float16, ROADMAP.md section 3)
    return (jps, jopt.Adagrad(learning_rate=0.1, parameters=jps),
            tps, topt.Adagrad(learning_rate=0.1, parameters=tps,
                              device="cpu"))


def _grads_by_hand(jps, tps, grads, dtype):
    for p, g in zip(jps, grads):
        p._grad = JTensor(jnp.asarray(g).astype(getattr(jnp, dtype)),
                          _internal=True)
    for p, g in zip(tps, grads):
        p.grad = _t(g, getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
@pytest.mark.parametrize("scale", [2.0 ** 15, 1000.0])
def test_unscale_rounds_the_inverse_scale_to_the_gradient_dtype(dtype,
                                                                scale):
    """unscale_ multiplies each gradient by 1 / scale rounded to the
    gradient's dtype, as the reference's weak python float is: bit-equal
    at a power of two and at 1000.0 (where the rounding of 1 / 1000
    shows: the float32 product differs)."""
    js, ts = _scaler_pair(init_loss_scaling=scale)
    jps, jo, tps, to = _opt_pair(dtype)
    rs = np.random.RandomState(4)
    grads = [(rs.randn(*np.shape(p._data)) * 300).astype(np.float32)
             for p in jps]
    _grads_by_hand(jps, tps, grads, dtype)
    js.unscale_(jo)
    ts.unscale_(to)
    assert not ts._read_found_inf() and not js._found_inf
    for jp, tp in zip(jps, tps):
        assert tp.grad.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np32(tp.grad), _np32(jp._grad._data))
    if dtype != "float32" and scale == 1000.0:
        f32 = _t(grads[0], getattr(torch, dtype)).float() * (1.0 / scale)
        assert not torch.equal(f32.to(getattr(torch, dtype)), tps[0].grad)


def test_grad_scaler_state_machine_matches_the_reference():
    """11 steps with inf or NaN planted in the gradients at steps 2, 3, 8
    and 9: skipped steps leave the parameters (and the step count) as they
    were, the scale halves after 2 bad steps in a row and doubles after 3
    good ones, on both sides; the state dicts agree at the end and load
    both ways."""
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    js, ts = _scaler_pair(**kw)
    jps, jo, tps, to = _opt_pair("float16")
    rs = np.random.RandomState(5)
    history = []
    for step in range(11):
        grads = [(rs.randn(*np.shape(p._data)) * 10).astype(np.float32)
                 for p in jps]
        if step in (2, 8):
            grads[0][1] = np.inf
        if step in (3, 9):
            grads[1][0, 0] = np.nan
        _grads_by_hand(jps, tps, grads, "float16")
        before = [p.detach().clone() for p in tps]
        js.step(jo)
        ts.step(to)
        skipped = all(torch.equal(a, b) for a, b in zip(before, tps))
        history.append((ts.get_init_loss_scaling(), skipped))
        assert js.get_init_loss_scaling() == ts.get_init_loss_scaling()
        assert (js._good_steps, js._bad_steps) == (ts._good_steps,
                                                   ts._bad_steps)
        for jp, tp in zip(jps, tps):
            np.testing.assert_array_equal(_np32(tp), _np32(jp._data))
    assert [s for _, s in history] == [i in (2, 3, 8, 9)
                                       for i in range(11)]
    assert [s for s, _ in history] == [1024.0, 1024.0, 1024.0, 512.0, 512.0,
                                       512.0, 1024.0, 1024.0, 1024.0, 512.0,
                                       512.0]
    assert to._step_count == jo._step_count == 7
    assert ts.state_dict() == js.state_dict()
    fresh_j, fresh_t = _scaler_pair()
    fresh_t.load_state_dict(js.state_dict())
    fresh_j.load_state_dict(ts.state_dict())
    assert fresh_t.state_dict() == fresh_j.state_dict() == js.state_dict()


def test_grad_scaler_floor_static_and_disabled():
    """The scale never drops below 1.0; without dynamic scaling it stays
    put; a disabled scaler passes the loss through and steps the
    optimizer; the getters and set_init_loss_scaling; minimize is step."""
    for kw in (dict(init_loss_scaling=2.0),
               dict(init_loss_scaling=8.0, use_dynamic_loss_scaling=False)):
        js, ts = _scaler_pair(**kw)
        jps, jo, tps, to = _opt_pair("float32")
        for _ in range(3):
            _grads_by_hand(jps, tps, [np.full(np.shape(p._data), np.inf,
                                              np.float32) for p in jps],
                           "float32")
            js.minimize(jo, None)
            ts.minimize(to, None)
            assert js.get_init_loss_scaling() == ts.get_init_loss_scaling()
        assert ts.get_init_loss_scaling() == (
            1.0 if ts.is_use_dynamic_loss_scaling() else 8.0)
        assert ts.is_use_dynamic_loss_scaling() == \
            js.is_use_dynamic_loss_scaling()
    ts.set_init_loss_scaling(3.0)
    assert ts.get_init_loss_scaling() == 3.0
    off = amp.GradScaler(enable=False)
    assert not off.is_enable()
    loss = torch.tensor(2.0)
    assert off.scale(loss) is loss
    jps, jo, tps, to = _opt_pair("float32")
    _grads_by_hand(jps, tps, [np.ones(np.shape(p._data), np.float32)
                              for p in jps], "float32")
    off.step(to)
    assert to._step_count == 1


def test_eager_float16_loop_without_auto_cast_matches_the_reference():
    """The reference's dygraph AMP recipe (scale, backward, step,
    clear_grad) at decorate O2 float16 without auto_cast, gpt_tiny,
    dropout 0, GradScaler(init_loss_scaling=2**15): the float16 loss
    times 2^15 overflows, every step is skipped, and the scale goes 32768
    -> 16384 -> 8192 -> 4096 on both sides; the parameters do not move."""
    ref, port = _gpt_pair()
    jo = jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                    parameters=ref.parameters())
    to = topt.AdamW(learning_rate=LR, weight_decay=0.01,
                    parameters=port.parameters(), device="cpu")
    ref, jo = jamp.decorate(ref, jo, level="O2", dtype="float16")
    port, to = amp.decorate(port, to, level="O2", dtype="float16")
    js, ts = _scaler_pair(init_loss_scaling=2.0 ** 15)
    jc, tc = JCriterion(), GPTPretrainingCriterion()
    start = [p.detach().clone() for p in port.parameters()]
    scales = {"jax": [js.get_init_loss_scaling()],
              "port": [ts.get_init_loss_scaling()]}
    for x, y in _batches(3, seed=8):
        jl = jc(ref(paddle.to_tensor(x)), paddle.to_tensor(y))
        tl = tc(port(torch.from_numpy(x)), torch.from_numpy(y))
        assert tl.dtype == torch.float16 and str(jl.dtype).endswith(
            "float16")
        np.testing.assert_allclose(float(tl.detach()),
                                   float(np.asarray(jl.numpy())), rtol=2e-3)
        js.scale(jl).backward()
        ts.scale(tl).backward()
        js.step(jo)
        ts.step(to)
        jo.clear_grad()
        to.clear_grad()
        scales["jax"].append(js.get_init_loss_scaling())
        scales["port"].append(ts.get_init_loss_scaling())
    assert scales["jax"] == scales["port"] == [32768.0, 16384.0, 8192.0,
                                               4096.0]
    assert to._step_count == jo._step_count == 0
    for a, b in zip(start, port.parameters()):
        assert torch.equal(a, b)
