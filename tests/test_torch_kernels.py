"""Kernel modules of the PyTorch port against the JAX package, on the CPU.

The port's kernel wrappers run their plain PyTorch versions on CPU
tensors; the JAX side runs its Pallas kernels in interpret mode, the way
its own tests run them. Inputs are made with numpy from a seed and handed
to both. Tolerances: float32 1e-5 (two float32 implementations that sum in
different orders), bfloat16 2e-2 (one bf16 rounding of the output),
int8 caches 1e-4 (dequantized values up to ~3, float32 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import cache as jcache
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.inference.serving import cache as tcache
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return t if dtype is None else t.to(dtype)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# flash-attention forward


def _qkv(B, H, Tq, Tk, D, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, Tq, D).astype(np.float32),
            rs.randn(B, H, Tk, D).astype(np.float32),
            rs.randn(B, H, Tk, D).astype(np.float32))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T", [8, 16, 40, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_xla(causal, T, dtype, atol):
    q, k, v = _qkv(2, 3, T, T, 16, seed=T)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want_pallas, _ = pk._flash_fwd(jq, jk, jv, causal, interpret=True,
                                   need_lse=False)
    want_xla = pk._xla_attention(jq, jk, jv, causal)
    got = ck.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    np.testing.assert_allclose(_np32(got), _np32(want_pallas), atol=atol,
                               rtol=atol)
    np.testing.assert_allclose(_np32(got), _np32(want_xla), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("Tq,Tk", [(16, 48), (8, 40)])
def test_flash_plain_bottom_right_causal(Tq, Tk):
    # Tq < Tk: a query at row i sees keys j <= i + Tk - Tq
    q, k, v = _qkv(1, 2, Tq, Tk, 16, seed=Tq + Tk)
    want, _ = pk._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            True, interpret=True, need_lse=False)
    got = ck.flash_attention(_t(q), _t(k), _t(v), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_flash_strided_views_take_the_same_values():
    # the model hands the kernel q/k/v as views of one fused qkv tensor
    rs = np.random.RandomState(3)
    qkv = _t(rs.randn(2, 24, 3, 4, 16).astype(np.float32))
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    got = ck.flash_attention(q, k, v, True)
    want = ck.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


class TestFlashGate:
    def test_takes_eligible_inputs(self):
        q, k, v = (_t(a) for a in _qkv(1, 2, 32, 32, 64, seed=0))
        before = ck.attention_path_counts()["flash"]
        assert ck.flash_attention_or_none(q, k, v, None, True) is not None
        assert ck.attention_path_counts()["flash"] == before + 1

    def test_flag_off_is_the_only_way_to_none(self):
        q, k, v = (_t(a) for a in _qkv(1, 2, 8, 8, 16, seed=0))
        saved = get_flags("use_flash_attention")
        set_flags({"use_flash_attention": False})
        try:
            assert ck.flash_attention_or_none(q, k, v, None, True) is None
            assert ck.flash_attention_or_none(q, k, v, torch.zeros(8, 8),
                                              False) is None
        finally:
            set_flags(saved)

    @pytest.mark.parametrize("case", ["negative_p", "tq_above_tk",
                                      "wide_head", "float16"])
    def test_rejected_input_raises(self, case):
        # the checks run before the device branch, so what the card's
        # kernel refuses raises here too instead of turning into None
        Tq, Tk, D = {"tq_above_tk": (16, 8, 16),
                     "wide_head": (8, 8, 160)}.get(case, (8, 8, 16))
        q, k, v = (_t(a) for a in _qkv(1, 2, Tq, Tk, D, seed=0))
        p = -0.1 if case == "negative_p" else 0.0
        if case == "float16":
            # float16 is taken (its own kernel instances); a float16 q
            # with float32 k and v is not
            q = q.half()
        before = ck.attention_path_counts()["flash"]
        with pytest.raises(ValueError):
            ck.flash_attention_or_none(q, k, v, None, True, dropout_p=p)
        assert ck.attention_path_counts()["flash"] == before

    @pytest.mark.parametrize("case", ["mask", "p_one"])
    def test_mask_and_p_one_take_the_plain_route(self, case):
        # as the reference's gate: None with the flag on, for an additive
        # mask (its kernel takes none) and p >= 1 (everything dropped);
        # the caller's composed attention then runs (path xla_sdpa)
        q, k, v = (_t(a) for a in _qkv(1, 2, 8, 8, 16, seed=0))
        mask = torch.zeros(8, 8) if case == "mask" else None
        p = 1.0 if case == "p_one" else 0.0
        before = ck.attention_path_counts()
        assert ck.flash_attention_or_none(q, k, v, mask, True,
                                          dropout_p=p) is None
        assert ck.attention_path_counts() == before


# ---------------------------------------------------------------------------
# paged decode

T_CACHE, D_HEAD = 96, 16


def _quantize_np(x):
    amax = np.abs(x).astype(np.float32).max(-1)
    scale = np.maximum(amax, 1e-8) / np.float32(127.0)
    q = np.clip(np.round(x.astype(np.float32) / scale[..., None]),
                -127.0, 127.0).astype(np.int8)
    return q, scale.astype(np.float32)


def _paged_inputs(lens, quantized, nan_tail, H=2, T=T_CACHE, D=D_HEAD,
                  seed=0):
    """numpy inputs; the cache tail past lens is NaN garbage when asked
    (uninitialized pages, the hostile case)."""
    rs = np.random.RandomState(seed)
    B = len(lens)
    lens = np.asarray(lens, np.int32)
    q, nk, nv = (rs.randn(B, H, 1, D).astype(np.float32) for _ in range(3))
    kf = rs.randn(B, H, T, D).astype(np.float32)
    vf = rs.randn(B, H, T, D).astype(np.float32)
    ks = vs = None
    if quantized:
        kf, ks = _quantize_np(kf)
        vf, vs = _quantize_np(vf)
        tails = (ks, vs)
    else:
        tails = (kf, vf)
    if nan_tail:
        for b in range(B):
            for a in tails:
                a[b, :, lens[b]:] = np.nan
    return q, kf, vf, lens, nk, nv, ks, vs


def _run_both(args):
    q, kc, vc, lens, nk, nv, ks, vs = args
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    want = pk._paged_decode(*jargs, block_k=pk._paged_block(kc.shape[2]),
                            interpret=True)
    targs = [None if a is None else _t(a.copy()) for a in args]
    out = ck.paged_decode(*targs)
    return out, targs, want


def _check_paged(args, atol):
    """Output vs the Pallas kernel; the in-place cache vs the buffers the
    Pallas kernel returns. The appended int8 row is held bit for bit to
    quantize_kv's rule (numpy, IEEE division). The jitted Pallas
    interpret run may round a scale 1 ulp away from that rule, so against
    it the scales get rtol 2e-7 and the int8 payload +-1."""
    out, targs, want = _run_both(args)
    lens, nk, nv = args[3], args[4], args[5]
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), atol=atol,
                               rtol=atol)
    T = args[1].shape[2]
    quantized = args[6] is not None
    got = [t.numpy() for t in targs[1:3] + (targs[6:8] if quantized
                                             else [])]
    ref = [np.asarray(w) for w in want[1:]][:len(got)]
    if quantized:
        (kq, ks), (vq, vs) = _quantize_np(nk), _quantize_np(nv)
        rule = [kq, vq, ks, vs]
    else:
        rule = [nk, nv]
    for i, (g, r) in enumerate(zip(got, ref)):
        for b in range(len(lens)):
            cl = min(int(lens[b]), T - 1)
            np.testing.assert_array_equal(g[b, :, :cl], r[b, :, :cl])
            np.testing.assert_array_equal(g[b, :, cl], rule[i][b, :, 0])
            if not quantized:
                np.testing.assert_array_equal(g[b, :, cl], r[b, :, cl])
            elif i < 2:
                assert np.abs(g[b, :, cl].astype(np.int32)
                              - r[b, :, cl].astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(g[b, :, cl], r[b, :, cl],
                                           rtol=2e-7, atol=0)


LENS_CASES = {
    "idle_slot": (0, 5),
    "inside_block": (5, 40),
    "block_edge": (31, 32),
    "last_row": (T_CACHE - 1, 17),
    "full_clamp": (T_CACHE, T_CACHE),
}


@pytest.mark.parametrize("case", sorted(LENS_CASES))
@pytest.mark.parametrize("quantized,atol", [(False, 1e-5), (True, 1e-4)])
def test_paged_plain_matches_pallas(case, quantized, atol):
    _check_paged(_paged_inputs(LENS_CASES[case], quantized,
                               nan_tail=case != "full_clamp"), atol)


@pytest.mark.parametrize("quantized,atol", [(False, 1e-5), (True, 1e-4)])
def test_paged_plain_ragged_batch_with_nan_tails(quantized, atol):
    args = _paged_inputs((0, 1, 33, 64, 95), quantized, nan_tail=True)
    _check_paged(args, atol)
    out, _, _ = _run_both(args)
    assert np.isfinite(out.numpy()).all()


def test_paged_plain_sequential_steps_cross_a_block():
    # one slot grows across the 32-row block edge, the port's cache
    # updated in place and the reference's threaded kernel to kernel
    args = list(_paged_inputs((29,), False, nan_tail=True, seed=5))
    jstate = [None if a is None else jnp.asarray(a) for a in args]
    tstate = [None if a is None else _t(a.copy()) for a in args]
    rs = np.random.RandomState(9)
    blk = pk._paged_block(T_CACHE)
    for _ in range(6):
        want = pk._paged_decode(*jstate, block_k=blk, interpret=True)
        got = ck.paged_decode(*tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[0]),
                                   atol=1e-5, rtol=1e-5)
        jstate[1], jstate[2] = want[1], want[2]
        ln = int(np.asarray(jstate[3])[0]) + 1
        jstate[3] = jnp.asarray([ln], jnp.int32)
        tstate[3] = torch.tensor([ln], dtype=torch.int32)
        nk, nv = (rs.randn(1, 2, 1, D_HEAD).astype(np.float32)
                  for _ in range(2))
        jstate[4], jstate[5] = jnp.asarray(nk), jnp.asarray(nv)
        tstate[4], tstate[5] = _t(nk), _t(nv)


class TestPagedGate:
    def _args(self, D=D_HEAD, T=T_CACHE):
        a = _paged_inputs((3, 7), False, nan_tail=False, D=D, T=T)
        return [_t(x) for x in a[:6]]

    def test_takes_eligible_inputs(self):
        before = ck.attention_path_counts()["paged_flash"]
        assert ck.paged_decode_attention_or_none(*self._args()) is not None
        assert ck.attention_path_counts()["paged_flash"] == before + 1

    def test_flag_off_is_the_only_way_to_none(self):
        saved = get_flags("paged_flash_decode")
        set_flags({"paged_flash_decode": False})
        try:
            assert ck.paged_decode_attention_or_none(*self._args()) is None
        finally:
            set_flags(saved)

    @pytest.mark.parametrize("D,T", [(12, T_CACHE), (D_HEAD, 7), (24, 100),
                                     (D_HEAD, 16384)])
    def test_takes_any_depth_and_width(self, D, T):
        # no block tiles T=7 or T=100 and D % 8 != 0 for D=12: the
        # reference gate refuses these, the port's kernel takes them; no
        # shared array of the kernel grows with T, so a cache deeper than
        # 8192 rows is taken too
        args = self._args(D=D, T=T)
        want = ck.paged_decode_plain(*[a.clone() for a in args])
        got = ck.paged_decode_attention_or_none(*args)
        np.testing.assert_array_equal(got.numpy(), want.numpy())

    @pytest.mark.parametrize("case", ["wide_head", "int64_lens",
                                      "float64_query", "strided_cache"])
    def test_rejected_input_raises(self, case):
        args = self._args(D=160) if case == "wide_head" else self._args()
        if case == "int64_lens":
            args[3] = args[3].long()
        elif case == "float64_query":
            args[0] = args[0].double()
        elif case == "strided_cache":
            args[1] = args[1].transpose(2, 3).contiguous().transpose(2, 3)
        before = ck.attention_path_counts()["paged_flash"]
        with pytest.raises(ValueError):
            ck.paged_decode_attention_or_none(*args)
        assert ck.attention_path_counts()["paged_flash"] == before


# ---------------------------------------------------------------------------
# int8 quantization


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_bit_equal_to_reference(seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(3, 4, 37, 64) * rs.choice([1e-3, 1.0, 50.0],
                                             (3, 4, 37, 1))).astype(
        np.float32)
    x[0, 0, 0] = 0.0                           # zero row: the eps floor
    x[0, 0, 1, :2] = [127.0, 0.5]              # exact .5 ties
    x[0, 0, 2, :2] = [-127.0, 2.5]
    jq, js = jcache.quantize_kv(jnp.asarray(x))
    tq, ts = ck.quantize_kv(_t(x))
    assert tcache.quantize_kv is ck.quantize_kv     # one rule, re-exported
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(
        ck.dequantize_kv(tq, ts).numpy(),
        np.asarray(jcache.dequantize_kv(jq, js)))


# ---------------------------------------------------------------------------
# flash-attention training forward (lse, dropout) and backward
#
# The port's plain versions against `_flash_fwd` / `_flash_bwd` in Pallas
# interpret mode, both fed the same numpy-made dropout bits (the JAX
# interpret path takes an explicit [B*H, Tq, Tk] bits slab). Tolerances:
# float32 5e-5 (sums in another order through a softmax and two products),
# bfloat16 5e-2 (bfloat16 inputs and outputs, one rounding each).

# (B, H, Tq, Tk, D, causal, block_q, block_k): test_pallas_fused.py's
# single-block configs, then its multi-block grids (incl. Tq < Tk causal)
FLASH_TRAIN_CFGS = [
    (2, 3, 32, 32, 16, False, 128, 128), (2, 3, 32, 32, 16, True, 128, 128),
    (1, 2, 16, 48, 8, True, 128, 128), (2, 2, 64, 64, 32, False, 128, 128),
    (1, 2, 64, 64, 16, True, 16, 16), (1, 2, 64, 64, 16, False, 16, 32),
    (1, 1, 32, 64, 8, True, 16, 16)]
FLASH_TRAIN_CASES = (
    [(cfg, p, "float32") for cfg in FLASH_TRAIN_CFGS for p in (0.0, 0.1)]
    + [(FLASH_TRAIN_CFGS[i], 0.5, "float32") for i in (1, 2, 5)]
    + [(FLASH_TRAIN_CFGS[i], p, "bfloat16") for i in (1, 2, 4)
       for p in (0.0, 0.1)])


def _train_inputs(B, H, Tq, Tk, D, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v = _qkv(B, H, Tq, Tk, D, seed)
    g = rs.randn(B, H, Tq, D).astype(np.float32)
    bits = rs.randint(0, 2 ** 32, (B * H, Tq, Tk), dtype=np.uint64)
    return q, k, v, g, bits


@pytest.mark.parametrize("cfg,p,dtype", FLASH_TRAIN_CASES)
def test_flash_train_plain_matches_pallas(cfg, p, dtype):
    B, H, Tq, Tk, D, causal, bq, bk = cfg
    atol = 5e-5 if dtype == "float32" else 5e-2
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, k, v, g, bits = _train_inputs(B, H, Tq, Tk, D)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jbits = jnp.asarray(bits.astype(np.uint32)) if p else None
    jo, jlse = pk._flash_fwd(jq, jk, jv, causal, block_q=bq, block_k=bk,
                             interpret=True, dropout_p=p, rng=jbits)
    jgrads = pk._flash_bwd(jq, jk, jv, jo, jlse, jg, causal, block_q=bq,
                           block_k=bk, interpret=True, dropout_p=p,
                           rng=jbits)
    tq, tk, tv, tg = (_t(a, tdt) for a in (q, k, v, g))
    tbits = _t(bits.astype(np.int64)) if p else None
    o, lse = ck.flash_fwd_train_plain(tq, tk, tv, causal, p, tbits)
    dq, delta = ck.flash_bwd_dq_plain(tq, tk, tv, o, tg, lse, causal, p,
                                      tbits)
    dk, dv = ck.flash_bwd_dkv_plain(tq, tk, tv, tg, lse, delta, causal, p,
                                    tbits)
    assert lse.shape == (B * H, Tq) and lse.dtype == torch.float32
    for t in (o, dq, dk, dv):
        assert t.dtype == tdt
    np.testing.assert_allclose(_np32(o), _np32(jo), atol=atol, rtol=atol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=atol, rtol=atol)
    for got, want in zip((dq, dk, dv), jgrads):
        np.testing.assert_allclose(_np32(got), _np32(want), atol=atol,
                                   rtol=atol)


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("Tq,Tk,causal", [(24, 24, True), (8, 40, True),
                                          (24, 24, False)])
def test_flash_plain_backward_matches_autograd(Tq, Tk, causal, p):
    # dq/dk/dv of the plain backward equal torch.autograd through the
    # dense plain forward with the same keep mask
    q, k, v, g, bits = _train_inputs(2, 2, Tq, Tk, 16, seed=Tq + Tk)
    tbits = _t(bits.astype(np.int64)) if p else None
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    keep = ck._keep_mask(tbits, p, (2, 2, Tq, Tk)) if p else None
    out = ck.flash_attention_plain(tq, tk, tv, causal, keep=keep,
                                   dropout_p=p)
    want = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    with torch.no_grad():
        o, lse = ck.flash_fwd_train_plain(tq, tk, tv, causal, p, tbits)
        dq, delta = ck.flash_bwd_dq_plain(tq, tk, tv, o, _t(g), lse, causal,
                                          p, tbits)
        dk, dv = ck.flash_bwd_dkv_plain(tq, tk, tv, _t(g), lse, delta,
                                        causal, p, tbits)
    np.testing.assert_allclose(o.numpy(), out.detach().numpy(), atol=1e-5,
                               rtol=1e-5)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_training_grads_flow_through_flash_function(causal):
    # the repaired fault: with the flag on, a training call must go
    # through FlashAttentionFunction, whose backward gives q, k and v the
    # gradients of the plain attention
    from paddle_tpu_torch.nn import functional as F
    q, k, v, g, _ = _train_inputs(2, 3, 24, 24, 16, seed=4)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    before = ck.attention_path_counts()["flash"]
    out = F.scaled_dot_product_attention(tq, tk, tv, dropout_p=0.0,
                                         is_causal=causal, training=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert ck.attention_path_counts()["flash"] == before + 1
    out.backward(_t(g))
    rq, rk, rv = (_t(a).requires_grad_() for a in (q, k, v))
    ck.flash_attention_plain(rq, rk, rv, causal).backward(_t(g))
    for got, want in ((tq, rq), (tk, rk), (tv, rv)):
        assert got.grad is not None
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_flash_function_with_dropout_regenerates_one_mask():
    # forward and backward draw the same Philox bits: the Function's
    # gradients equal autograd through the plain forward fed those bits
    q, k, v, g, _ = _train_inputs(1, 2, 20, 20, 8, seed=6)
    prandom.seed(11)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    before = ck.attention_path_counts()["flash_dropout"]
    out = ck.flash_attention_or_none(tq, tk, tv, None, True, dropout_p=0.25)
    assert ck.attention_path_counts()["flash_dropout"] == before + 1
    out.backward(_t(g))
    prandom.seed(11)
    seed, offset = prandom.next_seed_offset()
    bits = ck.attn_dropout_bits(prandom.philox_word(seed, offset, "cpu"), 0,
                                2, 20, 20)
    rq, rk, rv = (_t(a).requires_grad_() for a in (q, k, v))
    want = ck.flash_attention_plain(
        rq, rk, rv, True, keep=ck._keep_mask(bits, 0.25, (1, 2, 20, 20)),
        dropout_p=0.25)
    want.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=1e-5, rtol=1e-5)
    for got, w in ((tq, rq), (tk, rk), (tv, rv)):
        np.testing.assert_allclose(got.grad.numpy(), w.grad.numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_flash_function_without_grad_skips_lse():
    # the serving path: no input needs a gradient, so nothing is saved
    q, k, v, _, _ = _train_inputs(1, 2, 8, 8, 16)
    out = ck.FlashAttentionFunction.apply(_t(q), _t(k), _t(v), True, 0.0,
                                          None, 0)
    assert out.grad_fn is None
    np.testing.assert_allclose(
        out.numpy(), ck.flash_attention(_t(q), _t(k), _t(v), True).numpy())


def test_flash_gate_refuses_dropout_one():
    # the gate hands p = 1 to the caller's plain attention, as the
    # reference's does, launching nothing; the kernel's own wrapper still
    # refuses it
    q, k, v = (_t(a) for a in _qkv(1, 2, 8, 8, 16, seed=0))
    before = ck.launch_counts()
    assert ck.flash_attention_or_none(q, k, v, None, True,
                                      dropout_p=1.0) is None
    assert ck.launch_counts() == before
    word = prandom.philox_word(1, 0, "cpu")
    with pytest.raises(ValueError, match="dropout_p"):
        ck.flash_fwd_train(q, k, v, True, 1.0, word, 0)


# ---------------------------------------------------------------------------
# attention-dropout bits (Philox-4x32-10)


def test_philox_known_answers():
    # Random123's known-answer vectors for philox4x32-10
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = ck._philox4x32_10(*(torch.tensor([c]) for c in ctr), *key)
        assert tuple(int(w) for w in got) == want


def test_dropout_bits_layout_and_rate():
    seed, offset = 0x0123456789ABCDEF, 5
    word = prandom.philox_word(seed, offset, "cpu")
    bits = ck.attn_dropout_bits(word, 0, 3, 10, 7)
    assert bits.shape == (3, 10, 7) and bits.dtype == torch.int64
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    # element (bh, row, col) is word row % 4 of the counter
    # (col, row // 4, bh, offset) under the key (seed lo, seed hi)
    bh, row, col = 2, 9, 4
    words = ck._philox4x32_10(torch.tensor([col]), torch.tensor([row // 4]),
                              torch.tensor([bh]), torch.tensor([offset]),
                              seed & 0xFFFFFFFF, seed >> 32)
    assert int(bits[bh, row, col]) == int(words[row % 4])
    # another offset (the word's base + delta 1) is another mask; the keep
    # rate follows p
    assert not torch.equal(bits, ck.attn_dropout_bits(word, 1, 3, 10, 7))
    big = ck.attn_dropout_bits(word, 0, 4, 128, 128)
    drop = (big < int(0.1 * 2 ** 32)).double().mean().item()
    n = big.numel()
    assert abs(drop - 0.1) < 5 * (0.1 * 0.9 / n) ** 0.5


# ---------------------------------------------------------------------------
# fused AdamW


def _adam_case(shape, seed=0, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(dtype), rs.randn(*shape).astype(dtype),
            rs.rand(*shape).astype(np.float32),
            rs.rand(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,coeff", [((4, 128), 0.01), ((256,), 0.0),
                                         ((8, 128), 0.1), ((7,), 0.01)])
def test_adamw_plain_matches_pallas_and_jnp_rule(shape, coeff):
    from paddle_tpu.optimizer import Adam, AdamW
    p, g, m1, m2 = _adam_case(shape)
    lr, t = jnp.float32(1e-3), jnp.int32(7)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=coeff)
    sa = (0.9, 0.999, 1e-8, coeff)
    refs = [AdamW._update_rule(sa, p, g, lr, t, m1, m2) if coeff
            else Adam._update_rule(sa[:3], p, g, lr, t, m1, m2)]
    fused = pk.fused_adamw_or_none(p, g, lr, t, m1, m2, interpret=True, **kw)
    # the TPU kernel takes numel % 128 == 0 only; the port takes any
    assert (fused is None) == (int(np.prod(shape)) % 128 != 0)
    if fused is not None:
        refs.append(fused)
    got = [_t(a.copy()) for a in (p, g, m1, m2)]
    ck.adamw_plain(*got, 1e-3, 7, **kw)
    for ref in refs:
        for a, b in zip((got[0], got[2], got[3]), ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)


def test_adamw_bf16_param_matches_jnp_rule():
    from paddle_tpu.optimizer import AdamW
    p, g, m1, m2 = _adam_case((3, 50), seed=2)
    jp, jg = jnp.asarray(p, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    ref = AdamW._update_rule((0.9, 0.999, 1e-8, 0.01), jp, jg,
                             jnp.float32(1e-3), jnp.int32(3), m1, m2)
    got = [_t(p, torch.bfloat16), _t(g, torch.bfloat16), _t(m1.copy()),
           _t(m2.copy())]
    ck.adamw_plain(*got, 1e-3, 3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                   coeff=0.01)
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got[0]), _np32(ref[0]))
    for a, b in zip(got[2:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def test_adamw_gate_and_launch_counter():
    p, g, m1, m2 = (_t(a) for a in _adam_case((5, 3)))
    want = [x.clone() for x in (p, g, m1, m2)]
    ck.adamw_plain(*want, 1e-3, 2, beta1=0.9, beta2=0.999, epsilon=1e-8,
                   coeff=0.0)
    before = ck.launch_counts()["adamw"]
    sc = torch.from_numpy(ck.adam_step_scalars(1e-3, 2, 0.9, 0.999))
    out = ck.fused_adamw_or_none(p, g, sc, m1, m2, beta1=0.9,
                                 beta2=0.999, epsilon=1e-8, coeff=0.0)
    assert out[0] is p and out[1] is m1 and out[2] is m2      # in place
    assert ck.launch_counts()["adamw"] == before              # CPU: plain
    for a, b in zip((p, m1, m2), (want[0], want[2], want[3])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    saved = get_flags("use_fused_optimizer")
    set_flags({"use_fused_optimizer": False})
    try:
        assert ck.fused_adamw_or_none(p, g, sc, m1, m2, beta1=0.9,
                                      beta2=0.999, epsilon=1e-8,
                                      coeff=0.0) is None
    finally:
        set_flags(saved)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        ck.fused_adamw_or_none(p.double(), g.double(), sc, m1, m2,
                               beta1=0.9, beta2=0.999, epsilon=1e-8,
                               coeff=0.0)


def test_bias_corrections_match_jnp_power():
    # c = 1 - b^t on the host in float32 (np.float32 power) against the
    # reference's jnp.power: equal at the t the tests use; over
    # t = 1..20000, c1 within 2 ulp and c2 within 64 ulp (where 1 - b^t
    # cancels), which the 1e-6 tolerances above absorb
    ts = np.arange(1, 20001, dtype=np.float32)
    for b, worst in ((0.9, 2), (0.999, 64)):
        host = np.float32(1) - np.float32(b) ** ts
        ref = np.asarray(1 - jnp.power(jnp.float32(b), jnp.asarray(ts)))
        ulps = np.abs(host.view(np.int32).astype(np.int64)
                      - ref.view(np.int32).astype(np.int64))
        assert ulps.max() <= worst
        for t in (1, 2, 3, 7, 1000):
            assert ulps[t - 1] == 0
        sc = ck._adam_scalars(1e-3, 7, b, b, 1e-8, 0.0)
        assert sc["c1"] == host[6]
