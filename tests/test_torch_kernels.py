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
from paddle_tpu_torch.inference.serving import cache as tcache
from paddle_tpu_torch.ops import cuda_kernels as ck

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

    @pytest.mark.parametrize("case", ["mask", "tq_above_tk", "wide_head",
                                      "float16"])
    def test_rejected_input_raises(self, case):
        # the checks run before the device branch, so what the card's
        # kernel refuses raises here too instead of turning into None
        Tq, Tk, D = {"tq_above_tk": (16, 8, 16),
                     "wide_head": (8, 8, 160)}.get(case, (8, 8, 16))
        q, k, v = (_t(a) for a in _qkv(1, 2, Tq, Tk, D, seed=0))
        mask = torch.zeros(Tq, Tk) if case == "mask" else None
        if case == "float16":
            q, k, v = q.half(), k.half(), v.half()
        before = ck.attention_path_counts()["flash"]
        with pytest.raises(ValueError):
            ck.flash_attention_or_none(q, k, v, mask, True)
        assert ck.attention_path_counts()["flash"] == before


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

    @pytest.mark.parametrize("D,T", [(12, T_CACHE), (D_HEAD, 7), (24, 100)])
    def test_takes_any_depth_and_width(self, D, T):
        # no block tiles T=7 or T=100 and D % 8 != 0 for D=12: the
        # reference gate refuses these, the port's kernel takes them
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
