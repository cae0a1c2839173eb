"""The float32 flash-attention forward kernel's work split, on the CPU.

`flash_attention` and `flash_fwd_train` take float32 inputs to the
CUDA-core kernel (ops/csrc/flash_fwd.cu, namespace f32), which cannot run
here. This file repeats its algebra in float32 PyTorch: each CTA's 16
query rows against their causal key range, cut into tiles of
`flash_f32_geometry`'s size and dealt out to its warps in turn; each warp
an online softmax over its own tiles (S scaled after the product, l from
the undropped p, P V from the dropped p); the warps' states combined in
warp order (out = sum acc_w e^(m_w - M) / sum l_w e^(m_w - M), times
1 / (1 - p), lse = M + log L). The mirror is held against the plain
version and the JAX package's Pallas `_flash_fwd` in interpret mode on the
same numpy inputs, as the card check holds the kernel: check_flash's
float32 serving cases (p = 0, no lse) within the absolute TOL["float32"],
check_flash_train's float32 cases with lse, at p 0 and 0.1 through the
kernels' dropout bits (`attn_dropout_bits_plain`), within
REL_TOL["float32"] and lse within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import REL_TOL, TOL, abs_rel_err
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

ROWS = 16                   # query rows a CTA
LSE_TOL = 1e-5
SEED, OFFSET = 0x1234_5678_9ABC_DEF0, 7


def _warp_state(s, keep, v, tiles):
    """A warp's (m, l, acc) over its `tiles` (key slices) of scores s
    [B, H, R, Tk] (-inf where dead); no tile: (-inf, 0, 0)."""
    B, H, R, _ = s.shape
    m = torch.full((B, H, R, 1), -float("inf"))
    l = torch.zeros((B, H, R, 1))
    acc = torch.zeros((B, H, R, v.shape[-1]))
    for keys in tiles:
        st = s[..., keys]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        # a row with no live key yet keeps m = -inf and subtracts 0
        m_sub = torch.where(m_new == -float("inf"), 0.0, m_new)
        p = torch.exp(st - m_sub)
        alpha = torch.exp(m - m_sub)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., keys], p, 0.0)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         v[..., keys, :])
        m = m_new
    return m, l, acc


def mirror_fwd(q, k, v, causal, p=0.0, bits=None):
    """(out, lse [B*H, Tq]) as the float32 kernel forms them."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    warps, tile = ck.flash_f32_geometry(Tq, Tk, D, causal)
    shift = Tk - Tq
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * (float(D) ** -0.5)
    if causal:
        live = torch.ones((Tq, Tk), dtype=torch.bool).tril(shift)
        s = torch.where(live, s, -float("inf"))
    keep = ck._keep_mask(bits, p, s.shape) if p else None
    scale = ck._drop_args(p)[1] if p else 1.0
    out = torch.zeros((B, H, Tq, D))
    lse = torch.zeros((B, H, Tq))
    for q0 in range(0, Tq, ROWS):
        rows = slice(q0, min(q0 + ROWS, Tq))
        kend = min(Tk, q0 + ROWS + shift) if causal else Tk
        ntiles = -(-kend // tile)
        states = [_warp_state(
            s[..., rows, :], None if keep is None else keep[..., rows, :], v,
            [slice(t * tile, min(t * tile + tile, Tk))
             for t in range(w, ntiles, warps)]) for w in range(warps)]
        # warp order; M is finite (key 0 is live to every row, in warp 0)
        M = states[0][0]
        for m, _, _ in states[1:]:
            M = torch.maximum(M, m)
        L = torch.zeros_like(M)
        A = torch.zeros_like(states[0][2])
        for m, l, acc in states:
            e = torch.exp(m - M)
            L = L + e * l
            A = A + e * acc
        out[..., rows, :] = A * (scale / L)
        lse[..., rows] = (M + torch.log(L))[..., 0]
    return out, lse.reshape(B * H, Tq)


def _inputs(B, H, Tq, Tk, D, p, seed):
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(B, H, Tq, D).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(B, H, Tk, D).astype(np.float32))
            for _ in range(2))
    bits = (ck.attn_dropout_bits_plain(SEED, OFFSET, B * H, Tq, Tk)
            if p else None)
    return q, k, v, bits


def test_geometry_at_the_serving_buckets():
    # GPT-2's heads (D = 64): 8 warps; tiles of 8 keys at the 32 bucket,
    # 16 past it; a head wider than 64 takes 4 warps
    assert [ck.flash_f32_geometry(T, T, 64, True) for T in (32, 128, 256)] \
        == [(8, 8), (8, 16), (8, 16)]
    assert ck.flash_f32_geometry(64, 64, 128, True) == (4, 16)
    assert ck.flash_f32_geometry(16, 48, 64, True) == (8, 8)


# check_flash's float32 serving cases (B, H, Tq, Tk, D, causal)
SERVING_SHAPES = [(1, 12, T, T, 64, True) for T in (32, 128, 256)] + [
    (2, 12, 40, 40, 64, True), (1, 4, 16, 48, 64, True),
    (1, 4, 100, 100, 64, False), (1, 2, 64, 64, 128, True),
    (1, 2, 33, 33, 24, True)]


@pytest.mark.parametrize("B,H,Tq,Tk,D,causal", SERVING_SHAPES)
def test_serving_split_within_the_card_tolerance(B, H, Tq, Tk, D, causal):
    q, k, v, _ = _inputs(B, H, Tq, Tk, D, 0.0, seed=Tq + D)
    got, _ = mirror_fwd(q, k, v, causal)
    want = ck.flash_attention_plain(q, k, v, causal)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL["float32"], (err, TOL["float32"])


# check_flash_train's float32 cases (B, Tq, Tk, H, D, causal)
TRAIN_SHAPES = [(2, 64, 64, 4, 64, True), (1, 200, 200, 2, 64, True),
                (1, 48, 96, 2, 64, True), (1, 100, 100, 2, 64, False),
                (1, 64, 64, 2, 128, True), (1, 33, 33, 2, 24, True),
                (2, 512, 512, 2, 64, True)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", TRAIN_SHAPES)
def test_training_split_with_lse_and_dropout(B, Tq, Tk, H, D, causal, p):
    q, k, v, bits = _inputs(B, H, Tq, Tk, D, p, seed=Tq + D + 1)
    got, lse = mirror_fwd(q, k, v, causal, p, bits)
    want, want_lse = ck.flash_fwd_train_plain(q, k, v, causal, p, bits)
    rel = abs_rel_err(got, want)[1]
    assert rel <= REL_TOL["float32"], (rel, REL_TOL["float32"])
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(),
                               rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("T", [32, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_split_matches_pallas_forward(T, causal, p):
    # the JAX package's `_flash_fwd` in interpret mode, fed the same numpy
    # inputs and dropout bits: the serving tolerance at p = 0, the training
    # one (and lse within 1e-5) at p = 0.1
    B, H, D = 1, 2, 64
    rs = np.random.RandomState(T + int(causal) + int(10 * p))
    q, k, v = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    bits = rs.randint(0, 2 ** 32, (B * H, T, T), dtype=np.uint64)
    jo, jlse = pk._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), causal,
                             block_q=16, block_k=32, interpret=True,
                             dropout_p=p,
                             rng=jnp.asarray(bits.astype(np.uint32))
                             if p else None)
    tbits = torch.from_numpy(bits.astype(np.int64)) if p else None
    got, lse = mirror_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                          p, tbits)
    want = torch.from_numpy(np.array(jo))
    if p:
        assert abs_rel_err(got, want)[1] <= REL_TOL["float32"]
    else:
        assert (got - want).abs().max().item() <= TOL["float32"]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=LSE_TOL, atol=LSE_TOL)
