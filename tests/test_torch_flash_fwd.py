"""The rounding of the bfloat16 flash-attention forward kernel, on the CPU.

`flash_fwd_train` (and `flash_attention`) take bfloat16 inputs to the
tensor-core kernel (ops/csrc/flash_fwd.cu): S = Q K^T accumulates in
float32 from the bfloat16 inputs and is scaled after the product; the
online softmax rescales its float32 state once per tile of 64 keys; the
denominator l sums the undropped float32 p; P, after the keep mask, enters
P V rounded once to bfloat16, whose products accumulate in float32; the
kernel multiplies by 1 / (1 - p_drop) and 1 / l at the end, and rounds the
output to bfloat16. The mirror below repeats that in PyTorch and is held
against the plain version (`flash_fwd_train_plain`, float32 throughout)
on the same bfloat16 inputs, before either rounds its output.

The limit is a quarter of the card check's, as in test_torch_flash_bwd.py:
chip_smoke.py holds the kernel's bfloat16 output within
REL_TOL["bfloat16"] of the plain version's (max abs error over max(1,
max |plain|)); a float32 difference under a quarter of it stays under one
bfloat16 ulp of the largest value, which shows as at most that ulp. lse
is float32 on both sides: 1e-5 relative (float32 sums in another order).
Shapes: the bfloat16 cases of chip_smoke.py's check_flash_train (ragged T,
Tq < Tk, D 128, 24 and 20), GPT-2's and ERNIE's heads with 2 and with all
12 of them, p 0 and 0.1 with the kernels' dropout bits
(`attn_dropout_bits_plain`). The serving cases of check_flash (p 0, no
lse) are held the way that check holds them: by the absolute
TOL["bfloat16"], a quarter of it before the output rounding.
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

MIRROR_REL_TOL = REL_TOL["bfloat16"] / 4
LSE_REL_TOL = 1e-5
KEYS_A_TILE = 64
SEED, OFFSET = 0x1234_5678_9ABC_DEF0, 7


def mirror_fwd(q, k, v, causal, p, bits):
    """(o before its output rounding, lse [B*H, Tq]) as the kernel forms
    them from bfloat16 q, k, v."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        float(D) ** -0.5)
    if causal:
        live = torch.ones((Tq, Tk), dtype=torch.bool).tril(Tk - Tq)
        s = torch.where(live, s, -float("inf"))
    keep = ck._keep_mask(bits, p, s.shape) if p else None
    m = torch.full((B, H, Tq, 1), -float("inf"))
    l = torch.zeros((B, H, Tq, 1))
    acc = torch.zeros((B, H, Tq, D))
    for k0 in range(0, Tk, KEYS_A_TILE):
        st = s[..., k0:k0 + KEYS_A_TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        # a row with no live key yet keeps m = -inf and subtracts 0
        m_sub = torch.where(m_new == -float("inf"), 0.0, m_new)
        pt = torch.exp(st - m_sub)
        alpha = torch.exp(m - m_sub)
        l = l * alpha + pt.sum(-1, keepdim=True)
        if keep is not None:
            pt = torch.where(keep[..., k0:k0 + KEYS_A_TILE], pt, 0.0)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", pt.to(torch.bfloat16).float(),
            v[..., k0:k0 + KEYS_A_TILE, :].float())
        m = m_new
    scale = ck._drop_args(p)[1] if p else 1.0
    return acc * (scale / l), (m + torch.log(l)).reshape(B * H, Tq)


def _inputs(B, H, Tq, Tk, D, p, seed):
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(B, H, Tq, D).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(B, H, Tk, D).astype(np.float32))
            for _ in range(2))
    bits = (ck.attn_dropout_bits_plain(SEED, OFFSET, B * H, Tq, Tk)
            if p else None)
    return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(
        torch.bfloat16), bits


# (B, H, Tq, Tk, D, causal): GPT-2's training head and ERNIE's, with 2 and
# with all 12 heads, and check_flash_train's other bfloat16 shapes
SHAPES = [(1, 2, 512, 512, 64, True), (1, 12, 512, 512, 64, True),
          (1, 2, 128, 128, 64, False), (4, 12, 128, 128, 64, False),
          (1, 2, 200, 200, 64, True), (1, 2, 48, 96, 64, True),
          (1, 2, 64, 64, 128, True), (1, 2, 33, 33, 24, True),
          (1, 2, 72, 72, 20, True)]
CASES = [shape + (p,) for shape in SHAPES for p in (0.0, 0.1)]


@pytest.mark.parametrize("B,H,Tq,Tk,D,causal,p", CASES)
def test_fwd_rounding_within_a_quarter_of_the_card_tolerance(B, H, Tq, Tk, D,
                                                             causal, p):
    q, k, v, bits = _inputs(B, H, Tq, Tk, D, p, seed=Tq + D)
    got, lse = mirror_fwd(q, k, v, causal, p, bits)
    want, want_lse = ck.flash_fwd_train_plain(q.float(), k.float(),
                                              v.float(), causal, p, bits)
    assert want.dtype == torch.float32
    _, rel = abs_rel_err(got, want)
    assert rel <= MIRROR_REL_TOL, (rel, MIRROR_REL_TOL)
    # the rounding shows: the mirror is not the plain version again
    assert rel > 0.0
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(),
                               rtol=LSE_REL_TOL, atol=LSE_REL_TOL)


# check_flash's bfloat16 serving cases (B, H, Tq, Tk, D, causal)
SERVING_SHAPES = [(1, 12, T, T, 64, True) for T in (32, 128, 256)] + [
    (2, 12, 40, 40, 64, True), (1, 4, 16, 48, 64, True),
    (1, 4, 100, 100, 64, False), (1, 2, 64, 64, 128, True),
    (1, 2, 33, 33, 24, True)]


@pytest.mark.parametrize("B,H,Tq,Tk,D,causal", SERVING_SHAPES)
def test_serving_rounding_within_the_card_tolerance(B, H, Tq, Tk, D, causal):
    q, k, v, _ = _inputs(B, H, Tq, Tk, D, 0.0, seed=Tq + D + 1)
    got, _ = mirror_fwd(q, k, v, causal, 0.0, None)
    want = ck.flash_attention_plain(q.float(), k.float(), v.float(), causal)
    err = (got - want).abs().max().item()
    assert 0.0 < err <= TOL["bfloat16"] / 4, (err, TOL["bfloat16"] / 4)
    # both rounded to bfloat16, as check_flash compares them on the card
    want = ck.flash_attention_plain(q, k, v, causal)
    err = (got.to(torch.bfloat16).float() - want.float()).abs().max().item()
    assert err <= TOL["bfloat16"], (err, TOL["bfloat16"])


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_one_live_key_is_exact(p):
    # causal row 0 sees key 0 alone: p = 1 is exact in bfloat16, so the
    # kernel's output there is v0 (times the keep scale, or 0) exactly
    q, k, v, bits = _inputs(2, 3, 40, 40, 64, p, seed=5)
    got, _ = mirror_fwd(q, k, v, True, p, bits)
    want, _ = ck.flash_fwd_train_plain(q.float(), k.float(), v.float(), True,
                                       p, bits)
    assert torch.equal(got[:, :, 0], want[:, :, 0])


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_mirror_matches_plain_outputs_at_bf16(p):
    # rounded to bfloat16 like the kernel's output, the mirror stays within
    # the card check's own tolerance of the plain version's output
    q, k, v, bits = _inputs(1, 12, 512, 512, 64, p, seed=3)
    got, _ = mirror_fwd(q, k, v, True, p, bits)
    want, _ = ck.flash_fwd_train_plain(q, k, v, True, p, bits)
    assert want.dtype == torch.bfloat16
    assert abs_rel_err(got.to(torch.bfloat16), want)[1] <= REL_TOL["bfloat16"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_mirror_matches_pallas_forward(causal, p):
    # the JAX package's `_flash_fwd` in interpret mode (multi-block grid),
    # fed the same numpy bits: the mirror's output rounded to bfloat16
    # within the card check's tolerance of its bfloat16 output, lse within
    # 1e-5 relative
    B, H, T, D = 1, 2, 64, 16
    rs = np.random.RandomState(11)
    q, k, v = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    bits = rs.randint(0, 2 ** 32, (B * H, T, T), dtype=np.uint64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jo, jlse = pk._flash_fwd(jq, jk, jv, causal, block_q=16, block_k=16,
                             interpret=True, dropout_p=p,
                             rng=jnp.asarray(bits.astype(np.uint32))
                             if p else None)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tbits = torch.from_numpy(bits.astype(np.int64)) if p else None
    got, lse = mirror_fwd(tq, tk, tv, causal, p, tbits)
    want = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    assert abs_rel_err(got.to(torch.bfloat16), want)[1] <= REL_TOL["bfloat16"]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=LSE_REL_TOL, atol=LSE_REL_TOL)
