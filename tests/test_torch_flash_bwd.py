"""The rounding of the bfloat16 flash-attention backward kernels, on the CPU.

`flash_bwd_dq` and `flash_bwd_dkv` run their products on the tensor cores
(ops/csrc/flash_bwd.cu): S = Q K^T and dP = dO V^T accumulate in float32
from the bfloat16 inputs, S is scaled after the product, and P, M o p and
dS enter dq = dS K, dv = (M o p)^T dO and dk = dS^T Q as a bfloat16 pair
hi + lo (hi the value rounded, lo what hi leaves out, rounded), whose
products accumulate in float32 again. The mirror below repeats that
rounding in PyTorch and is held against the plain versions
(`flash_bwd_dq_plain` / `flash_bwd_dkv_plain`, float32 throughout) on the
same bfloat16 inputs, before either rounds its output.

The limit is a quarter of the card check's: chip_smoke.py holds the
kernels' bfloat16 outputs within REL_TOL["bfloat16"] of the plain
versions' (max abs error over max(1, max |plain|)). Both sides round
their output once, so a difference under one bfloat16 ulp of the largest
value (at least 2^-8 of it) shows as at most that ulp (at most 2^-7 of
it), within the check; a quarter of the check is below 2^-8. Shapes: the
bfloat16 cases of chip_smoke.py's check_flash_train (ragged T, D 128, 24
and 20), GPT-2's and ERNIE's heads with all 12 of them, p 0 and 0.1 with
the kernels' dropout bits (`attn_dropout_bits_plain`).
"""
import numpy as np
import pytest
import torch

from chip_smoke import REL_TOL, abs_rel_err
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

MIRROR_REL_TOL = REL_TOL["bfloat16"] / 4
SEED, OFFSET = 0x1234_5678_9ABC_DEF0, 7


def _inputs(B, H, T, D, causal, p, seed):
    """bfloat16 q, k, v, dO from a numpy seed; o and lse from the plain
    training forward, as the kernels get them; the dropout bits."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    bits = (ck.attn_dropout_bits_plain(SEED, OFFSET, B * H, T, T)
            if p else None)
    o, lse = ck.flash_fwd_train_plain(q, k, v, causal, p, bits)
    return q, k, v, do, o, lse, bits


def _terms(q, k, v, do, lse, causal, p, bits):
    """p, M o p and the dropped dP as the kernels form them: float32 S from
    the bfloat16 inputs, scaled after the product."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        float(D) ** -0.5)
    probs = torch.exp(s - lse.reshape(B, H, Tq, 1))
    if causal:
        live = torch.ones((Tq, Tk), dtype=torch.bool).tril(Tk - Tq)
        probs = torch.where(live, probs, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    pd = probs
    if p:
        keep = ck._keep_mask(bits, p, probs.shape)
        scale = ck._drop_args(p)[1]
        pd = torch.where(keep, probs * scale, 0.0)
        dp = torch.where(keep, dp * scale, 0.0)
    return probs, pd, dp


def _hi_lo(x):
    """x as the kernels' operand pair holds it: bfloat16 hi + lo."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def mirror_dq(q, k, v, o, do, lse, causal, p, bits):
    """dq before its output rounding, and Delta."""
    D = q.shape[-1]
    delta = (do.float() * o.float()).sum(-1)
    probs, _, dp = _terms(q, k, v, do, lse, causal, p, bits)
    ds = probs * (dp - delta[..., None]) * (float(D) ** -0.5)
    return torch.einsum("bhqk,bhkd->bhqd", _hi_lo(ds), k.float()), delta


def mirror_dkv(q, k, v, do, lse, delta, causal, p, bits):
    """dk and dv before their output rounding."""
    B, H, Tq, D = q.shape
    probs, pd, dp = _terms(q, k, v, do, lse, causal, p, bits)
    ds = probs * (dp - delta.reshape(B, H, Tq, 1)) * (float(D) ** -0.5)
    dk = torch.einsum("bhqk,bhqd->bhkd", _hi_lo(ds), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", _hi_lo(pd), do.float())
    return dk, dv


# (B, H, T, D, causal): GPT-2's training head and ERNIE's, with 2 and
# with all 12 heads, and check_flash_train's other bfloat16 shapes
SHAPES = [(1, 2, 512, 64, True), (1, 12, 512, 64, True),
          (1, 2, 128, 64, False), (4, 12, 128, 64, False),
          (1, 2, 200, 64, True), (1, 2, 64, 128, True),
          (1, 2, 33, 24, True), (1, 2, 72, 20, True)]
CASES = [shape + (p,) for shape in SHAPES for p in (0.0, 0.1)]


@pytest.mark.parametrize("B,H,T,D,causal,p", CASES)
def test_dq_rounding_within_a_quarter_of_the_card_tolerance(B, H, T, D,
                                                            causal, p):
    q, k, v, do, o, lse, bits = _inputs(B, H, T, D, causal, p, seed=T)
    got, delta = mirror_dq(q, k, v, o, do, lse, causal, p, bits)
    want, want_delta = ck.flash_bwd_dq_plain(
        q.float(), k.float(), v.float(), o.float(), do.float(), lse, causal,
        p, bits)
    assert want.dtype == torch.float32
    _, rel = abs_rel_err(got, want)
    assert rel <= MIRROR_REL_TOL, (rel, MIRROR_REL_TOL)
    # the rounding shows: the mirror is not the plain version again
    assert rel > 0.0
    np.testing.assert_allclose(delta.reshape(want_delta.shape).numpy(),
                               want_delta.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,H,T,D,causal,p", CASES)
def test_dkv_rounding_within_a_quarter_of_the_card_tolerance(B, H, T, D,
                                                             causal, p):
    q, k, v, do, o, lse, bits = _inputs(B, H, T, D, causal, p, seed=T + 1)
    _, delta = ck.flash_bwd_dq_plain(q, k, v, o, do, lse, causal, p, bits)
    got = mirror_dkv(q, k, v, do, lse, delta, causal, p, bits)
    want = ck.flash_bwd_dkv_plain(q.float(), k.float(), v.float(),
                                  do.float(), lse, delta, causal, p, bits)
    for g, w in zip(got, want):
        assert w.dtype == torch.float32
        _, rel = abs_rel_err(g, w)
        assert 0.0 < rel <= MIRROR_REL_TOL, (rel, MIRROR_REL_TOL)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_mirror_matches_plain_outputs_at_bf16(p):
    # rounded to bfloat16 like the kernels' outputs, the mirror stays
    # within the card check's own tolerance of the plain versions' outputs
    q, k, v, do, o, lse, bits = _inputs(1, 2, 512, 64, True, p, seed=3)
    dq_ref, delta = ck.flash_bwd_dq_plain(q, k, v, o, do, lse, True, p, bits)
    dk_ref, dv_ref = ck.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, p,
                                            bits)
    dq, _ = mirror_dq(q, k, v, o, do, lse, True, p, bits)
    dk, dv = mirror_dkv(q, k, v, do, lse, delta, True, p, bits)
    for g, w in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert w.dtype == torch.bfloat16
        assert abs_rel_err(g.to(torch.bfloat16), w)[1] <= REL_TOL["bfloat16"]
