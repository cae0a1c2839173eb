"""The float32 paged-decode kernel's split algebra, mirrored on the CPU.

The kernel (paddle_tpu_torch/ops/csrc/paged_decode.cu, `paged_split_kernel`)
cannot run here. This file repeats its arithmetic in float32 numpy: each
(slot, head)'s keys 0..cl cut into chunks of `paged_split_geometry(D)[1]`
keys, each chunk into 4 warps' slices, a partial (m, l, acc) per warp,
combined per chunk, and the chunks' partials combined in chunk order; only
rows below the append row cl are read from the cache, row cl comes from
new_k / new_v. The mirror is held against the port's plain version and
the JAX package's Pallas kernel in interpret mode, on the same numpy
inputs, within 1e-5 absolute (float32 sums in another order), at the
chunk edges, at T - 1 and T, for a ragged batch with NaN tails, and at
D = 24 and 64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

jax.config.update("jax_platforms", "cpu")

H = 2
WARPS = 4          # the kernel's warps a CTA, each a quarter of the chunk
ATOL = 1e-5


def _inputs(lens, D, T, seed):
    """numpy inputs; cache rows at and past each slot's lens are NaN
    (uninitialized pages), except the whole cache when lens = T."""
    rs = np.random.RandomState(seed)
    B = len(lens)
    q, nk, nv = (rs.randn(B, H, 1, D).astype(np.float32) for _ in range(3))
    kc = rs.randn(B, H, T, D).astype(np.float32)
    vc = rs.randn(B, H, T, D).astype(np.float32)
    for b, ln in enumerate(lens):
        kc[b, :, ln:] = np.nan
        vc[b, :, ln:] = np.nan
    return q, kc, vc, np.asarray(lens, np.int32), nk, nv


def _partial(s, v):
    """A warp's (m, l, acc) over scores s [n] and rows v [n, D]; no key:
    (-inf, 0, 0)."""
    if s.size == 0:
        return np.float32(-np.inf), np.float32(0.0), np.zeros(
            v.shape[1], np.float32)
    m = s.max()
    p = np.exp(s - m)
    return m, p.sum(dtype=np.float32), (p[:, None] * v).sum(
        0, dtype=np.float32)


def _combine(parts):
    """sum acc e^(m - M) / sum l e^(m - M) terms, M the largest m."""
    big = max(m for m, _, _ in parts)
    w = [np.exp(np.float32(m - big)) for m, _, _ in parts]
    return (np.float32(sum(e * l for e, (_, l, _) in zip(w, parts))),
            sum(e * a for e, (_, _, a) in zip(w, parts)).astype(np.float32),
            big)


def split_mirror(q, kc, vc, lens, nk, nv):
    """out [B, H, 1, D] as the split kernel computes it, in float32."""
    B, _, _, D = q.shape
    T = kc.shape[2]
    chunk = ck.paged_split_geometry(D)[1]
    per_warp = chunk // WARPS
    scale = np.float32(1.0) / np.sqrt(np.float32(D))
    out = np.zeros((B, H, 1, D), np.float32)
    for b in range(B):
        cl = min(max(int(lens[b]), 0), T - 1)
        for h in range(H):
            qs = q[b, h, 0] * scale
            # rows 0..cl-1 from the cache, row cl the appended one
            k = np.concatenate([kc[b, h, :cl], nk[b, h]], 0)
            v = np.concatenate([vc[b, h, :cl], nv[b, h]], 0)
            chunks = []
            for c0 in range(0, cl + 1, chunk):
                warps = []
                for w in range(WARPS):
                    lo = c0 + w * per_warp
                    hi = min(lo + per_warp, cl + 1)
                    keys = slice(lo, max(lo, hi))
                    warps.append(_partial(k[keys] @ qs, v[keys]))
                l, acc, m = _combine(warps)
                chunks.append((m, l, acc))
            l, acc, _ = (_combine(chunks) if len(chunks) > 1
                         else (chunks[0][1], chunks[0][2], None))
            out[b, h, 0] = acc / l
    return out


def _plain(args):
    q, kc, vc, lens, nk, nv = (torch.from_numpy(a.copy()) for a in args)
    return ck.paged_decode_plain(q, kc, vc, lens, nk, nv).numpy()


def _pallas(args):
    q, kc, vc, lens, nk, nv = (jnp.asarray(a) for a in args)
    out = pk._paged_decode(q, kc, vc, lens, nk, nv, None, None,
                           block_k=pk._paged_block(kc.shape[2]),
                           interpret=True)[0]
    return np.asarray(out)


def _lens(case, chunk, T):
    return {"idle": [0], "chunk_minus_1": [chunk - 1], "chunk": [chunk],
            "chunk_plus_1": [chunk + 1], "two_chunks": [2 * chunk],
            "last_row": [T - 1], "full_clamp": [T],
            "ragged_nan_tails": [0, chunk - 1, chunk + 1, 2 * chunk + 3,
                                 T - 1]}[case]


@pytest.mark.parametrize("case", ["idle", "chunk_minus_1", "chunk",
                                  "chunk_plus_1", "two_chunks", "last_row",
                                  "full_clamp", "ragged_nan_tails"])
@pytest.mark.parametrize("D", [24, 64])
def test_split_mirror_matches_plain_and_pallas(D, case):
    chunk = ck.paged_split_geometry(D)[1]
    T = 2 * chunk + 64            # three chunks, the last one partial
    args = _inputs(_lens(case, chunk, T), D, T, seed=D + len(case))
    got = split_mirror(*args)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _plain(args), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _pallas(args), atol=ATOL, rtol=0)
