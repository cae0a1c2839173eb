"""The paged-decode kernel's split algebra, mirrored on the CPU.

The kernel (paddle_tpu_torch/ops/csrc/paged_decode.cu, `paged_split_kernel`)
cannot run here. This file repeats its arithmetic in float32 numpy for
both caches: each (slot, head)'s keys 0..cl cut into chunks of the cache's
geometry (`paged_split_geometry(D)[1]` keys for float32,
`paged_int8_geometry(D)[1]` for int8), each chunk into 4 warps' slices, a
partial (m, l, acc) per warp, combined per chunk, and the chunks' partials
combined in chunk order; only rows below the append row cl are read from
the cache, row cl comes from new_k / new_v (for int8 quantized with
quantize_kv's rule by the chunk that holds it, which writes the int8 row
and both scales). For int8, k_scale multiplies a key's score and v_scale
its probability in P V. The mirror is held against the port's plain
version and the JAX package's Pallas kernel in interpret mode (which runs
`_paged_f_kernel` or `_paged_q_kernel`), on the same numpy inputs, within
1e-5 absolute (float32 sums in another order), at the chunk edges, at
T - 1 and T, for an all-T batch and a ragged batch with NaN tails (NaN
scales past lens for int8), and at D = 24 and 64; the appended int8 rows
and scales are bit-equal to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

H = 2
WARPS = 4          # the kernel's warps a CTA, each a quarter of the chunk
ATOL = 1e-5


def _quantize(x):
    """quantize_kv's rule in numpy: (int8 rows, float32 scales)."""
    amax = np.abs(x).max(-1)
    scale = (np.maximum(amax, np.float32(1e-8)) / np.float32(127.0))
    q = np.clip(np.rint(x / scale[..., None]), -127.0, 127.0)
    return q.astype(np.int8), scale.astype(np.float32)


def _inputs(lens, D, T, seed, quantized):
    """numpy inputs; cache rows (int8: their scales) at and past each
    slot's lens are NaN (uninitialized pages), except where lens = T."""
    rs = np.random.RandomState(seed)
    B = len(lens)
    q, nk, nv = (rs.randn(B, H, 1, D).astype(np.float32) for _ in range(3))
    kc = rs.randn(B, H, T, D).astype(np.float32)
    vc = rs.randn(B, H, T, D).astype(np.float32)
    ks = vs = None
    if quantized:
        (kc, ks), (vc, vs) = _quantize(kc), _quantize(vc)
    for b, ln in enumerate(lens):
        for a in (ks, vs) if quantized else (kc, vc):
            a[b, :, ln:] = np.nan
    return q, kc, vc, np.asarray(lens, np.int32), nk, nv, ks, vs


def _warp(s, v, vscale):
    """(m, l, acc) of a warp's keys: l sums p, acc sums p * v_scale * v."""
    if s.size == 0:
        return np.float32(-np.inf), np.float32(0.0), np.zeros(
            v.shape[1], np.float32)
    m = s.max()
    p = np.exp(s - m)
    return m, p.sum(dtype=np.float32), ((p * vscale)[:, None] * v).sum(
        0, dtype=np.float32)


def _combine(parts):
    """sum acc e^(m - M) / sum l e^(m - M) terms, M the largest m."""
    big = max(m for m, _, _ in parts)
    w = [np.exp(np.float32(m - big)) for m, _, _ in parts]
    return (np.float32(sum(e * l for e, (_, l, _) in zip(w, parts))),
            sum(e * a for e, (_, _, a) in zip(w, parts)).astype(np.float32),
            big)


def split_mirror(q, kc, vc, lens, nk, nv, ks=None, vs=None):
    """(out [B, H, 1, D], the appended rows) as the split kernel computes
    them, in float32; the appended rows are {(b, h): (k row, v row,
    k scale, v scale)}, int8 with scales for an int8 cache."""
    quantized = ks is not None
    B, _, _, D = q.shape
    T = kc.shape[2]
    chunk = (ck.paged_int8_geometry if quantized
             else ck.paged_split_geometry)(D)[1]
    per_warp = chunk // WARPS
    scale = np.float32(1.0) / np.sqrt(np.float32(D))
    out = np.zeros((B, H, 1, D), np.float32)
    appended = {}
    for b in range(B):
        cl = min(max(int(lens[b]), 0), T - 1)
        for h in range(H):
            qs = q[b, h, 0] * scale
            # rows 0..cl-1 from the cache, row cl the appended one
            if quantized:
                (nkq, nks), (nvq, nvs) = _quantize(nk[b, h]), _quantize(
                    nv[b, h])
                appended[b, h] = (nkq[0], nvq[0], nks[0], nvs[0])
                k = np.concatenate([kc[b, h, :cl], nkq], 0).astype(
                    np.float32)
                v = np.concatenate([vc[b, h, :cl], nvq], 0).astype(
                    np.float32)
                kscale = np.concatenate([ks[b, h, :cl], nks])
                vscale = np.concatenate([vs[b, h, :cl], nvs])
            else:
                k = np.concatenate([kc[b, h, :cl], nk[b, h]], 0)
                v = np.concatenate([vc[b, h, :cl], nv[b, h]], 0)
                kscale = vscale = np.ones(cl + 1, np.float32)
            chunks = []
            for c0 in range(0, cl + 1, chunk):
                warps = []
                for w in range(WARPS):
                    lo = c0 + w * per_warp
                    keys = slice(lo, max(lo, min(lo + per_warp, cl + 1)))
                    s = (k[keys] @ qs) * kscale[keys]
                    warps.append(_warp(s, v[keys], vscale[keys]))
                l, acc, m = _combine(warps)
                chunks.append((m, l, acc))
            l, acc, _ = (_combine(chunks) if len(chunks) > 1
                         else (chunks[0][1], chunks[0][2], None))
            out[b, h, 0] = acc / l
    return out, appended


def _plain(args):
    t = [None if a is None else torch.from_numpy(a.copy()) for a in args]
    out = ck.paged_decode_plain(*t)
    return out.numpy(), [None if t[i] is None else t[i].numpy()
                         for i in (1, 2, 6, 7)]


def _pallas(args):
    q, kc, vc, lens, nk, nv, ks, vs = (None if a is None else jnp.asarray(a)
                                       for a in args)
    outs = pk._paged_decode(q, kc, vc, lens, nk, nv, ks, vs,
                            block_k=pk._paged_block(kc.shape[2]),
                            interpret=True)
    return np.asarray(outs[0]), [None if a is None else np.asarray(a)
                                 for a in outs[1:]]


def _check_appended(appended, lens, caches, scale_ulps):
    """The mirror's quantized rows equal, bit for bit, the cache rows at
    each slot's append row, and its scales the cache's within
    `scale_ulps` float32 ulps (0: bit for bit)."""
    kc, vc, ks, vs = caches
    T = kc.shape[2]
    for (b, h), (kq, vq, kscale, vscale) in appended.items():
        cl = min(int(lens[b]), T - 1)
        np.testing.assert_array_equal(kc[b, h, cl], kq)
        np.testing.assert_array_equal(vc[b, h, cl], vq)
        for got, want in ((ks[b, h, cl], kscale), (vs[b, h, cl], vscale)):
            if scale_ulps:
                np.testing.assert_array_max_ulp(got, want, scale_ulps)
            else:
                assert got.tobytes() == want.tobytes()


def _lens(case, chunk, T):
    return {"idle": [0], "chunk_minus_1": [chunk - 1], "chunk": [chunk],
            "chunk_plus_1": [chunk + 1], "two_chunks": [2 * chunk],
            "last_row": [T - 1], "full_clamp": [T], "all_full": [T, T, T],
            "ragged_nan_tails": [0, chunk - 1, chunk + 1, 2 * chunk + 3,
                                 T - 1]}[case]


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float32", "int8"])
@pytest.mark.parametrize("case", ["idle", "chunk_minus_1", "chunk",
                                  "chunk_plus_1", "two_chunks", "last_row",
                                  "full_clamp", "all_full",
                                  "ragged_nan_tails"])
@pytest.mark.parametrize("D", [24, 64])
def test_split_mirror_matches_plain_and_pallas(D, case, quantized):
    chunk = (ck.paged_int8_geometry if quantized
             else ck.paged_split_geometry)(D)[1]
    T = 2 * chunk + 64            # three chunks, the last one partial
    lens = _lens(case, chunk, T)
    args = _inputs(lens, D, T, seed=D + len(case), quantized=quantized)
    got, appended = split_mirror(*args)
    assert np.isfinite(got).all()
    # the plain version's quantize_kv (the card check's yardstick) gives
    # the same scales bit for bit; the Pallas kernel run by XLA on the CPU
    # may take x / 127 as x * (1 / 127), one ulp away
    for (want, caches), ulps in ((_plain(args), 0), (_pallas(args), 1)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        if quantized:
            _check_appended(appended, lens, caches, ulps)
