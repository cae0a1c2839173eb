"""The blockwise attention tier (counterpart of paddle_tpu/ops/
ring_attention.py: `_online_block` :28 and `_blockwise_attention` :166),
single device. Ring and Ulysses attention, the reference's sequence
parallel forms of the same accumulator, are not ported.

`blockwise_attention` scans K/V in blocks of `block_k` keys (512) with the
online-softmax accumulator in float32, so that no [Tq, Tk] tensor is ever
held: each block's [Tq, block_k] scores live only while the block is
folded in. Its backward (`BlockwiseAttentionFunction`) recomputes each
block from q, k, v and the rows' logsumexp, as the reference's
`checkpoint_blocks=True` recomputes each scan step, and writes dq, dk, dv
block by block. A ragged last block is sliced, not padded: the reference
pads it and masks the padded keys, which adds exactly 0.

Attention dropout drops the numerator only (the denominator stays the
undropped softmax sum), as the flash kernels do. Each block draws its keep
mask from the global RNG (`framework.random.RNG.draw`: the Philox word and
a delta of its own), and the backward draws it again from the same
(word, delta), as the reference's `fold_in(key, i)` does: inside a
captured train step the word is the step's, so a replay draws new masks.
On CUDA the mask comes from the Philox keep kernel
(`ops.cuda_kernels.dropout_keep`, fused_dropout_ln.cu); on the CPU from
its plain version, which repeats its bits.

With `causal`, query i sees keys j <= i (the reference's alignment, for
Tq == Tk). A block's rows above the diagonal see none of its keys; the
reference folds them in as all -1e30 scores, which leave the row's
accumulator exactly as it was, so here the block starts at its first row
that sees a key.
"""
from __future__ import annotations

import torch

from ..framework.random import RNG
from . import cuda_kernels as ck

__all__ = ["BLOCK_K", "blockwise_attention", "BlockwiseAttentionFunction",
           "block_geometry"]

BLOCK_K = 512
_NEG = -1e30


def block_geometry(Tk, block_k=BLOCK_K):
    """(block width, number of blocks) of a key length: blocks of
    min(block_k, Tk) keys, the last one ragged."""
    bk = min(int(block_k), int(Tk))
    return bk, -(-int(Tk) // bk)


def _block(q32, k, v, i, bk, causal, scale):
    """Block i's key range (k0, k1), its first row r0 and its scaled float32
    scores [B, H, Tq - r0, k1 - k0], the causal mask written as -1e30."""
    Tk = k.shape[2]
    k0, k1 = i * bk, min((i + 1) * bk, Tk)
    r0 = k0 if causal else 0
    kb = k[:, :, k0:k1].float()
    s = torch.matmul(q32[:, :, r0:], kb.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(r0, q32.shape[2], device=s.device)
        cols = torch.arange(k0, k1, device=s.device)
        s = s.masked_fill(rows[:, None] < cols[None, :], _NEG)
    return k0, k1, r0, kb, s


def _drop_scale(keep, r0, p):
    """The dropout factor of block rows r0..: 1 / (1 - p) where kept, 0
    where dropped (float32, the flash kernels' scale)."""
    return torch.where(keep[:, :, r0:], ck._drop_args(p)[1], 0.0)


class BlockwiseAttentionFunction(torch.autograd.Function):
    """forward(q, k, v, causal, block_k, dropout_p, draws) -> out in q's
    dtype; `draws` holds one (word, delta) a block when dropout_p > 0."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_k, dropout_p, draws):
        B, H, Tq, D = q.shape
        scale = float(D) ** -0.5
        bk, nblk = block_geometry(k.shape[2], block_k)
        q32 = q.float()
        acc = torch.zeros(B, H, Tq, D, dtype=torch.float32, device=q.device)
        l = torch.zeros(B, H, Tq, dtype=torch.float32, device=q.device)
        m = torch.full((B, H, Tq), float("-inf"), dtype=torch.float32,
                       device=q.device)
        for i in range(nblk):
            k0, k1, r0, _, s = _block(q32, k, v, i, bk, causal, scale)
            m_old = m[:, :, r0:]
            m_new = torch.maximum(m_old, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_old - m_new)
            l[:, :, r0:] = l[:, :, r0:] * corr + p.sum(-1)
            if dropout_p > 0.0:
                keep = ck.dropout_keep(*draws[i], (B, H, Tq, k1 - k0),
                                       dropout_p)
                p = p * _drop_scale(keep, r0, dropout_p)
            acc[:, :, r0:] = (acc[:, :, r0:] * corr[..., None]
                              + torch.matmul(p, v[:, :, k0:k1].float()))
            m[:, :, r0:] = m_new
        l = torch.clamp_min(l, 1e-30)
        o32 = acc / l[..., None]
        ctx.save_for_backward(q, k, v, o32, m + torch.log(l))
        ctx.args = (causal, block_k, dropout_p, draws)
        return o32.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        causal, block_k, dropout_p, draws = ctx.args
        B, H, Tq, D = q.shape
        scale = float(D) ** -0.5
        bk, nblk = block_geometry(k.shape[2], block_k)
        q32, do32 = q.float(), do.float()
        delta = (do32 * o32).sum(-1)
        dq = torch.zeros_like(q32)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(nblk):
            k0, k1, r0, kb, s = _block(q32, k, v, i, bk, causal, scale)
            p = torch.exp(s - lse[:, :, r0:, None])
            dp = torch.matmul(do32[:, :, r0:],
                              v[:, :, k0:k1].float().transpose(-1, -2))
            pd = p
            if dropout_p > 0.0:
                keep = ck.dropout_keep(*draws[i], (B, H, Tq, k1 - k0),
                                       dropout_p)
                f = _drop_scale(keep, r0, dropout_p)
                pd, dp = p * f, dp * f
            dv[:, :, k0:k1] = torch.matmul(pd.transpose(-1, -2),
                                           do32[:, :, r0:])
            ds = p * (dp - delta[:, :, r0:, None]) * scale
            dq[:, :, r0:] += torch.matmul(ds, kb)
            dk[:, :, k0:k1] = torch.matmul(ds.transpose(-1, -2),
                                           q32[:, :, r0:])
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def blockwise_attention(q, k, v, causal, dropout_p=0.0, block_k=BLOCK_K):
    """softmax(q k^T / sqrt(D)) v over K/V blocks of `block_k` keys, q/k/v
    [B, H, T, D] (any float dtype; float32 arithmetic), out in q's dtype;
    attention dropout at `dropout_p` < 1 with one RNG draw a block. Causal
    needs Tq == Tk (the reference's gate sends the rest to the dense
    route)."""
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError("blockwise_attention: q %s, k %s, v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("blockwise_attention: causal needs Tq == Tk")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError("blockwise_attention: dropout_p %r" % (dropout_p,))
    nblk = block_geometry(k.shape[2], block_k)[1]
    draws = ([RNG.draw(q.device) for _ in range(nblk)]
             if dropout_p > 0.0 else None)
    return BlockwiseAttentionFunction.apply(q, k, v, bool(causal),
                                            int(block_k), float(dropout_p),
                                            draws)
