"""The sequence ops (counterpart of paddle_tpu/nn/functional/sequence.py),
bound as `nn.functional.sequence` and re-exported as `F.sequence_*`.

A ragged batch is padded dense values [B, T, ...] with a lengths vector
[B], or, where the reference takes the LoD form, flat values [sum(len),
...] with the lengths. The four ops of fixed output shape
(`sequence_{reverse,softmax,pool,conv}_op`) run on the device and are
registered under the reference's op types; the rest have outputs whose
size depends on the values, so they run on the host, as the reference's
do, and refuse a CUDA graph capture (`no_capture`). Their results come
back on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dispatch import primitive
from ..ops.math import no_capture

__all__ = ["sequence_pad", "sequence_unpad", "sequence_reverse",
           "sequence_softmax", "sequence_pool", "sequence_expand",
           "sequence_concat", "sequence_enumerate", "sequence_erase",
           "sequence_expand_as", "sequence_reshape", "sequence_slice",
           "sequence_scatter", "sequence_conv"]


def _mask(lengths, maxlen):
    return (torch.arange(maxlen, device=lengths.device)[None, :]
            < lengths.reshape(-1)[:, None])


def _host(t, name):
    """A tensor's values as numpy, read on the host (refused in a
    capture)."""
    no_capture(name)
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _back(a, like):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        like.device if isinstance(like, torch.Tensor) else "cpu")


def _trailing(t, ndim):
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


@primitive("sequence_reverse_op")
def _seq_reverse(x, lengths):
    """The first len steps of each row reversed; the padding stays."""
    T = x.shape[1]
    idx = torch.arange(T, device=x.device)[None, :]
    ln = lengths.reshape(-1, 1).long()
    rev = torch.where(idx < ln, ln - 1 - idx, idx)
    rev = _trailing(rev, x.ndim).expand(x.shape)
    return x.gather(1, rev)


@primitive("sequence_softmax_op")
def _seq_softmax(x, lengths):
    """Softmax over each row's first len steps; padded steps get 0."""
    m = _trailing(_mask(lengths, x.shape[1]), x.ndim)
    out = torch.softmax(torch.where(m, x, -1e30), dim=1)
    return torch.where(m, out, 0.0)


@primitive("sequence_pool_op")
def _seq_pool(x, lengths, pool_type="sum"):
    """SUM / AVERAGE / SQRT / MAX / FIRST / LAST over each row's first len
    steps (a length of 0 counts as 1 in the divisors and for LAST)."""
    m = _trailing(_mask(lengths, x.shape[1]), x.ndim)
    ln = _trailing(lengths.reshape(-1).clamp(min=1).to(x.dtype), x.ndim - 1)
    pt = pool_type.lower()
    if pt == "sum":
        return torch.where(m, x, 0.0).sum(dim=1)
    if pt == "average":
        return torch.where(m, x, 0.0).sum(dim=1) / ln
    if pt == "sqrt":
        return torch.where(m, x, 0.0).sum(dim=1) / torch.sqrt(ln)
    if pt == "max":
        return torch.where(m, x, float("-inf")).amax(dim=1)
    if pt == "first":
        return x[:, 0]
    if pt == "last":
        idx = (lengths.reshape(-1).clamp(min=1) - 1).long()
        idx = _trailing(idx, x.ndim).expand((x.shape[0], 1)
                                            + tuple(x.shape[2:]))
        return x.gather(1, idx).squeeze(1)
    raise ValueError("unknown pool_type %r" % (pool_type,))


@primitive("sequence_conv_op")
def _seq_conv(x, weight, lengths, context_length=3, context_start=-1):
    """The context-window convolution over [B, T, D]: steps outside [0,
    len) read as zeros, each step's window of context_length steps from
    context_start concatenated to [B, T, ctx * D] and multiplied by
    weight [ctx * D, F]; padded steps give 0."""
    B, T, D = x.shape
    m = _mask(lengths, T)[..., None]
    xz = torch.where(m, x, 0.0)
    pos = torch.arange(T, device=x.device)
    cols = []
    for c in range(context_length):
        shift = context_start + c
        rolled = torch.roll(xz, -shift, dims=1)
        ok = ((pos + shift >= 0) & (pos + shift < T))[None, :, None]
        cols.append(torch.where(ok, rolled, 0.0))
    out = torch.cat(cols, dim=-1) @ weight
    return torch.where(m, out, 0.0)


def sequence_reverse(x, lengths, name=None):
    return _seq_reverse(x, lengths)


def sequence_softmax(x, lengths, name=None):
    return _seq_softmax(x, lengths)


def sequence_pool(x, pool_type, lengths, name=None):
    return _seq_pool(x, lengths, pool_type=str(pool_type))


def sequence_conv(x, weight, lengths, context_length, context_start=None,
                  name=None):
    """See `_seq_conv`; context_start defaults to -((ctx - 1) // 2)."""
    if context_start is None:
        context_start = -((int(context_length) - 1) // 2)
    return _seq_conv(x, weight, lengths, context_length=int(context_length),
                     context_start=int(context_start))


def sequence_pad(x, pad_value, maxlen=None, lengths=None, name=None):
    """(flat values [sum(len), ...], lengths) -> (padded [B, T, ...],
    lengths); T is maxlen or the longest length (a shorter maxlen
    raises)."""
    if lengths is None:
        raise ValueError("sequence_pad needs `lengths` (the LoD split)")
    vals = _host(x, "sequence_pad")
    lens = _host(lengths, "sequence_pad").astype(np.int64).reshape(-1)
    T = int(maxlen) if maxlen is not None else int(lens.max(initial=0))
    if lens.size and int(lens.max(initial=0)) > T:
        raise ValueError("sequence_pad: maxlen=%d is smaller than the "
                         "longest sequence (%d)" % (T, int(lens.max())))
    pv = _host(pad_value, "sequence_pad")
    out = np.broadcast_to(pv, (len(lens), T) + vals.shape[1:]).astype(
        vals.dtype)
    off = 0
    for i, n in enumerate(lens):
        out[i, :int(n)] = vals[off:off + int(n)]
        off += int(n)
    return _back(out, x), _back(lens, x)


def sequence_unpad(x, length, name=None):
    """Padded [B, T, ...] and lengths -> flat [sum(len), ...]."""
    vals = _host(x, "sequence_unpad")
    lens = _host(length, "sequence_unpad").astype(np.int64).reshape(-1)
    parts = [vals[i, :int(n)] for i, n in enumerate(lens)]
    return _back(np.concatenate(parts, axis=0) if parts else vals[:0, 0], x)


def sequence_expand(x, ref_lengths, name=None):
    """Row i of x repeated ref_lengths[i] times."""
    vals = _host(x, "sequence_expand")
    lens = _host(ref_lengths, "sequence_expand").astype(np.int64).reshape(-1)
    return _back(np.repeat(vals, lens, axis=0), x)


def sequence_expand_as(x, ref_lengths, name=None):
    return sequence_expand(x, ref_lengths, name=name)


def sequence_concat(xs, lengths_list, name=None):
    """Sequence i of the output is sequence i of every input in turn:
    (flat values, lengths) pairs in, one pair out."""
    arrs = [_host(x, "sequence_concat") for x in xs]
    lens = [_host(n, "sequence_concat").astype(np.int64).reshape(-1)
            for n in lengths_list]
    B = len(lens[0])
    if any(len(n) != B for n in lens):
        raise ValueError("sequence_concat: batch sizes differ")
    offs = [np.concatenate([[0], np.cumsum(n)]) for n in lens]
    rows = [a[o[i]:o[i + 1]] for i in range(B) for a, o in zip(arrs, offs)]
    return (_back(np.concatenate(rows, axis=0), xs[0]),
            _back(np.sum(np.stack(lens), axis=0), xs[0]))


def sequence_enumerate(x, lengths, win_size, pad_value=0, name=None):
    """Every win_size-gram of each sequence of flat ids [N] -> [N,
    win_size], windows past a sequence's end padded."""
    ids = _host(x, "sequence_enumerate").reshape(-1)
    lens = _host(lengths, "sequence_enumerate").astype(np.int64).reshape(-1)
    out = np.full((len(ids), int(win_size)), pad_value, ids.dtype)
    off = 0
    for n in lens:
        seq = ids[off:off + int(n)]
        for i in range(int(n)):
            take = seq[i:i + int(win_size)]
            out[off + i, :len(take)] = take
        off += int(n)
    return _back(out, x)


def sequence_erase(x, lengths, tokens, name=None):
    """Every occurrence of `tokens` removed: (flat ids, new lengths)."""
    ids = _host(x, "sequence_erase").reshape(-1)
    lens = _host(lengths, "sequence_erase").astype(np.int64).reshape(-1)
    drop = [int(t) for t in tokens]
    rows, out_lens, off = [], [], 0
    for n in lens:
        seq = ids[off:off + int(n)]
        kept = seq[~np.isin(seq, drop)]
        rows.append(kept)
        out_lens.append(len(kept))
        off += int(n)
    return (_back(np.concatenate(rows) if rows else ids[:0], x),
            _back(np.asarray(out_lens, np.int64), x))


def sequence_reshape(x, lengths, new_dim, name=None):
    """Each sequence's payload reflowed to width new_dim: (values [-1,
    new_dim], lengths * old_dim / new_dim)."""
    vals = _host(x, "sequence_reshape")
    lens = _host(lengths, "sequence_reshape").astype(np.int64).reshape(-1)
    tot = lens * vals.shape[-1]
    if np.any(tot % new_dim):
        raise ValueError("sequence_reshape: payload %s not divisible by "
                         "new_dim=%d" % (tot.tolist(), new_dim))
    return (_back(vals.reshape(-1, int(new_dim)), x),
            _back(tot // new_dim, x))


def sequence_slice(x, lengths, offset, length, name=None):
    """Sequence i's steps [offset[i], offset[i] + length[i]): (flat
    values, length)."""
    vals = _host(x, "sequence_slice")
    lens = _host(lengths, "sequence_slice").astype(np.int64).reshape(-1)
    offs = _host(offset, "sequence_slice").astype(np.int64).reshape(-1)
    lns = _host(length, "sequence_slice").astype(np.int64).reshape(-1)
    rows, off = [], 0
    for i, n in enumerate(lens):
        if offs[i] < 0 or lns[i] < 0 or offs[i] + lns[i] > n:
            raise ValueError("sequence_slice: [%d, %d) out of range for "
                             "length %d" % (offs[i], offs[i] + lns[i], n))
        rows.append(vals[off + offs[i]:off + offs[i] + lns[i]])
        off += int(n)
    return _back(np.concatenate(rows, axis=0), x), _back(lns, x)


def sequence_scatter(x, index, updates, seg_lengths, name=None):
    """x[i, index[j]] += updates[j] for each j of segment i."""
    base = np.array(_host(x, "sequence_scatter"), copy=True)
    idx = _host(index, "sequence_scatter").astype(np.int64).reshape(-1)
    upd = _host(updates, "sequence_scatter").reshape(-1)
    segs = _host(seg_lengths, "sequence_scatter").astype(np.int64).reshape(-1)
    off = 0
    for i, n in enumerate(segs):
        np.add.at(base[i], idx[off:off + int(n)], upd[off:off + int(n)])
        off += int(n)
    return _back(base, x)
