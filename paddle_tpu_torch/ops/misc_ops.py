"""The long-tail ops (counterpart of paddle_tpu/ops/misc_ops.py; its
`ctc_align_op`, `gather_tree_op` and `frexp_op` are in ops/nn_ops.py and
ops/math.py).

Each op is registered under the reference's op type with the reference's
attrs as keyword arguments; none has a Pallas kernel in the reference
(each is XLA ops there), so each is torch ops here. The formulas are the
reference's, with its custom gradients (`cvm_op`'s CTR rule,
`teacher_student_sigmoid_loss_op`'s bounds) as autograd Functions, and
its tie rules: `viterbi_decode_op` and `beam_search_step_op` take the
first of tied maxima, as jnp.argmax and lax.top_k do.

Differences by design:
- `shuffle_batch_op` and `nce_op` draw their permutation and negatives
  from a torch generator seeded from the `key` input (the reference draws
  from a JAX key); the bodies that take the draws (`shuffle_rows`,
  `nce_loss`) are the reference's, and are held to it on its own draws;
- `hash_op` is the reference's splitmix64 mix on int64 words, its shifts
  masked to be logical and its modulus taken as unsigned, so its buckets
  are the reference's bit for bit.

`viterbi_decode_op`, `segment_pool_op`, `filter_by_instag_op` and
`py_func_op` size their output from values read on the host (or call the
host), so they refuse a CUDA graph capture (`no_capture`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dispatch import primitive
from .math import no_capture

__all__ = ["affine_channel", "viterbi_decode", "cvm", "center_loss",
           "squared_l2_distance", "teacher_student_sigmoid_loss",
           "fused_embedding_seq_pool", "squared_l2_norm", "hinge_loss",
           "rank_loss", "bpr_loss", "fsp_matrix", "pad_constant_like",
           "shuffle_batch", "shuffle_rows", "conv_shift", "row_conv",
           "correlation", "segment_pool", "positive_negative_pair",
           "filter_by_instag", "beam_search_step", "py_func_call",
           "data_norm", "linear_chain_crf", "hash_bucket", "fill_diagonal",
           "space_to_depth", "nce", "nce_loss", "prroi_pool",
           "key_generator"]


@primitive("affine_channel_op")
def affine_channel(x, scale, bias, data_layout="NCHW"):
    """x * scale_c + bias_c per channel (dim 1, or the last for 2-D
    inputs and NHWC)."""
    if x.dim() == 2 or data_layout == "NHWC":
        shape = (1,) * (x.dim() - 1) + (-1,)
    else:
        shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.reshape(shape) + bias.reshape(shape)


@primitive("viterbi_decode_op", nondiff=True)
def viterbi_decode(potentials, transition, lengths, include_bos_eos_tag=True):
    """The best tag path under a linear-chain CRF: (scores [B], path [B,
    max(lengths)] int64). With include_bos_eos_tag, transition's last row
    is the start tag's outgoing scores and its second-to-last the stop
    tag's incoming ones."""
    no_capture("viterbi_decode")
    B, T, C = potentials.shape
    left = lengths.long()[:, None]
    if include_bos_eos_tag:
        alpha = torch.full((B, C), -1e4, dtype=potentials.dtype,
                           device=potentials.device)
        alpha[:, -1] = 0.0
        start_t = 0
    else:
        alpha = potentials[:, 0, :]
        left = left - 1
        start_t = 1
    historys = []
    for t in range(start_t, T):
        scores_ij = alpha[:, :, None] + transition[None, :, :]
        best_prev = torch.argmax(scores_ij, dim=1)
        alpha_nxt = torch.amax(scores_ij, dim=1) + potentials[:, t, :]
        if not (include_bos_eos_tag and t == 0):
            historys.append(best_prev)
        alpha = torch.where(left > 0, alpha_nxt, alpha)
        if include_bos_eos_tag:
            alpha = alpha + (left == 1) * transition[None, -2, :]
        left = left - 1
    scores = torch.amax(alpha, dim=1)
    last_ids = torch.argmax(alpha, dim=1)
    left_v = left[:, 0]
    path = [torch.where(left_v >= 0, last_ids, 0)]
    for hist in reversed(historys):
        left_v = left_v + 1
        prev = hist.gather(1, last_ids[:, None])[:, 0]
        upd = torch.where(left_v > 0, prev, 0)
        upd = torch.where(left_v == 0, last_ids, upd)
        path.insert(0, upd)
        last_ids = torch.where(left_v < 0, last_ids, upd)
    path = torch.stack(path, dim=1).long()
    max_len = int(lengths.max())
    return scores, path[:, :max_len]


class _Cvm(torch.autograd.Function):
    """The CVM op with the reference's gradient rule: dX's show/click
    columns are the CVM input's values, the rest passes dY through."""

    @staticmethod
    def forward(ctx, x, cvm_feature, use_cvm):
        ctx.save_for_backward(cvm_feature)
        ctx.use_cvm, ctx.n = use_cvm, x.shape[0]
        if not use_cvm:
            return x[:, 2:].clone()
        y0 = torch.log(x[:, :1] + 1.0)
        y1 = torch.log(x[:, 1:2] + 1.0) - y0
        return torch.cat([y0, y1, x[:, 2:]], dim=1)

    @staticmethod
    def backward(ctx, dy):
        (c,) = ctx.saved_tensors
        head = c[:, :2].expand(ctx.n, 2).to(dy.dtype)
        rest = dy[:, 2:] if ctx.use_cvm else dy
        return torch.cat([head, rest], dim=1), torch.zeros_like(c), None


@primitive("cvm_op")
def cvm(x, cvm_feature, use_cvm=True):
    """X [N, D] whose first two columns are (show, click); CVM [N, 2]."""
    return _Cvm.apply(x, cvm_feature, bool(use_cvm))


@primitive("center_loss_op")
def center_loss(x, label, centers, update_rate, cluster_num,
                need_update=True):
    """(0.5 ||x - center[label]||^2 [N, 1], x - center[label], the updated
    centers: count-normalised summed differences times the update rate,
    counts from 1); the gradient reaches x only."""
    label = label.reshape(-1).long()
    c = centers.detach()
    diff = x - c[label]
    loss = 0.5 * torch.sum(diff * diff, dim=1, keepdim=True)
    if not need_update:
        return loss, diff, c
    acc = torch.zeros_like(c).index_add_(0, label, diff.detach())
    counts = torch.ones(cluster_num, dtype=x.dtype, device=x.device) \
        .index_add_(0, label, torch.ones_like(label, dtype=x.dtype))
    alpha = (torch.as_tensor(update_rate, dtype=c.dtype, device=c.device)
             if not isinstance(update_rate, torch.Tensor)
             else update_rate.detach()).reshape(())
    return loss, diff, c + alpha * acc / counts[:, None]


@primitive("squared_l2_distance_op")
def squared_l2_distance(x, y):
    """(x - y rows [N, C], their squared norms [N, 1]); y's rows broadcast
    where it has one."""
    sub = x.reshape(x.shape[0], -1) - y.reshape(y.shape[0], -1)
    return sub, torch.sum(sub * sub, dim=1, keepdim=True)


class _TsLoss(torch.autograd.Function):
    """The loss on unclipped x; the gradient of sigmoid(x clipped to the
    bounds) by label branch, zero at and outside the bounds."""

    @staticmethod
    def forward(ctx, x, label, up, lo):
        ctx.save_for_backward(x, label)
        ctx.up, ctx.lo = up, lo
        base = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
        return torch.where(
            label < -1.0, base,
            torch.where(label < 0.0, base - x,
                        torch.where(label < 1.0, 2.0 * base - x * label,
                                    (base - x) + base - x * (label - 1.0))))

    @staticmethod
    def backward(ctx, dy):
        x, label = ctx.saved_tensors
        pred = torch.sigmoid(torch.clamp(x, ctx.lo, ctx.up))
        branch = torch.where(label < -1.0, pred,
                             torch.where(label < 0.0, pred - 1.0,
                                         2.0 * pred - label))
        branch = torch.where((x >= ctx.up) | (x <= ctx.lo), 0.0, branch)
        return dy * branch, torch.zeros_like(label), None, None


@primitive("teacher_student_sigmoid_loss_op")
def teacher_student_sigmoid_loss(x, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """Sigmoid cross entropy against a click and an optional teacher value
    coded in one label (-2, -1, [0, 1) or [1, 2]); the bounds act on the
    gradient only, as the reference's kernels split them."""
    return _TsLoss.apply(x, label, float(soft_max_up_bound),
                         float(soft_max_lower_bound))


@primitive("fused_embedding_seq_pool_op")
def fused_embedding_seq_pool(w, ids, lengths, combiner="sum", padding_idx=-1):
    """The rows of w at ids [B, L], summed over each sequence's first
    lengths[b] ids (padding_idx rows left out)."""
    if combiner != "sum":
        raise NotImplementedError(
            "fused_embedding_seq_pool combiner %r: the reference kernel "
            "implements 'sum' only" % (combiner,))
    emb = w[ids.long().clamp(0, w.shape[0] - 1)]
    t = torch.arange(ids.shape[1], device=ids.device)[None, :]
    mask = t < lengths[:, None]
    if padding_idx >= 0:
        mask = mask & (ids != padding_idx)
    return torch.sum(emb * mask[..., None].to(w.dtype), dim=1)


@primitive("squared_l2_norm_op")
def squared_l2_norm(x):
    """sum(x^2) in float32, shape [1]."""
    return torch.sum(torch.square(x.float())).reshape(1)


@primitive("hinge_loss_op")
def hinge_loss(logits, labels):
    """max(0, 1 - (2 label - 1) logit), labels in {0, 1}; float32."""
    sign = 2.0 * labels.float() - 1.0
    v = 1.0 - sign * logits.float()
    return torch.maximum(torch.zeros_like(v), v)


@primitive("rank_loss_op")
def rank_loss(label, left, right):
    """RankNet: log(1 + exp(l - r)) - label (l - r); float32."""
    d = left.float() - right.float()
    return (torch.log1p(torch.exp(-d.abs()))
            + torch.maximum(d, torch.zeros_like(d)) - label.float() * d)


@primitive("bpr_loss_op")
def bpr_loss(x, label):
    """Bayesian personalised ranking over x [N, C]: the mean over j !=
    label of softplus(x_j - x_label), [N, 1] float32."""
    xf = x.float()
    C = xf.shape[1]
    lab = label.reshape(-1).long()
    d = xf.gather(1, lab[:, None]) - xf
    sp = torch.logaddexp(torch.zeros_like(d), -d)
    mask = 1.0 - torch.nn.functional.one_hot(lab, C).to(xf.dtype)
    return torch.sum(sp * mask, dim=1, keepdim=True) / max(C - 1, 1)


@primitive("fsp_op")
def fsp_matrix(x, y):
    """The flow-of-solution-procedure matrix [B, Cx, Cy] = mean over the
    H W positions of x[b, i] y[b, j]; float32."""
    B, Cx, H, W = x.shape
    xf = x.reshape(B, Cx, H * W).float()
    yf = y.reshape(B, y.shape[1], H * W).float()
    return torch.einsum("bik,bjk->bij", xf, yf) / float(H * W)


@primitive("pad_constant_like_op")
def pad_constant_like(x, y, pad_value=0.0):
    """y at the origin of an x-shaped tensor filled with pad_value."""
    flat = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        flat += [0, int(xs) - int(ys)]
    value = pad_value if y.is_floating_point() else int(pad_value)
    return torch.nn.functional.pad(y, flat, value=value)


def key_generator(key, device):
    """A torch generator on `device` seeded from a key input: the sum of
    its entries as an integer (a Python int passes as it is)."""
    if isinstance(key, torch.Tensor):
        key = int(key.detach().to(torch.int64).sum()) if key.numel() else 0
    return torch.Generator(device=device).manual_seed(int(key) % 2 ** 63)


def shuffle_rows(x, perm):
    """The rows of x in the order `perm`, and perm: the reference's body."""
    return x.index_select(0, perm), perm


@primitive("shuffle_batch_op")
def shuffle_batch(x, key):
    """A random permutation of x's rows, drawn from a torch generator
    seeded from `key` (see the module's note), and the permutation."""
    perm = torch.randperm(x.shape[0], generator=key_generator(key, x.device),
                          device=x.device)
    return shuffle_rows(x, perm)


@primitive("conv_shift_op")
def conv_shift(x, y):
    """Circular correlation: out[b, i] = sum_j x[b, (i + j - N//2) mod M]
    y[b, j]."""
    M, N = x.shape[1], y.shape[1]
    idx = (torch.arange(M, device=x.device)[:, None]
           + torch.arange(N, device=x.device)[None, :] - N // 2) % M
    return torch.einsum("bmn,bn->bm", x[:, idx], y)


@primitive("row_conv_op")
def row_conv(x, filt):
    """Lookahead row convolution: out[b, t] = sum_i x[b, t + i] filt[i],
    zero beyond T."""
    T = x.shape[1]
    F_ = filt.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, 0, F_ - 1))
    out = torch.zeros_like(x)
    for i in range(F_):
        out = out + xp[:, i:i + T, :] * filt[i][None, None, :]
    return out


@primitive("correlation_op")
def correlation(x1, x2, max_displacement=4, pad_size=4):
    """The cost volume out[b, k, h, w] = mean_c x1[b, c, h, w] x2[b, c, h +
    dy, w + dx] over (dy, dx) in [-d, d]^2 (kernel size 1, stride 1)."""
    B, C, H, W = x1.shape
    d, p = int(max_displacement), int(pad_size)
    if p != d:
        raise NotImplementedError(
            "correlation: only pad_size == max_displacement is supported "
            "(got pad_size=%d, max_displacement=%d)" % (p, d))
    x2p = torch.nn.functional.pad(x2, (p, p, p, p))
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            win = x2p[:, :, p + dy:p + dy + H, p + dx:p + dx + W]
            outs.append(torch.mean(x1 * win, dim=1))
    return torch.stack(outs, dim=1)


@primitive("segment_pool_op")
def segment_pool(x, segment_ids, pooltype="SUM"):
    """Rows of x pooled by segment id (SUM, MEAN, MAX or MIN) into
    max(segment_ids) + 1 rows; an empty segment's MAX is -inf and its MIN
    +inf, as jax.ops' are."""
    no_capture("segment_pool")
    ids = segment_ids.long()
    n = int(ids.max()) + 1 if ids.numel() else 0
    shape = (n,) + tuple(x.shape[1:])
    if pooltype in ("SUM", "MEAN"):
        s = torch.zeros(shape, dtype=x.dtype, device=x.device) \
            .index_add(0, ids, x)
        if pooltype == "SUM":
            return s
        cnt = torch.zeros(n, dtype=x.dtype, device=x.device).index_add(
            0, ids, torch.ones(x.shape[0], dtype=x.dtype, device=x.device))
        return s / torch.clamp_min(cnt, 1.0).reshape(
            (n,) + (1,) * (x.dim() - 1))
    if pooltype in ("MAX", "MIN"):
        fill = float("-inf") if pooltype == "MAX" else float("inf")
        idx = ids.reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
        return torch.full(shape, fill, dtype=x.dtype, device=x.device) \
            .scatter_reduce(0, idx, x, "amax" if pooltype == "MAX"
                            else "amin", include_self=True)
    raise ValueError("unknown pooltype %r" % (pooltype,))


@primitive("positive_negative_pair_op", nondiff=True)
def positive_negative_pair(score, label, query_id):
    """Over same-query pairs with label_i > label_j, the counts of score_i
    > score_j, < and ==: three float64 [1] tensors (the reference's sums
    of weak floats under x64)."""
    s = score.reshape(-1).float()
    lab = label.reshape(-1).float()
    q = query_id.reshape(-1)
    higher = (lab[:, None] > lab[None, :]) & (q[:, None] == q[None, :])
    return tuple(torch.sum((higher & cmp).double()).reshape(1)
                 for cmp in (s[:, None] > s[None, :],
                             s[:, None] < s[None, :],
                             s[:, None] == s[None, :]))


@primitive("filter_by_instag_op", nondiff=True)
def filter_by_instag(x, ins_tags, filter_tags, out_val_if_empty=0):
    """The rows whose tags (padded with -1) meet filter_tags: (rows, their
    indices int64, float32 loss weights of 1); one row of out_val_if_empty
    with index 0 and weight 0 where none does."""
    no_capture("filter_by_instag")
    tags = np.asarray(torch.as_tensor(ins_tags).cpu())
    want = set(np.asarray(torch.as_tensor(filter_tags).cpu())
               .reshape(-1).tolist())
    keep = [i for i in range(tags.shape[0])
            if want & set(t for t in tags[i].tolist() if t >= 0)]
    if not keep:
        return (torch.full((1,) + tuple(x.shape[1:]), out_val_if_empty,
                           dtype=x.dtype, device=x.device),
                torch.zeros(1, dtype=torch.int64, device=x.device),
                torch.zeros(1, dtype=torch.float32, device=x.device))
    idx = torch.tensor(keep, dtype=torch.int64, device=x.device)
    return (x.index_select(0, idx), idx,
            torch.ones(len(keep), dtype=torch.float32, device=x.device))


@primitive("beam_search_step_op", nondiff=True)
def beam_search_step(pre_ids, pre_scores, scores, beam_size, end_id,
                     is_accumulated=True):
    """One beam step on the dense layout: pre_ids / pre_scores [B, W],
    scores [B, W, V] -> (token ids [B, W], total scores [B, W] float32,
    parent beams [B, W]); a finished beam (pre_id == end_id) extends only
    with end_id at its score. The top W by a stable sort: ties keep the
    lower flat index first, as lax.top_k."""
    B, W, V = scores.shape
    if beam_size not in (None, W):
        raise ValueError("beam_search_step: beam_size=%s does not match the "
                         "beam dim of scores %s" % (beam_size,
                                                    tuple(scores.shape)))
    if is_accumulated:
        base = scores.float()
    else:
        base = (pre_scores[..., None].float()
                + torch.log(torch.clamp_min(scores.float(), 1e-30)))
    finished = (pre_ids == end_id)[..., None]
    is_end = torch.arange(V, device=scores.device)[None, None, :] == end_id
    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=scores.device)
    total = torch.where(finished, torch.where(
        is_end, pre_scores[..., None].float(), neg_inf), base)
    top_scores, top_idx = torch.sort(total.reshape(B, W * V), dim=1,
                                     descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :W], top_idx[:, :W]
    return ((top_idx % V).to(pre_ids.dtype), top_scores,
            (top_idx // V).int())


@primitive("py_func_op", nondiff=True)
def py_func_call(x, func, out_shape, out_dtype):
    """func on x's values on the host, its result of out_shape and
    out_dtype on x's device."""
    no_capture("py_func")
    out = np.asarray(func(x.detach().cpu().numpy()), dtype=out_dtype)
    return torch.from_numpy(out.reshape(tuple(out_shape))).to(x.device)


@primitive("data_norm_op")
def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4):
    """(x - batch_sum / batch_size) * sqrt(batch_size / batch_square_sum)
    in float32, in x's dtype; epsilon is taken and unused, as the
    reference's scale leaves it out."""
    bs = batch_size.float()
    mean = batch_sum.float() / bs
    scale = torch.sqrt(bs / batch_square_sum.float())
    return ((x.float() - mean) * scale).to(x.dtype)


@primitive("linear_chain_crf_op")
def linear_chain_crf(emission, transition, label, length):
    """The negative log-likelihood [B, 1] of a linear-chain CRF: emission
    [B, T, N], transition [N + 2, N] (start row, stop row, then
    transition[from, to]), label [B, T], length [B]; the partition
    function by a masked forward recursion over T."""
    B, T, N = emission.shape
    em = emission.float()
    start, stop = transition[0].float(), transition[1].float()
    trans = transition[2:].float()
    lab = label.long()
    ln = length.reshape(-1).long()
    ar = torch.arange(B, device=emission.device)
    alpha = start[None, :] + em[:, 0, :]
    gold = start[lab[:, 0]] + em[ar, 0, lab[:, 0]]
    for t in range(1, T):
        live = (t < ln)
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + em[:, t, :]
        alpha = torch.where(live[:, None], nxt, alpha)
        sc = trans[lab[:, t - 1], lab[:, t]] + em[ar, t, lab[:, t]]
        gold = gold + torch.where(live, sc, torch.zeros_like(sc))
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)
    gold = gold + stop[lab[ar, ln - 1]]
    return (log_z - gold).reshape(B, 1)


_U64 = 1 << 64


def _s64(v):
    """The uint64 constant v as the int64 of the same bits."""
    v %= _U64
    return v - _U64 if v >= 1 << 63 else v


def _shr(h, s):
    """A logical right shift of int64 words (torch's >> is arithmetic)."""
    return (h >> s) & ((1 << (64 - s)) - 1)


@primitive("hash_op", nondiff=True)
def hash_bucket(x, num_hash=1, mod_by=100000007):
    """out[..., k] = mix_k(x) mod mod_by, the reference's splitmix64 mix
    on uint64 words carried in int64 (the same bits: additions and
    products wrap alike), the modulus taken as unsigned; int64."""
    ids = x.long()
    m = int(mod_by)
    wrap = _U64 % m
    outs = []
    for k in range(int(num_hash)):
        h = ids + _s64(0x9E3779B97F4A7C15 * (k + 1))
        h = (h ^ _shr(h, 30)) * _s64(0xBF58476D1CE4E5B9)
        h = (h ^ _shr(h, 27)) * _s64(0x94D049BB133111EB)
        h = h ^ _shr(h, 31)
        r = torch.remainder(h, m)
        outs.append(torch.where(h < 0, torch.remainder(r + wrap, m), r))
    return torch.stack(outs, dim=-1)


@primitive("fill_diagonal_op")
def fill_diagonal(x, value=0.0, offset=0, wrap=False):
    """x with its (offset) diagonal set to value: within the leading W x W
    block, or with wrap restarting every W + 1 rows down a tall matrix;
    positions whose column leaves the row are skipped. The mask is built
    on x's device."""
    n, m = x.shape[-2], x.shape[-1]
    r = torch.arange(n, device=x.device)[:, None]
    c = torch.arange(m, device=x.device)[None, :]
    if wrap:
        k = r % (m + 1)
        mask = (k < m) & (c == k + offset)
    else:
        mask = (r < min(n, m)) & (c == r + offset)
    return torch.where(mask, torch.tensor(value, dtype=x.dtype,
                                          device=x.device), x)


@primitive("space_to_depth_op")
def space_to_depth(x, blocksize):
    """The darknet reorg layer (YOLO): the reference's channel order,
    neither pixel_unshuffle's nor block-major packing (see the
    reference's docstring); C must divide by blocksize^2."""
    r = int(blocksize)
    n, c, h, w = x.shape
    if r <= 0:
        raise ValueError("space_to_depth: blocksize must be >= 1, got %d" % r)
    if c % (r * r):
        raise ValueError("space_to_depth: channels (%d) must be divisible "
                         "by blocksize^2 (%d)" % (c, r * r))
    if h % r or w % r:
        raise ValueError("space_to_depth: spatial dims (%dx%d) must be "
                         "divisible by blocksize (%d)" % (h, w, r))
    c2 = c // (r * r)
    buf = x.reshape(n, r, r, c2, h, w).permute(0, 3, 4, 1, 5, 2)
    return buf.reshape(n, c2, h * r, w * r).reshape(n, c * r * r, h // r,
                                                    w // r)


def nce_loss(x, weight, bias, lab, neg, log_b):
    """The NCE loss [B, 1] on given negatives neg [B, k]: softplus(log b -
    s_pos) + sum softplus(s_neg - log b), scores in float32 (the
    reference's body)."""
    xf, wf, bf = x.float(), weight.float(), bias.float()
    s_pos = torch.einsum("bd,bd->b", xf, wf[lab]) + bf[lab]
    s_neg = torch.einsum("bd,bkd->bk", xf, wf[neg]) + bf[neg]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    loss = (torch.logaddexp(zero, log_b - s_pos)
            + torch.sum(torch.logaddexp(zero, s_neg - log_b), dim=1))
    return loss.reshape(x.shape[0], 1)


@primitive("nce_op")
def nce(x, weight, bias, label, key, num_neg_samples=5,
        num_total_classes=None):
    """Noise-contrastive estimation with the uniform sampler, the noise
    mass b = k / V: x [B, D], weight [V, D], bias [V], label [B(, 1)];
    the negatives drawn from a torch generator seeded from `key` (see the
    module's note); per-row loss [B, 1]."""
    B = x.shape[0]
    V = weight.shape[0] if num_total_classes is None else num_total_classes
    if V > weight.shape[0]:
        raise ValueError("nce: num_total_classes=%d exceeds the weight "
                         "table's %d rows" % (V, weight.shape[0]))
    k = int(num_neg_samples)
    neg = torch.randint(0, V, (B, k), generator=key_generator(key, x.device),
                        device=x.device)
    return nce_loss(x, weight, bias, label.reshape(-1).long(), neg,
                    float(np.log(k / V)))


def _hat_int(u):
    """The antiderivative of the hat max(0, 1 - |t|), clipped to [-1, 1]."""
    u = torch.minimum(torch.maximum(u, u.new_full((), -1.0)),
                      u.new_full((), 1.0))
    return torch.where(u <= 0, 0.5 * (u + 1.0) ** 2, 0.5 + u - 0.5 * u * u)


def _axis_weights(lo, hi, n_bins, size, dtype, device):
    bw = (hi - lo) / n_bins
    starts = lo[:, None] + bw[:, None] * torch.arange(
        n_bins, dtype=dtype, device=device)[None, :]
    rel = starts[:, :, None] - torch.arange(size, dtype=dtype,
                                            device=device)[None, None, :]
    return _hat_int(rel + bw[:, None, None]) - _hat_int(rel), bw


@primitive("prroi_pool_op")
def prroi_pool(x, boxes, output_size, spatial_scale=1.0):
    """Precise RoI pooling: the exact integral of the bilinear surface over
    each bin over the bin's area (IoU-Net); x [1, C, H, W], boxes [R, 4]
    (x1, y1, x2, y2) -> [R, C, ph, pw], differentiable in the boxes."""
    _, c, h, w = x.shape
    ph, pw = output_size
    img = x[0]
    s = spatial_scale
    wy, bh = _axis_weights(boxes[:, 1] * s, boxes[:, 3] * s, ph, h,
                           img.dtype, img.device)
    wx, bw = _axis_weights(boxes[:, 0] * s, boxes[:, 2] * s, pw, w,
                           img.dtype, img.device)
    area = torch.clamp_min(bh * bw, 1e-6)
    return (torch.einsum("chw,rih,rjw->rcij", img, wy, wx)
            / area[:, None, None, None])

