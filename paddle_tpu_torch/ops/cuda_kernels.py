"""Hand-written CUDA kernels of the ported paths, with their gates.

Counterpart of paddle_tpu/ops/pallas_kernels.py for the kernel families
the serving and training paths run:

  * flash-attention forward (csrc/flash_fwd.cu), replacing
    `_flash_fwd_kernel`: prefill attention (`flash_fwd`) and the training
    forward with an lse output and in-kernel dropout (`flash_fwd_train`);
  * flash-attention backward (csrc/flash_bwd.cu), replacing
    `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`, behind
    `FlashAttentionFunction` (the counterpart of the custom vjp `_flash`);
  * the attention-dropout bits (csrc/attn_dropout.cuh, Philox-4x32-10 per
    element): `attn_dropout_bits` writes them out so the checks can hand
    them to the plain versions;
  * fused bias + dropout + residual (+ LayerNorm) (csrc/
    fused_dropout_ln.cu), replacing `_fbdrln_fwd_kernel`,
    `_fbdrln_fwd_noln_kernel` and `_fbdrln_bwd_kernel`, behind
    `FusedDropoutResidualLNFunction` (the counterpart of the custom vjp
    `_fbdrln_pair`); `fused_dropout_bits` writes its dropout bits out;
  * fused AdamW (csrc/adamw.cu), replacing `_adamw_kernel`;
  * paged decode (csrc/paged_decode.cu) — one decode step's KV append plus
    single-query attention over the paged cache, float32 or int8, replacing
    `_paged_f_kernel` / `_paged_q_kernel` (`_paged_core`).

Beside each kernel sit its plain PyTorch version, a launch counter and a
note on what bounds it. A wrapper checks its inputs against what the
kernel takes on every device and raises ValueError on anything else; it
then runs the plain version for tensors that lie on the CPU and launches
the kernel for CUDA tensors. There is no probe and no quiet fallback: a
gate returns None (the caller's plain route) only when the kernel's flag
is off (`use_flash_attention`, `use_fused_optimizer`,
`paged_flash_decode`, `use_fused_dropout_ln`), which the attention
callers report in the path counters (`xla_sdpa`, `xla_paged`).

The int8 KV rule (`quantize_kv` / `dequantize_kv`) lives here too: the
paged-decode kernel's in-kernel append must match it bit for bit, and the
serving cache imports it from this module.

Launch counters (`launch_counts`) count kernel launches and nothing else.
Path counters (`attention_path_counts`) count which implementation the
gates chose, on any device, and feed `pt_attn_path_total{path}`.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..amp import amp_cast_inputs
from ..framework.flags import flag
from ..framework.random import next_seed_offset
from ..observability import metrics
from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "flash_fwd_train",
           "flash_fwd_train_plain", "flash_bwd_dq", "flash_bwd_dq_plain",
           "flash_bwd_dkv", "flash_bwd_dkv_plain", "FlashAttentionFunction",
           "attn_dropout_bits", "attn_dropout_bits_plain",
           "flash_attention_or_none", "fused_dropout_ln_fwd",
           "fused_dropout_ln_fwd_plain", "fused_dropout_residual_fwd",
           "fused_dropout_residual_fwd_plain", "fused_dropout_ln_bwd",
           "fused_dropout_ln_bwd_plain", "FusedDropoutResidualLNFunction",
           "fused_dropout_bits", "fused_dropout_bits_plain",
           "fused_bias_dropout_residual_ln",
           "fused_dropout_residual_ln_or_none", "DROPOUT_MODES", "adamw",
           "adamw_plain",
           "fused_adamw_or_none", "paged_decode", "paged_decode_plain",
           "paged_decode_attention_or_none", "quantize_kv", "dequantize_kv",
           "launch_counts", "attention_path_counts"]

_NEG_INF = -1e30

# kernel launches, bumped by the wrappers right after a successful launch
_LAUNCHES = {"flash_fwd": 0, "flash_fwd_train": 0, "flash_bwd_dq": 0,
             "flash_bwd_dkv": 0, "attn_dropout_bits": 0,
             "fused_dropout_ln_fwd": 0, "fused_dropout_residual_fwd": 0,
             "fused_dropout_ln_bwd": 0, "fused_dropout_bits": 0, "adamw": 0,
             "paged_decode": 0, "paged_decode_int8": 0}

# attention implementation chosen by the gates (reference:
# pallas_kernels.py _ATTN_PATHS / _note_attn_path)
_ATTN_PATHS = {"flash": 0, "flash_dropout": 0, "xla_sdpa": 0,
               "paged_flash": 0, "xla_paged": 0}
_ATTN_COUNTER = metrics.counter(
    "pt_attn_path_total", "Attention implementations run, by path",
    labelnames=("path",))

# the paged-decode kernel keeps one float score per cache row in shared
# memory and stays under the 48 KB a block gets without an opt-in
_PAGED_MAX_T = 8192


def launch_counts(reset=False):
    out = dict(_LAUNCHES)
    if reset:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0
    return out


def _note_attn_path(path):
    _ATTN_PATHS[path] = _ATTN_PATHS.get(path, 0) + 1
    _ATTN_COUNTER.labels(path).inc()


def attention_path_counts(reset=False):
    out = dict(_ATTN_PATHS)
    if reset:
        for k in _ATTN_PATHS:
            _ATTN_PATHS[k] = 0
    return out


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(err, name):
    if err != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (name, err))


def _need(cond, msg):
    if not cond:
        raise ValueError(msg)


def _on_cuda(t, name):
    """True for a CPU tensor's plain route, False for a CUDA launch; raises
    for any other device."""
    if t.device.type == "cpu":
        return False
    _need(t.device.type == "cuda", "%s: tensors on %s" % (name, t.device))
    return True


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Attention dropout bits
#
# The flash kernels draw their dropout mask in the kernel (attn_dropout.cuh):
# Philox-4x32-10 keyed by the call's 64-bit seed, counter (col, row // 4,
# batch*head, call offset), word row % 4; keep iff bits >= floor(p * 2^32)
# (clamped to 2^32 - 1), kept values scaled by 1 / (1 - p) — the keep and
# scale rule of the reference's `_attn_drop_keep` / `_attn_drop_scale`.
# A bit depends on its element only, never on the tiling, so the forward
# and both backward kernels regenerate one mask. The plain versions take
# the bits as an int64 tensor [B*H, Tq, Tk] holding values in [0, 2^32).

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a, b):
    """(hi, lo) 32-bit halves of the constant a times int64 tensor b, both
    below 2^32, in int64 arithmetic without overflow."""
    x = (b >> 16) * a                      # < 2^48
    y = (b & 0xFFFF) * a                   # < 2^48
    s = ((x & 0xFFFF) << 16) + y           # < 2^49
    return (x >> 16) + (s >> 32), s & _U32


def _philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 (Random123) on int64 tensors holding uint32 values;
    the function attn_dropout.cuh computes on the card."""
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def attn_dropout_bits_plain(seed, offset, BH, Tq, Tk, device="cpu"):
    """The kernels' dropout bits, [BH, Tq, Tk] int64 in [0, 2^32)."""
    G = (Tq + 3) // 4
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    shape = (BH, G, Tk)
    words = _philox4x32_10(
        ar(Tk).view(1, 1, Tk).expand(shape), ar(G).view(1, G, 1).expand(shape),
        ar(BH).view(BH, 1, 1).expand(shape),
        torch.full(shape, int(offset), dtype=torch.int64, device=device),
        int(seed) & _U32, (int(seed) >> 32) & _U32)
    bits = torch.stack(words, dim=2).reshape(BH, 4 * G, Tk)
    return bits[:, :Tq].contiguous()


def attn_dropout_bits(seed, offset, BH, Tq, Tk, device="cuda"):
    """The dropout bits the flash kernels draw for (seed, offset), written
    out by a small kernel; the plain version on the CPU. Not on the main
    path: the checks hand these bits to the plain versions."""
    dev = torch.device(device)
    _need(0 <= int(seed) < 2 ** 64 and 0 <= int(offset) < 2 ** 32,
          "attn_dropout_bits: seed must fit 64 bits and offset 32")
    probe = torch.empty(0, device=dev)
    if not _on_cuda(probe, "attn_dropout_bits"):
        return attn_dropout_bits_plain(seed, offset, BH, Tq, Tk, dev)
    out = torch.empty((BH, Tq, Tk), dtype=torch.int32, device=dev)
    err = _build.load("flash_fwd").attn_dropout_bits(
        out.data_ptr(), int(seed), int(offset), BH, Tq, Tk, _stream(out))
    _check_launch(err, "attn_dropout_bits")
    _LAUNCHES["attn_dropout_bits"] += 1
    return out.to(torch.int64) & _U32


def _threshold(p):
    """The keep rule's threshold: keep iff bits >= floor(p * 2^32),
    clamped to 2^32 - 1."""
    return min(int(p * (2.0 ** 32)), 2 ** 32 - 1)


def _drop_args(dropout_p):
    """(threshold, scale) of the keep rule: keep iff bits >= threshold,
    kept values times scale (float32, as the reference's weak-typed
    1 / (1 - p) multiply rounds it)."""
    return _threshold(dropout_p), float(np.float32(1.0 / (1.0 - dropout_p)))


def _keep_mask(bits, dropout_p, shape):
    thr, _ = _drop_args(dropout_p)
    return bits.reshape(shape) >= thr


# ---------------------------------------------------------------------------
# Flash-attention forward
#
# Replaces pallas_kernels.py `_flash_fwd_kernel` (:324, via `_flash_fwd`
# :412). Bound on the H100: at the serving prefill shapes (B=1, H=12,
# T<=256, D=64) a few microseconds of bytes or flops, so the kernel is
# latency-bound; at the training shapes (B=16, H=12, T=512, D=64, causal)
# it is bound by operations. It keeps the [Tq, Tk] scores and the dropout
# mask on chip and skips the K/V tiles above the causal diagonal (see the
# source's note).


def _scores(q, k, causal):
    """Scaled float32 scores q k^T / sqrt(D), the causal mask aligned
    bottom-right (query i sees keys j <= i + Tk - Tq) as -1e30."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        float(d) ** -0.5)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=s.device).tril(tk - tq)
        s = torch.where(cm, s, torch.full_like(s, _NEG_INF))
    return s


def flash_attention_plain(q, k, v, causal, attn_mask=None, keep=None,
                          dropout_p=0.0):
    """softmax(q k^T / sqrt(D) + attn_mask) v in float32, causal mask
    aligned bottom-right, returned in q's dtype (reference:
    pallas_kernels.py `_xla_attention`). With `keep` (bool, [B, H, Tq, Tk])
    the probabilities are dropped where keep is False and the rest scaled
    by 1 / (1 - dropout_p). The one dense attention body of the port: the
    kernels' CPU path, the plain sdpa route and the suffix-prefill
    attention all run it."""
    s = _scores(q, k, causal)
    if attn_mask is not None:
        s = s + attn_mask.float()
    w = torch.softmax(s, dim=-1)
    if keep is not None:
        w = torch.where(keep, w * _drop_args(dropout_p)[1], 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def flash_fwd_train_plain(q, k, v, causal, dropout_p=0.0, bits=None):
    """Plain version of the training forward: (out, lse) with lse
    [B*H, Tq] float32 the logsumexp of the scaled scores, and dropout by
    the explicit `bits` ([B*H, Tq, Tk] int64) when dropout_p > 0."""
    B, H, Tq, _ = q.shape
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1).reshape(B * H, Tq)
    keep = (_keep_mask(bits, dropout_p, s.shape) if dropout_p > 0.0
            else None)
    w = torch.softmax(s, dim=-1)
    if keep is not None:
        w = torch.where(keep, w * _drop_args(dropout_p)[1], 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
    return out, lse


def _flash_check(q, k, v, causal, dropout_p=0.0):
    """What the kernels take (the reference's `_shapes_ok` minus the TPU
    tiling rules: any T, ragged edges masked in the kernel); raises
    ValueError on anything else."""
    _need(q.ndim == 4 and k.ndim == 4 and q.dtype in _DTYPE_CODE
          and q.shape[-1] <= 128 and not (causal and k.shape[2] < q.shape[2]),
          "flash_attention: unsupported input %s %s %s causal=%s (float32 "
          "or bfloat16, [B,H,T,D] with D<=128, Tk>=Tq when causal)"
          % (tuple(q.shape), tuple(k.shape), q.dtype, causal))
    B, H, Tq, D = q.shape
    _need(tuple(k.shape) == (B, H, k.shape[2], D) and v.shape == k.shape
          and k.dtype == q.dtype and v.dtype == q.dtype,
          "flash_attention: k/v shape or dtype")
    _need(0.0 <= dropout_p < 1.0,
          "flash_attention: dropout_p %r (the kernel takes 0 <= p < 1)"
          % (dropout_p,))
    for t in (q, k, v):
        _need(t.device == q.device, "flash_attention: mixed devices")
        _need(t.stride(-1) == 1, "flash_attention: head_dim stride != 1")


def _strides(*ts):
    """(batch, head, time) element strides of [B, H, T, D] tensors, as the
    kernels' C arrays take them; None stands for a tensor a kernel does
    not touch."""
    vals = [s for t in ts for s in (t.stride()[:3] if t is not None
                                    else (0, 0, 0))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bhtd_empty(B, H, T, D, like):
    """[B, H, T, D] output laid out as [B, T, H, D]: the attention layer's
    transpose(1, 2).reshape(B, T, H*D) is then a view, not a copy."""
    return torch.empty((B, T, H, D), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _flash_fwd(q, k, v, causal, dropout_p, seed, offset, need_lse):
    """The forward kernel, or its plain version on CPU tensors; counts a
    launch as flash_fwd_train when it writes lse or drops, else as
    flash_fwd. Returns (out, lse or None)."""
    _flash_check(q, k, v, causal, dropout_p)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if not _on_cuda(q, "flash_attention"):
        bits = (attn_dropout_bits_plain(seed, offset, B * H, Tq, Tk)
                if dropout_p > 0.0 else None)
        out, lse = flash_fwd_train_plain(q, k, v, causal, dropout_p, bits)
        return out, (lse if need_lse else None)
    o = _bhtd_empty(B, H, Tq, D, q)
    lse = (torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    thr, scale = _drop_args(dropout_p)
    lib = _build.load("flash_fwd")
    strides = _strides(q, k, v, o)
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if need_lse else None, ctypes.addressof(strides),
        B, H, Tq, Tk, D, int(bool(causal)), float(D) ** -0.5,
        _DTYPE_CODE[q.dtype], int(dropout_p > 0.0), thr, scale, int(seed),
        int(offset), _stream(q))
    name = "flash_fwd_train" if (need_lse or dropout_p > 0.0) else \
        "flash_fwd"
    _check_launch(err, name)
    _LAUNCHES[name] += 1
    return o, lse


def flash_attention(q, k, v, causal):
    """Attention forward without lse or dropout (the serving prefill), q/k/v
    [B, H, T, D]; any strides with a unit head_dim stride. Inputs the
    kernel does not take raise ValueError on every device; CPU tensors
    then take the plain version."""
    return _flash_fwd(q, k, v, causal, 0.0, 0, 0, False)[0]


def flash_fwd_train(q, k, v, causal, dropout_p=0.0, seed=0, offset=0,
                    need_lse=True):
    """The training forward: (out, lse [B*H, Tq] float32 or None), with
    attention dropout at `dropout_p` drawn from (seed, offset)."""
    return _flash_fwd(q, k, v, causal, float(dropout_p), seed, offset,
                      need_lse)


# ---------------------------------------------------------------------------
# Flash-attention backward
#
# Replaces pallas_kernels.py `_flash_bwd_dq_kernel` (:462) and
# `_flash_bwd_dkv_kernel` (:524), launched by `_flash_bwd` (:589).
# bfloat16 inputs (every training path, under O2 or auto_cast) run on the
# tensor cores: bf16 mma.sync with float32 sums, M o p and dS kept in
# registers as bf16 hi + lo operand pairs. At the training shapes
# they are bound by bytes on paper, and in practice by the dropout's
# Philox calls and mma.sync's share of the tensor-core peak (see the
# source's note). float32 inputs keep the CUDA-core kernels in full
# float32. Delta = rowsum(dO o O) is computed once, by the dq kernel, which
# writes it beside dq; the dkv kernel reads it (no launch of its own).


def _bwd_terms(q, k, v, do, lse, causal, dropout_p, bits):
    """p = exp(s - lse), the dropped dP, and the keep scale (plain)."""
    B, H, Tq, _ = q.shape
    s = _scores(q, k, causal)
    p = torch.exp(s - lse.reshape(B, H, Tq, 1))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    pd = p
    if dropout_p > 0.0:
        keep = _keep_mask(bits, dropout_p, s.shape)
        scale = _drop_args(dropout_p)[1]
        pd = torch.where(keep, p * scale, 0.0)
        dp = torch.where(keep, dp * scale, 0.0)
    return p, pd, dp


def flash_bwd_dq_plain(q, k, v, o, do, lse, causal, dropout_p=0.0,
                       bits=None):
    """(dq in q's dtype, Delta [B*H, Tq] float32) as `_flash_bwd_dq_kernel`
    computes them: dS = p (dP - Delta) / sqrt(D), dq = dS K."""
    B, H, Tq, D = q.shape
    delta = (do.float() * o.float()).sum(-1)
    p, _, dp = _bwd_terms(q, k, v, do, lse, causal, dropout_p, bits)
    ds = p * (dp - delta[..., None]) * (float(D) ** -0.5)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq.to(q.dtype), delta.reshape(B * H, Tq)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, dropout_p=0.0,
                        bits=None):
    """(dk, dv) in k's dtype as `_flash_bwd_dkv_kernel` computes them:
    dv = (M o p)^T dO, dk = dS^T Q."""
    B, H, Tq, D = q.shape
    p, pd, dp = _bwd_terms(q, k, v, do, lse, causal, dropout_p, bits)
    ds = p * (dp - delta.reshape(B, H, Tq, 1)) * (float(D) ** -0.5)
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_check(q, k, v, rows, lse, causal, dropout_p):
    """`rows`: the [B, H, Tq, D] tensors beside q (o, dO)."""
    _flash_check(q, k, v, causal, dropout_p)
    B, H, Tq, _ = q.shape
    for t in rows:
        _need(t.shape == q.shape and t.dtype == q.dtype
              and t.device == q.device and t.stride(-1) == 1,
              "flash backward: o/dO must match q's shape, dtype and device "
              "with unit head_dim stride")
    for t in lse:
        _need(t.dtype == torch.float32 and tuple(t.shape) == (B * H, Tq)
              and t.is_contiguous() and t.device == q.device,
              "flash backward: lse/delta must be contiguous float32 "
              "[B*H, Tq]")


def _bwd_launch(fn, name, ptrs, q, k, causal, dropout_p, seed, offset,
                strides):
    B, H, Tq, D = q.shape
    thr, scale = _drop_args(dropout_p)
    err = getattr(_build.load("flash_bwd"), fn)(
        *ptrs, ctypes.addressof(strides), B, H, Tq, k.shape[2], D,
        int(bool(causal)), float(D) ** -0.5, _DTYPE_CODE[q.dtype],
        int(dropout_p > 0.0), thr, scale, int(seed), int(offset),
        _stream(q))
    _check_launch(err, name)
    _LAUNCHES[name] += 1


def flash_bwd_dq(q, k, v, o, do, lse, causal, dropout_p=0.0, seed=0,
                 offset=0):
    """dq kernel: (dq, Delta). Dropout bits are regenerated from (seed,
    offset), which must be the forward's."""
    dropout_p = float(dropout_p)
    _bwd_check(q, k, v, (o, do), (lse,), causal, dropout_p)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if not _on_cuda(q, "flash_bwd_dq"):
        bits = (attn_dropout_bits_plain(seed, offset, B * H, Tq, Tk)
                if dropout_p > 0.0 else None)
        return flash_bwd_dq_plain(q, k, v, o, do, lse, causal, dropout_p,
                                  bits)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_dq", "flash_bwd_dq",
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 delta.data_ptr()), q, k, causal, dropout_p, seed, offset,
                _strides(q, k, v, o, do, dq, None, None))
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal, dropout_p=0.0, seed=0,
                  offset=0):
    """dk/dv kernel: (dk, dv); `delta` from flash_bwd_dq."""
    dropout_p = float(dropout_p)
    _bwd_check(q, k, v, (do,), (lse, delta), causal, dropout_p)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if not _on_cuda(q, "flash_bwd_dkv"):
        bits = (attn_dropout_bits_plain(seed, offset, B * H, Tq, Tk)
                if dropout_p > 0.0 else None)
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                   dropout_p, bits)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _bwd_launch("flash_bwd_dkv", "flash_bwd_dkv",
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr()), q, k, causal, dropout_p, seed, offset,
                _strides(q, k, v, None, do, None, dk, dv))
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward (the counterpart of the custom vjp
    `_flash` :675 with `defvjp` :703). The forward runs the forward
    kernel, writing lse only when an input needs a gradient; the backward
    runs the dq and dk/dv kernels with the forward's dropout (seed,
    offset). CPU tensors take the plain versions through the same
    Function, so the graph is the same on every device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, dropout_p, seed, offset):
        need_lse = any(ctx.needs_input_grad[:3])
        o, lse = flash_fwd_train(q, k, v, causal, dropout_p, seed, offset,
                                 need_lse)
        if need_lse:
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.args = (causal, dropout_p, seed, offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, dropout_p, seed, offset = ctx.args
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, o, do, lse, causal, dropout_p,
                                 seed, offset)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, dropout_p,
                               seed, offset)
        return dq, dk, dv, None, None, None, None


def flash_attention_or_none(query, key, value, attn_mask, is_causal,
                            dropout_p=0.0):
    """Gate (reference: pallas_kernels.py flash_attention_or_none :1534):
    None when `use_flash_attention` is off (the caller then runs the plain
    version), else the output of `FlashAttentionFunction`, with attention
    dropout at `dropout_p` drawn in the kernel (path counter
    flash_dropout) or without (flash). An additive mask, p >= 1, or an
    input the kernel does not take raises ValueError: unlike the
    reference's gate, this one never hands such a call to the plain
    version on its own. Under amp.auto_cast this is the op
    flash_attention (white list): q, k and v enter in the amp dtype."""
    if not flag("use_flash_attention"):
        return None
    query, key, value = amp_cast_inputs("flash_attention",
                                        [query, key, value])
    _need(attn_mask is None,
          "flash_attention: the kernel takes no additive mask; set the "
          "use_flash_attention flag to False for the plain version")
    dropout_p = float(dropout_p)
    seed, offset = next_seed_offset() if dropout_p > 0.0 else (0, 0)
    out = FlashAttentionFunction.apply(query, key, value, bool(is_causal),
                                       dropout_p, seed, offset)
    _note_attn_path("flash_dropout" if dropout_p > 0.0 else "flash")
    return out


# ---------------------------------------------------------------------------
# Fused bias + dropout + residual (+ LayerNorm)
#
# Replaces pallas_kernels.py `_fbdrln_fwd_kernel` (:768),
# `_fbdrln_fwd_noln_kernel` (:792) and `_fbdrln_bwd_kernel` (:800), launched
# by `_fbdrln_call` (:840) behind the custom vjp `_fbdrln_pair` (:943).
# Bound on the H100: bytes (one pass over the [N, Hd] rows per call). The
# dropout bits are Philox-4x32-10 keyed by the call's 64-bit seed, counter
# (col, row // 4, _FDRLN_TAG, call offset), word row % 4 (csrc/
# fused_dropout_ln.cu); the backward regenerates the forward's mask from
# the saved (seed, offset). The plain versions take the bits as an int64
# tensor [N, Hd] holding values in [0, 2^32), or draw the kernels' own.

_FDRLN_TAG = 0xFD1D0000
# the backward kernel keeps 7 float32 values per column in shared memory
FDRLN_MAX_HD = 8192
# the backward kernel's CTAs per SM (each walks every grid-th 4-row group)
_FDRLN_BWD_CTAS_PER_SM = 4
_SM_COUNT = {}


def fused_dropout_bits_plain(seed, offset, N, Hd, device="cpu"):
    """The fused kernels' dropout bits, [N, Hd] int64 in [0, 2^32)."""
    G = (N + 3) // 4
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    shape = (G, Hd)
    full = lambda v: torch.full(shape, int(v), dtype=torch.int64,
                                device=device)
    words = _philox4x32_10(
        ar(Hd).view(1, Hd).expand(shape), ar(G).view(G, 1).expand(shape),
        full(_FDRLN_TAG), full(offset), int(seed) & _U32,
        (int(seed) >> 32) & _U32)
    bits = torch.stack(words, dim=1).reshape(4 * G, Hd)
    return bits[:N].contiguous()


def fused_dropout_bits(seed, offset, N, Hd, device="cuda"):
    """The dropout bits the fused kernels draw for (seed, offset), written
    out by a small kernel; the plain version on the CPU. Not on the main
    path: the checks hand these bits to the plain versions."""
    dev = torch.device(device)
    _need(0 <= int(seed) < 2 ** 64 and 0 <= int(offset) < 2 ** 32,
          "fused_dropout_bits: seed must fit 64 bits and offset 32")
    if not _on_cuda(torch.empty(0, device=dev), "fused_dropout_bits"):
        return fused_dropout_bits_plain(seed, offset, N, Hd, dev)
    out = torch.empty((N, Hd), dtype=torch.int32, device=dev)
    err = _build.load("fused_dropout_ln").fused_dropout_bits(
        out.data_ptr(), int(seed), int(offset), N, Hd, _stream(out))
    _check_launch(err, "fused_dropout_bits")
    _LAUNCHES["fused_dropout_bits"] += 1
    return out.to(torch.int64) & _U32


def _fdrln_drop(h, p, scale, seed, offset, bits):
    """`_dropout_keep`: h where bits >= floor(p * 2^32) (clamped to
    2^32 - 1) times scale, else 0; the kernels' bits for (seed, offset)
    when `bits` is None."""
    if bits is None:
        bits = fused_dropout_bits_plain(seed, offset, *h.shape,
                                        device=h.device)
    return torch.where(bits.reshape(h.shape) >= _threshold(p), h * scale,
                       0.0)


def _fdrln_z(x, residual, bias, p, scale, seed, offset, bits):
    h = x.float()
    if bias is not None:
        h = h + bias.float().reshape(-1)
    if p > 0.0:
        h = _fdrln_drop(h, p, scale, seed, offset, bits)
    return residual.float() + h


def _ln_stats(z, eps):
    """(mean, rstd) over the last axis of float32 z, the variance in two
    passes as `_fbdrln_fwd_kernel` takes it."""
    mean = z.mean(-1, keepdim=True)
    var = (z - mean).square().mean(-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def fused_dropout_residual_fwd_plain(x, residual, bias, p, scale, seed=0,
                                     offset=0, bits=None):
    """`_fbdrln_fwd_noln_kernel` in plain PyTorch: z = residual +
    dropout(x + bias) in float32, stored in x's dtype. x, residual
    [N, Hd]; bias [Hd] or None; at p > 0 the keep mask comes from `bits`
    ([N, Hd], values in [0, 2^32)) or from the kernels' bits for (seed,
    offset), kept values times `scale`."""
    return _fdrln_z(x, residual, bias, p, scale, seed, offset,
                    bits).to(x.dtype)


def fused_dropout_ln_fwd_plain(x, residual, bias, gamma, beta, p, scale,
                               eps, seed=0, offset=0, bits=None):
    """`_fbdrln_fwd_kernel` in plain PyTorch: (y, z) with z as
    `fused_dropout_residual_fwd_plain` computes it and y = (z - mean) *
    rstd * gamma + beta from the float32 z; both stored in x's dtype."""
    z = _fdrln_z(x, residual, bias, p, scale, seed, offset, bits)
    mean, rstd = _ln_stats(z, eps)
    y = (z - mean) * rstd * gamma.float().reshape(-1) + \
        beta.float().reshape(-1)
    return y.to(x.dtype), z.to(x.dtype)


def fused_dropout_ln_bwd_plain(z, dy, dz_extra, gamma, p, scale, eps, seed=0,
                               offset=0, bits=None):
    """`_fbdrln_bwd_kernel` and the column sums of `_fbdrln_vjp_bwd` in
    plain PyTorch: (dx, dres, dbias, dgamma, dbeta). With gamma, the LN
    statistics come from the stored z (in z's dtype, widened) and dz =
    rstd (a - mean(a) - x^ mean(a x^)) with a = dy gamma; without (gamma
    None), dz = dy and dgamma = dbeta = None. dz_extra (or None: 0) is
    added; dres = dz and dx = dz under the forward's keep mask, both in
    z's dtype; dbias = the column sum of dx as stored, dgamma = sum dy x^,
    dbeta = sum dy, each [Hd] in z's dtype."""
    dyf = dy.float()
    if gamma is not None:
        zf = z.float()
        mean, rstd = _ln_stats(zf, eps)
        xhat = (zf - mean) * rstd
        a = dyf * gamma.float().reshape(-1)
        dz = rstd * (a - a.mean(-1, keepdim=True)
                     - xhat * (a * xhat).mean(-1, keepdim=True))
    else:
        dz = dyf
    if dz_extra is not None:
        dz = dz + dz_extra.float()
    dres = dz.to(z.dtype)
    dx = (_fdrln_drop(dz, p, scale, seed, offset, bits) if p > 0.0
          else dz).to(z.dtype)
    dbias = dx.float().sum(0).to(z.dtype)
    if gamma is None:
        return dx, dres, dbias, None, None
    return (dx, dres, dbias, (dyf * xhat).sum(0).to(z.dtype),
            dyf.sum(0).to(z.dtype))


def _fdrln_check(name, rows, vecs, p):
    """`rows`: [N, Hd] tensors, `vecs`: [Hd] vectors (None where absent);
    raises ValueError on anything the kernels do not take."""
    first = rows[0]
    _need(first.ndim == 2 and first.shape[0] >= 1
          and 1 <= first.shape[1] <= FDRLN_MAX_HD,
          "%s: rows must be [N, Hd] with 1 <= Hd <= %d, got %s"
          % (name, FDRLN_MAX_HD, tuple(first.shape)))
    Hd = first.shape[1]
    for t in rows:
        if t is not None:
            _need(t.shape == first.shape, "%s: row tensors of shapes %s and "
                  "%s" % (name, tuple(first.shape), tuple(t.shape)))
    for t in vecs:
        if t is not None:
            _need(t.numel() == Hd and t.shape[-1] == Hd,
                  "%s: vector of shape %s for Hd=%d" % (name, tuple(t.shape),
                                                        Hd))
    for t in rows + vecs:
        if t is None:
            continue
        _need(t.dtype in _DTYPE_CODE, "%s: float32 or bfloat16 tensors, got "
              "%s" % (name, t.dtype))
        _need(t.device == first.device, "%s: mixed devices" % name)
        _need(t.is_contiguous(), "%s: tensors must be contiguous" % name)
    _need(0.0 <= p <= 1.0, "%s: dropout p %r (0 <= p <= 1)" % (name, p))


def _bf16_bits(*ts):
    """Bit i set where tensor i is bfloat16: the kernels' dtype word."""
    return sum(1 << i for i, t in enumerate(ts)
               if t is not None and t.dtype == torch.bfloat16)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fdrln_fwd(x, residual, bias, gamma, beta, p, scale, eps, seed, offset):
    """The forward kernels, or their plain versions on CPU tensors: (y, z)
    with gamma, (None, z) without."""
    p = float(p)
    with_ln = gamma is not None
    name = "fused_dropout_ln_fwd" if with_ln else "fused_dropout_residual_fwd"
    _fdrln_check(name, [x, residual], [bias, gamma, beta], p)
    _need(with_ln == (beta is not None),
          "%s: gamma and beta come together" % name)
    if not _on_cuda(x, name):
        if with_ln:
            return fused_dropout_ln_fwd_plain(x, residual, bias, gamma, beta,
                                              p, scale, eps, seed, offset)
        return None, fused_dropout_residual_fwd_plain(x, residual, bias, p,
                                                      scale, seed, offset)
    N, Hd = x.shape
    z = torch.empty_like(x)
    y = torch.empty_like(x) if with_ln else None
    err = _build.load("fused_dropout_ln").fused_dropout_ln_fwd(
        x.data_ptr(), residual.data_ptr(), _ptr(bias), _ptr(gamma),
        _ptr(beta), _ptr(y), z.data_ptr(), N, Hd,
        _bf16_bits(x, residual, bias, gamma, beta), int(with_ln),
        int(p > 0.0), _threshold(p), float(scale), float(eps), int(seed),
        int(offset), _stream(x))
    _check_launch(err, name)
    _LAUNCHES[name] += 1
    return y, z


def fused_dropout_ln_fwd(x, residual, bias, gamma, beta, p, scale, eps,
                         seed=0, offset=0):
    """Row 4's kernel: (y, z) for x, residual [N, Hd] (contiguous, each
    float32 or bfloat16), bias [Hd] or None, gamma and beta [Hd]; dropout
    at p from (seed, offset), kept values times `scale`. Inputs the kernel
    does not take raise ValueError on every device; CPU tensors then take
    the plain version."""
    return _fdrln_fwd(x, residual, bias, gamma, beta, p, scale, eps, seed,
                      offset)


def fused_dropout_residual_fwd(x, residual, bias, p, scale, seed=0,
                               offset=0):
    """Row 5's kernel: z = residual + dropout(x + bias), one output."""
    return _fdrln_fwd(x, residual, bias, None, None, p, scale, 0.0, seed,
                      offset)[1]


def fused_dropout_ln_bwd(z, dy, dz_extra, gamma, p, scale, eps, seed=0,
                         offset=0):
    """Row 6's kernel, with LN (gamma given) or without: (dx, dres, dbias,
    dgamma, dbeta) as `fused_dropout_ln_bwd_plain` computes them, dgamma
    and dbeta None without LN. dz_extra may be None (0). The kernel folds
    the column sums in as per-CTA partial rows, added here."""
    p = float(p)
    name = "fused_dropout_ln_bwd"
    _fdrln_check(name, [z, dy, dz_extra], [gamma], p)
    if not _on_cuda(z, name):
        return fused_dropout_ln_bwd_plain(z, dy, dz_extra, gamma, p, scale,
                                          eps, seed, offset)
    N, Hd = z.shape
    with_ln = gamma is not None
    dev = z.device
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    grid = min((N + 3) // 4, _FDRLN_BWD_CTAS_PER_SM * _SM_COUNT[dev])
    nacc = 3 if with_ln else 1
    dx, dres = torch.empty_like(z), torch.empty_like(z)
    part = torch.empty((grid, nacc, Hd), dtype=torch.float32, device=dev)
    err = _build.load("fused_dropout_ln").fused_dropout_ln_bwd(
        z.data_ptr(), dy.data_ptr(), _ptr(dz_extra), _ptr(gamma),
        dx.data_ptr(), dres.data_ptr(), part.data_ptr(), N, Hd, grid,
        _bf16_bits(z, dy, dz_extra, gamma), int(with_ln), int(p > 0.0),
        _threshold(p), float(scale), float(eps), int(seed), int(offset),
        _stream(z))
    _check_launch(err, name)
    _LAUNCHES[name] += 1
    sums = part.sum(0).to(z.dtype)
    if not with_ln:
        return dx, dres, sums[0], None, None
    return dx, dres, sums[0], sums[1], sums[2]


class FusedDropoutResidualLNFunction(torch.autograd.Function):
    """z = residual + dropout(x + bias) and, with gamma, y = LN(z) over the
    last axis, with its backward (the counterpart of the custom vjp
    `_fbdrln_pair` :943-951 with `defvjp` :954). With gamma it returns
    (y, z), so both cotangents reach the backward (dy, and dz_extra for z:
    the residual stream); without it returns z alone, whose one cotangent
    holds both of the reference's (there y is z). It saves z and the
    call's (seed, offset): the backward recomputes the LN statistics from
    the stored z and regenerates the mask. CPU tensors take the plain
    versions through the same Function."""

    @staticmethod
    def forward(ctx, x, residual, bias, gamma, beta, p, scale, eps, seed,
                offset):
        shape, Hd = x.shape, x.shape[-1]
        y, z = _fdrln_fwd(x.reshape(-1, Hd).contiguous(),
                          residual.reshape(-1, Hd).contiguous(), bias, gamma,
                          beta, p, scale, eps, seed, offset)
        ctx.save_for_backward(z, gamma)
        ctx.args = (p, scale, eps, seed, offset, shape, residual.shape,
                    None if bias is None else bias.shape)
        ctx.set_materialize_grads(False)
        if gamma is None:
            return z.reshape(shape)
        return y.reshape(shape), z.reshape(shape)

    @staticmethod
    def backward(ctx, dy, dz=None):
        z, gamma = ctx.saved_tensors
        p, scale, eps, seed, offset, shape, res_shape, bias_shape = ctx.args
        Hd = shape[-1]
        flat = lambda g: None if g is None else g.reshape(-1, Hd).contiguous()
        if dy is None:                  # only z's cotangent arrived
            dy = torch.zeros_like(z)
        dx, dres, dbias, dgamma, dbeta = fused_dropout_ln_bwd(
            z, flat(dy), flat(dz), gamma, p, scale, eps, seed, offset)
        need = ctx.needs_input_grad
        return (dx.reshape(shape), dres.reshape(res_shape),
                dbias.reshape(bias_shape) if need[2] else None,
                dgamma.reshape(gamma.shape) if need[3] else None,
                dbeta.reshape(gamma.shape) if need[4] else None,
                None, None, None, None, None)


DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


def fused_bias_dropout_residual_ln(x, residual, bias, gamma, beta, p, eps,
                                   training, mode):
    """The array-level entry (reference: pallas_kernels.py
    fused_bias_dropout_residual_ln_arrays :960): x, residual [..., Hd] ->
    (y, z) with z = residual + dropout(x + bias), y = LN(z); z alone when
    gamma is None. paddle's modes: upscale_in_train scales kept values by
    1 / (1 - p) in training (0 at p = 1); downscale_in_infer keeps them as
    they are in training and, in eval, multiplies x and bias by 1 - p.
    Eval runs the kernels at p = 0 and draws no seed, so the flash
    kernels' call offsets do not move."""
    _need(mode in DROPOUT_MODES, "dropout mode %r (one of %s)"
          % (mode, DROPOUT_MODES))
    p = float(p)
    _need(0.0 <= p <= 1.0, "fused dropout: p %r (0 <= p <= 1)" % (p,))
    if not training:
        p_eff, scale = 0.0, 1.0
        if mode == "downscale_in_infer":
            x = x * (1.0 - p)
            bias = None if bias is None else bias * (1.0 - p)
    else:
        p_eff = p
        if mode == "downscale_in_infer":
            scale = 1.0
        else:
            scale = float(np.float32(1.0 / (1.0 - p))) if p < 1.0 else 0.0
    seed, offset = next_seed_offset() if p_eff > 0.0 else (0, 0)
    return FusedDropoutResidualLNFunction.apply(
        x, residual, bias, gamma, beta, p_eff, scale, float(eps), seed,
        offset)


def fused_dropout_residual_ln_or_none(x, residual, bias, gamma, beta, p, eps,
                                      training, mode):
    """Gate of `fused_bias_dropout_residual` and
    `fused_bias_dropout_residual_layer_norm` (reference: pallas_kernels.py
    fused_ln_shapes_ok :1024): None when `use_fused_dropout_ln` is off (the
    caller runs the composed ops), else `fused_bias_dropout_residual_ln`'s
    output. The reference's gate also hands a shape the TPU cannot tile
    to the composed ops; this one raises ValueError on an input the
    kernels do not take."""
    if not flag("use_fused_dropout_ln"):
        return None
    return fused_bias_dropout_residual_ln(x, residual, bias, gamma, beta, p,
                                          eps, training, mode)


# ---------------------------------------------------------------------------
# Fused AdamW
#
# Replaces pallas_kernels.py `_adamw_kernel` (:1044, via
# `fused_adamw_or_none` :1067). Bound on the H100: bytes (22 per element
# for a bfloat16 parameter and gradient, 28 for float32). One pass, in
# place; one launch per parameter.


def _adam_scalars(lr, t, beta1, beta2, epsilon, coeff):
    """The update's scalars in float32, as the reference rounds them: lr
    and the betas as float32, 1 - beta in double then float32 (a weak-typed
    python float), decay = 1 - lr * coeff and the bias corrections
    c = 1 - beta^t in float32 on the host, as `fused_adamw_or_none` passes
    them (np.float32 power: equal to jnp.power at the t the tests take)."""
    f = np.float32
    lr32 = f(lr)
    return dict(lr=lr32, decay=f(1) - lr32 * f(coeff), b1=f(beta1),
                omb1=f(1 - beta1), b2=f(beta2), omb2=f(1 - beta2),
                eps=f(epsilon), c1=f(1) - f(beta1) ** f(t),
                c2=f(1) - f(beta2) ** f(t))


def adamw_plain(param, grad, m1, m2, lr, t, *, beta1, beta2, epsilon,
                coeff):
    """The update in plain PyTorch, in place on param, m1 and m2: the
    reference's jnp rule (optimizer Adam/AdamW `_update_rule`) line for
    line, each operation rounded on its own as the kernel rounds it."""
    sc = _adam_scalars(lr, t, beta1, beta2, epsilon, coeff)
    dev = param.device
    # tensor divisors, filled on the device: dividing by a python number,
    # torch may multiply by its reciprocal instead
    c1 = torch.full((), float(sc["c1"]), device=dev)
    c2 = torch.full((), float(sc["c2"]), device=dev)
    g = grad.float()
    p32 = param.float()
    if coeff:
        p32 = p32 * float(sc["decay"])
    m1n = float(sc["b1"]) * m1 + float(sc["omb1"]) * g
    m2n = float(sc["b2"]) * m2 + float(sc["omb2"]) * (g * g)
    step = float(sc["lr"]) * (m1n / c1) / (torch.sqrt(m2n / c2)
                                           + float(sc["eps"]))
    param.copy_(p32 - step)
    m1.copy_(m1n)
    m2.copy_(m2n)


def _adamw_check(param, grad, m1, m2):
    _need(param.dtype in _DTYPE_CODE and grad.dtype in _DTYPE_CODE,
          "adamw: param and grad must be float32 or bfloat16 (got %s, %s)"
          % (param.dtype, grad.dtype))
    for t in (grad, m1, m2):
        _need(t.shape == param.shape and t.device == param.device,
              "adamw: grad and moments must match the parameter's shape "
              "and device")
    _need(m1.dtype == torch.float32 and m2.dtype == torch.float32,
          "adamw: moments must be float32")
    for t in (param, grad, m1, m2):
        _need(t.is_contiguous(), "adamw: tensors must be contiguous")
    _need(param.numel() > 0, "adamw: empty parameter")


def adamw(param, grad, m1, m2, lr, t, *, beta1, beta2, epsilon, coeff):
    """The fused update kernel, in place on param, m1, m2 (plain version
    on CPU tensors). coeff 0 is Adam."""
    _adamw_check(param, grad, m1, m2)
    if not _on_cuda(param, "adamw"):
        return adamw_plain(param, grad, m1, m2, lr, t, beta1=beta1,
                           beta2=beta2, epsilon=epsilon, coeff=coeff)
    sc = _adam_scalars(lr, t, beta1, beta2, epsilon, coeff)
    err = _build.load("adamw").adamw(
        param.data_ptr(), grad.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        param.numel(), _DTYPE_CODE[param.dtype], _DTYPE_CODE[grad.dtype],
        float(sc["lr"]), float(sc["decay"]), int(bool(coeff)),
        float(sc["b1"]), float(sc["omb1"]), float(sc["b2"]),
        float(sc["omb2"]), float(sc["eps"]), float(sc["c1"]),
        float(sc["c2"]), _stream(param))
    _check_launch(err, "adamw")
    _LAUNCHES["adamw"] += 1


def fused_adamw_or_none(param, grad, lr, t, m1, m2, *, beta1, beta2,
                        epsilon, coeff):
    """Gate (reference: pallas_kernels.py fused_adamw_or_none :1067): None
    when `use_fused_optimizer` is off (the caller runs the plain rule),
    else the kernel's update, in place, returning (param, m1, m2). The
    kernel takes any numel, so the reference's rows-of-128 rule is not
    carried over; an input it does not take raises ValueError."""
    if not flag("use_fused_optimizer"):
        return None
    adamw(param, grad, m1, m2, lr, t, beta1=beta1, beta2=beta2,
          epsilon=epsilon, coeff=coeff)
    return param, m1, m2


# ---------------------------------------------------------------------------
# Paged decode
#
# Replaces pallas_kernels.py `_paged_f_kernel` (:1738) and
# `_paged_q_kernel` (:1746), both `_paged_core` (:1646), launched by
# `_paged_decode` (:1755). Bound on the H100: bytes — each live K/V row is
# read once per step; the kernel reads only rows 0..min(lens, T-1) and
# updates the cache in place (the reference returns new buffers).


def quantize_kv(x, eps=1e-8):
    """Symmetric absmax int8 quantization over the last (head_dim) axis
    (reference: inference/serving/cache.py quantize_kv).

    Returns (int8 values, float32 scales) with scales shaped like `x`
    minus its last axis. scale = max(absmax, eps) / 127 in float32, then
    x / scale with IEEE division, rounded half to even and clipped to
    +-127: bit for bit the reference's rule, which the paged-decode
    kernel's in-kernel append repeats."""
    amax = x.abs().amax(dim=-1).to(torch.float32)
    # divide by a tensor, not a python number: on CUDA, torch turns
    # division by a scalar into a multiplication by its reciprocal, which
    # can land one ulp away from the IEEE quotient
    scale = torch.clamp_min(amax, eps) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale[..., None]),
                    -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of `quantize_kv`: int8 values x per-token scales."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def paged_decode_plain(q, k_cache, v_cache, lens, new_k, new_v,
                       k_scale=None, v_scale=None):
    """One decode step in plain PyTorch, cache updated in place.

    q/new_k/new_v [B, H, 1, D]; caches [B, H, T, D] (int8 with float32
    scales [B, H, T] when k_scale is given); lens int [B], the live length
    before this token. Appends at min(lens, T-1), attends keys pos <= lens,
    returns out [B, H, 1, D] in q's dtype. Rows past lens are zeroed by
    select, never by multiplying, so a NaN tail cannot leak through 0*NaN.
    """
    B, H, _, D = q.shape
    T = k_cache.shape[2]
    dev = q.device
    quantized = k_scale is not None
    lens_l = lens.to(device=dev, dtype=torch.long)
    cl = torch.clamp(lens_l, max=T - 1)
    bidx = torch.arange(B, device=dev)
    if quantized:
        nkq, nks = quantize_kv(new_k[:, :, 0])
        nvq, nvs = quantize_kv(new_v[:, :, 0])
        k_cache[bidx, :, cl] = nkq
        v_cache[bidx, :, cl] = nvq
        k_scale[bidx, :, cl] = nks
        v_scale[bidx, :, cl] = nvs
    else:
        k_cache[bidx, :, cl] = new_k[:, :, 0].to(k_cache.dtype)
        v_cache[bidx, :, cl] = new_v[:, :, 0].to(v_cache.dtype)
    live = (torch.arange(T, device=dev)[None, :]
            <= lens_l[:, None])[:, None, :]                  # [B, 1, T]
    kf = k_cache.float()
    vf = v_cache.float()
    if quantized:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    kf = torch.where(live[..., None], kf, 0.0)
    vf = torch.where(live[..., None], vf, 0.0)
    s = torch.einsum("bhd,bhtd->bht", q[:, :, 0].float(), kf) * (
        float(D) ** -0.5)
    s = torch.where(live, s, _NEG_INF)
    p = torch.where(live, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bht,bhtd->bhd", p, vf)
    return out[:, :, None, :].to(q.dtype)


def _paged_check(q, k_cache, v_cache, lens, new_k, new_v, k_scale,
                 v_scale):
    """What the kernel takes; raises ValueError on anything else."""
    quantized = k_scale is not None
    _need(q.ndim == 4 and q.shape[2] == 1 and k_cache.ndim == 4,
          "paged_decode: q must be [B, H, 1, D] and the caches [B, H, T, D]")
    B, H, _, D = q.shape
    T = k_cache.shape[2]
    _need(tuple(k_cache.shape) == (B, H, T, D)
          and v_cache.shape == k_cache.shape, "paged_decode: cache shape")
    _need(1 <= D <= 128 and T <= _PAGED_MAX_T,
          "paged_decode: needs D <= 128 and T <= %d" % _PAGED_MAX_T)
    for t in (q, new_k, new_v):
        _need(t.dtype == torch.float32 and tuple(t.shape) == (B, H, 1, D)
              and t.stride(-1) == 1, "paged_decode: q/new_k/new_v must be "
              "float32 [B, H, 1, D] with unit head_dim stride")
    want = torch.int8 if quantized else torch.float32
    _need(k_cache.dtype == want and v_cache.dtype == want,
          "paged_decode: cache dtype %s (kernel takes float32, or int8 "
          "with scales)" % k_cache.dtype)
    _need(k_cache.is_contiguous() and v_cache.is_contiguous(),
          "paged_decode: caches must be contiguous")
    if quantized:
        for t in (k_scale, v_scale):
            _need(t is not None and t.dtype == torch.float32
                  and tuple(t.shape) == (B, H, T) and t.is_contiguous(),
                  "paged_decode: scales must be contiguous float32 "
                  "[B, H, T]")
    _need(lens.dtype == torch.int32 and tuple(lens.shape) == (B,)
          and lens.is_contiguous(), "paged_decode: lens must be int32 [B]")
    for t in (k_cache, v_cache, lens, new_k, new_v) + (
            (k_scale, v_scale) if quantized else ()):
        _need(t.device == q.device, "paged_decode: mixed devices")


def paged_decode(q, k_cache, v_cache, lens, new_k, new_v, k_scale=None,
                 v_scale=None):
    """The paged-decode kernel (in place on the caches). Inputs the kernel
    does not take raise ValueError on every device; CPU tensors then take
    the plain version. Returns out [B, H, 1, D] float32."""
    _paged_check(q, k_cache, v_cache, lens, new_k, new_v, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_cache, v_cache, lens, new_k, new_v,
                                  k_scale, v_scale)
    _need(q.device.type == "cuda", "paged_decode: tensors on %s" % q.device)
    quantized = k_scale is not None
    B, H, _, D = q.shape
    T = k_cache.shape[2]
    out = torch.empty((B, H, 1, D), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 6)(
        *(s for t in (q, new_k, new_v) for s in t.stride()[:2]))
    lib = _build.load("paged_decode")
    err = lib.paged_decode(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        ctypes.addressof(strides), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        lens.data_ptr(), out.data_ptr(), B, H, T, D,
        1.0 / math.sqrt(D), int(quantized), _stream(q))
    _check_launch(err, "paged_decode")
    _LAUNCHES["paged_decode_int8" if quantized else "paged_decode"] += 1
    return out


def paged_decode_attention_or_none(q, k_cache, v_cache, lens, new_k, new_v,
                                   k_scale=None, v_scale=None):
    """Gate (reference: pallas_kernels.py paged_decode_attention_or_none
    :1921): None when `paged_flash_decode` is off (the caller then runs the
    plain version), else the kernel's output with the cache updated in
    place. The kernel takes any cache depth T and head_dim D <= 128, so the
    reference's block rule (`_paged_block`) and its D % 8 rule are not
    carried over; an input the kernel does not take raises ValueError."""
    if not flag("paged_flash_decode"):
        return None
    out = paged_decode(q, k_cache, v_cache, lens, new_k, new_v, k_scale,
                       v_scale)
    _note_attn_path("paged_flash")
    return out
