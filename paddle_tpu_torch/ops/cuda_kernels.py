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
  * the dropout keep mask of `nn.functional.dropout` on CUDA tensors
    (`dropout_keep`, the fused kernels' Philox bits under a tag of its
    own), so that every draw of a train step reads the step's Philox word;
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
`paged_flash_decode`; `use_fused_dropout_ln` is read by the
incubate fused_transformer functions themselves), or where the reference's
gate does so for what the call computes rather than for what its kernel
takes: the flash gate on an additive mask or dropout p >= 1 (the
reference's Pallas kernel takes neither, and the composed XLA attention
runs such a call). The attention callers report the plain route in the
path counters (`xla_sdpa`, `xla_paged`).

The int8 KV rule (`quantize_kv` / `dequantize_kv`) lives here too: the
paged-decode kernel's in-kernel append must match it bit for bit, and the
serving cache imports it from this module.

The dropout kernels take their (seed, offset) from device memory: a
Philox word (int64 [seed, base offset], framework/random.py) and a
per-call delta, offset = base + delta, as the reference's kernels read
`rng_ref`; AdamW takes lr and the bias corrections from a float32 device
buffer, as `_adamw_kernel` reads `lr_ref` and `c_ref`. So a CUDA graph
that captured a train step draws new masks and applies each step's lr and
t on replay (jit/engine.py). The plain versions keep host (seed, offset)
and scalar arguments; on CPU tensors the wrappers read the word or the
buffer on the host and call them.

The training kernels take float32, bfloat16 and float16 tensors (their
16-bit routes one template instance a type: the float16 ones replace the
bfloat16 mma.sync with its .f16 form, and the flash backward scales dS by
a power of two a row for float16's range; csrc/flash_bwd.cu).

Launch counters (`launch_counts`) count kernel launches and nothing else;
a float16 instance counts under its kernel's name + F16 ("_f16").
Path counters (`attention_path_counts`) count which implementation the
gates chose, on any device, and feed `pt_attn_path_total{path}`.
"""
from __future__ import annotations

import ctypes
import math
import weakref

import numpy as np
import torch

from ..amp import amp_cast_inputs
from ..framework.dispatch import primitive
from ..framework.flags import flag
from ..framework.random import RNG
from ..observability import metrics
from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "flash_fwd_train",
           "flash_fwd_train_plain", "flash_f32_geometry", "flash_bwd_dq",
           "flash_bwd_dq_plain",
           "flash_bwd_dkv", "flash_bwd_dkv_plain", "FlashAttentionFunction",
           "attn_dropout_bits", "attn_dropout_bits_plain",
           "flash_attention_or_none", "fused_dropout_ln_fwd",
           "fused_dropout_ln_fwd_plain", "fused_dropout_residual_fwd",
           "fused_dropout_residual_fwd_plain", "fused_dropout_ln_bwd",
           "fused_dropout_ln_bwd_plain", "FusedDropoutResidualLNFunction",
           "fused_dropout_bits", "fused_dropout_bits_plain", "dropout_keep",
           "dropout_keep_plain",
           "fused_bias_dropout_residual_ln", "DROPOUT_MODES", "adamw",
           "adamw_multi", "adamw_plain", "adamw_plain_scalars",
           "adam_step_scalars", "fused_adamw_or_none",
           "fused_adamw_multi_or_none", "paged_decode", "paged_decode_plain",
           "paged_split_geometry", "paged_int8_geometry",
           "paged_workspace_numel", "paged_decode_attention_or_none",
           "quantize_kv", "dequantize_kv", "launch_counts", "launch_delta",
           "add_launches", "attention_path_counts"]

_NEG_INF = -1e30

# kernel launches, bumped by the wrappers right after a successful launch;
# a kernel's float16 instance counts under its name + F16 (`_count`)
F16 = "_f16"
_F16_KERNELS = ("flash_fwd", "flash_fwd_train", "flash_bwd_dq",
                "flash_bwd_dkv", "fused_dropout_ln_fwd",
                "fused_dropout_residual_fwd", "fused_dropout_ln_bwd", "adamw")
_LAUNCHES = {"flash_fwd": 0, "flash_fwd_train": 0, "flash_bwd_dq": 0,
             "flash_bwd_dkv": 0, "attn_dropout_bits": 0,
             "fused_dropout_ln_fwd": 0, "fused_dropout_residual_fwd": 0,
             "fused_dropout_ln_bwd": 0, "fused_dropout_bits": 0,
             "dropout_keep": 0, "adamw": 0, "paged_decode": 0,
             "paged_decode_int8": 0}
_LAUNCHES.update({k + F16: 0 for k in _F16_KERNELS})

# attention implementation chosen by the gates (reference:
# pallas_kernels.py _ATTN_PATHS / _note_attn_path)
_ATTN_PATHS = {"flash": 0, "flash_dropout": 0, "xla_sdpa": 0,
               "xla_chunked": 0, "paged_flash": 0, "xla_paged": 0}
_ATTN_COUNTER = metrics.counter(
    "pt_attn_path_total", "Attention implementations run, by path",
    labelnames=("path",))

def launch_counts(reset=False):
    out = dict(_LAUNCHES)
    if reset:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0
    return out


def launch_delta(before):
    """The launches counted since `before` (a `launch_counts()` reading),
    kernel by kernel."""
    return {k: n - before[k] for k, n in _LAUNCHES.items()}


def add_launches(delta, times=1):
    """Add `times` x `delta` to the launch counts. A CUDA graph counts the
    launches it captured once per replay this way, and takes back those
    its capture counted, which ran nothing (jit/cuda_graph.py)."""
    for k, n in delta.items():
        _LAUNCHES[k] += times * n


def _note_attn_path(path):
    _ATTN_PATHS[path] = _ATTN_PATHS.get(path, 0) + 1
    _ATTN_COUNTER.labels(path).inc()


def attention_path_counts(reset=False):
    out = dict(_ATTN_PATHS)
    if reset:
        for k in _ATTN_PATHS:
            _ATTN_PATHS[k] = 0
    return out


def _count(name, dtype):
    """One launch of kernel `name`'s instance for `dtype`."""
    _LAUNCHES[name + F16 if dtype == torch.float16 else name] += 1


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


# the kernels' dtype codes: float32 on the CUDA cores (the flash kernels)
# or in float32 arithmetic, the 16-bit types as template instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_WORDS = "float32, bfloat16 or float16"


def _word_check(word, like, name):
    """A call's Philox word: int64 [2] (seed, base offset) on `like`'s
    device."""
    _need(isinstance(word, torch.Tensor) and word.dtype == torch.int64
          and tuple(word.shape) == (2,) and word.device == like.device
          and word.is_contiguous(),
          "%s: dropout needs the Philox word, an int64 [2] tensor on %s "
          "(framework.random)" % (name, like.device))


def _key(word, delta):
    """(seed, offset) of a draw, read from a word on the CPU: the host
    numbers the plain versions take."""
    seed, base = (int(v) for v in word.tolist())
    return seed % 2 ** 64, (base + int(delta)) % 2 ** 32


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


def attn_dropout_bits(word, delta, BH, Tq, Tk):
    """The dropout bits the flash kernels draw for the Philox word `word`
    and delta `delta` (the key (seed, base + delta)), written out by a
    small kernel on the word's device; the plain version on the CPU. Not
    on the main path: the checks hand these bits to the plain versions."""
    _word_check(word, word, "attn_dropout_bits")
    _need(0 <= int(delta) < 2 ** 32, "attn_dropout_bits: delta must fit 32 "
          "bits")
    if not _on_cuda(word, "attn_dropout_bits"):
        return attn_dropout_bits_plain(*_key(word, delta), BH, Tq, Tk)
    out = torch.empty((BH, Tq, Tk), dtype=torch.int32, device=word.device)
    err = _build.load("flash_fwd").attn_dropout_bits(
        out.data_ptr(), word.data_ptr(), int(delta), BH, Tq, Tk,
        _stream(out))
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
# :412). bfloat16 and float16 inputs (every training path, under O2 or
# auto_cast, and 16-bit prefill) run on the tensor cores: mma.sync on the
# 16-bit type with float32 sums, S and P kept in registers, P rounded once
# to the 16-bit type for the P V product.
# float32 inputs (the serving path's float32 cache) run on the CUDA cores
# in full float32, each CTA's causal key range dealt out to its warps in
# tiles (`flash_f32_geometry`), the warps' softmax states combined at the
# end. Bound on the H100: at the serving prefill shapes (B=1, H=12,
# T<=256, D=64) a few microseconds, so the kernel is latency-bound; at the
# training shapes (B=16, H=12, T=512, D=64, causal) bytes on paper, and in
# practice the dropout's Philox calls and mma.sync's share of the
# tensor-core peak. It keeps the [Tq, Tk] scores and the dropout mask on
# chip and skips the K/V tiles above the causal diagonal (see the
# source's note).

# the float32 kernel's query rows a CTA
_F32_ROWS = 16


def flash_f32_geometry(Tq, Tk, D, causal):
    """(warps, tile) of the float32 flash forward: a CTA of `warps` warps
    (8 up to D = 64, 4 past it) takes 16 query rows and deals their causal
    key range out to its warps in tiles of `tile` keys, tile t to warp
    t % warps. The tile is 8 keys where that covers a warp's share of the
    last query tile's range (the CTA with the most keys), so that short
    prompts keep every warp busy, else 16 (two CTAs an SM; tiles of 32
    were slower at T = 256 on the H100, PERF.md)."""
    warps = 8 if D <= 64 else 4
    kend = Tk
    if causal:
        kend = min(Tk, -(-Tq // _F32_ROWS) * _F32_ROWS + Tk - Tq)
    return warps, 8 if -(-kend // warps) <= 8 else 16


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
                          dropout_p=0.0, return_weights=False):
    """softmax(q k^T / sqrt(D) + attn_mask) v in float32, causal mask
    aligned bottom-right, returned in q's dtype (reference:
    pallas_kernels.py `_xla_attention`). With `keep` (bool, [B, H, Tq, Tk])
    the probabilities are dropped where keep is False and the rest scaled
    by 1 / (1 - dropout_p); at dropout_p >= 1 every probability is
    dropped and the output is zeros, as the reference's where(keep, w /
    (1 - p), 0) gives. With return_weights, (out, the dropped
    probabilities in q's dtype). The one dense attention body of the
    port: the kernels' CPU path, the plain sdpa route and the
    suffix-prefill attention all run it."""
    s = _scores(q, k, causal)
    if attn_mask is not None:
        s = s + attn_mask.float()
    w = torch.softmax(s, dim=-1)
    if keep is not None:
        w = (torch.where(keep, w * _drop_args(dropout_p)[1], 0.0)
             if dropout_p < 1.0 else torch.zeros_like(w))
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
    return (out, w.to(q.dtype)) if return_weights else out


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
          "flash_attention: unsupported input %s %s %s causal=%s (float32, "
          "bfloat16 or float16, [B,H,T,D] with D<=128, Tk>=Tq when causal)"
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


def _flash_fwd(q, k, v, causal, dropout_p, word, delta, need_lse):
    """The forward kernel, or its plain version on CPU tensors; counts a
    launch as flash_fwd_train when it writes lse or drops, else as
    flash_fwd. Returns (out, lse or None)."""
    _flash_check(q, k, v, causal, dropout_p)
    if dropout_p > 0.0:
        _word_check(word, q, "flash_attention")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if not _on_cuda(q, "flash_attention"):
        bits = (attn_dropout_bits_plain(*_key(word, delta), B * H, Tq, Tk)
                if dropout_p > 0.0 else None)
        out, lse = flash_fwd_train_plain(q, k, v, causal, dropout_p, bits)
        return out, (lse if need_lse else None)
    o = _bhtd_empty(B, H, Tq, D, q)
    lse = (torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    thr, scale = _drop_args(dropout_p)
    lib = _build.load("flash_fwd")
    strides = _strides(q, k, v, o)
    warps, tile = (flash_f32_geometry(Tq, Tk, D, causal)
                   if q.dtype == torch.float32 else (0, 0))
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if need_lse else None, ctypes.addressof(strides),
        B, H, Tq, Tk, D, int(bool(causal)), float(D) ** -0.5,
        _DTYPE_CODE[q.dtype], warps, tile, int(dropout_p > 0.0), thr,
        scale, _ptr(word) if dropout_p > 0.0 else None, int(delta),
        _stream(q))
    name = "flash_fwd_train" if (need_lse or dropout_p > 0.0) else \
        "flash_fwd"
    _check_launch(err, name)
    _count(name, q.dtype)
    return o, lse


def flash_attention(q, k, v, causal):
    """Attention forward without lse or dropout (the serving prefill), q/k/v
    [B, H, T, D]; any strides with a unit head_dim stride. Inputs the
    kernel does not take raise ValueError on every device; CPU tensors
    then take the plain version."""
    return _flash_fwd(q, k, v, causal, 0.0, None, 0, False)[0]


def flash_fwd_train(q, k, v, causal, dropout_p=0.0, word=None, delta=0,
                    need_lse=True):
    """The training forward: (out, lse [B*H, Tq] float32 or None), with
    attention dropout at `dropout_p` drawn from the Philox word `word`
    (int64 [2] on q's device) and the call's `delta`."""
    return _flash_fwd(q, k, v, causal, float(dropout_p), word, delta,
                      need_lse)


# ---------------------------------------------------------------------------
# Flash-attention backward
#
# Replaces pallas_kernels.py `_flash_bwd_dq_kernel` (:462) and
# `_flash_bwd_dkv_kernel` (:524), launched by `_flash_bwd` (:589).
# bfloat16 and float16 inputs (every training path, under O2 or auto_cast)
# run on the tensor cores: mma.sync on the 16-bit type with float32 sums,
# M o p and dS kept in registers as hi + lo operand pairs of that type
# (float16's dS scaled a row by a power of two, undone in the float32
# sums, so that a loss-scaled dS stays finite where the reference's
# float32 one does). At the training shapes
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


def _bwd_check(q, k, v, rows, lse, causal, dropout_p, word):
    """`rows`: the [B, H, Tq, D] tensors beside q (o, dO)."""
    _flash_check(q, k, v, causal, dropout_p)
    if dropout_p > 0.0:
        _word_check(word, q, "flash backward")
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


def _bwd_launch(fn, name, ptrs, q, k, causal, dropout_p, word, delta,
                strides):
    B, H, Tq, D = q.shape
    thr, scale = _drop_args(dropout_p)
    err = getattr(_build.load("flash_bwd"), fn)(
        *ptrs, ctypes.addressof(strides), B, H, Tq, k.shape[2], D,
        int(bool(causal)), float(D) ** -0.5, _DTYPE_CODE[q.dtype],
        int(dropout_p > 0.0), thr, scale,
        _ptr(word) if dropout_p > 0.0 else None, int(delta), _stream(q))
    _check_launch(err, name)
    _count(name, q.dtype)


def flash_bwd_dq(q, k, v, o, do, lse, causal, dropout_p=0.0, word=None,
                 delta=0):
    """dq kernel: (dq, Delta). Dropout bits are regenerated from the word
    and delta, which must be the forward's (the word's base unmoved)."""
    dropout_p = float(dropout_p)
    _bwd_check(q, k, v, (o, do), (lse,), causal, dropout_p, word)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if not _on_cuda(q, "flash_bwd_dq"):
        bits = (attn_dropout_bits_plain(*_key(word, delta), B * H, Tq, Tk)
                if dropout_p > 0.0 else None)
        return flash_bwd_dq_plain(q, k, v, o, do, lse, causal, dropout_p,
                                  bits)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dsum = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    _bwd_launch("flash_bwd_dq", "flash_bwd_dq",
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                 dsum.data_ptr()), q, k, causal, dropout_p, word, delta,
                _strides(q, k, v, o, do, dq, None, None))
    return dq, dsum


def flash_bwd_dkv(q, k, v, do, lse, dsum, causal, dropout_p=0.0, word=None,
                  delta=0):
    """dk/dv kernel: (dk, dv); `dsum` is Delta from flash_bwd_dq, `word`
    and `delta` the forward's dropout draw."""
    dropout_p = float(dropout_p)
    _bwd_check(q, k, v, (do,), (lse, dsum), causal, dropout_p, word)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if not _on_cuda(q, "flash_bwd_dkv"):
        bits = (attn_dropout_bits_plain(*_key(word, delta), B * H, Tq, Tk)
                if dropout_p > 0.0 else None)
        return flash_bwd_dkv_plain(q, k, v, do, lse, dsum, causal,
                                   dropout_p, bits)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _bwd_launch("flash_bwd_dkv", "flash_bwd_dkv",
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(),
                 dv.data_ptr()), q, k, causal, dropout_p, word, delta,
                _strides(q, k, v, None, do, None, dk, dv))
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its backward (the counterpart of the custom vjp
    `_flash` :675 with `defvjp` :703). The forward runs the forward
    kernel, writing lse only when an input needs a gradient; the backward
    runs the dq and dk/dv kernels with the forward's dropout draw (the
    Philox word and delta: the word's base moves only between train steps,
    so the backward regenerates the forward's mask). CPU tensors take the
    plain versions through the same Function, so the graph is the same on
    every device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, dropout_p, word, delta):
        need_lse = any(ctx.needs_input_grad[:3])
        o, lse = flash_fwd_train(q, k, v, causal, dropout_p, word, delta,
                                 need_lse)
        if need_lse:
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.args = (causal, dropout_p, word, delta)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, dropout_p, word, delta = ctx.args
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dsum = flash_bwd_dq(q, k, v, o, do, lse, causal, dropout_p,
                                word, delta)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, dsum, causal, dropout_p,
                               word, delta)
        return dq, dk, dv, None, None, None, None


def flash_attention_or_none(query, key, value, attn_mask, is_causal,
                            dropout_p=0.0):
    """Gate (reference: pallas_kernels.py flash_attention_or_none :1534):
    None, so that the caller runs the plain version (path xla_sdpa), when
    `use_flash_attention` is off, and where the reference's gate returns
    None for what the call computes: an additive mask (the reference's
    kernel takes none; its masked attention is composed XLA ops) and
    dropout p >= 1 (everything dropped; the reference's XLA path returns
    zeros). Else the output of `FlashAttentionFunction`, with attention
    dropout at `dropout_p` drawn in the kernel (path counter
    flash_dropout) or without (flash). An input the kernel does not take
    (shape, dtype, device) raises ValueError: unlike the reference's gate,
    this one never hands such a call to the plain version. Under
    amp.auto_cast this is the op flash_attention (white list): q, k and v
    enter in the amp dtype."""
    dropout_p = float(dropout_p)
    if (not flag("use_flash_attention") or attn_mask is not None
            or dropout_p >= 1.0):
        return None
    return _flash_op(query, key, value, None, causal=bool(is_causal),
                     dropout_p=dropout_p)


@primitive("flash_attention", out_like=0)
def _flash_op(q, k, v, rng=None, causal=False, dropout_p=0.0,
              interpret=False, block_q=None, block_k=None):
    """The op flash_attention (reference: pallas_kernels.py :724 `_flash_op`,
    q, k, v [B, H, T, D] and a PRNG key): `FlashAttentionFunction` with
    attention dropout at `dropout_p` drawn in the kernel from the Philox
    word (a fresh draw at every call, in a program at every run). The
    reference's key input and its Pallas attrs (interpret, block_q,
    block_k) are taken and ignored."""
    dropout_p = float(dropout_p)
    q, k, v = amp_cast_inputs("flash_attention", [q, k, v])
    word, delta = (RNG.draw(q.device) if dropout_p > 0.0 else (None, 0))
    out = FlashAttentionFunction.apply(q, k, v, bool(causal), dropout_p,
                                       word, delta)
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
# the saved Philox word and delta. The plain versions take the bits as an
# int64 tensor [N, Hd] holding values in [0, 2^32), or draw the kernels'
# own for a host (seed, offset).

_FDRLN_TAG = 0xFD1D0000
# counter word 2 of `dropout_keep`'s bits: apart from the fused kernels'
# and above any batch*head index of the attention bits
_KEEP_TAG = 0xD0E00000
# the forward kernel with LN keeps 4 float32 values per column in shared
# memory
FDRLN_MAX_HD = 8192
# the backward kernel's CTAs an SM: its launch bounds hold one (with LN a
# thread takes up to 255 registers); each CTA writes one partial row
_FDRLN_BWD_CTAS_PER_SM = 1
_SM_COUNT = {}


def fused_dropout_bits_plain(seed, offset, N, Hd, device="cpu",
                             tag=_FDRLN_TAG):
    """The fused kernels' dropout bits, [N, Hd] int64 in [0, 2^32) (with
    `tag` _KEEP_TAG: `dropout_keep`'s)."""
    G = (N + 3) // 4
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    shape = (G, Hd)
    full = lambda v: torch.full(shape, int(v), dtype=torch.int64,
                                device=device)
    words = _philox4x32_10(
        ar(Hd).view(1, Hd).expand(shape), ar(G).view(G, 1).expand(shape),
        full(tag), full(offset), int(seed) & _U32, (int(seed) >> 32) & _U32)
    bits = torch.stack(words, dim=1).reshape(4 * G, Hd)
    return bits[:N].contiguous()


def fused_dropout_bits(word, delta, N, Hd):
    """The dropout bits the fused kernels draw for the Philox word `word`
    and delta `delta`, written out by a small kernel on the word's device;
    the plain version on the CPU. Not on the main path: the checks hand
    these bits to the plain versions."""
    _word_check(word, word, "fused_dropout_bits")
    _need(0 <= int(delta) < 2 ** 32, "fused_dropout_bits: delta must fit "
          "32 bits")
    if not _on_cuda(word, "fused_dropout_bits"):
        return fused_dropout_bits_plain(*_key(word, delta), N, Hd)
    out = torch.empty((N, Hd), dtype=torch.int32, device=word.device)
    err = _build.load("fused_dropout_ln").fused_dropout_bits(
        out.data_ptr(), word.data_ptr(), int(delta), 0, N, Hd, 0, 0,
        _stream(out))
    _check_launch(err, "fused_dropout_bits")
    _LAUNCHES["fused_dropout_bits"] += 1
    return out.to(torch.int64) & _U32


def dropout_keep_plain(seed, offset, shape, p, device="cpu"):
    """`dropout_keep`'s mask in plain PyTorch: bool `shape`, the bits of
    (seed, offset) under _KEEP_TAG (the rows the leading axes flattened,
    the columns the last axis) >= floor(p * 2^32)."""
    shape = tuple(shape)
    n = int(np.prod(shape[:-1], dtype=np.int64))
    bits = fused_dropout_bits_plain(seed, offset, n, shape[-1], device,
                                    _KEEP_TAG)
    return (bits >= _threshold(p)).reshape(shape)


def dropout_keep(word, delta, shape, p):
    """The keep mask of a dropout at p, bool `shape` on the word's
    device, drawn by the Philox bits kernel of fused_dropout_ln.cu under a
    tag of its own from the Philox word and delta: keep iff bits >=
    floor(p * 2^32), the fused kernels' rule. Bound on the H100: the
    Philox calls (one per 4 elements, ~60-90 integer instructions each)
    against one byte written an element; a lane takes 4 columns of a
    4-row group and splits its index in 32 bits (fused_dropout_ln.cu
    `fdrln_bits_kernel`). The plain version on the CPU."""
    shape = tuple(int(x) for x in shape)
    _word_check(word, word, "dropout_keep")
    _need(len(shape) >= 1 and all(x >= 1 for x in shape)
          and 0.0 <= float(p) <= 1.0,
          "dropout_keep: shape %s, p %r" % (shape, p))
    if not _on_cuda(word, "dropout_keep"):
        return dropout_keep_plain(*_key(word, delta), shape, p)
    h = shape[-1]
    n = int(np.prod(shape[:-1], dtype=np.int64))
    _need(n < 2 ** 31 and h < 2 ** 31, "dropout_keep: shape %s" % (shape,))
    out = torch.empty(shape, dtype=torch.bool, device=word.device)
    err = _build.load("fused_dropout_ln").fused_dropout_bits(
        out.data_ptr(), word.data_ptr(), int(delta), _KEEP_TAG, n, h,
        _threshold(p), 1, _stream(out))
    _check_launch(err, "dropout_keep")
    _LAUNCHES["dropout_keep"] += 1
    return out


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
        _need(t.dtype in _DTYPE_CODE, "%s: %s tensors, got %s"
              % (name, _DTYPE_WORDS, t.dtype))
        _need(t.device == first.device, "%s: mixed devices" % name)
        _need(t.is_contiguous(), "%s: tensors must be contiguous" % name)
    low = {t.dtype for t in rows + vecs
           if t is not None and t.dtype != torch.float32}
    _need(len(low) <= 1, "%s: one 16-bit type a call (the kernels' "
          "instances pair float32 with bfloat16 or with float16), got %s"
          % (name, sorted(str(d) for d in low)))
    _need(0.0 <= p <= 1.0, "%s: dropout p %r (0 <= p <= 1)" % (name, p))


def _dtype_codes(*ts):
    """The kernels' dtype word: tensor i's `_DTYPE_CODE` in bits 2i and
    2i + 1 (an absent tensor 0)."""
    return sum(_DTYPE_CODE[t.dtype] << (2 * i) for i, t in enumerate(ts)
               if t is not None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fdrln_fwd(x, residual, bias, gamma, beta, p, scale, eps, word, delta):
    """The forward kernels, or their plain versions on CPU tensors: (y, z)
    with gamma, (None, z) without."""
    p = float(p)
    with_ln = gamma is not None
    name = "fused_dropout_ln_fwd" if with_ln else "fused_dropout_residual_fwd"
    _fdrln_check(name, [x, residual], [bias, gamma, beta], p)
    _need(with_ln == (beta is not None),
          "%s: gamma and beta come together" % name)
    if p > 0.0:
        _word_check(word, x, name)
    if not _on_cuda(x, name):
        seed, offset = _key(word, delta) if p > 0.0 else (0, 0)
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
        _dtype_codes(x, residual, bias, gamma, beta), int(with_ln),
        int(p > 0.0), _threshold(p), float(scale), float(eps),
        _ptr(word) if p > 0.0 else None, int(delta), _stream(x))
    _check_launch(err, name)
    _count(name, x.dtype)
    return y, z


def fused_dropout_ln_fwd(x, residual, bias, gamma, beta, p, scale, eps,
                         word=None, delta=0):
    """Row 4's kernel: (y, z) for x, residual [N, Hd] (contiguous, each float32
    or the call's one 16-bit type), bias [Hd] or None, gamma and beta [Hd];
    dropout at p from the Philox word `word` and delta `delta`, kept values
    times `scale`. Inputs the kernel does not take raise ValueError on every
    device; CPU tensors then take the plain version."""
    return _fdrln_fwd(x, residual, bias, gamma, beta, p, scale, eps, word,
                      delta)


def fused_dropout_residual_fwd(x, residual, bias, p, scale, word=None,
                               delta=0):
    """Row 5's kernel: z = residual + dropout(x + bias), one output."""
    return _fdrln_fwd(x, residual, bias, None, None, p, scale, 0.0, word,
                      delta)[1]


def _fdrln_bwd_grid(N, device):
    """The backward kernel's CTAs along N rows: one an SM, at most one per
    4-row group."""
    dev = torch.device(device)
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return min((N + 3) // 4, _FDRLN_BWD_CTAS_PER_SM * _SM_COUNT[dev])


def fused_dropout_ln_bwd(z, dy, dz_extra, gamma, p, scale, eps, word=None,
                         delta=0):
    """Row 6's kernel, with LN (gamma given) or without: (dx, dres, dbias,
    dgamma, dbeta) as `fused_dropout_ln_bwd_plain` computes them, dgamma
    and dbeta None without LN. dz_extra may be None (0). The kernel folds
    the column sums in as per-CTA partial rows (one CTA an SM), which a
    second small kernel of the same call adds."""
    p = float(p)
    name = "fused_dropout_ln_bwd"
    _fdrln_check(name, [z, dy, dz_extra], [gamma], p)
    if p > 0.0:
        _word_check(word, z, name)
    if not _on_cuda(z, name):
        seed, offset = _key(word, delta) if p > 0.0 else (0, 0)
        return fused_dropout_ln_bwd_plain(z, dy, dz_extra, gamma, p, scale,
                                          eps, seed, offset)
    N, Hd = z.shape
    with_ln = gamma is not None
    dev = z.device
    grid = _fdrln_bwd_grid(N, dev)
    nacc = 3 if with_ln else 1
    dx, dres = torch.empty_like(z), torch.empty_like(z)
    part = torch.empty((grid, nacc, Hd), dtype=torch.float32, device=dev)
    sums = torch.empty((nacc, Hd), dtype=z.dtype, device=dev)
    err = _build.load("fused_dropout_ln").fused_dropout_ln_bwd(
        z.data_ptr(), dy.data_ptr(), _ptr(dz_extra), _ptr(gamma),
        dx.data_ptr(), dres.data_ptr(), part.data_ptr(), sums.data_ptr(), N,
        Hd, grid, _dtype_codes(z, dy, dz_extra, gamma), int(with_ln),
        int(p > 0.0), _threshold(p), float(scale), float(eps),
        _ptr(word) if p > 0.0 else None, int(delta), _stream(z))
    _check_launch(err, name)
    _count(name, z.dtype)
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
    call's dropout draw (the Philox word and delta): the backward
    recomputes the LN statistics from the stored z and regenerates the
    mask. CPU tensors take the plain versions through the same Function."""

    @staticmethod
    def forward(ctx, x, residual, bias, gamma, beta, p, scale, eps, word,
                delta):
        shape, Hd = x.shape, x.shape[-1]
        y, z = _fdrln_fwd(x.reshape(-1, Hd).contiguous(),
                          residual.reshape(-1, Hd).contiguous(), bias, gamma,
                          beta, p, scale, eps, word, delta)
        ctx.save_for_backward(z, gamma)
        ctx.args = (p, scale, eps, word, delta, shape, residual.shape,
                    None if bias is None else bias.shape)
        ctx.set_materialize_grads(False)
        if gamma is None:
            return z.reshape(shape)
        return y.reshape(shape), z.reshape(shape)

    @staticmethod
    def backward(ctx, dy, dz=None):
        z, gamma = ctx.saved_tensors
        p, scale, eps, word, delta, shape, res_shape, bias_shape = ctx.args
        Hd = shape[-1]
        flat = lambda g: None if g is None else g.reshape(-1, Hd).contiguous()
        if dy is None:                  # only z's cotangent arrived
            dy = torch.zeros_like(z)
        dx, dres, dbias, dgamma, dbeta = fused_dropout_ln_bwd(
            z, flat(dy), flat(dz), gamma, p, scale, eps, word, delta)
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
    Eval runs the kernels at p = 0 and draws nothing, so the call offsets
    do not move."""
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
    word, delta = RNG.draw(x.device) if p_eff > 0.0 else (None, 0)
    return FusedDropoutResidualLNFunction.apply(
        x, residual, bias, gamma, beta, p_eff, scale, float(eps), word,
        delta)


# ---------------------------------------------------------------------------
# Fused AdamW
#
# Replaces pallas_kernels.py `_adamw_kernel` (:1044, via `fused_adamw_or_none`
# :1067). Bound on the H100: bytes (22 per element for a bfloat16 or float16
# parameter and gradient, 28 for float32). One pass, in place; one launch a
# step for all the parameters of one (parameter dtype, gradient dtype) pair
# (`adamw_multi`; the per-tensor `adamw` is its list of one). lr and the bias
# corrections c1 = 1 - beta1^t, c2 = 1 - beta2^t change every step, so the
# kernel reads them from a float32 device buffer [lr, c1, c2, go, scale]
# (`adam_step_scalars`, filled by the optimizer once a step), as
# `_adamw_kernel` reads its SMEM refs. `go` is the non-finite guard's word
# (`Optimizer.gate_update`): staged 1 by the host, set to 0 on the device by a
# guarded train step whose loss or gradients are not finite, and then the
# update writes nothing. `scale` is ClipGradByGlobalNorm's: staged 1, written
# on the device by a clipped step; an update made with scaled=True takes g =
# float(grad) * scale, one float32 rounding, the reference's product of a
# gradient and its float32 0-d scale. A buffer of 4 words serves an update that
# is not scaled.
GO = 3                          # the guard word's index in the buffer
SCALE = 4                       # the clip scale's index


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


def adam_step_scalars(lr, t, beta1, beta2):
    """The step's values of the scalar buffer, float32 [lr, c1, c2, go,
    scale] as `_adam_scalars` rounds them, with the guard's word go = 1
    (the update applies) and the clip scale 1."""
    sc = _adam_scalars(lr, t, beta1, beta2, 0.0, 0.0)
    return np.array([sc["lr"], sc["c1"], sc["c2"], 1.0, 1.0],
                    dtype=np.float32)


def _adamw_rule(param, grad, m1, m2, lr, c1, c2, decay, sc, go=None,
                scale=None):
    """The reference's jnp rule (optimizer Adam/AdamW `_update_rule`) line
    for line, in place, each operation rounded on its own as the kernel
    rounds it; lr, c1, c2 and decay (None: no decay) are float32 values,
    host numbers or 0-d tensors, c1 and c2 tensors (dividing by a python
    number, torch may multiply by its reciprocal instead). `go` (a 0-d
    bool tensor, or None for always): where it is False, param, m1 and m2
    keep their values, as the kernel writes nothing at go = 0. `scale` (a
    0-d float32 tensor, or None): the gradient is float(grad) * scale."""
    g = grad.float()
    if scale is not None:
        g = g * scale
    p32 = param.float()
    if decay is not None:
        p32 = p32 * decay
    m1n = float(sc["b1"]) * m1 + float(sc["omb1"]) * g
    m2n = float(sc["b2"]) * m2 + float(sc["omb2"]) * (g * g)
    step = lr * (m1n / c1) / (torch.sqrt(m2n / c2) + float(sc["eps"]))
    new = p32 - step
    if go is not None:
        new = torch.where(go, new, param.float())
        m1n = torch.where(go, m1n, m1)
        m2n = torch.where(go, m2n, m2)
    param.copy_(new)
    m1.copy_(m1n)
    m2.copy_(m2n)


def adamw_plain(param, grad, m1, m2, lr, t, *, beta1, beta2, epsilon,
                coeff):
    """The update in plain PyTorch, in place on param, m1 and m2, from
    host lr and step t."""
    sc = _adam_scalars(lr, t, beta1, beta2, epsilon, coeff)
    dev = param.device
    c1 = torch.full((), float(sc["c1"]), device=dev)
    c2 = torch.full((), float(sc["c2"]), device=dev)
    _adamw_rule(param, grad, m1, m2, float(sc["lr"]), c1, c2,
                float(sc["decay"]) if coeff else None, sc)


def adamw_plain_scalars(param, grad, m1, m2, scalars, *, beta1, beta2,
                        epsilon, coeff, scaled=False):
    """The same update with lr, c1 and c2 read from the scalar buffer
    `scalars` (float32 [4] or [5] on param's device) on the device, 1 - lr
    * coeff formed there in float32: equal to `adamw_plain` at the
    buffer's lr and t bit for bit; where the buffer's guard word is 0,
    param and the moments keep their values, as in the kernel; with
    `scaled`, the gradient times the buffer's clip scale. The optimizer's
    route with use_fused_optimizer off, so that a captured plain step also
    advances."""
    _scalars_check(scalars, param, scaled)
    sc = _adam_scalars(0.0, 1, beta1, beta2, epsilon, 0.0)
    lr, c1, c2 = scalars[0], scalars[1], scalars[2]
    decay = (1.0 - lr * float(np.float32(coeff))) if coeff else None
    _adamw_rule(param, grad, m1, m2, lr, c1, c2, decay, sc,
                go=scalars[GO] != 0,
                scale=scalars[SCALE] if scaled else None)


def _scalars_check(scalars, param, scaled=False):
    _need(isinstance(scalars, torch.Tensor)
          and scalars.dtype == torch.float32 and scalars.dim() == 1
          and scalars.numel() in ((5,) if scaled else (4, 5))
          and scalars.device == param.device and scalars.is_contiguous(),
          "adamw: the step's scalars must be a float32 [4] tensor (lr, c1, "
          "c2, go), or [5] with the clip scale (needed when scaled), on the "
          "parameter's device")


def _adamw_check(param, grad, m1, m2, device=None):
    _need(param.dtype in _DTYPE_CODE and grad.dtype in _DTYPE_CODE,
          "adamw: param and grad must be %s (got %s, %s)"
          % (_DTYPE_WORDS, param.dtype, grad.dtype))
    dev = param.device if device is None else device
    for t in (param, grad, m1, m2):
        _need(t.shape == param.shape and t.device == dev,
              "adamw: grad and moments must match the parameter's shape, "
              "and every tensor must lie on %s" % dev)
    _need(m1.dtype == torch.float32 and m2.dtype == torch.float32,
          "adamw: moments must be float32")
    for t in (param, grad, m1, m2):
        _need(t.is_contiguous(), "adamw: tensors must be contiguous")
    _need(param.numel() > 0, "adamw: empty parameter")


def _per_tensor(value, n, name):
    """A per-tensor attribute as a list of n: one value for all, or a
    sequence of n."""
    if isinstance(value, (list, tuple)):
        _need(len(value) == n, "adamw: %d %s for %d tensors"
              % (len(value), name, n))
        return list(value)
    return [value] * n


# the kernel's table (csrc/adamw.cu `Table`): its layout, read once from
# the library, and the tables of recent launches, keyed by their tensors'
# data pointers and attributes (an eager step over the same tensors packs
# nothing; a captured one never calls here again)
_TABLE_FIELDS = {"p": np.uint64, "g": np.uint64, "m1": np.uint64,
                 "m2": np.uint64, "n": np.int64, "coeff": np.float32,
                 "lrf": np.float32, "chunk0": np.int32, "flags": np.uint8}
_ADAMW_LAYOUT = []
_ADAMW_PLANS = {}
_ADAMW_PLANS_MAX = 8
_SCALED, _VEC = 1, 2


def _adamw_layout():
    """(bytes, capacity, chunk, {field: offset}) of the kernel's table."""
    if not _ADAMW_LAYOUT:
        out = (ctypes.c_longlong * 12)()
        _build.load("adamw").adamw_table_layout(ctypes.addressof(out))
        _ADAMW_LAYOUT.append((out[0], out[1], out[2],
                              dict(zip(_TABLE_FIELDS, out[3:12]))))
    return _ADAMW_LAYOUT[0]


def _adamw_table(ptrs, ns, coeffs, lrfs, flags):
    """One launch's packed table (uint8 numpy) for the tensors whose
    pointers (param, grad, m1, m2 of each), sizes, coeffs, lr factors and
    flags are given, with the chunk prefixes of their sizes."""
    size, _, chunk, off = _adamw_layout()
    ptrs = np.asarray(ptrs, dtype=np.uint64).reshape(len(ns), 4)
    prefix = np.zeros(len(ns) + 1, np.int64)
    np.cumsum((np.asarray(ns, np.int64) + chunk - 1) // chunk,
              out=prefix[1:])
    _need(prefix[-1] < 2 ** 31, "adamw: %d elements in one launch"
          % sum(ns))
    values = dict(p=ptrs[:, 0], g=ptrs[:, 1], m1=ptrs[:, 2], m2=ptrs[:, 3],
                  n=ns, coeff=coeffs, lrf=lrfs, chunk0=prefix, flags=flags)
    buf = np.zeros(size, np.uint8)
    for field, dtype in _TABLE_FIELDS.items():
        a = np.ascontiguousarray(values[field], dtype=dtype)
        buf[off[field]:off[field] + a.nbytes] = a.view(np.uint8)
    return buf


def _adamw_plan(params, grads, m1s, m2s, coeffs, scaled, lrfs):
    """The launches of one multi-tensor update on the card: a list of
    (table, count, ptype, gtype, dtype), one a (parameter dtype, gradient
    dtype) group, consecutive launches where a group outgrows the table.
    Checks every entry first (ValueError); a call over the same tensor
    objects at the same addresses and attributes reuses its plan."""
    tensors = params + grads + m1s + m2s
    ptrs = [t.data_ptr() for t in tensors]
    key = (tuple(ptrs), tuple(coeffs), tuple(scaled), tuple(lrfs))
    plan = _ADAMW_PLANS.get(key)
    if plan is not None and all(r() is t for r, t in zip(plan[0], tensors)):
        return plan[1]
    dev = params[0].device
    for p, g, a, b in zip(params, grads, m1s, m2s):
        _adamw_check(p, g, a, b, dev)
    _, cap, _, _ = _adamw_layout()
    n = len(params)
    groups = {}
    for i, (p, g) in enumerate(zip(params, grads)):
        groups.setdefault((p.dtype, g.dtype), []).append(i)
    launches = []
    for (pdt, gdt), idx in groups.items():
        for s in range(0, len(idx), cap):
            part = idx[s:s + cap]
            tptrs = [ptrs[j * n + i] for i in part for j in range(4)]
            flags = [(_SCALED if scaled[i] else 0)
                     | (_VEC if all(ptrs[j * n + i] % 16 == 0
                                    for j in range(4)) else 0)
                     for i in part]
            table = _adamw_table(
                tptrs, [params[i].numel() for i in part],
                [coeffs[i] for i in part], [lrfs[i] for i in part], flags)
            launches.append((table, len(part), _DTYPE_CODE[pdt],
                             _DTYPE_CODE[gdt], pdt))
    if len(_ADAMW_PLANS) >= _ADAMW_PLANS_MAX:
        _ADAMW_PLANS.pop(next(iter(_ADAMW_PLANS)), None)
    _ADAMW_PLANS[key] = ([weakref.ref(t) for t in tensors], launches)
    return launches


def adamw_multi(params, grads, m1s, m2s, scalars, *, beta1, beta2, epsilon,
                coeff, scaled=False, lr_factor=1.0):
    """The fused update over lists of tensors, in place on each parameter
    and both its moments, with the step's lr, c1 and c2 from `scalars`
    (float32 [4] or [5] on the parameters' device, `adam_step_scalars`;
    its guard word at 0: nothing written). `coeff` (AdamW's decoupled
    decay; 0 is Adam), `scaled` (each gradient element times the buffer's
    fifth word, the clip scale) and `lr_factor` (the tensor's lr is the
    buffer's lr times it, in float32) are one value for all tensors or a
    sequence of one a tensor. On the card one launch a (parameter dtype,
    gradient dtype) group, reading the tensor table as its parameter (a
    CUDA graph freezes it); on CPU tensors the plain version, tensor by
    tensor. Every entry is checked first (ValueError), so a bad one
    launches nothing."""
    params, grads, m1s, m2s = (list(x) for x in (params, grads, m1s, m2s))
    n = len(params)
    _need(n > 0 and len(grads) == n and len(m1s) == n and len(m2s) == n,
          "adamw: %d params, %d grads, %d and %d moments: equal, non-empty "
          "lists" % (n, len(grads), len(m1s), len(m2s)))
    coeffs = _per_tensor(coeff, n, "coeffs")
    scaled = _per_tensor(scaled, n, "scaled flags")
    lrfs = _per_tensor(lr_factor, n, "lr factors")
    _scalars_check(scalars, params[0], any(scaled))
    if not _on_cuda(params[0], "adamw"):
        dev = params[0].device
        for p, g, a, b in zip(params, grads, m1s, m2s):
            _adamw_check(p, g, a, b, dev)
        for p, g, a, b, c, s, f in zip(params, grads, m1s, m2s, coeffs,
                                       scaled, lrfs):
            sc = scalars if f == 1.0 else torch.cat(
                (scalars[:1] * float(f), scalars[1:]))
            adamw_plain_scalars(p, g, a, b, sc, beta1=beta1, beta2=beta2,
                                epsilon=epsilon, coeff=c, scaled=s)
        return
    launches = _adamw_plan(params, grads, m1s, m2s, coeffs, scaled, lrfs)
    hp = _adam_scalars(0.0, 1, beta1, beta2, epsilon, 0.0)
    lib = _build.load("adamw")
    stream = _stream(params[0])
    for table, count, ptype, gtype, dtype in launches:
        err = lib.adamw_multi(
            table.ctypes.data, count, ptype, gtype, scalars.data_ptr(),
            float(hp["b1"]), float(hp["omb1"]), float(hp["b2"]),
            float(hp["omb2"]), float(hp["eps"]), stream)
        _check_launch(err, "adamw")
        _count("adamw", dtype)


def adamw(param, grad, m1, m2, scalars, *, beta1, beta2, epsilon, coeff,
          scaled=False):
    """The fused update kernel on one parameter (`adamw_multi` over a list
    of one), in place on param, m1, m2, with the step's lr, c1 and c2
    from `scalars` (float32 [4] or [5] on param's device,
    `adam_step_scalars`; its guard word at 0: nothing written; with
    `scaled`, each gradient element times its fifth word, the clip
    scale); the plain version on CPU tensors. coeff 0 is Adam."""
    adamw_multi([param], [grad], [m1], [m2], scalars, beta1=beta1,
                beta2=beta2, epsilon=epsilon, coeff=coeff, scaled=scaled)


def fused_adamw_or_none(param, grad, scalars, m1, m2, *, beta1, beta2,
                        epsilon, coeff, scaled=False):
    """Gate (reference: pallas_kernels.py fused_adamw_or_none :1067): None
    when `use_fused_optimizer` is off (the caller runs the plain rule),
    else the kernel's update, in place, returning (param, m1, m2); lr and
    the bias corrections come from the step's `scalars` (the reference's
    lr_ref and c_ref). The kernel takes any numel, so the reference's
    rows-of-128 rule is not carried over; an input it does not take raises
    ValueError."""
    if not flag("use_fused_optimizer"):
        return None
    adamw(param, grad, m1, m2, scalars, beta1=beta1, beta2=beta2,
          epsilon=epsilon, coeff=coeff, scaled=scaled)
    return param, m1, m2


def fused_adamw_multi_or_none(params, grads, scalars, m1s, m2s, *, beta1,
                              beta2, epsilon, coeff, scaled=False,
                              lr_factor=1.0):
    """The same gate over lists (the optimizer's one call a dtype group a
    step): None when `use_fused_optimizer` is off, else `adamw_multi`'s
    update, in place, returning the parameters."""
    if not flag("use_fused_optimizer"):
        return None
    adamw_multi(params, grads, m1s, m2s, scalars, beta1=beta1, beta2=beta2,
                epsilon=epsilon, coeff=coeff, scaled=scaled,
                lr_factor=lr_factor)
    return params


# ---------------------------------------------------------------------------
# Paged decode
#
# Replaces pallas_kernels.py `_paged_f_kernel` (:1738) and
# `_paged_q_kernel` (:1746), both `_paged_core` (:1646), launched by
# `_paged_decode` (:1755). Bound on the H100: bytes — each live K/V row is
# read once per step; the kernel reads only rows 0..min(lens, T-1) and
# updates the cache in place (the reference returns new buffers). For
# either cache the kernel splits each (slot, head)'s keys into chunks, one
# CTA each, whose partial softmax sums the last CTA to arrive combines
# (csrc/paged_decode.cu). Its workspace (partials and tickets) is the
# caller's where the caller owns one (the serving cache: a CUDA graph holds
# its addresses), else one cached here per device and stream. Nothing in
# it grows with the cache depth T, so it takes any T.

# the kernel's warps a CTA and key loads in flight a lane
_PAGED_WARPS, _PAGED_SLOTS = 4, 8
_PAGED_WS = {}


def paged_split_geometry(D, vec4=True):
    """(lanes, chunk) of the paged-decode kernel on a float32 cache for
    head width D: `lanes` take one key row, 16 bytes a lane when `vec4`
    (rows of float4: D % 4 == 0 and 16-byte aligned caches; the power of
    two >= D / 4, at least 4), else 32 lanes of single floats; a CTA takes
    `chunk` = 4 warps x 8 loads x 32 / lanes keys."""
    if vec4 and D % 4 == 0:
        lanes = max(4, 1 << (D // 4 - 1).bit_length())
    else:
        lanes = 32
    return lanes, _PAGED_WARPS * _PAGED_SLOTS * (32 // lanes)


def paged_int8_geometry(D, vec4=True):
    """(lanes, chunk) of the kernel on an int8 cache: 4 bytes (char4) a
    lane when `vec4` (D % 4 == 0 and 4-byte aligned caches), else 32 lanes
    of single bytes. Four values a lane, as the float32 cache's float4, so
    the rule is `paged_split_geometry`'s: at D = 64, 16 lanes a row and
    chunks of 64 keys. (16-byte loads of int8 would give 4 lanes a row and
    256-key chunks, one CTA for nearly every (slot, head) at the serving
    lens.)"""
    return paged_split_geometry(D, vec4)


def paged_workspace_numel(B, H, T, D):
    """(partial floats, tickets) of a workspace that serves the kernel on
    either cache at [B, H, T, D], whatever the caches' alignment: B * H *
    ceil(T / chunk) * (D + 2) floats at the smaller chunk of the two row
    widths (`paged_int8_geometry` is the same rule), and B * H
    tickets."""
    chunk = min(paged_split_geometry(D, vec4)[1] for vec4 in (True, False))
    return B * H * -(-T // chunk) * (D + 2), B * H


def _paged_workspace(q, stream, B, H, T, D, chunk):
    """The kernel's partial sums (B * H * ceil(T / chunk) * (D + 2)
    floats) and its tickets (uint32 [B * H], zeroed once; each call leaves
    them 0) for a call that brings no workspace of its own, cached per
    device and stream and replaced when too small. A CUDA graph must not
    capture these (a replacement would free what it holds), so a capture
    brings its own."""
    key = (q.device, stream)
    need = B * H * -(-T // chunk) * (D + 2)
    ws = _PAGED_WS.get(key)
    if ws is None or ws[0].numel() < need or ws[1].numel() < B * H:
        ws = (torch.empty(need, dtype=torch.float32, device=q.device),
              torch.zeros(B * H, dtype=torch.int32, device=q.device))
        _PAGED_WS[key] = ws
    return ws


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
    _need(1 <= D <= 128 and B <= 65535 and H <= 65535,
          "paged_decode: needs D <= 128 and B, H <= 65535")
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
                 v_scale=None, workspace=None):
    """The paged-decode kernel (in place on the caches). `workspace` is the
    caller's (partials float32, tickets int32 all 0; sizes from
    `paged_workspace_numel`), or None for the one cached here. Inputs the
    kernel does not take raise ValueError on every device; CPU tensors then
    take the plain version, which needs no workspace. Returns out [B, H, 1,
    D] float32."""
    _paged_check(q, k_cache, v_cache, lens, new_k, new_v, k_scale, v_scale)
    quantized = k_scale is not None
    B, H, _, D = q.shape
    T = k_cache.shape[2]
    # 4 elements a lane load: float4 rows (16 bytes) or char4 (4 bytes)
    align = 4 if quantized else 16
    vec4 = (D % 4 == 0 and k_cache.data_ptr() % align == 0
            and v_cache.data_ptr() % align == 0)
    lanes, chunk = (paged_int8_geometry if quantized
                    else paged_split_geometry)(D, vec4)
    if workspace is not None:
        part, ticket = workspace
        _need(part.dtype == torch.float32 and ticket.dtype == torch.int32
              and part.numel() >= B * H * -(-T // chunk) * (D + 2)
              and ticket.numel() >= B * H and part.device == q.device
              and ticket.device == q.device
              and part.is_contiguous() and ticket.is_contiguous(),
              "paged_decode: the workspace must be float32 partials and "
              "int32 tickets on q's device, sized by paged_workspace_numel")
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_cache, v_cache, lens, new_k, new_v,
                                  k_scale, v_scale)
    _need(q.device.type == "cuda", "paged_decode: tensors on %s" % q.device)
    out = torch.empty((B, H, 1, D), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 6)(
        *(s for t in (q, new_k, new_v) for s in t.stride()[:2]))
    stream = _stream(q)
    if workspace is None:
        _need(not torch.cuda.is_current_stream_capturing(),
              "paged_decode: a CUDA graph capture needs a workspace its "
              "caller owns (the cached one may be replaced)")
        workspace = _paged_workspace(q, stream, B, H, T, D, chunk)
    part, ticket = (t.data_ptr() for t in workspace)
    lib = _build.load("paged_decode")
    err = lib.paged_decode(
        q.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        ctypes.addressof(strides), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        lens.data_ptr(), out.data_ptr(), part, ticket, B, H, T, D, lanes,
        int(vec4), 1.0 / math.sqrt(D), int(quantized), stream)
    _check_launch(err, "paged_decode")
    _LAUNCHES["paged_decode_int8" if quantized else "paged_decode"] += 1
    return out


def paged_decode_attention_or_none(q, k_cache, v_cache, lens, new_k, new_v,
                                   k_scale=None, v_scale=None,
                                   workspace=None):
    """Gate (reference: pallas_kernels.py paged_decode_attention_or_none
    :1921): None when `paged_flash_decode` is off (the caller then runs the
    plain version), else the kernel's output with the cache updated in
    place. The kernel takes any cache depth T and head_dim D <= 128, so the
    reference's block rule (`_paged_block`) and its D % 8 rule are not
    carried over; an input the kernel does not take raises ValueError."""
    if not flag("paged_flash_decode"):
        return None
    out = paged_decode(q, k_cache, v_cache, lens, new_k, new_v, k_scale,
                       v_scale, workspace)
    _note_attn_path("paged_flash")
    return out
