"""Hand-written CUDA kernels of the serving path, with their gates.

Counterpart of paddle_tpu/ops/pallas_kernels.py for the two kernel families
the serving path runs:

  * flash-attention forward (csrc/flash_fwd.cu) — prefill attention,
    replacing `_flash_fwd_kernel`;
  * paged decode (csrc/paged_decode.cu) — one decode step's KV append plus
    single-query attention over the paged cache, float32 or int8, replacing
    `_paged_f_kernel` / `_paged_q_kernel` (`_paged_core`).

Beside each kernel sit its plain PyTorch version, a launch counter and a
note on what bounds it. A wrapper checks its inputs against what the
kernel takes on every device and raises ValueError on anything else; it
then runs the plain version for tensors that lie on the CPU and launches
the kernel for CUDA tensors. There is no probe and no quiet fallback: a
gate returns None (the caller's plain route) only when the kernel's flag
is off (`use_flash_attention`, `paged_flash_decode`), which the callers
report in the attention path counters (`xla_sdpa`, `xla_paged`).

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

import torch

from ..framework.flags import flag
from ..observability import metrics
from . import _build

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_or_none", "paged_decode", "paged_decode_plain",
           "paged_decode_attention_or_none", "quantize_kv", "dequantize_kv",
           "launch_counts", "attention_path_counts"]

_NEG_INF = -1e30

# kernel launches, bumped by the wrappers right after a successful launch
_LAUNCHES = {"flash_fwd": 0, "paged_decode": 0, "paged_decode_int8": 0}

# attention implementation chosen by the gates (reference:
# pallas_kernels.py _ATTN_PATHS / _note_attn_path)
_ATTN_PATHS = {"flash": 0, "xla_sdpa": 0, "paged_flash": 0, "xla_paged": 0}
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


# ---------------------------------------------------------------------------
# Flash-attention forward
#
# Replaces pallas_kernels.py `_flash_fwd_kernel` (:324, via `_flash_fwd`
# :412 with need_lse=False). Bound on the H100: at the serving prefill
# shapes (B=1, H=12, T<=256, D=64) a few microseconds of bytes or flops,
# so the kernel is latency-bound; it keeps the [Tq, Tk] scores on chip and
# skips the K/V tiles above the causal diagonal (see the source's note).


def flash_attention_plain(q, k, v, causal, attn_mask=None):
    """softmax(q k^T / sqrt(D) + attn_mask) v in float32, causal mask
    aligned bottom-right (query i sees keys j <= i + Tk - Tq), returned in
    q's dtype (reference: pallas_kernels.py `_xla_attention`). The one
    dense attention body of the port: the kernel's CPU path, the plain sdpa
    route and the suffix-prefill attention all run it."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        float(d) ** -0.5)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        cm = torch.ones((tq, tk), dtype=torch.bool,
                        device=s.device).tril(tk - tq)
        s = torch.where(cm, s, torch.full_like(s, _NEG_INF))
    if attn_mask is not None:
        s = s + attn_mask.float()
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def _flash_check(q, k, v, causal):
    """What the kernel takes (the reference's `_shapes_ok` minus the TPU
    tiling rules: any T, ragged edges masked in the kernel); raises
    ValueError on anything else."""
    _need(q.ndim == 4 and k.ndim == 4 and q.dtype in (torch.float32,
                                                       torch.bfloat16)
          and q.shape[-1] <= 128 and not (causal and k.shape[2] < q.shape[2]),
          "flash_attention: unsupported input %s %s %s causal=%s (float32 "
          "or bfloat16, [B,H,T,D] with D<=128, Tk>=Tq when causal)"
          % (tuple(q.shape), tuple(k.shape), q.dtype, causal))
    B, H, Tq, D = q.shape
    _need(tuple(k.shape) == (B, H, k.shape[2], D) and v.shape == k.shape
          and k.dtype == q.dtype and v.dtype == q.dtype,
          "flash_attention: k/v shape or dtype")
    for t in (q, k, v):
        _need(t.device == q.device, "flash_attention: mixed devices")
        _need(t.stride(-1) == 1, "flash_attention: head_dim stride != 1")


def flash_attention(q, k, v, causal):
    """Attention forward, q/k/v [B, H, T, D]; any strides with a unit
    head_dim stride. Inputs the kernel does not take raise ValueError on
    every device; CPU tensors then take the plain version."""
    _flash_check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    _need(q.device.type == "cuda", "flash_attention: tensors on %s"
          % q.device)
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    o = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    lib = _build.load("flash_fwd")
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        ctypes.addressof(strides), B, H, Tq, Tk, D, int(bool(causal)),
        float(D) ** -0.5, 0 if q.dtype == torch.float32 else 1,
        _stream(q))
    _check_launch(err, "flash_fwd")
    _LAUNCHES["flash_fwd"] += 1
    return o


def flash_attention_or_none(query, key, value, attn_mask, is_causal):
    """Gate (reference: pallas_kernels.py flash_attention_or_none :1534):
    None when `use_flash_attention` is off (the caller then runs the plain
    version), else the kernel's output. An additive mask, or an input the
    kernel does not take, raises ValueError: unlike the reference's gate,
    this one never hands such a call to the plain version on its own.
    Attention dropout is not ported: the caller refuses it first."""
    if not flag("use_flash_attention"):
        return None
    _need(attn_mask is None,
          "flash_attention: the kernel takes no additive mask; set the "
          "use_flash_attention flag to False for the plain version")
    out = flash_attention(query, key, value, bool(is_causal))
    _note_attn_path("flash")
    return out


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
