// Fused bias + dropout + residual (+ LayerNorm) for Hopper (sm_90a):
// forward with LN, forward without LN, and the backward of both.
//
// Replaces paddle_tpu/ops/pallas_kernels.py `_fbdrln_fwd_kernel`,
// `_fbdrln_fwd_noln_kernel` and `_fbdrln_bwd_kernel` (launched by
// `_fbdrln_call`, behind the custom vjp `_fbdrln_pair`), on rows of
// [N, Hd] in row-major order:
//   forward:  h = x + bias, dropped (keep iff bits >= thr, kept values
//             times scale) when `on`; z = residual + h; with LN,
//             y = (z - mean) * rstd * gamma + beta, mean = sum(z) / Hd,
//             var = sum((z - mean)^2) / Hd (two passes, as :784-786),
//             rstd = 1 / sqrt(var + eps). y and z are stored in x's type.
//   backward: with LN, mean and rstd again from the stored z (in z's type,
//             widened: :805-808), x^ = (z - mean) * rstd, a = dy * gamma,
//             dz = rstd * (a - mean(a) - x^ * mean(a x^)); without LN,
//             dz = dy; then dz += dz_extra (absent: 0). dres = dz, and
//             dx = dz under the forward's keep mask and scale, both in z's
//             type.
// All arithmetic is float32; each of x, residual, bias, gamma, beta (and z,
// dy, dz_extra, gamma) is float32, bfloat16 or float16 on its own (the 2-bit
// code i of `dtypes`: 0 float32, 1 bfloat16, 2 float16), with one 16-bit type
// a call: the row kernels are template instances by type, each tensor float32
// or the call's 16-bit type, which keeps their count to twice the bfloat16 set
// rather than three to the power of the tensors. A call that mixes bfloat16
// and float16 is refused. Hd <= 8192 (the forward's shared memory; the wrapper
// refuses more). IEEE division and square root (no --use_fast_math), so rstd
// is 1 / sqrtf, not the approximate rsqrtf.
//
// The dropout bits are Philox-4x32-10 (attn_dropout.cuh) keyed by the
// call's 64-bit seed with the counter (col, row / 4, kTag, call offset) and
// word row % 4 of the result: a function of the element alone, so the
// backward regenerates the forward's mask from the saved Philox word and
// delta (offset = the word's base + delta, read in the kernel) whatever its
// launch shape. The TPU kernels seed their PRNG with seed +
// program id, so there forward and backward must share the row block
// (:917-919); here they need not. kTag is above any batch*head index, so
// no attention call draws the same counter.
//
// The reference leaves dbias, dgamma and dbeta to XLA column reductions
// outside the kernel (:924-933). Here the backward folds them in: each
// lane keeps the sums of dx (as stored), dy * x^ and dy of its columns in
// registers across its warp's groups, the CTA's warps add theirs in shared
// memory at its end, and the CTA writes one float32 partial row per sum
// (132 on an H100); a second, small kernel of the same call adds
// the partial rows in CTA order and stores the sums in z's type.
//
// Forward design, with LN at Hd <= 768 (both main paths: GPT-2 and ERNIE
// are 768 wide): a warp per 4-row group, 8 warps a CTA, a persistent grid
// of as many CTAs as fit on the card (the occupancy API), the groups dealt
// to the CTAs in turn and within a CTA to its warps. The row types (x and
// the residual; y and z take x's) are template parameters; bias, gamma and
// beta sit in each lane's registers as float, read once, whatever their
// type. A lane takes 8 columns at once, one 16-byte access of bfloat16 or
// two of float32, where Hd % 8 == 0 and the rows are 16-byte aligned,
// else single elements in the same kernel. One Philox call per column
// gives the group's 4 rows' bits, packed to a keep bit each at the group's
// start. Row by row, the next row's x and residual are loaded before the
// current row is reduced; z is formed in float32 in registers and stored,
// its mean and two-pass variance are warp shuffles over those registers
// (statistics of the float32 z, as the reference takes them), and y is
// stored. No shared memory, no __syncthreads.
// Without LN, and with LN past Hd = 768, one CTA of 256 threads per group
// of 4 rows: a thread owns columns tid, tid + 256, ... of all 4 rows, so
// one Philox call per column gives the bits of the group's 4 rows. The row
// sums go through warp shuffles and one shared-memory step (4 rows at
// once). With LN the rows' float32 z sit in shared memory between passes.
//
// Backward design: a warp per 4-row group, 8 warps a CTA, one CTA an SM
// (the launch bounds; the wrapper sizes the grid to match), the groups
// dealt to the CTAs in turn and within a CTA to its warps. The element types are template parameters. A lane takes 8
// columns at once, one 16-byte access of bfloat16 or two of float32,
// where Hd % 8 == 0 and the rows are 16-byte aligned, else single
// elements in the same kernel. One Philox call per column gives the
// group's 4 rows' bits, packed to a keep bit each at the group's start.
// Each row's 768 block columns of z, dy and dz_extra are loaded into
// registers once (bfloat16 stays packed), a row ahead of the row being
// reduced, and every pass of the row reads them there: no value is read
// twice from memory and nothing is staged in shared memory. Row sums are
// warp shuffles only, no __syncthreads within a group. Past Hd = 768 the
// grid gains column blocks of 768, each adding the columns outside its
// block to the rows' sums from global memory and writing its own columns.
//
// What bounds it on the H100: bytes. At the GPT-2 shapes (N = 8192 rows,
// Hd = 768, bfloat16) the forward with LN reads x and the residual and
// writes y and z (4 x 12.6 MB), without LN one output fewer, and the
// backward reads z, dy and dz_extra and writes dx and dres (5 x 12.6 MB).
// The backward's instructions come near that: by count ~36 an element
// and lane plus one Philox call (~120) per 4 elements, ~14 us at the
// card's peak issue rate against the bytes' ~19 us. What the design does
// about it: one pass over device memory per call, the mask never stored,
// the LN statistics recomputed from z rather than saved, registers in
// place of re-reads and shared-memory staging, 16-byte accesses, and
// loads a row ahead so that a warp keeps bytes in flight while it
// reduces. The forward without LN keeps the CTA-per-group kernel: it
// reaches half its bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "attn_dropout.cuh"

namespace {

constexpr int kRows = 4;         // rows per group: one Philox call's words
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 8192;
constexpr unsigned kTag = 0xFD1D0000u;   // counter word 2; > any b*h index

// a call's dropout as the host passes it: the Philox word in device memory
// (seed, base offset) and the call's delta, read by `resolve` once at each
// kernel's start (attn_dropout.cuh), so a replayed CUDA graph draws the
// bits of the word's current base
struct DropArgs {
  int on;
  unsigned thr;
  float scale;
  const unsigned long long* rng;
  unsigned delta;
  unsigned tag;
};

// ... and as the kernels use it: offset = base + delta
struct Drop {
  int on;
  unsigned thr;
  float scale;
  unsigned long long seed;
  unsigned offset;
};

__device__ __forceinline__ Drop resolve(const DropArgs& a) {
  Drop d{a.on, a.thr, a.scale, 0ull, 0u};
  if (a.on) attn_dropout::load_key(a.rng, a.delta, d.seed, d.offset);
  return d;
}

// tensor i's type code in a call's `dtypes`: 0 float32, 1 bfloat16, 2
// float16
__host__ __device__ __forceinline__ int code(int dt, int i) {
  return (dt >> (2 * i)) & 3;
}

__device__ __forceinline__ float ld(const void* p, int c, size_t i) {
  if (c == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (c == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, int c, size_t i, float v) {
  if (c == 1)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else if (c == 2)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ uint4 bits4(const Drop& d, int group, int col,
                                       unsigned tag = kTag) {
  return attn_dropout::philox4x32_10(
      make_uint4((unsigned)col, (unsigned)group, tag, d.offset),
      make_uint2((unsigned)d.seed, (unsigned)(d.seed >> 32)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v[r] <- the sum of v[r] over the block, for the 4 rows at once
__device__ void block_sum4(float (&v)[kRows], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    v[r] = warp_sum(v[r]);
    if (lane == 0) red[r * 32 + warp] = v[r];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float t = warp_sum(lane < kWarps ? red[r * 32 + lane] : 0.f);
      if (lane == 0) red[r * 32] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = red[r * 32];
  __syncthreads();
}

template <bool LN>
__global__ void __launch_bounds__(kThreads)
fdrln_fwd_kernel(const void* __restrict__ x, const void* __restrict__ res,
                 const void* __restrict__ bias,
                 const void* __restrict__ gamma,
                 const void* __restrict__ beta, void* __restrict__ y,
                 void* __restrict__ z, int n, int h, int dt, DropArgs da,
                 float eps) {
  const Drop d = resolve(da);
  extern __shared__ float zs[];            // LN: kRows * h float32 z
  __shared__ float red[kRows * 32];
  const int xb = code(dt, 0), rb = code(dt, 1), bb = code(dt, 2);
  const int gb = code(dt, 3), eb = code(dt, 4);
  const int group = blockIdx.x, row0 = group * kRows;
  const int rows = min(kRows, n - row0);
  float s[kRows] = {0.f, 0.f, 0.f, 0.f};
  for (int c = threadIdx.x; c < h; c += kThreads) {
    const float b = bias ? ld(bias, bb, c) : 0.f;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (d.on) w = bits4(d, group, c);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      const size_t i = (size_t)(row0 + r) * h + c;
      float hv = ld(x, xb, i) + b;
      if (d.on) hv = attn_dropout::word(w, r) >= d.thr ? hv * d.scale : 0.f;
      const float zv = ld(res, rb, i) + hv;
      st(z, xb, i, zv);
      if (LN) {
        zs[r * h + c] = zv;
        s[r] += zv;
      }
    }
  }
  if (!LN) return;
  block_sum4(s, red);
  float mean[kRows], v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    mean[r] = s[r] / (float)h;
    v[r] = 0.f;
  }
  for (int c = threadIdx.x; c < h; c += kThreads) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float dd = zs[r * h + c] - mean[r];
      v[r] += dd * dd;
    }
  }
  block_sum4(v, red);
  float rstd[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) rstd[r] = 1.0f / sqrtf(v[r] / (float)h + eps);
  for (int c = threadIdx.x; c < h; c += kThreads) {
    const float g = ld(gamma, gb, c), be = ld(beta, eb, c);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      const size_t i = (size_t)(row0 + r) * h + c;
      st(y, xb, i, (zs[r * h + c] - mean[r]) * rstd[r] * g + be);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: a warp per 4-row group, 16-byte accesses, dtypes as template
// parameters (TZ: z, dx and dres; TY: dy; TE: dz_extra; TG: gamma).

// 8 warps: with LN a thread takes up to ~220 registers (its 72 column
// sums, two rows of packed values), so one CTA an SM (the launch bounds,
// and the wrapper's _FDRLN_BWD_CTAS_PER_SM); 12 or 16 warps capped the
// registers and spilled, and ran slower on the H100
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kChunk = 8;                // columns a lane takes at once
constexpr int kLaneChunks = 3;           // chunks a lane keeps sums for
// the columns whose sums a CTA keeps (in its lanes' registers): 768, so at
// Hd <= 768 one column block holds the whole row
constexpr int kColBlock = 32 * kChunk * kLaneChunks;
// the forward with LN at Hd <= kColBlock: 8 warps a CTA, as many CTAs an
// SM as its registers allow (the launch asks the occupancy API)
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = kFwdWarps * 32;

// 8 values from p: one 16-byte load (bfloat16) or two (float32) when vec,
// else the first n by element, zeros after
__device__ __forceinline__ void load8(const float* p, float (&v)[kChunk],
                                      bool vec, int n) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = e < n ? p[e] : 0.f;
  }
}
// the 16-bit types' pair type and conversions
template <typename T>
struct Half;
template <>
struct Half<__nv_bfloat16> {
  typedef __nv_bfloat162 T2;
  static __device__ __forceinline__ float2 widen(T2 v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ T2 pair(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ T2 join(__nv_bfloat16 a,
                                            __nv_bfloat16 b) {
    return __halves2bfloat162(a, b);
  }
  static __device__ __forceinline__ float lo(T2 v) { return __low2float(v); }
  static __device__ __forceinline__ float hi(T2 v) { return __high2float(v); }
};
template <>
struct Half<__half> {
  typedef __half2 T2;
  static __device__ __forceinline__ float2 widen(T2 v) {
    return __half22float2(v);
  }
  static __device__ __forceinline__ T2 pair(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float to(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ T2 join(__half a, __half b) {
    return __halves2half2(a, b);
  }
  static __device__ __forceinline__ float lo(T2 v) { return __low2float(v); }
  static __device__ __forceinline__ float hi(T2 v) { return __high2float(v); }
};

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[kChunk],
                                      bool vec, int n) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const typename Half<T>::T2* h2 =
        reinterpret_cast<const typename Half<T>::T2*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = Half<T>::widen(h2[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      v[e] = e < n ? Half<T>::to(p[e]) : 0.f;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kChunk],
                                       bool vec, int n) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < n) p[e] = v[e];
  }
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[kChunk],
                                       bool vec, int n) {
  if (vec) {
    uint4 u;
    typename Half<T>::T2* h2 = reinterpret_cast<typename Half<T>::T2*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h2[e] = Half<T>::pair(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (e < n) p[e] = Half<T>::from(v[e]);
  }
}

// 8 values of a row as loaded, in their own type (16-bit types stay
// packed: 4 registers, widened where they are read)
template <typename T>
struct Chunk {
  typename Half<T>::T2 v[kChunk / 2];
  __device__ __forceinline__ void load(const T* p, bool vec, int n) {
    if (vec) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; e += 2)
        v[e / 2] = Half<T>::join(e < n ? p[e] : Half<T>::from(0.f),
                                 e + 1 < n ? p[e + 1] : Half<T>::from(0.f));
    }
  }
  __device__ __forceinline__ float operator[](int e) const {
    return e & 1 ? Half<T>::hi(v[e / 2]) : Half<T>::lo(v[e / 2]);
  }
};
template <>
struct Chunk<float> {
  float v[kChunk];
  __device__ __forceinline__ void load(const float* p, bool vec, int n) {
    load8(p, v, vec, n);
  }
  __device__ __forceinline__ float operator[](int e) const { return v[e]; }
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
template <typename T>
__device__ __forceinline__ void store1(T* p, float v) {
  *p = Half<T>::from(v);
}

// v as stored in T, widened back
__device__ __forceinline__ float as_stored(float v, const float*) {
  return v;
}
template <typename T>
__device__ __forceinline__ float as_stored(float v, const T*) {
  return Half<T>::to(Half<T>::from(v));
}

// keep bits of a group: bit 4 e + r of keep[c] is row r of column
// col0 + 256 c + e, from one Philox call per column (all kept when off)
__device__ __forceinline__ void keep_bits(const Drop& d, int group, int col0,
                                          int h,
                                          unsigned (&keep)[kLaneChunks]) {
#pragma unroll
  for (int c = 0; c < kLaneChunks; ++c) {
    keep[c] = 0xFFFFFFFFu;
    const int col = col0 + c * 32 * kChunk;
    if (d.on && col < h) {
      keep[c] = 0u;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const uint4 w = bits4(d, group, col + e);
        keep[c] |= ((unsigned)(w.x >= d.thr) |
                    (unsigned)(w.y >= d.thr) << 1 |
                    (unsigned)(w.z >= d.thr) << 2 |
                    (unsigned)(w.w >= d.thr) << 3) << (4 * e);
      }
    }
  }
}

// Forward with LN at Hd <= 768 (kColBlock): a warp per 4-row group, 8 warps
// a CTA, a persistent grid; warp w of CTA b takes groups b + grid (w + 8 i).
// Lane l takes columns 256 c + 8 l .. +7 (c < 3), 16 bytes at a time where
// vec. bias, gamma and beta sit in its registers as float, read once. A
// group starts with its keep bits; then row after row: x and the residual
// of the next row (the next group's first after a group's last) are loaded
// before the current row is reduced; z = residual + dropped (x + bias) in
// float32 is stored, its mean and two-pass variance are warp shuffles over
// the float32 values in registers, and y is stored. No __syncthreads.
template <typename TX, typename TR>
__global__ void __launch_bounds__(kFwdThreads)
fdrln_fwd_ln_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
                    const void* __restrict__ bias,
                    const void* __restrict__ gamma,
                    const void* __restrict__ beta, TX* __restrict__ y,
                    TX* __restrict__ z, int n, int h, int vec, int dt,
                    DropArgs da, float eps) {
  const Drop d = resolve(da);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (n + kRows - 1) / kRows;
  const int col0 = lane * kChunk;
  auto ncols = [&](int c) { return min(kChunk, h - (col0 + c * 32 * kChunk)); };
  const int bb = code(dt, 2), gb = code(dt, 3), eb = code(dt, 4);
  float vb[kLaneChunks][kChunk], vg[kLaneChunks][kChunk],
      ve[kLaneChunks][kChunk];
#pragma unroll
  for (int c = 0; c < kLaneChunks; ++c)
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int col = col0 + c * 32 * kChunk + e;
      const bool in = col < h;
      vb[c][e] = in && bias ? ld(bias, bb, col) : 0.f;
      vg[c][e] = in ? ld(gamma, gb, col) : 0.f;
      ve[c][e] = in ? ld(beta, eb, col) : 0.f;
    }

  Chunk<TX> xn[kLaneChunks];
  Chunk<TR> rn[kLaneChunks];
  auto load_row = [&](int row) {
    const size_t rb = (size_t)row * h;
#pragma unroll
    for (int c = 0; c < kLaneChunks; ++c) {
      const int col = col0 + c * 32 * kChunk, nv = ncols(c);
      if (nv <= 0) continue;
      xn[c].load(x + rb + col, vec, nv);
      rn[c].load(res + rb + col, vec, nv);
    }
  };
  const int gstride = gridDim.x * kFwdWarps;
  if (blockIdx.x + gridDim.x * warp < groups)
    load_row((blockIdx.x + gridDim.x * warp) * kRows);

  for (int group = blockIdx.x + gridDim.x * warp; group < groups;
       group += gstride) {
    const int row0 = group * kRows, rows = min(kRows, n - row0);
    unsigned keep[kLaneChunks];
    keep_bits(d, group, col0, h, keep);
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const size_t rb = (size_t)(row0 + r) * h;
      Chunk<TX> xc[kLaneChunks];
      Chunk<TR> rc[kLaneChunks];
#pragma unroll
      for (int c = 0; c < kLaneChunks; ++c) {
        xc[c] = xn[c];
        rc[c] = rn[c];
      }
      if (r + 1 < rows)
        load_row(row0 + r + 1);
      else if (group + gstride < groups)
        load_row((group + gstride) * kRows);
      float zv[kLaneChunks][kChunk];
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kLaneChunks; ++c) {
        const int nv = ncols(c);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          float hv = xc[c][e] + vb[c][e];
          if (d.on) hv = (keep[c] >> (4 * e + r)) & 1u ? hv * d.scale : 0.f;
          zv[c][e] = e < nv ? rc[c][e] + hv : 0.f;
          s += zv[c][e];
        }
        if (nv > 0) store8(z + rb + col0 + c * 32 * kChunk, zv[c], vec, nv);
      }
      const float mean = warp_sum(s) / (float)h;
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < kLaneChunks; ++c) {
        const int nv = ncols(c);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          const float dd = e < nv ? zv[c][e] - mean : 0.f;
          v += dd * dd;
        }
      }
      const float rstd = 1.0f / sqrtf(warp_sum(v) / (float)h + eps);
#pragma unroll
      for (int c = 0; c < kLaneChunks; ++c) {
        const int nv = ncols(c);
        if (nv <= 0) continue;
        float yv[kChunk];
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          yv[e] = (zv[c][e] - mean) * rstd * vg[c][e] + ve[c][e];
        store8(y + rb + col0 + c * 32 * kChunk, yv, vec, nv);
      }
    }
  }
}

// Warp w of CTA b takes groups b + grid (w + 8 i), so every CTA gets its
// share of the groups when they are few. Lane l takes columns
// cb0 + 256 c + 8 l .. +7 of the CTA's column block (blockIdx.y, 768
// columns), and keeps their column sums (dx as stored, dy x^, dy) in
// registers across its groups. A group starts with its keep bits (one
// Philox call per column, 4 rows' bits, packed to a bit each); then row
// after row, the row's block columns of z, dy and dz_extra are loaded
// into registers once (a row ahead, all their loads in flight), and every
// pass of the row (mean, variance, the sums of a and a x^, then dz, dres
// and dx) reads them there. Past Hd = 768 the columns
// outside the block only add to the row's sums, read from global memory
// in the same passes. At the end the CTA's warps add their column sums in
// shared memory in a fixed order, and the CTA writes one float32 partial
// row per sum.
template <bool LN, typename TZ, typename TY, typename TE, typename TG>
__global__ void __launch_bounds__(kBwdThreads, 1)
fdrln_bwd_kernel(const TZ* __restrict__ z, const TY* __restrict__ dy,
                 const TE* __restrict__ dzx, const TG* __restrict__ gamma,
                 TZ* __restrict__ dx, TZ* __restrict__ dres,
                 float* __restrict__ part, int n, int h, int vec,
                 DropArgs da, float eps) {
  const Drop d = resolve(da);
  constexpr int nacc = LN ? 3 : 1;
  __shared__ float sums[nacc * kColBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cb0 = blockIdx.y * kColBlock;
  const int groups = (n + kRows - 1) / kRows;
  // the lane's columns of the block: col0 + 256 c + e
  const int col0 = cb0 + lane * kChunk;
  auto ncols = [&](int c) { return min(kChunk, h - (col0 + c * 32 * kChunk)); };
  float cdx[kLaneChunks][kChunk], cdyx[kLaneChunks][kChunk],
      cdy[kLaneChunks][kChunk];
#pragma unroll
  for (int c = 0; c < kLaneChunks; ++c)
#pragma unroll
    for (int e = 0; e < kChunk; ++e) cdx[c][e] = cdyx[c][e] = cdy[c][e] = 0.f;

  // the block columns of z, dy and dz_extra of one row, loaded one row
  // ahead of the row being worked on (the next group's first row after a
  // group's last), so a row's loads are in flight while the row before it
  // is reduced and written
  Chunk<TZ> zn[kLaneChunks];
  Chunk<TY> yn[kLaneChunks];
  Chunk<TE> en[kLaneChunks];
  auto load_row = [&](int row) {
    const size_t rb = (size_t)row * h;
#pragma unroll
    for (int c = 0; c < kLaneChunks; ++c) {
      const int col = col0 + c * 32 * kChunk, nv = ncols(c);
      if (nv <= 0) continue;
      yn[c].load(dy + rb + col, vec, nv);
      if (LN) zn[c].load(z + rb + col, vec, nv);
      if (dzx) en[c].load(dzx + rb + col, vec, nv);
    }
  };
  const int gstride = gridDim.x * kBwdWarps;
  if (blockIdx.x + gridDim.x * warp < groups)
    load_row((blockIdx.x + gridDim.x * warp) * kRows);

  for (int group = blockIdx.x + gridDim.x * warp; group < groups;
       group += gstride) {
    const int row0 = group * kRows, rows = min(kRows, n - row0);
    unsigned keep[kLaneChunks];
    keep_bits(d, group, col0, h, keep);
#pragma unroll 1
    for (int r = 0; r < rows; ++r) {
      const size_t rb = (size_t)(row0 + r) * h;
      Chunk<TZ> zc[kLaneChunks];
      Chunk<TY> yc[kLaneChunks];
      Chunk<TE> ec[kLaneChunks];
#pragma unroll
      for (int c = 0; c < kLaneChunks; ++c) {
        zc[c] = zn[c];
        yc[c] = yn[c];
        ec[c] = en[c];
      }
      if (r + 1 < rows)
        load_row(row0 + r + 1);
      else if (group + gstride < groups)
        load_row((group + gstride) * kRows);
      float mean = 0.f, rstd = 0.f, ma = 0.f, mxa = 0.f;
      if (LN) {
        // the row's columns outside the block: 256 a lane-chunk step
        auto others = [&](auto&& fn) {
          for (int base = 0; base < h; base += kColBlock) {
            if (base == cb0) continue;
            for (int c = 0; c < kLaneChunks; ++c) {
              const int col = base + c * 32 * kChunk + lane * kChunk;
              const int nv = min(kChunk, h - col);
              if (nv > 0) fn(col, nv);
            }
          }
        };
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kLaneChunks; ++c) {
          if (ncols(c) <= 0) continue;
#pragma unroll
          for (int e = 0; e < kChunk; ++e) s += zc[c][e];   // 0 past h
        }
        others([&](int col, int nv) {
          float zv[kChunk];
          load8(z + rb + col, zv, vec, nv);
#pragma unroll
          for (int e = 0; e < kChunk; ++e) s += zv[e];
        });
        mean = warp_sum(s) / (float)h;
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < kLaneChunks; ++c) {
          const int nv = ncols(c);
#pragma unroll
          for (int e = 0; e < kChunk; ++e) {
            const float dd = e < nv ? zc[c][e] - mean : 0.f;
            v += dd * dd;
          }
        }
        others([&](int col, int nv) {
          float zv[kChunk];
          load8(z + rb + col, zv, vec, nv);
#pragma unroll
          for (int e = 0; e < kChunk; ++e) {
            const float dd = e < nv ? zv[e] - mean : 0.f;
            v += dd * dd;
          }
        });
        rstd = 1.0f / sqrtf(warp_sum(v) / (float)h + eps);
        float sa = 0.f, sax = 0.f;
#pragma unroll
        for (int c = 0; c < kLaneChunks; ++c) {
          const int nv = ncols(c);
          if (nv <= 0) continue;
          float g[kChunk];
          load8(gamma + col0 + c * 32 * kChunk, g, false, nv);
#pragma unroll
          for (int e = 0; e < kChunk; ++e) {
            // columns past h hold dy = 0 and add nothing
            const float xh = (zc[c][e] - mean) * rstd;
            const float a = yc[c][e] * g[e];
            sa += a;
            sax += a * xh;
            cdyx[c][e] += yc[c][e] * xh;
            cdy[c][e] += yc[c][e];
          }
        }
        others([&](int col, int nv) {
          float zv[kChunk], yv[kChunk], g[kChunk];
          load8(z + rb + col, zv, vec, nv);
          load8(dy + rb + col, yv, vec, nv);
          load8(gamma + col, g, false, nv);
#pragma unroll
          for (int e = 0; e < kChunk; ++e) {
            const float xh = (zv[e] - mean) * rstd;
            const float a = yv[e] * g[e];
            sa += a;
            sax += a * xh;
          }
        });
        ma = warp_sum(sa) / (float)h;
        mxa = warp_sum(sax) / (float)h;
      }
#pragma unroll
      for (int c = 0; c < kLaneChunks; ++c) {
        const int col = col0 + c * 32 * kChunk, nv = ncols(c);
        if (nv <= 0) continue;
        float g[kChunk], dz[kChunk], dxv[kChunk];
        if (LN) load8(gamma + col, g, false, nv);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          float v = yc[c][e];
          if (LN) {
            const float xh = (zc[c][e] - mean) * rstd;
            v = rstd * (v * g[e] - ma - xh * mxa);
          }
          if (dzx) v += ec[c][e];
          dz[e] = v;
          dxv[e] = d.on ? ((keep[c] >> (4 * e + r)) & 1u ? v * d.scale : 0.f)
                        : v;
          // columns past h add 0 (dy = dz_extra = 0 there, dx = 0)
          if (e < nv) cdx[c][e] += as_stored(dxv[e], dx);
        }
        store8(dres + rb + col, dz, vec, nv);
        store8(dx + rb + col, dxv, vec, nv);
      }
    }
  }

  // the CTA's column sums: warp after warp, a fixed order
  for (int w = 0; w < kBwdWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < kLaneChunks; ++c)
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          const int cl = c * 32 * kChunk + lane * kChunk + e;
          sums[cl] = (w ? sums[cl] : 0.f) + cdx[c][e];
          if (LN) {
            sums[kColBlock + cl] = (w ? sums[kColBlock + cl] : 0.f) +
                                   cdyx[c][e];
            sums[2 * kColBlock + cl] =
                (w ? sums[2 * kColBlock + cl] : 0.f) + cdy[c][e];
          }
        }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < nacc * kColBlock; j += kBwdThreads) {
    const int k = j / kColBlock, col = cb0 + j - k * kColBlock;
    if (col < h) part[((size_t)blockIdx.x * nacc + k) * h + col] = sums[j];
  }
}

// out[j] = the sum of part[b][j] over the grid's rows b, in row order,
// stored in out's type: the backward's column sums
template <typename T>
__global__ void fdrln_colsum_kernel(const float* __restrict__ part,
                              T* __restrict__ out, int rows, int m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float t = 0.f;
  for (int b = 0; b < rows; ++b) t += part[(size_t)b * m + j];
  store1(out + j, t);
}

// A block whose shared memory passes 48 KB in all (`dynamic` bytes beside
// the kernel's static `fixed`) needs an opt-in per kernel.
template <typename K>
int set_smem(K kernel, size_t dynamic, size_t fixed) {
  if (dynamic + fixed <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
}

struct BwdArgs {
  const void *z, *dy, *dzx, *gamma;
  void *dx, *dres;
  float* part;
  int n, h, grid, vec;
  DropArgs d;
  float eps;
  cudaStream_t stream;
};

template <bool LN, typename TZ, typename TY, typename TE, typename TG>
int launch_bwd(const BwdArgs& a) {
  const dim3 grid(a.grid, (a.h + kColBlock - 1) / kColBlock);
  fdrln_bwd_kernel<LN, TZ, TY, TE, TG><<<grid, kBwdThreads, 0, a.stream>>>(
      static_cast<const TZ*>(a.z), static_cast<const TY*>(a.dy),
      static_cast<const TE*>(a.dzx), static_cast<const TG*>(a.gamma),
      static_cast<TZ*>(a.dx), static_cast<TZ*>(a.dres), a.part, a.n, a.h,
      a.vec, a.d, a.eps);
  return (int)cudaGetLastError();
}
// The element types from `dtypes` (code 0 z, 1 dy, 2 dz_extra, 3 gamma),
// each float or the call's 16-bit type L; without LN gamma is unused and
// float
typedef __nv_bfloat16 bf16;
template <typename L>
struct BwdPick {
  template <bool LN, typename TZ, typename TY, typename TE>
  static int g(const BwdArgs& a, int dt) {
    if constexpr (LN) {
      if (code(dt, 3)) return launch_bwd<LN, TZ, TY, TE, L>(a);
    }
    return launch_bwd<LN, TZ, TY, TE, float>(a);
  }
  template <bool LN, typename TZ, typename TY>
  static int e(const BwdArgs& a, int dt) {
    return code(dt, 2) ? g<LN, TZ, TY, L>(a, dt) : g<LN, TZ, TY, float>(a, dt);
  }
  template <bool LN, typename TZ>
  static int y(const BwdArgs& a, int dt) {
    return code(dt, 1) ? e<LN, TZ, L>(a, dt) : e<LN, TZ, float>(a, dt);
  }
  static int pick(const BwdArgs& a, int dt, int with_ln) {
    if (with_ln)
      return code(dt, 0) ? y<true, L>(a, dt) : y<true, float>(a, dt);
    return code(dt, 0) ? y<false, L>(a, dt) : y<false, float>(a, dt);
  }
};

// the call's 16-bit type: 2 for float16 when any of the first n codes is
// 2, else 1; -1 when bfloat16 and float16 are mixed (refused)
int low_code(int dt, int n) {
  int low = 0;
  for (int i = 0; i < n; ++i) {
    const int c = code(dt, i);
    if (c == 3 || (c && low && c != low)) return -1;
    if (c) low = c;
  }
  return low ? low : 1;
}

int pick(const BwdArgs& a, int dt, int with_ln) {
  const int low = low_code(dt, 4);
  if (low < 0) return (int)cudaErrorInvalidValue;
  return low == 2 ? BwdPick<__half>::pick(a, dt, with_ln)
                  : BwdPick<bf16>::pick(a, dt, with_ln);
}

struct FwdArgs {
  const void *x, *res, *bias, *gamma, *beta;
  void *y, *z;
  int n, h, vec, dt;
  DropArgs d;
  float eps;
  cudaStream_t stream;
};

// the persistent grid: as many CTAs as fit on the card at once, at most
// one per 8 groups
template <typename TX, typename TR>
int launch_fwd_ln(const FwdArgs& a) {
  static int per_sm = 0;               // per instance; the same on any H100
  if (!per_sm) {
    const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fdrln_fwd_ln_kernel<TX, TR>, kFwdThreads, 0);
    if (err) return err;
    if (!per_sm) return (int)cudaErrorInvalidConfiguration;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const int err = (int)cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const int groups = (a.n + kRows - 1) / kRows;
  const int grid = min((groups + kFwdWarps - 1) / kFwdWarps, per_sm * sms);
  fdrln_fwd_ln_kernel<TX, TR><<<grid, kFwdThreads, 0, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TR*>(a.res), a.bias,
      a.gamma, a.beta, static_cast<TX*>(a.y), static_cast<TX*>(a.z), a.n,
      a.h, a.vec, a.dt, a.d, a.eps);
  return (int)cudaGetLastError();
}

// One lane's bits: 4-row group `group`, columns c0 .. c0 + 3 (4 Philox
// calls, one a column). MASK: out is bool [n, h], bits >= d.thr (a dropout
// keep mask), each row's 4 bytes one 4-byte store; else out is uint32 [n,
// h], the bits, each row's 4 words one 16-byte store. `vec` (h % 4 == 0 and
// out 16-byte aligned) lets a whole group and quad take those stores; the
// last partial group and the ragged column tail store element by element.
template <bool MASK>
__device__ __forceinline__ void bits_lane(void* __restrict__ out,
                                          const Drop& d, unsigned tag, int n,
                                          int h, bool vec, int group,
                                          int c0) {
  uint4 w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = bits4(d, group, c0 + j, tag);
  const int row0 = group * kRows;
  if (vec && row0 + kRows <= n && c0 + 4 <= h) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t i = (size_t)(row0 + r) * h + c0;
      const unsigned b0 = attn_dropout::word(w[0], r),
                     b1 = attn_dropout::word(w[1], r),
                     b2 = attn_dropout::word(w[2], r),
                     b3 = attn_dropout::word(w[3], r);
      if (MASK)
        *reinterpret_cast<unsigned*>(static_cast<bool*>(out) + i) =
            (unsigned)(b0 >= d.thr) | (unsigned)(b1 >= d.thr) << 8 |
            (unsigned)(b2 >= d.thr) << 16 | (unsigned)(b3 >= d.thr) << 24;
      else
        *reinterpret_cast<uint4*>(static_cast<unsigned*>(out) + i) =
            make_uint4(b0, b1, b2, b3);
    }
    return;
  }
  for (int r = 0; r < kRows && row0 + r < n; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j >= h) break;
      const size_t i = (size_t)(row0 + r) * h + c0 + j;
      const unsigned b = attn_dropout::word(w[j], r);
      if (MASK)
        static_cast<bool*>(out)[i] = b >= d.thr;
      else
        static_cast<unsigned*>(out)[i] = b;
    }
}

// The bits of rows [n, h], a lane per (4-row group, 4 adjacent columns):
// lane t takes group t / quads and columns 4 (t % quads) .., quads = ceil(h
// / 4). The split is 32-bit, by a multiply-high with the host's magic
// number for quads (t < 2^31: t / quads = (umulhi(t, magic) + t) >>
// shift), one lane a thread. WIDE (groups * quads >= 2^31): 64-bit
// division in a grid-stride loop. What bounds it on the H100: the Philox
// calls (~60 int32 operations each, one a 4 elements) against one byte
// written an element. A lane per (group, column) with a 64-bit t / h and
// t % h, as the kernel first did, spent about as many instructions on the
// split as on Philox and stored single bytes at row stride; here the
// split is ~4 instructions for 4 calls, and a warp stores 128 contiguous
// bytes a row.
template <bool MASK, bool WIDE>
__global__ void __launch_bounds__(256)
fdrln_bits_kernel(void* __restrict__ out, DropArgs da, int n, int h,
                  int vec, unsigned quads, unsigned magic, unsigned shift,
                  long long total) {
  const Drop d = resolve(da);
  if (WIDE) {
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x)
      bits_lane<MASK>(out, d, da.tag, n, h, vec, (int)(t / quads),
                      (int)(t % quads) * 4);
    return;
  }
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (unsigned)total) return;
  const unsigned group = (__umulhi(t, magic) + t) >> shift;
  bits_lane<MASK>(out, d, da.tag, n, h, vec, (int)group,
                  (int)(t - group * quads) * 4);
}

template <bool MASK>
void launch_bits(void* out, const DropArgs& d, int n, int h,
                 cudaStream_t stream) {
  const unsigned quads = (unsigned)((h + 3) / 4);
  const long long total = (long long)((n + kRows - 1) / kRows) * quads;
  const int vec =
      h % 4 == 0 && reinterpret_cast<unsigned long long>(out) % 16 == 0;
  if (total >= (1ll << 31)) {
    fdrln_bits_kernel<MASK, true><<<132 * 16, 256, 0, stream>>>(
        out, d, n, h, vec, quads, 0u, 0u, total);
    return;
  }
  // magic number for t / quads (t < 2^31): shift = ceil(log2(quads)),
  // magic = floor(2^32 (2^shift - quads) / quads) + 1
  unsigned shift = 0;
  while ((1ull << shift) < quads) ++shift;
  const unsigned magic = (unsigned)(
      ((1ull << 32) * ((1ull << shift) - quads)) / quads + 1);
  fdrln_bits_kernel<MASK, false><<<(unsigned)((total + 255) / 256), 256, 0,
                                   stream>>>(out, d, n, h, vec, quads, magic,
                                             shift, total);
}

}  // namespace

// Forward. x, res [n, h]; bias, gamma, beta [h] (bias may be null: 0);
// with_ln = 0 writes z only (y, gamma, beta unused). dtypes: 2-bit codes
// 0 x, 1 res, 2 bias, 3 gamma, 4 beta (0 float32, 1 bfloat16, 2 float16;
// one 16-bit type a call); y and z take x's type.
// on: dropout with keep iff bits >= thr, kept values times scale. With LN
// at h <= 768 the warp-per-group kernel runs, else the CTA-per-group one.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_dropout_ln_fwd(const void* x, const void* res,
                                    const void* bias, const void* gamma,
                                    const void* beta, void* y, void* z,
                                    int n, int h, int dtypes, int with_ln,
                                    int on, unsigned thr, float scale,
                                    float eps, const unsigned long long* rng,
                                    unsigned rng_delta, cudaStream_t stream) {
  const int low = low_code(dtypes, 5);
  if (n < 1 || h < 1 || h > kMaxHd || low < 0)
    return (int)cudaErrorInvalidValue;
  const DropArgs d{on, thr, scale, rng, rng_delta, kTag};
  const int groups = (n + kRows - 1) / kRows;
  if (with_ln && h <= kColBlock) {
    // 16-byte accesses as in the backward
    int vec = h % kChunk == 0;
    const void* rows[4] = {x, res, y, z};
    for (const void* p : rows)
      if (reinterpret_cast<unsigned long long>(p) % 16) vec = 0;
    const FwdArgs a{x, res, bias, gamma, beta, y, z, n, h, vec, dtypes, d,
                    eps, stream};
    const int cx = code(dtypes, 0), cr = code(dtypes, 1);
    if (low == 2) {
      if (cx)
        return cr ? launch_fwd_ln<__half, __half>(a)
                  : launch_fwd_ln<__half, float>(a);
      if (cr) return launch_fwd_ln<float, __half>(a);
    } else {
      if (cx)
        return cr ? launch_fwd_ln<bf16, bf16>(a)
                  : launch_fwd_ln<bf16, float>(a);
      if (cr) return launch_fwd_ln<float, bf16>(a);
    }
    return launch_fwd_ln<float, float>(a);
  }
  if (with_ln) {
    const size_t smem = (size_t)kRows * h * sizeof(float);
    const int err =
        set_smem(fdrln_fwd_kernel<true>, smem, sizeof(float) * kRows * 32);
    if (err) return err;
    fdrln_fwd_kernel<true><<<groups, kThreads, smem, stream>>>(
        x, res, bias, gamma, beta, y, z, n, h, dtypes, d, eps);
  } else {
    fdrln_fwd_kernel<false><<<groups, kThreads, 0, stream>>>(
        x, res, bias, gamma, beta, y, z, n, h, dtypes, d, eps);
  }
  return (int)cudaGetLastError();
}

// Backward. z, dy [n, h], dz_extra [n, h] or null (0), gamma [h] (with_ln).
// dtypes: 2-bit codes 0 z, 1 dy, 2 dz_extra, 3 gamma as in the forward (one
// 16-bit type a call); dx and dres take z's type. part: float32 scratch [grid,
// 3 or 1, h], the CTAs' column sums of dx, dy * x^ and dy (with LN) or of dx
// alone; sums: [3 or 1, h] in z's type, their totals over the CTAs (a second,
// small kernel adds the partial rows in CTA order). grid: CTAs along the rows
// (one an SM, at most one per 4-row group), each warp walking the 4-row groups
// grid * 8 apart; past h = 768 the grid has a second axis of 768-column
// blocks.
extern "C" int fused_dropout_ln_bwd(const void* z, const void* dy,
                                    const void* dzx, const void* gamma,
                                    void* dx, void* dres, float* part,
                                    void* sums, int n, int h, int grid,
                                    int dtypes, int with_ln, int on,
                                    unsigned thr, float scale, float eps,
                                    const unsigned long long* rng,
                                    unsigned rng_delta, cudaStream_t stream) {
  if (n < 1 || h < 1 || h > kMaxHd || grid < 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte accesses: h % 8 == 0 (rows of 8-column chunks stay aligned)
  // and every row tensor 16-byte aligned
  int vec = h % kChunk == 0;
  const void* rows[5] = {z, dy, dzx, dx, dres};
  for (const void* p : rows)
    if (reinterpret_cast<unsigned long long>(p) % 16) vec = 0;
  const BwdArgs a{z, dy, dzx, gamma, dx, dres, part, n, h, grid, vec,
                  DropArgs{on, thr, scale, rng, rng_delta, kTag}, eps,
                  stream};
  const int err = pick(a, dtypes, with_ln);
  if (err) return err;
  const int m = (with_ln ? 3 : 1) * h;
  if (code(dtypes, 0) == 1)
    fdrln_colsum_kernel<<<(m + 255) / 256, 256, 0, stream>>>(
        part, static_cast<__nv_bfloat16*>(sums), grid, m);
  else if (code(dtypes, 0) == 2)
    fdrln_colsum_kernel<<<(m + 255) / 256, 256, 0, stream>>>(
        part, static_cast<__half*>(sums), grid, m);
  else
    fdrln_colsum_kernel<<<(m + 255) / 256, 256, 0, stream>>>(
        part, static_cast<float*>(sums), grid, m);
  return (int)cudaGetLastError();
}

// The dropout bits of the counter layout above for the key (rng[0],
// rng[1] + rng_delta) and counter word 2 `tag` (0: the fused kernels'
// kTag), [n, h]: with mask = 0 the bits as uint32 (the fused kernels' own
// for the checks), else the keep mask bits >= thr as bool (a dropout's
// mask drawn on the card: cuda_kernels.dropout_keep).
extern "C" int fused_dropout_bits(void* out, const unsigned long long* rng,
                                  unsigned rng_delta, unsigned tag, int n,
                                  int h, unsigned thr, int mask,
                                  cudaStream_t stream) {
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const DropArgs d{1, thr, 1.f, rng, rng_delta, tag ? tag : kTag};
  if (mask)
    launch_bits<true>(out, d, n, h, stream);
  else
    launch_bits<false>(out, d, n, h, stream);
  return (int)cudaGetLastError();
}
