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
// All arithmetic is float32; each of x, residual, bias, gamma, beta (and
// z, dy, dz_extra, gamma) is float32 or bfloat16 on its own (bit i of
// `dtypes`). Hd <= 8192 (the backward's shared memory; the wrapper
// refuses more). IEEE division and square root (no --use_fast_math), so
// rstd is 1 / sqrtf, not the approximate rsqrtf.
//
// The dropout bits are Philox-4x32-10 (attn_dropout.cuh) keyed by the
// call's 64-bit seed with the counter (col, row / 4, kTag, call offset) and
// word row % 4 of the result: a function of the element alone, so the
// backward regenerates the forward's mask from the saved (seed, offset)
// whatever its launch shape. The TPU kernels seed their PRNG with seed +
// program id, so there forward and backward must share the row block
// (:917-919); here they need not. kTag is above any batch*head index, so
// no attention call draws the same counter.
//
// The reference leaves dbias, dgamma and dbeta to XLA column reductions
// outside the kernel (:924-933). Here the backward folds them in: each CTA
// walks a strided set of 4-row groups, sums dx (as stored), dy * x^ and dy
// per column in shared memory, and writes one float32 partial row per
// column sum; the wrapper adds the grid's partial rows (a few hundred).
//
// Design: one CTA of 256 threads per group of 4 rows (the forward) or per
// strided set of groups (the backward). A thread owns columns tid,
// tid + 256, ... of all 4 rows, so one Philox call per column gives the
// bits of the group's 4 rows. The row sums go through warp shuffles and
// one shared-memory step (4 rows at once). With LN the rows' float32 z
// (forward) or z then x^ (backward) sit in shared memory between passes;
// the backward reads dy twice (the second time from L2).
//
// What bounds it on the H100: bytes. At the GPT-2 shapes (N = 8192 rows,
// Hd = 768, bfloat16) the forward with LN reads x and the residual and
// writes y and z (4 x 12.6 MB), without LN one output fewer, and the
// backward reads z, dy and dz_extra and writes dx and dres (5 x 12.6 MB);
// about 20 flops per element against the card's ~300 per byte. What the
// design does about it: one pass over device memory per call, the mask
// never stored, the LN statistics recomputed from z rather than saved;
// vector loads and a warp per row are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attn_dropout.cuh"

namespace {

constexpr int kRows = 4;         // rows per group: one Philox call's words
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 8192;
constexpr unsigned kTag = 0xFD1D0000u;   // counter word 2; > any b*h index

struct Drop {
  int on;
  unsigned thr;
  float scale;
  unsigned long long seed;
  unsigned offset;
};

__device__ __forceinline__ float ld(const void* p, int bf, size_t i) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, int bf, size_t i, float v) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// v as stored in the type (bf: bfloat16), widened back
__device__ __forceinline__ float stored(int bf, float v) {
  return bf ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ uint4 bits4(const Drop& d, int group, int col) {
  return attn_dropout::philox4x32_10(
      make_uint4((unsigned)col, (unsigned)group, kTag, d.offset),
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
                 void* __restrict__ z, int n, int h, int dt, Drop d,
                 float eps) {
  extern __shared__ float zs[];            // LN: kRows * h float32 z
  __shared__ float red[kRows * 32];
  const int xb = dt & 1, rb = (dt >> 1) & 1, bb = (dt >> 2) & 1;
  const int gb = (dt >> 3) & 1, eb = (dt >> 4) & 1;
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

template <bool LN>
__global__ void __launch_bounds__(kThreads)
fdrln_bwd_kernel(const void* __restrict__ z, const void* __restrict__ dy,
                 const void* __restrict__ dzx,
                 const void* __restrict__ gamma, void* __restrict__ dx,
                 void* __restrict__ dres, float* __restrict__ part, int n,
                 int h, int dt, Drop d, float eps) {
  extern __shared__ float sm[];
  float* xs = sm;                            // LN: kRows * h, z then x^
  float* acc = sm + (LN ? kRows * h : 0);    // per column: dbias, dgamma, dbeta
  __shared__ float red[kRows * 32];
  constexpr int nacc = LN ? 3 : 1;
  const int zb = dt & 1, yb = (dt >> 1) & 1, eb = (dt >> 2) & 1;
  const int gb = (dt >> 3) & 1;
  for (int c = threadIdx.x; c < h; c += kThreads)
#pragma unroll
    for (int k = 0; k < nacc; ++k) acc[k * h + c] = 0.f;
  const int groups = (n + kRows - 1) / kRows;
  for (int group = blockIdx.x; group < groups; group += gridDim.x) {
    const int row0 = group * kRows, rows = min(kRows, n - row0);
    float rstd[kRows], ma[kRows], max_[kRows];
    if (LN) {
      float s[kRows] = {0.f, 0.f, 0.f, 0.f};
      for (int c = threadIdx.x; c < h; c += kThreads) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float zv =
              r < rows ? ld(z, zb, (size_t)(row0 + r) * h + c) : 0.f;
          xs[r * h + c] = zv;
          s[r] += zv;
        }
      }
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
          const float dd = xs[r * h + c] - mean[r];
          v[r] += dd * dd;
        }
      }
      block_sum4(v, red);
      float sa[kRows], sax[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        rstd[r] = 1.0f / sqrtf(v[r] / (float)h + eps);
        sa[r] = sax[r] = 0.f;
      }
      for (int c = threadIdx.x; c < h; c += kThreads) {
        const float g = ld(gamma, gb, c);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r >= rows) break;
          const float xh = (xs[r * h + c] - mean[r]) * rstd[r];
          xs[r * h + c] = xh;
          const float dyv = ld(dy, yb, (size_t)(row0 + r) * h + c);
          const float a = dyv * g;
          sa[r] += a;
          sax[r] += a * xh;
          acc[h + c] += dyv * xh;
          acc[2 * h + c] += dyv;
        }
      }
      block_sum4(sa, red);
      block_sum4(sax, red);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ma[r] = sa[r] / (float)h;
        max_[r] = sax[r] / (float)h;
      }
    }
    for (int c = threadIdx.x; c < h; c += kThreads) {
      uint4 w = make_uint4(0, 0, 0, 0);
      if (d.on) w = bits4(d, group, c);
      const float g = LN ? ld(gamma, gb, c) : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows) break;
        const size_t i = (size_t)(row0 + r) * h + c;
        float dz = ld(dy, yb, i);
        if (LN)
          dz = rstd[r] * (dz * g - ma[r] - xs[r * h + c] * max_[r]);
        if (dzx) dz += ld(dzx, eb, i);
        st(dres, zb, i, dz);
        float dxv = dz;
        if (d.on) dxv = attn_dropout::word(w, r) >= d.thr ? dz * d.scale : 0.f;
        st(dx, zb, i, dxv);
        acc[c] += stored(zb, dxv);
      }
    }
  }
  for (int c = threadIdx.x; c < h; c += kThreads)
#pragma unroll
    for (int k = 0; k < nacc; ++k)
      part[((size_t)blockIdx.x * nacc + k) * h + c] = acc[k * h + c];
}

__global__ void fdrln_bits_kernel(unsigned* __restrict__ out, Drop d, int n,
                                  int h) {
  const int groups = (n + kRows - 1) / kRows;
  const long long total = (long long)groups * h;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int group = (int)(t / h), c = (int)(t % h);
    const uint4 w = bits4(d, group, c);
    for (int r = 0; r < kRows && group * kRows + r < n; ++r)
      out[(size_t)(group * kRows + r) * h + c] = attn_dropout::word(w, r);
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Forward. x, res [n, h]; bias, gamma, beta [h] (bias may be null: 0);
// with_ln = 0 writes z only (y, gamma, beta unused). dtypes: bit 0 x,
// 1 res, 2 bias, 3 gamma, 4 beta set for bfloat16; y and z take x's type.
// on: dropout with keep iff bits >= thr, kept values times scale. Returns
// cudaGetLastError() after the launch.
extern "C" int fused_dropout_ln_fwd(const void* x, const void* res,
                                    const void* bias, const void* gamma,
                                    const void* beta, void* y, void* z,
                                    int n, int h, int dtypes, int with_ln,
                                    int on, unsigned thr, float scale,
                                    float eps, unsigned long long seed,
                                    unsigned offset, cudaStream_t stream) {
  if (n < 1 || h < 1 || h > kMaxHd) return (int)cudaErrorInvalidValue;
  const Drop d{on, thr, scale, seed, offset};
  const int groups = (n + kRows - 1) / kRows;
  if (with_ln) {
    const size_t smem = (size_t)kRows * h * sizeof(float);
    const int err = set_smem(fdrln_fwd_kernel<true>, smem);
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
// dtypes: bit 0 z, 1 dy, 2 dz_extra, 3 gamma for bfloat16; dx and dres
// take z's type. part: float32 [grid, 3 or 1, h], the CTAs' column sums
// of dx, dy * x^ and dy (with LN) or of dx alone. grid: CTAs, each walking
// the 4-row groups grid apart.
extern "C" int fused_dropout_ln_bwd(const void* z, const void* dy,
                                    const void* dzx, const void* gamma,
                                    void* dx, void* dres, float* part, int n,
                                    int h, int grid, int dtypes, int with_ln,
                                    int on, unsigned thr, float scale,
                                    float eps, unsigned long long seed,
                                    unsigned offset, cudaStream_t stream) {
  if (n < 1 || h < 1 || h > kMaxHd || grid < 1)
    return (int)cudaErrorInvalidValue;
  const Drop d{on, thr, scale, seed, offset};
  if (with_ln) {
    const size_t smem = (size_t)(kRows + 3) * h * sizeof(float);
    const int err = set_smem(fdrln_bwd_kernel<true>, smem);
    if (err) return err;
    fdrln_bwd_kernel<true><<<grid, kThreads, smem, stream>>>(
        z, dy, dzx, gamma, dx, dres, part, n, h, dtypes, d, eps);
  } else {
    const size_t smem = (size_t)h * sizeof(float);
    fdrln_bwd_kernel<false><<<grid, kThreads, smem, stream>>>(
        z, dy, dzx, gamma, dx, dres, part, n, h, dtypes, d, eps);
  }
  return (int)cudaGetLastError();
}

// The dropout bits the kernels draw for (seed, offset), written out as
// uint32 [n, h] for the checks.
extern "C" int fused_dropout_bits(unsigned* out, unsigned long long seed,
                                  unsigned offset, int n, int h,
                                  cudaStream_t stream) {
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const Drop d{1, 0u, 1.f, seed, offset};
  const long long total = (long long)((n + kRows - 1) / kRows) * h;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fdrln_bits_kernel<<<(int)blocks, 256, 0, stream>>>(out, d, n, h);
  return (int)cudaGetLastError();
}
