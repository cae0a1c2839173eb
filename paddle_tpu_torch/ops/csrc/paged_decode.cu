// Paged-decode attention for Hopper (sm_90a): one serving decode step.
//
// Replaces paddle_tpu/ops/pallas_kernels.py `_paged_f_kernel` (float cache)
// and `_paged_q_kernel` (int8 cache), both the body `_paged_core`, launched
// by `_paged_decode`. For each (slot b, head h), with lens[b] the live
// length BEFORE this token:
//   * append: the new k/v row lands at cl = min(lens, T-1) (the clamp of
//     the reference's dynamic_update_slice). For an int8 cache the row is
//     quantized here with cuda_kernels.quantize_kv's rule: scale =
//     max(absmax, 1e-8) / 127 in float32, x / scale with IEEE division,
//     round half to even (rintf), clip to +-127. The file is built without
//     --use_fast_math so this equals quantize_kv bit for bit;
//   * attend: the single query over keys pos <= lens (scores scaled by
//     D^-1/2; for int8, k_scale multiplies the scores and v_scale the
//     probabilities), float32 softmax.
// The cache is updated IN PLACE: only the appended row (and its scales) is
// written. The reference kernel returns new cache buffers instead, as JAX
// arrays are immutable.
//
// Dead tail: keys past lens are never loaded. The key loop stops at the
// append row cl (every row 0..cl is live, since cl <= lens), so garbage or
// NaN past lens cannot reach the output; this is stronger than the
// reference's select-to-zero of the append block's dead rows, which the
// plain PyTorch version keeps.
//
// Design: one CTA (8 warps) per (slot, head), reading only rows 0..cl.
// Pass 1: each warp scores 8 keys at a time (lanes split D, a coalesced
// row read per key, all 8 keys' loads in flight, shuffle reductions);
// scores go to shared memory. Pass 2: block max and sum. Pass 3: thread
// groups split the keys, each thread owns one output column and keeps 8
// V rows' loads in flight; partial sums are reduced in shared memory.
//
// What bounds it on the H100: bytes. One step reads each live K/V row once
// (2 * live * D * 4 bytes per slot and head for float32, a quarter of that
// plus 8 bytes of scales per row for int8); the arithmetic is ~0.5 flop
// per byte of float32 cache. At B*H = 96 CTAs the 132 SMs are underfilled
// and each CTA walks its keys in a few dependent rounds, so memory latency,
// not bandwidth, limits it; splitting the key range across CTAs
// (flash-decoding) is later work.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 8;                    // keys per warp in flight, pass 1

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reduction over all kThreads threads; `red` holds kWarps floats.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();                       // red may still be read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__device__ __forceinline__ float load_row(const float* p) { return *p; }
__device__ __forceinline__ float load_row(const int8_t* p) {
  return (float)*p;
}

// Quantize one D-row with warp 0 and write it at `dst`; returns the scale
// (valid in warp 0). Mirrors cuda_kernels.quantize_kv exactly.
__device__ float quantize_row(const float* src, int8_t* dst, int D) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(src[d]));
  amax = warp_max(amax);
  const float scale = fmaxf(amax, 1e-8f) / 127.0f;
  for (int d = lane; d < D; d += 32) {
    const float r = rintf(src[d] / scale);
    dst[d] = (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
  }
  return scale;
}

// DC = ceil(D / 32): head-dim columns each lane reads in pass 1.
template <typename C, bool kQuant, int DC>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ nk,
                    const float* __restrict__ nv, long long qsb,
                    long long qsh, long long ksb, long long ksh,
                    long long vsb, long long vsh, C* kc, C* vc, float* ksc,
                    float* vsc, const int* __restrict__ lens,
                    float* __restrict__ out, int H, int T, int D,
                    float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [D]
  float* red = qs + D;                   // [kWarps]
  float* pv = red + kWarps;              // [groups * D]
  const int groups = kThreads / D;
  float* sc = pv + groups * D;           // [T] scores, then probabilities

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ln = min(max(lens[b], 0), T);
  const int cl = min(ln, T - 1);         // append row
  const long long row0 = ((long long)b * H + h) * T;   // first row of (b,h)
  const float* qp = q + b * qsb + h * qsh;
  const float* nkp = nk + b * ksb + h * ksh;
  const float* nvp = nv + b * vsb + h * vsh;

  // append (in place), then the query, scaled
  if constexpr (kQuant) {
    if (warp == 0) {
      const float s = quantize_row(nkp, kc + (row0 + cl) * D, D);
      if (lane == 0) ksc[row0 + cl] = s;
    } else if (warp == 1) {
      const float s = quantize_row(nvp, vc + (row0 + cl) * D, D);
      if (lane == 0) vsc[row0 + cl] = s;
    }
  } else {
    for (int d = tid; d < D; d += kThreads) {
      kc[(row0 + cl) * D + d] = nkp[d];
      vc[(row0 + cl) * D + d] = nvp[d];
    }
  }
  for (int d = tid; d < D; d += kThreads) qs[d] = qp[d] * sm_scale;
  __syncthreads();                       // appended row visible block-wide

  // pass 1: scores of the live keys 0..cl, kU keys per warp in flight
  const int n = cl + 1;
  for (int j0 = warp * kU; j0 < n; j0 += kWarps * kU) {
    // no branch around the loads, so all kU rows are in flight at once:
    // keys past n re-read row n-1 (live) and their scores are dropped
    float part[kU], kscale[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = min(j0 + u, n - 1);
      const C* krow = kc + (row0 + j) * D;
      part[u] = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) part[u] = fmaf(qs[d], load_row(krow + d), part[u]);
      }
      if constexpr (kQuant) kscale[u] = ksc[row0 + j];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float sv = warp_sum(part[u]);
      if constexpr (kQuant) sv *= kscale[u];
      if (lane == 0 && j0 + u < n) sc[j0 + u] = sv;
    }
  }
  __syncthreads();

  // pass 2: softmax statistics; sc becomes p (times v_scale for int8)
  float mx = -INFINITY;
  for (int j = tid; j < n; j += kThreads) mx = fmaxf(mx, sc[j]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    const float p = expf(sc[j] - mx);
    sum += p;
    if constexpr (kQuant) sc[j] = p * vsc[row0 + j];
    else sc[j] = p;
  }
  sum = block_reduce<false>(sum, red);   // ends with a __syncthreads()

  // pass 3: out[d] = sum_j p_j v[j, d] / sum
  if (tid < groups * D) {
    const int g = tid / D, d = tid - g * D;
    float a = 0.f;
#pragma unroll 8
    for (int j = g; j < n; j += groups)
      a = fmaf(sc[j], load_row(vc + (row0 + j) * D + d), a);
    pv[g * D + d] = a;
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
    for (int g = 0; g < groups; ++g) a += pv[g * D + d];
    out[((long long)b * H + h) * D + d] = a / sum;
  }
}

}  // namespace

// q/new_k/new_v: float32 [B, H, 1, D] given by (batch, head) element
// strides; caches [B, H, T, D] contiguous, float32 (quant=0) or int8
// (quant=1, with float32 scales [B, H, T]); lens int32 [B]; out float32
// [B, H, 1, D] contiguous. Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* new_k,
                            const void* new_v, const long long* strides,
                            void* k_cache, void* v_cache, void* k_scale,
                            void* v_scale, const void* lens, void* out,
                            int B, int H, int T, int D, float sm_scale,
                            int quant, cudaStream_t stream) {
  if (D < 1 || D > 128 || T < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const int groups = kThreads / D;
  const size_t smem = sizeof(float) * (D + kWarps + groups * D + T);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(new_k);
  const float* vv = static_cast<const float*>(new_v);
  const int* ll = static_cast<const int*>(lens);
  float* oo = static_cast<float*>(out);
  int8_t* kq = static_cast<int8_t*>(k_cache);
  int8_t* vq = static_cast<int8_t*>(v_cache);
  float* kf = static_cast<float*>(k_cache);
  float* vf = static_cast<float*>(v_cache);
  float* ks = static_cast<float*>(k_scale);
  float* vs = static_cast<float*>(v_scale);
#define PAGED_LAUNCH(DC)                                                     \
  if (quant)                                                                 \
    paged_decode_kernel<int8_t, true, DC><<<grid, kThreads, smem, stream>>>( \
        qq, kk, vv, strides[0], strides[1], strides[2], strides[3],          \
        strides[4], strides[5], kq, vq, ks, vs, ll, oo, H, T, D, sm_scale);  \
  else                                                                       \
    paged_decode_kernel<float, false, DC><<<grid, kThreads, smem, stream>>>( \
        qq, kk, vv, strides[0], strides[1], strides[2], strides[3],          \
        strides[4], strides[5], kf, vf, nullptr, nullptr, ll, oo, H, T, D,   \
        sm_scale)
  switch ((D + 31) / 32) {
    case 1: PAGED_LAUNCH(1); break;
    case 2: PAGED_LAUNCH(2); break;
    case 3: PAGED_LAUNCH(3); break;
    default: PAGED_LAUNCH(4); break;
  }
#undef PAGED_LAUNCH
  return (int)cudaGetLastError();
}
