// Fused Adam / AdamW update for Hopper (sm_90a) over a list of tensors in
// one launch, in place on each parameter and both its moments.
//
// Replaces paddle_tpu/ops/pallas_kernels.py `_adamw_kernel` (launched by
// `fused_adamw_or_none`), whose arithmetic is the jnp rule of
// paddle_tpu/optimizer Adam/AdamW `_update_rule`:
//     p  = float(param) [* (1 - lr * coeff)]        (AdamW's decoupled decay)
//     m1 = b1 * m1 + (1 - b1) * g                   (g = float(grad)
//                                                    [* scale], the clip's)
//     m2 = b2 * m2 + (1 - b2) * (g * g)
//     param = p - lr * (m1 / c1) / (sqrt(m2 / c2) + eps)
// with c1 = 1 - b1^t and c2 = 1 - b2^t computed on the host in float32.
// lr, c1 and c2 change every step, so the kernel reads them from a float32
// device buffer [lr, c1, c2, go, scale] that the host fills before the
// step, as the TPU kernel reads `lr_ref` and `c_ref` from SMEM: a CUDA
// graph that captured the launch then applies each step's values on
// replay. `go` is the non-finite guard's word: the host stages 1, and a
// train step made with FLAGS_skip_nonfinite_steps overwrites it on the
// device with 0 when the loss or a gradient is not finite; at 0 the
// kernel writes nothing, so every parameter and moment keeps its value
// (the reference selects the old ones with jnp.where inside its
// executable). `scale` is ClipGradByGlobalNorm's clip_norm / max(global
// norm, clip_norm): the host stages 1, and a clipped step writes it on
// the device before the update; a tensor marked scaled takes g =
// float(grad) * scale, one float32 rounding, the reference's float32
// product of the gradient and its 0-d float32 scale (which a bfloat16
// gradient is never rounded back from), at no extra pass over the
// gradients.
//
// Each tensor of the list carries its own decoupled-decay coeff (AdamW's
// apply_decay_param_fun gives 0 to some: no decay multiply), its scaled
// bit (the clip's need_clip) and its lr factor (optimize_attr
// learning_rate): the kernel forms lr = __fmul_rn(buffer lr, factor), the
// optimizer's float32 product on the device, and 1 - lr * coeff
// (__fmul_rn, __fsub_rn), the host's float32 value bit for bit. Every
// operation is rounded on its own (__fmul_rn, __fdiv_rn, __fsqrt_rn, ...:
// no FMA contraction), so the kernel equals the plain PyTorch version op
// for op.
//
// The parameter is float32, bfloat16 or float16, the gradient any of the
// three (converted to float32 here), the moments float32: one template
// instance a (parameter, gradient) pair of types, one launch a pair. A
// float16 parameter takes the update rounded once from float32, as the
// reference's `.astype(param.dtype)` rounds it. Any numel: the TPU's
// rows-of-128 rule (`_adamw_rows_ok`) is not carried over.
//
// What bounds it on the H100: bytes. Each element reads param, grad, m1,
// m2 and writes param, m1, m2 once: 22 bytes for a bfloat16 parameter and
// gradient, 28 for float32, at ~10 flops, far below the card's ~300 flops
// per byte. A step's tensors are many and mostly small (the UNet's 446
// float32 tensors, most of them GroupNorm and bias vectors of 128-512
// elements), so one launch a tensor cost ~2.4 us each even replayed from
// a graph. What the design does about it: one launch for the whole list.
// The tensor table (pointers, sizes, per-tensor attributes) is the
// kernel's by-value parameter (__grid_constant__: read in place from the
// parameter bank, up to 32,764 bytes with CUDA >= 12.1), so a CUDA graph
// freezes it with no host-to-device copy, which a capture would refuse.
// The concatenated element space is cut into chunks of kChunk elements,
// one CTA a chunk; a CTA finds its tensor by a binary search over the
// table's chunk prefixes. Where a tensor's four pointers are 16-byte
// aligned, a thread moves kUnroll vectors of 4 elements (16-byte float32
// and 8-byte 16-bit accesses), all loaded before any is computed, with
// streaming cache hints (every byte is touched once); the tail past its
// last whole vector, and an unaligned tensor throughout, take single
// elements.
#include <cstddef>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                       // vectors a thread
constexpr int kChunk = kThreads * 4 * kUnroll;   // elements a CTA
#if CUDART_VERSION >= 12010
constexpr int kMaxTensors = 576;   // 53 bytes an entry: 30.5 KB of 32,764
#else
constexpr int kMaxTensors = 64;    // the older 4,096-byte parameter limit
#endif

// the launch's tensors; entry i's chunks are chunk0[i] .. chunk0[i + 1] - 1
struct Table {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  float* m1[kMaxTensors];
  float* m2[kMaxTensors];
  long long n[kMaxTensors];
  float coeff[kMaxTensors];          // 0: no decay multiply
  float lrf[kMaxTensors];            // lr factor
  int chunk0[kMaxTensors + 1];
  unsigned char flags[kMaxTensors];  // kScaled | kVec
};
constexpr unsigned char kScaled = 1, kVec = 2;

// the per-step values live in device memory (`sc`: lr, c1, c2, go, scale)
struct Hyper {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// 4 consecutive elements as float32, streamed: one 16-byte access of
// float32, one 8-byte access of a 16-bit type
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(*reinterpret_cast<const unsigned*>(&a),
                    *reinterpret_cast<const unsigned*>(&b)));
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  const __half2 a = __floats2half2_rn(v.x, v.y);
  const __half2 b = __floats2half2_rn(v.z, v.w);
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(*reinterpret_cast<const unsigned*>(&a),
                    *reinterpret_cast<const unsigned*>(&b)));
}

// one tensor's values for this step
struct Step {
  float lr, c1, c2, decay, scale;
  bool decays, scaled;
};

// the rule on one element, in place on p (widened), m1 and m2
__device__ __forceinline__ void update(float& p, float g, float& a, float& b,
                                       const Step& s, const Hyper& hp) {
  if (s.scaled) g = __fmul_rn(g, s.scale);
  if (s.decays) p = __fmul_rn(p, s.decay);
  a = __fadd_rn(__fmul_rn(hp.b1, a), __fmul_rn(hp.omb1, g));
  b = __fadd_rn(__fmul_rn(hp.b2, b), __fmul_rn(hp.omb2, __fmul_rn(g, g)));
  const float step = __fdiv_rn(
      __fmul_rn(s.lr, __fdiv_rn(a, s.c1)),
      __fadd_rn(__fsqrt_rn(__fdiv_rn(b, s.c2)), hp.eps));
  p = __fsub_rn(p, step);
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Table tab, int count,
             const float* __restrict__ sc, Hyper hp) {
  if (__ldg(sc + 3) == 0.f) return;        // the guard skipped this step
  // this CTA's tensor: the last entry whose first chunk is <= blockIdx.x
  const int c = blockIdx.x;
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.chunk0[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  const long long begin = (long long)(c - tab.chunk0[lo]) * kChunk;
  const long long left = tab.n[lo] - begin;
  const int len = left < kChunk ? (int)left : kChunk;
  P* __restrict__ param = static_cast<P*>(tab.p[lo]) + begin;
  const G* __restrict__ grad = static_cast<const G*>(tab.g[lo]) + begin;
  float* __restrict__ m1 = tab.m1[lo] + begin;
  float* __restrict__ m2 = tab.m2[lo] + begin;
  const unsigned char flags = tab.flags[lo];
  Step s;
  s.lr = __fmul_rn(__ldg(sc), tab.lrf[lo]);
  s.c1 = __ldg(sc + 1);
  s.c2 = __ldg(sc + 2);
  s.decays = tab.coeff[lo] != 0.f;
  s.decay = __fsub_rn(1.f, __fmul_rn(s.lr, tab.coeff[lo]));
  s.scaled = flags & kScaled;
  s.scale = s.scaled ? __ldg(sc + 4) : 1.f;
  int tail = 0;                            // the first single element
  if (flags & kVec) {
    tail = len & ~3;
    float4 pv[kUnroll], gv[kUnroll], av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = (u * kThreads + threadIdx.x) * 4;
      if (i < tail) {
        pv[u] = load4(param + i);
        gv[u] = load4(grad + i);
        av[u] = load4(m1 + i);
        bv[u] = load4(m2 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = (u * kThreads + threadIdx.x) * 4;
      if (i < tail) {
        update(pv[u].x, gv[u].x, av[u].x, bv[u].x, s, hp);
        update(pv[u].y, gv[u].y, av[u].y, bv[u].y, s, hp);
        update(pv[u].z, gv[u].z, av[u].z, bv[u].z, s, hp);
        update(pv[u].w, gv[u].w, av[u].w, bv[u].w, s, hp);
        store4(param + i, pv[u]);
        store4(m1 + i, av[u]);
        store4(m2 + i, bv[u]);
      }
    }
  }
  for (int i = tail + threadIdx.x; i < len; i += kThreads) {
    float p = to_f(param[i]), a = m1[i], b = m2[i];
    update(p, to_f(grad[i]), a, b, s, hp);
    store(param + i, p);
    m1[i] = a;
    m2[i] = b;
  }
}

template <typename P, typename G>
int launch(const Table& tab, int count, const float* sc, const Hyper& hp,
           cudaStream_t stream) {
  adamw_kernel<P, G><<<tab.chunk0[count], kThreads, 0, stream>>>(
      tab, count, sc, hp);
  return (int)cudaGetLastError();
}

template <typename P>
int pick_g(int gtype, const Table& tab, int count, const float* sc,
           const Hyper& hp, cudaStream_t stream) {
  if (gtype == 0) return launch<P, float>(tab, count, sc, hp, stream);
  if (gtype == 1)
    return launch<P, __nv_bfloat16>(tab, count, sc, hp, stream);
  if (gtype == 2) return launch<P, __half>(tab, count, sc, hp, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The table's layout for the host that packs it: out[0] sizeof(Table),
// out[1] kMaxTensors, out[2] kChunk, out[3..11] the offsets of p, g, m1,
// m2, n, coeff, lrf, chunk0 and flags.
extern "C" int adamw_table_layout(long long* out) {
  out[0] = sizeof(Table);
  out[1] = kMaxTensors;
  out[2] = kChunk;
  out[3] = offsetof(Table, p);
  out[4] = offsetof(Table, g);
  out[5] = offsetof(Table, m1);
  out[6] = offsetof(Table, m2);
  out[7] = offsetof(Table, n);
  out[8] = offsetof(Table, coeff);
  out[9] = offsetof(Table, lrf);
  out[10] = offsetof(Table, chunk0);
  out[11] = offsetof(Table, flags);
  return 0;
}

// One launch over `count` tensors of one (parameter, gradient) type pair.
// table: a host Table (adamw_table_layout) whose chunk0 holds the chunk
// prefixes of kChunk elements, chunk0[count] the launch's CTAs; it is
// copied into the launch's parameters, so the host may reuse it at once.
// ptype / gtype: 0 float32, 1 bfloat16, 2 float16. sc: float32 [4] or [5]
// in device memory, the step's lr, c1, c2, go (0: write nothing) and the
// clip scale (read only for an entry marked scaled). The betas, 1 - beta
// and eps are float32 values computed by the caller. Returns
// cudaGetLastError() after the launch.
extern "C" int adamw_multi(const void* table, int count, int ptype,
                           int gtype, const float* sc, float b1, float omb1,
                           float b2, float omb2, float eps,
                           cudaStream_t stream) {
  const Table& tab = *static_cast<const Table*>(table);
  if (count < 1 || count > kMaxTensors || tab.chunk0[0] != 0 ||
      tab.chunk0[count] < count)
    return (int)cudaErrorInvalidValue;
  const Hyper hp{b1, omb1, b2, omb2, eps};
  if (ptype == 0) return pick_g<float>(gtype, tab, count, sc, hp, stream);
  if (ptype == 1)
    return pick_g<__nv_bfloat16>(gtype, tab, count, sc, hp, stream);
  if (ptype == 2) return pick_g<__half>(gtype, tab, count, sc, hp, stream);
  return (int)cudaErrorInvalidValue;
}
