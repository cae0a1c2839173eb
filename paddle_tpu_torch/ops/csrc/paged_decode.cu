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
// Dead tail: keys past lens are never loaded. Only rows 0..cl are read
// (every one is live, since cl <= lens), so garbage or NaN past lens
// cannot reach the output; this is stronger than the reference's
// select-to-zero of the append block's dead rows, which the plain PyTorch
// version keeps.
//
// What bounds it on the H100: bytes. One step reads each live K/V row once
// (2 * live * D * 4 bytes per slot and head for float32, a quarter of that
// plus 8 bytes of scales per row for int8); the arithmetic is ~0.5 flop
// per byte of float32 cache. At the serving shape (B=8, H=12, T=512,
// D=64, a few hundred live rows) that is a few MB, a couple of
// microseconds at the card's rate, so what limits a kernel in practice is
// memory latency: how many of those bytes it has in flight at once.
//
// The kernel: flash-decoding, one design for both caches. The key range
// 0..cl of each (slot, head) is split into chunks of CH keys, one CTA of 4
// warps per chunk (grid ceil(T / CH) x H x B; a CTA whose chunk starts past
// cl exits at once, since the host does not know lens). A key row is taken
// by G lanes, VEC elements a lane a load: 16 bytes (float4) for a float32
// cache, 4 bytes (char4) for an int8 one, where D % 4 == 0 and the caches
// are aligned to that width (G = the power of two >= D / 4, at least 4:
// at D = 64 a warp takes 2 keys a load), else G = 32 lanes of single
// elements. Each warp issues the K and V loads of all its 8 slots (8 * 32
// / G keys), and for int8 the keys' two scales, before it reduces the
// first, so a CTA has its whole chunk in flight, and the launch has every
// live row in flight over a few hundred CTAs. A warp forms its partial
// (m, l, acc[D]) with the reference's online-softmax algebra, the CTA
// combines its 4 warps' in shared memory, and the chunks' partials go to a
// float32 workspace; the last CTA of a (slot, head) to arrive (an atomic
// ticket per (slot, head), which it resets to 0 for the next call)
// combines them in chunk order: out = sum acc_c e^(m_c - M) / sum l_c
// e^(m_c - M). A (slot, head) of one chunk writes its output directly.
// The chunk that holds cl writes the appended row (quantized, for int8,
// with its two scales) to the cache and takes it from shared memory, never
// reading it back; no other CTA reads row cl. The wrapper owns the
// workspace and the tickets (cached per device and stream); the kernel
// allocates nothing. No shared array grows with T, so the kernel takes any
// cache depth.
//
// int8 geometry: a 64-byte row of int8 in 16-byte loads would take G = 4
// lanes, 8 keys a warp load and 256-key chunks, so at the serving lens
// (39-257) nearly every (slot, head) would be one CTA. 4-byte loads keep
// the float32 kernel's geometry (G = 16 at D = 64, chunks of 64 keys, the
// same live CTAs: cuda_kernels.paged_int8_geometry); the int8 values are
// widened to float32 after the load, k_scale multiplies a key's score
// after its D-dot, and v_scale the key's probability before the P V sum
// (l sums the probabilities without it), as `_paged_q_kernel` does.
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kSlots = 8;                // key loads in flight a lane
constexpr int kMaxD = 128;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Quantize one D-row with one warp: the int8 row goes to `dst` (the cache)
// and, widened, to `keep` (shared memory); returns the scale, in every
// lane. Mirrors cuda_kernels.quantize_kv exactly.
__device__ float quantize_row(const float* src, int8_t* dst, float* keep,
                              int D) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(src[d]));
  amax = warp_max(amax);
  const float scale = fmaxf(amax, 1e-8f) / 127.0f;
  for (int d = lane; d < D; d += 32) {
    const float r = fminf(fmaxf(rintf(src[d] / scale), -127.0f), 127.0f);
    dst[d] = (int8_t)r;
    keep[d] = r;
  }
  return scale;
}

// VEC elements of a cache row from global memory, as float32: one 16-byte
// load of floats or one 4-byte load of int8, or a single element
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = __ldg(p);
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const int8_t* p, float* v) {
  if constexpr (VEC == 4) {
    const char4 a = __ldg(reinterpret_cast<const char4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = __ldg(reinterpret_cast<const signed char*>(p));
  }
}

// G lanes take a key row, each C vectors of VEC elements: columns
// (gl + G c) VEC .. +VEC-1 of lane gl of its group. A warp takes 32 / G
// keys a load and kSlots loads, a CTA CH = 4 * kSlots * 32 / G keys
// (cuda_kernels.paged_split_geometry, paged_int8_geometry). CT is the
// cache's element type: float, or int8_t with float32 scales ksc / vsc.
template <typename CT, int G, int C, int VEC>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const float* __restrict__ q,
                   const float* __restrict__ nk,
                   const float* __restrict__ nv, long long qsb,
                   long long qsh, long long ksb, long long ksh,
                   long long vsb, long long vsh, CT* kc, CT* vc, float* ksc,
                   float* vsc, const int* __restrict__ lens,
                   float* __restrict__ out, float* part, unsigned* ticket,
                   int H, int T, int D, float sm_scale) {
  constexpr bool kQuant = sizeof(CT) == 1;
  constexpr int KPW = 32 / G;            // keys a warp load takes
  constexpr int CH = kSplitWarps * kSlots * KPW;
  constexpr int W = C * VEC;             // elements of a row a lane holds
  __shared__ __align__(16) float s_q[kMaxD];
  __shared__ __align__(16) float s_nk[kMaxD];
  __shared__ __align__(16) float s_nv[kMaxD];
  __shared__ __align__(16) float s_acc[kSplitWarps][kMaxD];
  __shared__ float s_m[kSplitWarps], s_l[kSplitWarps];
  __shared__ float s_ks, s_vs;
  __shared__ bool s_last;

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ln = min(max(lens[b], 0), T);
  const int cl = min(ln, T - 1);         // append row
  const int k0 = chunk * CH;
  if (k0 > cl) return;                   // no live key in this chunk
  const int nch = cl / CH + 1;           // live chunks of (b, h)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = (long long)b * H + h;
  const long long row0 = bh * T;         // first cache row of (b, h)
  const bool owner = cl < k0 + CH;       // this chunk holds the append row

  // the warp's keys: kw0 + KPW u + gi, u < kSlots. The loads of the cache
  // rows (those below cl; rows past cl are never loaded) and, for int8,
  // their scales are all issued first, so their latency overlaps the
  // query's; row cl comes from shared memory below.
  const int gi = lane / G, gl = lane % G;
  const int kw0 = k0 + warp * kSlots * KPW;
  float kr[kSlots][W], vr[kSlots][W];
  float kscale[kSlots], vscale[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const int j = kw0 + KPW * u + gi;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (gl + G * c) * VEC;
      if (col < D && j < cl) {
        load_vec<VEC>(kc + (row0 + j) * D + col, &kr[u][c * VEC]);
        load_vec<VEC>(vc + (row0 + j) * D + col, &vr[u][c * VEC]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          kr[u][c * VEC + e] = vr[u][c * VEC + e] = 0.f;
      }
    }
    if constexpr (kQuant) {
      kscale[u] = j < cl ? __ldg(ksc + row0 + j) : 0.f;
      vscale[u] = j < cl ? __ldg(vsc + row0 + j) : 0.f;
    }
  }

  // the query, scaled; the chunk holding cl appends the new row (in
  // place; for int8 quantized by warps 0 and 1) and keeps it in shared
  // memory for its own use
  for (int d = tid; d < D; d += kSplitThreads) {
    s_q[d] = q[b * qsb + h * qsh + d] * sm_scale;
    if constexpr (!kQuant) {
      if (owner) {
        const float kv = nk[b * ksb + h * ksh + d];
        const float vv = nv[b * vsb + h * vsh + d];
        s_nk[d] = kv;
        s_nv[d] = vv;
        kc[(row0 + cl) * D + d] = kv;
        vc[(row0 + cl) * D + d] = vv;
      }
    }
  }
  if constexpr (kQuant) {
    if (owner && warp == 0) {
      const float s = quantize_row(nk + b * ksb + h * ksh,
                                   kc + (row0 + cl) * D, s_nk, D);
      if (lane == 0) ksc[row0 + cl] = s_ks = s;
    } else if (owner && warp == 1) {
      const float s = quantize_row(nv + b * vsb + h * vsh,
                                   vc + (row0 + cl) * D, s_nv, D);
      if (lane == 0) vsc[row0 + cl] = s_vs = s;
    }
  }
  __syncthreads();

  float qv[W];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (gl + G * c) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qv[c * VEC + e] = col < D ? s_q[col + e] : 0.f;
  }
  if (owner) {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (kw0 + KPW * u + gi != cl) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = (gl + G * c) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kr[u][c * VEC + e] = col < D ? s_nk[col + e] : 0.f;
          vr[u][c * VEC + e] = col < D ? s_nv[col + e] : 0.f;
        }
      }
      if constexpr (kQuant) {
        kscale[u] = s_ks;
        vscale[u] = s_vs;
      }
    }
  }

  // the warp's partial: m = max score, l = sum e^(s - m), acc = sum
  // e^(s - m) v (times v_scale for int8); a warp with no live key keeps
  // m = -inf, l = acc = 0
  float s[kSlots], m = -INFINITY;
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) a = fmaf(qv[i], kr[u][i], a);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, o);
    if constexpr (kQuant) a *= kscale[u];
    s[u] = kw0 + KPW * u + gi <= cl ? a : -INFINITY;
    m = fmaxf(m, s[u]);
  }
#pragma unroll
  for (int o = 16; o >= G; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f, acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  if (m != -INFINITY) {                  // uniform across the warp
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const float p = expf(s[u] - m);    // 0 for a dead key
      l += p;
      const float pv = kQuant ? p * vscale[u] : p;
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = fmaf(pv, vr[u][i], acc[i]);
    }
  }
  // sum over the warp's key groups (lanes gl, gl + G, ...)
#pragma unroll
  for (int o = 16; o >= G; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int i = 0; i < W; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (gi == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (gl + G * c) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (col < D) s_acc[warp][col + e] = acc[c * VEC + e];
    }
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  // the CTA's partial, column d by thread d; M is finite, since the
  // chunk holds key k0 <= cl, and a warp at m = -inf weighs e^-inf = 0
  float M = s_m[0];
#pragma unroll
  for (int w = 1; w < kSplitWarps; ++w) M = fmaxf(M, s_m[w]);
  float L = 0.f, A = 0.f;
  if (tid < D) {
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float e = expf(s_m[w] - M);
      L += e * s_l[w];
      A += e * s_acc[w][tid];
    }
  }
  if (nch == 1) {
    if (tid < D) out[bh * D + tid] = A / L;
    return;
  }

  // several chunks: write the partial, and the last CTA to arrive
  // combines them all, in chunk order
  const int NC = gridDim.x;
  float* pacc = part + bh * NC * D;                  // [NC, D]
  float* pml = part + (long long)gridDim.y * gridDim.z * NC * D +
               bh * NC * 2;                          // [NC, 2]
  if (tid < D) pacc[chunk * D + tid] = A;
  if (tid == 0) {
    pml[2 * chunk] = M;
    pml[2 * chunk + 1] = L;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(ticket + bh, 1u) == (unsigned)(nch - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid < D) {
    float Mt = -INFINITY;
    for (int c = 0; c < nch; ++c) Mt = fmaxf(Mt, __ldcg(pml + 2 * c));
    float Lt = 0.f, At = 0.f;
    for (int c = 0; c < nch; ++c) {
      const float e = expf(__ldcg(pml + 2 * c) - Mt);
      Lt += e * __ldcg(pml + 2 * c + 1);
      At += e * __ldcg(pacc + c * D + tid);
    }
    out[bh * D + tid] = At / Lt;
  }
  if (tid == 0) ticket[bh] = 0;          // ready for the next call
}

template <typename CT, int G, int C, int VEC>
void launch_split(const float* q, const float* nk, const float* nv,
                  const long long* st, CT* kc, CT* vc, float* ksc,
                  float* vsc, const int* lens, float* out, float* part,
                  unsigned* ticket, int B, int H, int T, int D,
                  float sm_scale, cudaStream_t stream) {
  constexpr int CH = kSplitWarps * kSlots * (32 / G);
  const dim3 grid((T + CH - 1) / CH, H, B);
  paged_split_kernel<CT, G, C, VEC><<<grid, kSplitThreads, 0, stream>>>(
      q, nk, nv, st[0], st[1], st[2], st[3], st[4], st[5], kc, vc, ksc, vsc,
      lens, out, part, ticket, H, T, D, sm_scale);
}

// the geometry's instance: VEC-wide loads by `lanes` lanes a row (VEC = 4
// for 16-byte float or 4-byte int8 loads), or 32 lanes of single elements
template <typename CT, int VEC>
int launch_for(const float* q, const float* nk, const float* nv,
               const long long* st, CT* kc, CT* vc, float* ksc, float* vsc,
               const int* lens, float* out, float* part, unsigned* ticket,
               int B, int H, int T, int D, int lanes, int vec, float sm_scale,
               cudaStream_t stream) {
  const bool aligned =
      reinterpret_cast<unsigned long long>(kc) % (VEC * sizeof(CT)) == 0 &&
      reinterpret_cast<unsigned long long>(vc) % (VEC * sizeof(CT)) == 0;
#define SPLIT_LAUNCH(G, C, V)                                                \
  launch_split<CT, G, C, V>(q, nk, nv, st, kc, vc, ksc, vsc, lens, out,      \
                            part, ticket, B, H, T, D, sm_scale, stream)
  if (vec) {
    if (D % 4 || !aligned || 4 * lanes < D) return (int)cudaErrorInvalidValue;
    switch (lanes) {
      case 4: SPLIT_LAUNCH(4, 1, VEC); break;
      case 8: SPLIT_LAUNCH(8, 1, VEC); break;
      case 16: SPLIT_LAUNCH(16, 1, VEC); break;
      case 32: SPLIT_LAUNCH(32, 1, VEC); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    if (lanes != 32) return (int)cudaErrorInvalidValue;
    switch ((D + 31) / 32) {
      case 1: SPLIT_LAUNCH(32, 1, 1); break;
      case 2: SPLIT_LAUNCH(32, 2, 1); break;
      case 3: SPLIT_LAUNCH(32, 3, 1); break;
      default: SPLIT_LAUNCH(32, 4, 1); break;
    }
  }
#undef SPLIT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q/new_k/new_v: float32 [B, H, 1, D] given by (batch, head) element
// strides; caches [B, H, T, D] contiguous, float32 (quant=0) or int8
// (quant=1, with float32 scales [B, H, T]); lens int32 [B]; out float32
// [B, H, 1, D] contiguous. `lanes` (G) and `vec` (4-wide rows: float4 or
// char4) pick the geometry (cuda_kernels.paged_split_geometry,
// paged_int8_geometry), `part` is a float32 workspace of at least B * H *
// ceil(T / CH) * (D + 2) floats and `ticket` uint32 [B * H], all 0 before
// the call and after it. Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* new_k,
                            const void* new_v, const long long* strides,
                            void* k_cache, void* v_cache, void* k_scale,
                            void* v_scale, const void* lens, void* out,
                            void* part, void* ticket, int B, int H, int T,
                            int D, int lanes, int vec, float sm_scale,
                            int quant, cudaStream_t stream) {
  if (D < 1 || D > kMaxD || T < 1 || B < 1 || H < 1 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(new_k);
  const float* vv = static_cast<const float*>(new_v);
  const int* ll = static_cast<const int*>(lens);
  float* oo = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  unsigned* tt = static_cast<unsigned*>(ticket);
  if (quant)
    return launch_for<int8_t, 4>(
        qq, kk, vv, strides, static_cast<int8_t*>(k_cache),
        static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale),
        static_cast<float*>(v_scale), ll, oo, pp, tt, B, H, T, D, lanes, vec,
        sm_scale, stream);
  return launch_for<float, 4>(qq, kk, vv, strides,
                              static_cast<float*>(k_cache),
                              static_cast<float*>(v_cache), nullptr, nullptr,
                              ll, oo, pp, tt, B, H, T, D, lanes, vec,
                              sm_scale, stream);
}
