// Flash-attention forward for Hopper (sm_90a), float32 accumulation, with
// the training options: an lse output and attention dropout.
//
// Replaces paddle_tpu/ops/pallas_kernels.py `_flash_fwd_kernel` (launched by
// `_flash_fwd`): out = softmax(Q K^T * D^-1/2) V per (batch*head), online
// softmax over K/V tiles, causal mask aligned bottom-right (a query row i
// sees keys j <= i + Tk - Tq), tiles past the diagonal skipped. The TPU
// kernel carries its softmax state across a sequential grid axis; here one
// block loops over the key tiles itself.
//
// Training options (both off on the serving path, where no lse pointer is
// passed and the dropout branch is compiled out):
//   * lse [B*H, Tq] float32 = m + log l of the scaled scores, the one
//     number per row the backward kernels need. The TPU kernel stores it
//     broadcast over 128 lanes ([B*H, Tq, 128]) because a TPU vector store
//     is 128 lanes wide; a CUDA thread stores one float, so the port keeps
//     one value per row (128x fewer bytes).
//   * dropout at p: the keep mask (attn_dropout.cuh, Philox bits per
//     element) scales the exp-scores of the P V product only; the softmax
//     denominator l sums the undropped scores, which equals
//     dropout(softmax(s)) V exactly, as `_flash_fwd_kernel` computes it.
//
// Design: one CTA (4 warps) per (batch*head, 16-row query tile). Each K/V
// tile of 32 keys is staged in shared memory as float32: every warp loads
// 8 of its rows with all loads issued before the first store, so the tile
// costs one memory latency, not one per element. Each warp owns 4 query
// rows and scores them together: lane l takes key l of the tile, reads its
// K row once per 4 head-dim values (float4, rows padded to a stride of
// D4 + 4 floats so a quarter-warp hits 32 distinct banks) and the 4 query
// rows as broadcasts. The warp reduces max and sum with shuffles per row;
// for P V, lane l accumulates output columns l, l+32, ... of all 4 rows in
// registers. The warp's 4 rows are 4-aligned, so one Philox call per lane
// and tile gives the dropout bits of all 4 rows. Any Tq/Tk is allowed: the
// ragged edge is masked, rows past Tq are computed and not stored. D <= 128.
//
// What bounds it on the H100: at the serving prefill shapes (B=1, H=12,
// T <= 256, D=64) the work is ~0.1 GFLOP and ~3 MB, a bound of about two
// microseconds, so the kernel is latency-bound (24 to 192 CTAs on 132 SMs);
// at the training shapes (B=16, H=12, T=512, D=64, causal) it is 6.4 GFLOP
// against 25 MB, bound by operations. Its FMAs run on the CUDA cores, not
// the tensor cores. What the design does about it: it never writes the
// [Tq, Tk] scores or the dropout mask to device memory, skips the tiles
// above the diagonal, keeps every tile load in flight at once and reuses
// each shared-memory K value for 4 rows; moving QK^T and PV onto wgmma
// with bf16 tiles is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attn_dropout.cuh"

namespace {

constexpr int kBQ = 16;                  // query rows per CTA
constexpr int kBK = 32;                  // keys per tile (one per lane)
constexpr int kWarps = 4;
constexpr int kR = kBQ / kWarps;         // query rows per warp
constexpr int kLoadRows = kBK / kWarps;  // tile rows each warp loads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// DC = ceil(D / 32): head-dim columns each lane loads and accumulates.
template <typename T, int DC, bool DROP>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse,
                 long long qsb, long long qsh, long long qst,
                 long long ksb, long long ksh, long long kst,
                 long long vsb, long long vsh, long long vst,
                 long long osb, long long osh, long long ost,
                 int H, int Tq, int Tk, int D, int causal, float sm_scale,
                 unsigned drop_thr, float drop_scale,
                 unsigned long long seed, unsigned offset) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = pad4(D);                // head dim padded to float4
  const int KP = D4 + 4;                 // K row stride, bank-conflict free
  float* qs = smem;                      // [kBQ][D4], scaled, zero-padded
  float* ks = qs + kBQ * D4;             // [kBK][KP], zero-padded
  float* vs = ks + kBK * KP;             // [kBK][D]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  T* op = o + b * osb + h * osh;

  // this warp's 4 query rows, scaled by D^-1/2 as the TPU kernel does
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int r = warp * kR + rr, qr = q0 + r;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D4)
        qs[r * D4 + d] =
            (qr < Tq && d < D) ? to_f(qp[qr * qst + d]) * sm_scale : 0.f;
    }
  }

  float acc[kR][DC];
  float m[kR], l[kR];
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[rr][c] = 0.f;
  }

  const int shift = Tk - Tq;
  int kend = Tk;
  if (causal) kend = min(Tk, q0 + kBQ + shift);   // last row's bound, excl.
  const float* qrow = qs + warp * kR * D4;
  const float* krow = ks + lane * KP;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    // issue every load of this warp's 8 tile rows, then store them
    float kreg[kLoadRows][DC], vreg[kLoadRows][DC];
#pragma unroll
    for (int i = 0; i < kLoadRows; ++i) {
      const int kr = k0 + warp + kWarps * i;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        const bool ok = kr < Tk && d < D;
        kreg[i][c] = ok ? to_f(kp[kr * kst + d]) : 0.f;
        vreg[i][c] = ok ? to_f(vp[kr * vst + d]) : 0.f;
      }
    }
    __syncthreads();                     // previous tile fully consumed
#pragma unroll
    for (int i = 0; i < kLoadRows; ++i) {
      const int r = warp + kWarps * i;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < D4) ks[r * KP + d] = kreg[i][c];
        if (d < D) vs[r * D + d] = vreg[i][c];
      }
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's 4 rows
    float s[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) s[rr] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + rr * D4 + d);
        s[rr] = fmaf(qv.x, kv.x, s[rr]);
        s[rr] = fmaf(qv.y, kv.y, s[rr]);
        s[rr] = fmaf(qv.z, kv.z, s[rr]);
        s[rr] = fmaf(qv.w, kv.w, s[rr]);
      }
    }

    // online softmax per row
    const int kpos = k0 + lane;
    uint4 bits;
    if (DROP) bits = attn_dropout::bits4(seed, offset, bh, (q0 >> 2) + warp,
                                         kpos);
    float p[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int qpos = q0 + warp * kR + rr;
      const bool ok = kpos < Tk && (!causal || kpos <= qpos + shift);
      const float sv = ok ? s[rr] : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      // a row with no live key yet keeps m = -inf; subtract 0 then so
      // exp() sees -inf and yields 0 instead of NaN
      const float m_sub = m_new == -INFINITY ? 0.f : m_new;
      p[rr] = ok ? expf(sv - m_sub) : 0.f;
      const float alpha = expf(m[rr] - m_sub);
      l[rr] = l[rr] * alpha + warp_sum(p[rr]);
      m[rr] = m_new;
      // the denominator took the undropped score; P V takes the dropped one
      if (DROP)
        p[rr] = attn_dropout::word(bits, rr) >= drop_thr ? p[rr] * drop_scale
                                                         : 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[rr][c] *= alpha;
    }

    // acc += P V: lane owns columns lane + 32c of all 4 rows
#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      const float* vrow = vs + j * D;
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? vrow[d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const float pj = __shfl_sync(0xffffffffu, p[rr], j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[rr][c] = fmaf(pj, vv[c], acc[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int qpos = q0 + warp * kR + rr;
    if (qpos >= Tq) continue;
    if (lse != nullptr && lane == 0)
      lse[(long long)bh * Tq + qpos] = m[rr] + logf(l[rr]);
    const float inv = 1.f / l[rr];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(op + qpos * ost + d, acc[rr][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int H, int Tq, int Tk, int D,
           int causal, float sm_scale, int dropout, unsigned drop_thr,
           float drop_scale, unsigned long long seed, unsigned offset,
           cudaStream_t stream) {
  if (D < 1 || D > 128 || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  const dim3 block(kWarps * 32);
  const size_t smem =
      sizeof(float) * (kBQ * pad4(D) + kBK * (pad4(D) + 4) + kBK * D);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
#define FLASH_LAUNCH(DC, DROP)                                               \
  flash_fwd_kernel<T, DC, DROP><<<grid, block, smem, stream>>>(              \
      qq, kk, vv, oo, lse, st[0], st[1], st[2], st[3], st[4], st[5], st[6],  \
      st[7], st[8], st[9], st[10], st[11], H, Tq, Tk, D, causal, sm_scale,   \
      drop_thr, drop_scale, seed, offset)
#define FLASH_LAUNCH_DC(DROP)                                                \
  switch ((D + 31) / 32) {                                                   \
    case 1: FLASH_LAUNCH(1, DROP); break;                                    \
    case 2: FLASH_LAUNCH(2, DROP); break;                                    \
    case 3: FLASH_LAUNCH(3, DROP); break;                                    \
    default: FLASH_LAUNCH(4, DROP); break;                                   \
  }
  if (dropout) {
    FLASH_LAUNCH_DC(true)
  } else {
    FLASH_LAUNCH_DC(false)
  }
#undef FLASH_LAUNCH_DC
#undef FLASH_LAUNCH
  return (int)cudaGetLastError();
}

// Bits of the dropout mask, [B*H, Tq, Tk] uint32: one thread per (column,
// 4-row group), the counter layout of attn_dropout.cuh.
__global__ void attn_dropout_bits_kernel(unsigned* __restrict__ out,
                                         unsigned long long seed,
                                         unsigned offset, int Tq, int Tk) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int group = blockIdx.y, bh = blockIdx.z;
  if (col >= Tk) return;
  const uint4 r = attn_dropout::bits4(seed, offset, bh, group, col);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * group + i;
    if (row < Tq)
      out[((long long)bh * Tq + row) * Tk + col] = attn_dropout::word(r, i);
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, time) for q, k, v, o in turn;
// the head_dim stride must be 1. dtype: 0 float32, 1 bfloat16. lse: null,
// or [B*H, Tq] float32. dropout: 0 off, else keep iff bits >= drop_thr and
// kept values times drop_scale, bits keyed by (seed, offset).
// Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, const long long* strides,
                         int B, int H, int Tq, int Tk, int D, int causal,
                         float sm_scale, int dtype, int dropout,
                         unsigned drop_thr, float drop_scale,
                         unsigned long long seed, unsigned offset,
                         cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, strides, B, H, Tq, Tk, D, causal,
                         sm_scale, dropout, drop_thr, drop_scale, seed,
                         offset, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, strides, B, H, Tq, Tk, D,
                                 causal, sm_scale, dropout, drop_thr,
                                 drop_scale, seed, offset, stream);
  return (int)cudaErrorInvalidValue;
}

// out: [BH, Tq, Tk] uint32 (stored in an int32 tensor).
extern "C" int attn_dropout_bits(void* out, unsigned long long seed,
                                 unsigned offset, int BH, int Tq, int Tk,
                                 cudaStream_t stream) {
  if (BH < 1 || Tq < 1 || Tk < 1 || BH > 65535 || (Tq + 3) / 4 > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tk + 127) / 128, (Tq + 3) / 4, BH);
  attn_dropout_bits_kernel<<<grid, 128, 0, stream>>>(
      static_cast<unsigned*>(out), seed, offset, Tq, Tk);
  return (int)cudaGetLastError();
}
