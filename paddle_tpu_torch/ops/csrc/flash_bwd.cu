// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, float32
// accumulation, optional attention dropout.
//
// Replaces paddle_tpu/ops/pallas_kernels.py `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (both launched by `_flash_bwd`). With s the
// scaled scores, p = exp(s - lse) (lse from the training forward), the
// dropout keep mask M scaled by 1/(1-p_drop) (attn_dropout.cuh, the same
// bits the forward used), dP = M o (dO V^T), Delta = rowsum(dO o O) and
// dS = p o (dP - Delta) * D^-1/2:
//     dq = dS K,   dk = dS^T Q,   dv = (M o p)^T dO.
// Two kernels, two passes, no atomics, as on the TPU:
//   * flash_bwd_dq: one CTA per (batch*head, 16-row query tile), looping
//     over the K/V tiles up to the causal diagonal. It also computes Delta
//     for its rows and writes it, [B*H, Tq] float32: Delta is computed
//     once per row here instead of once per (row, key tile) as the TPU
//     kernels recompute it, and costs no launch of its own.
//   * flash_bwd_dkv: one CTA per (batch*head, 16-key tile), looping over
//     the Q/dO tiles from the causal lower bound (first row that sees the
//     tile's first key, (k0 - shift) rounded down to a tile) to Tq. It
//     reads the Delta the dq kernel wrote, so it runs after it on the same
//     stream.
// Causal masking is bottom-right aligned (shift = Tk - Tq, Tk >= Tq); any
// Tq/Tk, ragged tiles masked; D <= 128; float32 or bfloat16 in and out.
//
// Design: the layout of the forward kernel. In dq, each of 4 warps owns 4
// query rows (q pre-scaled, and dO, in shared memory, read as broadcasts);
// lane l takes key l of a 32-key tile and computes s and dP for the warp's
// 4 rows from its own K and V rows (float4 reads, rows padded to D4 + 4
// floats); the warp then accumulates dq += dS K with lane l owning columns
// l, l+32, ... In dkv the roles turn around: each warp owns 4 keys (K
// pre-scaled, and V, read as broadcasts), lane l takes query row l of a
// 32-row Q/dO tile, and lane l accumulates columns l, l+32, ... of dk and
// dv for the warp's 4 keys. The dropout bits of a warp's 4 x 32 elements
// come from 32 Philox calls, one per lane, shared with shuffles.
//
// What bounds it on the H100: at the training shapes (B=16, H=12, T=512,
// D=64, causal) the two kernels do 7 * D FMAs per live (row, key) pair,
// ~11 GFLOP against ~40 MB, so they are bound by operations, and they run
// on the CUDA cores (67 TFLOP/s float32), not the tensor cores. What the
// design does about it: nothing of size [Tq, Tk] (scores, probabilities,
// dropout mask) touches device memory, tiles above the diagonal are
// skipped, and each shared-memory value read feeds 4 rows or keys. Moving
// the four products onto wgmma is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attn_dropout.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kR = 4;                  // rows (dq) or keys (dkv) per warp
constexpr int kBQ = kWarps * kR;       // query rows of a dq CTA
constexpr int kBKV = kWarps * kR;      // keys of a dkv CTA
constexpr int kTile = 32;              // keys (dq) or rows (dkv) per tile
constexpr int kLoadRows = kTile / kWarps;

struct Strides {
  // (batch, head, time) element strides of q, k, v, o, dO, dq, dk, dv
  long long s[8][3];
};
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

template <typename T>
__device__ __forceinline__ const T* head(const T* p, const Strides& st,
                                         int t, int b, int h) {
  return p + b * st.s[t][0] + h * st.s[t][1];
}

// DC = ceil(D / 32): head-dim columns each lane loads and accumulates.
template <typename T, int DC, bool DROP>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, Strides st, int H, int Tq,
                    int Tk, int D, int causal, float sm_scale,
                    unsigned drop_thr, float drop_scale,
                    unsigned long long seed, unsigned offset) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = pad4(D);
  const int KP = D4 + 4;
  float* qs = smem;                      // [kBQ][D4] q * scale
  float* dos = qs + kBQ * D4;            // [kBQ][D4] dO
  float* ks = dos + kBQ * D4;            // [kTile][KP]
  float* vs = ks + kTile * KP;           // [kTile][KP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qp = head(q, st, kQ, b, h);
  const T* kp = head(k, st, kK, b, h);
  const T* vp = head(v, st, kV, b, h);
  const T* op = head(o, st, kO, b, h);
  const T* dop = head(dout, st, kDO, b, h);
  const long long qst = st.s[kQ][2], kst = st.s[kK][2], vst = st.s[kV][2],
                  ost = st.s[kO][2], dost = st.s[kDO][2];

  // this warp's 4 rows: q (scaled) and dO to shared memory, Delta, lse
  float lse_r[kR], delta_r[kR];
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int r = warp * kR + rr, qr = q0 + r;
    float dd = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D4) {
        float qv = 0.f, gv = 0.f, ov = 0.f;
        if (qr < Tq && d < D) {
          qv = to_f(qp[qr * qst + d]) * sm_scale;
          gv = to_f(dop[qr * dost + d]);
          ov = to_f(op[qr * ost + d]);
        }
        qs[r * D4 + d] = qv;
        dos[r * D4 + d] = gv;
        dd = fmaf(gv, ov, dd);
      }
    }
    delta_r[rr] = warp_sum(dd);
    lse_r[rr] = qr < Tq ? lse[(long long)bh * Tq + qr] : 0.f;
    if (lane == 0 && qr < Tq) delta[(long long)bh * Tq + qr] = delta_r[rr];
  }

  float acc[kR][DC];
#pragma unroll
  for (int rr = 0; rr < kR; ++rr)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[rr][c] = 0.f;

  const int shift = Tk - Tq;
  int kend = Tk;
  if (causal) kend = min(Tk, q0 + kBQ + shift);
  const float* qrow = qs + warp * kR * D4;
  const float* dorow = dos + warp * kR * D4;
  const float* krow = ks + lane * KP;
  const float* vrow = vs + lane * KP;

  for (int k0 = 0; k0 < kend; k0 += kTile) {
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
        if (d < D4) {
          ks[r * KP + d] = kreg[i][c];
          vs[r * KP + d] = vreg[i][c];
        }
      }
    }
    __syncthreads();

    // s and dP of key k0 + lane against the warp's 4 rows
    float s[kR], dp[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) s[rr] = dp[rr] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
      const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        s[rr] = dot4(*reinterpret_cast<const float4*>(qrow + rr * D4 + d),
                     kv, s[rr]);
        dp[rr] = dot4(*reinterpret_cast<const float4*>(dorow + rr * D4 + d),
                      vv, dp[rr]);
      }
    }

    const int kpos = k0 + lane;
    uint4 bits;
    if (DROP) bits = attn_dropout::bits4(seed, offset, bh, (q0 >> 2) + warp,
                                         kpos);
    float ds[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int qpos = q0 + warp * kR + rr;
      const bool ok = qpos < Tq && kpos < Tk &&
                      (!causal || kpos <= qpos + shift);
      const float p = ok ? expf(s[rr] - lse_r[rr]) : 0.f;
      float dpv = dp[rr];
      if (DROP)
        dpv = attn_dropout::word(bits, rr) >= drop_thr ? dpv * drop_scale
                                                       : 0.f;
      ds[rr] = p * (dpv - delta_r[rr]) * sm_scale;
    }

    // dq += dS K: lane owns columns lane + 32c of all 4 rows
#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const float* kj = ks + j * KP;
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < D ? kj[d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const float dsj = __shfl_sync(0xffffffffu, ds[rr], j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[rr][c] = fmaf(dsj, kv[c], acc[rr][c]);
      }
    }
  }

  T* dqp = dq + b * st.s[kDQ][0] + h * st.s[kDQ][1];
  const long long dqst = st.s[kDQ][2];
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int qpos = q0 + warp * kR + rr;
    if (qpos >= Tq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(dqp + qpos * dqst + d, acc[rr][c]);
    }
  }
}

template <typename T, int DC, bool DROP>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Strides st, int H, int Tq, int Tk,
                     int D, int causal, float sm_scale, unsigned drop_thr,
                     float drop_scale, unsigned long long seed,
                     unsigned offset) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = pad4(D);
  const int KP = D4 + 4;
  float* kss = smem;                     // [kBKV][D4] k * scale
  float* vss = kss + kBKV * D4;          // [kBKV][D4]
  float* qs = vss + kBKV * D4;           // [kTile][KP]
  float* dos = qs + kTile * KP;          // [kTile][KP]
  float* lse_s = dos + kTile * KP;       // [kTile]
  float* delta_s = lse_s + kTile;        // [kTile]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kb0 = blockIdx.x * kBKV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qp = head(q, st, kQ, b, h);
  const T* kp = head(k, st, kK, b, h);
  const T* vp = head(v, st, kV, b, h);
  const T* dop = head(dout, st, kDO, b, h);
  const long long qst = st.s[kQ][2], kst = st.s[kK][2], vst = st.s[kV][2],
                  dost = st.s[kDO][2];

  for (int idx = threadIdx.x; idx < kBKV * D4; idx += kWarps * 32) {
    const int r = idx / D4, d = idx - r * D4, kr = kb0 + r;
    const bool ok = kr < Tk && d < D;
    kss[idx] = ok ? to_f(kp[kr * kst + d]) * sm_scale : 0.f;
    vss[idx] = ok ? to_f(vp[kr * vst + d]) : 0.f;
  }

  float dka[kR][DC], dva[kR][DC];
#pragma unroll
  for (int kk = 0; kk < kR; ++kk)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[kk][c] = dva[kk][c] = 0.f;

  const int shift = Tk - Tq;
  int start = 0;
  if (causal) start = (max(0, kb0 - shift) / kTile) * kTile;
  const int kw = kb0 + warp * kR;        // this warp's first key
  const float* krow = kss + warp * kR * D4;
  const float* vrow = vss + warp * kR * D4;
  const float* qown = qs + lane * KP;
  const float* doown = dos + lane * KP;

  for (int i0 = start; i0 < Tq; i0 += kTile) {
    float qreg[kLoadRows][DC], greg[kLoadRows][DC];
#pragma unroll
    for (int i = 0; i < kLoadRows; ++i) {
      const int qr = i0 + warp + kWarps * i;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        const bool ok = qr < Tq && d < D;
        qreg[i][c] = ok ? to_f(qp[qr * qst + d]) : 0.f;
        greg[i][c] = ok ? to_f(dop[qr * dost + d]) : 0.f;
      }
    }
    const int myrow = i0 + threadIdx.x;
    float lse_v = 0.f, delta_v = 0.f;
    if (threadIdx.x < kTile && myrow < Tq) {
      lse_v = lse[(long long)bh * Tq + myrow];
      delta_v = delta[(long long)bh * Tq + myrow];
    }
    __syncthreads();                     // previous tile fully consumed
#pragma unroll
    for (int i = 0; i < kLoadRows; ++i) {
      const int r = warp + kWarps * i;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < D4) {
          qs[r * KP + d] = qreg[i][c];
          dos[r * KP + d] = greg[i][c];
        }
      }
    }
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse_v;
      delta_s[threadIdx.x] = delta_v;
    }
    __syncthreads();

    // s and dP of query row i0 + lane against the warp's 4 keys
    float s[kR], dp[kR];
#pragma unroll
    for (int kk = 0; kk < kR; ++kk) s[kk] = dp[kk] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qown + d);
      const float4 gv = *reinterpret_cast<const float4*>(doown + d);
#pragma unroll
      for (int kk = 0; kk < kR; ++kk) {
        s[kk] = dot4(qv, *reinterpret_cast<const float4*>(krow + kk * D4 + d),
                     s[kk]);
        dp[kk] = dot4(gv,
                      *reinterpret_cast<const float4*>(vrow + kk * D4 + d),
                      dp[kk]);
      }
    }

    const int row = i0 + lane;
    const float lse_l = lse_s[lane], delta_l = delta_s[lane];
    // lane computes the bits of rows 4*(lane/4).. of key kw + lane % 4;
    // lane l needs word l % 4 of the lane holding its row group and key kk
    uint4 bits;
    if (DROP)
      bits = attn_dropout::bits4(seed, offset, bh, (i0 >> 2) + (lane >> 2),
                                 kw + (lane & 3));
    float pd[kR], ds[kR];
#pragma unroll
    for (int kk = 0; kk < kR; ++kk) {
      const int key = kw + kk;
      const bool ok = row < Tq && key < Tk && (!causal || key <= row + shift);
      const float p = ok ? expf(s[kk] - lse_l) : 0.f;
      float pdv = p, dpv = dp[kk];
      if (DROP) {
        const int src = (lane & ~3) | kk;
        const unsigned w0 = __shfl_sync(0xffffffffu, bits.x, src);
        const unsigned w1 = __shfl_sync(0xffffffffu, bits.y, src);
        const unsigned w2 = __shfl_sync(0xffffffffu, bits.z, src);
        const unsigned w3 = __shfl_sync(0xffffffffu, bits.w, src);
        const int wi = lane & 3;
        const unsigned w = wi == 0 ? w0 : wi == 1 ? w1 : wi == 2 ? w2 : w3;
        const bool keep = w >= drop_thr;
        pdv = keep ? p * drop_scale : 0.f;
        dpv = keep ? dpv * drop_scale : 0.f;
      }
      pd[kk] = pdv;
      ds[kk] = p * (dpv - delta_l) * sm_scale;
    }

    // dv += (M o p)^T dO, dk += dS^T Q: lane owns columns lane + 32c
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float* qj = qs + j * KP;
      const float* gj = dos + j * KP;
      float qv[DC], gv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        qv[c] = d < D ? qj[d] : 0.f;
        gv[c] = d < D ? gj[d] : 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kR; ++kk) {
        const float pj = __shfl_sync(0xffffffffu, pd[kk], j);
        const float sj = __shfl_sync(0xffffffffu, ds[kk], j);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dva[kk][c] = fmaf(pj, gv[c], dva[kk][c]);
          dka[kk][c] = fmaf(sj, qv[c], dka[kk][c]);
        }
      }
    }
  }

  T* dkp = dk + b * st.s[kDK][0] + h * st.s[kDK][1];
  T* dvp = dv + b * st.s[kDV][0] + h * st.s[kDV][1];
  const long long dkst = st.s[kDK][2], dvst = st.s[kDV][2];
#pragma unroll
  for (int kk = 0; kk < kR; ++kk) {
    const int key = kw + kk;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        store(dkp + key * dkst + d, dka[kk][c]);
        store(dvp + key * dvst + d, dva[kk][c]);
      }
    }
  }
}

// Above 48 KB a block's dynamic shared memory needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Strides st;
  int B, H, Tq, Tk, D, causal;
  float sm_scale;
  int dropout;
  unsigned drop_thr;
  float drop_scale;
  unsigned long long seed;
  unsigned offset;
};

template <typename T, int DC, bool DROP>
int launch_dq(const Args& a, cudaStream_t stream) {
  const int D4 = pad4(a.D);
  const size_t smem = sizeof(float) * (2 * kBQ * D4 + 2 * kTile * (D4 + 4));
  auto kern = flash_bwd_dq_kernel<T, DC, DROP>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.B * a.H);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), a.lse, static_cast<T*>(a.dq), a.delta,
      a.st, a.H, a.Tq, a.Tk, a.D, a.causal, a.sm_scale, a.drop_thr,
      a.drop_scale, a.seed, a.offset);
  return (int)cudaGetLastError();
}

template <typename T, int DC, bool DROP>
int launch_dkv(const Args& a, cudaStream_t stream) {
  const int D4 = pad4(a.D);
  const size_t smem = sizeof(float) * (2 * kBKV * D4 +
                                       2 * kTile * (D4 + 4) + 2 * kTile);
  auto kern = flash_bwd_dkv_kernel<T, DC, DROP>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tk + kBKV - 1) / kBKV, a.B * a.H);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.st, a.H,
      a.Tq, a.Tk, a.D, a.causal, a.sm_scale, a.drop_thr, a.drop_scale,
      a.seed, a.offset);
  return (int)cudaGetLastError();
}

// dispatch on dtype, ceil(D / 32) and dropout
template <template <typename, int, bool> class L>
int dispatch(const Args& a, int dtype, cudaStream_t stream) {
  if (a.D < 1 || a.D > 128 || a.Tq < 1 || a.Tk < 1 || dtype < 0 ||
      dtype > 1 || (a.causal && a.Tk < a.Tq))
    return (int)cudaErrorInvalidValue;
  const int dc = (a.D + 31) / 32;
#define BWD_CASE(T, DC)                                                      \
  if (dc == DC)                                                              \
    return a.dropout ? L<T, DC, true>::run(a, stream)                        \
                     : L<T, DC, false>::run(a, stream);
  if (dtype == 0) {
    BWD_CASE(float, 1) BWD_CASE(float, 2) BWD_CASE(float, 3)
    BWD_CASE(float, 4)
  } else {
    BWD_CASE(__nv_bfloat16, 1) BWD_CASE(__nv_bfloat16, 2)
    BWD_CASE(__nv_bfloat16, 3) BWD_CASE(__nv_bfloat16, 4)
  }
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int DC, bool DROP>
struct DqLauncher {
  static int run(const Args& a, cudaStream_t s) {
    return launch_dq<T, DC, DROP>(a, s);
  }
};
template <typename T, int DC, bool DROP>
struct DkvLauncher {
  static int run(const Args& a, cudaStream_t s) {
    return launch_dkv<T, DC, DROP>(a, s);
  }
};

Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, const long long* strides, int B, int H,
               int Tq, int Tk, int D, int causal, float sm_scale,
               int dropout, unsigned drop_thr, float drop_scale,
               unsigned long long seed, unsigned offset) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) a.st.s[t][j] = strides[3 * t + j];
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale; a.dropout = dropout; a.drop_thr = drop_thr;
  a.drop_scale = drop_scale; a.seed = seed; a.offset = offset;
  return a;
}

}  // namespace

// strides: 24 element strides, (batch, head, time) for q, k, v, o, dO, dq,
// dk, dv in turn (entries of tensors a kernel does not touch are ignored);
// every head_dim stride must be 1. dtype: 0 float32, 1 bfloat16. lse and
// delta: [B*H, Tq] float32 (flash_bwd_dq writes delta, flash_bwd_dkv reads
// it). dropout as in flash_fwd. Each returns cudaGetLastError() after its
// launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, void* dq, float* delta,
                            const long long* strides, int B, int H, int Tq,
                            int Tk, int D, int causal, float sm_scale,
                            int dtype, int dropout, unsigned drop_thr,
                            float drop_scale, unsigned long long seed,
                            unsigned offset, cudaStream_t stream) {
  const Args a = make_args(q, k, v, o, dout, lse, delta, dq, nullptr,
                           nullptr, strides, B, H, Tq, Tk, D, causal,
                           sm_scale, dropout, drop_thr, drop_scale, seed,
                           offset);
  return dispatch<DqLauncher>(a, dtype, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int Tq,
                             int Tk, int D, int causal, float sm_scale,
                             int dtype, int dropout, unsigned drop_thr,
                             float drop_scale, unsigned long long seed,
                             unsigned offset, cudaStream_t stream) {
  const Args a = make_args(q, k, v, nullptr, dout, lse,
                           const_cast<float*>(delta), nullptr, dk, dv,
                           strides, B, H, Tq, Tk, D, causal, sm_scale,
                           dropout, drop_thr, drop_scale, seed, offset);
  return dispatch<DkvLauncher>(a, dtype, stream);
}
