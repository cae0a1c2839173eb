// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, with
// optional attention dropout. bfloat16 and float16 inputs run on the
// tensor cores; float32 inputs keep the CUDA-core kernels.
//
// Replaces paddle_tpu/ops/pallas_kernels.py `_flash_bwd_dq_kernel` (:462)
// and `_flash_bwd_dkv_kernel` (:524), both launched by `_flash_bwd`
// (:589; calls :615 and :636). With s the scaled scores, p = exp(s - lse)
// (lse from the training forward), the dropout keep mask M scaled by
// 1/(1-p_drop) (attn_dropout.cuh, the same bits the forward used),
// dP = M o (dO V^T), Delta = rowsum(dO o O) and
// dS = p o (dP - Delta) * D^-1/2:
//     dq = dS K,   dk = dS^T Q,   dv = (M o p)^T dO.
// Two kernels, two passes, no atomics, as on the TPU, so the result is the
// same from run to run:
//   * flash_bwd_dq: one CTA per (batch*head, query tile), looping over the
//     K/V tiles up to the causal diagonal. It also computes Delta for its
//     rows and writes it, [B*H, Tq] float32 (once per row, where the TPU
//     kernels recompute it per key tile; no launch of its own).
//   * flash_bwd_dkv: one CTA per (batch*head, key tile), looping over the
//     Q/dO tiles from the causal lower bound (the first row that sees the
//     tile's first key, rounded down to a tile) to Tq. It reads the Delta
//     the dq kernel wrote, so it runs after it on the same stream.
// Causal masking is bottom-right aligned (shift = Tk - Tq, Tk >= Tq); any
// Tq/Tk, ragged tiles masked; D <= 128; strided [B, H, T, D] views with a
// unit head_dim stride.
//
// bfloat16 route (namespace tc): FlashAttention-2's backward in its two
// passes, on mma.sync.m16n8k16 bf16 x bf16 -> f32. Its building blocks
// (cp.async, ldmatrix, mma, the hi + lo split, the accumulator-to-A-
// fragment repacking, tile loads and pair stores, the Philox stage) live
// in tc_mma.cuh, which the forward's tensor-core kernel (flash_fwd.cu)
// includes too; moving them there left this file's kernels the same
// machine code, instruction for instruction (cuobjdump -sass of the old
// and the new source's cubins, kernel by kernel).
//   * Tiles. A CTA is 4 warps and holds 64 resident rows in shared memory
//     (Q and dO in dq, K and V in dk/dv), loaded once; a warp owns 16 of
//     them. The streamed tiles (64 keys of K/V in dq, 32 past D = 64; 32
//     rows of Q/dO, lse and Delta in dk/dv) are copied with cp.async, 16
//     bytes a thread, into two stages, so the next tile's copy overlaps
//     this tile's products. Shared-memory rows are padded by 16 bytes, so
//     the 8 row addresses of every ldmatrix phase fall in 8 distinct 4-bank
//     groups. Launch bounds hold both kernels to 168 registers a thread at
//     D <= 64, so 3 CTAs (12 warps) share an SM.
//   * Register reuse. dq: S = Q K^T and dP = dO V^T for the warp's 16 rows
//     against BN keys (A from Q/dO by ldmatrix, B from K/V rows by
//     ldmatrix). The f32 accumulator of two neighbouring n8 tiles, packed
//     to bf16 pairs, is exactly the A fragment of a k16 step, so dS stays
//     in registers and dq += dS K takes K by ldmatrix.trans. dk/dv computes
//     the transposed tiles directly, S^T = K Q^T and dP^T = V dO^T for the
//     warp's 16 keys, then dv += (M o p)^T dO and dk += dS^T Q from
//     registers, with dO and Q by ldmatrix.trans. Nothing of size
//     [Tq, Tk] touches shared or device memory.
//   * Rounding. S is accumulated in f32 from the bf16 inputs and scaled
//     after the product (a bf16 operand scaled before rounding would add a
//     rounding the plain version does not have). M o p and dS enter the
//     second products as two bf16 operands, hi (the value rounded) and lo
//     (what hi leaves out, rounded), each multiplied by the same B
//     fragment: 2^-17 relative where one bf16 rounding loses 2^-9, which
//     at the main path's shapes came near one ulp of the largest output.
//     It costs one product more in dq and two in dk/dv, no shared memory
//     and no loads. Every sum is f32. tests/test_torch_flash_bwd.py
//     repeats this rounding on the CPU and holds it against the plain
//     versions.
//   * Dropout. The mask is the element function of attn_dropout.cuh (one
//     Philox call per 4 rows of a column), which does not line up with the
//     accumulator layout (a thread holds rows r, r+8 and two adjacent
//     columns). An m16n8 tile is 32 (row group, column) pairs: lane l makes
//     the call of one pair, stores its 4 words in a per-warp shared stage,
//     and each thread reads the 4 words of its elements back. One call per
//     4 elements, as the mask's definition has it.
//   * Work order. Tiles above the causal diagonal are skipped and the CTAs
//     with the most tiles launch first (the last query tiles in dq, the
//     first key tiles in dk/dv), which shortens a causal grid's tail.
//   * Edges. With D % 8 == 0 and every row 16-byte aligned the tiles come
//     by cp.async (rows past T and columns past D zero-filled); otherwise
//     by element loads, and outputs by element stores.
//
// float16 route: the same kernels, one template instance an element type
// (tc_mma.cuh's Elt<T>; mma.sync .f16 in place of .bf16), with one
// difference. The reference keeps p and dS in float32 (its Pallas kernels
// take float32 products of any input type), and float16's largest finite
// value is 65504 where bfloat16's is float32's: under a loss scale of
// 2^15, dO and so dS grow 32768-fold, and a dS rounded to float16 as it
// stands would become inf where the reference stays finite (and a
// GradScaler would skip a step the reference takes). So dS enters its
// products scaled per accumulator row by a power of two
// (tc_mma.cuh range_scale: its largest element below 2^15, each row's
// running exponent the largest seen, the accumulator shrunk by the power
// of two in between when a tile raises it), and the output takes the
// inverse power at the end: exact in the float32 sums. M o p lies in [0,
// 1 / (1 - p)] and enters as it is. The hi + lo pairs stay: in float16
// they hold dS to 2^-22 relative where one rounding holds 2^-11, and the
// pair costs what it costs in bfloat16.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s):
//   * GPT-2 training (B=16, H=12, T=512, D=64, causal): 25.2 M live
//     (row, key) pairs; dq does 3 products of the function (6 D flops a
//     pair, 9.7 GFLOP) and dk/dv 4 (12.9 GFLOP), 0.010 / 0.013 ms of
//     tensor-core time (the lo operands add one product's worth in dq and
//     two in dk/dv), against ~76 MB each to move (0.0228 ms): bound by
//     bytes on paper. In practice the Philox calls at p = 0.1 (one per 4
//     elements, ~90 integer instructions each, ~7 M calls a kernel with
//     the diagonal tiles' masked elements) and mma.sync's share of the
//     tensor-core peak bound it: chip_smoke.py reads dq 0.104 / dk/dv
//     0.137 ms at p = 0.1 and 0.078 / 0.114 ms at p = 0 on an H100 SXM
//     at 700 W.
//   * ERNIE (B=32, H=12, T=128, D=64, not causal): 6.3 M pairs, 2.4 / 3.2
//     GFLOP, ~38 MB a kernel (0.0114 ms): bound by bytes; 768 CTAs of 2
//     (dq) or 4 (dk/dv) tiles, so the prologue (the resident tiles and
//     Delta) weighs; chip_smoke.py reads 0.033 / 0.042 ms.
//
// float32 route: the CUDA-core kernels below (scalar f32 FMAs, 16-row or
// 16-key CTAs). chip_smoke.py's float32 kernels-vs-plain training compares
// hold parameters within 1e-4 after 3 steps; TF32 (10-bit mantissa) on the
// tensor cores cannot meet that, and every training path hands these
// kernels bf16 q/k/v under O2 or auto_cast, so float32 keeps full f32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attn_dropout.cuh"
#include "tc_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 route: CUDA cores. In dq, each of 4 warps owns 4 query rows (q
// pre-scaled, and dO, in shared memory, read as broadcasts); lane l takes
// key l of a 32-key tile and computes s and dP for the warp's 4 rows from
// its own K and V rows (float4 reads, rows padded to D4 + 4 floats); the
// warp then accumulates dq += dS K with lane l owning columns l, l+32, ...
// In dkv the roles turn around: each warp owns 4 keys (K pre-scaled, and
// V, read as broadcasts), lane l takes query row l of a 32-row Q/dO tile,
// and lane l accumulates columns l, l+32, ... of dk and dv for the warp's 4
// keys. The dropout bits of a warp's 4 x 32 elements come from 32 Philox
// calls, one per lane, shared with shuffles.

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
template <int DC, bool DROP>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ delta, Strides st, int H, int Tq,
                    int Tk, int D, int causal, float sm_scale,
                    unsigned drop_thr, float drop_scale,
                    const unsigned long long* __restrict__ rng,
                    unsigned rng_delta) {
  unsigned long long seed = 0;            // the call's dropout key, read
  unsigned offset = 0;                    // once from the Philox word
  if (DROP) attn_dropout::load_key(rng, rng_delta, seed, offset);
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
  const float* qp = head(q, st, kQ, b, h);
  const float* kp = head(k, st, kK, b, h);
  const float* vp = head(v, st, kV, b, h);
  const float* op = head(o, st, kO, b, h);
  const float* dop = head(dout, st, kDO, b, h);
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
          qv = qp[qr * qst + d] * sm_scale;
          gv = dop[qr * dost + d];
          ov = op[qr * ost + d];
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
        kreg[i][c] = ok ? kp[kr * kst + d] : 0.f;
        vreg[i][c] = ok ? vp[kr * vst + d] : 0.f;
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

  float* dqp = dq + b * st.s[kDQ][0] + h * st.s[kDQ][1];
  const long long dqst = st.s[kDQ][2];
#pragma unroll
  for (int rr = 0; rr < kR; ++rr) {
    const int qpos = q0 + warp * kR + rr;
    if (qpos >= Tq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dqp[qpos * dqst + d] = acc[rr][c];
    }
  }
}

template <int DC, bool DROP>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Strides st, int H, int Tq, int Tk,
                     int D, int causal, float sm_scale, unsigned drop_thr,
                     float drop_scale,
                     const unsigned long long* __restrict__ rng,
                     unsigned rng_delta) {
  unsigned long long seed = 0;            // the call's dropout key, read
  unsigned offset = 0;                    // once from the Philox word
  if (DROP) attn_dropout::load_key(rng, rng_delta, seed, offset);
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
  const float* qp = head(q, st, kQ, b, h);
  const float* kp = head(k, st, kK, b, h);
  const float* vp = head(v, st, kV, b, h);
  const float* dop = head(dout, st, kDO, b, h);
  const long long qst = st.s[kQ][2], kst = st.s[kK][2], vst = st.s[kV][2],
                  dost = st.s[kDO][2];

  for (int idx = threadIdx.x; idx < kBKV * D4; idx += kWarps * 32) {
    const int r = idx / D4, d = idx - r * D4, kr = kb0 + r;
    const bool ok = kr < Tk && d < D;
    kss[idx] = ok ? kp[kr * kst + d] * sm_scale : 0.f;
    vss[idx] = ok ? vp[kr * vst + d] : 0.f;
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
        qreg[i][c] = ok ? qp[qr * qst + d] : 0.f;
        greg[i][c] = ok ? dop[qr * dost + d] : 0.f;
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

  float* dkp = dk + b * st.s[kDK][0] + h * st.s[kDK][1];
  float* dvp = dv + b * st.s[kDV][0] + h * st.s[kDV][1];
  const long long dkst = st.s[kDK][2], dvst = st.s[kDV][2];
#pragma unroll
  for (int kk = 0; kk < kR; ++kk) {
    const int key = kw + kk;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dkp[key * dkst + d] = dka[kk][c];
        dvp[key * dvst + d] = dva[kk][c];
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores (see the note at the top). The kernels live
// in namespace tc beside the building blocks of tc_mma.cuh.

}  // namespace

namespace tc {

// A tile configuration: DP, the head dim rounded up to 32 (the k extent
// of S and the n extent of the outputs; columns D..DP are zeros in shared
// memory), and BN, the streamed rows a tile.
template <int DP, int BN_>
struct Cfg {
  static constexpr int BN = BN_;
  static constexpr int LD = DP + 8;              // shared row, elements
  static constexpr int NT = BN / 8;              // n8 tiles of S a warp
  static constexpr int KS = DP / 16;             // k16 steps of S
  static constexpr int DT = DP / 8;              // n8 tiles of an output
};
// dq streams 64 keys a tile (32 past D = 64, which keeps S, dP and dq in
// registers); dk/dv streams 32 query rows, which keeps its S^T, dP^T, dk
// and dv within the 168 registers a thread of 3 CTAs an SM at D <= 64.
// On the H100 both ran faster at 3 CTAs an SM than at 2 (dk/dv with
// 64-row tiles takes 255 registers and spills); dk/dv spills at 4, and dq
// with 32-key tiles at 4 was no faster.
// float16 A operands without a bound of their own take range_scale
template <typename T>
constexpr bool kRanged = std::is_same<T, f16>::value;

template <int DP>
using DqCfg = Cfg<DP, (DP <= 64 ? 64 : 32)>;
template <int DP>
using DkvCfg = Cfg<DP, 32>;
constexpr int kDqBlocks = 3;
template <int DP>
struct DkvBlocks {              // past D = 64 dk/dv takes ~250 registers
  static constexpr int value = DP <= 64 ? 3 : 1;
};

template <typename C>
constexpr size_t smem_bytes() {            // 2-byte elements
  return 2 * (2 * kRes + 4 * C::BN) * C::LD +
         sizeof(float) * 4 * C::BN + sizeof(uint4) * kThreads;
}

// dq = dS K and Delta. Grid (B*H, query tiles), last query tile first.
template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads, kDqBlocks)
flash_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 T* __restrict__ dq, float* __restrict__ delta, Strides st,
                 int H, int Tq, int Tk, int D, int causal, float sm_scale,
                 int vec, unsigned drop_thr, float drop_scale,
                 const unsigned long long* __restrict__ rng,
                 unsigned rng_delta) {
  unsigned long long seed = 0;            // the call's dropout key, read
  unsigned offset = 0;                    // once from the Philox word
  if (DROP) attn_dropout::load_key(rng, rng_delta, seed, offset);
  using C = DqCfg<DP>;
  constexpr int BN = C::BN, LD = C::LD, NT = C::NT, KS = C::KS, DT = C::DT;
  extern __shared__ uint4 smem_u4[];
  T* qs = reinterpret_cast<T*>(smem_u4);           // [kRes][LD]
  T* dos = qs + kRes * LD;                         // [kRes][LD]
  T* kvs = dos + kRes * LD;                        // [2][K, V][BN][LD]
  float* delta_s = reinterpret_cast<float*>(kvs + 4 * BN * LD);  // [kRes]
  uint4* bits_s = reinterpret_cast<uint4*>(delta_s + 4 * BN);    // [4][32]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const T* qp = head(q, st, kQ, b, h);
  const T* kp = head(k, st, kK, b, h);
  const T* vp = head(v, st, kV, b, h);
  const T* op = head(o, st, kO, b, h);
  const T* dop = head(dout, st, kDO, b, h);
  const long long kst = st.s[kK][2], vst = st.s[kV][2];
  const int shift = Tk - Tq;
  const int kend = causal ? min(Tk, q0 + kRes + shift) : Tk;
  const int ntiles = (kend + BN - 1) / BN;

  load_tile<kRes, DP>(qs, qp, st.s[kQ][2], q0, Tq, D, vec);
  load_tile<kRes, DP>(dos, dop, st.s[kDO][2], q0, Tq, D, vec);
  cp_commit();
  load_tile<BN, DP>(kvs, kp, kst, 0, Tk, D, vec);
  load_tile<BN, DP>(kvs + BN * LD, vp, vst, 0, Tk, D, vec);
  cp_commit();
  cp_wait_prev();                        // Q and dO (K/V tile 0 in flight)
  __syncthreads();

  // Delta = rowsum(dO o O): two threads a row, alternate 8-column chunks
  {
    const int r = tid >> 1, row = q0 + r;
    float dd = 0.f;
    if (row < Tq) {
      const T* orow = op + row * st.s[kO][2];
      const T* grow = dos + r * LD;
      for (int d = (tid & 1) * 8; d < D; d += 16) {
        float ov[8];
        if (vec) {
          const uint4 u = *reinterpret_cast<const uint4*>(orow + d);
          const typename Elt<T>::T2* h2 =
              reinterpret_cast<const typename Elt<T>::T2*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = Elt<T>::widen(h2[e]);
            ov[2 * e] = f.x;
            ov[2 * e + 1] = f.y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            ov[e] = d + e < D ? Elt<T>::to(orow[d + e]) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dd = fmaf(Elt<T>::to(grow[d + e]), ov[e], dd);
      }
    }
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = dd;
      if (row < Tq) delta[(long long)bh * Tq + row] = dd;
    }
  }
  __syncthreads();

  const int r0 = q0 + warp * 16;         // the warp's first row
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    lse2[i] = row < Tq ? lse[(long long)bh * Tq + row] * kLog2e : 0.f;
    dlt[i] = delta_s[warp * 16 + g + 8 * i];
  }
  const float scale_log2 = sm_scale * kLog2e;
  const T* qw = qs + warp * 16 * LD;
  const T* dow = dos + warp * 16 * LD;
  uint4* wbits = bits_s + warp * 32;
  // lane offsets of ldmatrix: a_off for an A fragment (16 rows x k16) and
  // for two B fragments transposed (k16 rows x 16 columns), b_off for two
  // B fragments from 16 rows (n) x k16
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // float16: the running exponents of dS's rows g, g + 8 (range_scale)
  int ex[2] = {kMinExp, kMinExp};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN;
    if (it + 1 < ntiles) {
      T* nxt = kvs + ((it + 1) & 1) * 2 * BN * LD;
      load_tile<BN, DP>(nxt, kp, kst, k0 + BN, Tk, D, vec);
      load_tile<BN, DP>(nxt + BN * LD, vp, vst, k0 + BN, Tk, D, vec);
    }
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    const T* ks = kvs + (it & 1) * 2 * BN * LD;
    const T* vs = ks + BN * LD;

    // S = Q K^T and dP = dO V^T over this tile's keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned aq[4], ag[4];
      ldsm(aq, qw + a_off + kk * 16);
      ldsm(ag, dow + a_off + kk * 16);
#pragma unroll
      for (int jn = 0; jn < NT / 2; ++jn) {
        unsigned bk[4], bv[4];
        ldsm(bk, ks + jn * 16 * LD + b_off + kk * 16);
        ldsm(bv, vs + jn * 16 * LD + b_off + kk * 16);
        mma<T>(s[2 * jn], aq, bk[0], bk[1]);
        mma<T>(s[2 * jn + 1], aq, bk[2], bk[3]);
        mma<T>(dp[2 * jn], ag, bv[0], bv[1]);
        mma<T>(dp[2 * jn + 1], ag, bv[2], bv[3]);
      }
    }

    // dS, in place of S. Element e of tile j: row g + 8 (e / 2), key
    // 8 j + 2 t + e % 2 of the tile.
    const bool edge = k0 + BN > Tk || (causal && k0 + BN - 1 > r0 + shift);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (DROP) {
        // lane: rows 4 (lane / 8) .. +3 of the warp, key 8 j + lane % 8
        stage_bits(wbits, lane, seed, offset, bh, (r0 >> 2) + (lane >> 3),
                   k0 + 8 * j + (lane & 7));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = g + 8 * (e >> 1), kc = 2 * t + (e & 1);
        float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
        if (edge) {
          const int kpos = k0 + 8 * j + kc;
          if (kpos >= Tk || (causal && kpos > r0 + rr + shift)) p = 0.f;
        }
        float dpv = dp[j][e];
        if (DROP) {
          const unsigned w = staged_word(wbits, ((rr >> 2) << 3) + kc,
                                         rr & 3);
          dpv = w >= drop_thr ? dpv * drop_scale : 0.f;
        }
        s[j][e] = p * (dpv - dlt[e >> 1]) * sm_scale;
      }
      if (DROP) __syncwarp();
    }

    if constexpr (kRanged<T>) range_scale(s, ex, acc);

    // dq += dS K: dS from registers (hi and lo), K transposed from shared
    // memory
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      unsigned hi[4], lo[4];
      a_from_acc<T>(hi, lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        unsigned bk[4];
        ldsm_t(bk, ks + kk * 16 * LD + a_off + dn * 16);
        mma<T>(acc[2 * dn], hi, bk[0], bk[1]);
        mma<T>(acc[2 * dn + 1], hi, bk[2], bk[3]);
        mma<T>(acc[2 * dn], lo, bk[0], bk[1]);
        mma<T>(acc[2 * dn + 1], lo, bk[2], bk[3]);
      }
    }
    __syncthreads();                     // this stage is refilled next
  }

  T* dqp = dq + b * st.s[kDQ][0] + h * st.s[kDQ][1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= Tq) continue;
    const float un = kRanged<T> ? exp2i(ex[i] - kTop) : 1.f;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int d = dn * 8 + 2 * t;
      if (d < D)
        store_pair(dqp + row * st.s[kDQ][2] + d, acc[dn][2 * i] * un,
                   acc[dn][2 * i + 1] * un, d, D, vec);
    }
  }
}

// dk = dS^T Q, dv = (M o p)^T dO. Grid (B*H, key tiles), first key tile
// first.
template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads, DkvBlocks<DP>::value)
flash_bwd_dkv_mma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, Strides st, int H, int Tq, int Tk,
                  int D, int causal, float sm_scale, int vec,
                  unsigned drop_thr, float drop_scale,
                  const unsigned long long* __restrict__ rng,
                  unsigned rng_delta) {
  unsigned long long seed = 0;            // the call's dropout key, read
  unsigned offset = 0;                    // once from the Philox word
  if (DROP) attn_dropout::load_key(rng, rng_delta, seed, offset);
  using C = DkvCfg<DP>;
  constexpr int BN = C::BN, LD = C::LD, NT = C::NT, KS = C::KS, DT = C::DT;
  extern __shared__ uint4 smem_u4[];
  T* ks = reinterpret_cast<T*>(smem_u4);           // [kRes][LD]
  T* vs = ks + kRes * LD;                          // [kRes][LD]
  T* qgs = vs + kRes * LD;                         // [2][Q, dO][BN][LD]
  // ld_s: [2][lse, Delta][BN]
  float* ld_s = reinterpret_cast<float*>(qgs + 4 * BN * LD);
  uint4* bits_s = reinterpret_cast<uint4*>(ld_s + 4 * BN);  // [4][32]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kb0 = blockIdx.y * kRes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const T* qp = head(q, st, kQ, b, h);
  const T* kp = head(k, st, kK, b, h);
  const T* vp = head(v, st, kV, b, h);
  const T* dop = head(dout, st, kDO, b, h);
  const float* lse_h = lse + (long long)bh * Tq;
  const float* delta_h = delta + (long long)bh * Tq;
  const long long qst = st.s[kQ][2], dost = st.s[kDO][2];
  const int shift = Tk - Tq;
  const int start = causal ? (max(0, kb0 - shift) / BN) * BN : 0;
  const int ntiles = (Tq - start + BN - 1) / BN;

  load_tile<kRes, DP>(ks, kp, st.s[kK][2], kb0, Tk, D, vec);
  load_tile<kRes, DP>(vs, vp, st.s[kV][2], kb0, Tk, D, vec);
  cp_commit();
  load_tile<BN, DP>(qgs, qp, qst, start, Tq, D, vec);
  load_tile<BN, DP>(qgs + BN * LD, dop, dost, start, Tq, D, vec);
  load_vec(ld_s, lse_h, start, Tq, BN);
  load_vec(ld_s + BN, delta_h, start, Tq, BN);
  cp_commit();

  const int kw = kb0 + warp * 16;        // the warp's first key
  const float scale_log2 = sm_scale * kLog2e;
  const T* kwp = ks + warp * 16 * LD;
  const T* vwp = vs + warp * 16 * LD;
  uint4* wbits = bits_s + warp * 32;
  // lane offsets of ldmatrix: a_off for an A fragment (16 rows x k16) and
  // for two B fragments transposed (k16 rows x 16 columns), b_off for two
  // B fragments from 16 rows (n) x k16
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  // float16: the running exponents of dS^T's rows (the warp's keys g,
  // g + 8; range_scale). M o p lies in [0, 1 / (1 - p)] and needs none.
  int ex[2] = {kMinExp, kMinExp};

  for (int it = 0; it < ntiles; ++it) {
    const int i0 = start + it * BN;
    if (it + 1 < ntiles) {
      const int nx = (it + 1) & 1;
      T* nxt = qgs + nx * 2 * BN * LD;
      load_tile<BN, DP>(nxt, qp, qst, i0 + BN, Tq, D, vec);
      load_tile<BN, DP>(nxt + BN * LD, dop, dost, i0 + BN, Tq, D, vec);
      load_vec(ld_s + nx * 2 * BN, lse_h, i0 + BN, Tq, BN);
      load_vec(ld_s + nx * 2 * BN + BN, delta_h, i0 + BN, Tq, BN);
    }
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    const T* qs = qgs + (it & 1) * 2 * BN * LD;
    const T* gs = qs + BN * LD;
    const float* ls = ld_s + (it & 1) * 2 * BN;
    const float* dls = ls + BN;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BN rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned ak[4], av[4];
      ldsm(ak, kwp + a_off + kk * 16);
      ldsm(av, vwp + a_off + kk * 16);
#pragma unroll
      for (int jn = 0; jn < NT / 2; ++jn) {
        unsigned bq[4], bg[4];
        ldsm(bq, qs + jn * 16 * LD + b_off + kk * 16);
        ldsm(bg, gs + jn * 16 * LD + b_off + kk * 16);
        mma<T>(s[2 * jn], ak, bq[0], bq[1]);
        mma<T>(s[2 * jn + 1], ak, bq[2], bq[3]);
        mma<T>(dp[2 * jn], av, bg[0], bg[1]);
        mma<T>(dp[2 * jn + 1], av, bg[2], bg[3]);
      }
    }

    // M o p^T in place of S^T, dS^T in place of dP^T. Element e of tile
    // j: key g + 8 (e / 2) of the warp, row 8 j + 2 t + e % 2 of the tile.
    const bool edge = i0 + BN > Tq || (causal && kw + 15 > i0 + shift);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (DROP) {
        // lane: key lane % 16 of the warp, rows 8 j + 4 (lane / 16) .. +3
        stage_bits(wbits, lane, seed, offset, bh,
                   ((i0 + 8 * j) >> 2) + (lane >> 4), kw + (lane & 15));
      }
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d2 =
          *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = g + 8 * (e >> 1);
        const float lv = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        float p = exp2f(fmaf(s[j][e], scale_log2, -lv * kLog2e));
        if (edge) {
          const int row = i0 + 8 * j + 2 * t + (e & 1), key = kw + kr;
          if (row >= Tq || key >= Tk || (causal && key > row + shift))
            p = 0.f;
        }
        float pd = p, dpv = dp[j][e];
        if (DROP) {
          const unsigned w = staged_word(wbits, ((t >> 1) << 4) + kr,
                                         2 * (t & 1) + (e & 1));
          const bool keep = w >= drop_thr;
          pd = keep ? p * drop_scale : 0.f;
          dpv = keep ? dpv * drop_scale : 0.f;
        }
        s[j][e] = pd;
        dp[j][e] = p * (dpv - dl) * sm_scale;
      }
      if (DROP) __syncwarp();
    }

    if constexpr (kRanged<T>) range_scale(dp, ex, dka);

    // dv += (M o p)^T dO, then dk += dS^T Q: A from registers (hi and
    // lo), dO and Q transposed from shared memory
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      unsigned hi[4], lo[4];
      a_from_acc<T>(hi, lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        unsigned bg[4];
        ldsm_t(bg, gs + kk * 16 * LD + a_off + dn * 16);
        mma<T>(dva[2 * dn], hi, bg[0], bg[1]);
        mma<T>(dva[2 * dn + 1], hi, bg[2], bg[3]);
        mma<T>(dva[2 * dn], lo, bg[0], bg[1]);
        mma<T>(dva[2 * dn + 1], lo, bg[2], bg[3]);
      }
      a_from_acc<T>(hi, lo, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        unsigned bq[4];
        ldsm_t(bq, qs + kk * 16 * LD + a_off + dn * 16);
        mma<T>(dka[2 * dn], hi, bq[0], bq[1]);
        mma<T>(dka[2 * dn + 1], hi, bq[2], bq[3]);
        mma<T>(dka[2 * dn], lo, bq[0], bq[1]);
        mma<T>(dka[2 * dn + 1], lo, bq[2], bq[3]);
      }
    }
    __syncthreads();                     // this stage is refilled next
  }

  T* dkp = dk + b * st.s[kDK][0] + h * st.s[kDK][1];
  T* dvp = dv + b * st.s[kDV][0] + h * st.s[kDV][1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + g + 8 * i;
    if (key >= Tk) continue;
    const float un = kRanged<T> ? exp2i(ex[i] - kTop) : 1.f;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int d = dn * 8 + 2 * t;
      if (d >= D) continue;
      store_pair(dkp + key * st.s[kDK][2] + d, dka[dn][2 * i] * un,
                 dka[dn][2 * i + 1] * un, d, D, vec);
      store_pair(dvp + key * st.s[kDV][2] + d, dva[dn][2 * i],
                 dva[dn][2 * i + 1], d, D, vec);
    }
  }
}

}  // namespace tc

namespace {

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
  const unsigned long long* rng;
  unsigned rng_delta;
};

// float32 route: the CUDA-core kernels

template <int DC, bool DROP>
struct DqLauncher {
  static int run(const Args& a, cudaStream_t stream) {
    const int D4 = pad4(a.D);
    const size_t smem =
        sizeof(float) * (2 * kBQ * D4 + 2 * kTile * (D4 + 4));
    auto kern = flash_bwd_dq_kernel<DC, DROP>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.B * a.H);
    kern<<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.o),
        static_cast<const float*>(a.dout), a.lse, static_cast<float*>(a.dq),
        a.delta, a.st, a.H, a.Tq, a.Tk, a.D, a.causal, a.sm_scale,
        a.drop_thr, a.drop_scale, a.rng, a.rng_delta);
    return (int)cudaGetLastError();
  }
};

template <int DC, bool DROP>
struct DkvLauncher {
  static int run(const Args& a, cudaStream_t stream) {
    const int D4 = pad4(a.D);
    const size_t smem = sizeof(float) * (2 * kBKV * D4 +
                                         2 * kTile * (D4 + 4) + 2 * kTile);
    auto kern = flash_bwd_dkv_kernel<DC, DROP>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.Tk + kBKV - 1) / kBKV, a.B * a.H);
    kern<<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.st, a.H, a.Tq, a.Tk, a.D, a.causal, a.sm_scale, a.drop_thr,
        a.drop_scale, a.rng, a.rng_delta);
    return (int)cudaGetLastError();
  }
};

// bfloat16 route: the tensor-core kernels

// The tiles can come by 16-byte cp.async and the outputs be stored in
// pairs: D % 8 == 0 and every pointer and (batch, head, time) stride of
// the tensors the kernel touches a multiple of 16 bytes.
int tc_vec(const Args& a) {
  if (a.D % 8) return 0;
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  for (int t = 0; t < 8; ++t) {
    if (!ptrs[t]) continue;            // not touched by this kernel
    if (reinterpret_cast<unsigned long long>(ptrs[t]) % 16) return 0;
    for (int j = 0; j < 3; ++j)
      if (a.st.s[t][j] % 8) return 0;
  }
  return 1;
}

template <typename T>
struct DqTc {
  template <int DP, bool DROP>
  struct L {
    static int run(const Args& a, cudaStream_t stream) {
      const size_t smem = tc::smem_bytes<tc::DqCfg<DP> >();
      auto kern = tc::flash_bwd_dq_mma<T, DP, DROP>;
      cudaError_t err = allow_smem(kern, smem);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid(a.B * a.H, (a.Tq + tc::kRes - 1) / tc::kRes);
      kern<<<grid, tc::kThreads, smem, stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.o),
          static_cast<const T*>(a.dout), a.lse, static_cast<T*>(a.dq),
          a.delta, a.st, a.H, a.Tq, a.Tk, a.D, a.causal, a.sm_scale,
          tc_vec(a), a.drop_thr, a.drop_scale, a.rng, a.rng_delta);
      return (int)cudaGetLastError();
    }
  };
};

template <typename T>
struct DkvTc {
  template <int DP, bool DROP>
  struct L {
    static int run(const Args& a, cudaStream_t stream) {
      const size_t smem = tc::smem_bytes<tc::DkvCfg<DP> >();
      auto kern = tc::flash_bwd_dkv_mma<T, DP, DROP>;
      cudaError_t err = allow_smem(kern, smem);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid(a.B * a.H, (a.Tk + tc::kRes - 1) / tc::kRes);
      kern<<<grid, tc::kThreads, smem, stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
          a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
          a.st, a.H, a.Tq, a.Tk, a.D, a.causal, a.sm_scale, tc_vec(a),
          a.drop_thr, a.drop_scale, a.rng, a.rng_delta);
      return (int)cudaGetLastError();
    }
  };
};

// dtype 0 (float32): F<ceil(D / 32), dropout>; dtype 1 (bfloat16) and 2
// (float16): TC<T>::L<D rounded up to 32, dropout>
template <template <int, bool> class F, template <typename> class TC>
int dispatch(const Args& a, int dtype, cudaStream_t stream) {
  if (a.D < 1 || a.D > 128 || a.Tq < 1 || a.Tk < 1 || dtype < 0 ||
      dtype > 2 || (a.causal && a.Tk < a.Tq))
    return (int)cudaErrorInvalidValue;
  const int dc = (a.D + 31) / 32;
#define BWD_CASE(L, DC, N)                                                   \
  if (dc == DC)                                                              \
    return a.dropout ? L<N, true>::run(a, stream)                            \
                     : L<N, false>::run(a, stream);
  if (dtype == 0) {
    BWD_CASE(F, 1, 1) BWD_CASE(F, 2, 2) BWD_CASE(F, 3, 3) BWD_CASE(F, 4, 4)
  } else if (dtype == 1) {
    BWD_CASE(TC<tc::bf16>::template L, 1, 32)
    BWD_CASE(TC<tc::bf16>::template L, 2, 64)
    BWD_CASE(TC<tc::bf16>::template L, 3, 96)
    BWD_CASE(TC<tc::bf16>::template L, 4, 128)
  } else {
    BWD_CASE(TC<tc::f16>::template L, 1, 32)
    BWD_CASE(TC<tc::f16>::template L, 2, 64)
    BWD_CASE(TC<tc::f16>::template L, 3, 96)
    BWD_CASE(TC<tc::f16>::template L, 4, 128)
  }
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, const long long* strides, int B, int H,
               int Tq, int Tk, int D, int causal, float sm_scale,
               int dropout, unsigned drop_thr, float drop_scale,
               const unsigned long long* rng, unsigned rng_delta) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) a.st.s[t][j] = strides[3 * t + j];
  a.B = B; a.H = H; a.Tq = Tq; a.Tk = Tk; a.D = D; a.causal = causal;
  a.sm_scale = sm_scale; a.dropout = dropout; a.drop_thr = drop_thr;
  a.drop_scale = drop_scale; a.rng = rng; a.rng_delta = rng_delta;
  return a;
}

}  // namespace

// strides: 24 element strides, (batch, head, time) for q, k, v, o, dO, dq,
// dk, dv in turn (entries of tensors a kernel does not touch are ignored);
// every head_dim stride must be 1. dtype: 0 float32, 1 bfloat16, 2
// float16. lse and
// delta: [B*H, Tq] float32 (flash_bwd_dq writes delta, flash_bwd_dkv reads
// it). dropout as in flash_fwd: (seed, offset) = (rng[0], rng[1] +
// rng_delta), from the forward's word and delta. Each returns
// cudaGetLastError() after its launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, void* dq, float* delta,
                            const long long* strides, int B, int H, int Tq,
                            int Tk, int D, int causal, float sm_scale,
                            int dtype, int dropout, unsigned drop_thr,
                            float drop_scale,
                            const unsigned long long* rng,
                            unsigned rng_delta, cudaStream_t stream) {
  const Args a = make_args(q, k, v, o, dout, lse, delta, dq, nullptr,
                           nullptr, strides, B, H, Tq, Tk, D, causal,
                           sm_scale, dropout, drop_thr, drop_scale, rng,
                           rng_delta);
  return dispatch<DqLauncher, DqTc>(a, dtype, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const long long* strides, int B, int H, int Tq,
                             int Tk, int D, int causal, float sm_scale,
                             int dtype, int dropout, unsigned drop_thr,
                             float drop_scale,
                             const unsigned long long* rng,
                             unsigned rng_delta, cudaStream_t stream) {
  const Args a = make_args(q, k, v, nullptr, dout, lse,
                           const_cast<float*>(delta), nullptr, dk, dv,
                           strides, B, H, Tq, Tk, D, causal, sm_scale,
                           dropout, drop_thr, drop_scale, rng, rng_delta);
  return dispatch<DkvLauncher, DkvTc>(a, dtype, stream);
}
