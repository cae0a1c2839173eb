// Flash-attention forward for Hopper (sm_90a), float32 accumulation, with
// the training options: an lse output and attention dropout. bfloat16
// inputs run on the tensor cores; float32 inputs keep the CUDA-core kernel.
//
// Replaces paddle_tpu/ops/pallas_kernels.py `_flash_fwd_kernel` (:324,
// launched by `_flash_fwd` :412, call :445): out = softmax(Q K^T * D^-1/2) V
// per (batch*head), online softmax over K/V tiles, causal mask aligned
// bottom-right (a query row i sees keys j <= i + Tk - Tq), tiles past the
// diagonal skipped. The TPU kernel carries its softmax state across a
// sequential grid axis; here one CTA loops over the key tiles itself.
//
// Training options (both off on the serving path, where no lse pointer is
// passed and the dropout branch is compiled out):
//   * lse [B*H, Tq] float32 = m + log l of the scaled scores, the one
//     number per row the backward kernels need. The TPU kernel stores it
//     broadcast over 128 lanes ([B*H, Tq, 128]) because a TPU vector store
//     is 128 lanes wide; the port keeps one value per row.
//   * dropout at p: the keep mask (attn_dropout.cuh, Philox bits per
//     element) drops exp-scores of the P V product only; the softmax
//     denominator l sums the undropped scores, which equals
//     dropout(softmax(s)) V exactly, as `_flash_fwd_kernel` computes it.
//
// bfloat16 route (namespace tc): FlashAttention-2's forward on
// mma.sync.m16n8k16 bf16 x bf16 -> f32, with the building blocks of
// tc_mma.cuh that the backward kernels (flash_bwd.cu) use too.
//   * Tiles. A CTA of 4 warps owns 64 query rows, 16 a warp; each warp
//     loads its Q fragments once (ldmatrix) and keeps them in registers.
//     K/V tiles of 64 keys stream through two cp.async stages, shared rows
//     padded by 16 bytes.
//   * S in registers. S = Q K^T accumulates in f32 and is scaled after the
//     product (a bf16 operand scaled first would add a rounding the plain
//     version lacks). The online softmax runs on the accumulator
//     fragments: a thread holds rows g and g + 8 of its warp, so a row max
//     takes two shuffles within the quad; l is kept per thread in f32 from
//     the undropped p and summed over the quad once, at the end.
//   * P V from registers. The f32 accumulators of two neighbouring n8
//     tiles of P, packed to bf16 pairs, are the A fragment of a k16 step,
//     and V comes by ldmatrix.trans: nothing of size [Tq, Tk] touches
//     shared or device memory. P is rounded to bf16 once (the mask drops
//     it to 0 or keeps it; the 1/(1-p) scale is applied with 1/l at the
//     end, so a row with one live key gives o = v exactly).
//     tests/test_torch_flash_fwd.py repeats this rounding on the CPU: its
//     worst case at the card check's shapes is ~1.3e-3 of the largest
//     output, under a quarter of the check's 1e-2, so P needs no hi + lo
//     pair (the backward's M o p and dS do).
//   * Dropout. The per-warp Philox stage of tc_mma.cuh: one call per 4
//     elements, each lane the call of one of a tile's 32 (row group,
//     column) pairs; n8 tiles wholly above a warp's causal diagonal draw
//     nothing.
//   * Work order and edges. Tiles above the causal diagonal are skipped
//     (by the CTA, and by a warp whose rows all end before the tile), the
//     CTAs with the most tiles (the last query tiles) launch first. With
//     D % 8 == 0 and every row 16-byte aligned the tiles come by cp.async;
//     otherwise by element loads, and the output by element stores.
//     D <= 128, any Tq/Tk.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at GPT-2's
// training shape (B=16, H=12, T=512, D=64, causal) 25.2 M live (row, key)
// pairs, 2 products of 2 D flops each (6.4 GFLOP, 0.0065 ms) against
// ~50 MB of q, k, v, o and lse (0.0151 ms): bound by bytes on paper; the
// Philox calls at p = 0.1 (one per 4 elements, ~90 integer instructions)
// and mma.sync's share of the tensor-core peak bound it in practice. At
// the serving prefill shapes (B=1, H=12, T <= 256) the work is a few
// microseconds and the kernel latency-bound.
//
// float32 route: one CTA (4 warps) per (batch*head, 16-row query tile).
// Each K/V tile of 32 keys is staged in shared memory as float32: every
// warp loads 8 of its rows with all loads issued before the first store.
// Each warp owns 4 query rows: lane l takes key l of the tile, reads its K
// row once per 4 head-dim values (float4, rows padded to a stride of
// D4 + 4 floats) and the 4 query rows as broadcasts; shuffles reduce max
// and sum per row; for P V, lane l accumulates output columns l, l+32, ...
// of all 4 rows. One Philox call per lane and tile gives the dropout bits
// of the warp's 4 rows. Its FMAs run on the CUDA cores in full float32:
// the serving path's float32 cache and the float32 compares (1e-4) need
// that, which TF32 would not meet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attn_dropout.cuh"
#include "tc_mma.cuh"

namespace {

constexpr int kBQ = 16;                  // query rows per CTA
constexpr int kBK = 32;                  // keys per tile (one per lane)
constexpr int kWarps = 4;
constexpr int kR = kBQ / kWarps;         // query rows per warp
constexpr int kLoadRows = kBK / kWarps;  // tile rows each warp loads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores (see the note at the top)

namespace tc {

constexpr int kFwdBN = 64;             // keys a streamed K/V tile
constexpr float kLn2 = 0.6931471805599453f;

// CTAs an SM the launch bounds aim at: 3 at D <= 64 (168 registers a
// thread: Q fragments, S and the output accumulators), 2 past it
template <int DP>
struct FwdBlocks {
  static constexpr int value = DP <= 64 ? 3 : 2;
};

// Q, two stages of K and V, the warps' Philox stages
template <int DP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(bf16) * (kRes + 4 * kFwdBN) * (DP + 8) +
         sizeof(uint4) * kThreads;
}

// out (and lse) for 64 query rows of one (batch, head). Grid (B*H, query
// tiles), last query tile first. Strides: (batch, head, time) of q, k, v,
// o in turn, in elements.
template <int DP, bool DROP>
__global__ void __launch_bounds__(kThreads, FwdBlocks<DP>::value)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, long long qsb, long long qsh,
              long long qst, long long ksb, long long ksh, long long kst,
              long long vsb, long long vsh, long long vst, long long osb,
              long long osh, long long ost, int H, int Tq, int Tk, int D,
              int causal, float sm_scale, int vec, unsigned drop_thr,
              float drop_scale, unsigned long long seed, unsigned offset) {
  constexpr int BN = kFwdBN, LD = DP + 8, NT = BN / 8, KS = DP / 16;
  constexpr int DT = DP / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* qs = reinterpret_cast<bf16*>(smem_u4);     // [kRes][LD]
  bf16* kvs = qs + kRes * LD;                      // [2][K, V][BN][LD]
  uint4* bits_s = reinterpret_cast<uint4*>(kvs + 4 * BN * LD);  // [4][32]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qp = q + b * qsb + h * qsh;
  const bf16* kp = k + b * ksb + h * ksh;
  const bf16* vp = v + b * vsb + h * vsh;
  const int shift = Tk - Tq;
  const int kend = causal ? min(Tk, q0 + kRes + shift) : Tk;
  const int ntiles = (kend + BN - 1) / BN;

  load_tile<kRes, DP>(qs, qp, qst, q0, Tq, D, vec);
  cp_commit();
  load_tile<BN, DP>(kvs, kp, kst, 0, Tk, D, vec);
  load_tile<BN, DP>(kvs + BN * LD, vp, vst, 0, Tk, D, vec);
  cp_commit();
  cp_wait_prev();                        // Q (K/V tile 0 in flight)
  __syncthreads();

  // lane offsets of ldmatrix: a_off for an A fragment (16 rows x k16) and
  // for two B fragments transposed (k16 rows x 16 columns), b_off for two
  // B fragments from 16 rows (n) x k16
  const int a_off = (lane & 15) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;
  const int r0 = q0 + warp * 16;         // the warp's first row
  const int wlast = r0 + 15 + shift;     // last key its rows see (causal)
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm(qf[kk], qs + warp * 16 * LD + a_off +
                                               kk * 16);
  const float scale_log2 = sm_scale * kLog2e;
  uint4* wbits = bits_s + warp * 32;

  // m: running max of rows g, g + 8 in the log2 domain; l: this thread's
  // share of their denominators
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN;
    if (it + 1 < ntiles) {
      bf16* nxt = kvs + ((it + 1) & 1) * 2 * BN * LD;
      load_tile<BN, DP>(nxt, kp, kst, k0 + BN, Tk, D, vec);
      load_tile<BN, DP>(nxt + BN * LD, vp, vst, k0 + BN, Tk, D, vec);
    }
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    const bf16* ks = kvs + (it & 1) * 2 * BN * LD;
    const bf16* vs = ks + BN * LD;

    if (!causal || k0 <= wlast) {        // else the warp's rows see none
      // S = Q K^T over this tile's keys
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int jn = 0; jn < NT / 2; ++jn) {
          unsigned bk[4];
          ldsm(bk, ks + jn * 16 * LD + b_off + kk * 16);
          mma(s[2 * jn], qf[kk], bk[0], bk[1]);
          mma(s[2 * jn + 1], qf[kk], bk[2], bk[3]);
        }
      }

      // scaled to the log2 domain, masked, and the rows' new max. Element
      // e of tile j: row g + 8 (e / 2), key 8 j + 2 t + e % 2 of the tile.
      const bool edge = k0 + BN > Tk || (causal && k0 + BN - 1 > r0 + shift);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int row = r0 + g + 8 * (e >> 1);
            if (kpos >= Tk || (causal && kpos > row + shift)) x = -INFINITY;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float msub[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a row with no live key yet keeps m = -inf; subtract 0 then so
        // exp2 sees -inf and yields 0 instead of NaN
        msub[i] = mx[i] == -INFINITY ? 0.f : mx[i];
        const float alpha = exp2f(m[i] - msub[i]);
        m[i] = mx[i];
        l[i] *= alpha;
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          acc[dn][2 * i] *= alpha;
          acc[dn][2 * i + 1] *= alpha;
        }
      }

      // p in place of S; l takes it undropped, P V the dropped one
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - msub[e >> 1]);
          l[e >> 1] += p;
          s[j][e] = p;
        }
        if (DROP && !(causal && k0 + 8 * j > wlast)) {
          // lane: rows 4 (lane / 8) .. +3 of the warp, key 8 j + lane % 8
          stage_bits(wbits, lane, seed, offset, bh, (r0 >> 2) + (lane >> 3),
                     k0 + 8 * j + (lane & 7));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = g + 8 * (e >> 1), kc = 2 * t + (e & 1);
            if (staged_word(wbits, ((rr >> 2) << 3) + kc, rr & 3) < drop_thr)
              s[j][e] = 0.f;
          }
          __syncwarp();
        }
      }

      // acc += P V: P from registers (rounded once to bf16), V transposed
      // from shared memory
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        unsigned a[4];
        a_from_acc(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DT / 2; ++dn) {
          unsigned bv[4];
          ldsm_t(bv, vs + kk * 16 * LD + a_off + dn * 16);
          mma(acc[2 * dn], a, bv[0], bv[1]);
          mma(acc[2 * dn + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                     // this stage is refilled next
  }

  bf16* op = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + g + 8 * i;
    if (row >= Tq) continue;
    if (lse != nullptr && t == 0)
      lse[(long long)bh * Tq + row] = m[i] * kLn2 + logf(l[i]);
    // the kept values' 1 / (1 - p) with the softmax's 1 / l
    const float inv = (DROP ? drop_scale : 1.f) / l[i];
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int d = dn * 8 + 2 * t;
      if (d < D)
        store_pair(op + row * ost + d, acc[dn][2 * i] * inv,
                   acc[dn][2 * i + 1] * inv, d, D, vec);
    }
  }
}

}  // namespace tc

namespace {

template <int DP, bool DROP>
int launch_tc(const tc::bf16* q, const tc::bf16* k, const tc::bf16* v,
              tc::bf16* o, float* lse, const long long* st, int B, int H,
              int Tq, int Tk, int D, int causal, float sm_scale, int vec,
              unsigned drop_thr, float drop_scale, unsigned long long seed,
              unsigned offset, cudaStream_t stream) {
  const size_t smem = tc::fwd_smem_bytes<DP>();
  auto kern = tc::flash_fwd_mma<DP, DROP>;
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory needs an opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * H, (Tq + tc::kRes - 1) / tc::kRes);
  kern<<<grid, tc::kThreads, smem, stream>>>(
      q, k, v, o, lse, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], H, Tq, Tk, D, causal, sm_scale,
      vec, drop_thr, drop_scale, seed, offset);
  return (int)cudaGetLastError();
}

// The bfloat16 route: tc::flash_fwd_mma<D rounded up to 32, dropout>. The
// tiles come by 16-byte cp.async and the output is stored in pairs when
// D % 8 == 0 and every pointer and (batch, head, time) stride is a
// multiple of 16 bytes; otherwise by element loads and stores.
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, int B, int H, int Tq,
                int Tk, int D, int causal, float sm_scale, int dropout,
                unsigned drop_thr, float drop_scale, unsigned long long seed,
                unsigned offset, cudaStream_t stream) {
  if (D < 1 || D > 128 || Tq < 1 || Tk < 1 || (Tq + tc::kRes - 1) /
      tc::kRes > 65535 || (causal && Tk < Tq))
    return (int)cudaErrorInvalidValue;
  int vec = D % 8 == 0;
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16) vec = 0;
    for (int j = 0; j < 3; ++j)
      if (st[3 * i + j] % 8) vec = 0;
  }
  typedef tc::bf16 bf16;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
#define FWD_TC_CASE(DP)                                                      \
  if (D <= DP)                                                               \
    return dropout ? launch_tc<DP, true>(qq, kk, vv, oo, lse, st, B, H, Tq,  \
                                         Tk, D, causal, sm_scale, vec,       \
                                         drop_thr, drop_scale, seed, offset, \
                                         stream)                             \
                   : launch_tc<DP, false>(qq, kk, vv, oo, lse, st, B, H, Tq, \
                                          Tk, D, causal, sm_scale, vec,      \
                                          drop_thr, drop_scale, seed,        \
                                          offset, stream);
  FWD_TC_CASE(32) FWD_TC_CASE(64) FWD_TC_CASE(96) FWD_TC_CASE(128)
#undef FWD_TC_CASE
  return (int)cudaErrorInvalidValue;
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
    return launch_bf16(q, k, v, o, lse, strides, B, H, Tq, Tk, D, causal,
                       sm_scale, dropout, drop_thr, drop_scale, seed, offset,
                       stream);
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
