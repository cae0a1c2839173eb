// Flash-attention forward for Hopper (sm_90a), float32 accumulation, with
// the training options: an lse output and attention dropout. bfloat16
// inputs run on the tensor cores, float32 inputs on the CUDA cores.
//
// Replaces paddle_tpu/ops/pallas_kernels.py `_flash_fwd_kernel` (:324,
// launched by `_flash_fwd` :412, call :445): out = softmax(Q K^T * D^-1/2) V
// per (batch*head), online softmax over K/V tiles, causal mask aligned
// bottom-right (a query row i sees keys j <= i + Tk - Tq), tiles past the
// diagonal skipped. The TPU kernel carries its softmax state across a
// sequential grid axis; here a CTA's warps loop over the key tiles
// themselves.
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
// bfloat16 and float16 route (namespace tc): FlashAttention-2's forward on
// mma.sync.m16n8k16 bf16 x bf16 -> f32 (f16 x f16 -> f32 for float16, one
// template instance a type: the notes below say bf16 for either), with
// the building blocks of tc_mma.cuh that the backward kernels
// (flash_bwd.cu) use too. P lies in [0, 1], so float16's narrower range
// takes it as it is (a p below 2^-24 rounds to 0, as it would in the
// float16 output).
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
// float32 route (namespace f32): full float32 FMA on the CUDA cores. TF32
// would not meet the float32 checks (1e-4). At the serving buckets the
// work is a few microseconds; what sets the time is the CTA with the most
// keys (the last query tile): its serial chain, and the shared-memory
// loads that feed its FMAs, which all run on one SM.
//   * Keys split across warps. A CTA of NW warps (8 up to D = 64, 4 past
//     it) owns 16 query rows; its causal key range, in tiles of BK = 8 or
//     16 keys, is dealt out to the warps in turn (tile t to warp t % NW),
//     and each warp keeps an online-softmax state (m, l, acc) for all 16
//     rows over its own tiles. At the end the CTA combines the NW states
//     in shared memory in warp order: out = sum acc_w e^(m_w - M) / sum
//     l_w e^(m_w - M), lse = M + log L. BK is 8 where that covers a
//     warp's share of the last query tile's keys, else 16
//     (cuda_kernels.flash_f32_geometry): at T = 32, 128 and 256 the
//     longest chain is 1, 1 and 2 tiles a warp, where the CTA of the
//     earlier design walked T / 32 tiles of 32 keys in a row. The CTAs
//     with the most tiles are dispatched first.
//   * Register micro-tiles. In S = Q K^T a lane (rg = lane / 8, kg =
//     lane % 8) takes rows 4 rg .. 4 rg + 3 against keys kg + 8 i, i <
//     BK / 8: per 4 head-dim values, 5 or 6 shared float4 loads feed 16 or
//     32 FMAs, and the K rows a quarter-warp reads (row stride D + 4
//     floats) fall in distinct banks. The row max takes 3 shuffles among
//     the 8 lanes of a row group; l stays a per-lane partial, summed once
//     at the end. S is scaled after the product, as the plain version
//     scales it.
//   * P staged in shared memory. Each lane stores its 4 rows of a key as
//     one float4 (P as [key][row], stride 20); in P V a lane owns the same
//     4 rows and columns 4 kg .. 4 kg + 3 (+ 32 c), and reads a key's 4 p
//     as one float4 broadcast and its V columns as float4: no shuffle.
//   * Tiles by cp.async. Every warp has its own K, V and P stage and brings
//     its tiles in by 16-byte cp.async (zeros past Tk) where D % 4 == 0 and
//     the rows are 16-byte aligned, else by element copies. A warp's next
//     K is requested as soon as S is formed and its next V as soon as P V
//     is done, so each load runs under the other half of the tile.
//   * Dropout: the mask of attn_dropout.cuh, one Philox call per lane and
//     key for its 4-row group (a function of (bh, row / 4, key) alone, so
//     the backward kernels and attn_dropout_bits regenerate it); l takes
//     the undropped p, P V the dropped one, and 1 / (1 - p) comes with
//     1 / l at the end.
//   * Edges: any Tq, Tk (bottom-right causal with Tq < Tk), D <= 128,
//     any strides with a unit head-dim stride.
//   Tried on the H100 and dropped (PERF.md, section 6): tiles of 32 keys (one
//   CTA an SM, slower at T = 256), and the key range of the longest query
//   tiles split across CTAs with a ticket combine (slower at every bucket).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attn_dropout.cuh"
#include "tc_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 route (see the note at the top)

namespace f32 {

constexpr int kBQ = 16;                  // query rows a CTA
constexpr int kPP = 20;                  // P row stride: 16 rows + pad

__host__ __device__ __forceinline__ int pad4(int d) { return (d + 3) & ~3; }

// floats of a warp's stage for tiles of BK keys: K [BK][D4 + 4], V [BK]
// [32 DC], P [BK][kPP]
__host__ __device__ __forceinline__ int warp_floats(int D, int DC, int BK) {
  return BK * (pad4(D) + 4 + 32 * DC + kPP);
}

// Q and NW warps' stages; the combine reuses the stages (acc [NW][kBQ][D4],
// m and l [NW][kBQ], [kBQ] scales), which always fit: BK >= 8 and
// D4 <= 32 DC
__host__ __device__ __forceinline__ size_t smem_bytes(int D, int DC, int BK,
                                                      int NW) {
  return sizeof(float) * (kBQ * pad4(D) + NW * warp_floats(D, DC, BK));
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + n - 1 of a [rows, D] slab (row stride st, rows from
// `lim` on read as zeros) into dst [n][ld], by threads t0, t0 + nt, ...:
// 16-byte cp.async when vec (D % 4 == 0), else element copies that also
// zero the pad columns D .. width - 1
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long st,
                                          int r0, int n, int lim, int D,
                                          int width, int vec, int t0,
                                          int nt) {
  if (vec) {
    const int c4 = D >> 2;
    for (int i = t0; i < n * c4; i += nt) {
      const int r = i / c4, c = i - r * c4, row = r0 + r;
      const bool ok = row < lim;
      tc::cp_async16(dst + r * ld + 4 * c, src + (ok ? row : 0) * st + 4 * c,
                     ok);
    }
  } else {
    for (int i = t0; i < n * width; i += nt) {
      const int r = i / width, d = i - r * width, row = r0 + r;
      dst[r * ld + d] = row < lim && d < D ? src[row * st + d] : 0.f;
    }
  }
}

// out (and lse) for 16 query rows of one (batch, head). Grid (B*H, query
// tiles), so every (batch, head)'s last query tile is dispatched first. NW
// warps, tiles of BK = 8 KI keys (a lane takes KI of them), DC = ceil(D /
// 32): float4 column groups of 32 a lane owns in P V.
template <int DC, int KI, int NW, bool DROP>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, long long qsb, long long qsh,
              long long qst, long long ksb, long long ksh, long long kst,
              long long vsb, long long vsh, long long vst, long long osb,
              long long osh, long long ost, int H, int Tq, int Tk, int D,
              int causal, float sm_scale, int vec, unsigned drop_thr,
              float drop_scale, const unsigned long long* __restrict__ rng,
              unsigned rng_delta) {
  constexpr int BK = 8 * KI, NT = NW * 32;
  unsigned long long seed = 0;            // the call's dropout key, read
  unsigned offset = 0;                    // once from the Philox word
  if (DROP) attn_dropout::load_key(rng, rng_delta, seed, offset);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D4 = pad4(D), KP = D4 + 4, VP = 32 * DC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, kg = lane & 7;
  float* qs = smem;                                  // [kBQ][D4]
  float* ks = qs + kBQ * D4 + warp * warp_floats(D, DC, BK);
  float* vs = ks + BK * KP;                          // [BK][VP]
  float* ps = vs + BK * VP;                          // [BK][kPP]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qp = q + b * qsb + h * qsh;
  const float* kp = k + b * ksb + h * ksh;
  const float* vp = v + b * vsb + h * vsh;
  const int shift = Tk - Tq;
  const int kend = causal ? min(Tk, q0 + kBQ + shift) : Tk;
  const int ntiles = (kend + BK - 1) / BK;

  // cp.async groups a lane has: Q, then K and V of its warp's first tile
  load_rows(qs, D4, qp, qst, q0, kBQ, Tq, D, D4, vec, tid, NT);
  tc::cp_commit();
  int t = warp;
  if (t < ntiles) load_rows(ks, KP, kp, kst, t * BK, BK, Tk, D, D4, vec,
                            lane, 32);
  tc::cp_commit();
  if (t < ntiles) load_rows(vs, VP, vp, vst, t * BK, BK, Tk, D, D4, vec,
                            lane, 32);
  tc::cp_commit();
  cp_wait<1>();                          // Q and K landed
  __syncthreads();                       // Q from every thread

  // rows 4 rg + ii of the CTA: m running max, l this lane's share of the
  // denominator, acc columns 32 c + 4 kg + e
  float m[4], l[4], acc[4][4 * DC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = -INFINITY;
    l[ii] = 0.f;
#pragma unroll
    for (int x = 0; x < 4 * DC; ++x) acc[ii][x] = 0.f;
  }
  const float* qrow = qs + 4 * rg * D4;
  const float* krow = ks + kg * KP;

  for (; t < ntiles; t += NW) {
    __syncwarp();                        // K(t) from every lane
    float s[4][KI];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int i = 0; i < KI; ++i) s[ii][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D4; d += 4) {
      float4 qv[4], kv[KI];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        qv[ii] = *reinterpret_cast<const float4*>(qrow + ii * D4 + d);
#pragma unroll
      for (int i = 0; i < KI; ++i)
        kv[i] = *reinterpret_cast<const float4*>(krow + 8 * i * KP + d);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          s[ii][i] = fmaf(qv[ii].x, kv[i].x, s[ii][i]);
          s[ii][i] = fmaf(qv[ii].y, kv[i].y, s[ii][i]);
          s[ii][i] = fmaf(qv[ii].z, kv[i].z, s[ii][i]);
          s[ii][i] = fmaf(qv[ii].w, kv[i].w, s[ii][i]);
        }
    }
    __syncwarp();                        // K(t) consumed
    const int tn = t + NW;
    if (tn < ntiles) load_rows(ks, KP, kp, kst, tn * BK, BK, Tk, D, D4, vec,
                               lane, 32);
    tc::cp_commit();

    // scaled, masked, the rows' new max among the 8 lanes of the group;
    // p in place of s (l takes it undropped)
    const int k0 = t * BK;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = q0 + 4 * rg + ii;
      float mx = m[ii];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const int key = k0 + kg + 8 * i;
        const bool ok = key < Tk && (!causal || key <= row + shift);
        s[ii][i] = ok ? s[ii][i] * sm_scale : -INFINITY;
        mx = fmaxf(mx, s[ii][i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // a row with no live key yet keeps m = -inf; subtract 0 then so
      // exp() sees -inf and yields 0 instead of NaN
      const float msub = mx == -INFINITY ? 0.f : mx;
      const float alpha = expf(m[ii] - msub);
      m[ii] = mx;
      l[ii] *= alpha;
#pragma unroll
      for (int x = 0; x < 4 * DC; ++x) acc[ii][x] *= alpha;
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        s[ii][i] = expf(s[ii][i] - msub);
        l[ii] += s[ii][i];
      }
    }
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const int key = k0 + kg + 8 * i;
      if (DROP && key < Tk && (!causal || key <= q0 + 4 * rg + 3 + shift)) {
        const uint4 bits = attn_dropout::bits4(seed, offset, bh,
                                               (q0 >> 2) + rg, key);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          if (attn_dropout::word(bits, ii) < drop_thr) s[ii][i] = 0.f;
      }
      *reinterpret_cast<float4*>(ps + (kg + 8 * i) * kPP + 4 * rg) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
    }
    cp_wait<1>();                        // V(t) landed
    __syncwarp();                        // V(t) and P from every lane

    // acc += P V
    const float* pr = ps + 4 * rg;
    const float* vr = vs + 4 * kg;
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(pr + j * kPP);
      const float pv[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vr + j * VP + 32 * c);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          acc[ii][4 * c] = fmaf(pv[ii], vv.x, acc[ii][4 * c]);
          acc[ii][4 * c + 1] = fmaf(pv[ii], vv.y, acc[ii][4 * c + 1]);
          acc[ii][4 * c + 2] = fmaf(pv[ii], vv.z, acc[ii][4 * c + 2]);
          acc[ii][4 * c + 3] = fmaf(pv[ii], vv.w, acc[ii][4 * c + 3]);
        }
      }
    }
    __syncwarp();                        // V(t) and P consumed
    if (tn < ntiles) load_rows(vs, VP, vp, vst, tn * BK, BK, Tk, D, D4, vec,
                               lane, 32);
    tc::cp_commit();
    cp_wait<1>();                        // K(tn) landed
  }
  cp_wait<0>();

  // the warps' states to shared memory, over their stages: acc [NW][kBQ]
  // [D4], then m and l [NW][kBQ]
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 1);
    l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 2);
    l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 4);
  }
  __syncthreads();                       // every warp done with its stage
  float* s_acc = qs + kBQ * D4;
  float* s_m = s_acc + NW * kBQ * D4;
  float* s_l = s_m + NW * kBQ;
  float* s_inv = s_l + NW * kBQ;         // [kBQ]: the scale of each row
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int r = 4 * rg + ii;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = 32 * c + 4 * kg;
      if (col < D4)
        *reinterpret_cast<float4*>(s_acc + (warp * kBQ + r) * D4 + col) =
            make_float4(acc[ii][4 * c], acc[ii][4 * c + 1],
                        acc[ii][4 * c + 2], acc[ii][4 * c + 3]);
    }
    if (kg == 0) {
      s_m[warp * kBQ + r] = m[ii];
      s_l[warp * kBQ + r] = l[ii];
    }
  }
  __syncthreads();

  // per row: M, L and each warp's weight e^(m_w - M), in warp order; M is
  // finite for a row < Tq (key 0 is live to it, in warp 0's first tile)
  if (tid < kBQ) {
    const int row = q0 + tid;
    float M = s_m[tid];
#pragma unroll
    for (int w = 1; w < NW; ++w) M = fmaxf(M, s_m[w * kBQ + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(s_m[w * kBQ + tid] - M);
      s_m[w * kBQ + tid] = e;
      L += e * s_l[w * kBQ + tid];
    }
    s_inv[tid] = (DROP ? drop_scale : 1.f) / L;
    if (lse != nullptr && row < Tq) lse[(long long)bh * Tq + row] =
        M + logf(L);
  }
  __syncthreads();
  float* op = o + b * osb + h * osh;
  for (int i = tid; i < kBQ * D; i += NT) {
    const int r = i / D, d = i - r * D, row = q0 + r;
    if (row >= Tq) continue;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      a = fmaf(s_m[w * kBQ + r], s_acc[(w * kBQ + r) * D4 + d], a);
    op[row * ost + d] = a * s_inv[r];
  }
}

template <int DC, int KI, int NW, bool DROP>
int launch_dc(const float* q, const float* k, const float* v, float* o,
              float* lse, const long long* st, int B, int H, int Tq, int Tk,
              int D, int causal, float sm_scale, int vec, unsigned drop_thr,
              float drop_scale, const unsigned long long* rng,
              unsigned rng_delta,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(D, DC, 8 * KI, NW);
  auto kern = flash_fwd_f32<DC, KI, NW, DROP>;
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory needs an opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  kern<<<grid, NW * 32, smem, stream>>>(
      q, k, v, o, lse, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], H, Tq, Tk, D, causal, sm_scale,
      vec, drop_thr, drop_scale, rng, rng_delta);
  return (int)cudaGetLastError();
}

// the instance for D (DC = ceil(D / 32); 8 warps up to D = 64, 4 past it,
// so that two CTAs fit an SM) and tiles of `tile` keys
template <int DC, bool DROP>
int launch_tile(const float* q, const float* k, const float* v, float* o,
                float* lse, const long long* st, int B, int H, int Tq,
                int Tk, int D, int causal, float sm_scale, int vec,
                int warps, int tile, unsigned drop_thr, float drop_scale,
                const unsigned long long* rng, unsigned rng_delta,
                cudaStream_t stream) {
  constexpr int NW = DC <= 2 ? 8 : 4;
  if (warps != NW) return (int)cudaErrorInvalidValue;
#define F32_TILE(KI)                                                         \
  return launch_dc<DC, KI, NW, DROP>(q, k, v, o, lse, st, B, H, Tq, Tk, D,   \
                                     causal, sm_scale, vec, drop_thr,        \
                                     drop_scale, rng, rng_delta, stream)
  switch (tile) {
    case 8: F32_TILE(1);
    case 16: F32_TILE(2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef F32_TILE
}

}  // namespace f32

// The float32 route: f32::flash_fwd_f32 for D, `warps` and `tile`
// (cuda_kernels.flash_f32_geometry). The tiles come by 16-byte cp.async
// when D % 4 == 0 and every pointer and (batch, head, time) stride of q, k
// and v is a multiple of 16 bytes; otherwise by element copies.
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const long long* st, int B, int H, int Tq, int Tk,
               int D, int causal, float sm_scale, int warps, int tile,
               int dropout, unsigned drop_thr, float drop_scale,
               const unsigned long long* rng, unsigned rng_delta,
               cudaStream_t stream) {
  if (D < 1 || D > 128 || Tq < 1 || Tk < 1 ||
      (Tq + f32::kBQ - 1) / f32::kBQ > 65535 || (causal && Tk < Tq))
    return (int)cudaErrorInvalidValue;
  int vec = D % 4 == 0;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16) vec = 0;
    for (int j = 0; j < 3; ++j)
      if (st[3 * i + j] % 4) vec = 0;
  }
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
#define FWD_F32_CASE(DC)                                                     \
  if (D <= 32 * DC)                                                          \
    return dropout                                                           \
        ? f32::launch_tile<DC, true>(qq, kk, vv, oo, lse, st, B, H, Tq, Tk,  \
                                     D, causal, sm_scale, vec, warps, tile,  \
                                     drop_thr, drop_scale, rng, rng_delta,   \
                                     stream)                                 \
        : f32::launch_tile<DC, false>(qq, kk, vv, oo, lse, st, B, H, Tq, Tk, \
                                      D, causal, sm_scale, vec, warps, tile, \
                                      drop_thr, drop_scale, rng, rng_delta,  \
                                      stream);
  FWD_F32_CASE(1) FWD_F32_CASE(2) FWD_F32_CASE(3) FWD_F32_CASE(4)
#undef FWD_F32_CASE
  return (int)cudaErrorInvalidValue;
}

// Bits of the dropout mask, [B*H, Tq, Tk] uint32: one thread per (column,
// 4-row group), the counter layout of attn_dropout.cuh.
__global__ void attn_dropout_bits_kernel(
    unsigned* __restrict__ out, const unsigned long long* __restrict__ rng,
    unsigned rng_delta, int Tq, int Tk) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int group = blockIdx.y, bh = blockIdx.z;
  if (col >= Tk) return;
  unsigned long long seed;
  unsigned offset;
  attn_dropout::load_key(rng, rng_delta, seed, offset);
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

// Q, two stages of K and V (2-byte elements), the warps' Philox stages
template <int DP>
constexpr size_t fwd_smem_bytes() {
  return 2 * (kRes + 4 * kFwdBN) * (DP + 8) +
         sizeof(uint4) * kThreads;
}

// out (and lse) for 64 query rows of one (batch, head). Grid (B*H, query
// tiles), last query tile first. Strides: (batch, head, time) of q, k, v,
// o in turn, in elements.
template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads, FwdBlocks<DP>::value)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, long long qsb, long long qsh,
              long long qst, long long ksb, long long ksh, long long kst,
              long long vsb, long long vsh, long long vst, long long osb,
              long long osh, long long ost, int H, int Tq, int Tk, int D,
              int causal, float sm_scale, int vec, unsigned drop_thr,
              float drop_scale, const unsigned long long* __restrict__ rng,
              unsigned rng_delta) {
  constexpr int BN = kFwdBN, LD = DP + 8, NT = BN / 8, KS = DP / 16;
  unsigned long long seed = 0;            // the call's dropout key, read
  unsigned offset = 0;                    // once from the Philox word
  if (DROP) attn_dropout::load_key(rng, rng_delta, seed, offset);
  constexpr int DT = DP / 8;
  extern __shared__ uint4 smem_u4[];
  T* qs = reinterpret_cast<T*>(smem_u4);           // [kRes][LD]
  T* kvs = qs + kRes * LD;                         // [2][K, V][BN][LD]
  uint4* bits_s = reinterpret_cast<uint4*>(kvs + 4 * BN * LD);  // [4][32]

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
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
      T* nxt = kvs + ((it + 1) & 1) * 2 * BN * LD;
      load_tile<BN, DP>(nxt, kp, kst, k0 + BN, Tk, D, vec);
      load_tile<BN, DP>(nxt + BN * LD, vp, vst, k0 + BN, Tk, D, vec);
    }
    cp_commit();
    cp_wait_prev();
    __syncthreads();
    const T* ks = kvs + (it & 1) * 2 * BN * LD;
    const T* vs = ks + BN * LD;

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
          mma<T>(s[2 * jn], qf[kk], bk[0], bk[1]);
          mma<T>(s[2 * jn + 1], qf[kk], bk[2], bk[3]);
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

      // acc += P V: P from registers (rounded once to T), V transposed
      // from shared memory
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        unsigned a[4];
        a_from_acc<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DT / 2; ++dn) {
          unsigned bv[4];
          ldsm_t(bv, vs + kk * 16 * LD + a_off + dn * 16);
          mma<T>(acc[2 * dn], a, bv[0], bv[1]);
          mma<T>(acc[2 * dn + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                     // this stage is refilled next
  }

  T* op = o + b * osb + h * osh;
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

template <typename T, int DP, bool DROP>
int launch_tc(const T* q, const T* k, const T* v, T* o, float* lse,
              const long long* st, int B, int H,
              int Tq, int Tk, int D, int causal, float sm_scale, int vec,
              unsigned drop_thr, float drop_scale,
              const unsigned long long* rng, unsigned rng_delta,
              cudaStream_t stream) {
  const size_t smem = tc::fwd_smem_bytes<DP>();
  auto kern = tc::flash_fwd_mma<T, DP, DROP>;
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
      vec, drop_thr, drop_scale, rng, rng_delta);
  return (int)cudaGetLastError();
}

// The 16-bit route (T bfloat16 or float16): tc::flash_fwd_mma<T, D rounded
// up to 32, dropout>. The tiles come by 16-byte cp.async and the output is
// stored in pairs when D % 8 == 0 and every pointer and (batch, head,
// time) stride is a multiple of 16 bytes; otherwise by element loads and
// stores.
template <typename T>
int launch_16(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, int B, int H, int Tq,
                int Tk, int D, int causal, float sm_scale, int dropout,
                unsigned drop_thr, float drop_scale,
                const unsigned long long* rng, unsigned rng_delta,
                cudaStream_t stream) {
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
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
#define FWD_TC_CASE(DP)                                                      \
  if (D <= DP)                                                               \
    return dropout                                                           \
               ? launch_tc<T, DP, true>(qq, kk, vv, oo, lse, st, B, H, Tq,   \
                                        Tk, D, causal, sm_scale, vec,        \
                                        drop_thr, drop_scale, rng,           \
                                        rng_delta, stream)                   \
               : launch_tc<T, DP, false>(qq, kk, vv, oo, lse, st, B, H, Tq,  \
                                         Tk, D, causal, sm_scale, vec,       \
                                         drop_thr, drop_scale, rng,          \
                                         rng_delta, stream);
  FWD_TC_CASE(32) FWD_TC_CASE(64) FWD_TC_CASE(96) FWD_TC_CASE(128)
#undef FWD_TC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 element strides, (batch, head, time) for q, k, v, o in turn;
// the head_dim stride must be 1. dtype: 0 float32, 1 bfloat16, 2 float16.
// lse: null,
// or [B*H, Tq] float32. dropout: 0 off, else keep iff bits >= drop_thr and
// kept values times drop_scale, bits keyed by (seed, offset) = (rng[0],
// rng[1] + rng_delta), read from the Philox word in device memory (null
// without dropout; attn_dropout.cuh). float32 only:
// `warps` and `tile` (8 or 16 keys), cuda_kernels.flash_f32_geometry's; the
// 16-bit routes ignore them.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, const long long* strides,
                         int B, int H, int Tq, int Tk, int D, int causal,
                         float sm_scale, int dtype, int warps, int tile,
                         int dropout, unsigned drop_thr, float drop_scale,
                         const unsigned long long* rng, unsigned rng_delta,
                         cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32(q, k, v, o, lse, strides, B, H, Tq, Tk, D, causal,
                      sm_scale, warps, tile, dropout, drop_thr, drop_scale,
                      rng, rng_delta, stream);
  if (dtype == 1)
    return launch_16<tc::bf16>(q, k, v, o, lse, strides, B, H, Tq, Tk, D,
                               causal, sm_scale, dropout, drop_thr,
                               drop_scale, rng, rng_delta, stream);
  if (dtype == 2)
    return launch_16<tc::f16>(q, k, v, o, lse, strides, B, H, Tq, Tk, D,
                              causal, sm_scale, dropout, drop_thr,
                              drop_scale, rng, rng_delta, stream);
  return (int)cudaErrorInvalidValue;
}

// out: [BH, Tq, Tk] uint32 (stored in an int32 tensor), the bits of the
// key (rng[0], rng[1] + rng_delta).
extern "C" int attn_dropout_bits(void* out, const unsigned long long* rng,
                                 unsigned rng_delta, int BH, int Tq, int Tk,
                                 cudaStream_t stream) {
  if (BH < 1 || Tq < 1 || Tk < 1 || BH > 65535 || (Tq + 3) / 4 > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tk + 127) / 128, (Tq + 3) / 4, BH);
  attn_dropout_bits_kernel<<<grid, 128, 0, stream>>>(
      static_cast<unsigned*>(out), rng, rng_delta, Tq, Tk);
  return (int)cudaGetLastError();
}
