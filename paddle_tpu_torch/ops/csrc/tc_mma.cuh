// Tensor-core building blocks shared by the bfloat16 flash kernels
// (flash_fwd.cu's forward, flash_bwd.cu's dq and dk/dv): cp.async copies,
// ldmatrix, mma.sync.m16n8k16 bf16 x bf16 -> f32, the repacking of an f32
// accumulator as the A fragment of the next product, tile loads and pair
// stores with their element-wise edge route, and the per-warp stage of
// the attention-dropout Philox words.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): a lane l holds
// g = l / 4 and t = l % 4; accumulator element e of an m16n8 tile is row
// g + 8 (e / 2), column 2 t + e % 2. Every kernel that includes this runs
// 128 threads (4 warps) a CTA, and its shared rows are DP + 8 elements
// long (DP the head dim rounded up to 32): the 16-byte pad puts the 8 row
// addresses of every ldmatrix phase in 8 distinct 4-bank groups.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attn_dropout.cuh"

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;          // 4 warps
constexpr int kRes = 64;               // resident rows a CTA, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared without a register; zeros if !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group have landed (this thread's copies)
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one bf16 pair register, lo in the low half
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// x, y as a bf16 pair hi and the pair lo of what hi leaves out (x - hi
// is exact in f32): hi + lo holds x to 2^-17 relative, where hi alone
// holds it to 2^-9
__device__ __forceinline__ void split(unsigned& hi, unsigned& lo, float x,
                                      float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack(x - f.x, y - f.y);
}

// The A fragment (16 x k16) made of the accumulators of n8 tiles j, j+1,
// as hi and lo fragments: a0/a1 are rows g / g+8 of tile j, a2/a3 the
// same of tile j+1.
__device__ __forceinline__ void a_from_acc(unsigned (&hi)[4],
                                           unsigned (&lo)[4],
                                           const float (&c0)[4],
                                           const float (&c1)[4]) {
  split(hi[0], lo[0], c0[0], c0[1]);
  split(hi[1], lo[1], c0[2], c0[3]);
  split(hi[2], lo[2], c1[0], c1[1]);
  split(hi[3], lo[3], c1[2], c1[3]);
}

// The same A fragment rounded once (hi alone)
__device__ __forceinline__ void a_from_acc(unsigned (&a)[4],
                                           const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Rows [row0, row0 + R) of a [T, D] head slice (time stride ts) into
// shared rows of LD elements, columns [0, DP); rows >= T and columns >= D
// become zeros. vec: 16-byte cp.async (D % 8 == 0, rows 16-byte aligned);
// otherwise element loads, which land before the next __syncthreads.
template <int R, int DP>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long ts, int row0, int T,
                                          int D, bool vec) {
  constexpr int LD = DP + 8, CH = DP / 8;
  if (vec) {
#pragma unroll
    for (int j = 0; j < (R * CH + kThreads - 1) / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / CH, c = i - r * CH, row = row0 + r;
      const bool ok = row < T && c * 8 < D;
      if (i < R * CH)
        cp_async16(s + r * LD + c * 8, ok ? g + row * ts + c * 8 : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += kThreads) {
      const int r = i / DP, d = i - r * DP, row = row0 + r;
      s[r * LD + d] = (row < T && d < D) ? g[row * ts + d]
                                         : __float2bfloat16(0.f);
    }
  }
}

// rows [row0, row0 + n) of a float [T] vector; zeros past T
__device__ __forceinline__ void load_vec(float* s, const float* g, int row0,
                                         int T, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = row0 + i < T;
    cp_async4(s + i, ok ? g + row0 + i : g, ok);
  }
}

// A thread's accumulator pair (cols d, d+1 of one row) to a [T, D] output
__device__ __forceinline__ void store_pair(bf16* p, float x, float y, int d,
                                           int D, bool vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    if (d < D) p[0] = __float2bfloat16(x);
    if (d + 1 < D) p[1] = __float2bfloat16(y);
  }
}

// The dropout bits of one m16n8 tile. The mask is one Philox call per 4
// rows of a column (attn_dropout.cuh), which does not line up with the
// accumulator layout (a thread holds rows r, r+8 and two adjacent
// columns). A tile is 32 (row group, column) pairs: the lane makes the
// call of its pair (`group`, `col`) and stores the 4 words in the warp's
// stage; each thread then reads the words of its elements back with
// staged_word. One call per 4 elements, as the mask's definition has it.
// The caller syncs the warp again before the stage is refilled.
__device__ __forceinline__ void stage_bits(uint4* wbits, int lane,
                                           unsigned long long seed,
                                           unsigned offset, int bh,
                                           int group, int col) {
  wbits[lane] = attn_dropout::bits4(seed, offset, bh, group, col);
  __syncwarp();
}

// word `w` of the stage's entry `i`
__device__ __forceinline__ unsigned staged_word(const uint4* wbits, int i,
                                                int w) {
  return reinterpret_cast<const unsigned*>(wbits + i)[w];
}

}  // namespace tc
