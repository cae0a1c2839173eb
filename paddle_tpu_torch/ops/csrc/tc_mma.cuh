// Tensor-core building blocks shared by the 16-bit flash kernels
// (flash_fwd.cu's forward, flash_bwd.cu's dq and dk/dv): cp.async copies,
// ldmatrix, mma.sync.m16n8k16 with bfloat16 or float16 operands and f32
// sums, the repacking of an f32 accumulator as the A fragment of the next
// product, tile loads and pair stores with their element-wise edge route,
// and the per-warp stage of the attention-dropout Philox words. Every
// piece that depends on the element type takes it as a template
// parameter T (bf16 or f16, `Elt<T>`); ldmatrix moves 16-bit words of
// either.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 or .f16, the same for
// both): a lane l holds
// g = l / 4 and t = l % 4; accumulator element e of an m16n8 tile is row
// g + 8 (e / 2), column 2 t + e % 2. Every kernel that includes this runs
// 128 threads (4 warps) a CTA, and its shared rows are DP + 8 elements
// long (DP the head dim rounded up to 32): the 16-byte pad puts the 8 row
// addresses of every ldmatrix phase in 8 distinct 4-bank groups.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "attn_dropout.cuh"

namespace tc {

typedef __nv_bfloat16 bf16;
typedef __half f16;

// The element type's pair type and its conversions from and to float,
// each rounded to nearest even
template <typename T>
struct Elt;
template <>
struct Elt<bf16> {
  typedef __nv_bfloat162 T2;
  static __device__ __forceinline__ T2 pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 widen(T2 v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ bf16 from(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ float to(bf16 x) {
    return __bfloat162float(x);
  }
};
template <>
struct Elt<f16> {
  typedef __half2 T2;
  static __device__ __forceinline__ T2 pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 widen(T2 v) {
    return __half22float2(v);
  }
  static __device__ __forceinline__ f16 from(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ float to(f16 x) { return __half2float(x); }
};

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
__device__ __forceinline__ void ldsm(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b: a 16x16 (row), b 16x8 (col), T in, f32 accumulate
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  if constexpr (std::is_same<T, f16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two f32 as one T pair register, lo in the low half
template <typename T>
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  typename Elt<T>::T2 v = Elt<T>::pair(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// x, y as a T pair hi and the pair lo of what hi leaves out (x - hi is
// exact in f32): hi + lo holds x to 2^-17 relative in bf16 (hi alone to
// 2^-9), to 2^-22 in f16 (hi alone 2^-11) while x - hi stays in f16's
// normal range
template <typename T>
__device__ __forceinline__ void split(unsigned& hi, unsigned& lo, float x,
                                      float y) {
  const typename Elt<T>::T2 h = Elt<T>::pair(x, y);
  const float2 f = Elt<T>::widen(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack<T>(x - f.x, y - f.y);
}

// The A fragment (16 x k16) made of the accumulators of n8 tiles j, j+1,
// as hi and lo fragments: a0/a1 are rows g / g+8 of tile j, a2/a3 the
// same of tile j+1.
template <typename T>
__device__ __forceinline__ void a_from_acc(unsigned (&hi)[4],
                                           unsigned (&lo)[4],
                                           const float (&c0)[4],
                                           const float (&c1)[4]) {
  split<T>(hi[0], lo[0], c0[0], c0[1]);
  split<T>(hi[1], lo[1], c0[2], c0[3]);
  split<T>(hi[2], lo[2], c1[0], c1[1]);
  split<T>(hi[3], lo[3], c1[2], c1[3]);
}

// The same A fragment rounded once (hi alone)
template <typename T>
__device__ __forceinline__ void a_from_acc(unsigned (&a)[4],
                                           const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack<T>(c0[0], c0[1]);
  a[1] = pack<T>(c0[2], c0[3]);
  a[2] = pack<T>(c1[0], c1[1]);
  a[3] = pack<T>(c1[2], c1[3]);
}

// float16's range (normal numbers 2^-14 .. 65504) is far narrower than
// float32's, which bfloat16 shares. An A operand with no bound of its own
// (the backward's dS, which a loss scale of 2^15 multiplies) enters the
// f16 products scaled per accumulator row by a power of two, 2^(kTop -
// e) with |values| < 2^e, so that its largest element is below 2^kTop
// and rounds finite. Each row keeps the largest e seen so far (the
// online softmax's running max, in exponents): a tile with a larger one
// shrinks the row's accumulator by the power of two in between, and the
// output takes 2^(e - kTop) at the end. Powers of two are exact in f32,
// so the f32 sums are those of the unscaled operand. A NaN passes through
// (fmaxf skips it in the max, and the product carries it); an inf row
// max gives e = 129 and the inf reaches the output.
constexpr int kTop = 15;
constexpr int kMinExp = -100;          // all-zero rows: 2^(kTop - e) finite

// 2^n as a float, n in [-126, 127]; 0 below
__device__ __forceinline__ float exp2i(int n) {
  return n < -126 ? 0.f : __uint_as_float((unsigned)(n + 127) << 23);
}

// e with x < 2^e for x >= 0 (x's exponent field less 126), at least kMinExp
__device__ __forceinline__ int exp_above(float x) {
  return max((int)((__float_as_uint(x) >> 23) & 0xff) - 126, kMinExp);
}

// One tile's A values of rows g and g + 8 (a[j][e], row g + 8 (e / 2)):
// their running exponents ex[2] take the tile's row maxima (over the
// lane's quad), the accumulator rows acc[DT] shrink to match, and the
// values are scaled to below 2^kTop.
template <int NT, int DT>
__device__ __forceinline__ void range_scale(float (&a)[NT][4], int (&ex)[2],
                                            float (&acc)[DT][4]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], fabsf(a[j][e]));
  float sc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const int et = exp_above(mx[i]);
    if (et > ex[i]) {
      const float down = exp2i(ex[i] - et);
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        acc[dn][2 * i] *= down;
        acc[dn][2 * i + 1] *= down;
      }
      ex[i] = et;
    }
    sc[i] = exp2i(kTop - ex[i]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] *= sc[e >> 1];
}

// Rows [row0, row0 + R) of a [T, D] head slice (time stride ts) into
// shared rows of LD elements, columns [0, DP); rows >= T and columns >= D
// become zeros. vec: 16-byte cp.async (D % 8 == 0, rows 16-byte aligned);
// otherwise element loads, which land before the next __syncthreads.
template <int R, int DP, typename E>
__device__ __forceinline__ void load_tile(E* s, const E* g,
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
                                         : Elt<E>::from(0.f);
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
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y, int d,
                                           int D, bool vec) {
  if (vec) {
    *reinterpret_cast<typename Elt<T>::T2*>(p) = Elt<T>::pair(x, y);
  } else {
    if (d < D) p[0] = Elt<T>::from(x);
    if (d + 1 < D) p[1] = Elt<T>::from(y);
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
