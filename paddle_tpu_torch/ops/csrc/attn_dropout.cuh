// Attention-dropout bits shared by the flash forward and both backward
// kernels (and the attn_dropout_bits kernel that writes them out for the
// checks).
//
// Replaces the TPU kernels' per-tile hardware PRNG (pallas_kernels.py
// `_attn_drop_keep` / `_attn_drop_scale`): there the tile indices re-seed
// the PRNG, so the mask depends on the tiling. Here the bits are a pure
// function of the element: Philox-4x32-10 (Random123; the same function
// as curand's curand_Philox4x32_10, written out so the plain PyTorch
// version in cuda_kernels.py can repeat it bit for bit) keyed by the
// call's 64-bit seed, with the counter
//     (col, row / 4, batch*head, call offset)
// and word row % 4 of the result. Four rows of one column share one
// Philox call: a warp that owns 4 aligned rows (forward, dq) gets all its
// bits from one call per lane. keep <=> bits >= thr, thr = min(floor(p *
// 2^32), 2^32 - 1); kept values are scaled by 1 / (1 - p).
//
// A kernel takes its (seed, offset) from device memory, as the reference's
// kernels read `rng_ref`: a Philox word (two 64-bit values, seed and base
// offset, that the host writes before a train step) and a per-call delta,
// offset = base + delta (mod 2^32). A CUDA graph replay then draws new bits
// each step from the same captured launch. `load_key` reads the word once,
// at the kernel's start, into registers.
#pragma once
#include <cuda_runtime.h>

namespace attn_dropout {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// bits of rows 4*group .. 4*group+3 of column `col` (word i is row 4g+i)
__device__ __forceinline__ uint4 bits4(unsigned long long seed,
                                       unsigned offset, int bh, int group,
                                       int col) {
  return philox4x32_10(
      make_uint4((unsigned)col, (unsigned)group, (unsigned)bh, offset),
      make_uint2((unsigned)seed, (unsigned)(seed >> 32)));
}

// (seed, offset) of the call: word[0] is the seed, word[1] the base offset
__device__ __forceinline__ void load_key(const unsigned long long* word,
                                         unsigned delta,
                                         unsigned long long& seed,
                                         unsigned& offset) {
  seed = __ldg(word);
  offset = (unsigned)__ldg(word + 1) + delta;
}

__device__ __forceinline__ unsigned word(uint4 r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

}  // namespace attn_dropout
