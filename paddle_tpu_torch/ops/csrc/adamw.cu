// Fused Adam / AdamW update for Hopper (sm_90a), in place on the
// parameter and both moments.
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
// kernel writes nothing, so the parameter and both moments keep their
// values (the reference selects the old ones with jnp.where inside its
// executable). `scale` is
// ClipGradByGlobalNorm's clip_norm / max(global norm, clip_norm): the host
// stages 1, and a clipped step writes it on the device before the update;
// a launch with use_scale takes g = float(grad) * scale, one float32
// rounding, the reference's float32 product of the gradient and its 0-d
// float32 scale (which a bfloat16 gradient is never rounded back from),
// at no extra pass over the gradients. A launch without use_scale reads
// four words only. The kernel forms 1 - lr * coeff itself (__fmul_rn,
// __fsub_rn), the host's float32 value bit for bit. Every operation is
// rounded on its own (__fmul_rn, __fdiv_rn, __fsqrt_rn, ...: no FMA
// contraction), so the kernel equals the plain PyTorch version op for op.
//
// The parameter is float32, bfloat16 or float16, the gradient any of the
// three (converted to float32 here), the moments float32: one template
// instance a (parameter, gradient) pair of types. A float16 parameter
// takes the update rounded once from float32, as the reference's
// `.astype(param.dtype)` rounds it. Any numel: the TPU's
// rows-of-128 rule (`_adamw_rows_ok`) is not carried over. One launch per
// parameter, as the JAX step makes one pallas_call per parameter.
//
// What bounds it on the H100: bytes. Each element reads param, grad, m1,
// m2 and writes param, m1, m2 once: 22 bytes for a bfloat16 parameter and
// gradient, 28 for float32, at ~10 flops, far below the card's ~300 flops
// per byte. What the design does about it: one pass, nothing staged, a
// grid-stride loop of coalesced loads with enough blocks to cover the SMs
// several times over; vector (16-byte) loads and one launch for all
// parameters are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

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

// the per-step values live in device memory (`sc`: lr, c1, c2, go, scale)
struct Hyper {
  float coeff, b1, omb1, b2, omb2, eps;
  int use_decay, use_scale;
};

template <typename P, typename G>
__global__ void __launch_bounds__(256)
adamw_kernel(P* __restrict__ param, const G* __restrict__ grad,
             float* __restrict__ m1, float* __restrict__ m2, long long n,
             const float* __restrict__ sc, Hyper hp) {
  if (__ldg(sc + 3) == 0.f) return;        // the guard skipped this step
  const float lr = __ldg(sc), c1 = __ldg(sc + 1), c2 = __ldg(sc + 2);
  const float decay = __fsub_rn(1.f, __fmul_rn(lr, hp.coeff));
  const float scale = hp.use_scale ? __ldg(sc + 4) : 1.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float g = to_f(grad[i]);
    if (hp.use_scale) g = __fmul_rn(g, scale);
    float p = to_f(param[i]);
    if (hp.use_decay) p = __fmul_rn(p, decay);
    const float a = __fadd_rn(__fmul_rn(hp.b1, m1[i]), __fmul_rn(hp.omb1, g));
    const float b = __fadd_rn(__fmul_rn(hp.b2, m2[i]),
                              __fmul_rn(hp.omb2, __fmul_rn(g, g)));
    const float step = __fdiv_rn(
        __fmul_rn(lr, __fdiv_rn(a, c1)),
        __fadd_rn(__fsqrt_rn(__fdiv_rn(b, c2)), hp.eps));
    store(param + i, __fsub_rn(p, step));
    m1[i] = a;
    m2[i] = b;
  }
}

template <typename P, typename G>
int launch(void* param, const void* grad, float* m1, float* m2, long long n,
           const float* sc, const Hyper& hp, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;    // 16 blocks per SM, then loop
  adamw_kernel<P, G><<<(int)blocks, threads, 0, stream>>>(
      static_cast<P*>(param), static_cast<const G*>(grad), m1, m2, n, sc, hp);
  return (int)cudaGetLastError();
}

template <typename P>
int pick_g(int gtype, void* param, const void* grad, float* m1, float* m2,
           long long n, const float* sc, const Hyper& hp,
           cudaStream_t stream) {
  if (gtype == 0)
    return launch<P, float>(param, grad, m1, m2, n, sc, hp, stream);
  if (gtype == 1)
    return launch<P, __nv_bfloat16>(param, grad, m1, m2, n, sc, hp, stream);
  if (gtype == 2)
    return launch<P, __half>(param, grad, m1, m2, n, sc, hp, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ptype / gtype: 0 float32, 1 bfloat16, 2 float16. sc: float32 [4] or [5] in
// device memory, the step's lr, c1, c2, go (0: write nothing) and the clip
// scale (read only with use_scale). coeff (AdamW's decoupled decay), the
// betas, 1 - beta and eps are float32 values computed by the caller.
// use_decay: 0 for Adam (no decay multiply). Returns cudaGetLastError() after
// the launch.
extern "C" int adamw(void* param, const void* grad, float* m1, float* m2,
                     long long n, int ptype, int gtype, const float* sc,
                     float coeff, int use_decay, int use_scale, float b1,
                     float omb1, float b2, float omb2, float eps,
                     cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const Hyper hp{coeff, b1, omb1, b2, omb2, eps, use_decay, use_scale};
  if (ptype == 0) return pick_g<float>(gtype, param, grad, m1, m2, n, sc, hp,
                                       stream);
  if (ptype == 1)
    return pick_g<__nv_bfloat16>(gtype, param, grad, m1, m2, n, sc, hp,
                                 stream);
  if (ptype == 2)
    return pick_g<__half>(gtype, param, grad, m1, m2, n, sc, hp, stream);
  return (int)cudaErrorInvalidValue;
}
