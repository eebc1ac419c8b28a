// Fused heavy-ball momentum SGD for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel chainermn_tpu/ops/optimizer.py:_sgd_kernel
// (launched by _leaf_update_pallas) together with the optax.apply_updates
// that follows it:
//
//   v' = mu * v + g          (v float32, never narrowed)
//   delta = -lr * v'         (cast to g's dtype, then to p's dtype)
//   p <- p + delta ; v <- v' (in place)
//
// What bounds it on the H100: device-memory bytes (read g, v, p; write v,
// p: 20 bytes per f32 element for ~4 flops).  One grid-stride elementwise
// pass per parameter tensor, so each byte moves once; lr and mu are
// runtime arguments, so a changing schedule never rebuilds the kernel.
// Every product and sum uses the __f*_rn intrinsics (never contracted
// into an FMA), so the update rounds where the plain PyTorch version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TG, typename TP>
__global__ void momentum_sgd_kernel(const TG* __restrict__ g,
                                    float* __restrict__ v,
                                    TP* __restrict__ p, int64_t n, float lr,
                                    float mu) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float neg_lr = -lr;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float vn = __fadd_rn(__fmul_rn(mu, v[i]), to_f32(g[i]));
    v[i] = vn;
    // delta rounds to g's dtype, then to p's dtype; the add runs in f32
    // and rounds once to p's dtype
    const float delta = to_f32(from_f32<TP>(to_f32(from_f32<TG>(
        __fmul_rn(neg_lr, vn)))));
    p[i] = from_f32<TP>(__fadd_rn(to_f32(p[i]), delta));
  }
}

template <typename TG, typename TP>
cudaError_t launch(const void* g, float* v, void* p, int64_t n, float lr,
                   float mu, int blocks, cudaStream_t stream) {
  momentum_sgd_kernel<TG, TP><<<blocks, 256, 0, stream>>>(
      static_cast<const TG*>(g), v, static_cast<TP*>(p), n, lr, mu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16.
int cmn_momentum_sgd(const void* g, int g_dtype, float* v, void* p,
                     int p_dtype, int64_t n, float lr, float mu, int blocks,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (g_dtype == 0 && p_dtype == 0)
    return (int)launch<float, float>(g, v, p, n, lr, mu, blocks, stream);
  if (g_dtype == 1 && p_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(g, v, p, n, lr, mu, blocks,
                                             stream);
  if (g_dtype == 0 && p_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(g, v, p, n, lr, mu, blocks,
                                             stream);
  if (g_dtype == 1 && p_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(g, v, p, n, lr, mu,
                                                     blocks, stream);
  return (int)cudaErrorInvalidValue;
}

const char* cmn_sgd_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
