// LayerNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of chainermn_tpu/ops/layer_norm.py:
//   _ln_kernel (launched by _ln_pallas, layer_norm.py:40) -> cmn_layer_norm
//
// Computes, per row of an (N, D) matrix: f32 mean, f32 variance of the
// centred values (two passes over the row, as the TPU kernel and the plain
// version do), y = (x - mean) * rsqrt(var + eps) * gamma + beta, written in
// x's dtype.  gamma / beta are f32 or bf16 (the bf16 serving policy casts
// them) and are widened to f32 before the affine.
//
// What bounds it on the H100: device-memory bytes.  It reads x once and
// writes the output once (~8 flops per element, far below the card's
// balance point), so the design goal is one pass over x with coalesced
// loads and no round trip through shared or device memory.
//
// Design: one warp per row and four rows per 128-thread block.  The row
// stays in registers between the passes: lane l holds elements
// l, l + 32, l + 64, ... (kPer of them, D <= 32 * kPer), so every load
// and store instruction of the warp touches consecutive addresses.  The
// sums are warp shuffles, no shared memory, no atomics.  Rows are ragged:
// there is no padding of N to the TPU's 8-row tile; the last block simply
// has idle warps.  D up to 1024 (kPer <= 32 floats per lane).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename G, int kPer>
__global__ void __launch_bounds__(kWarps * 32)
    ln_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
              const G* __restrict__ beta, T* __restrict__ out, int64_t n,
              int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  float v[kPer];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d ? to_f32(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / (float)d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    const float xc = c < d ? v[i] - mu : 0.f;
    v[i] = xc;
    q += xc * xc;
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)d + eps);
  T* orow = out + row * d;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < d)
      store_f32(orow + c,
                v[i] * rstd * to_f32(gamma[c]) + to_f32(beta[c]));
  }
}

template <typename T, typename G>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* out, int64_t n, int d, float eps,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  const T* xp = static_cast<const T*>(x);
  const G* gp = static_cast<const G*>(gamma);
  const G* bp = static_cast<const G*>(beta);
  T* op = static_cast<T*>(out);
  const int per = (d + 31) / 32;
  if (per <= 1)
    ln_kernel<T, G, 1><<<grid, block, 0, stream>>>(xp, gp, bp, op, n, d, eps);
  else if (per <= 2)
    ln_kernel<T, G, 2><<<grid, block, 0, stream>>>(xp, gp, bp, op, n, d, eps);
  else if (per <= 4)
    ln_kernel<T, G, 4><<<grid, block, 0, stream>>>(xp, gp, bp, op, n, d, eps);
  else if (per <= 8)
    ln_kernel<T, G, 8><<<grid, block, 0, stream>>>(xp, gp, bp, op, n, d, eps);
  else if (per <= 16)
    ln_kernel<T, G, 16><<<grid, block, 0, stream>>>(xp, gp, bp, op, n, d,
                                                    eps);
  else if (per <= 32)
    ln_kernel<T, G, 32><<<grid, block, 0, stream>>>(xp, gp, bp, op, n, d,
                                                    eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16.
// x and out are contiguous (N, D) of x_dtype; gamma and beta are (D,) of
// g_dtype.  D <= 1024.
int cmn_layer_norm(const void* x, int x_dtype, const void* gamma,
                   const void* beta, int g_dtype, void* out, int64_t n, int d,
                   float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && g_dtype == 0)
    return (int)launch<float, float>(x, gamma, beta, out, n, d, eps, stream);
  if (x_dtype == 0 && g_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, gamma, beta, out, n, d, eps,
                                             stream);
  if (x_dtype == 1 && g_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, gamma, beta, out, n, d, eps,
                                             stream);
  if (x_dtype == 1 && g_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, out, n,
                                                     d, eps, stream);
  return (int)cudaErrorInvalidValue;
}

const char* cmn_ln_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
