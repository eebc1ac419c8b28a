// Fused BatchNorm (+ residual add) (+ relu) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of chainermn_tpu/ops/batch_norm_act.py:
//   _stats_kernel (launched by _stats_pallas)  -> cmn_bn_stats
//   _apply_kernel / _apply_res_kernel (launched by _apply_pallas)
//                                              -> cmn_bn_apply
//
// Layout: the (..., C) activation is a row-major (M, C) matrix; statistics
// reduce over rows.  Every block is (32 channels) x (8 row lanes): a warp
// reads 32 neighbouring channels of one row, so loads coalesce along the
// contiguous C axis.
//
// What bounds it on the H100: device-memory bytes.  Stats reads x once
// (2 or 4 bytes per element, ~3 flops each); apply reads x (+ residual)
// and writes out once.  Both are far below the card's ~20 flop/byte
// f32 balance point, so the design goal is one pass over the activation
// with coalesced loads and enough blocks in flight to fill 132 SMs.
//
// The TPU stats kernel carries its sums across a sequential grid.  Blocks
// on Hopper run in no order, so stats is two passes: pass 1 writes one
// (n_chunks, C) partial per row chunk, pass 2 sums the partials per
// channel in a fixed order.  No float atomics, so the result is the same
// from run to run.  The ragged last chunk is masked (no row padding).
//
// Rounding: every product and sum uses the __f*_rn intrinsics, which nvcc
// never contracts into an FMA, so the kernel rounds where the plain
// PyTorch version (and XLA's _apply_ref order) rounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTileC = 32;
constexpr int kLanes = 8;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Pass 1: per (row chunk, channel) partial sum and sum of squares.
template <typename T>
__global__ void stats_partial_kernel(const T* __restrict__ x,
                                     float* __restrict__ psum,
                                     float* __restrict__ psq, int64_t m,
                                     int64_t c, int64_t rows_per_chunk) {
  __shared__ float ssum[kLanes][kTileC];
  __shared__ float ssq[kLanes][kTileC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t ch = (int64_t)blockIdx.x * kTileC + tx;
  const int64_t chunk = blockIdx.y;
  const int64_t r0 = chunk * rows_per_chunk;
  int64_t r1 = r0 + rows_per_chunk;
  if (r1 > m) r1 = m;
  float s = 0.f, q = 0.f;
  if (ch < c) {
    for (int64_t r = r0 + ty; r < r1; r += kLanes) {
      const float v = load_f32(x + r * c + ch);
      s = __fadd_rn(s, v);
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
  }
  ssum[ty][tx] = s;
  ssq[ty][tx] = q;
  __syncthreads();
  if (ty == 0 && ch < c) {
    // fixed lane order: deterministic
    for (int l = 1; l < kLanes; ++l) {
      s = __fadd_rn(s, ssum[l][tx]);
      q = __fadd_rn(q, ssq[l][tx]);
    }
    psum[chunk * c + ch] = s;
    psq[chunk * c + ch] = q;
  }
}

// Pass 2: sum the partials per channel in chunk order, then form the
// flax-parity statistics over the REAL row count: mean, fast variance
// clipped at zero, rstd = 1 / sqrt(var + eps).
__global__ void stats_finalize_kernel(const float* __restrict__ psum,
                                      const float* __restrict__ psq,
                                      int64_t n_chunks, int64_t c, int64_t m,
                                      float eps, float* __restrict__ mean,
                                      float* __restrict__ var,
                                      float* __restrict__ rstd) {
  const int64_t ch = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float s = 0.f, q = 0.f;
  for (int64_t k = 0; k < n_chunks; ++k) {
    s = __fadd_rn(s, psum[k * c + ch]);
    q = __fadd_rn(q, psq[k * c + ch]);
  }
  const float fm = (float)m;
  const float mu = __fdiv_rn(s, fm);
  float v = __fsub_rn(__fdiv_rn(q, fm), __fmul_rn(mu, mu));
  v = v > 0.f ? v : 0.f;
  mean[ch] = mu;
  var[ch] = v;
  rstd[ch] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(v, eps)));
}

// y = (x - mean) * (rstd * scale) + bias (+ residual) (relu), f32 math,
// output in x's dtype.
template <typename T, bool kRes, bool kRelu>
__global__ void apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             T* __restrict__ out, int64_t m, int64_t c,
                             int64_t rows_per_chunk) {
  const int64_t ch = (int64_t)blockIdx.x * kTileC + threadIdx.x;
  if (ch >= c) return;
  const float mu = mean[ch];
  const float s = __fmul_rn(rstd[ch], scale[ch]);
  const float b = bias[ch];
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  int64_t r1 = r0 + rows_per_chunk;
  if (r1 > m) r1 = m;
  for (int64_t r = r0 + threadIdx.y; r < r1; r += kLanes) {
    const int64_t i = r * c + ch;
    float y = __fadd_rn(__fmul_rn(__fsub_rn(load_f32(x + i), mu), s), b);
    if (kRes) y = __fadd_rn(y, load_f32(res + i));
    if (kRelu) y = y < 0.f ? 0.f : y;
    store_from_f32(out + i, y);
  }
}

template <typename T>
cudaError_t launch_apply(const void* x, const void* res, const float* mean,
                         const float* rstd, const float* scale,
                         const float* bias, void* out, int64_t m, int64_t c,
                         int64_t rows_per_chunk, int relu,
                         cudaStream_t stream) {
  const dim3 block(kTileC, kLanes);
  const dim3 grid((unsigned)((c + kTileC - 1) / kTileC),
                  (unsigned)((m + rows_per_chunk - 1) / rows_per_chunk));
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  T* op = static_cast<T*>(out);
  if (res != nullptr && relu)
    apply_kernel<T, true, true><<<grid, block, 0, stream>>>(
        xp, rp, mean, rstd, scale, bias, op, m, c, rows_per_chunk);
  else if (res != nullptr)
    apply_kernel<T, true, false><<<grid, block, 0, stream>>>(
        xp, rp, mean, rstd, scale, bias, op, m, c, rows_per_chunk);
  else if (relu)
    apply_kernel<T, false, true><<<grid, block, 0, stream>>>(
        xp, rp, mean, rstd, scale, bias, op, m, c, rows_per_chunk);
  else
    apply_kernel<T, false, false><<<grid, block, 0, stream>>>(
        xp, rp, mean, rstd, scale, bias, op, m, c, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16.

// Both passes of the statistics.  psum / psq are (n_chunks, C) f32
// scratch from the caller; mean / var / rstd are (C,) f32 outputs.
int cmn_bn_stats(const void* x, int dtype, int64_t m, int64_t c,
                 int64_t rows_per_chunk, float* psum, float* psq, float eps,
                 float* mean, float* var, float* rstd, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n_chunks = (m + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 block(kTileC, kLanes);
  const dim3 grid((unsigned)((c + kTileC - 1) / kTileC), (unsigned)n_chunks);
  if (dtype == 0)
    stats_partial_kernel<float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(x), psum, psq, m, c, rows_per_chunk);
  else if (dtype == 1)
    stats_partial_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), psum, psq, m, c,
        rows_per_chunk);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  stats_finalize_kernel<<<(unsigned)((c + threads - 1) / threads), threads, 0,
                          stream>>>(psum, psq, n_chunks, c, m, eps, mean, var,
                                    rstd);
  return (int)cudaGetLastError();
}

// res may be null (no residual).  x, res and out share dtype and (M, C).
int cmn_bn_apply(const void* x, const void* res, int dtype, const float* mean,
                 const float* rstd, const float* scale, const float* bias,
                 void* out, int64_t m, int64_t c, int64_t rows_per_chunk,
                 int relu, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 0)
    return (int)launch_apply<float>(x, res, mean, rstd, scale, bias, out, m, c,
                                    rows_per_chunk, relu, stream);
  if (dtype == 1)
    return (int)launch_apply<__nv_bfloat16>(x, res, mean, rstd, scale, bias,
                                            out, m, c, rows_per_chunk, relu,
                                            stream);
  return (int)cudaErrorInvalidValue;
}

const char* cmn_bn_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
