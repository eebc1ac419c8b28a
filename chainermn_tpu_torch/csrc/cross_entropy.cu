// Fused softmax cross-entropy forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _ce_kernel (launched by _ce_pallas,
// chainermn_tpu/ops/cross_entropy.py:48): per row of a (B, V) logits
// matrix the log-sum-exp and the label's logit in ONE pass over the row,
// so no (B, V) probability matrix is ever written.  Returns loss = lse -
// logits[label] and lse, both f32; the backward recomputes p = exp(logits
// - lse) from the saved lse.
//
// The TPU kernel holds a block of 8 whole rows in VMEM and reduces them
// there (a max pass, then a sum pass over the resident block).  A row of
// 32000 f32 logits is 128 KB, too much to keep per block here, and there
// is no need to: one block per row streams the row once from device
// memory with 16-byte loads, each thread carrying a running maximum m and
// a running sum s of exp(x - m) (the online-softmax pair), rescaled when
// the maximum moves.  The pairs are merged across the warp by shuffles
// and across the warps through shared memory, in a fixed order, so two
// runs give the same bits.  The label's logit is read by its index; a
// label outside [0, V) picks nothing (loss = lse), as the TPU kernel's
// one-hot sum gives.  Any row count is taken: the TPU wrapper's padding
// to a multiple of 8 rows is a tiling matter of that machine.
//
// What bounds it on the H100: device-memory bytes.  The logits are read
// once (8192 x 32000 f32 = 1.05 GB, 0.31 ms at 3.35 TB/s) against 1.25
// exponentials per element, which the SMs' special-function units do
// several times faster than the memory delivers the elements.  8192 rows
// give 8192 blocks of 256 threads, 62 per SM: enough loads in flight to
// keep the memory busy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the running maximum starts at a finite floor: exp(kFloor - x) is 0,
// never NaN, also when a logit is -inf
constexpr float kFloor = -3.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// merge the pair (m2, s2) into (m, s)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float m_new = fmaxf(m, m2);
  s = s * expf(m - m_new) + s2 * expf(m2 - m_new);
  m = m_new;
}

template <typename T, int N>
__device__ __forceinline__ void absorb(float& m, float& s, const T* x) {
  float f[N];
  float mx = kFloor;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[i] = to_f32(x[i]);
    mx = fmaxf(mx, f[i]);
  }
  const float m_new = fmaxf(m, mx);
  float add = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) add += expf(f[i] - m_new);
  s = s * expf(m - m_new) + add;
  m = m_new;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
              float* __restrict__ loss, float* __restrict__ lse, int v,
              int vectors) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red_m[kThreads / 32];
  __shared__ float red_s[kThreads / 32];

  const int64_t row = blockIdx.x;
  const T* x = logits + row * (int64_t)v;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float m = kFloor, s = 0.f;

  int done = 0;  // elements covered by the 16-byte loads
  if (vectors) {
    const int n_vec = v / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int i = tid; i < n_vec; i += kThreads) {
      const uint4 w = __ldg(xv + i);
      absorb<T, kVec>(m, s, reinterpret_cast<const T*>(&w));
    }
    done = n_vec * kVec;
  }
  for (int i = done + tid; i < v; i += kThreads) absorb<T, 1>(m, s, x + i);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (tid == 0) {
    m = red_m[0];
    s = red_s[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) merge(m, s, red_m[w], red_s[w]);
    const float out = m + logf(s);
    const int label = labels[row];
    const float picked = (label >= 0 && label < v) ? to_f32(x[label]) : 0.f;
    lse[row] = out;
    loss[row] = out - picked;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const int* labels, float* loss,
                   float* lse, int64_t b, int v, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte loads need every row to start on a 16-byte boundary
  const int vectors =
      (v % kVec == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0) ? 1 : 0;
  ce_kernel<T><<<(unsigned)b, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), labels, loss, lse, v, vectors);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logits: (B, V) contiguous, dtype 0 = float32 or 1 = bfloat16; labels:
// (B,) int32 (a label outside [0, V) picks nothing); loss, lse: (B,) f32.
int cmn_cross_entropy(const void* logits, int dtype, const int* labels,
                      float* loss, float* lse, int64_t b, int v,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b <= 0 || b > 2147483647LL || v <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(logits, labels, loss, lse, b, v, stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(logits, labels, loss, lse, b, v, stream);
  return (int)cudaErrorInvalidValue;
}

const char* cmn_ce_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
