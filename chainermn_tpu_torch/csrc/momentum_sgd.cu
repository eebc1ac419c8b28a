// Fused heavy-ball momentum SGD for Hopper (sm_90a), many tensors a launch.
//
// Replaces the Pallas TPU kernel chainermn_tpu/ops/optimizer.py:_sgd_kernel
// (launched by _leaf_update_pallas, once per leaf) together with the
// optax.apply_updates that follows it:
//
//   v' = mu * v + g          (v float32, never narrowed)
//   delta = -lr * v'         (cast to g's dtype, then to p's dtype)
//   p <- p + delta ; v <- v' (in place)
//
// What bounds it on the H100: device-memory bytes (read g, v, p; write v,
// p: 20 bytes per f32 element for ~4 flops).  One elementwise pass over
// every tensor of a step, so each byte moves once.  A ResNet-50 step
// updates 161 tensors, many of them small (biases, BN scales): one launch
// each left the card waiting on the host between launches, so one launch
// walks them all.  The tensors' table -- g, v and p pointers and the
// element count of each, and the prefix of their chunk counts -- is the
// kernel's parameter struct, passed by value (sm_90 with CUDA 12.1 or
// later takes up to 32,764 bytes of parameters): nothing is copied to the
// device before the launch.  Block i updates chunk i of the concatenation:
// a binary search of the prefix finds its tensor.  A table of more than
// kMaxTensors tensors takes one launch per kMaxTensors.  lr and mu are
// runtime arguments, so a changing schedule never rebuilds the kernel.
// Every product and sum uses the __f*_rn intrinsics (never contracted
// into an FMA), so the update rounds where the plain PyTorch version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16 * kThreads;  // elements a block
constexpr int kMaxTensors = 200;       // tensors a launch

struct SgdTensor {
  const void* g;
  float* v;
  void* p;
  int64_t n;
};

struct SgdTable {
  SgdTensor t[kMaxTensors];
  int chunk_end[kMaxTensors];  // chunks of tensors 0..i together
  int n;
  float lr, mu;
};
static_assert(sizeof(SgdTable) <= 32764, "kernel parameters over 32,764 B");

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
__global__ void __launch_bounds__(kThreads)
    momentum_sgd_kernel(const __grid_constant__ SgdTable tab) {
  const int blk = blockIdx.x;
  // the first tensor whose chunks reach past this block
  int lo = 0, hi = tab.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab.chunk_end[mid] > blk)
      hi = mid;
    else
      lo = mid + 1;
  }
  const TG* __restrict__ g = static_cast<const TG*>(tab.t[lo].g);
  float* __restrict__ v = tab.t[lo].v;
  TP* __restrict__ p = static_cast<TP*>(tab.t[lo].p);
  const int64_t start =
      (int64_t)(blk - (lo ? tab.chunk_end[lo - 1] : 0)) * kChunk;
  const int64_t n = tab.t[lo].n;
  const int64_t end = start + kChunk < n ? start + kChunk : n;
  const float neg_lr = -tab.lr, mu = tab.mu;
#pragma unroll 4
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    const float vn = __fadd_rn(__fmul_rn(mu, v[i]), to_f32(g[i]));
    v[i] = vn;
    // delta rounds to g's dtype, then to p's dtype; the add runs in f32
    // and rounds once to p's dtype
    const float delta = to_f32(from_f32<TP>(to_f32(from_f32<TG>(
        __fmul_rn(neg_lr, vn)))));
    p[i] = from_f32<TP>(__fadd_rn(to_f32(p[i]), delta));
  }
}

// rows: n rows of 4 int64 (g, v, p pointers; element count)
template <typename TG, typename TP>
cudaError_t launch(const int64_t* rows, int n, float lr, float mu,
                   int* launches, cudaStream_t stream) {
  for (int first = 0; first < n; first += kMaxTensors) {
    SgdTable tab;
    tab.n = 0;
    tab.lr = lr;
    tab.mu = mu;
    int chunks = 0;
    for (int i = first; i < n && i < first + kMaxTensors; ++i) {
      const int64_t* r = rows + 4 * (int64_t)i;
      if (r[3] <= 0) continue;
      SgdTensor& t = tab.t[tab.n];
      t.g = reinterpret_cast<const void*>(r[0]);
      t.v = reinterpret_cast<float*>(r[1]);
      t.p = reinterpret_cast<void*>(r[2]);
      t.n = r[3];
      const int64_t c = (r[3] + kChunk - 1) / kChunk;
      if (c > INT32_MAX - chunks) return cudaErrorInvalidValue;
      chunks += (int)c;
      tab.chunk_end[tab.n++] = chunks;
    }
    if (chunks == 0) continue;
    momentum_sgd_kernel<TG, TP><<<chunks, kThreads, 0, stream>>>(tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16.
// table: n rows of 4 int64 -- the gradient's, velocity's (f32) and
// parameter's device pointers and their element count -- of tensors that
// share the gradient dtype g_dtype and the parameter dtype p_dtype, each
// dense (its elements laid out alike in g, v and p).  *launches grows by
// the launches made.
int cmn_momentum_sgd(const int64_t* table, int n, int g_dtype, int p_dtype,
                     float lr, float mu, int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (g_dtype == 0 && p_dtype == 0)
    return (int)launch<float, float>(table, n, lr, mu, launches, stream);
  if (g_dtype == 1 && p_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(table, n, lr, mu, launches,
                                             stream);
  if (g_dtype == 0 && p_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(table, n, lr, mu, launches,
                                             stream);
  if (g_dtype == 1 && p_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(table, n, lr, mu,
                                                     launches, stream);
  return (int)cudaErrorInvalidValue;
}

const char* cmn_sgd_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
