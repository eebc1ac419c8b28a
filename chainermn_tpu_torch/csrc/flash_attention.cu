// Flash attention for Hopper (sm_90a): the prefill forward and the
// single-query decode read of a slot KV cache.
//
// Replaces two Pallas TPU kernels of chainermn_tpu/ops/flash_attention.py:
//   _fwd_kernel    (launched by _fwd_pallas,    flash_attention.py:144)
//                                                   -> cmn_flash_fwd
//   _decode_kernel (launched by _decode_pallas, flash_attention.py:650)
//                                                   -> cmn_flash_decode
//
// Both keep the TPU kernels' online-softmax recurrence in f32 -- running
// max m, running sum l, accumulator acc; scores masked with the finite
// NEG_INF = -1e30 of chainermn_tpu/ops/_common.py; the output divided by
// max(l, 1e-30) -- and both compute in f32 on every input dtype, as the
// TPU kernels do (they widen q, k, v to f32 before each product).
//
// ---- forward (cmn_flash_fwd) ----
// One block per (batch*head, block of kBQ query rows).  The TPU walks the
// key blocks as a sequential grid axis and carries (m, l, acc) in VMEM
// scratch between grid steps; blocks on Hopper run in no order, so here a
// loop inside the block walks the key tiles, and (m, l, acc) live in
// registers.  The loop stops at the causal frontier: tiles wholly after
// the block's last query row are neither loaded nor computed.  Keys at or
// past kv_len are masked and never loaded (the JAX wrapper pads them).
// K and V tiles (kBK = 32 keys) go through shared memory as f32; the
// query tile is loaded once, pre-scaled.  Each warp owns kRows query rows:
// lane j scores key j of the tile against all of them (the K row is read
// once from shared memory for kRows products), and for P.V each lane owns
// D/32 output columns, with p_j broadcast by a warp shuffle.
// What bounds it on the H100: operations.  At T = 2048, D = 64 it does
// ~64 flops per byte of q, k, v; the card's bf16 tensor cores would do
// ~295.  This first version runs scalar f32 FMAs (no tensor cores), so it
// sits far from that bound; mma/wgmma tiles are the next step.
//
// ---- decode (cmn_flash_decode) ----
// One block of 128 threads per (row, head): one query row against its
// slot's cache, read in place in its (slots, S, H, D) layout through
// strides (no per-step merge or pad copy of the layer's cache), with an
// optional row -> slot map so a compacted bucket reads its rows without a
// gather.  The loop covers ceil(length / 128) key tiles only, and inside
// the last tile only positions < length are read, so the kernel moves the
// live bytes and nothing else.  Thread t scores position t of the tile
// (its K row read with 16-byte vector loads), the block reduces max and
// sum, and for P.V thread t owns column t % D of a key group, the groups
// summed in a fixed order at the end.  int8 caches are dequantized with
// their per-(position, head) f32 scales before the products, as the TPU
// kernel does.
// What bounds it on the H100: device-memory bytes (one pass over the live
// cache, 2 flops per byte of bf16 K/V).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---------------------------------------------------------------------
// forward

constexpr int kFwdWarps = 8;
constexpr int kBK = 32;  // keys per tile: one per lane

template <int D>
struct FwdCfg {
  static constexpr int kRows = D <= 64 ? 8 : 4;  // query rows per warp
  static constexpr int kBQ = kFwdWarps * kRows;  // query rows per block
  static constexpr int kPer = D / 32;            // output columns per lane
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) +
                       (size_t)kBK * D);
};

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  void* out;   // (B, Tq, H, D), contiguous, q's dtype
  float* lse;  // (B, H, Tq) f32
  int h, t_q, t_kv;
  float scale;
  int causal;
};

template <typename T, int D>
__global__ void __launch_bounds__(kFwdWarps * 32) flash_fwd_kernel(FwdArgs a) {
  constexpr int R = FwdCfg<D>::kRows;
  constexpr int BQ = FwdCfg<D>::kBQ;
  constexpr int P = FwdCfg<D>::kPer;
  extern __shared__ float smem[];
  float* qs = smem;                // BQ x D, pre-scaled
  float* ks = qs + BQ * D;         // kBK x (D + 1): padded, no bank conflict
  float* vs = ks + kBK * (D + 1);  // kBK x D

  const int bh = blockIdx.y;
  const int b = bh / a.h, hh = bh % a.h;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + hh * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hh * a.v_sh;

  for (int e = tid; e < BQ * D; e += kFwdWarps * 32) {
    const int r = e / D, c = e % D, t = q0 + r;
    qs[e] = t < a.t_q ? to_f32(qp[t * a.q_st + c]) * a.scale : 0.f;
  }

  float m[R], l[R], acc[R][P];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) acc[r][i] = 0.f;
  }

  int n_tiles = (a.t_kv + kBK - 1) / kBK;
  if (a.causal) {
    const int frontier = (q0 + BQ + kBK - 1) / kBK;  // tiles with key < q0+BQ
    if (frontier < n_tiles) n_tiles = frontier;
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile is consumed (and qs written)
    for (int e = tid; e < kBK * D; e += kFwdWarps * 32) {
      const int r = e / D, c = e % D, t = k0 + r;
      const bool live = t < a.t_kv;
      ks[r * (D + 1) + c] = live ? to_f32(kp[t * a.k_st + c]) : 0.f;
      vs[r * D + c] = live ? to_f32(vp[t * a.v_st + c]) : 0.f;
    }
    __syncthreads();

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* krow = ks + lane * (D + 1);
    const float* qrow = qs + warp * R * D;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(qrow[r * D + c], kc, s[r]);
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + warp * R + r;
      const bool ok = kpos < a.t_kv && (!a.causal || qpos >= kpos);
      const float sr = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sr - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < P; ++i) acc[r][i] *= alpha;
      s[r] = p;
    }
#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float vv[P];
#pragma unroll
      for (int i = 0; i < P; ++i) vv[i] = vs[jj * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], jj);
#pragma unroll
        for (int i = 0; i < P; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

  T* op = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qpos = q0 + warp * R + r;
    if (qpos >= a.t_q) continue;  // padded query rows are dropped
    const float l_safe = fmaxf(l[r], 1e-30f);
    T* orow = op + (((int64_t)b * a.t_q + qpos) * a.h + hh) * D;
#pragma unroll
    for (int i = 0; i < P; ++i) store_f32(orow + lane + 32 * i, acc[r][i] / l_safe);
    if (lane == 0) a.lse[(int64_t)bh * a.t_q + qpos] = m[r] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const FwdArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = FwdCfg<D>::kSmem;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((a.t_q + FwdCfg<D>::kBQ - 1) / FwdCfg<D>::kBQ),
                  (unsigned)bh);
  flash_fwd_kernel<T, D><<<grid, kFwdWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_d(const FwdArgs& a, int d, int bh,
                         cudaStream_t stream) {
  if (d == 32) return launch_fwd<T, 32>(a, bh, stream);
  if (d == 64) return launch_fwd<T, 64>(a, bh, stream);
  if (d == 128) return launch_fwd<T, 128>(a, bh, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// decode

constexpr int kDecThreads = 128;
constexpr int kDecBK = kDecThreads;  // keys per tile: one per thread

struct DecArgs {
  const void* q;  // (N, H, D), D contiguous
  int64_t q_sn, q_sh;
  const void* k;  // the layer's cache, (slots, S, H, D), D contiguous
  const void* v;
  int64_t k_ss, k_sp, k_sh;  // element strides: slot, position, head
  int64_t v_ss, v_sp, v_sh;
  const float* ks;  // int8 scales (slots, S, H) f32; null for float caches
  const float* vs;
  int64_t ks_ss, ks_sp, ks_sh;
  int64_t vs_ss, vs_sp, vs_sh;
  const int* lengths;  // (N,) live positions per row, >= 1
  const int* slots;    // (N,) row -> slot; null: row i reads slot i
  void* out;           // (N, H, D), contiguous, q's dtype
  int h, s_max;
  float scale;
};

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kDecThreads / 32; ++w) r = fmaxf(r, red[w]);
  __syncthreads();  // red is reused by the next reduction
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kDecThreads / 32; ++w) r += red[w];  // fixed order
  __syncthreads();
  return r;
}

// q_s . (k_row * kscale) over D elements read as 16-byte vectors (the
// wrapper guarantees 16-byte alignment of every row).
template <typename TK, int D>
__device__ __forceinline__ float dot_row(const float* qs, const TK* kr,
                                         float kscale) {
  constexpr int kVec = 16 / sizeof(TK);
  const uint4* kv = reinterpret_cast<const uint4*>(kr);
  float dot = 0.f;
#pragma unroll
  for (int u = 0; u < D / kVec; ++u) {
    const uint4 w = __ldg(kv + u);
    const TK* e = reinterpret_cast<const TK*>(&w);
#pragma unroll
    for (int t = 0; t < kVec; ++t)
      dot = fmaf(qs[u * kVec + t], to_f32(e[t]) * kscale, dot);
  }
  return dot;
}

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(kDecThreads) flash_decode_kernel(DecArgs a) {
  constexpr int G = kDecThreads / D;  // key groups of the P.V phase
  __shared__ float qs[D];
  __shared__ float ps[kDecBK];
  __shared__ float red[kDecThreads / 32];
  __shared__ float part[kDecThreads];

  const int row = blockIdx.x / a.h, hh = blockIdx.x % a.h;
  const int tid = threadIdx.x;
  int len = a.lengths[row];
  if (len > a.s_max) len = a.s_max;
  const int64_t slot = a.slots != nullptr ? a.slots[row] : row;

  const TQ* qp = static_cast<const TQ*>(a.q) + row * a.q_sn + hh * a.q_sh;
  for (int c = tid; c < D; c += kDecThreads) qs[c] = to_f32(qp[c]) * a.scale;
  const TK* kb = static_cast<const TK*>(a.k) + slot * a.k_ss + hh * a.k_sh;
  const TK* vb = static_cast<const TK*>(a.v) + slot * a.v_ss + hh * a.v_sh;
  const float* ksb =
      a.ks != nullptr ? a.ks + slot * a.ks_ss + hh * a.ks_sh : nullptr;
  const float* vsb =
      a.vs != nullptr ? a.vs + slot * a.vs_ss + hh * a.vs_sh : nullptr;
  __syncthreads();

  const int col = tid % D, grp = tid / D;
  float m = kNegInf, l = 0.f, acc = 0.f;
  const int n_tiles = (len + kDecBK - 1) / kDecBK;
  for (int j = 0; j < n_tiles; ++j) {
    const int p0 = j * kDecBK;
    const int pos = p0 + tid;
    float s = kNegInf;
    if (pos < len)
      s = dot_row<TK, D>(qs, kb + pos * a.k_sp,
                         ksb != nullptr ? ksb[pos * a.ks_sp] : 1.f);
    const float m_new = fmaxf(m, block_max(s, red));
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + block_sum(p, red);
    m = m_new;
    // v's dequant scale rides on p (l sums the unscaled p)
    ps[tid] = (vsb != nullptr && pos < len) ? p * vsb[pos * a.vs_sp] : p;
    __syncthreads();
    acc *= alpha;
    const int live = len - p0 < kDecBK ? len - p0 : kDecBK;
    for (int jj = grp; jj < live; jj += G)
      acc = fmaf(ps[jj], to_f32(vb[(p0 + jj) * a.v_sp + col]), acc);
    __syncthreads();  // ps is rewritten by the next tile
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float t = part[tid];
#pragma unroll
    for (int g = 1; g < G; ++g) t += part[g * D + tid];  // fixed order
    TQ* op = static_cast<TQ*>(a.out) + ((int64_t)row * a.h + hh) * D;
    store_f32(op + tid, t / fmaxf(l, 1e-30f));
  }
}

template <typename TQ, typename TK>
cudaError_t launch_decode(const DecArgs& a, int n, int d,
                          cudaStream_t stream) {
  const dim3 grid((unsigned)(n * a.h));
  if (d == 32)
    flash_decode_kernel<TQ, TK, 32><<<grid, kDecThreads, 0, stream>>>(a);
  else if (d == 64)
    flash_decode_kernel<TQ, TK, 64><<<grid, kDecThreads, 0, stream>>>(a);
  else if (d == 128)
    flash_decode_kernel<TQ, TK, 128><<<grid, kDecThreads, 0, stream>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_decode_kv(const DecArgs& a, int kv_dtype, int n, int d,
                             cudaStream_t stream) {
  if (kv_dtype == 0) return launch_decode<TQ, float>(a, n, d, stream);
  if (kv_dtype == 1) return launch_decode<TQ, __nv_bfloat16>(a, n, d, stream);
  if (kv_dtype == 2) return launch_decode<TQ, int8_t>(a, n, d, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16,
// 2 = int8 (decode K/V only).

// q, k, v: (B, T, H, D) of one dtype, D contiguous, other axes through the
// element strides given.  out (B, Tq, H, D) contiguous in that dtype, lse
// (B, H, Tq) f32.  Keys at or past t_kv are masked; causal needs
// Tq == Tkv.  D is 32, 64 or 128.
int cmn_flash_fwd(const void* q, const void* k, const void* v, int dtype,
                  int d, int64_t q_sb, int64_t q_st, int64_t q_sh,
                  int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                  int64_t v_st, int64_t v_sh, void* out, float* lse, int b,
                  int h, int t_q, int t_kv, float scale, int causal,
                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b <= 0 || h <= 0 || t_q <= 0 || t_kv <= 0)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_sb = q_sb;
  a.q_st = q_st;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_st = k_st;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_st = v_st;
  a.v_sh = v_sh;
  a.out = out;
  a.lse = lse;
  a.h = h;
  a.t_q = t_q;
  a.t_kv = t_kv;
  a.scale = scale;
  a.causal = causal;
  if (dtype == 0) return (int)launch_fwd_d<float>(a, d, b * h, stream);
  if (dtype == 1) return (int)launch_fwd_d<__nv_bfloat16>(a, d, b * h, stream);
  return (int)cudaErrorInvalidValue;
}

// q: (N, H, D) f32/bf16 through strides (row, head); k, v: one layer's
// cache (slots, S, H, D) through strides (slot, position, head), every row
// 16-byte aligned; ks, vs: (slots, S, H) f32 scales for an int8 cache, or
// null.  lengths: (N,) int32 >= 1; slots: (N,) int32 or null.  out:
// (N, H, D) contiguous in q's dtype.  D is 32, 64 or 128.
int cmn_flash_decode(const void* q, int q_dtype, int64_t q_sn, int64_t q_sh,
                     const void* k, const void* v, int kv_dtype, int64_t k_ss,
                     int64_t k_sp, int64_t k_sh, int64_t v_ss, int64_t v_sp,
                     int64_t v_sh, const float* ks, const float* vs,
                     int64_t ks_ss, int64_t ks_sp, int64_t ks_sh,
                     int64_t vs_ss, int64_t vs_sp, int64_t vs_sh,
                     const int* lengths, const int* slots, void* out, int n,
                     int h, int s_max, int d, float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || h <= 0 || s_max <= 0) return (int)cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (ks != nullptr && vs != nullptr))
    return (int)cudaErrorInvalidValue;
  DecArgs a;
  a.q = q;
  a.q_sn = q_sn;
  a.q_sh = q_sh;
  a.k = k;
  a.v = v;
  a.k_ss = k_ss;
  a.k_sp = k_sp;
  a.k_sh = k_sh;
  a.v_ss = v_ss;
  a.v_sp = v_sp;
  a.v_sh = v_sh;
  a.ks = ks;
  a.vs = vs;
  a.ks_ss = ks_ss;
  a.ks_sp = ks_sp;
  a.ks_sh = ks_sh;
  a.vs_ss = vs_ss;
  a.vs_sp = vs_sp;
  a.vs_sh = vs_sh;
  a.lengths = lengths;
  a.slots = slots;
  a.out = out;
  a.h = h;
  a.s_max = s_max;
  a.scale = scale;
  if (q_dtype == 0)
    return (int)launch_decode_kv<float>(a, kv_dtype, n, d, stream);
  if (q_dtype == 1)
    return (int)launch_decode_kv<__nv_bfloat16>(a, kv_dtype, n, d, stream);
  return (int)cudaErrorInvalidValue;
}

const char* cmn_fa_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
