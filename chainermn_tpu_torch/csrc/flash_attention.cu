// Flash attention for Hopper (sm_90a): the prefill forward, its backward
// (dq; dk and dv) and the single-query decode read of a slot KV cache or
// of a paged KV pool.
//
// Replaces five Pallas TPU kernels of chainermn_tpu/ops/flash_attention.py:
//   _fwd_kernel     (launched by _fwd_pallas,    flash_attention.py:144)
//                                                   -> cmn_flash_fwd
//   _bwd_dq_kernel  (launched by _bwd_pallas,    flash_attention.py:375)
//                                                   -> cmn_flash_bwd_dq
//   _bwd_dkv_kernel (launched by _bwd_pallas,    flash_attention.py:397)
//                                                   -> cmn_flash_bwd_dkv
//   _decode_kernel  (launched by _decode_pallas, flash_attention.py:650)
//                                                   -> cmn_flash_decode
//   _decode_paged_kernel (launched by _decode_paged_pallas,
//                         flash_attention.py:953)   -> cmn_flash_decode_paged
//
// All keep the TPU kernels' online-softmax recurrence in f32 -- running
// max m, running sum l, accumulator acc; scores masked with the finite
// NEG_INF = -1e30 of chainermn_tpu/ops/_common.py; the output divided by
// max(l, 1e-30) -- and all hold the TPU kernels' numerics (they widen q,
// k, v to f32 before each product).  Two routes by dtype, both written
// here: f32 operands take scalar f32 FMA kernels (every cmn_* entry);
// bf16 operands of cmn_flash_fwd, cmn_flash_bwd_dq and cmn_flash_bwd_dkv
// take tensor-core kernels ("tensor cores" below), those of the decode
// kernels the scalar ones.
//
// ---- forward (cmn_flash_fwd, f32 operands) ----
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
// ---- backward (cmn_flash_bwd_dq; cmn_flash_bwd_dkv, f32 operands) ----
// With p = exp(s - lse) recomputed from the forward's lse (s formed as the
// forward forms it: the pre-scaled query times the key, then the mask),
// dp = g.v^T, ds = p * (dp - delta) * scale and delta = rowsum(g * out)
// (formed by the dq kernel's prologue from the g and out tiles it loads,
// in a fixed order, and written for the dk/dv kernel, which runs after it
// on the same stream):
//   dq = sum over keys    ds . k        dv = sum over queries p^T . g
//                                        dk = sum over queries ds^T . q
// Two kernels, as on the TPU, because the two sums run over different
// axes.  The TPU kernels carry their sums in VMEM scratch along a
// sequential innermost grid axis; here each block OWNS its output tile
// and a loop inside the block streams the other axis, so no sum crosses
// blocks: no float atomics, and two runs give the same bits.
//   dq:  one block per (batch*head, tile of query rows); it streams key
//        tiles of 32 up to the causal frontier, as the forward does.
//   dkv: one block per (batch*head, tile of key rows); it streams query
//        tiles of 32 FROM the causal frontier on (query tiles wholly
//        before the key tile contribute nothing and are never loaded).
// A tile that straddles the diagonal is masked element by element, and
// ragged T is masked in the kernel (no padded copies).  Each warp owns
// kRows rows of the block's tile; lane j takes row j of the streamed
// tile for the two score products (s and dp), reading the owned rows
// from shared memory as 16-byte broadcasts.  The scores then go through
// a per-warp staging patch in shared memory so that the second products
// (ds.k; p^T.g and ds^T.q) read them as 16-byte broadcasts too, each lane
// owning D/32 output columns.  The accumulators stay in registers; a
// block's shared memory is 33-41 KB at D = 32 and 57-74 KB at D = 64 and
// 128, above the 48 KB default, so every launch raises the kernel's limit
// to its own size first.
// What bounds them on the H100: operations (at T = 1024, D = 64 causal
// they do 5 products over 64 x 525k (query, key) pairs against 4 MB of
// operands).  Like the forward they run scalar f32 FMAs, and the two
// kernels recompute s and dp each (7 products for the 5 the gradient
// needs), so they sit far from the tensor-core bound.
//
// ---- tensor cores (bf16: flash_fwd_tc_kernel, flash_bwd_dq_tc_kernel,
//      flash_bwd_dkv_tc_kernel) ----
// FlashAttention-2's structure on mma.sync.m16n8k16 (bf16 operands, f32
// sums), with the TPU kernels' numerics:
//  - a bf16 x bf16 product is exact in f32, so Q.K^T, V.G^T and K.Q^T go
//    to mma as they are; the softmax scale multiplies the f32 scores
//    after the product (d^-0.5 is no power of two at D = 32 or 128: a
//    pre-scaled bf16 q would be rounded), and dK is scaled at the end;
//  - the second products need p (and ds) as a 16-bit operand.  One bf16
//    rounding would move an output by ~2^-9 of max|v|, beyond the
//    holds at outputs that cancel to ~0, so each is split into hi =
//    bf16(x) and lo = bf16(x - hi) and both meet the same B fragments:
//    x to ~2^-17, for 3 products where 2 would do (forward), 4 for 3
//    (dq) and 6 for 4 (dk/dv);
//  - the softmax runs in log2 units (exp2f of scale * log2(e) * s); lse
//    comes out in natural units.
// A block is 4 warps, 16 owned rows a warp (64 a block).  Operands stay
// bf16 in shared memory, rows padded by 16 bytes so that ldmatrix reads
// them without bank conflicts, filled by 16-byte cp.async (zero-filled
// past the edge) in a two-stage ring: the next tile streams in while the
// tensor cores work on this one.  The m16n8 accumulator layout is the
// m16n8k16 A-operand layout, so p and ds go from registers to mma.
//   forward: one block per (64 query rows, b*h), the tile order reversed
//     so the longest causal tiles start first; the warp's Q fragment is
//     held in registers, unscaled; key tiles of 64 up to the causal
//     frontier; a row's max and sum live in a quad of 4 lanes (two
//     shuffles each); only tiles on the causal diagonal or the t_kv edge
//     are masked.  Shared memory 45 KB at D = 64, 85 KB at D = 128.
//   dk/dv: one block per (64 key rows, b*h), each block owning its dK and
//     dV tile (no float atomics: runs are bit-equal); query tiles of 64
//     (32 at D = 128) streamed from the causal frontier on with their lse
//     and delta, 16 queries at a time: S^T = K.Q^T and dP^T = V.G^T on
//     mma, P^T = exp(scale S^T - lse) (0 where masked), dS^T = P^T (dP^T -
//     delta), then dV += P^T.G and dK += dS^T.Q with G and Q read through
//     ldmatrix.trans.  The warp's K and V fragments are held in registers
//     at D <= 64; at D = 128 the 128 accumulators of dK and dV leave no
//     room for them, and they are read from shared memory.
//   dq: one block per (64 query rows, b*h), each block owning its dQ tile,
//     the tile order reversed as in the forward; the prologue forms delta
//     from the G and out tiles (its out tile borrows a K/V ring stage);
//     key tiles of 64 up to the causal frontier, 16 keys at a time: S =
//     Q.K^T and dP = G.V^T on mma, P = exp(scale S - lse) (0 where
//     masked), dS = P (dP - delta), then dQ += dS.K with K read through
//     ldmatrix.trans; lse and delta of a lane's two rows stay in
//     registers.  Q and G fragments are held in registers at D <= 64 and
//     read from shared memory at D = 128.  Shared memory 54 KB at D = 64,
//     102 KB at D = 128.
// What bounds them: operations at the bf16 tensor-core rate; for the
// hi/lo split this design runs 1.5x (forward), 1.33x (dq) and 1.5x
// (dk/dv's second products) the minimum, on mma.sync, which reaches a
// part of the rate that wgmma does.
//
// ---- decode (cmn_flash_decode, cmn_flash_decode_paged): split-K ----
// One query row per (row, head) against its cache: the slot form reads a
// (slots, S, H, D) cache in place through strides, with an optional row ->
// slot map (replaces _decode_kernel, launched by _decode_pallas); the
// paged form reads a pool (P, ps, H, D) through the row's page table
// (replaces _decode_paged_kernel, launched by _decode_paged_pallas).  Both
// are flash_decode_split_kernel, with kPaged choosing the address of a
// position: slot * slot_stride + p * pos_stride, or table[b, p / ps] *
// page_stride + (p % ps) * offset_stride.  int8 caches carry per-(position,
// head) f32 scales: the K scale multiplies the score, the V scale rides on
// p (l sums the unscaled p).
// What bounds it on the H100: device-memory bytes -- one pass over the
// live K/V, 2 flops per byte of bf16 (no tensor-core work: one query row
// a head).  A row's live bytes are a few KB to a few hundred KB, so the
// time is the latency of getting them moving: the kernel has to put many
// bytes in flight at once on every SM.
// What the design does about it (flash-decoding):
//  - the key axis is cut into splits of kSplit = 128 positions, a block
//    per (row, head, split): at 32 rows x 8 heads and S = 512, up to 1024
//    blocks.  Row r has ceil(len_r / kSplit) live splits; the grid is
//    sized from S (slot) or n_max * ps (paged), which the host knows, and
//    a block past its row's live splits exits at once.  128 and not 64:
//    the serving engine's rows (prompts up to 128 tokens plus the tokens
//    made so far) mostly fit one split and skip the merge, which costs a
//    fence, an atomic and a second read of the partials (on the H100, 64
//    took 0.0054 ms a call at the serve profile's lengths 65-96 against
//    0.0028-0.0039 for 128, and 0.0103 against 0.0107 at S 512, uniform
//    lengths; PERF.md);
//  - a block requests ALL of its split's K and V chunks (16 bytes a lane)
//    into registers before it uses any: kLanes = D * sizeof(TK) / 16
//    lanes read one row contiguously, kThreads / kLanes rows at once,
//    kRows (<= 8) times: 16 KB of K and 16 KB of V in flight a block at
//    bf16 D = 64.  Registers and not shared memory: the time is a chain
//    of dependent latencies -- the length, the table entry, the K/V
//    bytes, the merge -- not the bytes in flight, and a cp.async staging
//    measured 10-15% slower.  The lanes of a row join their partial dots
//    by xor shuffles; for P.V each lane keeps the kVec columns of its
//    chunk, summed over its rows in order, then over a warp's row groups
//    by xor shuffles, then over the warps in order;
//  - each split writes its (m, l, acc[D]) in f32 to a workspace, and the
//    last block of the row to finish (a ticket counter, atomicInc, which
//    wraps back to zero) merges the splits in split order 0..n-1: M =
//    max m_j, l = sum l_j exp(m_j - M), acc likewise, out = acc / max(l,
//    1e-30).  No atomic touches a value.  A row with one live split
//    writes its output directly: a merge of one has weight exp(0) = 1 and
//    gives the same bits.
// Why the two forms stay bit-equal: the split boundaries are a function of
// the position alone (never of the page size), and every sum runs in the
// same order in both; only the addresses differ.  Two runs give equal
// bits for the same reason.  No table entry or page at or past a row's
// live length is read.  The rounding order is modelled in PyTorch ops in
// tests/test_torch_decode_split.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

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
// backward

constexpr int kBwdWarps = 8;
constexpr int kBT = 32;  // rows of a streamed tile: one per lane

template <int D>
struct BwdCfg {
  static constexpr int kRows = D <= 64 ? 8 : 4;  // owned rows per warp
  static constexpr int kBO = kBwdWarps * kRows;  // owned rows per block
  static constexpr int kPer = D / 32;            // output columns per lane
  // dq: q and g tiles (owned), the ds patch, k and v tiles (streamed),
  // the owned rows' lse and delta
  static constexpr size_t kSmemDq =
      sizeof(float) * (2 * (size_t)kBO * D + (size_t)kBO * kBT +
                       2 * (size_t)kBT * (D + 1) + 2 * (size_t)kBO);
  // dkv: k and v tiles (owned), the p and ds patches, q and g tiles
  // (streamed), their lse and delta
  static constexpr size_t kSmemDkv =
      sizeof(float) * (2 * (size_t)kBO * D + 2 * (size_t)kBO * kBT +
                       2 * (size_t)kBT * (D + 1) + 2 * (size_t)kBT);
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;             // d(loss)/d(out), laid out like q
  const void* out;           // the forward's output, laid out like q (dq)
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t g_sb, g_st, g_sh;
  int64_t o_sb, o_st, o_sh;
  const float* lse;  // (B, H, Tq) f32, the forward's
  float* delta;      // (B, H, Tq) f32, rowsum(g * out): dq writes, dkv reads
  void* dq;            // (B, Tq, H, D) contiguous, q's dtype
  void* dk;            // (B, Tkv, H, D) contiguous
  void* dv;
  int h, t_q, t_kv;
  float scale;
  int causal;
};

// Copy rows [t0, t0 + rows) of a (T, D) operand into shared memory as f32
// times mul, zero past t_end; the shared rows are `pitch` floats apart.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src,
                                          int64_t stride_t, int t0, int rows,
                                          int t_end, float mul) {
  for (int e = threadIdx.x; e < rows * D; e += kBwdWarps * 32) {
    const int r = e / D, c = e % D, t = t0 + r;
    dst[r * pitch + c] = t < t_end ? to_f32(src[t * stride_t + c]) * mul : 0.f;
  }
}

// x[r] += own[r][:] . mine[:] and y[r] += own2[r][:] . mine2[:] for the R
// owned rows of a warp (own, own2: R x D in shared memory, read as 16-byte
// broadcasts) against the lane's own streamed rows (mine, mine2).
template <int R, int D>
__device__ __forceinline__ void score_rows(float* x, float* y,
                                           const float* own, const float* own2,
                                           const float* mine,
                                           const float* mine2) {
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    const float a0 = mine[c], a1 = mine[c + 1], a2 = mine[c + 2],
                a3 = mine[c + 3];
    const float b0 = mine2[c], b1 = mine2[c + 1], b2 = mine2[c + 2],
                b3 = mine2[c + 3];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 o = *reinterpret_cast<const float4*>(own + r * D + c);
      const float4 o2 = *reinterpret_cast<const float4*>(own2 + r * D + c);
      x[r] = fmaf(o.x, a0, x[r]);
      x[r] = fmaf(o.y, a1, x[r]);
      x[r] = fmaf(o.z, a2, x[r]);
      x[r] = fmaf(o.w, a3, x[r]);
      y[r] = fmaf(o2.x, b0, y[r]);
      y[r] = fmaf(o2.y, b1, y[r]);
      y[r] = fmaf(o2.z, b2, y[r]);
      y[r] = fmaf(o2.w, b3, y[r]);
    }
  }
}

// acc[r][i] += sum_j w[r][j] * tile[j][lane + 32 i] over the kBT rows of a
// streamed tile (pitch D + 1); w is the warp's R x kBT staging patch, read
// as 16-byte broadcasts.
template <int R, int D>
__device__ __forceinline__ void accumulate_rows(float (*acc)[D / 32],
                                                const float* w,
                                                const float* tile, int lane) {
  constexpr int P = D / 32;
#pragma unroll 2
  for (int jj = 0; jj < kBT; jj += 4) {
    float t[4][P];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < P; ++i)
        t[u][i] = tile[(jj + u) * (D + 1) + lane + 32 * i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + r * kBT + jj);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        acc[r][i] = fmaf(w4.x, t[0][i], acc[r][i]);
        acc[r][i] = fmaf(w4.y, t[1][i], acc[r][i]);
        acc[r][i] = fmaf(w4.z, t[2][i], acc[r][i]);
        acc[r][i] = fmaf(w4.w, t[3][i], acc[r][i]);
      }
    }
  }
}

// The f32 route of cmn_flash_bwd_dq.  Its prologue forms delta =
// rowsum(g * out) of the owned rows (lanes over the columns, a warp_sum
// in a fixed order) and writes it for the dk/dv kernel; lse and delta of
// the owned rows wait in shared memory, not registers (at D = 64 the
// eight rows' 16 values in registers spilled).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
    flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int R = BwdCfg<D>::kRows;
  constexpr int BO = BwdCfg<D>::kBO;
  constexpr int P = BwdCfg<D>::kPer;
  extern __shared__ float4 bwd_smem[];  // 16-byte aligned
  float* qs = reinterpret_cast<float*>(bwd_smem);  // BO x D, pre-scaled
  float* gs = qs + BO * D;                         // BO x D
  float* dss = gs + BO * D;                        // BO x kBT: ds patches
  float* ks = dss + BO * kBT;                      // kBT x (D + 1)
  float* vs = ks + kBT * (D + 1);                  // kBT x (D + 1)
  float* ls = vs + kBT * (D + 1);                  // BO: lse
  float* des = ls + BO;                            // BO: delta

  const int bh = blockIdx.y;
  const int b = bh / a.h, hh = bh % a.h;
  const int q0 = blockIdx.x * BO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + hh * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hh * a.v_sh;
  const T* gp = static_cast<const T*>(a.g) + b * a.g_sb + hh * a.g_sh;
  const T* op = static_cast<const T*>(a.out) + b * a.o_sb + hh * a.o_sh;

  load_tile<T, D>(qs, D, qp, a.q_st, q0, BO, a.t_q, a.scale);
  load_tile<T, D>(gs, D, gp, a.g_st, q0, BO, a.t_q, 1.f);
  __syncthreads();  // gs is written

  // delta = rowsum(g * out) of the warp's rows
  for (int r = 0; r < R; ++r) {
    const int row = warp * R + r, qpos = q0 + row;
    const bool live = qpos < a.t_q;  // the same for the whole warp
    float x = 0.f;
    if (live) {
#pragma unroll
      for (int i = 0; i < P; ++i)
        x = fmaf(gs[row * D + lane + 32 * i],
                 to_f32(op[qpos * a.o_st + lane + 32 * i]), x);
    }
    x = warp_sum(x);
    if (lane == 0) {
      des[row] = x;
      ls[row] = live ? a.lse[(int64_t)bh * a.t_q + qpos] : 0.f;
      if (live) a.delta[(int64_t)bh * a.t_q + qpos] = x;
    }
  }

  float acc[R][P];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < P; ++i) acc[r][i] = 0.f;

  int n_tiles = (a.t_kv + kBT - 1) / kBT;
  if (a.causal) {
    const int frontier = (q0 + BO + kBT - 1) / kBT;  // tiles with key < q0+BO
    if (frontier < n_tiles) n_tiles = frontier;
  }
  float* patch = dss + warp * R * kBT;
  const float* lse = ls + warp * R;
  const float* delta = des + warp * R;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBT;
    __syncthreads();  // the previous tile is consumed (and qs, ls written)
    load_tile<T, D>(ks, D + 1, kp, a.k_st, k0, kBT, a.t_kv, 1.f);
    load_tile<T, D>(vs, D + 1, vp, a.v_st, k0, kBT, a.t_kv, 1.f);
    __syncthreads();

    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
    score_rows<R, D>(s, dp, qs + warp * R * D, gs + warp * R * D,
                     ks + lane * (D + 1), vs + lane * (D + 1));
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + warp * R + r;
      const bool ok =
          qpos < a.t_q && kpos < a.t_kv && (!a.causal || qpos >= kpos);
      // a masked score is NEG_INF, and exp(NEG_INF - lse) is 0
      const float p = ok ? expf(s[r] - lse[r]) : 0.f;
      patch[r * kBT + lane] = p * (dp[r] - delta[r]) * a.scale;
    }
    __syncwarp();
    accumulate_rows<R, D>(acc, patch, ks, lane);
  }

  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qpos = q0 + warp * R + r;
    if (qpos >= a.t_q) continue;
    T* orow = dqp + (((int64_t)b * a.t_q + qpos) * a.h + hh) * D;
#pragma unroll
    for (int i = 0; i < P; ++i) store_f32(orow + lane + 32 * i, acc[r][i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
    flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int R = BwdCfg<D>::kRows;
  constexpr int BO = BwdCfg<D>::kBO;
  constexpr int P = BwdCfg<D>::kPer;
  extern __shared__ float4 bwd_smem[];  // 16-byte aligned
  float* ks = reinterpret_cast<float*>(bwd_smem);  // BO x D
  float* vs = ks + BO * D;                         // BO x D
  float* pss = vs + BO * D;                        // BO x kBT: p patches
  float* dss = pss + BO * kBT;                     // BO x kBT: ds patches
  float* qs = dss + BO * kBT;      // kBT x (D + 1), pre-scaled
  float* gs = qs + kBT * (D + 1);  // kBT x (D + 1)
  float* ls = gs + kBT * (D + 1);  // kBT: lse of the streamed queries
  float* des = ls + kBT;           // kBT: their delta

  const int bh = blockIdx.y;
  const int b = bh / a.h, hh = bh % a.h;
  const int k0 = blockIdx.x * BO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + hh * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hh * a.v_sh;
  const T* gp = static_cast<const T*>(a.g) + b * a.g_sb + hh * a.g_sh;

  load_tile<T, D>(ks, D, kp, a.k_st, k0, BO, a.t_kv, 1.f);
  load_tile<T, D>(vs, D, vp, a.v_st, k0, BO, a.t_kv, 1.f);

  float dk[R][P], dv[R][P];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < P; ++i) dk[r][i] = dv[r][i] = 0.f;

  const int n_tiles = (a.t_q + kBT - 1) / kBT;
  // causal: query tiles wholly before this key tile contribute nothing
  const int first = a.causal ? k0 / kBT : 0;
  float* p_patch = pss + warp * R * kBT;
  float* ds_patch = dss + warp * R * kBT;
  for (int j = first; j < n_tiles; ++j) {
    const int q0 = j * kBT;
    __syncthreads();  // the previous tile is consumed (and ks, vs written)
    load_tile<T, D>(qs, D + 1, qp, a.q_st, q0, kBT, a.t_q, a.scale);
    load_tile<T, D>(gs, D + 1, gp, a.g_st, q0, kBT, a.t_q, 1.f);
    if (tid < kBT) {
      const int t = q0 + tid;
      ls[tid] = t < a.t_q ? a.lse[(int64_t)bh * a.t_q + t] : 0.f;
      des[tid] = t < a.t_q ? a.delta[(int64_t)bh * a.t_q + t] : 0.f;
    }
    __syncthreads();

    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
    score_rows<R, D>(s, dp, ks + warp * R * D, vs + warp * R * D,
                     qs + lane * (D + 1), gs + lane * (D + 1));
    const int qpos = q0 + lane;
    const float lse = ls[lane], delta = des[lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int kpos = k0 + warp * R + r;
      const bool ok =
          qpos < a.t_q && kpos < a.t_kv && (!a.causal || qpos >= kpos);
      const float p = ok ? expf(s[r] - lse) : 0.f;
      p_patch[r * kBT + lane] = p;
      // ds without its scale: qs carries it (ds * q = p (dp - delta) (q scale))
      ds_patch[r * kBT + lane] = p * (dp[r] - delta);
    }
    __syncwarp();
    accumulate_rows<R, D>(dv, p_patch, gs, lane);
    accumulate_rows<R, D>(dk, ds_patch, qs, lane);
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kpos = k0 + warp * R + r;
    if (kpos >= a.t_kv) continue;
    const int64_t off = (((int64_t)b * a.t_kv + kpos) * a.h + hh) * D;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      store_f32(dkp + off + lane + 32 * i, dk[r][i]);
      store_f32(dvp + off + lane + 32 * i, dv[r][i]);
    }
  }
}

// Every backward block needs more than the 48 KB of shared memory a launch
// gets by default: raise the kernel's limit first, or the launch is refused.
template <typename K>
cudaError_t launch_bwd(K kernel, const BwdArgs& a, int tiles, int bh,
                       size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)tiles, (unsigned)bh), kBwdWarps * 32, smem, stream>>>(
      a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const BwdArgs& a, int bh, cudaStream_t stream);
template <int D>
cudaError_t launch_dq_tc(const BwdArgs& a, int bh, cudaStream_t stream);

// bf16 operands go to the tensor-core kernels, f32 operands to the scalar
// kernels above
template <typename T, int D>
cudaError_t launch_bwd_td(const BwdArgs& a, int bh, bool dkv,
                          cudaStream_t stream) {
  constexpr int BO = BwdCfg<D>::kBO;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return dkv ? launch_dkv_tc<D>(a, bh, stream)
               : launch_dq_tc<D>(a, bh, stream);
  } else {
    if (dkv)
      return launch_bwd(flash_bwd_dkv_kernel<T, D>, a,
                        (a.t_kv + BO - 1) / BO, bh, BwdCfg<D>::kSmemDkv,
                        stream);
    return launch_bwd(flash_bwd_dq_kernel<T, D>, a, (a.t_q + BO - 1) / BO,
                      bh, BwdCfg<D>::kSmemDq, stream);
  }
}

template <typename T>
cudaError_t launch_bwd_t(const BwdArgs& a, int d, int bh, bool dkv,
                         cudaStream_t stream) {
  if (d == 32) return launch_bwd_td<T, 32>(a, bh, dkv, stream);
  if (d == 64) return launch_bwd_td<T, 64>(a, bh, dkv, stream);
  if (d == 128) return launch_bwd_td<T, 128>(a, bh, dkv, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_bwd_any(const BwdArgs& a, int dtype, int d, int b, bool dkv,
                           cudaStream_t stream) {
  if (b <= 0 || a.h <= 0 || a.t_q <= 0 || a.t_kv <= 0)
    return cudaErrorInvalidValue;
  if (a.causal && a.t_q != a.t_kv) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_bwd_t<float>(a, d, b * a.h, dkv, stream);
  if (dtype == 1)
    return launch_bwd_t<__nv_bfloat16>(a, d, b * a.h, dkv, stream);
  return cudaErrorInvalidValue;
}

// The 12 strides are those of q, k, v, g: batch, token, head each.
BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* g,
                 const int64_t* strides, const float* lse, float* delta,
                 int h, int t_q, int t_kv, float scale, int causal) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.q_sb = strides[0];
  a.q_st = strides[1];
  a.q_sh = strides[2];
  a.k_sb = strides[3];
  a.k_st = strides[4];
  a.k_sh = strides[5];
  a.v_sb = strides[6];
  a.v_st = strides[7];
  a.v_sh = strides[8];
  a.g_sb = strides[9];
  a.g_st = strides[10];
  a.g_sh = strides[11];
  a.out = nullptr;
  a.o_sb = a.o_st = a.o_sh = 0;
  a.lse = lse;
  a.delta = delta;
  a.dq = nullptr;
  a.dk = nullptr;
  a.dv = nullptr;
  a.h = h;
  a.t_q = t_q;
  a.t_kv = t_kv;
  a.scale = scale;
  a.causal = causal;
  return a;
}

// ---------------------------------------------------------------------
// tensor-core kernels: the bf16 routes of cmn_flash_fwd and
// cmn_flash_bwd_dkv (see "tensor cores" at the top of the file)

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 16 * kTcWarps;  // owned rows a block: 16 per warp
constexpr int kPad = 8;  // bf16 elements of padding after each shared row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled (and nothing
// read) when !live
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 give the rows of matrix i); .trans transposes each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col): bf16 operands, f32 sums
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// (x, y) as a 16-bit pair hi = bf16(x, y) and the remainder lo =
// bf16((x, y) - hi): hi + lo holds x and y to about 2^-17 of each
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// The A operand (16 x 16, rows = this lane's quad rows) of the m16n8
// accumulators c0 (columns 0..7) and c1 (columns 8..15), split hi / lo.
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// Rows [t0, t0 + ROWS) of a (T, D) bf16 operand (rows `st` elements
// apart, 16-byte aligned) into shared memory, rows D + kPad apart; rows
// at or past t_end are zero-filled.  Every thread issues its part.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          int64_t st, int t0, int t_end) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * kChunks % kTcThreads == 0, "uneven copy");
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kTcThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8, t = t0 + r;
    const bool live = t < t_end;
    cp_async16(dst + r * (D + kPad) + c, live ? src + t * st + c : src, live);
  }
}

// n f32 values src[t0 + i] into dst[i], zero at or past t_end
__device__ __forceinline__ void copy_vec(float* dst, const float* src, int n,
                                         int t0, int t_end) {
  for (int i = threadIdx.x; i < n; i += kTcThreads) {
    const bool live = t0 + i < t_end;
    cp_async4(dst + i, live ? src + t0 + i : src, live);
  }
}

template <int D>
struct TcFwdCfg {
  static constexpr int kBK = 64;  // keys a tile
  // the query tile, then two stages each of K and V
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(D + kPad) * (kTcRows + 4 * kBK);
};

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(FwdArgs a) {
  constexpr int BK = TcFwdCfg<D>::kBK, P = D + kPad;
  constexpr int KS = D / 16;  // k-steps of Q.K^T
  constexpr int NS = BK / 8;  // n-blocks of S (8 keys each)
  constexpr int NO = D / 8;   // n-blocks of O (8 columns each)
  extern __shared__ float4 tc_smem[];  // 16-byte aligned
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // kTcRows x P
  bf16* ks = qs + kTcRows * P;                   // 2 x BK x P
  bf16* vs = ks + 2 * BK * P;                    // 2 x BK x P

  const int bh = blockIdx.y;
  const int b = bh / a.h, hh = bh % a.h;
  // the longest causal tiles (the last query rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tg = lane & 3;  // quad row, lane in quad
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + hh * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hh * a.v_sh;

  int n_tiles = (a.t_kv + BK - 1) / BK;
  if (a.causal) {
    const int frontier = (q0 + kTcRows + BK - 1) / BK;  // keys < q0 + rows
    if (frontier < n_tiles) n_tiles = frontier;
  }
  copy_rows<D, kTcRows>(qs, qp, a.q_st, q0, a.t_q);
  copy_rows<D, BK>(ks, kp, a.k_st, 0, a.t_kv);
  copy_rows<D, BK>(vs, vp, a.v_st, 0, a.t_kv);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows gr, gr + 8
  const float sl2 = a.scale * kLog2e;  // scores in log2 units
  const int wq = q0 + warp * 16;       // the warp's first query row

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // the next tile streams in during this one
      const int nx = (j + 1) & 1;
      copy_rows<D, BK>(ks + nx * BK * P, kp, a.k_st, (j + 1) * BK, a.t_kv);
      copy_rows<D, BK>(vs + nx * BK * P, vp, a.v_st, (j + 1) * BK, a.t_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {  // the warp's 16 query rows, held unscaled from here on
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * P + kk * 16 +
                            (lane >> 4) * 8);
    }
    const bf16* kt = ks + (j & 1) * BK * P;
    const bf16* vt = vs + (j & 1) * BK * P;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NS; n += 2)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * P +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[n], qf[kk], kb[0], kb[1]);
        mma16816(s[n + 1], qf[kk], kb[2], kb[3]);
      }

    // scale after the product; mask only a tile on the causal diagonal
    // or the t_kv edge
    const int k0 = j * BK;
    const bool edge =
        k0 + BK > a.t_kv || (a.causal && k0 + BK - 1 > wq);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * sl2;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * tg + (c & 1);
          const int qpos = wq + gr + (c >> 1) * 8;
          if (kpos >= a.t_kv || (a.causal && kpos > qpos)) x = kNegInf;
        }
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row lives in a quad of 4 lanes
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[n][c] - m[c >> 1]);
        s[n][c] = p;
        l[c >> 1] += p;  // this lane's part of the row sum
      }

    // O += P.V: the accumulators of S are the A operand, split hi / lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_frag(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + (kk * 16 + (lane & 15)) * P + n * 8 +
                          (lane >> 4) * 8);
        mma16816(o[n], ph, vb[0], vb[1]);
        mma16816(o[n], pl, vb[0], vb[1]);
        mma16816(o[n + 1], ph, vb[2], vb[3]);
        mma16816(o[n + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  bf16* op = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = wq + gr + 8 * r;
    if (qpos >= a.t_q) continue;  // padded query rows are dropped
    const float l_safe = fmaxf(l[r], 1e-30f);
    bf16* orow = op + (((int64_t)b * a.t_q + qpos) * a.h + hh) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] / l_safe,
                                o[n][2 * r + 1] / l_safe);
    if (tg == 0) a.lse[(int64_t)bh * a.t_q + qpos] = m[r] * kLn2 + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_fwd_tc(const FwdArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = TcFwdCfg<D>::kSmem;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((a.t_q + kTcRows - 1) / kTcRows), (unsigned)bh);
  flash_fwd_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_fwd_tc_d(const FwdArgs& a, int d, int bh,
                            cudaStream_t stream) {
  if (d == 32) return launch_fwd_tc<32>(a, bh, stream);
  if (d == 64) return launch_fwd_tc<64>(a, bh, stream);
  if (d == 128) return launch_fwd_tc<128>(a, bh, stream);
  return cudaErrorInvalidValue;
}

// One k-step (16 columns) of S^T = K.Q^T and dP^T = V.G^T for a warp's
// 16 keys against 16 queries: ka, va the keys' A fragments, q and g this
// lane's row addresses in the query tile.
__device__ __forceinline__ void score_k16(float (&s)[2][4], float (&d)[2][4],
                                          const uint32_t (&ka)[4],
                                          const uint32_t (&va)[4],
                                          const bf16* q, const bf16* g) {
  uint32_t qb[4], gb[4];
  ldsm_x4(qb, q);
  ldsm_x4(gb, g);
  mma16816(s[0], ka, qb[0], qb[1]);
  mma16816(s[1], ka, qb[2], qb[3]);
  mma16816(d[0], va, gb[0], gb[1]);
  mma16816(d[1], va, gb[2], gb[3]);
}

template <int D>
struct TcBwdCfg {
  static constexpr int kBQ = D == 128 ? 32 : 64;  // streamed query rows
  // the warp's K and V fragments live in registers at D <= 64; at D = 128
  // they are read from shared memory for each product (registers)
  static constexpr bool kKvRegs = D <= 64;
  // lse and delta (two stages each), the K and V tiles, two stages each
  // of the Q and G tiles
  static constexpr size_t kSmem =
      sizeof(float) * 4 * (size_t)kBQ +
      sizeof(bf16) * (size_t)(D + kPad) * (2 * kTcRows + 4 * kBQ);
};

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_tc_kernel(BwdArgs a) {
  constexpr int BQ = TcBwdCfg<D>::kBQ, P = D + kPad;
  constexpr bool kRegs = TcBwdCfg<D>::kKvRegs;
  constexpr int KS = D / 16;  // k-steps of K.Q^T and V.G^T
  constexpr int NO = D / 8;   // n-blocks of dK and dV
  // without the fragments in registers, one query slice at a time too
  constexpr int kSqUnroll = kRegs ? BQ / 16 : 1;
  extern __shared__ float4 tc_smem[];
  float* ls = reinterpret_cast<float*>(tc_smem);  // 2 x BQ: lse
  float* des = ls + 2 * BQ;                       // 2 x BQ: delta
  bf16* kt = reinterpret_cast<bf16*>(des + 2 * BQ);  // kTcRows x P
  bf16* vt = kt + kTcRows * P;                       // kTcRows x P
  bf16* qs = vt + kTcRows * P;                       // 2 x BQ x P
  bf16* gs = qs + 2 * BQ * P;                        // 2 x BQ x P

  const int bh = blockIdx.y;
  const int b = bh / a.h, hh = bh % a.h;
  const int k0 = blockIdx.x * kTcRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tg = lane & 3;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + hh * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hh * a.v_sh;
  const bf16* gp = static_cast<const bf16*>(a.g) + b * a.g_sb + hh * a.g_sh;
  const float* lp = a.lse + (int64_t)bh * a.t_q;
  const float* dp = a.delta + (int64_t)bh * a.t_q;

  const int n_tiles = (a.t_q + BQ - 1) / BQ;
  // causal: query tiles wholly before this key tile contribute nothing
  const int first = a.causal ? k0 / BQ : 0;
  copy_rows<D, kTcRows>(kt, kp, a.k_st, k0, a.t_kv);
  copy_rows<D, kTcRows>(vt, vp, a.v_st, k0, a.t_kv);
  copy_rows<D, BQ>(qs, qp, a.q_st, first * BQ, a.t_q);
  copy_rows<D, BQ>(gs, gp, a.g_st, first * BQ, a.t_q);
  copy_vec(ls, lp, BQ, first * BQ, a.t_q);
  copy_vec(des, dp, BQ, first * BQ, a.t_q);
  cp_async_commit();

  uint32_t kf[kRegs ? KS : 1][4], vf[kRegs ? KS : 1][4];
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int wk = k0 + warp * 16;  // the warp's first key row
  // this lane's A-operand row address in the K and V tiles
  const int a_off = (warp * 16 + (lane & 15)) * P + (lane >> 4) * 8;

  for (int j = first; j < n_tiles; ++j) {
    const int stage = (j - first) & 1;
    if (j + 1 < n_tiles) {  // the next tile streams in during this one
      const int nx = stage ^ 1;
      copy_rows<D, BQ>(qs + nx * BQ * P, qp, a.q_st, (j + 1) * BQ, a.t_q);
      copy_rows<D, BQ>(gs + nx * BQ * P, gp, a.g_st, (j + 1) * BQ, a.t_q);
      copy_vec(ls + nx * BQ, lp, BQ, (j + 1) * BQ, a.t_q);
      copy_vec(des + nx * BQ, dp, BQ, (j + 1) * BQ, a.t_q);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kRegs) {
      if (j == first) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(kf[kk], kt + a_off + kk * 16);
          ldsm_x4(vf[kk], vt + a_off + kk * 16);
        }
      }
    }
    const bf16* qt = qs + stage * BQ * P;
    const bf16* gt = gs + stage * BQ * P;
    const float* lt = ls + stage * BQ;
    const float* dt = des + stage * BQ;
    const int q0 = j * BQ;
    // mask only a tile that straddles the causal diagonal of this warp's
    // keys or the t_q edge
    const bool edge = q0 + BQ > a.t_q || (a.causal && q0 < wk + 15);

#pragma unroll(kSqUnroll)
    for (int sq = 0; sq < BQ / 16; ++sq) {  // 16 queries at a time
      // S^T = K.Q^T and dP^T = V.G^T for the warp's 16 keys
      float s[2][4], d[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = d[n][c] = 0.f;
      const int b_off = (sq * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                        ((lane >> 3) & 1) * 8;
      if constexpr (kRegs) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          score_k16(s, d, kf[kk], vf[kk], qt + b_off + kk * 16,
                    gt + b_off + kk * 16);
      } else {
        // one k-step at a time: the 128 accumulators of dK and dV leave
        // no registers for loads hoisted from later steps
#pragma unroll 1
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t ka[4], va[4];
          ldsm_x4(ka, kt + a_off + kk * 16);
          ldsm_x4(va, vt + a_off + kk * 16);
          score_k16(s, d, ka, va, qt + b_off + kk * 16, gt + b_off + kk * 16);
        }
      }
      // P^T = exp(scale S^T - lse), masked to 0; dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = sq * 16 + n * 8 + 2 * tg + (c & 1);
          float p = exp2f(s[n][c] * sl2 - lt[qi] * kLog2e);
          if (edge) {
            const int qpos = q0 + qi, kpos = wk + gr + (c >> 1) * 8;
            if (qpos >= a.t_q || (a.causal && qpos < kpos)) p = 0.f;
          }
          s[n][c] = p;
          d[n][c] = p * (d[n][c] - dt[qi]);
        }
      // dV += P^T.G and dK += dS^T.Q: the accumulators are the A
      // operands (split hi / lo), G and Q the B operands (transposed)
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_frag(s[0], s[1], ph, pl);
      split_frag(d[0], d[1], dh, dl);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t gb[4], qb[4];
        const int t_off = (sq * 16 + (lane & 15)) * P + n * 8 + (lane >> 4) * 8;
        ldsm_x4_t(gb, gt + t_off);
        ldsm_x4_t(qb, qt + t_off);
        mma16816(dv[n], ph, gb[0], gb[1]);
        mma16816(dv[n], pl, gb[0], gb[1]);
        mma16816(dv[n + 1], ph, gb[2], gb[3]);
        mma16816(dv[n + 1], pl, gb[2], gb[3]);
        mma16816(dk[n], dh, qb[0], qb[1]);
        mma16816(dk[n], dl, qb[0], qb[1]);
        mma16816(dk[n + 1], dh, qb[2], qb[3]);
        mma16816(dk[n + 1], dl, qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = wk + gr + 8 * r;
    if (kpos >= a.t_kv) continue;
    const int64_t off = (((int64_t)b * a.t_kv + kpos) * a.h + hh) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + n * 8) =
          __floats2bfloat162_rn(dk[n][2 * r] * a.scale,
                                dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + n * 8) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_tc(const BwdArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = TcBwdCfg<D>::kSmem;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((a.t_kv + kTcRows - 1) / kTcRows), (unsigned)bh);
  flash_bwd_dkv_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
struct TcDqCfg {
  static constexpr int kBK = 64;  // keys a tile
  // the warp's Q and G fragments live in registers at D <= 64; at D = 128
  // they are read from shared memory for each product (registers)
  static constexpr bool kQgRegs = D <= 64;
  // the Q and G tiles, then two stages each of the K and V tiles (the
  // prologue's out tile borrows the second V stage)
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(D + kPad) * (2 * kTcRows + 4 * kBK);
};

// The bf16 route of cmn_flash_bwd_dq (see "tensor cores" at the top of the
// file): one block per (64 query rows, b*h), each block owning its dQ
// tile (no float atomics: runs are bit-equal), the tile order reversed so
// the longest causal rows start first.  The prologue loads the Q, G and
// out tiles once and forms delta = rowsum(g * out) of the warp's rows
// (each lane of a quad sums its columns, two shuffles join them: a fixed
// order) and writes it for the dk/dv kernel.  Key tiles of 64 stream in
// up to the causal frontier, 16 keys at a time: S = Q.K^T and dP = G.V^T
// on mma, P = exp(scale S - lse) (0 where masked), dS = P (dP - delta),
// then dQ += dS.K with K read through ldmatrix.trans.  Each lane keeps
// lse and delta of its two mma rows in registers for the whole loop.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_tc_kernel(BwdArgs a) {
  constexpr int BK = TcDqCfg<D>::kBK, P = D + kPad;
  constexpr bool kRegs = TcDqCfg<D>::kQgRegs;
  constexpr int KS = D / 16;  // k-steps of Q.K^T and G.V^T
  constexpr int NO = D / 8;   // n-blocks of dQ
  // without the fragments in registers, one key slice at a time too
  constexpr int kSkUnroll = kRegs ? BK / 16 : 1;
  static_assert(BK == kTcRows, "out's tile borrows a V stage");
  extern __shared__ float4 tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // kTcRows x P
  bf16* gs = qs + kTcRows * P;                   // kTcRows x P
  bf16* ks = gs + kTcRows * P;                   // 2 x BK x P
  bf16* vs = ks + 2 * BK * P;                    // 2 x BK x P
  bf16* os = vs + BK * P;  // the second V stage, until tile 1 streams in

  const int bh = blockIdx.y;
  const int b = bh / a.h, hh = bh % a.h;
  // the longest causal tiles (the last query rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tg = lane & 3;  // quad row, lane in quad
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + hh * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hh * a.v_sh;
  const bf16* gp = static_cast<const bf16*>(a.g) + b * a.g_sb + hh * a.g_sh;
  const bf16* op =
      static_cast<const bf16*>(a.out) + b * a.o_sb + hh * a.o_sh;

  int n_tiles = (a.t_kv + BK - 1) / BK;
  if (a.causal) {
    const int frontier = (q0 + kTcRows + BK - 1) / BK;  // keys < q0 + rows
    if (frontier < n_tiles) n_tiles = frontier;
  }
  copy_rows<D, kTcRows>(qs, qp, a.q_st, q0, a.t_q);
  copy_rows<D, kTcRows>(gs, gp, a.g_st, q0, a.t_q);
  copy_rows<D, kTcRows>(os, op, a.o_st, q0, a.t_q);
  copy_rows<D, BK>(ks, kp, a.k_st, 0, a.t_kv);
  copy_rows<D, BK>(vs, vp, a.v_st, 0, a.t_kv);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wq = q0 + warp * 16;  // the warp's first query row
  // lse (in log2 units) and delta of this lane's rows wq + gr, wq + gr + 8
  float lse2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + gr + 8 * r, qpos = q0 + row;
    const bf16* grow = gs + row * P + 2 * tg;
    const bf16* orow = os + row * P + 2 * tg;
    float x = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float2 gv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(grow + n * 8));
      const float2 ov = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(orow + n * 8));
      x = fmaf(gv.x, ov.x, x);
      x = fmaf(gv.y, ov.y, x);
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const bool live = qpos < a.t_q;  // rows past t_q: zero g, zero out
    dr[r] = x;
    lse2[r] = live ? a.lse[(int64_t)bh * a.t_q + qpos] * kLog2e : 0.f;
    if (live && tg == 0) a.delta[(int64_t)bh * a.t_q + qpos] = x;
  }
  // this lane's A-operand row address in the Q and G tiles
  const int a_off = (warp * 16 + (lane & 15)) * P + (lane >> 4) * 8;
  uint32_t qf[kRegs ? KS : 1][4], gf[kRegs ? KS : 1][4];
  if constexpr (kRegs) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(qf[kk], qs + a_off + kk * 16);
      ldsm_x4(gf[kk], gs + a_off + kk * 16);
    }
  }
  __syncthreads();  // out's tile is read: tile 1 may stream into its stage

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {  // the next tile streams in during this one
      const int nx = stage ^ 1;
      copy_rows<D, BK>(ks + nx * BK * P, kp, a.k_st, (j + 1) * BK, a.t_kv);
      copy_rows<D, BK>(vs + nx * BK * P, vp, a.v_st, (j + 1) * BK, a.t_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + stage * BK * P;
    const bf16* vt = vs + stage * BK * P;
    const int k0 = j * BK;
    // mask only a tile on the causal diagonal of this warp's rows or at
    // the t_kv edge
    const bool edge = k0 + BK > a.t_kv || (a.causal && k0 + BK - 1 > wq);

#pragma unroll(kSkUnroll)
    for (int sk = 0; sk < BK / 16; ++sk) {  // 16 keys at a time
      // S = Q.K^T and dP = G.V^T for the warp's 16 query rows
      float s[2][4], d[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = d[n][c] = 0.f;
      const int b_off = (sk * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                        ((lane >> 3) & 1) * 8;
      if constexpr (kRegs) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          score_k16(s, d, qf[kk], gf[kk], kt + b_off + kk * 16,
                    vt + b_off + kk * 16);
      } else {
        // one k-step at a time: loads hoisted from later steps would take
        // the registers the dQ accumulators need
#pragma unroll 1
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t qa[4], ga[4];
          ldsm_x4(qa, qs + a_off + kk * 16);
          ldsm_x4(ga, gs + a_off + kk * 16);
          score_k16(s, d, qa, ga, kt + b_off + kk * 16, vt + b_off + kk * 16);
        }
      }
      // P = exp(scale S - lse), masked to 0; dS = P (dP - delta)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1;
          float p = exp2f(s[n][c] * sl2 - lse2[r]);
          if (edge) {
            const int kpos = k0 + sk * 16 + n * 8 + 2 * tg + (c & 1);
            const int qpos = wq + gr + 8 * r;
            if (kpos >= a.t_kv || (a.causal && kpos > qpos)) p = 0.f;
          }
          d[n][c] = p * (d[n][c] - dr[r]);
        }
      // dQ += dS.K: the accumulators of dS are the A operand (split hi /
      // lo), the K slice the B operand (transposed)
      uint32_t dh[4], dl[4];
      split_frag(d[0], d[1], dh, dl);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t kb[4];
        ldsm_x4_t(kb, kt + (sk * 16 + (lane & 15)) * P + n * 8 +
                          (lane >> 4) * 8);
        mma16816(dq[n], dh, kb[0], kb[1]);
        mma16816(dq[n], dl, kb[0], kb[1]);
        mma16816(dq[n + 1], dh, kb[2], kb[3]);
        mma16816(dq[n + 1], dl, kb[2], kb[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  bf16* dqp = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = wq + gr + 8 * r;
    if (qpos >= a.t_q) continue;  // padded query rows are dropped
    bf16* orow = dqp + (((int64_t)b * a.t_q + qpos) * a.h + hh) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(dq[n][2 * r] * a.scale,
                                dq[n][2 * r + 1] * a.scale);
  }
}

template <int D>
cudaError_t launch_dq_tc(const BwdArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = TcDqCfg<D>::kSmem;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((a.t_q + kTcRows - 1) / kTcRows), (unsigned)bh);
  flash_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// decode

// Positions of the key axis one block owns.  The split boundaries are a
// function of the position alone -- never of the page size, the layout
// or the card -- so paged and slot decode over the same K/V give equal
// bits.  chainermn_tpu_torch/ops/flash_attention.py DECODE_SPLIT names
// the same number (the wrapper sizes the workspace with it).
constexpr int kSplit = 128;

// The slot kernel reads a (slots, S, H, D) cache; the paged kernel a pool
// (P, page_size, H, D) through per-row page tables.  For the paged kernel
// the "slot" strides below are the pool's page strides and the "position"
// strides its in-page offset strides.
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
  const int* tables;   // paged: (N, n_max) page ids, contiguous
  int n_max, page_size;
  void* out;           // (N, H, D), contiguous, q's dtype
  int h, s_max;        // paged: s_max = n_max * page_size
  float scale;
  // split partials: acc (N*H, n_split, D) then (m, l) (N*H, n_split, 2),
  // f32; tickets (N*H,) zero between launches (the last block of a
  // (row, head) leaves its counter at zero again)
  float* ws;
  unsigned* tickets;
  int n_split;         // ceil(s_max / kSplit), the grid's y
};

// How a block of the (TK, D) instantiation covers its split: a row of D
// elements is kLanes 16-byte chunks, one lane each; kThreads / kLanes rows
// are read at once, kRows times.
template <typename TK, int D>
struct DecShape {
  static constexpr int kVec = 16 / (int)sizeof(TK);  // elements a chunk
  static constexpr int kLanes = D / kVec;            // lanes a row: 2..32
  static constexpr int kThreads =
      kSplit * kLanes >= 1024 ? kSplit * kLanes / 8 : 128;
  static constexpr int kStride = kThreads / kLanes;  // rows read at once
  static constexpr int kRows = kSplit / kStride;     // rows a thread
  static constexpr int kWarps = kThreads / 32;
  static_assert(kLanes >= 2 && kLanes <= 32 && 32 % kLanes == 0, "lanes");
  static_assert(kRows * kStride == kSplit && D <= kThreads, "split");
};

// One template for both caches: the arithmetic, the split and the order
// of every reduction are the same, only the address of a position
// differs, so paged and slot decode over the same K/V give equal bits.
// Block (row * h + head, split) scores positions [split * kSplit, +kSplit)
// of its row; blocks past the row's live splits exit at once.
template <typename TQ, typename TK, int D, bool kPaged>
__global__ void __launch_bounds__(DecShape<TK, D>::kThreads)
    flash_decode_split_kernel(DecArgs a) {
  using S = DecShape<TK, D>;
  constexpr int kVec = S::kVec, kLanes = S::kLanes, kRows = S::kRows;
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  __shared__ float red[S::kWarps];
  __shared__ float lsum[S::kWarps];
  __shared__ float part[S::kWarps][D];
  __shared__ bool last;

  const int bh = blockIdx.x, split = blockIdx.y;
  const int row = bh / a.h, hh = bh % a.h;
  int len = a.lengths[row];
  len = len < a.s_max ? len : a.s_max;
  const int n_live = len > kSplit ? (len + kSplit - 1) / kSplit : 1;
  if (split >= n_live) return;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % kLanes, rg = tid / kLanes;
  const int p0 = split * kSplit;
  const int64_t slot = kPaged ? 0 : (a.slots != nullptr ? a.slots[row] : row);
  const int* table = kPaged ? a.tables + (int64_t)row * a.n_max : nullptr;
  const TK* kh = static_cast<const TK*>(a.k) + hh * a.k_sh + c * kVec;
  const TK* vh = static_cast<const TK*>(a.v) + hh * a.v_sh + c * kVec;

  // Every K and V chunk (and int8 scale) of the split's live rows is
  // requested here, before any is used: kRows 16-byte loads of K and of V
  // a thread in flight at once.  The paged form looks each live
  // position's page up in the table; no entry at or past
  // ceil(len / page_size) is read.
  uint4 kc[kRows], vc[kRows];
  float ksc[kRows], vsc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int pos = p0 + rg + i * S::kStride;
    kc[i] = make_uint4(0u, 0u, 0u, 0u);
    vc[i] = kc[i];
    ksc[i] = vsc[i] = 1.f;
    if (pos < len) {
      const int64_t base = kPaged ? (int64_t)table[pos / a.page_size] : slot;
      const int64_t off = kPaged ? pos % a.page_size : pos;
      kc[i] = __ldg(reinterpret_cast<const uint4*>(kh + base * a.k_ss +
                                                    off * a.k_sp));
      vc[i] = __ldg(reinterpret_cast<const uint4*>(vh + base * a.v_ss +
                                                    off * a.v_sp));
      if (kQuant) {
        ksc[i] = __ldg(a.ks + hh * a.ks_sh + base * a.ks_ss + off * a.ks_sp);
        vsc[i] = __ldg(a.vs + hh * a.vs_sh + base * a.vs_ss + off * a.vs_sp);
      }
    }
  }
  // this lane's kVec columns of the query, pre-scaled
  const TQ* qp =
      static_cast<const TQ*>(a.q) + row * a.q_sn + hh * a.q_sh + c * kVec;
  float qs[kVec];
#pragma unroll
  for (int t = 0; t < kVec; ++t) qs[t] = to_f32(qp[t]) * a.scale;

  // scores: a row's kLanes lanes each dot their chunk, then join by xor
  // shuffles (every lane of the group ends with the same bits); int8: the
  // K scale multiplies the score
  float s[kRows];
  float m = kNegInf;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const TK* e = reinterpret_cast<const TK*>(&kc[i]);
    float dot = 0.f;
#pragma unroll
    for (int t = 0; t < kVec; ++t) dot = fmaf(qs[t], to_f32(e[t]), dot);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    s[i] = p0 + rg + i * S::kStride < len ? dot * ksc[i] : kNegInf;
    m = fmaxf(m, s[i]);
  }
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < S::kWarps; ++w) m = fmaxf(m, red[w]);

  // p = exp(s - m) of the split; the V scale rides on p (l sums the
  // unscaled p).  Each lane sums its rows in order, then the row groups
  // of a warp join by xor shuffles and the warps in order 0..kWarps-1.
  float l = 0.f, acc[kVec];
#pragma unroll
  for (int t = 0; t < kVec; ++t) acc[t] = 0.f;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float p =
        p0 + rg + i * S::kStride < len ? expf(s[i] - m) : 0.f;
    l += p;
    const float pv = p * vsc[i];
    const TK* e = reinterpret_cast<const TK*>(&vc[i]);
#pragma unroll
    for (int t = 0; t < kVec; ++t) acc[t] = fmaf(pv, to_f32(e[t]), acc[t]);
  }
#pragma unroll
  for (int off = 16; off >= kLanes; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int t = 0; t < kVec; ++t)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
  }
  if (lane < kLanes) {
#pragma unroll
    for (int t = 0; t < kVec; ++t) part[warp][c * kVec + t] = acc[t];
  }
  if (lane == 0) lsum[warp] = l;
  __syncthreads();

  TQ* op = static_cast<TQ*>(a.out) + (int64_t)bh * D;
  const int64_t pi = (int64_t)bh * a.n_split + split;
  float* ws_ml = a.ws + (int64_t)gridDim.x * a.n_split * D;
  if (tid < D) {
    float o = part[0][tid], lt = lsum[0];
#pragma unroll
    for (int w = 1; w < S::kWarps; ++w) {
      o += part[w][tid];
      lt += lsum[w];
    }
    if (n_live == 1) {
      // a merge of one split: weight exp(m - m) = 1, the same bits
      store_f32(op + tid, o / fmaxf(lt, 1e-30f));
    } else {
      a.ws[pi * D + tid] = o;
      if (tid == 0) {
        ws_ml[pi * 2] = m;
        ws_ml[pi * 2 + 1] = lt;
      }
    }
  }
  if (n_live == 1) return;

  // The last of the row's live blocks to finish merges the splits, in
  // split order 0..n_live-1 whichever block it is.  The ticket wraps to
  // zero on the last increment (atomicInc), ready for the next launch;
  // no atomic touches a value.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicInc(a.tickets + bh, (unsigned)(n_live - 1)) ==
           (unsigned)(n_live - 1);
  __syncthreads();
  if (!last || tid >= D) return;
  const float* ml = ws_ml + (int64_t)bh * a.n_split * 2;
  const float* ac = a.ws + (int64_t)bh * a.n_split * D + tid;
  float mx = kNegInf;
  for (int j = 0; j < n_live; ++j) mx = fmaxf(mx, __ldcg(ml + 2 * j));
  float lt = 0.f, o = 0.f;
  for (int j = 0; j < n_live; ++j) {
    const float w = expf(__ldcg(ml + 2 * j) - mx);
    lt = fmaf(__ldcg(ml + 2 * j + 1), w, lt);
    o = fmaf(__ldcg(ac + (int64_t)j * D), w, o);
  }
  store_f32(op + tid, o / fmaxf(lt, 1e-30f));
}

template <typename TQ, typename TK, int D, bool kPaged>
cudaError_t launch_decode_split(const DecArgs& a, int n,
                                cudaStream_t stream) {
  const dim3 grid((unsigned)(n * a.h), (unsigned)a.n_split);
  flash_decode_split_kernel<TQ, TK, D, kPaged>
      <<<grid, DecShape<TK, D>::kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TK, bool kPaged>
cudaError_t launch_decode(const DecArgs& a, int n, int d,
                          cudaStream_t stream) {
  if (d == 32) return launch_decode_split<TQ, TK, 32, kPaged>(a, n, stream);
  if (d == 64) return launch_decode_split<TQ, TK, 64, kPaged>(a, n, stream);
  if (d == 128)
    return launch_decode_split<TQ, TK, 128, kPaged>(a, n, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ, bool kPaged>
cudaError_t launch_decode_kv(const DecArgs& a, int kv_dtype, int n, int d,
                             cudaStream_t stream) {
  if (kv_dtype == 0) return launch_decode<TQ, float, kPaged>(a, n, d, stream);
  if (kv_dtype == 1)
    return launch_decode<TQ, __nv_bfloat16, kPaged>(a, n, d, stream);
  if (kv_dtype == 2) return launch_decode<TQ, int8_t, kPaged>(a, n, d, stream);
  return cudaErrorInvalidValue;
}

// Checks the workspace and tickets the wrapper handed over, then launches.
template <bool kPaged>
cudaError_t launch_decode_any(DecArgs& a, int q_dtype, int kv_dtype, int n,
                              int d, int64_t ws_floats, int64_t n_tickets,
                              cudaStream_t stream) {
  a.n_split = (a.s_max + kSplit - 1) / kSplit;
  if (a.n_split > 65535 || (int64_t)n * a.h > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (ws_floats < (int64_t)n * a.h * a.n_split * (d + 2) ||
      n_tickets < (int64_t)n * a.h || a.ws == nullptr ||
      a.tickets == nullptr)
    return cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch_decode_kv<float, kPaged>(a, kv_dtype, n, d, stream);
  if (q_dtype == 1)
    return launch_decode_kv<__nv_bfloat16, kPaged>(a, kv_dtype, n, d, stream);
  return cudaErrorInvalidValue;
}

DecArgs decode_args(const void* q, int64_t q_sn, int64_t q_sh, const void* k,
                    const void* v, int64_t k_ss, int64_t k_sp, int64_t k_sh,
                    int64_t v_ss, int64_t v_sp, int64_t v_sh, const float* ks,
                    const float* vs, int64_t ks_ss, int64_t ks_sp,
                    int64_t ks_sh, int64_t vs_ss, int64_t vs_sp,
                    int64_t vs_sh, const int* lengths, void* out, int h,
                    int s_max, float scale, float* ws, unsigned* tickets) {
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
  a.slots = nullptr;
  a.tables = nullptr;
  a.n_max = 0;
  a.page_size = 1;
  a.out = out;
  a.h = h;
  a.s_max = s_max;
  a.scale = scale;
  a.ws = ws;
  a.tickets = tickets;
  a.n_split = 0;
  return a;
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
  if (dtype == 1) return (int)launch_fwd_tc_d(a, d, b * h, stream);
  return (int)cudaErrorInvalidValue;
}

// The backward's operands: q, k, v and g (the gradient of out) are
// (B, T, H, D) of one dtype, D contiguous, other axes through the element
// strides of `strides` (q, k, v, g; batch, token, head each: 12); lse is
// (B, H, Tq) f32.  Causal needs Tq == Tkv.  D is 32, 64 or 128.  dq is
// (B, Tq, H, D), dk and dv (B, Tkv, H, D), all contiguous in the
// operands' dtype.
//
// cmn_flash_bwd_dq also reads out (the forward's output, (B, Tq, H, D) in
// the operands' dtype through strides[12..14]) and WRITES delta =
// rowsum(g * out), (B, H, Tq) f32, which cmn_flash_bwd_dkv then reads.
int cmn_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* g, int dtype, int d, const int64_t* strides,
                     const float* lse, float* delta, const void* out,
                     void* dq, int b, int h, int t_q, int t_kv, float scale,
                     int causal, void* stream_ptr) {
  BwdArgs a =
      bwd_args(q, k, v, g, strides, lse, delta, h, t_q, t_kv, scale, causal);
  a.out = out;
  a.o_sb = strides[12];
  a.o_st = strides[13];
  a.o_sh = strides[14];
  a.dq = dq;
  return (int)launch_bwd_any(a, dtype, d, b, false,
                             static_cast<cudaStream_t>(stream_ptr));
}

int cmn_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* g, int dtype, int d, const int64_t* strides,
                      const float* lse, const float* delta, void* dk, void* dv,
                      int b, int h, int t_q, int t_kv, float scale, int causal,
                      void* stream_ptr) {
  // the dk/dv kernels only read delta
  BwdArgs a = bwd_args(q, k, v, g, strides, lse, const_cast<float*>(delta),
                       h, t_q, t_kv, scale, causal);
  a.dk = dk;
  a.dv = dv;
  return (int)launch_bwd_any(a, dtype, d, b, true,
                             static_cast<cudaStream_t>(stream_ptr));
}

// q: (N, H, D) f32/bf16 through strides (row, head); k, v: one layer's
// cache (slots, S, H, D) through strides (slot, position, head), every row
// 16-byte aligned; ks, vs: (slots, S, H) f32 scales for an int8 cache, or
// null.  lengths: (N,) int32 >= 1; slots: (N,) int32 or null.  out:
// (N, H, D) contiguous in q's dtype.  D is 32, 64 or 128.  ws: f32
// scratch of at least N * H * ceil(S / kSplit) * (D + 2) floats (its
// contents need not be set); tickets: at least N * H uint32 counters,
// zero before the launch and zero again after it.
int cmn_flash_decode(const void* q, int q_dtype, int64_t q_sn, int64_t q_sh,
                     const void* k, const void* v, int kv_dtype, int64_t k_ss,
                     int64_t k_sp, int64_t k_sh, int64_t v_ss, int64_t v_sp,
                     int64_t v_sh, const float* ks, const float* vs,
                     int64_t ks_ss, int64_t ks_sp, int64_t ks_sh,
                     int64_t vs_ss, int64_t vs_sp, int64_t vs_sh,
                     const int* lengths, const int* slots, void* out, int n,
                     int h, int s_max, int d, float scale, float* ws,
                     int64_t ws_floats, unsigned* tickets, int64_t n_tickets,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || h <= 0 || s_max <= 0) return (int)cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (ks != nullptr && vs != nullptr))
    return (int)cudaErrorInvalidValue;
  DecArgs a = decode_args(q, q_sn, q_sh, k, v, k_ss, k_sp, k_sh, v_ss, v_sp,
                          v_sh, ks, vs, ks_ss, ks_sp, ks_sh, vs_ss, vs_sp,
                          vs_sh, lengths, out, h, s_max, scale, ws, tickets);
  a.slots = slots;
  return (int)launch_decode_any<false>(a, q_dtype, kv_dtype, n, d, ws_floats,
                                       n_tickets, stream);
}

// The paged twin of cmn_flash_decode.  k, v: one layer's pool (P, ps, H, D)
// through strides (page, in-page offset, head), every row 16-byte aligned;
// ks, vs: (P, ps, H) f32 scales for an int8 pool, or null.  tables: (N,
// n_max) int32 contiguous, position p of row i at page tables[i, p / ps],
// offset p % ps; entries at or past ceil(lengths[i] / ps) are never read.
// lengths: (N,) int32 in 1..n_max * ps.  out: (N, H, D) contiguous in q's
// dtype.  D is 32, 64 or 128.  ws and tickets as for cmn_flash_decode,
// with S = n_max * ps.
int cmn_flash_decode_paged(
    const void* q, int q_dtype, int64_t q_sn, int64_t q_sh, const void* k,
    const void* v, int kv_dtype, int64_t k_sg, int64_t k_so, int64_t k_sh,
    int64_t v_sg, int64_t v_so, int64_t v_sh, const float* ks,
    const float* vs, int64_t ks_sg, int64_t ks_so, int64_t ks_sh,
    int64_t vs_sg, int64_t vs_so, int64_t vs_sh, const int* tables,
    int n_max, int page_size, const int* lengths, void* out, int n, int h,
    int d, float scale, float* ws, int64_t ws_floats, unsigned* tickets,
    int64_t n_tickets, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || h <= 0 || n_max <= 0 || page_size <= 0 ||
      (int64_t)n_max * page_size > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (ks != nullptr && vs != nullptr))
    return (int)cudaErrorInvalidValue;
  DecArgs a = decode_args(q, q_sn, q_sh, k, v, k_sg, k_so, k_sh, v_sg, v_so,
                          v_sh, ks, vs, ks_sg, ks_so, ks_sh, vs_sg, vs_so,
                          vs_sh, lengths, out, h, n_max * page_size, scale,
                          ws, tickets);
  a.tables = tables;
  a.n_max = n_max;
  a.page_size = page_size;
  return (int)launch_decode_any<true>(a, q_dtype, kv_dtype, n, d, ws_floats,
                                      n_tickets, stream);
}

const char* cmn_fa_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
