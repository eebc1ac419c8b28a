// Fused BatchNorm (+ residual add) (+ relu) for Hopper (sm_90a), forward
// and backward.
//
// Replaces the two Pallas TPU kernels of chainermn_tpu/ops/batch_norm_act.py:
//   _stats_kernel (launched by _stats_pallas)  -> cmn_bn_stats
//   _apply_kernel / _apply_res_kernel (launched by _apply_pallas)
//                                              -> cmn_bn_apply
// and computes its jnp backward (_bn_act_bwd) as two kernels
//                                              -> cmn_bn_backward
//
// Layout: the (..., C) activation is a row-major (M, C) matrix; statistics
// reduce over rows.
//
// What bounds them on the H100: device-memory bytes.  Stats reads x once
// (2 or 4 bytes per element, ~10 flops each with the compensated sums);
// apply reads x (+ residual) and writes out once; the backward reads x,
// g (and out for the relu mask) twice and writes dx (and the residual's
// gradient) once.  All are far below the card's ~20 flop/byte f32 balance
// point, so the design goal is few passes over the activation with
// 16-byte loads and enough bytes in flight to fill 132 SMs.
//
// The column sums (stats: Sx and Sx^2; backward: S gm and S gm*xhat) share
// one template, bn_reduce_kernel<Op>:
// - a block covers a tile of at most kMaxTileVec 16-byte vectors along C
//   (64 bf16 or 32 f32 channels) and a chunk of rows; each thread reads
//   one vector of a row, so at C = 32 bf16 four threads cover a row and a
//   warp reads 8 rows at once;
// - the wrapper sizes the chunks (ops/batch_norm_act.py _plan): about two
//   blocks per SM in all, each reading at least 32 KB, so a small C gets
//   few long chunks;
// - a thread sums its rows in order (Kahan), the block's row lanes are
//   folded in a fixed pairwise tree, and each chunk writes its
//   compensated partial (sum and carry) per channel;
// - the last block of a tile to finish (an atomicInc ticket after
//   __threadfence, which wraps the counter back to 0) sums the chunks'
//   partials with all its threads, strided by chunk index in a fixed
//   order, then folds them in the same tree.  No float atomics: the
//   result is the same from run to run, whichever block is last.
// The TPU stats kernel carries its sums across a sequential grid; blocks
// on Hopper run in no order, hence the partials and the ticket.
//
// Rounding: every product and sum uses the __f*_rn intrinsics, which nvcc
// never contracts into an FMA, so the kernels round where the plain
// PyTorch versions round (bn_apply and the backward's elementwise pass
// are bit-equal to theirs).  Every sum is compensated: Kahan inside a
// thread's run, and TwoSum when two compensated sums meet in a tree.
// Plain f32 sums lose about five times the accuracy of torch's tree
// reduction on the variance E[x^2] - E[x]^2, which cancels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads of a reduce / backward block
constexpr int kMaxTileVec = 8;  // 16-byte vectors a block covers along C
constexpr int kTreeFloats = kThreads / 2 * 8 * 4;
constexpr int kFinishBatch = 8;  // chunks a finishing lane loads at once
constexpr int kTileC = 32;      // apply: channels per block
constexpr int kLanes = 8;       // apply: row lanes per block

// element storage: bf16 travels as its 16 bits, f16 as __half; both
// widen to f32 exactly, and every sum and statistic stays f32
template <typename T> struct Storage;
template <> struct Storage<float> { using type = float; };
template <> struct Storage<__nv_bfloat16> { using type = unsigned short; };
template <> struct Storage<__half> { using type = __half; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}
__device__ __forceinline__ float to_f32(__half h) { return __half2float(h); }
__device__ __forceinline__ void from_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f32(unsigned short& d, float v) {
  d = __bfloat16_as_ushort(__float2bfloat16(v));
}
__device__ __forceinline__ void from_f32(__half& d, float v) {
  d = __float2half_rn(v);
}

// V neighbouring elements, loaded and stored as one vector
template <typename S, int V>
struct alignas(sizeof(S) * V) Pack {
  S v[V];
};

template <typename S, int V>
__device__ __forceinline__ Pack<S, V> load_pack(const S* p) {
  return *reinterpret_cast<const Pack<S, V>*>(p);
}

// A compensated sum: the value is s - c.  The __f*_rn intrinsics keep
// nvcc from reassociating the carry away.
struct Comp {
  float s, c;
  __device__ __forceinline__ void zero() { s = c = 0.f; }
  // Kahan: the rounding error of each addition is carried into c
  __device__ __forceinline__ void add(float v) {
    const float y = __fsub_rn(v, c);
    const float t = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(t, s), y);
    s = t;
  }
  // another compensated sum (os - oc): TwoSum keeps the heads' rounding
  // error e exactly (s + os = t + e), so the sum is t - (c + oc - e)
  __device__ __forceinline__ void merge(float os, float oc) {
    const float t = __fadd_rn(s, os);
    const float bp = __fsub_rn(t, s);
    const float ap = __fsub_rn(t, bp);
    const float e = __fadd_rn(__fsub_rn(s, ap), __fsub_rn(os, bp));
    c = __fsub_rn(__fadd_rn(c, oc), e);
    s = t;
  }
  __device__ __forceinline__ float value() const { return __fsub_rn(s, c); }
};

// How a reduce or backward launch covers the (M, C) matrix (the wrapper's
// _plan): blockIdx.x is the channel tile of tcv vectors, blockIdx.y the
// chunk of `rows` rows; a block has tcv * lanes threads, thread t reads
// vector t % tcv of rows r0 + t / tcv + k * lanes.
struct Plan {
  int64_t m, c, rows;
  int tcv, lanes, n_chunks;
};

// Fold `lanes` row lanes of compensated sums (N channels x two sums per
// thread, `width` threads a lane) into lane 0: lane l takes lane
// l + half, for half = 2^k down to 1 -- a fixed pairwise tree.  Every
// thread of the block calls it (it synchronizes); lanes >= `lanes` only
// wait.
template <int N>
__device__ __forceinline__ void fold(Comp (&a)[N], Comp (&b)[N], float* tree,
                                     int tx, int ty, int width, int lanes) {
  int half = 1;
  while (half < lanes) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (ty >= half && ty < 2 * half && ty < lanes) {
      float* slot = tree + ((ty - half) * width + tx) * N * 4;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        slot[4 * k] = a[k].s;
        slot[4 * k + 1] = a[k].c;
        slot[4 * k + 2] = b[k].s;
        slot[4 * k + 3] = b[k].c;
      }
    }
    __syncthreads();
    if (ty < half && ty + half < lanes) {
      const float* slot = tree + (ty * width + tx) * N * 4;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        a[k].merge(slot[4 * k], slot[4 * k + 1]);
        b[k].merge(slot[4 * k + 2], slot[4 * k + 3]);
      }
    }
    __syncthreads();
  }
}

// Two column sums over the rows of an (M, C) matrix; Op gives the terms
// and what becomes of the sums:
//   Op::kVec, Op::kUnroll   elements a load, rows a thread has in flight
//   Op::Row load(i)         the vector at flat element index i
//   Op::Lane lane(ch0)      per-thread constants of channels ch0..+kVec
//   Lane::terms(row, k, a, b)   the two terms of element k of `row`
//   finish(ch, a, b)        the two sums of channel ch
// part is (4, n_chunks, C) f32 scratch (sum, carry of each sum), tickets
// one counter a tile, zero between launches.
template <class Op>
__global__ void __launch_bounds__(kThreads, 2)
    bn_reduce_kernel(const Op op, const Plan p, float* __restrict__ part,
                  unsigned* __restrict__ tickets) {
  constexpr int V = Op::kVec, U = Op::kUnroll;
  __shared__ float tree[kTreeFloats];
  __shared__ bool last;
  const int tx = threadIdx.x % p.tcv, ty = threadIdx.x / p.tcv;
  const int tile = blockIdx.x, chunk = blockIdx.y;
  const int64_t ch0 = ((int64_t)tile * p.tcv + tx) * V;
  const bool live = ch0 < p.c;
  const int64_t r0 = (int64_t)chunk * p.rows;
  const int64_t r1 = r0 + p.rows < p.m ? r0 + p.rows : p.m;
  Comp a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k].zero();
    b[k].zero();
  }
  if (live) {
    const typename Op::Lane lane = op.lane(ch0);
    for (int64_t r = r0 + ty; r < r1; r += (int64_t)p.lanes * U) {
      typename Op::Row row[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int64_t rr = r + (int64_t)j * p.lanes;
        if (rr < r1) row[j] = op.load(rr * p.c + ch0);
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (r + (int64_t)j * p.lanes < r1) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float ta, tb;
            lane.terms(row[j], k, ta, tb);
            a[k].add(ta);
            b[k].add(tb);
          }
        }
      }
    }
  }
  fold<V>(a, b, tree, tx, ty, p.tcv, p.lanes);
  const int64_t nc = (int64_t)p.n_chunks * p.c;
  if (ty == 0 && live) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t i = (int64_t)chunk * p.c + ch0 + k;
      part[i] = a[k].s;
      part[nc + i] = a[k].c;
      part[2 * nc + i] = b[k].s;
      part[3 * nc + i] = b[k].c;
    }
  }
  // the last block of this tile to finish sums every chunk's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&tickets[tile], (unsigned)(p.n_chunks - 1)) ==
           (unsigned)(p.n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // tc channels, fl lanes each, chunk k to lane k % fl, in chunk order;
  // kFinishBatch chunks' loads in flight at once (a lane walks up to
  // ~70 chunks, and one L2 round trip a chunk would dominate)
  const int tc = p.tcv * V;
  const int fl = blockDim.x / tc;
  const int fch = threadIdx.x % tc, flane = threadIdx.x / tc;
  const int64_t ch = (int64_t)tile * tc + fch;
  Comp fa[1], fb[1];
  fa[0].zero();
  fb[0].zero();
  if (flane < fl && ch < p.c) {
    const int64_t step = (int64_t)fl * kFinishBatch;
    for (int64_t k0 = flane; k0 < p.n_chunks; k0 += step) {
      float v[kFinishBatch][4];
#pragma unroll
      for (int j = 0; j < kFinishBatch; ++j) {
        const int64_t k = k0 + (int64_t)j * fl;
        if (k < p.n_chunks) {
          const int64_t i = k * p.c + ch;
#pragma unroll
          for (int q = 0; q < 4; ++q) v[j][q] = __ldcg(part + q * nc + i);
        }
      }
#pragma unroll
      for (int j = 0; j < kFinishBatch; ++j) {
        if (k0 + (int64_t)j * fl < p.n_chunks) {
          fa[0].merge(v[j][0], v[j][1]);
          fb[0].merge(v[j][2], v[j][3]);
        }
      }
    }
  }
  fold<1>(fa, fb, tree, fch, flane, tc, fl);
  if (flane == 0 && ch < p.c) op.finish(ch, fa[0].value(), fb[0].value());
}

// Statistics: sums of x and x^2, then flax-parity statistics over the
// REAL row count: mean, fast variance clipped at zero, 1 / sqrt(var + eps).
template <typename S, int V>
struct StatsOp {
  static constexpr int kVec = V, kUnroll = 4;
  using Row = Pack<S, V>;
  struct Lane {
    __device__ __forceinline__ void terms(const Row& r, int k, float& a,
                                          float& b) const {
      const float v = to_f32(r.v[k]);
      a = v;
      b = __fmul_rn(v, v);
    }
  };
  const S* x;
  float *mean, *var, *rstd;
  int64_t m;
  float eps;
  __device__ __forceinline__ Lane lane(int64_t) const { return Lane(); }
  __device__ __forceinline__ Row load(int64_t i) const {
    return load_pack<S, V>(x + i);
  }
  __device__ __forceinline__ void finish(int64_t ch, float s, float q) const {
    const float fm = (float)m;
    const float mu = __fdiv_rn(s, fm);
    float v = __fsub_rn(__fdiv_rn(q, fm), __fmul_rn(mu, mu));
    v = v > 0.f ? v : 0.f;
    mean[ch] = mu;
    var[ch] = v;
    rstd[ch] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(v, eps)));
  }
};

// The backward's per-element quantities, in the plain version's order:
// xhat = (x - mean) * rstd, gm = g * (out > 0) under the relu, else g.
template <typename S, int V, bool kRelu>
__device__ __forceinline__ void bwd_terms(const Pack<S, V>& x,
                                          const Pack<S, V>& g,
                                          const Pack<S, V>& o, int k,
                                          float mu, float rs, float& gm,
                                          float& xhat) {
  const float gf = to_f32(g.v[k]);
  gm = kRelu ? __fmul_rn(gf, to_f32(o.v[k]) > 0.f ? 1.f : 0.f) : gf;
  xhat = __fmul_rn(__fsub_rn(to_f32(x.v[k]), mu), rs);
}

// The backward's sums: dbeta = S gm, dgamma = S gm * xhat.
template <typename S, int V, bool kRelu>
struct BwdSumOp {
  static constexpr int kVec = V, kUnroll = 2;
  struct Row {
    Pack<S, V> x, g, o;
  };
  struct Lane {
    float mu[V], rs[V];
    __device__ __forceinline__ void terms(const Row& r, int k, float& a,
                                          float& b) const {
      float xhat;
      bwd_terms<S, V, kRelu>(r.x, r.g, r.o, k, mu[k], rs[k], a, xhat);
      b = __fmul_rn(a, xhat);
    }
  };
  const S *x, *g, *o;
  const float *mean, *rstd;
  float *dbeta, *dgamma;
  __device__ __forceinline__ Lane lane(int64_t ch0) const {
    Lane l;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      l.mu[k] = mean[ch0 + k];
      l.rs[k] = rstd[ch0 + k];
    }
    return l;
  }
  __device__ __forceinline__ Row load(int64_t i) const {
    Row r;
    r.x = load_pack<S, V>(x + i);
    r.g = load_pack<S, V>(g + i);
    if (kRelu) r.o = load_pack<S, V>(o + i);
    return r;
  }
  __device__ __forceinline__ void finish(int64_t ch, float a, float b) const {
    dbeta[ch] = a;
    dgamma[ch] = b;
  }
};

// The backward's elementwise pass, in the plain version's order:
//   dx = (scale * rstd) * ((gm - dbeta / m) - xhat * (dgamma / m))
//        [+ (g_mean + (2 (x - mean)) * g_var) / m]
//   dres = gm (when res is not null)
// g_mean / g_var null: that cotangent is zero; both null: no term.
template <typename S, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
    bn_bwd_apply_kernel(const S* __restrict__ x, const S* __restrict__ g,
                     const S* __restrict__ o, const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ scale,
                     const float* __restrict__ dbeta,
                     const float* __restrict__ dgamma,
                     const float* __restrict__ g_mean,
                     const float* __restrict__ g_var, S* __restrict__ dx,
                     S* __restrict__ dres, const Plan p) {
  constexpr int U = 2;
  const int tx = threadIdx.x % p.tcv, ty = threadIdx.x / p.tcv;
  const int64_t ch0 = ((int64_t)blockIdx.x * p.tcv + tx) * V;
  if (ch0 >= p.c) return;
  const bool ct = g_mean != nullptr || g_var != nullptr;
  const float fm = (float)p.m;
  float mu[V], rs[V], kk[V], dbm[V], dgm[V], gmv[V], gvv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mu[k] = mean[ch0 + k];
    rs[k] = rstd[ch0 + k];
    kk[k] = __fmul_rn(scale[ch0 + k], rs[k]);
    dbm[k] = __fdiv_rn(dbeta[ch0 + k], fm);
    dgm[k] = __fdiv_rn(dgamma[ch0 + k], fm);
    gmv[k] = g_mean != nullptr ? g_mean[ch0 + k] : 0.f;
    gvv[k] = g_var != nullptr ? g_var[ch0 + k] : 0.f;
  }
  const int64_t r0 = (int64_t)blockIdx.y * p.rows;
  const int64_t r1 = r0 + p.rows < p.m ? r0 + p.rows : p.m;
  for (int64_t r = r0 + ty; r < r1; r += (int64_t)p.lanes * U) {
    Pack<S, V> xv[U], gv[U], ov[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t rr = r + (int64_t)j * p.lanes;
      if (rr < r1) {
        xv[j] = load_pack<S, V>(x + rr * p.c + ch0);
        gv[j] = load_pack<S, V>(g + rr * p.c + ch0);
        if (kRelu) ov[j] = load_pack<S, V>(o + rr * p.c + ch0);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t rr = r + (int64_t)j * p.lanes;
      if (rr >= r1) continue;
      Pack<S, V> dxv, drv;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float gm, xhat;
        bwd_terms<S, V, kRelu>(xv[j], gv[j], ov[j], k, mu[k], rs[k], gm,
                               xhat);
        float d = __fmul_rn(
            kk[k], __fsub_rn(__fsub_rn(gm, dbm[k]), __fmul_rn(xhat, dgm[k])));
        if (ct) {
          const float x2 =
              __fmul_rn(2.f, __fsub_rn(to_f32(xv[j].v[k]), mu[k]));
          d = __fadd_rn(
              d, __fdiv_rn(__fadd_rn(gmv[k], __fmul_rn(x2, gvv[k])), fm));
        }
        from_f32(dxv.v[k], d);
        from_f32(drv.v[k], gm);
      }
      *reinterpret_cast<Pack<S, V>*>(dx + rr * p.c + ch0) = dxv;
      if (dres != nullptr)
        *reinterpret_cast<Pack<S, V>*>(dres + rr * p.c + ch0) = drv;
    }
  }
}

// y = (x - mean) * (rstd * scale) + bias (+ residual) (relu), f32 math,
// output in x's dtype.  Every block is (32 channels) x (8 row lanes): a
// warp reads 32 neighbouring channels of one row.
template <typename T, bool kRes, bool kRelu>
__global__ void apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             T* __restrict__ out, int64_t m, int64_t c,
                             int64_t rows_per_chunk) {
  using S = typename Storage<T>::type;
  const S* xs = reinterpret_cast<const S*>(x);
  const S* rsd = reinterpret_cast<const S*>(res);
  S* os = reinterpret_cast<S*>(out);
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
    float y = __fadd_rn(__fmul_rn(__fsub_rn(to_f32(xs[i]), mu), s), b);
    if (kRes) y = __fadd_rn(y, to_f32(rsd[i]));
    if (kRelu) y = y < 0.f ? 0.f : y;
    from_f32(os[i], y);
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

// The plan the wrapper computed, checked: a block of at most kThreads
// threads and kMaxTileVec vectors, the tiles covering C and the chunks M.
bool plan_ok(const Plan& p, int vec, int n_ctiles) {
  return p.m > 0 && p.c > 0 && vec > 0 && p.c % vec == 0 && p.tcv > 0 &&
         p.tcv <= kMaxTileVec && p.lanes > 0 &&
         p.tcv * p.lanes <= kThreads && p.lanes >= vec &&
         (int64_t)n_ctiles * p.tcv * vec >= p.c &&
         (int64_t)(n_ctiles - 1) * p.tcv * vec < p.c && p.rows > 0 &&
         p.n_chunks > 0 && (int64_t)p.n_chunks * p.rows >= p.m &&
         (int64_t)(p.n_chunks - 1) * p.rows < p.m && p.n_chunks < 65536;
}

template <class Op>
cudaError_t launch_reduce(const Op& op, const Plan& p, int n_ctiles,
                          float* part, unsigned* tickets,
                          cudaStream_t stream) {
  bn_reduce_kernel<Op><<<dim3((unsigned)n_ctiles, (unsigned)p.n_chunks),
                      p.tcv * p.lanes, 0, stream>>>(op, p, part, tickets);
  return cudaGetLastError();
}

template <typename S, int V>
cudaError_t stats(const void* x, const Plan& p, int n_ctiles, float* part,
                  unsigned* tickets, float eps, float* mean, float* var,
                  float* rstd, cudaStream_t stream) {
  StatsOp<S, V> op;
  op.x = static_cast<const S*>(x);
  op.mean = mean;
  op.var = var;
  op.rstd = rstd;
  op.m = p.m;
  op.eps = eps;
  return launch_reduce(op, p, n_ctiles, part, tickets, stream);
}

template <typename S, int V, bool kRelu>
cudaError_t backward(const void* x, const void* g, const void* o,
                     const Plan& p, int n_ctiles, const float* mean,
                     const float* rstd, const float* scale,
                     const float* g_mean, const float* g_var, float* part,
                     unsigned* tickets, float* dbeta, float* dgamma, void* dx,
                     void* dres, cudaStream_t stream) {
  BwdSumOp<S, V, kRelu> op;
  op.x = static_cast<const S*>(x);
  op.g = static_cast<const S*>(g);
  op.o = static_cast<const S*>(o);
  op.mean = mean;
  op.rstd = rstd;
  op.dbeta = dbeta;
  op.dgamma = dgamma;
  cudaError_t err = launch_reduce(op, p, n_ctiles, part, tickets, stream);
  if (err != cudaSuccess) return err;
  bn_bwd_apply_kernel<S, V, kRelu>
      <<<dim3((unsigned)n_ctiles, (unsigned)p.n_chunks), p.tcv * p.lanes, 0,
         stream>>>(op.x, op.g, op.o, mean, rstd, scale, dbeta, dgamma, g_mean,
                   g_var, static_cast<S*>(dx), static_cast<S*>(dres), p);
  return cudaGetLastError();
}

template <typename S, int V>
cudaError_t backward_relu(int relu, const void* x, const void* g,
                          const void* o, const Plan& p, int n_ctiles,
                          const float* mean, const float* rstd,
                          const float* scale, const float* g_mean,
                          const float* g_var, float* part, unsigned* tickets,
                          float* dbeta, float* dgamma, void* dx, void* dres,
                          cudaStream_t stream) {
  if (relu)
    return backward<S, V, true>(x, g, o, p, n_ctiles, mean, rstd, scale,
                                g_mean, g_var, part, tickets, dbeta, dgamma,
                                dx, dres, stream);
  return backward<S, V, false>(x, g, o, p, n_ctiles, mean, rstd, scale,
                               g_mean, g_var, part, tickets, dbeta, dgamma,
                               dx, dres, stream);
}

}  // namespace

extern "C" {

// dtype codes shared with the Python wrapper: 0 = float32, 1 = bfloat16,
// 2 = float16.  vec (elements a load) is 16 bytes' worth (4 f32, 8 bf16
// or f16) or 1.
// The plan (vec, tcv, lanes, n_ctiles, rows, n_chunks) is the wrapper's
// _plan; part is (4, n_chunks, C) f32 scratch, tickets n_ctiles counters
// that are zero between launches (each launch leaves them at zero).

// Statistics in one launch; mean / var / rstd are (C,) f32 outputs.
int cmn_bn_stats(const void* x, int dtype, int64_t m, int64_t c, int vec,
                 int tcv, int lanes, int n_ctiles, int64_t rows, int n_chunks,
                 float* part, unsigned* tickets, float eps, float* mean,
                 float* var, float* rstd, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan p{m, c, rows, tcv, lanes, n_chunks};
  if (!plan_ok(p, vec, n_ctiles)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    return (int)stats<float, 4>(x, p, n_ctiles, part, tickets, eps, mean, var,
                                rstd, stream);
  if (dtype == 0 && vec == 1)
    return (int)stats<float, 1>(x, p, n_ctiles, part, tickets, eps, mean, var,
                                rstd, stream);
  if (dtype == 1 && vec == 8)
    return (int)stats<unsigned short, 8>(x, p, n_ctiles, part, tickets, eps,
                                         mean, var, rstd, stream);
  if (dtype == 1 && vec == 1)
    return (int)stats<unsigned short, 1>(x, p, n_ctiles, part, tickets, eps,
                                         mean, var, rstd, stream);
  if (dtype == 2 && vec == 8)
    return (int)stats<__half, 8>(x, p, n_ctiles, part, tickets, eps, mean,
                                 var, rstd, stream);
  if (dtype == 2 && vec == 1)
    return (int)stats<__half, 1>(x, p, n_ctiles, part, tickets, eps, mean,
                                 var, rstd, stream);
  return (int)cudaErrorInvalidValue;
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
  if (dtype == 2)
    return (int)launch_apply<__half>(x, res, mean, rstd, scale, bias, out, m,
                                     c, rows_per_chunk, relu, stream);
  return (int)cudaErrorInvalidValue;
}

// The backward in two launches: the sums dbeta / dgamma ((C,) f32
// outputs), then dx and, when dres is not null, the residual's gradient.
// x, g, out, dx and dres share dtype and (M, C); out is read only under
// the relu; g_mean / g_var may be null.
int cmn_bn_backward(const void* x, const void* g, const void* out, int dtype,
                    int64_t m, int64_t c, int vec, int tcv, int lanes,
                    int n_ctiles, int64_t rows, int n_chunks,
                    const float* mean, const float* rstd, const float* scale,
                    const float* g_mean, const float* g_var, int relu,
                    float* part, unsigned* tickets, float* dbeta,
                    float* dgamma, void* dx, void* dres, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan p{m, c, rows, tcv, lanes, n_chunks};
  if (!plan_ok(p, vec, n_ctiles) || (relu && out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    return (int)backward_relu<float, 4>(relu, x, g, out, p, n_ctiles, mean,
                                        rstd, scale, g_mean, g_var, part,
                                        tickets, dbeta, dgamma, dx, dres,
                                        stream);
  if (dtype == 0 && vec == 1)
    return (int)backward_relu<float, 1>(relu, x, g, out, p, n_ctiles, mean,
                                        rstd, scale, g_mean, g_var, part,
                                        tickets, dbeta, dgamma, dx, dres,
                                        stream);
  if (dtype == 1 && vec == 8)
    return (int)backward_relu<unsigned short, 8>(
        relu, x, g, out, p, n_ctiles, mean, rstd, scale, g_mean, g_var, part,
        tickets, dbeta, dgamma, dx, dres, stream);
  if (dtype == 1 && vec == 1)
    return (int)backward_relu<unsigned short, 1>(
        relu, x, g, out, p, n_ctiles, mean, rstd, scale, g_mean, g_var, part,
        tickets, dbeta, dgamma, dx, dres, stream);
  if (dtype == 2 && vec == 8)
    return (int)backward_relu<__half, 8>(relu, x, g, out, p, n_ctiles, mean,
                                         rstd, scale, g_mean, g_var, part,
                                         tickets, dbeta, dgamma, dx, dres,
                                         stream);
  if (dtype == 2 && vec == 1)
    return (int)backward_relu<__half, 1>(relu, x, g, out, p, n_ctiles, mean,
                                         rstd, scale, g_mean, g_var, part,
                                         tickets, dbeta, dgamma, dx, dres,
                                         stream);
  return (int)cudaErrorInvalidValue;
}

const char* cmn_bn_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
