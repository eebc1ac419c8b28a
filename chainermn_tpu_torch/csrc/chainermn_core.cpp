// Native host core of chainermn_tpu_torch: the port's copy of the JAX
// package's csrc/chainermn_core.cpp, the same C ABI and the same
// arithmetic, built by ops/_build.py (g++ -O3 -std=c++17, no fast-math)
// into build/chainermn_tpu_torch/ and bound with ctypes by native/core.py.
//
//   - buffer/arena management  (reference: _memory_utility.py
//     DeviceMemory/HostPinnedMemory -- grow-only assign, fused
//     pack/unpack of many tensors into one contiguous buffer)
//   - data-loader hot path     (reference: Chainer MultiprocessIterator
//     worker processes doing crop/flip/mean-subtract in Python;
//     here a C++ thread pool over contiguous sample memory)
//   - host collective engine   (reference: chainermn/nccl/nccl.pyx --
//     allreduce/reduce/bcast/reduce_scatter/allgather with comm-id
//     handshake and an error taxonomy; here over POSIX shared memory
//     for same-host processes.  On-device collectives belong to NCCL;
//     this engine serves the eager/object path, e.g. metric
//     aggregation, mirroring the reference's mpi4py usage.)

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <new>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

#define CMN_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// Error taxonomy (parity: nccl.pyx:60-76 status table)
// ---------------------------------------------------------------------------

enum CmnStatus {
  CMN_OK = 0,
  CMN_UNHANDLED_ERROR = 1,
  CMN_SYSTEM_ERROR = 2,
  CMN_INTERNAL_ERROR = 3,
  CMN_INVALID_ARGUMENT = 4,
  CMN_INVALID_USAGE = 5,
  CMN_BUFFER_OVERFLOW = 6,
  CMN_TIMEOUT = 7,
  CMN_RANK_MISMATCH = 8,
};

static const char* kStatusStrings[] = {
    "success",          "unhandled error",  "system error",
    "internal error",   "invalid argument", "invalid usage",
    "buffer overflow",  "timeout",          "rank mismatch",
};

CMN_API const char* cmn_error_string(int status) {
  if (status < 0 || status > CMN_RANK_MISMATCH) return "unknown error";
  return kStatusStrings[status];
}

// ---------------------------------------------------------------------------
// Arena: grow-only aligned buffer (parity: DeviceMemory.assign,
// _memory_utility.py:43-74)
// ---------------------------------------------------------------------------

struct CmnArena {
  void* ptr = nullptr;
  size_t capacity = 0;
};

CMN_API void* cmn_arena_create() { return new (std::nothrow) CmnArena(); }

CMN_API int cmn_arena_assign(void* handle, size_t nbytes) {
  auto* a = static_cast<CmnArena*>(handle);
  if (!a) return CMN_INVALID_ARGUMENT;
  if (nbytes <= a->capacity) return CMN_OK;
  void* p = nullptr;
  if (posix_memalign(&p, 64, nbytes) != 0) return CMN_SYSTEM_ERROR;
  free(a->ptr);
  a->ptr = p;
  a->capacity = nbytes;
  return CMN_OK;
}

CMN_API void* cmn_arena_ptr(void* handle) {
  auto* a = static_cast<CmnArena*>(handle);
  return a ? a->ptr : nullptr;
}

CMN_API size_t cmn_arena_capacity(void* handle) {
  auto* a = static_cast<CmnArena*>(handle);
  return a ? a->capacity : 0;
}

CMN_API void cmn_arena_destroy(void* handle) {
  auto* a = static_cast<CmnArena*>(handle);
  if (a) {
    free(a->ptr);
    delete a;
  }
}

// Fused pack/unpack (parity: pack_params/unpack_params,
// _memory_utility.py:77-92): gather n segments into dst / scatter back.
// Parallel memcpy for large totals.

static size_t pool_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  size_t n_threads = hw ? hw : 4;
  return n_threads > 16 ? 16 : n_threads;
}

// the most threads parallel_for starts (fewer for small n)
CMN_API int cmn_pool_threads() { return static_cast<int>(pool_threads()); }

static void parallel_for(size_t n, size_t grain,
                         const std::function<void(size_t, size_t)>& fn) {
  size_t n_threads = pool_threads();
  if (n < grain * 2 || n_threads <= 1) {
    fn(0, n);
    return;
  }
  if (n_threads > n / grain) n_threads = n / grain;
  std::vector<std::thread> threads;
  size_t chunk = (n + n_threads - 1) / n_threads;
  for (size_t t = 0; t < n_threads; ++t) {
    size_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

CMN_API int cmn_pack(void* dst, void** srcs, const size_t* nbytes, int n) {
  if (!dst || !srcs || !nbytes || n < 0) return CMN_INVALID_ARGUMENT;
  std::vector<size_t> offsets(static_cast<size_t>(n) + 1, 0);
  for (int i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + nbytes[i];
  parallel_for(static_cast<size_t>(n), 1, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i)
      memcpy(static_cast<char*>(dst) + offsets[i], srcs[i], nbytes[i]);
  });
  return CMN_OK;
}

CMN_API int cmn_unpack(void* src, void** dsts, const size_t* nbytes, int n) {
  if (!src || !dsts || !nbytes || n < 0) return CMN_INVALID_ARGUMENT;
  std::vector<size_t> offsets(static_cast<size_t>(n) + 1, 0);
  for (int i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + nbytes[i];
  parallel_for(static_cast<size_t>(n), 1, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i)
      memcpy(dsts[i], static_cast<char*>(src) + offsets[i], nbytes[i]);
  });
  return CMN_OK;
}

// ---------------------------------------------------------------------------
// Image augmentation pipeline (the data-loader hot path).
//
// Batched crop + horizontal flip + mean-subtract + scale from a
// contiguous (N, H, W, C) float32 sample store into a packed
// (B, crop, crop, C) float32 batch, parallel over batch items.
// Mean is a full (H, W, C) image; the window subtracted tracks the
// crop window (reference train_imagenet.py:79-80).
// ---------------------------------------------------------------------------

CMN_API int cmn_augment_batch(
    const float* samples, int64_t h, int64_t w, int64_t c,
    const int64_t* sample_indices,  // B source sample ids
    const int32_t* tops, const int32_t* lefts, const uint8_t* flips,
    int64_t b, int64_t crop, const float* mean /* nullable, HWC */,
    float scale, float* out /* B*crop*crop*C */) {
  if (!samples || !sample_indices || !tops || !lefts || !flips || !out)
    return CMN_INVALID_ARGUMENT;
  if (crop > h || crop > w) return CMN_INVALID_ARGUMENT;
  const int64_t sample_stride = h * w * c;
  const int64_t out_stride = crop * crop * c;
  std::atomic<int> status{CMN_OK};
  parallel_for(static_cast<size_t>(b), 1, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      const int64_t top = tops[i], left = lefts[i];
      if (top < 0 || left < 0 || top + crop > h || left + crop > w) {
        status.store(CMN_INVALID_ARGUMENT);
        continue;
      }
      const float* src = samples + sample_indices[i] * sample_stride;
      float* dst = out + i * out_stride;
      const bool flip = flips[i] != 0;
      for (int64_t y = 0; y < crop; ++y) {
        const float* srow = src + ((top + y) * w + left) * c;
        const float* mrow =
            mean ? mean + ((top + y) * w + left) * c : nullptr;
        float* drow = dst + y * crop * c;
        if (!flip) {
          if (mrow) {
            for (int64_t xc = 0; xc < crop * c; ++xc)
              drow[xc] = (srow[xc] - mrow[xc]) * scale;
          } else {
            for (int64_t xc = 0; xc < crop * c; ++xc)
              drow[xc] = srow[xc] * scale;
          }
        } else {
          // horizontal flip: output col x reads source col crop-1-x
          // (mean window is subtracted pre-flip, matching
          // "subtract then flip" semantics)
          for (int64_t x = 0; x < crop; ++x) {
            const float* spix = srow + (crop - 1 - x) * c;
            const float* mpix = mrow ? mrow + (crop - 1 - x) * c : nullptr;
            float* dpix = drow + x * c;
            for (int64_t ch = 0; ch < c; ++ch)
              dpix[ch] = ((spix[ch] - (mpix ? mpix[ch] : 0.f)) * scale);
          }
        }
      }
    }
  });
  return status.load();
}

// ---------------------------------------------------------------------------
// Host collective engine over POSIX shared memory.
//
// Parity surface with the reference NCCL binding (nccl.pyx):
//   comm-id handshake  -> shm segment name generated by rank 0
//                         (ncclGetUniqueId, nccl.pyx:107-115)
//   comm init          -> cmn_comm_init(name, n_ranks, rank)
//                         (ncclCommInitRank, nccl.pyx:122-133)
//   allreduce/reduce/bcast/reduce_scatter/allgather
//                         (nccl.pyx:140-199)
// Synchronization: per-collective sequence number + sense-reversing
// double barrier on atomics (processes on one host; fail-stop with
// timeout -> CMN_TIMEOUT, a failure-detection behavior the reference
// lacks entirely).
// ---------------------------------------------------------------------------

static const int kMaxRanks = 64;

struct ShmHeader {
  std::atomic<int32_t> arrived[2];   // double-buffered barrier counters
  std::atomic<int32_t> generation;   // barrier phase
  std::atomic<int32_t> attached;     // rank attach count
  std::atomic<int64_t> slot_bytes;
  std::atomic<int32_t> n_ranks;      // published LAST by rank 0
};

struct CmnComm {
  ShmHeader* hdr = nullptr;
  char* slots = nullptr;  // n_ranks * slot_bytes payload area
  int rank = -1;
  int n_ranks = 0;
  int64_t slot_bytes = 0;
  size_t map_bytes = 0;
  std::string name;
  int barrier_count = 0;
  double timeout_s = 60.0;
};

static int comm_barrier(CmnComm* comm) {
  // sense-reversing barrier; index alternates so a fast rank cannot
  // lap a slow one within a single collective
  ShmHeader* h = comm->hdr;
  const int idx = comm->barrier_count & 1;
  comm->barrier_count++;
  const int32_t gen = h->generation.load(std::memory_order_acquire);
  const int32_t pos = h->arrived[idx].fetch_add(1) + 1;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(comm->timeout_s);
  if (pos == comm->n_ranks) {
    h->arrived[idx].store(0, std::memory_order_relaxed);
    h->generation.store(gen + 1, std::memory_order_release);
    return CMN_OK;
  }
  while (h->generation.load(std::memory_order_acquire) == gen) {
    if (std::chrono::steady_clock::now() > deadline) return CMN_TIMEOUT;
    std::this_thread::yield();
  }
  return CMN_OK;
}

CMN_API void* cmn_comm_create(const char* name, int n_ranks, int rank,
                              int64_t slot_bytes, double timeout_s) {
  if (!name || n_ranks < 1 || n_ranks > kMaxRanks || rank < 0 ||
      rank >= n_ranks || slot_bytes < 8)
    return nullptr;
  const size_t total = sizeof(ShmHeader) +
                       static_cast<size_t>(n_ranks) * slot_bytes;
  int fd = shm_open(name, O_CREAT | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* comm = new (std::nothrow) CmnComm();
  if (!comm) {
    munmap(mem, total);
    return nullptr;
  }
  comm->hdr = static_cast<ShmHeader*>(mem);
  comm->slots = static_cast<char*>(mem) + sizeof(ShmHeader);
  comm->rank = rank;
  comm->n_ranks = n_ranks;
  comm->slot_bytes = slot_bytes;
  comm->map_bytes = total;
  comm->name = name;
  comm->timeout_s = timeout_s > 0 ? timeout_s : 60.0;
  if (rank == 0) {
    comm->hdr->arrived[0].store(0);
    comm->hdr->arrived[1].store(0);
    comm->hdr->generation.store(0);
    comm->hdr->attached.store(0);
    comm->hdr->slot_bytes.store(slot_bytes);
    comm->hdr->n_ranks.store(n_ranks, std::memory_order_release);
  }
  // attach handshake: everyone waits until all ranks have mapped
  // (rank 0 initialized the header first; non-zero ranks spin on it)
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(comm->timeout_s);
  while (comm->hdr->n_ranks.load(std::memory_order_acquire) != n_ranks ||
         comm->hdr->slot_bytes.load() != slot_bytes) {
    if (std::chrono::steady_clock::now() > deadline) {
      munmap(mem, total);
      delete comm;
      return nullptr;
    }
    std::this_thread::yield();
  }
  comm->hdr->attached.fetch_add(1);
  while (comm->hdr->attached.load() < n_ranks) {
    if (std::chrono::steady_clock::now() > deadline) {
      munmap(mem, total);
      delete comm;
      return nullptr;
    }
    std::this_thread::yield();
  }
  return comm;
}

CMN_API void cmn_comm_destroy(void* handle, int unlink_shm) {
  auto* comm = static_cast<CmnComm*>(handle);
  if (!comm) return;
  if (comm->hdr) munmap(comm->hdr, comm->map_bytes);
  if (unlink_shm) shm_unlink(comm->name.c_str());
  delete comm;
}

CMN_API int cmn_comm_rank(void* handle) {
  auto* c = static_cast<CmnComm*>(handle);
  return c ? c->rank : -1;
}

CMN_API int cmn_comm_size(void* handle) {
  auto* c = static_cast<CmnComm*>(handle);
  return c ? c->n_ranks : 0;
}

enum CmnOp { CMN_SUM = 0, CMN_PROD = 1, CMN_MAX = 2, CMN_MIN = 3 };
// CMN_BF16/CMN_F16 mirror the reference's NCCL_HALF surface
// (nccl.pyx:87); bf16 is the TPU-native dtype.
enum CmnDtype { CMN_F32 = 0, CMN_F64 = 1, CMN_I32 = 2, CMN_I64 = 3,
                CMN_BF16 = 4, CMN_F16 = 5 };

static size_t dtype_size(int dtype) {
  switch (dtype) {
    case CMN_F32: return 4;
    case CMN_F64: return 8;
    case CMN_I32: return 4;
    case CMN_I64: return 8;
    case CMN_BF16: return 2;
    case CMN_F16: return 2;
    default: return 0;
  }
}

// ---- 16-bit float conversions (scalar; host reduction payloads are
// small).  bf16 uses round-to-nearest-even truncation; f16 is IEEE
// binary16 with subnormal handling.
static inline float bf16_to_f32(uint16_t v) {
  uint32_t b = static_cast<uint32_t>(v) << 16;
  float f;
  memcpy(&f, &b, 4);
  return f;
}

static inline uint16_t f32_to_bf16(float f) {
  uint32_t b;
  memcpy(&b, &f, 4);
  if ((b & 0x7f800000u) == 0x7f800000u) {
    // inf stays inf; NaN keeps a quiet bit even when the payload
    // lives only in the truncated low 16 bits (else NaN -> inf)
    uint16_t hi = static_cast<uint16_t>(b >> 16);
    if ((b & 0x007fffffu) != 0) hi |= 0x0040u;
    return hi;
  }
  uint32_t rounding = 0x7fffu + ((b >> 16) & 1u);
  return static_cast<uint16_t>((b + rounding) >> 16);
}

static inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1fu;
  uint32_t mant = h & 0x3ffu;
  uint32_t f;
  if (exp == 0) {
    if (mant == 0) {
      f = sign;
    } else {  // subnormal: renormalize
      exp = 127 - 15 + 1;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        --exp;
      }
      mant &= 0x3ffu;
      f = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    f = sign | 0x7f800000u | (mant << 13);
  } else {
    f = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  memcpy(&out, &f, 4);
  return out;
}

static inline uint16_t f32_to_f16(float x) {
  uint32_t b;
  memcpy(&b, &x, 4);
  uint32_t sign = (b >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((b >> 23) & 0xffu) - 127 + 15;
  uint32_t mant = b & 0x7fffffu;
  if (((b >> 23) & 0xffu) == 0xffu)  // inf/nan
    return static_cast<uint16_t>(sign | 0x7c00u | (mant ? 0x200u : 0));
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7c00u);  // overflow
  if (exp <= 0) {  // subnormal or underflow
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1)))
      ++half;  // round to nearest even
    return static_cast<uint16_t>(sign | half);
  }
  uint32_t half = sign | (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) ++half;
  return static_cast<uint16_t>(half);
}

struct Bf16Cvt {
  static float to(uint16_t v) { return bf16_to_f32(v); }
  static uint16_t from(float f) { return f32_to_bf16(f); }
};
struct F16Cvt {
  static float to(uint16_t v) { return f16_to_f32(v); }
  static uint16_t from(float f) { return f32_to_f16(f); }
};

template <typename Cvt>
static void reduce_typed_16(uint16_t* acc, const uint16_t* src, int64_t n,
                            int op) {
  for (int64_t i = 0; i < n; ++i) {
    float a = Cvt::to(acc[i]);
    float s = Cvt::to(src[i]);
    float r;
    switch (op) {
      case CMN_SUM: r = a + s; break;
      case CMN_PROD: r = a * s; break;
      case CMN_MAX: r = a > s ? a : s; break;
      case CMN_MIN: r = a < s ? a : s; break;
      default: r = a; break;
    }
    acc[i] = Cvt::from(r);
  }
}

template <typename T>
static void reduce_typed(T* acc, const T* src, int64_t n, int op) {
  switch (op) {
    case CMN_SUM:
      for (int64_t i = 0; i < n; ++i) acc[i] += src[i];
      break;
    case CMN_PROD:
      for (int64_t i = 0; i < n; ++i) acc[i] *= src[i];
      break;
    case CMN_MAX:
      for (int64_t i = 0; i < n; ++i)
        acc[i] = acc[i] > src[i] ? acc[i] : src[i];
      break;
    case CMN_MIN:
      for (int64_t i = 0; i < n; ++i)
        acc[i] = acc[i] < src[i] ? acc[i] : src[i];
      break;
  }
}

static void reduce_dispatch(void* acc, const void* src, int64_t count,
                            int dtype, int op) {
  switch (dtype) {
    case CMN_F32:
      reduce_typed(static_cast<float*>(acc),
                   static_cast<const float*>(src), count, op);
      break;
    case CMN_F64:
      reduce_typed(static_cast<double*>(acc),
                   static_cast<const double*>(src), count, op);
      break;
    case CMN_I32:
      reduce_typed(static_cast<int32_t*>(acc),
                   static_cast<const int32_t*>(src), count, op);
      break;
    case CMN_I64:
      reduce_typed(static_cast<int64_t*>(acc),
                   static_cast<const int64_t*>(src), count, op);
      break;
    case CMN_BF16:
      reduce_typed_16<Bf16Cvt>(static_cast<uint16_t*>(acc),
                               static_cast<const uint16_t*>(src), count,
                               op);
      break;
    case CMN_F16:
      reduce_typed_16<F16Cvt>(static_cast<uint16_t*>(acc),
                              static_cast<const uint16_t*>(src), count,
                              op);
      break;
  }
}

// allreduce: all ranks contribute `count` elements; every rank receives
// the elementwise reduction.  (nccl.pyx allreduce)
CMN_API int cmn_allreduce(void* handle, const void* sendbuf, void* recvbuf,
                          int64_t count, int dtype, int op) {
  auto* comm = static_cast<CmnComm*>(handle);
  if (!comm || !sendbuf || !recvbuf) return CMN_INVALID_ARGUMENT;
  const size_t esz = dtype_size(dtype);
  if (!esz) return CMN_INVALID_ARGUMENT;
  const size_t nbytes = count * esz;
  if (static_cast<int64_t>(nbytes) > comm->slot_bytes)
    return CMN_BUFFER_OVERFLOW;
  memcpy(comm->slots + comm->rank * comm->slot_bytes, sendbuf, nbytes);
  int st = comm_barrier(comm);  // all contributions visible
  if (st != CMN_OK) return st;
  // every rank reduces locally (small host payloads; contention-free)
  memcpy(recvbuf, comm->slots, nbytes);
  for (int r = 1; r < comm->n_ranks; ++r)
    reduce_dispatch(recvbuf, comm->slots + r * comm->slot_bytes, count,
                    dtype, op);
  return comm_barrier(comm);  // slots free for reuse
}

// reduce to root (nccl.pyx reduce)
CMN_API int cmn_reduce(void* handle, const void* sendbuf, void* recvbuf,
                       int64_t count, int dtype, int op, int root) {
  auto* comm = static_cast<CmnComm*>(handle);
  if (!comm || !sendbuf) return CMN_INVALID_ARGUMENT;
  if (root < 0 || root >= comm->n_ranks) return CMN_INVALID_ARGUMENT;
  if (comm->rank == root && !recvbuf) return CMN_INVALID_ARGUMENT;
  const size_t esz = dtype_size(dtype);
  if (!esz) return CMN_INVALID_ARGUMENT;
  const size_t nbytes = count * esz;
  if (static_cast<int64_t>(nbytes) > comm->slot_bytes)
    return CMN_BUFFER_OVERFLOW;
  memcpy(comm->slots + comm->rank * comm->slot_bytes, sendbuf, nbytes);
  int st = comm_barrier(comm);
  if (st != CMN_OK) return st;
  if (comm->rank == root) {
    memcpy(recvbuf, comm->slots, nbytes);
    for (int r = 1; r < comm->n_ranks; ++r)
      reduce_dispatch(recvbuf, comm->slots + r * comm->slot_bytes, count,
                      dtype, op);
  }
  return comm_barrier(comm);
}

// bcast from root in-place (nccl.pyx bcast)
CMN_API int cmn_bcast(void* handle, void* buf, int64_t count, int dtype,
                      int root) {
  auto* comm = static_cast<CmnComm*>(handle);
  if (!comm || !buf) return CMN_INVALID_ARGUMENT;
  if (root < 0 || root >= comm->n_ranks) return CMN_INVALID_ARGUMENT;
  const size_t esz = dtype_size(dtype);
  if (!esz) return CMN_INVALID_ARGUMENT;
  const size_t nbytes = count * esz;
  if (static_cast<int64_t>(nbytes) > comm->slot_bytes)
    return CMN_BUFFER_OVERFLOW;
  if (comm->rank == root)
    memcpy(comm->slots + root * comm->slot_bytes, buf, nbytes);
  int st = comm_barrier(comm);
  if (st != CMN_OK) return st;
  if (comm->rank != root)
    memcpy(buf, comm->slots + root * comm->slot_bytes, nbytes);
  return comm_barrier(comm);
}

// reduce_scatter: rank r receives the reduction of everyone's r-th
// `recvcount` chunk (nccl.pyx reduce_scatter)
CMN_API int cmn_reduce_scatter(void* handle, const void* sendbuf,
                               void* recvbuf, int64_t recvcount, int dtype,
                               int op) {
  auto* comm = static_cast<CmnComm*>(handle);
  if (!comm || !sendbuf || !recvbuf) return CMN_INVALID_ARGUMENT;
  const size_t esz = dtype_size(dtype);
  if (!esz) return CMN_INVALID_ARGUMENT;
  const size_t total_bytes = recvcount * esz * comm->n_ranks;
  if (static_cast<int64_t>(total_bytes) > comm->slot_bytes)
    return CMN_BUFFER_OVERFLOW;
  memcpy(comm->slots + comm->rank * comm->slot_bytes, sendbuf, total_bytes);
  int st = comm_barrier(comm);
  if (st != CMN_OK) return st;
  const size_t chunk = recvcount * esz;
  memcpy(recvbuf, comm->slots + comm->rank * chunk, chunk);
  for (int r = 1; r < comm->n_ranks; ++r)
    reduce_dispatch(recvbuf,
                    comm->slots + r * comm->slot_bytes +
                        comm->rank * chunk,
                    recvcount, dtype, op);
  return comm_barrier(comm);
}

// allgather: concatenation of every rank's `sendcount` elements
// (nccl.pyx allgather)
CMN_API int cmn_allgather(void* handle, const void* sendbuf, void* recvbuf,
                          int64_t sendcount, int dtype) {
  auto* comm = static_cast<CmnComm*>(handle);
  if (!comm || !sendbuf || !recvbuf) return CMN_INVALID_ARGUMENT;
  const size_t esz = dtype_size(dtype);
  if (!esz) return CMN_INVALID_ARGUMENT;
  const size_t nbytes = sendcount * esz;
  if (static_cast<int64_t>(nbytes) > comm->slot_bytes)
    return CMN_BUFFER_OVERFLOW;
  memcpy(comm->slots + comm->rank * comm->slot_bytes, sendbuf, nbytes);
  int st = comm_barrier(comm);
  if (st != CMN_OK) return st;
  for (int r = 0; r < comm->n_ranks; ++r)
    memcpy(static_cast<char*>(recvbuf) + r * nbytes,
           comm->slots + r * comm->slot_bytes, nbytes);
  return comm_barrier(comm);
}

// barrier as a standalone primitive
CMN_API int cmn_barrier(void* handle) {
  auto* comm = static_cast<CmnComm*>(handle);
  if (!comm) return CMN_INVALID_ARGUMENT;
  return comm_barrier(comm);
}
