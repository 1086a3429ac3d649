// Batched block-sparse semiring SpMV for Hopper (sm_90a): one frontier
// step of Quegel's superstep-sharing round,
//
//     y[q, v] = add_{u -> v} mul(x[q, u], w(u, v)),
//
// over the packed block-sparse layout of core/graph.py::PackedBlocks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frontier.py
// (propagate_blocks, with _kernel and _combine_tile).  The TPU kernel reads
// dense (B, B) tiles because its vector units and matrix unit want them.
// Here a tile holds 1.5 to 3.7 edges on average (barabasi_albert, m=3,
// B=128), so the layout keeps the TPU kernel's slots (src_ids, nslots, the
// per-lane mask) but stores only the entries of each tile that differ from
// the add-identity, and this kernel reads only those.  In place of the TPU
// kernel's per-(dst block, slot) activity bitmap it looks up a per-source-
// block live table, which block_live_kernel builds from the mask in one
// pass:
//
//   * work is cut into items: a run of at most CHUNK consecutive entries of
//     one destination block's row, as (row, first, end) (the wrapper
//     builds the list once per table).  A row of a hub block holds 15x to 45x the average, so one
//     CUDA block per row would leave the launch waiting on that block;
//     items of one size balance the work;
//   * one CUDA block of THREADS threads owns an (item, QT-lane Q-tile): a
//     (QT, B) accumulator in shared memory that starts at add_id.  Each
//     thread takes ILP entries of the item (a warp per slot would idle most
//     of its lanes at a few entries per slot) and issues their loads level
//     by level (entry; source block and slot flag; live byte, an L1 hit;
//     weight, x and mask of each lane), so a pass waits on four dependent
//     reads, not four per entry.  An entry packs its slot k, in-tile source
//     row r and column c;
//   * an entry whose source block is dead (live[src_ids[i, k]] == 0: no
//     lane holds an active vertex there) is skipped, weight and all.  The
//     live table is nb bytes and stays in L1.  A caller may instead pass a
//     per-slot bitmap active (nb, max_bpr) and the entry is tested by
//     active[i, k]; one of the two, or neither (every entry visited).
//     Entries never name a padding slot (k >= nslots[i]: the packer writes
//     none there), so no k < nslots[i] test is needed.  Otherwise the
//     thread reads x[q, src_ids[i, k] * B + r] and the weight, for each
//     lane (add_id where the lane's mask is off), forms mul(x, w), and
//     combines it into the
//     accumulator with a shared-memory atomic, unless it cannot change it
//     (m >= add_id under min, m <= add_id under max, m == 0 under sum: an
//     accumulator never passes add_id, so that skip is exact);
//   * one barrier, then each word that left add_id is combined into the
//     output, which the wrapper fills with add_id, by a global atomic
//     (several items may share a row).
//
// Atomics: int32 atomicMin/atomicMax/atomicAdd (wrapping) commute, so the
// integer semirings are bit-exact whatever the order.  float32 min/max go
// through an order-preserving integer key of the IEEE bits in shared
// memory, and through the sign-split integer atomics in global memory (a
// non-negative float orders as a signed int, a negative one inversely as
// an unsigned int).  float32 sum_times uses float atomicAdd, whose order
// varies from run to run (tolerance 1e-4).
//
// Which entries may be dropped: an absent entry holds add_id in the dense
// tile.  For int32 it contributes nothing under every semiring (*_right gate
// on t != add_id; min_plus saturates at t >= INF, max_plus at t <= -INF;
// x * 0 = 0), so the packed result is bit-identical to the dense one.  For
// float32 the same holds for *_right; for sum_times where x is finite
// (x * 0 is NaN for an infinite x); for min_plus where fl(x + 2^30) >= 2^30,
// i.e. x >= -32 (add_id is 2^30, not infinity, and no saturation applies),
// and for max_plus where x <= 32.
//
// Bound on this card: the kernel must read, per entry of a live slot, 4 B of
// packed position (and 4 B of weight where the semiring reads one), plus x,
// mask and y once, the source block of each slot that holds entries and
// the live byte of each source block (no entry names the padding of the
// (nb, max_bpr) grid, so it is never read).  At the main shape (Q=8,
// barabasi_albert(262144, 3), B=128, a BFS frontier two hops out) that is
// 23.8 MB, 7.1 us at 3.35 TB/s, four fifths of it x, mask and y.  At
// n=32768 it is 3.40 MB, 1.01 us, below a launch: there the kernel is bound
// by latency, the dependent reads of a pass and the fill of the
// output.  x is 1 to 8 MB, so the per-entry gathers hit the 50 MB L2.
// Tensor cores do not apply (no dense product at a few entries per tile),
// nor do TMA or cp.async staging.  Persistent blocks are left for later
// work.  The live table costs one read of the (Q, V) mask; the slot grid
// is never built or gathered on the gated path.
//
// Five semirings, as in the reference: min_right/max_right (label copy),
// min_plus/max_plus (int32 add that saturates at +-INF, frontier.py:44-50;
// plain add on float32) and sum_times (int32 wraps like XLA's dot; float32
// multiplies in full fp32, no TF32).  x and the weights share one dtype.
//
// C interface (loaded with ctypes): repro_propagate_packed and
// repro_block_live return the cudaError_t of the launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int QT = 8;          // query lanes per block (ragged Q is guarded)
constexpr int THREADS = 256;   // threads per block, striding over entries
constexpr int ILP = 4;         // entries per thread in flight
constexpr int CHUNK = THREADS * ILP;  // entries per work item: one pass
constexpr int LIVE_THREADS = 128;     // threads per source block in block_live
constexpr int32_t INF = 1 << 30;

enum Semiring { MIN_PLUS = 0, MIN_RIGHT = 1, MAX_RIGHT = 2, MAX_PLUS = 3, SUM_TIMES = 4 };

template <typename T>
constexpr bool is_int = std::is_integral_v<T>;

template <int SR>
constexpr bool is_min = SR == MIN_PLUS || SR == MIN_RIGHT;

template <int SR>
constexpr bool reads_weight = !(SR == MIN_RIGHT || SR == MAX_RIGHT);

// int32 arithmetic in unsigned form: wraps like XLA instead of being UB
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// mul(x, t) for one stored entry (t != add_id, so *_right copy x)
template <int SR, typename T>
__device__ __forceinline__ T mul(T x, T t, T add_id) {
  if constexpr (SR == MIN_RIGHT || SR == MAX_RIGHT) {
    return x;
  } else if constexpr (SR == MIN_PLUS) {
    if constexpr (is_int<T>) {
      return (x >= T(INF) || t >= T(INF)) ? add_id : wrap_add(x, t);
    } else {
      return x + t;
    }
  } else if constexpr (SR == MAX_PLUS) {
    if constexpr (is_int<T>) {
      return (x <= T(-INF) || t <= T(-INF)) ? add_id : wrap_add(x, t);
    } else {
      return x + t;
    }
  } else {
    if constexpr (is_int<T>) {
      return (int32_t)((uint32_t)x * (uint32_t)t);
    } else {
      return x * t;
    }
  }
}

// whether combining m can change an accumulator that started at add_id
template <int SR, typename T>
__device__ __forceinline__ bool contributes(T m, T add_id) {
  if constexpr (SR == SUM_TIMES) {
    return m != T(0);
  } else if constexpr (is_min<SR>) {
    return m < add_id;
  } else {
    return m > add_id;
  }
}

// The accumulator holds int32 words: the value for int32, the float's bits
// for float32 sum, and for float32 min/max a key that orders like the float.
template <int SR, typename T>
__device__ __forceinline__ int32_t to_word(T v) {
  if constexpr (is_int<T>) {
    return v;
  } else if constexpr (SR == SUM_TIMES) {
    return __float_as_int(v);
  } else {
    const int32_t b = __float_as_int(v);
    return b >= 0 ? b : b ^ 0x7FFFFFFF;
  }
}

template <int SR, typename T>
__device__ __forceinline__ T from_word(int32_t w) {
  if constexpr (is_int<T>) {
    return w;
  } else if constexpr (SR == SUM_TIMES) {
    return __int_as_float(w);
  } else {
    return __int_as_float(w >= 0 ? w : w ^ 0x7FFFFFFF);
  }
}

template <int SR, typename T>
__device__ __forceinline__ void accumulate(int32_t* a, T m) {
  if constexpr (SR == SUM_TIMES) {
    if constexpr (is_int<T>) {
      atomicAdd(reinterpret_cast<unsigned int*>(a), (unsigned int)m);
    } else {
      atomicAdd(reinterpret_cast<float*>(a), m);
    }
  } else if constexpr (is_min<SR>) {
    atomicMin(a, to_word<SR, T>(m));
  } else {
    atomicMax(a, to_word<SR, T>(m));
  }
}

// out (+)= v in global memory
template <int SR, typename T>
__device__ __forceinline__ void combine_out(T* out, T v) {
  if constexpr (SR == SUM_TIMES) {
    if constexpr (is_int<T>) {
      atomicAdd(reinterpret_cast<unsigned int*>(out), (unsigned int)v);
    } else {
      atomicAdd(out, v);
    }
  } else if constexpr (is_int<T>) {
    if constexpr (is_min<SR>) {
      atomicMin(out, v);
    } else {
      atomicMax(out, v);
    }
  } else {
    int* as_int = reinterpret_cast<int*>(out);
    unsigned int* as_uint = reinterpret_cast<unsigned int*>(out);
    const bool neg = __float_as_int(v) < 0;
    if constexpr (is_min<SR>) {
      if (neg) atomicMax(as_uint, __float_as_uint(v));
      else atomicMin(as_int, __float_as_int(v));
    } else {
      if (neg) atomicMin(as_uint, __float_as_uint(v));
      else atomicMax(as_int, __float_as_int(v));
    }
  }
}

template <int SR, typename T>
__global__ void __launch_bounds__(THREADS)
propagate_packed_kernel(const T* __restrict__ x,
                        const int32_t* __restrict__ entries,
                        const T* __restrict__ w,
                        const int32_t* __restrict__ items,
                        const int32_t* __restrict__ src_ids,
                        const uint8_t* __restrict__ active,
                        const uint8_t* __restrict__ live,
                        const uint8_t* __restrict__ mask, T* __restrict__ out,
                        int Q, int max_bpr, int B, int shift, size_t V,
                        T add_id) {
  extern __shared__ int32_t acc[];  // (QT, B)
  const int i = items[3 * blockIdx.x];
  const int first = items[3 * blockIdx.x + 1];
  const int end = items[3 * blockIdx.x + 2];
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Q - q0);
  const int32_t init = to_word<SR, T>(add_id);
  for (int j = threadIdx.x; j < QT * B; j += THREADS) acc[j] = init;
  __syncthreads();

  const size_t row = (size_t)i * max_bpr;
  const int32_t lo = (1 << shift) - 1;
  const T* xq = x + (size_t)q0 * V;
  const uint8_t* mq = mask == nullptr ? nullptr : mask + (size_t)q0 * V;
  int32_t code[ILP];
  bool keep[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const int e = first + threadIdx.x + j * THREADS;
    keep[j] = e < end;
    code[j] = keep[j] ? entries[e] : 0;
  }
  int32_t sb[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    const size_t slot = row + (code[j] >> (2 * shift));
    if (active != nullptr && active[slot] == 0) keep[j] = false;
    sb[j] = src_ids[slot];
  }
  if (live != nullptr) {
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
      if (keep[j] && live[sb[j]] == 0) keep[j] = false;
    }
  }
  T t[ILP];
  size_t u[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    t[j] = add_id;
    if constexpr (reads_weight<SR>) {
      if (keep[j]) t[j] = w[first + threadIdx.x + j * THREADS];
    }
    u[j] = (size_t)sb[j] * B + ((code[j] >> shift) & lo);
  }
  T xv[ILP][QT];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      xv[j][q] = add_id;
      if (keep[j] && q < nq) {
        const size_t off = (size_t)q * V + u[j];
        const T v = xq[off];
        if (mq == nullptr || mq[off] != 0) xv[j][q] = v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
    // a dead entry sends nothing, whatever its weight (under float
    // min_plus, add_id + t < add_id for t < -32)
    if (!keep[j]) continue;
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const T m = mul<SR>(xv[j][q], t[j], add_id);
      if (contributes<SR>(m, add_id)) accumulate<SR>(&acc[q * B + (code[j] & lo)], m);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nq * B; j += THREADS) {
    if (acc[j] == init) continue;
    const int q = j / B;
    const int c = j - q * B;
    combine_out<SR, T>(out + (size_t)(q0 + q) * V + (size_t)i * B + c,
                       from_word<SR, T>(acc[j]));
  }
}

// live[b] = whether some lane holds an active vertex in source block b:
// mask (Q, V) reduced over the lanes and the block's columns [b*B, (b+1)*B),
// the tail block cut at V.  One CUDA block a source block; each thread
// issues its lanes' loads before it combines them.
__global__ void __launch_bounds__(LIVE_THREADS)
block_live_kernel(const uint8_t* __restrict__ mask, uint8_t* __restrict__ live,
                  int Q, size_t V, int B) {
  const size_t base = (size_t)blockIdx.x * B;
  const size_t rest = base >= V ? 0 : V - base;
  const int width = rest < (size_t)B ? (int)rest : B;
  int any = 0;
  for (int c = threadIdx.x; c < width; c += LIVE_THREADS) {
    const uint8_t* col = mask + base + c;
#pragma unroll 8
    for (int q = 0; q < Q; ++q) any |= col[(size_t)q * V];
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) live[blockIdx.x] = any != 0;
}

template <int SR, typename T>
cudaError_t launch(const void* x, const void* entries, const void* w,
                   const void* items, int n_items,
                   const void* src_ids, const void* active, const void* live,
                   const void* mask, void* out, int Q, int nb, int max_bpr,
                   int B, int shift, double add_id, cudaStream_t stream) {
  const dim3 grid(n_items, (Q + QT - 1) / QT);
  const size_t smem = (size_t)QT * B * sizeof(int32_t);
  propagate_packed_kernel<SR, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(entries),
      static_cast<const T*>(w), static_cast<const int32_t*>(items),
      static_cast<const int32_t*>(src_ids),
      static_cast<const uint8_t*>(active), static_cast<const uint8_t*>(live),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), Q, max_bpr, B, shift, (size_t)nb * B, (T)add_id);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int sr, const void* x, const void* entries, const void* w,
                     const void* items, int n_items,
                     const void* src_ids, const void* active, const void* live,
                     const void* mask, void* out, int Q, int nb, int max_bpr,
                     int B, int shift, double add_id, cudaStream_t stream) {
#define REPRO_LAUNCH(SR)                                                   \
  launch<SR, T>(x, entries, w, items, n_items, src_ids, active, live,      \
                mask, out, Q, nb, max_bpr, B, shift, add_id, stream)
  switch (sr) {
    case MIN_PLUS:
      return REPRO_LAUNCH(MIN_PLUS);
    case MIN_RIGHT:
      return REPRO_LAUNCH(MIN_RIGHT);
    case MAX_RIGHT:
      return REPRO_LAUNCH(MAX_RIGHT);
    case MAX_PLUS:
      return REPRO_LAUNCH(MAX_PLUS);
    case SUM_TIMES:
      return REPRO_LAUNCH(SUM_TIMES);
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
}

}  // namespace

// sr: 0 min_plus, 1 min_right, 2 max_right, 3 max_plus, 4 sum_times.
// dtype: 0 int32, 1 float32.  x and out are (Q, nb*B), out filled with
// add_id by the caller; mask (Q, nb*B) uint8 or null; entries (nnz,) int32
// packed k << 2*shift | r << shift | c; w (nnz,) (unread, and may be null,
// where the semiring reads no weight; the wrapper checks that it is there
// otherwise); items (n_items, 3) int32 (destination block row, first
// entry, end entry), each run of at most repro_chunk() entries; src_ids
// (nb, max_bpr) int32; active (nb, max_bpr) uint8 or null; live (nb,)
// uint8 (repro_block_live's table) or null.  At most one of active and
// live; with neither, every entry is visited.
extern "C" int repro_propagate_packed(int sr, int dtype, const void* x,
                                      const void* entries, const void* w,
                                      const void* items, int n_items,
                                      const void* src_ids, const void* active,
                                      const void* live, const void* mask,
                                      void* out, int Q, int nb, int max_bpr,
                                      int B, int shift, double add_id,
                                      void* stream) {
  if (Q < 1 || n_items < 1 || nb < 1 || max_bpr < 1 || B < 1 || B > 1024 ||
      shift < 0 || shift > 10 || B > (1 << shift) || (Q + QT - 1) / QT > 65535 ||
      (active != nullptr && live != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch<int32_t>(sr, x, entries, w, items, n_items, src_ids,
                                  active, live, mask, out, Q, nb, max_bpr, B,
                                  shift, add_id, st);
  }
  if (dtype == 1) {
    return (int)dispatch<float>(sr, x, entries, w, items, n_items, src_ids,
                                active, live, mask, out, Q, nb, max_bpr, B,
                                shift, add_id, st);
  }
  return (int)cudaErrorInvalidValue;
}

// mask (Q, V) uint8, row-major; live (nb,) uint8, written in full (0 where
// no lane is active, so Q = 0 gives all 0).  V <= nb * B.
extern "C" int repro_block_live(const void* mask, void* live, int Q,
                                long long V, int nb, int B, void* stream) {
  if (Q < 0 || V < 0 || nb < 1 || B < 1 || B > 1024 || V > (long long)nb * B ||
      (Q > 0 && mask == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  block_live_kernel<<<nb, LIVE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<uint8_t*>(live), Q,
      (size_t)V, B);
  return (int)cudaGetLastError();
}

// The most entries one work item may hold (THREADS * ILP: one pass).
extern "C" int repro_chunk() { return CHUNK; }
