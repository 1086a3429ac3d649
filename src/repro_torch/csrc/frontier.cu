// Batched block-sparse semiring SpMV for Hopper (sm_90a): one frontier
// step of Quegel's superstep-sharing round,
//
//     y[q, v] = add_{u -> v} mul(x[q, u], w(u, v)),
//
// over the block-sparse dense-tile layout of core/graph.py::BlockSparse.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frontier.py
// (propagate_blocks, with _kernel and _combine_tile).  The TPU grid
// (dst block, slot) runs in order and carries the (Q, B) output across the
// slot axis in VMEM; CUDA blocks run in no order, so here one block owns a
// (dst block i, Q-tile) output tile and loops over the slots k itself:
//
//   * blockDim.x == B: thread c owns output column c of the tile, and its
//     QT accumulators stay in registers, start at add_id and are written
//     once (no atomics, slots combined in the reference's k order);
//   * for each slot it reads active[i, k] and src_ids[i, k]; a dead tile
//     (frontier-empty source block or padding slot) is skipped whole;
//   * the (QT, B) x-tile of source block src_ids[i, k] is staged in shared
//     memory with masked sources set to add_id (frontier.py:81-82);
//   * thread c walks the B rows of column c of the (B, B) tile: for each
//     row, neighbouring threads read neighbouring addresses, so the tile
//     reads coalesce; UNROLL rows are loaded ahead to keep loads in flight.
//
// Bound on this card: every live tile is read once, so the kernel moves
// active_tiles * B^2 * sizeof(T) bytes (plus x, mask and y, small beside
// it) and does about 2 * Q operations per tile entry; at Q <= 8 that is
// far below the 67 TFLOP/s fp32 rate, so the bound is the bytes at the
// H100's 3.35 TB/s.  Packing presence bits, cp.async/TMA staging and
// persistent blocks are left for later work.
//
// Five semirings, as in the reference: min_right/max_right (a tile entry
// different from add_id gates the label), min_plus/max_plus (int32 add
// that saturates at +-INF, frontier.py:44-50; plain add on float32) and
// sum_times (an fp32 FMA loop, no TF32; int32 wraps like XLA's dot).
// x and tiles share one dtype, int32 or float32.
//
// C interface (loaded with ctypes): repro_propagate_blocks returns the
// cudaError_t of the launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int QT = 8;       // query lanes per block (ragged Q is guarded)
constexpr int UNROLL = 16;  // tile rows loaded ahead per step
constexpr int32_t INF = 1 << 30;

enum Semiring { MIN_PLUS = 0, MIN_RIGHT = 1, MAX_RIGHT = 2, MAX_PLUS = 3, SUM_TIMES = 4 };

template <typename T>
constexpr bool is_int = std::is_integral_v<T>;

// int32 arithmetic in unsigned form: wraps like XLA instead of being UB
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ float wrap_add(float a, float b) { return a + b; }

template <int SR, typename T>
__device__ __forceinline__ T sr_add(T acc, T m) {
  if constexpr (SR == MIN_PLUS || SR == MIN_RIGHT) {
    return m < acc ? m : acc;
  } else if constexpr (SR == MAX_PLUS || SR == MAX_RIGHT) {
    return m > acc ? m : acc;
  } else {
    return wrap_add(acc, m);
  }
}

// acc (+) mul(x, t) for one tile entry
template <int SR, typename T>
__device__ __forceinline__ T combine(T acc, T x, T t, T add_id) {
  if constexpr (SR == MIN_RIGHT || SR == MAX_RIGHT) {
    return sr_add<SR>(acc, t != add_id ? x : add_id);
  } else if constexpr (SR == MIN_PLUS) {
    if constexpr (is_int<T>) {
      return sr_add<SR>(acc, (x >= T(INF) || t >= T(INF)) ? add_id : wrap_add(x, t));
    } else {
      return sr_add<SR>(acc, x + t);
    }
  } else if constexpr (SR == MAX_PLUS) {
    if constexpr (is_int<T>) {
      return sr_add<SR>(acc, (x <= T(-INF) || t <= T(-INF)) ? add_id : wrap_add(x, t));
    } else {
      return sr_add<SR>(acc, x + t);
    }
  } else {
    if constexpr (is_int<T>) {
      return (int32_t)((uint32_t)acc + (uint32_t)x * (uint32_t)t);
    } else {
      return fmaf(x, t, acc);
    }
  }
}

template <int SR, typename T>
__global__ void __launch_bounds__(1024)
propagate_blocks_kernel(const T* __restrict__ x, const T* __restrict__ tiles,
                        const int32_t* __restrict__ src_ids,
                        const uint8_t* __restrict__ active,
                        const uint8_t* __restrict__ mask, T* __restrict__ out,
                        int Q, int max_bpr, int B, size_t V, T add_id) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (QT, B) staged x-tile
  const int i = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int c = threadIdx.x;
  const size_t row = (size_t)i * max_bpr;

  T acc[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) acc[q] = add_id;

  for (int k = 0; k < max_bpr; ++k) {
    // uniform across the block: depends on (i, k) only
    if (active != nullptr && active[row + k] == 0) continue;
    const size_t src0 = (size_t)src_ids[row + k] * B + c;
    __syncthreads();  // the previous tile's readers are done with xs
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      T v = add_id;
      if (q0 + q < Q) {
        const size_t off = (size_t)(q0 + q) * V + src0;
        v = x[off];
        if (mask != nullptr && mask[off] == 0) v = add_id;
      }
      xs[q * B + c] = v;
    }
    __syncthreads();
    const T* tcol = tiles + (row + k) * (size_t)B * B + c;
    for (int r0 = 0; r0 < B; r0 += UNROLL) {
      T t[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        t[u] = (r0 + u < B) ? tcol[(size_t)(r0 + u) * B] : add_id;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r0 + u < B) {
#pragma unroll
          for (int q = 0; q < QT; ++q) {
            acc[q] = combine<SR>(acc[q], xs[q * B + r0 + u], t[u], add_id);
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    if (q0 + q < Q) out[(size_t)(q0 + q) * V + (size_t)i * B + c] = acc[q];
  }
}

template <int SR, typename T>
cudaError_t launch(const void* x, const void* tiles, const void* src_ids,
                   const void* active, const void* mask, void* out, int Q,
                   int nb, int max_bpr, int B, double add_id,
                   cudaStream_t stream) {
  const dim3 grid(nb, (Q + QT - 1) / QT);
  const size_t smem = (size_t)QT * B * sizeof(T);
  propagate_blocks_kernel<SR, T><<<grid, B, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tiles),
      static_cast<const int32_t*>(src_ids),
      static_cast<const uint8_t*>(active), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), Q, max_bpr, B, (size_t)nb * B, (T)add_id);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int sr, const void* x, const void* tiles,
                     const void* src_ids, const void* active,
                     const void* mask, void* out, int Q, int nb, int max_bpr,
                     int B, double add_id, cudaStream_t stream) {
  switch (sr) {
    case MIN_PLUS:
      return launch<MIN_PLUS, T>(x, tiles, src_ids, active, mask, out, Q, nb, max_bpr, B, add_id, stream);
    case MIN_RIGHT:
      return launch<MIN_RIGHT, T>(x, tiles, src_ids, active, mask, out, Q, nb, max_bpr, B, add_id, stream);
    case MAX_RIGHT:
      return launch<MAX_RIGHT, T>(x, tiles, src_ids, active, mask, out, Q, nb, max_bpr, B, add_id, stream);
    case MAX_PLUS:
      return launch<MAX_PLUS, T>(x, tiles, src_ids, active, mask, out, Q, nb, max_bpr, B, add_id, stream);
    case SUM_TIMES:
      return launch<SUM_TIMES, T>(x, tiles, src_ids, active, mask, out, Q, nb, max_bpr, B, add_id, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// sr: 0 min_plus, 1 min_right, 2 max_right, 3 max_plus, 4 sum_times.
// dtype: 0 int32, 1 float32.  x and out are (Q, nb*B), mask (Q, nb*B)
// uint8 or null, tiles (nb, max_bpr, B, B), src_ids (nb, max_bpr) int32,
// active (nb, max_bpr) uint8 or null (null visits every tile).
extern "C" int repro_propagate_blocks(int sr, int dtype, const void* x,
                                      const void* tiles, const void* src_ids,
                                      const void* active, const void* mask,
                                      void* out, int Q, int nb, int max_bpr,
                                      int B, double add_id, void* stream) {
  if (Q < 1 || nb < 1 || max_bpr < 1 || B < 1 || B > 1024 || (Q + QT - 1) / QT > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch<int32_t>(sr, x, tiles, src_ids, active, mask, out, Q, nb, max_bpr, B, add_id, st);
  }
  if (dtype == 1) {
    return (int)dispatch<float>(sr, x, tiles, src_ids, active, mask, out, Q, nb, max_bpr, B, add_id, st);
  }
  return (int)cudaErrorInvalidValue;
}
