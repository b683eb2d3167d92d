// K3 — merge-path CSR SpMM for Hopper (sm_90a): Y (num_rows, L) = A X
// for X (num_cols, L), both row-major float32; and K3d, its float64 twin.
//
// K3 replaces the Pallas TPU kernel tpusparse/kernels/spmm_merge.py::
// _spmm_tiles (body _spmm_kernel). K3d replaces tpusparse/kernels/
// merge_df.py::_spmm_tiles_df (body _spmm_kernel_df), the same SpMM in
// double-float (two-f32) arithmetic because Mosaic has no 64-bit types;
// here values, X, Y, partials and carry-outs are IEEE float64. Those
// kernels stream the tile payload once for all L right-hand sides; so
// does this one. It is K2's pipeline (merge_spmv.cu) carried to L lanes,
// on K2's tiles:
//
//   0. plan:    the start (row, nz) of every tile of kTileItems merge
//               items, found once on the host (kernels/merge_spmv.py::
//               merge_tile_coords) and shared with K2; a call launches no
//               search.
//   1. consume: each CTA stages its tile's column indices, values and row
//               end offsets in shared memory (every load of a thread
//               issued before its stores). A thread takes V RHS lanes of
//               a row of X, 16 bytes (V = 4 in float32, 2 in float64)
//               where V divides L, else one. The CTA's threads form
//               kBlock / W groups of W threads (W the next power of two
//               >= L / V, at most 32; wider L loops over lane chunks); a
//               group finds the start and end of its stretch of the
//               tile's merge items by two searches in shared memory and
//               walks it: the X rows of the next kBatch nonzeros are
//               gathered into registers first, then the row ends and
//               products are taken in path order, writing every row the
//               group completes. A group's first completed row may have
//               begun in earlier groups: its head is the sum, in group
//               order, of the partials the earlier groups end with, back
//               to the last group that completed a row. The CTA's
//               carry-out goes to scratch; its row is the row of the next
//               tile start.
//   2. fix-up:  per (run of carry-outs on one row, lane), the first tile
//               of the run adds the run, in tile order, into Y.
//
// No float atomics: every sum has a fixed order, so two runs give
// bitwise equal Y. Products and sums round separately (no FMA
// contraction, rn_arith.cuh), as in the plain version. The order of a
// lane's additions follows the group stretches (kBlock, W): any fixed
// order keeps row i within (nnz_i + 2) u (|A||X|)_i.
//
// The TPU kernel's MXU prefix scan, its (L, 128) lane blocks, the lane
// padding to multiples of 8, the VMEM lane chunking and the overflow COO
// stream have no counterpart: a lane chunk here is a loop inside the CTA
// over the payload already in shared memory.
//
// Bound: bytes. Per nonzero 8 B of column index and value stream once
// for all L lanes (12 B in float64); X is gathered 4 L B per nonzero
// (8 L B in float64; cached when columns cluster, so about once per row
// of X); Y is written 4 L B per row (8 L B). At L = 16 the X and Y
// streams outweigh the payload. What the design does about it, each step
// timed against its undoing on six cells (geometric means, PERF.md §6):
// the search goes into the plan (undoing it cost 7.5 and 9.0 % in two
// rounds); kBatch gathers in flight instead of one (12.1 % in both);
// 16-byte lanes, so a group's walk is a quarter (in float64 half) as
// long and each gather one 16-byte load (28 % faster than one lane a
// thread). Measured and dropped: a fix-up loading a run's carry-outs 16
// at a time (1.4-3.5 % faster, inside the 6.8-9.8 % spreads), 256
// threads a CTA, cp.async staging, 32-byte lanes, 4 or 16 gathers in
// flight. Index arithmetic on X, Y and the carry-outs is 64-bit: n L
// passes 2^31 at real sizes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "merge_path.cuh"
#include "rn_arith.cuh"

namespace {

using tps_merge::Coord;
using tps_merge::merge_path_search;

// kernels/spmm_merge.py mirrors kBlock, kTileItems, kMaxGroup and
// kLaneBytes (group_items); every launch checks it against
// tps_merge_spmm_group_items.
constexpr int kBlock = 128;                  // threads per consume CTA
constexpr int kTileItems = 1024;             // merge items per CTA: K2's
constexpr int kStage = kTileItems / kBlock;  // payload entries per thread
constexpr int kMaxGroup = 32;                // threads per lane group
constexpr int kBatch = 8;                    // X gathers in flight
constexpr int kFixupThreads = 256;
// Bytes of RHS lanes a thread takes where they divide a row of X (four
// float32 or two float64 lanes, one 16-byte load), else one lane.
constexpr int kLaneBytes = 16;

// V consecutive RHS lanes of one row, loaded and stored as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Lanes {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Lanes<T, V> zeros() {
  Lanes<T, V> z;
#pragma unroll
  for (int i = 0; i < V; ++i) z.v[i] = T(0);
  return z;
}

// V lanes from p: one load, or one 16-byte load (p 16-byte aligned).
template <typename T, int V>
__device__ __forceinline__ Lanes<T, V> load_lanes(const T* p) {
  Lanes<T, V> out;
  if constexpr (V == 1) {
    out.v[0] = __ldg(p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "16-byte lanes");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out.v[0] = q.x;
    out.v[1] = q.y;
    out.v[2] = q.z;
    out.v[3] = q.w;
  } else {
    static_assert(V == 2, "16-byte lanes");
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    out.v[0] = q.x;
    out.v[1] = q.y;
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void add_to(Lanes<T, V>& s, const Lanes<T, V>& a) {
#pragma unroll
  for (int i = 0; i < V; ++i) s.v[i] = tps_rn::add(s.v[i], a.v[i]);
}

// The partial that the groups lo .. hi-1 contribute to the row in
// progress at the end of group hi-1: the sum, in group order, of their
// end partials from the last group in [lo, hi) that completed a row.
template <typename T, int V>
__device__ __forceinline__ Lanes<T, V> run_partial(const Lanes<T, V>* s_run,
                                                   const int* s_done, int hi,
                                                   int lane, int log2w) {
  int k = hi - 1;
  while (k > 0 && !s_done[k]) --k;
  Lanes<T, V> s = zeros<T, V>();
  for (int j = k < 0 ? 0 : k; j < hi; ++j) {
    add_to(s, s_run[(j << log2w) + lane]);
  }
  return s;
}

template <typename T, int V>
__global__ void __launch_bounds__(kBlock)
merge_spmm_consume_kernel(const int* __restrict__ row_offsets,
                          const int* __restrict__ col_indices,
                          const T* __restrict__ values,
                          const T* __restrict__ X, T* __restrict__ Y,
                          const Coord* __restrict__ coords, int num_rows,
                          int L, int log2w, T* __restrict__ carry_vals) {
  using Vec = Lanes<T, V>;
  // 17.5-18.5 KB of shared memory in float64, 13-14.5 KB in float32
  __shared__ int s_row_end[kTileItems + 1];
  __shared__ int s_col[kTileItems];
  __shared__ T s_val[kTileItems];
  __shared__ Vec s_run[kBlock];    // (group, lane): partial at group end
  __shared__ int s_done[kBlock];   // group: completed at least one row

  const Coord start = coords[blockIdx.x];
  const Coord end = coords[blockIdx.x + 1];
  const int tile_rows = end.row - start.row;
  const int tile_nnz = end.nz - start.nz;
  const int tile_items = tile_rows + tile_nnz;
  const int t = threadIdx.x;
  const int W = 1 << log2w;
  const int G = kBlock >> log2w;
  const int g = t >> log2w;
  const int lane = t & (W - 1);

  // Staging: every load of the thread, then every store. Nonzero j =
  // t + k kBlock (k < kStage covers tile_nnz <= kTileItems); row end r =
  // t + k kBlock for k <= kStage covers the tile's rows and one entry
  // past them (a walk may test the row it ends in; past the last row of
  // the matrix nothing is left to consume).
  int col[kStage];
  T val[kStage];
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int j = t + k * kBlock;
    col[k] = j < tile_nnz ? col_indices[start.nz + j] : 0;
    val[k] = j < tile_nnz ? values[start.nz + j] : T(0);
  }
  int row_end[kStage + 1];
#pragma unroll
  for (int k = 0; k <= kStage; ++k) {
    const int r = t + k * kBlock;
    const int gr = start.row + r;
    row_end[k] = r <= tile_rows && gr < num_rows ? row_offsets[gr + 1]
                                                 : INT_MAX;
  }
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int j = t + k * kBlock;
    if (j < tile_nnz) {
      s_col[j] = col[k];
      s_val[j] = val[k];
    }
  }
#pragma unroll
  for (int k = 0; k <= kStage; ++k) {
    const int r = t + k * kBlock;
    if (r <= tile_rows) s_row_end[r] = row_end[k];
  }
  __syncthreads();

  // the group's stretch of merge items [d0, d1), from (c.row, c.nz) to
  // (e.row, e.nz), local to the tile
  const int per_group = kTileItems / G;
  const int d0 = g * per_group < tile_items ? g * per_group : tile_items;
  const int d1 = d0 + per_group < tile_items ? d0 + per_group : tile_items;
  const Coord c = merge_path_search(d0, s_row_end, tile_rows, start.nz,
                                    tile_nnz);
  const Coord e = merge_path_search(d1, s_row_end, tile_rows, start.nz,
                                    tile_nnz);

  for (int l0 = 0; l0 < L; l0 += W * V) {
    const int l = l0 + lane * V;
    const bool active = l < L;
    int row = c.row;
    Vec running = zeros<T, V>();
    int done = 0;
    int first_row = 0;
    Vec first_val = zeros<T, V>();
    // the row end item of `row`: the group's first completed row is kept
    // for the head, every later one is written
    auto complete_row = [&]() {
      if (done) {
        if (active) {
          *reinterpret_cast<Vec*>(
              Y + static_cast<long long>(start.row + row) * L + l) = running;
        }
      } else {
        done = 1;
        first_row = row;
        first_val = running;
      }
      running = zeros<T, V>();
      ++row;
    };
    for (int j0 = c.nz; j0 < e.nz; j0 += kBatch) {
      Vec xv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = j0 + k;
        xv[k] = active && j < e.nz
                    ? load_lanes<T, V>(
                          X + static_cast<long long>(s_col[j]) * L + l)
                    : zeros<T, V>();
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = j0 + k;
        if (j < e.nz) {
          // the row ends that come before nonzero j on the path
          while (s_row_end[row] <= start.nz + j) complete_row();
          const T a = s_val[j];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            running.v[i] =
                tps_rn::add(running.v[i], tps_rn::mul(a, xv[k].v[i]));
          }
        }
      }
    }
    while (row < e.row) complete_row();
    s_run[t] = running;
    if (lane == 0) s_done[g] = done;
    __syncthreads();
    if (done && active) {
      Vec head = g > 0 ? run_partial(s_run, s_done, g, lane, log2w)
                       : zeros<T, V>();
      add_to(head, first_val);
      *reinterpret_cast<Vec*>(
          Y + static_cast<long long>(start.row + first_row) * L + l) = head;
    }
    if (g == G - 1 && active) {
      *reinterpret_cast<Vec*>(
          carry_vals + static_cast<long long>(blockIdx.x) * L + l) =
          run_partial(s_run, s_done, G, lane, log2w);
    }
    __syncthreads();  // s_run and s_done are rewritten by the next chunk
  }
}

// The carry-out of tile c belongs to row coords[c + 1].row. The first
// tile of each run of carry-outs on one row adds the run, in tile order,
// into Y, one thread per (run, lane).
template <typename T>
__global__ void __launch_bounds__(kFixupThreads)
merge_spmm_fixup_kernel(const Coord* __restrict__ coords,
                        const T* __restrict__ carry_vals, int num_tiles,
                        int num_rows, int L, T* __restrict__ Y) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kFixupThreads + threadIdx.x;
  if (idx >= static_cast<long long>(num_tiles) * L) return;
  const int c = static_cast<int>(idx / L);
  const int l = static_cast<int>(idx % L);
  const int r = coords[c + 1].row;
  if (r >= num_rows || (c > 0 && coords[c].row == r)) return;
  T s = carry_vals[idx];
  for (int k = c + 1; k < num_tiles && coords[k + 1].row == r; ++k) {
    s = tps_rn::add(s, carry_vals[static_cast<long long>(k) * L + l]);
  }
  const long long yi = static_cast<long long>(r) * L + l;
  Y[yi] = tps_rn::add(Y[yi], s);
}

// Lanes per thread at L right-hand sides of `value_bytes` each.
int lanes_per_thread(int L, int value_bytes) {
  const int wide = kLaneBytes / value_bytes;
  return L % wide == 0 ? wide : 1;
}

// log2 of the threads of a lane group: W V >= L lanes, W a power of two
// of at most kMaxGroup.
int group_log2(int L, int V) {
  const int lanes = (L + V - 1) / V;
  int log2w = 0;
  while ((1 << log2w) < lanes && (1 << log2w) < kMaxGroup) ++log2w;
  return log2w;
}

template <typename T>
int run(const void* row_offsets, const void* col_indices, const void* values,
        const void* X, void* Y, const void* tile_coords, void* carry_vals,
        int num_rows, int nnz, int num_tiles, int L, void* stream) {
  const long long total = static_cast<long long>(num_rows) + nnz;
  if (L < 1 || num_rows < 0 || nnz < 0 ||
      num_tiles != (total + kTileItems - 1) / kTileItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int V = lanes_per_thread(L, sizeof(T));
  // wide lanes need X and Y aligned to kLaneBytes (their rows are, as
  // L % V == 0)
  if (V > 1 && ((reinterpret_cast<uintptr_t>(X) |
                 reinterpret_cast<uintptr_t>(Y)) & (kLaneBytes - 1)) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (num_tiles == 0) return 0;
  const int log2w = group_log2(L, V);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Coord* coords = static_cast<const Coord*>(tile_coords);
  T* cval = static_cast<T*>(carry_vals);
  T* Yv = static_cast<T*>(Y);
  const int* ro = static_cast<const int*>(row_offsets);
  const int* ci = static_cast<const int*>(col_indices);
  const T* va = static_cast<const T*>(values);
  const T* Xv = static_cast<const T*>(X);

  if (V == 1) {
    merge_spmm_consume_kernel<T, 1><<<num_tiles, kBlock, 0, s>>>(
        ro, ci, va, Xv, Yv, coords, num_rows, L, log2w, cval);
  } else {
    constexpr int kWide = static_cast<int>(kLaneBytes / sizeof(T));
    merge_spmm_consume_kernel<T, kWide><<<num_tiles, kBlock, 0, s>>>(
        ro, ci, va, Xv, Yv, coords, num_rows, L, log2w, cval);
  }
  const long long fix_threads = static_cast<long long>(num_tiles) * L;
  const unsigned fixup_blocks = static_cast<unsigned>(
      (fix_threads + kFixupThreads - 1) / kFixupThreads);
  merge_spmm_fixup_kernel<T><<<fixup_blocks, kFixupThreads, 0, s>>>(
      coords, cval, num_tiles, num_rows, L, Yv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Merge items of each lane group's stretch of a tile at L right-hand
// sides of value_bytes (4 or 8) each: the geometry that fixes the order
// of a lane's additions, mirrored by kernels/spmm_merge.py::group_items.
extern "C" int tps_merge_spmm_group_items(int L, int value_bytes) {
  const int log2w = group_log2(L, lanes_per_thread(L, value_bytes));
  return kTileItems / (kBlock >> log2w);
}

// Y (num_rows, L) = A @ X (num_cols, L) for CSR (row_offsets,
// col_indices, values), row-major float32 (K3). tile_coords: the plan's
// (num_tiles + 1) int pairs (row, nz), tile t starting at merge item
// t 1024 (kernels/merge_spmv.py::merge_tile_coords, K2's tiles). Scratch:
// carry_vals (num_tiles, L). Returns the cudaGetLastError() code after
// the two launches.
extern "C" int tps_merge_spmm(const void* row_offsets, const void* col_indices,
                              const void* values, const void* X, void* Y,
                              const void* tile_coords, void* carry_vals,
                              int num_rows, int nnz, int num_tiles, int L,
                              void* stream) {
  return run<float>(row_offsets, col_indices, values, X, Y, tile_coords,
                    carry_vals, num_rows, nnz, num_tiles, L, stream);
}

// The same in float64 (K3d): values, X, Y and carry_vals are double.
extern "C" int tps_merge_spmm_f64(const void* row_offsets,
                                  const void* col_indices, const void* values,
                                  const void* X, void* Y,
                                  const void* tile_coords, void* carry_vals,
                                  int num_rows, int nnz, int num_tiles, int L,
                                  void* stream) {
  return run<double>(row_offsets, col_indices, values, X, Y, tile_coords,
                     carry_vals, num_rows, nnz, num_tiles, L, stream);
}
