// K2 — merge-path CSR SpMV for Hopper (sm_90a), and K2d, its float64 twin.
//
// K2 replaces the Pallas TPU kernel tpusparse/kernels/merge_spmv.py::
// _spmv_tiles (body _fused_kernel). K2d replaces tpusparse/kernels/
// merge_df.py::_spmv_tiles_df (body _fused_kernel_df), the same SpMV in
// double-float (two-f32) arithmetic with compensated scans, written so
// because Mosaic has no 64-bit types; on Hopper it is this pipeline at
// IEEE float64: double products, partials, scan values and carry-outs.
//
// The TPU kernel re-designed the SC'16 merge-based SpMV (Merrill &
// Garland) around static tiles planned on the host; on a GPU the
// original pipeline fits again (the CUB pipeline dispatch_spmv_orig.cuh),
// with its search moved into the plan:
//
//   0. plan:    the start coordinate (row, nz) of every CTA tile on the
//               merge path of (row end offsets, nonzero indices), found
//               once on the host (kernels/merge_spmv.py::
//               merge_tile_coords): it depends only on the matrix.
//   1. consume: each CTA stages its tile's products vals * x[col] and
//               row end offsets in shared memory; each thread searches
//               its own start inside the tile and walks kItems merge
//               items serially, writing every row it completes. A
//               thread's first completed row may have begun in earlier
//               threads: a CTA-wide inclusive scan of (completed-a-row,
//               partial) pairs supplies that head. The last partial of
//               the CTA (its carry-out) goes to scratch with its row.
//   2. fix-up:  the first CTA of each run of carry-outs on the same row
//               adds the run, in CTA order, into y.
//
// No float atomics: every sum has a fixed order, so two runs give
// bitwise equal y. Empty rows, a row spanning many CTAs, rectangular
// matrices, nnz = 0 and n = 0 need no special path: the merge path
// covers num_rows + nnz items exactly and every row is completed once.
// The order of a row's additions follows the geometry (kThreads, kItems):
// any fixed order keeps row i within (nnz_i + 2) u (|A||x|)_i.
//
// Bound: bytes and gather latency. Per nonzero 8 B of column index and
// value stream once (12 B in float64); x is gathered (4 B, 8 B in
// float64, cached when columns cluster); per row 4 B of offsets and 4 B
// of y (8 B). Products and sums round separately (rn_arith.cuh). What
// the design does about it:
//
//   * the staging is unrolled over kItems: a thread issues all of its
//     column-index, value and row-end loads, then all of its x gathers,
//     so kItems gathers are in flight per thread, not one;
//   * the row ends and products share one shared-memory buffer
//     (tile_rows + tile_nnz = the tile's items), as in CUB;
//   * the CTA scan is a segmented scan with warp shuffles, then one
//     barrier and a serial pass over the kThreads / 32 warp totals: two
//     barriers per tile in all, staging included.
//
// Measured against this form on lap3d-160 and rmat-18-ef16 in both types
// and dropped (PERF.md §6): streaming (evict-first) loads, cp.async
// staging, 256 threads or 16 items a thread, a 32-register cap, and a
// fix-up loading a hub's carry-outs 16 at a time (2.0 % faster over the
// four cells, inside the run-to-run spread).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "merge_path.cuh"
#include "rn_arith.cuh"

namespace {

using tps_merge::Coord;
using tps_merge::merge_path_search;

// K2's geometry; kernels/merge_spmv.py::TILE_ITEMS mirrors kTileItems,
// and K3 (merge_spmm.cu) works on the same tiles.
constexpr int kThreads = 128;                  // threads per consume CTA
constexpr int kItems = 8;                      // merge items per thread
constexpr int kTileItems = kThreads * kItems;  // merge items per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kFixupThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_consume_kernel(const int* __restrict__ row_offsets,
                     const int* __restrict__ col_indices,
                     const T* __restrict__ values, const T* __restrict__ x,
                     T* __restrict__ y, const Coord* __restrict__ coords,
                     int num_rows, int* __restrict__ carry_rows,
                     T* __restrict__ carry_vals) {
  // tile_rows + 1 row ends, then (aligned) tile_nnz products: at most
  // kTileItems * sizeof(T) + 8 bytes
  __shared__ __align__(16) unsigned char s_tile[kTileItems * sizeof(T) + 16];
  __shared__ int s_warp_flag[kWarps];
  __shared__ T s_warp_val[kWarps];

  const Coord start = coords[blockIdx.x];
  const Coord end = coords[blockIdx.x + 1];
  const int tile_rows = end.row - start.row;
  const int tile_nnz = end.nz - start.nz;
  const int tile_items = tile_rows + tile_nnz;
  const int t = threadIdx.x;
  int* s_row_end = reinterpret_cast<int*>(s_tile);
  T* s_prod = reinterpret_cast<T*>(
      s_tile + ((tile_rows + 1) * sizeof(int) + sizeof(T) - 1) / sizeof(T) *
                   sizeof(T));

  // Staging: every load of the thread first, then every gather, then
  // the stores. Nonzero j = t + k kThreads of the tile (k < kItems covers
  // tile_nnz <= kTileItems); row end r = t + k kThreads for k <= kItems
  // covers the tile's rows and one entry past them (the walk may test
  // the row it ends in; past the last row nothing is left to consume).
  int col[kItems];
  T val[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t + k * kThreads;
    col[k] = j < tile_nnz ? col_indices[start.nz + j] : 0;
    val[k] = j < tile_nnz ? values[start.nz + j] : T(0);
  }
  int row_end[kItems + 1];
#pragma unroll
  for (int k = 0; k <= kItems; ++k) {
    const int r = t + k * kThreads;
    const int g = start.row + r;
    row_end[k] = r <= tile_rows && g < num_rows ? row_offsets[g + 1]
                                                : INT_MAX;
  }
  T xv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    xv[k] = t + k * kThreads < tile_nnz ? __ldg(x + col[k]) : T(0);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t + k * kThreads;
    if (j < tile_nnz) s_prod[j] = tps_rn::mul(val[k], xv[k]);
  }
#pragma unroll
  for (int k = 0; k <= kItems; ++k) {
    const int r = t + k * kThreads;
    if (r <= tile_rows) s_row_end[r] = row_end[k];
  }
  __syncthreads();

  const int d0 = t * kItems < tile_items ? t * kItems : tile_items;
  const int d1 = d0 + kItems < tile_items ? d0 + kItems : tile_items;
  const Coord c = merge_path_search(d0, s_row_end, tile_rows, start.nz,
                                    tile_nnz);
  int row = c.row;  // local to the tile
  int nz = c.nz;
  T running = T(0);
  int has_first = 0;
  int first_row = 0;
  T first_val = T(0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (d0 + k < d1) {
      if (start.nz + nz < s_row_end[row]) {
        running = tps_rn::add(running, s_prod[nz]);
        ++nz;
      } else {
        if (has_first) {
          y[start.row + row] = running;
        } else {
          has_first = 1;
          first_row = row;
          first_val = running;
        }
        running = T(0);
        ++row;
      }
    }
  }

  // Inclusive scan of (flag, value) over the CTA's threads with
  // (a, b) -> (a.flag | b.flag, b.flag ? b.value : a.value + b.value):
  // the value of thread t is the partial of the row thread t ends in,
  // over every item of the CTA up to t's end. First inside each warp
  // with shuffles (no barrier), then across the warp totals.
  const int lane = t & 31;
  const int warp = t >> 5;
  int f = has_first;
  T v = running;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T v_up = __shfl_up_sync(kFullMask, v, off);
    const int f_up = __shfl_up_sync(kFullMask, f, off);
    if (lane >= off) {
      if (!f) v = tps_rn::add(v_up, v);
      f |= f_up;
    }
  }
  if (lane == 31) {
    s_warp_flag[warp] = f;
    s_warp_val[warp] = v;
  }
  // the thread's exclusive prefix inside its warp
  int fe = __shfl_up_sync(kFullMask, f, 1);
  T ve = __shfl_up_sync(kFullMask, v, 1);
  if (lane == 0) {
    fe = 0;
    ve = T(0);
  }
  __syncthreads();
  // the prefix of the warps before this one, in warp order
  T pv = T(0);
  for (int w = 0; w < warp; ++w) {
    pv = s_warp_flag[w] ? s_warp_val[w] : tps_rn::add(pv, s_warp_val[w]);
  }
  if (has_first) {
    const T head = fe ? ve : tps_rn::add(pv, ve);
    y[start.row + first_row] = tps_rn::add(head, first_val);
  }
  if (t == kThreads - 1) {
    carry_rows[blockIdx.x] = end.row;
    carry_vals[blockIdx.x] = f ? v : tps_rn::add(pv, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kFixupThreads)
merge_fixup_kernel(const int* __restrict__ carry_rows,
                   const T* __restrict__ carry_vals, int num_tiles,
                   int num_rows, T* __restrict__ y) {
  const int c = blockIdx.x * kFixupThreads + threadIdx.x;
  if (c >= num_tiles) return;
  const int r = carry_rows[c];
  if (r >= num_rows || (c > 0 && carry_rows[c - 1] == r)) return;
  T s = carry_vals[c];
  for (int k = c + 1; k < num_tiles && carry_rows[k] == r; ++k) {
    s = tps_rn::add(s, carry_vals[k]);
  }
  y[r] = tps_rn::add(y[r], s);
}

template <typename T>
int run(const void* row_offsets, const void* col_indices, const void* values,
        const void* x, void* y, const void* tile_coords, void* carry_rows,
        void* carry_vals, int num_rows, int nnz, int num_tiles,
        void* stream) {
  const long long total = static_cast<long long>(num_rows) + nnz;
  if (num_rows < 0 || nnz < 0 ||
      num_tiles != (total + kTileItems - 1) / kTileItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* crow = static_cast<int*>(carry_rows);
  T* cval = static_cast<T*>(carry_vals);
  T* yv = static_cast<T*>(y);

  merge_consume_kernel<T><<<num_tiles, kThreads, 0, s>>>(
      static_cast<const int*>(row_offsets),
      static_cast<const int*>(col_indices), static_cast<const T*>(values),
      static_cast<const T*>(x), yv, static_cast<const Coord*>(tile_coords),
      num_rows, crow, cval);
  const int fixup_blocks = (num_tiles + kFixupThreads - 1) / kFixupThreads;
  merge_fixup_kernel<T><<<fixup_blocks, kFixupThreads, 0, s>>>(
      crow, cval, num_tiles, num_rows, yv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2's tile: tile_coords of a K2 or K3 call start a tile every this many
// merge items.
extern "C" int tps_merge_spmv_tile_items(void) { return kTileItems; }

// y (num_rows,) = A @ x for CSR (row_offsets, col_indices, values),
// float32 (K2). tile_coords: the plan's (num_tiles + 1) int pairs
// (row, nz), tile t starting at merge item t tps_merge_spmv_tile_items()
// (kernels/merge_spmv.py::merge_tile_coords). Scratch: carry_rows and
// carry_vals (num_tiles each), num_tiles = ceil((num_rows + nnz) /
// tps_merge_spmv_tile_items()). Returns the cudaGetLastError() code
// after the two launches.
extern "C" int tps_merge_spmv(const void* row_offsets, const void* col_indices,
                              const void* values, const void* x, void* y,
                              const void* tile_coords, void* carry_rows,
                              void* carry_vals, int num_rows, int nnz,
                              int num_tiles, void* stream) {
  return run<float>(row_offsets, col_indices, values, x, y, tile_coords,
                    carry_rows, carry_vals, num_rows, nnz, num_tiles, stream);
}

// The same in float64 (K2d): values, x, y and carry_vals are double.
extern "C" int tps_merge_spmv_f64(const void* row_offsets,
                                  const void* col_indices, const void* values,
                                  const void* x, void* y,
                                  const void* tile_coords, void* carry_rows,
                                  void* carry_vals, int num_rows, int nnz,
                                  int num_tiles, void* stream) {
  return run<double>(row_offsets, col_indices, values, x, y, tile_coords,
                     carry_rows, carry_vals, num_rows, nnz, num_tiles,
                     stream);
}
