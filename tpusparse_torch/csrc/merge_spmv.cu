// K2 — merge-path CSR SpMV for Hopper (sm_90a), and K2d, its float64 twin.
//
// K2 replaces the Pallas TPU kernel tpusparse/kernels/merge_spmv.py::
// _spmv_tiles (body _fused_kernel). K2d replaces tpusparse/kernels/
// merge_df.py::_spmv_tiles_df (body _fused_kernel_df), the same SpMV in
// double-float (two-f32) arithmetic with compensated scans, written so
// because Mosaic has no 64-bit types; on Hopper it is this pipeline at
// IEEE float64: double products, partials, scan values and carry-outs.
//
// The TPU kernel re-designed the
// SC'16 merge-based SpMV (Merrill & Garland) around static tiles planned
// on the host; on a GPU the original pipeline fits again, and this is it
// (the CUB pipeline dispatch_spmv_orig.cuh: search -> consume -> fix-up):
//
//   1. search:  one thread per CTA tile binary-searches the merge path
//               of (row end offsets, nonzero indices) for the tile's
//               start coordinate (row, nz) (merge_path.cuh, shared
//               with K3).
//   2. consume: each CTA stages its tile's products vals * x[col] and
//               row end offsets in shared memory; each thread searches
//               its own start inside the tile and walks kItems merge
//               items serially, writing every row it completes. A
//               thread's first completed row may have begun in earlier
//               threads: a CTA-wide inclusive scan of (completed-a-row,
//               partial) pairs supplies that head. The last partial of
//               the CTA (its carry-out) goes to scratch with its row.
//   3. fix-up:  the first CTA of each run of carry-outs on the same row
//               adds the run, in CTA order, into y.
//
// No float atomics: every sum has a fixed order, so two runs give
// bitwise equal y. Empty rows, a row spanning many CTAs, rectangular
// matrices, nnz = 0 and n = 0 need no special path: the merge path
// covers num_rows + nnz items exactly and every row is completed once.
//
// Bound: bytes and gather latency. Per nonzero 8 B of column index and
// value stream once (12 B in float64); x is gathered (4 B, 8 B in
// float64, cached when columns cluster); per row 4 B of offsets and 4 B
// of y (8 B). Products and sums round separately (rn_arith.cuh). Equal work per CTA whatever the
// row lengths is what the merge path buys; the coalesced staging of the
// nonzero streams into shared memory is what keeps the streams at full
// width. Vector loads and a warp-level reduce-by-key are later work.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "merge_path.cuh"
#include "rn_arith.cuh"

namespace {

using tps_merge::Coord;
using tps_merge::kBlock;
using tps_merge::kItems;
using tps_merge::kSearchThreads;
using tps_merge::kTileItems;
using tps_merge::merge_path_search;
using tps_merge::merge_search_kernel;

template <typename T>
__global__ void __launch_bounds__(kBlock)
merge_consume_kernel(const int* __restrict__ row_offsets,
                     const int* __restrict__ col_indices,
                     const T* __restrict__ values, const T* __restrict__ x,
                     T* __restrict__ y, const Coord* __restrict__ coords,
                     int num_rows, int* __restrict__ carry_rows,
                     T* __restrict__ carry_vals) {
  // 15 KB of shared memory in float64, 10 KB in float32
  __shared__ int s_row_end[kTileItems + 1];
  __shared__ T s_prod[kTileItems];
  __shared__ int s_flag[2][kBlock];
  __shared__ T s_val[2][kBlock];

  const Coord start = coords[blockIdx.x];
  const Coord end = coords[blockIdx.x + 1];
  const int tile_rows = end.row - start.row;
  const int tile_nnz = end.nz - start.nz;
  const int tile_items = tile_rows + tile_nnz;
  const int t = threadIdx.x;

  for (int j = t; j < tile_nnz; j += kBlock) {
    const int g = start.nz + j;
    s_prod[j] = tps_rn::mul(values[g], __ldg(x + col_indices[g]));
  }
  // one entry past the tile's rows: the walk may test the row it ends
  // in; past the last row of the matrix nothing is left to consume
  for (int r = t; r <= tile_rows; r += kBlock) {
    const int g = start.row + r;
    s_row_end[r] = g < num_rows ? row_offsets[g + 1] : INT_MAX;
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
  for (int item = d0; item < d1; ++item) {
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

  // Inclusive scan of (flag, value) over the CTA's threads with
  // (a, b) -> (a.flag | b.flag, b.flag ? b.value : a.value + b.value):
  // the value of thread t is the partial of the row thread t ends in,
  // over every item of the CTA up to t's end.
  int f = has_first;
  T v = running;
  int buf = 0;
  s_flag[buf][t] = f;
  s_val[buf][t] = v;
  for (int off = 1; off < kBlock; off <<= 1) {
    __syncthreads();
    if (t >= off) {
      if (!f) v = tps_rn::add(s_val[buf][t - off], v);
      f |= s_flag[buf][t - off];
    }
    buf ^= 1;
    s_flag[buf][t] = f;
    s_val[buf][t] = v;
  }
  __syncthreads();
  if (has_first) {
    const T head = t > 0 ? s_val[buf][t - 1] : T(0);
    y[start.row + first_row] = tps_rn::add(head, first_val);
  }
  if (t == kBlock - 1) {
    carry_rows[blockIdx.x] = end.row;
    carry_vals[blockIdx.x] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSearchThreads)
merge_fixup_kernel(const int* __restrict__ carry_rows,
                   const T* __restrict__ carry_vals, int num_tiles,
                   int num_rows, T* __restrict__ y) {
  const int c = blockIdx.x * kSearchThreads + threadIdx.x;
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
        const void* x, void* y, void* tile_coords, void* carry_rows,
        void* carry_vals, int num_rows, int nnz, int num_tiles,
        void* stream) {
  if (!tps_merge::tile_count_ok(num_rows, nnz, num_tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ro = static_cast<const int*>(row_offsets);
  Coord* coords = static_cast<Coord*>(tile_coords);
  int* crow = static_cast<int*>(carry_rows);
  T* cval = static_cast<T*>(carry_vals);
  T* yv = static_cast<T*>(y);

  const int search_blocks = (num_tiles + 1 + kSearchThreads - 1) /
                            kSearchThreads;
  merge_search_kernel<<<search_blocks, kSearchThreads, 0, s>>>(
      ro, num_rows, nnz, num_tiles, coords);
  merge_consume_kernel<T><<<num_tiles, kBlock, 0, s>>>(
      ro, static_cast<const int*>(col_indices),
      static_cast<const T*>(values), static_cast<const T*>(x), yv, coords,
      num_rows, crow, cval);
  const int fixup_blocks = (num_tiles + kSearchThreads - 1) / kSearchThreads;
  merge_fixup_kernel<T><<<fixup_blocks, kSearchThreads, 0, s>>>(
      crow, cval, num_tiles, num_rows, yv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tps_merge_tile_items(void) { return kTileItems; }

// y (num_rows,) = A @ x for CSR (row_offsets, col_indices, values),
// float32 (K2). Scratch: tile_coords (num_tiles + 1 int pairs),
// carry_rows and carry_vals (num_tiles each), with num_tiles =
// ceil((num_rows + nnz) / tps_merge_tile_items()). Returns the
// cudaGetLastError() code after the three launches.
extern "C" int tps_merge_spmv(const void* row_offsets, const void* col_indices,
                              const void* values, const void* x, void* y,
                              void* tile_coords, void* carry_rows,
                              void* carry_vals, int num_rows, int nnz,
                              int num_tiles, void* stream) {
  return run<float>(row_offsets, col_indices, values, x, y, tile_coords,
                    carry_rows, carry_vals, num_rows, nnz, num_tiles, stream);
}

// The same in float64 (K2d): values, x, y and carry_vals are double.
extern "C" int tps_merge_spmv_f64(const void* row_offsets,
                                  const void* col_indices, const void* values,
                                  const void* x, void* y, void* tile_coords,
                                  void* carry_rows, void* carry_vals,
                                  int num_rows, int nnz, int num_tiles,
                                  void* stream) {
  return run<double>(row_offsets, col_indices, values, x, y, tile_coords,
                     carry_rows, carry_vals, num_rows, nnz, num_tiles,
                     stream);
}
