// K3 — merge-path CSR SpMM for Hopper (sm_90a): Y (num_rows, L) = A X
// for X (num_cols, L), both row-major float32; and K3d, its float64 twin.
//
// K3 replaces the Pallas TPU kernel tpusparse/kernels/spmm_merge.py::
// _spmm_tiles (body _spmm_kernel). K3d replaces tpusparse/kernels/
// merge_df.py::_spmm_tiles_df (body _spmm_kernel_df), the same SpMM in
// double-float (two-f32) arithmetic because Mosaic has no 64-bit types;
// here values, X, Y, partials and carry-outs are IEEE float64. Those
// kernels stream the tile payload once for all L right-hand sides; so
// does this one. It is K2's pipeline (merge_spmv.cu) carried to L lanes:
//
//   1. search:  the tile start coordinates (merge_path.cuh), once per
//               call whatever L is: they depend only on the matrix.
//   2. consume: each CTA stages its tile's column indices, values and
//               row end offsets in shared memory once, then loops over
//               chunks of W lanes (W = the next power of two >= L, at
//               most 32). The CTA's threads form kBlock / W groups of W
//               threads; a group walks one stretch of the tile's merge
//               items serially with one RHS lane per thread, so each read
//               of X[col, l0 : l0 + W] is coalesced, and writes every row
//               it completes. A group's first completed row may have
//               begun in earlier groups: its head is the sum, in group
//               order, of the partials the earlier groups end with, back
//               to the last group that completed a row. The CTA's
//               carry-out, one per lane, goes to scratch with its row.
//   3. fix-up:  per (run of carry-outs on one row, lane), the first CTA
//               of the run adds the run, in CTA order, into Y.
//
// No float atomics: every sum has a fixed order, so two runs give
// bitwise equal Y. Products and sums round separately (no FMA
// contraction, rn_arith.cuh), as in the plain version.
//
// The TPU kernel's MXU prefix scan, its (L, 128) lane blocks, the lane
// padding to multiples of 8, the VMEM lane chunking and the overflow COO
// stream have no counterpart: a lane chunk here is a loop inside the CTA
// over the payload already in shared memory.
//
// Bound: bytes. Per nonzero 8 B of column index and value stream once
// for all L lanes (12 B in float64); X is gathered 4 L B per nonzero
// (8 L B in float64; cached when columns cluster, so about once per row
// of X); Y is written 4 L B per row (8 L B). At
// L = 16 the X and Y streams outweigh the payload, and the gather of
// X rows is what the design keeps coalesced. Index arithmetic on X, Y
// and the carry-outs is 64-bit: n L passes 2^31 at real sizes.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "merge_path.cuh"
#include "rn_arith.cuh"

namespace {

using tps_merge::Coord;
using tps_merge::kBlock;
using tps_merge::kSearchThreads;
using tps_merge::kTileItems;
using tps_merge::merge_path_search;
using tps_merge::merge_search_kernel;

constexpr int kMaxLaneWidth = 32;

// The partial that the groups lo .. hi-1 contribute to the row in
// progress at the end of group hi-1: the sum, in group order, of their
// end partials from the last group in [lo, hi) that completed a row.
template <typename T>
__device__ __forceinline__ T run_partial(const T* s_run, const int* s_done,
                                         int hi, int lane, int log2w) {
  int k = hi - 1;
  while (k > 0 && !s_done[k]) --k;
  T s = T(0);
  for (int j = k < 0 ? 0 : k; j < hi; ++j) {
    s = tps_rn::add(s, s_run[(j << log2w) + lane]);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
merge_spmm_consume_kernel(const int* __restrict__ row_offsets,
                          const int* __restrict__ col_indices,
                          const T* __restrict__ values,
                          const T* __restrict__ X, T* __restrict__ Y,
                          const Coord* __restrict__ coords, int num_rows,
                          int L, int log2w, int* __restrict__ carry_rows,
                          T* __restrict__ carry_vals) {
  // 18 KB of shared memory in float64, 13 KB in float32
  __shared__ int s_row_end[kTileItems + 1];
  __shared__ int s_col[kTileItems];
  __shared__ T s_val[kTileItems];
  __shared__ T s_run[kBlock];       // (group, lane): partial at group end
  __shared__ int s_done[kBlock];    // group: completed at least one row

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

  for (int j = t; j < tile_nnz; j += kBlock) {
    s_col[j] = col_indices[start.nz + j];
    s_val[j] = values[start.nz + j];
  }
  // one entry past the tile's rows: a walk may test the row it ends in;
  // past the last row of the matrix nothing is left to consume
  for (int r = t; r <= tile_rows; r += kBlock) {
    const int gr = start.row + r;
    s_row_end[r] = gr < num_rows ? row_offsets[gr + 1] : INT_MAX;
  }
  if (t == 0) carry_rows[blockIdx.x] = end.row;
  __syncthreads();

  const int per_group = kTileItems / G;
  const int d0 = g * per_group < tile_items ? g * per_group : tile_items;
  const int d1 = d0 + per_group < tile_items ? d0 + per_group : tile_items;
  const Coord c = merge_path_search(d0, s_row_end, tile_rows, start.nz,
                                    tile_nnz);

  for (int l0 = 0; l0 < L; l0 += W) {
    const int l = l0 + lane;
    const bool active = l < L;
    int row = c.row;  // local to the tile
    int nz = c.nz;
    T running = T(0);
    int done = 0;
    int first_row = 0;
    T first_val = T(0);
    for (int item = d0; item < d1; ++item) {
      if (start.nz + nz < s_row_end[row]) {
        const T xv =
            active ? __ldg(X + static_cast<long long>(s_col[nz]) * L + l)
                   : T(0);
        running = tps_rn::add(running, tps_rn::mul(s_val[nz], xv));
        ++nz;
      } else {
        if (done) {
          if (active) {
            Y[static_cast<long long>(start.row + row) * L + l] = running;
          }
        } else {
          done = 1;
          first_row = row;
          first_val = running;
        }
        running = T(0);
        ++row;
      }
    }
    s_run[t] = running;
    if (lane == 0) s_done[g] = done;
    __syncthreads();
    if (done && active) {
      const T head =
          g > 0 ? run_partial(s_run, s_done, g, lane, log2w) : T(0);
      Y[static_cast<long long>(start.row + first_row) * L + l] =
          tps_rn::add(head, first_val);
    }
    if (g == G - 1 && active) {
      carry_vals[static_cast<long long>(blockIdx.x) * L + l] =
          run_partial(s_run, s_done, G, lane, log2w);
    }
    __syncthreads();  // s_run and s_done are rewritten by the next chunk
  }
}

template <typename T>
__global__ void __launch_bounds__(kSearchThreads)
merge_spmm_fixup_kernel(const int* __restrict__ carry_rows,
                        const T* __restrict__ carry_vals, int num_tiles,
                        int num_rows, int L, T* __restrict__ Y) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kSearchThreads + threadIdx.x;
  if (idx >= static_cast<long long>(num_tiles) * L) return;
  const int c = static_cast<int>(idx / L);
  const int l = static_cast<int>(idx % L);
  const int r = carry_rows[c];
  if (r >= num_rows || (c > 0 && carry_rows[c - 1] == r)) return;
  T s = carry_vals[idx];
  for (int k = c + 1; k < num_tiles && carry_rows[k] == r; ++k) {
    s = tps_rn::add(s, carry_vals[static_cast<long long>(k) * L + l]);
  }
  const long long yi = static_cast<long long>(r) * L + l;
  Y[yi] = tps_rn::add(Y[yi], s);
}

template <typename T>
int run(const void* row_offsets, const void* col_indices, const void* values,
        const void* X, void* Y, void* tile_coords, void* carry_rows,
        void* carry_vals, int num_rows, int nnz, int num_tiles, int L,
        void* stream) {
  if (L < 1 || !tps_merge::tile_count_ok(num_rows, nnz, num_tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles == 0) return 0;
  int log2w = 0;
  while ((1 << log2w) < L && (1 << log2w) < kMaxLaneWidth) ++log2w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ro = static_cast<const int*>(row_offsets);
  Coord* coords = static_cast<Coord*>(tile_coords);
  int* crow = static_cast<int*>(carry_rows);
  T* cval = static_cast<T*>(carry_vals);
  T* Yv = static_cast<T*>(Y);

  const int search_blocks = (num_tiles + 1 + kSearchThreads - 1) /
                            kSearchThreads;
  merge_search_kernel<<<search_blocks, kSearchThreads, 0, s>>>(
      ro, num_rows, nnz, num_tiles, coords);
  merge_spmm_consume_kernel<T><<<num_tiles, kBlock, 0, s>>>(
      ro, static_cast<const int*>(col_indices),
      static_cast<const T*>(values), static_cast<const T*>(X), Yv, coords,
      num_rows, L, log2w, crow, cval);
  const long long fix_threads = static_cast<long long>(num_tiles) * L;
  const unsigned fixup_blocks = static_cast<unsigned>(
      (fix_threads + kSearchThreads - 1) / kSearchThreads);
  merge_spmm_fixup_kernel<T><<<fixup_blocks, kSearchThreads, 0, s>>>(
      crow, cval, num_tiles, num_rows, L, Yv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Y (num_rows, L) = A @ X (num_cols, L) for CSR (row_offsets,
// col_indices, values), row-major float32 (K3). Scratch: tile_coords
// (num_tiles + 1 int pairs), carry_rows (num_tiles) and carry_vals
// (num_tiles, L), with num_tiles = ceil((num_rows + nnz) /
// tps_merge_tile_items()). Returns the cudaGetLastError() code after the
// three launches.
extern "C" int tps_merge_spmm(const void* row_offsets, const void* col_indices,
                              const void* values, const void* X, void* Y,
                              void* tile_coords, void* carry_rows,
                              void* carry_vals, int num_rows, int nnz,
                              int num_tiles, int L, void* stream) {
  return run<float>(row_offsets, col_indices, values, X, Y, tile_coords,
                    carry_rows, carry_vals, num_rows, nnz, num_tiles, L,
                    stream);
}

// The same in float64 (K3d): values, X, Y and carry_vals are double.
extern "C" int tps_merge_spmm_f64(const void* row_offsets,
                                  const void* col_indices, const void* values,
                                  const void* X, void* Y, void* tile_coords,
                                  void* carry_rows, void* carry_vals,
                                  int num_rows, int nnz, int num_tiles, int L,
                                  void* stream) {
  return run<double>(row_offsets, col_indices, values, X, Y, tile_coords,
                     carry_rows, carry_vals, num_rows, nnz, num_tiles, L,
                     stream);
}
