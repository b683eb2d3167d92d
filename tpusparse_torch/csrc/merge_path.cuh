// Merge-path partition: the merge-path search, shared by K2
// (merge_spmv.cu) and K3 (merge_spmm.cu), and K3's tile geometry and the
// search kernel that gives every K3 tile its start coordinate at each
// call (K2 has its own geometry and takes its tile starts from the
// plan).
//
// The merge path of a CSR matrix merges list A = the end offset of each
// row with list B = the nonzero indices 0 .. nnz-1; it has num_rows +
// nnz items, and a tile is kTileItems consecutive items. Where a tile
// starts depends only on the matrix, so one search serves every RHS
// lane of a call.

#pragma once

#include <cuda_runtime.h>

// Internal linkage: each translation unit that includes this header
// gets its own copy of the search kernel.
namespace tps_merge {
namespace {

constexpr int kBlock = 128;                   // threads per consume CTA
constexpr int kItems = 8;                     // merge items per thread
constexpr int kTileItems = kBlock * kItems;   // merge items per CTA
constexpr int kSearchThreads = 256;

struct Coord {
  int row;
  int nz;
};

// The split of merge-path diagonal `diag` between list A = row_end[0 ..
// a_len) (the end offset of each row) and list B = nz_begin, nz_begin+1,
// ... (b_len nonzero indices). A row end comes first on the path when it
// is <= the nonzero index it is compared with. Returns (rows, nonzeros)
// consumed before the diagonal.
__device__ __forceinline__ Coord merge_path_search(long long diag,
                                                   const int* row_end,
                                                   int a_len, int nz_begin,
                                                   int b_len) {
  long long lo = diag - b_len > 0 ? diag - b_len : 0;
  long long hi = diag < a_len ? diag : a_len;
  while (lo < hi) {
    const long long pivot = (lo + hi) >> 1;
    if (static_cast<long long>(row_end[pivot]) <=
        nz_begin + (diag - pivot - 1)) {
      lo = pivot + 1;
    } else {
      hi = pivot;
    }
  }
  return Coord{static_cast<int>(lo), static_cast<int>(diag - lo)};
}

// coords[t] = start of tile t, for t = 0 .. num_tiles (the last entry is
// the end of the path).
__global__ void __launch_bounds__(kSearchThreads)
merge_search_kernel(const int* __restrict__ row_offsets, int num_rows,
                    int nnz, int num_tiles, Coord* __restrict__ coords) {
  const int t = blockIdx.x * kSearchThreads + threadIdx.x;
  if (t > num_tiles) return;
  const long long total = static_cast<long long>(num_rows) + nnz;
  const long long tile_start = static_cast<long long>(t) * kTileItems;
  const long long diag = tile_start < total ? tile_start : total;
  coords[t] = merge_path_search(diag, row_offsets + 1, num_rows, 0, nnz);
}

// The tile count a caller must size its scratch for.
inline bool tile_count_ok(int num_rows, int nnz, int num_tiles) {
  const long long total = static_cast<long long>(num_rows) + nnz;
  return num_rows >= 0 && nnz >= 0 &&
         num_tiles == static_cast<int>((total + kTileItems - 1) / kTileItems);
}

}  // namespace
}  // namespace tps_merge
