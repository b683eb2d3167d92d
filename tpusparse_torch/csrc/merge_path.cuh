// Merge-path partition: the search shared by K2 (merge_spmv.cu) and K3
// (merge_spmm.cu).
//
// The merge path of a CSR matrix merges list A = the end offset of each
// row with list B = the nonzero indices 0 .. nnz-1; it has num_rows +
// nnz items, and a CTA tile is a run of consecutive items. Where each
// tile starts depends only on the matrix, so the plan finds every tile
// start once, on the host (kernels/merge_spmv.py::merge_tile_coords), and
// no call searches for them. Inside a tile, each thread (K2) or thread
// group (K3) finds its own start with this search over the tile's row
// ends, staged in shared memory.

#pragma once

#include <cuda_runtime.h>

// Internal linkage: each translation unit that includes this header
// gets its own copy.
namespace tps_merge {
namespace {

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

}  // namespace
}  // namespace tps_merge
