// Host C++ of the IC(0) preconditioner: the factorization and the
// dependency levels of a triangular factor. Nothing here runs on the
// card; it lives in the kernels' library because that library is the
// port's one native build (kernels/_build.py compiles it with nvcc's host
// compiler).
//
// tps_ic0_factorize is the up-looking IC(0) of tpusparse_torch/precond/
// ic0.py::_try_factorize with its diagonal-shift retries (the JAX
// package's native/src/ic0.cpp computes the same): the pattern is the
// lower triangle of A with sorted columns, so each row's diagonal is its
// last entry; entry (i, k) subtracts the sorted-merge dot of rows i and k
// over the columns before k; a pivot <= 0 restarts from the original
// values with a diagonal shift of initial_shift, growing 10x per retry.
// The factorization is sequential over rows; what the native loop buys
// over the Python one is the inner merge (lap3d-128's 8.4 M lower-
// triangle entries take minutes in Python).
//
// tps_tri_levels gives each row of a triangular CSR its level:
// 1 + the largest level of its strict dependencies, one walk in
// dependency order (ascending rows for a lower factor, descending for an
// upper one), as tpusparse_torch/precond/trisolve.py::_dependency_levels
// does with numpy frontiers.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// In: the lower-triangle pattern (row_offsets (n + 1), col_indices, int64,
// columns sorted, diagonal last in each row) and its values vals_in.
// Out: the factor L in vals_out. Returns the number of attempts used
// (>= 1), or 0 when every attempt broke down.
int tps_ic0_factorize(int64_t n, const int64_t* row_offsets,
                      const int64_t* col_indices, const double* vals_in,
                      double* vals_out, int max_attempts,
                      double initial_shift) {
  const int64_t nnz = row_offsets[n];
  double shift = 0.0;
  for (int attempt = 0; attempt < max_attempts; ++attempt) {
    std::memcpy(vals_out, vals_in, sizeof(double) * nnz);
    if (attempt > 0) {
      for (int64_t i = 0; i < n; ++i) {
        const int64_t last = row_offsets[i + 1] - 1;
        if (last >= row_offsets[i] && col_indices[last] == i) {
          vals_out[last] += shift;
        }
      }
    }
    bool failed = false;
    for (int64_t i = 0; i < n && !failed; ++i) {
      for (int64_t k_off = row_offsets[i]; k_off < row_offsets[i + 1];
           ++k_off) {
        const int64_t k = col_indices[k_off];
        double s = 0.0;
        int64_t jl = row_offsets[i];
        int64_t jk = row_offsets[k];
        const int64_t end_k = row_offsets[k + 1];
        while (jl < k_off && jk < end_k) {
          const int64_t cl = col_indices[jl];
          const int64_t ck = col_indices[jk];
          if (cl == ck) {
            s += vals_out[jl] * vals_out[jk];
            ++jl;
            ++jk;
          } else if (cl < ck) {
            ++jl;
          } else {
            ++jk;
          }
        }
        vals_out[k_off] -= s;
        if (k == i) {
          if (vals_out[k_off] <= 0.0) {
            failed = true;
            break;
          }
          vals_out[k_off] = std::sqrt(vals_out[k_off]);
        } else {
          vals_out[k_off] /= vals_out[row_offsets[k + 1] - 1];
        }
      }
    }
    if (!failed) return attempt + 1;
    shift = shift == 0.0 ? initial_shift : shift * 10.0;
  }
  return 0;
}

// Levels of a triangular CSR (row_offsets int64 (n + 1), col_indices
// int32): lower != 0 for a lower factor (dependencies j < i), 0 for an
// upper one (j > i). Writes out_level (n,) and returns the number of
// levels (1 for n = 0).
int tps_tri_levels(int64_t n, const int64_t* row_offsets,
                   const int32_t* col_indices, int lower,
                   int32_t* out_level) {
  int32_t nlev = 1;
  for (int64_t t = 0; t < n; ++t) {
    const int64_t i = lower ? t : n - 1 - t;
    int32_t lv = 0;
    for (int64_t s = row_offsets[i]; s < row_offsets[i + 1]; ++s) {
      const int64_t j = col_indices[s];
      if (j != i && out_level[j] + 1 > lv) lv = out_level[j] + 1;
    }
    out_level[i] = lv;
    if (lv + 1 > nlev) nlev = lv + 1;
  }
  return nlev;
}

}  // extern "C"
