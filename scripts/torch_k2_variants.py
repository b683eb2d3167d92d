"""Write the variant trees of K2's A/B (``scripts/torch_k2_ab.py``).

Each variant is a copy of this tree's ``tpusparse_torch`` package with
``csrc/merge_spmv.cu`` (and, for a geometry, ``kernels/merge_spmv.py``'s
``TILE_ITEMS``) changed in one respect, so that a design step is timed
against the kernel without it:

  search   the tile starts searched again at every call, by one thread a
           tile, into the plan's buffer (step 2 undone);
  loop     the staging as a strided loop, one gather in flight per
           thread (step 3 undone);
  ldcs     step 3 with streaming loads (``__ldcs``, evict-first) of the
           column indices, values and row ends;
  cpasync  step 3 with the column indices and values copied into shared
           memory by ``cp.async``, then the gathers;
  hs       the CTA scan as a Hillis-Steele scan in shared memory, a
           barrier a round (step 4 undone);
  gTxI     T threads per CTA and I merge items per thread (step 5);
  bI       I merge items per thread, staged in batches of 8 (the loads
           of a batch, then its gathers, then its stores);
  lbN      ``__launch_bounds__(kThreads, N)`` on the consume kernel (at
           least N CTAs of it on an SM), lbfN the same for float32 only;
  fixb     the fix-up loading a run's carry-outs 16 at a time (the same
           additions in the same order);
  a+b      variant a, then variant b.

    python3 scripts/torch_k2_variants.py build/ab search loop hs g256x8
"""

import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SEARCH_KERNEL = '''
__global__ void __launch_bounds__(kFixupThreads)
k2_search_kernel(const int* __restrict__ row_offsets, int num_rows,
                 int nnz, int num_tiles, Coord* __restrict__ coords) {
  const int t = blockIdx.x * kFixupThreads + threadIdx.x;
  if (t > num_tiles) return;
  const long long total = static_cast<long long>(num_rows) + nnz;
  const long long tile_start = static_cast<long long>(t) * kTileItems;
  const long long diag = tile_start < total ? tile_start : total;
  coords[t] = merge_path_search(diag, row_offsets + 1, num_rows, 0, nnz);
}

template <typename T>
int run('''

SEARCH_LAUNCH = '''  k2_search_kernel<<<(num_tiles + kFixupThreads) / kFixupThreads,
                     kFixupThreads, 0, s>>>(
      static_cast<const int*>(row_offsets), num_rows, nnz, num_tiles,
      static_cast<Coord*>(const_cast<void*>(tile_coords)));
  merge_consume_kernel<T><<<'''

STAGING_START = "  int col[kItems];\n"
STAGING_END = "  __syncthreads();\n\n  const int d0"

LOOP_STAGING = '''  for (int j = t; j < tile_nnz; j += kThreads) {
    const int g = start.nz + j;
    s_prod[j] = tps_rn::mul(values[g], __ldg(x + col_indices[g]));
  }
  for (int r = t; r <= tile_rows; r += kThreads) {
    const int g = start.row + r;
    s_row_end[r] = g < num_rows ? row_offsets[g + 1] : INT_MAX;
  }
'''

CP_ASYNC_HELPERS = '''
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\\n" ::"r"(s),
                 "l"(gmem));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_consume_kernel('''

CP_ASYNC_STAGING = '''  __shared__ int s_col[kTileItems];
  __shared__ T s_val[kTileItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t + k * kThreads;
    if (j < tile_nnz) {
      cp_async(s_col + j, col_indices + start.nz + j, 4);
      cp_async(s_val + j, values + start.nz + j, sizeof(T));
    }
  }
  asm volatile("cp.async.commit_group;\\n" ::);
  int row_end[kItems + 1];
#pragma unroll
  for (int k = 0; k <= kItems; ++k) {
    const int r = t + k * kThreads;
    const int g = start.row + r;
    row_end[k] = r <= tile_rows && g < num_rows ? row_offsets[g + 1]
                                                : INT_MAX;
  }
  asm volatile("cp.async.wait_all;\\n" ::: "memory");
  T xv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t + k * kThreads;
    xv[k] = j < tile_nnz ? __ldg(x + s_col[j]) : T(0);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = t + k * kThreads;
    if (j < tile_nnz) s_prod[j] = tps_rn::mul(s_val[j], xv[k]);
  }
#pragma unroll
  for (int k = 0; k <= kItems; ++k) {
    const int r = t + k * kThreads;
    if (r <= tile_rows) s_row_end[r] = row_end[k];
  }
'''

SCAN_START = "  const int lane = t & 31;\n"
SCAN_END = "    carry_vals[blockIdx.x] = f ? v : tps_rn::add(pv, v);\n  }\n"

HS_SCAN = '''  __shared__ int s_flag[2][kThreads];
  __shared__ T s_val[2][kThreads];
  int f = has_first;
  T v = running;
  int buf = 0;
  s_flag[buf][t] = f;
  s_val[buf][t] = v;
  for (int off = 1; off < kThreads; off <<= 1) {
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
  if (t == kThreads - 1) {
    carry_rows[blockIdx.x] = end.row;
    carry_vals[blockIdx.x] = v;
  }
'''


BATCHED_STAGING = '''  constexpr int kBatch = 8;
#pragma unroll
  for (int b = 0; b < kItems; b += kBatch) {
    const bool last = b + kBatch == kItems;
    int col[kBatch];
    T val[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = t + (b + k) * kThreads;
      col[k] = j < tile_nnz ? col_indices[start.nz + j] : 0;
      val[k] = j < tile_nnz ? values[start.nz + j] : T(0);
    }
    int row_end[kBatch + 1];
#pragma unroll
    for (int k = 0; k <= kBatch; ++k) {
      const int r = t + (b + k) * kThreads;
      const int g = start.row + r;
      row_end[k] = (k < kBatch || last) && r <= tile_rows && g < num_rows
                       ? row_offsets[g + 1]
                       : INT_MAX;
    }
    T xv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      xv[k] = t + (b + k) * kThreads < tile_nnz ? __ldg(x + col[k]) : T(0);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int j = t + (b + k) * kThreads;
      if (j < tile_nnz) s_prod[j] = tps_rn::mul(val[k], xv[k]);
    }
#pragma unroll
    for (int k = 0; k <= kBatch; ++k) {
      const int r = t + (b + k) * kThreads;
      if ((k < kBatch || last) && r <= tile_rows) s_row_end[r] = row_end[k];
    }
  }
'''

FIXUP_START = "template <typename T>\n__global__ void __launch_bounds__(kFixupThreads)"
FIXUP_END = "template <typename T>\nint run("

BATCHED_FIXUP = '''// The first tile of each run of carry-outs on one row adds the run, in
// tile order, into y. A row spanning many tiles (a hub) makes a long run:
// its rows and values are loaded kFixupBatch at a time, so the loads of a
// batch are in flight together; the additions keep the tile order.
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
  // carry rows never decrease along the tiles: the run ends at the
  // first other row
  for (int k0 = c + 1; k0 < num_tiles; k0 += kFixupBatch) {
    int in_run[kFixupBatch];
#pragma unroll
    for (int i = 0; i < kFixupBatch; ++i) {
      in_run[i] = k0 + i < num_tiles && carry_rows[k0 + i] == r;
    }
    T v[kFixupBatch];
#pragma unroll
    for (int i = 0; i < kFixupBatch; ++i) {
      v[i] = in_run[i] ? carry_vals[k0 + i] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kFixupBatch; ++i) {
      if (in_run[i]) s = tps_rn::add(s, v[i]);
    }
    if (!in_run[kFixupBatch - 1]) break;
  }
  y[r] = tps_rn::add(y[r], s);
}

'''

CONSUME_BOUNDS = "__launch_bounds__(kThreads)\nmerge_consume_kernel("


def _items(cu: str, py: str, threads: int | None, items: int):
    n1 = 1
    if threads is not None:
        cu, n1 = re.subn(r"constexpr int kThreads = \d+;",
                         f"constexpr int kThreads = {threads};", cu)
    threads = int(re.search(r"constexpr int kThreads = (\d+);", cu)[1])
    cu, n2 = re.subn(r"constexpr int kItems = \d+;",
                     f"constexpr int kItems = {items};", cu)
    py, n3 = re.subn(r"^TILE_ITEMS = \d+$",
                     f"TILE_ITEMS = {threads * items}", py, flags=re.M)
    if (n1, n2, n3) != (1, 1, 1):
        raise SystemExit("geometry patch does not apply")
    return cu, py


def _once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"variant patch does not apply: {old[:60]!r}")
    return text.replace(old, new)


def _between(text: str, start: str, end: str, new: str,
             keep_end: bool = True) -> str:
    i = text.index(start)
    j = text.index(end, i)
    return text[:i] + new + (text[j:] if keep_end else text[j + len(end):])


def variant(cu: str, py: str, name: str) -> tuple[str, str]:
    if "+" in name:
        for part in name.split("+"):
            cu, py = variant(cu, py, part)
        return cu, py
    if name == "search":
        cu = _once(cu, "\ntemplate <typename T>\nint run(", SEARCH_KERNEL)
        cu = _once(cu, "  merge_consume_kernel<T><<<", SEARCH_LAUNCH)
    elif name == "loop":
        cu = _between(cu, STAGING_START, STAGING_END, LOOP_STAGING)
    elif name == "ldcs":
        for old, new in (("col_indices[start.nz + j]",
                          "__ldcs(col_indices + start.nz + j)"),
                         ("values[start.nz + j]",
                          "__ldcs(values + start.nz + j)"),
                         ("row_offsets[g + 1]", "__ldcs(row_offsets + g + 1)")):
            cu = _once(cu, old, new)
    elif name == "cpasync":
        cu = _once(cu, "\ntemplate <typename T>\n__global__ void "
                   "__launch_bounds__(kThreads)\nmerge_consume_kernel(",
                   CP_ASYNC_HELPERS)
        cu = _between(cu, STAGING_START, STAGING_END, CP_ASYNC_STAGING)
    elif name == "hs":
        cu = _between(cu, SCAN_START, SCAN_END, HS_SCAN, keep_end=False)
    elif m := re.fullmatch(r"g(\d+)x(\d+)", name):
        cu, py = _items(cu, py, int(m[1]), int(m[2]))
    elif m := re.fullmatch(r"b(\d+)", name):
        cu, py = _items(cu, py, None, int(m[1]))
        cu = _between(cu, STAGING_START, STAGING_END, BATCHED_STAGING)
    elif name == "fixb":
        cu = _once(cu, "constexpr int kFixupThreads = 256;\n",
                   "constexpr int kFixupThreads = 256;\n"
                   "constexpr int kFixupBatch = 16;\n")
        cu = _between(cu, FIXUP_START, FIXUP_END, BATCHED_FIXUP)
    elif m := re.fullmatch(r"lb(f?)(\d+)", name):
        blocks = f"sizeof(T) == 4 ? {m[2]} : 1" if m[1] else m[2]
        cu = _once(cu, CONSUME_BOUNDS, "__launch_bounds__(kThreads, "
                   f"{blocks})\nmerge_consume_kernel(")
    else:
        raise SystemExit(f"unknown variant {name}")
    return cu, py


def main() -> None:
    out = Path(sys.argv[1])
    for name in sys.argv[2:]:
        tree = out / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(ROOT / "tpusparse_torch", tree / "tpusparse_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu_path = tree / "tpusparse_torch" / "csrc" / "merge_spmv.cu"
        py_path = tree / "tpusparse_torch" / "kernels" / "merge_spmv.py"
        cu, py = variant(cu_path.read_text(), py_path.read_text(), name)
        cu_path.write_text(cu)
        py_path.write_text(py)
        print(f"{tree}: {name}")


if __name__ == "__main__":
    main()
