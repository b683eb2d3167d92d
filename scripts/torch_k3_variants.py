"""Write the variant trees of K3's A/B (``scripts/torch_k3_ab.py``).

Each variant is a copy of this tree's ``tpusparse_torch`` package with
``csrc/merge_spmm.cu`` (and, where the geometry changes, the mirror in
``kernels/spmm_merge.py``) changed in one respect, so that a design step
is timed against the kernel without it, or a variant against the design:

  search   the tile starts searched again at every call, one thread a
           tile, into the plan's buffer (step 1 undone: three launches);
  loop     the walk one merge item at a time, one X gather in flight per
           thread (step 2 undone);
  fixb     the fix-up loading a run's carry-outs 16 at a time (the same
           additions in the same order);
  fixc     fixb only where the run has a second carry-out (a run of one
           loads nothing more);
  v32      32 bytes of lanes a thread where they divide L (two 16-byte
           loads a gather; the stretches halve, the order of additions
           changes);
  bN       N X gathers in flight a thread instead of 8;
  g256     256 threads per consume CTA (4 payload entries a thread; the
           group stretches halve, the order of additions changes);
  cpasync  the column indices and values staged into shared memory by
           ``cp.async`` (no register round trip), then the row ends;
  a+b      variant a, then variant b.

    python3 scripts/torch_k3_variants.py build/ab search loop fixb v32+b4
"""

import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SEARCH_KERNEL = '''
__global__ void __launch_bounds__(kFixupThreads)
k3_search_kernel(const int* __restrict__ row_offsets, int num_rows,
                 int nnz, int num_tiles, Coord* __restrict__ coords) {
  const int t = blockIdx.x * kFixupThreads + threadIdx.x;
  if (t > num_tiles) return;
  const long long total = static_cast<long long>(num_rows) + nnz;
  const long long tile_start = static_cast<long long>(t) * kTileItems;
  const long long diag = tile_start < total ? tile_start : total;
  coords[t] = merge_path_search(diag, row_offsets + 1, num_rows, 0, nnz);
}

// Lanes per thread at L'''

SEARCH_LAUNCH = '''  k3_search_kernel<<<(num_tiles + kFixupThreads) /
                     kFixupThreads, kFixupThreads, 0, s>>>(
      ro, num_rows, nnz, num_tiles, const_cast<Coord*>(coords));
  if (V == 1) {'''

WALK_START = "    for (int j0 = c.nz; j0 < e.nz; j0 += kBatch) {\n"
WALK_END = "    while (row < e.row) complete_row();\n"

LOOP_WALK = '''    int nz = c.nz;
    for (int item = d0; item < d1; ++item) {
      if (start.nz + nz < s_row_end[row]) {
        const Vec xv =
            active ? load_lanes<T, V>(
                         X + static_cast<long long>(s_col[nz]) * L + l)
                   : zeros<T, V>();
        const T a = s_val[nz];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          running.v[i] = tps_rn::add(running.v[i], tps_rn::mul(a, xv.v[i]));
        }
        ++nz;
      } else {
        complete_row();
      }
    }
'''

FIXUP_START = "  T s = carry_vals[idx];\n"
FIXUP_END = "  const long long yi ="

BATCHED_FIXUP = '''  T s = carry_vals[idx];
  constexpr int kFixupBatch = 16;
  // tile starts never go back a row: the run ends at the first other row
  for (int k0 = c + 1; k0 < num_tiles; k0 += kFixupBatch) {
    bool in_run[kFixupBatch];
#pragma unroll
    for (int i = 0; i < kFixupBatch; ++i) {
      in_run[i] = k0 + i < num_tiles && coords[k0 + i + 1].row == r;
    }
    T v[kFixupBatch];
#pragma unroll
    for (int i = 0; i < kFixupBatch; ++i) {
      v[i] = in_run[i] ? carry_vals[static_cast<long long>(k0 + i) * L + l]
                       : T(0);
    }
#pragma unroll
    for (int i = 0; i < kFixupBatch; ++i) {
      if (in_run[i]) s = tps_rn::add(s, v[i]);
    }
    if (!in_run[kFixupBatch - 1]) break;
  }
'''

CP_ASYNC_HELPER = '''
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

template <typename T, int V>
__global__ void __launch_bounds__(kBlock)
merge_spmm_consume_kernel('''

STAGING_START = "  int col[kStage];\n"
STAGING_END = "  __syncthreads();\n\n  // the group's stretch"

CP_ASYNC_STAGING = '''#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int j = t + k * kBlock;
    if (j < tile_nnz) {
      cp_async(s_col + j, col_indices + start.nz + j, 4);
      cp_async(s_val + j, values + start.nz + j, sizeof(T));
    }
  }
  asm volatile("cp.async.commit_group;\\n" ::);
  int row_end[kStage + 1];
#pragma unroll
  for (int k = 0; k <= kStage; ++k) {
    const int r = t + k * kBlock;
    const int gr = start.row + r;
    row_end[k] = r <= tile_rows && gr < num_rows ? row_offsets[gr + 1]
                                                 : INT_MAX;
  }
#pragma unroll
  for (int k = 0; k <= kStage; ++k) {
    const int r = t + k * kBlock;
    if (r <= tile_rows) s_row_end[r] = row_end[k];
  }
  asm volatile("cp.async.wait_all;\\n" ::: "memory");
'''


WIDE_LOAD_START = "// V lanes from p: one load, or one 16-byte load"
WIDE_LOAD_END = ("template <typename T, int V>\n"
                 "__device__ __forceinline__ void add_to")

WIDE_LOAD = '''// V lanes from p: one load, or V sizeof(T) / 16 loads of 16 bytes (p
// 16-byte aligned).
template <typename T, int V>
__device__ __forceinline__ Lanes<T, V> load_lanes(const T* p) {
  Lanes<T, V> out;
  if constexpr (V == 1) {
    out.v[0] = __ldg(p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V % 4 == 0, "16-byte lanes");
#pragma unroll
    for (int c = 0; c < V / 4; ++c) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + c);
      out.v[4 * c] = q.x;
      out.v[4 * c + 1] = q.y;
      out.v[4 * c + 2] = q.z;
      out.v[4 * c + 3] = q.w;
    }
  } else {
    static_assert(V % 2 == 0, "16-byte lanes");
#pragma unroll
    for (int c = 0; c < V / 2; ++c) {
      const double2 q = __ldg(reinterpret_cast<const double2*>(p) + c);
      out.v[2 * c] = q.x;
      out.v[2 * c + 1] = q.y;
    }
  }
  return out;
}

'''


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
        cu = _once(cu, "\n// Lanes per thread at L", SEARCH_KERNEL)
        cu = _once(cu, "  if (V == 1) {", SEARCH_LAUNCH)
    elif name == "loop":
        cu = _between(cu, WALK_START, WALK_END, LOOP_WALK, keep_end=False)
    elif name in ("fixb", "fixc"):
        fixup = BATCHED_FIXUP
        if name == "fixc":
            fixup = fixup.replace(
                "  for (int k0", "  if (c + 1 < num_tiles && coords[c + 2]."
                "row == r)\n  for (int k0")
        cu = _between(cu, FIXUP_START, FIXUP_END, fixup)
    elif name == "v32":
        cu = _once(cu, "constexpr int kLaneBytes = 16;",
                   "constexpr int kLaneBytes = 32;")
        cu = _between(cu, WIDE_LOAD_START, WIDE_LOAD_END, WIDE_LOAD)
        py = _once(py, "LANE_BYTES = 16", "LANE_BYTES = 32")
    elif m := re.fullmatch(r"b(\d+)", name):
        cu = _once(cu, "constexpr int kBatch = 8;",
                   f"constexpr int kBatch = {m[1]};")
    elif name == "g256":
        cu = _once(cu, "constexpr int kBlock = 128;",
                   "constexpr int kBlock = 256;")
        py = _once(py, "BLOCK_THREADS = 128", "BLOCK_THREADS = 256")
    elif name == "cpasync":
        cu = _once(cu, "\ntemplate <typename T, int V>\n__global__ void "
                   "__launch_bounds__(kBlock)\nmerge_spmm_consume_kernel(",
                   CP_ASYNC_HELPER)
        cu = _between(cu, STAGING_START, STAGING_END, CP_ASYNC_STAGING)
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
        cu_path = tree / "tpusparse_torch" / "csrc" / "merge_spmm.cu"
        py_path = tree / "tpusparse_torch" / "kernels" / "spmm_merge.py"
        cu, py = variant(cu_path.read_text(), py_path.read_text(), name)
        cu_path.write_text(cu)
        py_path.write_text(py)
        print(f"{tree}: {name}")


if __name__ == "__main__":
    main()
