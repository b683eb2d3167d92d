"""Write the variant trees of K7's A/B (``scripts/torch_k7_ab.py``).

Each variant is a copy of this tree's ``tpusparse_torch`` package with
``csrc/dia_nmajor.cu`` (and, where the geometry changes,
``kernels/dia_nmajor.py``) changed in one respect, so that a design
step is timed against the kernel without it, or a variant against the
design:

  sub4, sub8
           a CTA walks four sub-blocks (step 4 as first designed, round
           1's "new"), or eight;
  v1       lane groups of one value whatever L (step 1's vectors undone);
  rows1, rows2, rows8
           1, 2 or 8 rows a thread;
  rwin     (on consec) where three planes lie at consecutive offsets
           (the +-1 planes around the diagonal), one window of R + 2 rows
           of x serves all three instead of 3 R loads;
  consec   a thread's R rows consecutive (rounds 1-2's design, step 1's
           row slots undone), its mask words in one 16-byte load;
  smem     (on consec) at V = 4: a sub-block's window of x, its rows
           and h rows on
           either side (h the largest |offset| within kHaloBytes), staged
           in shared memory by one 1-D bulk copy (cp.async.bulk, TMA) on
           an mbarrier; the planes within h read it, the others global
           memory;
  t128     128 threads a CTA;
  cs       streaming stores of Y (st.global.cs);
  a+b      variant a, then variant b.

    python3 scripts/torch_k7_variants.py build/ab sub4 rows2 consec+smem

Every variant computes the same products and sums in the same order, so
its Y equals the design's bit for bit. Round 1 of the A/B (PERF.md §6)
ran on the first design (``consec+sub4``), round 2 on ``consec``, each
with the variants of its day on top (round 2's ``stride`` is this
tree); round 1's trees also carried K6 variants of a K6 design that was
tried and dropped (2, 4 or 8 gathers a thread and a scatter through the
inverse), and its variants went with it.
"""

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

K7_PLANE_LOOP = """    for (int k = 0; k < p.K; ++k) {
      const long long j0 = i0 + p.offsets[k];
      float xv[kRows][V];
"""
K7_RWIN = """    for (int k = 0; k < p.K; ++k) {
      const long long j0 = i0 + p.offsets[k];
      if (k + 2 < p.K && p.offsets[k + 1] == p.offsets[k] + 1 &&
          p.offsets[k + 2] == p.offsets[k] + 2) {
        float xw[kRows + 2][V];
        if (j0 >= 0 && j0 + kRows + 2 <= n) {
#pragma unroll
          for (int q = 0; q < kRows + 2; ++q) {
            Lanes<V>::unpack(
                __ldg(reinterpret_cast<const VT*>(x + (j0 + q) * L + lane)),
                xw[q]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kRows + 2; ++q) {
            if (j0 + q >= 0 && j0 + q < n) {
              Lanes<V>::unpack(__ldg(reinterpret_cast<const VT*>(
                                   x + (j0 + q) * L + lane)),
                               xw[q]);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) xw[q][e] = 0.0f;
            }
          }
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float v = p.vals[k + d];
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const float c = ((w[q] >> (k + d)) & 1u) ? v : 0.0f;
#pragma unroll
            for (int e = 0; e < V; ++e) {
              acc[q][e] = tps_rn::add(acc[q][e],
                                      tps_rn::mul(c, xw[q + d][e]));
            }
          }
        }
        k += 2;
        continue;
      }
      float xv[kRows][V];
"""

K7_SUB_LOOP_START = "  for (int s = 0; s < kSubBlocks; ++s) {\n"
K7_SUB_LOOP_END = "  }\n}\n\ntemplate <int V>\nint launch("
K7_KERNEL = "template <int V>\n__global__"
K7_LOAD_MASK = """\
// w[q] = mask[i0 + q], 0 past n: one 16-byte load where the run lies
// inside [0, n) on a 16-byte boundary.
__device__ __forceinline__ void load_mask(const uint32_t* __restrict__ mask,
                                          long long n, long long i0,
                                          uint32_t (&w)[kRows]) {
  if constexpr (kRows % 4 == 0) {
    if (i0 + kRows <= n &&
        reinterpret_cast<uintptr_t>(mask + i0) % 16 == 0) {
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(mask + i0) + q);
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    w[q] = i0 + q < n ? __ldg(mask + i0 + q) : 0u;
  }
}

"""
K7_CONSEC = """\
  for (int s = 0; s < kSubBlocks; ++s) {
    const long long i0 = cta0 + (static_cast<long long>(s) * runs + run) *
                                    kRows;
    if (i0 >= n) return;
    uint32_t w[kRows];
    load_mask(mask, n, i0, w);
    float acc[kRows][V];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[q][e] = 0.0f;
    }
    for (int k = 0; k < p.K; ++k) {
      const long long j0 = i0 + p.offsets[k];
      float xv[kRows][V];
      if (j0 >= 0 && j0 + kRows <= n) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          Lanes<V>::unpack(
              __ldg(reinterpret_cast<const VT*>(x + (j0 + q) * L + lane)),
              xv[q]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          if (j0 + q >= 0 && j0 + q < n) {
            Lanes<V>::unpack(
                __ldg(reinterpret_cast<const VT*>(x + (j0 + q) * L + lane)),
                xv[q]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) xv[q][e] = 0.0f;
          }
        }
      }
      const float v = p.vals[k];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float c = ((w[q] >> k) & 1u) ? v : 0.0f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[q][e] = tps_rn::add(acc[q][e], tps_rn::mul(c, xv[q][e]));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (i0 + q < n) {
        *reinterpret_cast<VT*>(y + (i0 + q) * L + lane) =
            Lanes<V>::pack(acc[q]);
      }
    }
"""

K7_STORE = """\
        *reinterpret_cast<VT*>(y + i * L + lane) = Lanes<V>::pack(acc[q]);
"""
K7_STORE_CS = ("        __stcs(reinterpret_cast<VT*>(y + i * L + lane),"
               " Lanes<V>::pack(acc[q]));\n")

K7_LAUNCH_ANCHOR = "template <int V>\nint launch("
K7_LAUNCH4 = "      return launch<4>(m, xf, yf, n, L, p, s);"
K7_LAUNCH4_WIN = "      return launch_win(m, xf, yf, n, L, p, s);"
K7_WIN = r"""
// bytes of x a plane may lie from its sub-block and still be read from
// the shared-memory window
constexpr int kHaloBytes = 12 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V = 4: a sub-block's rows of x and `halo` rows on either side staged in
// shared memory by one bulk copy; planes with |off| <= halo read it.
__global__ void __launch_bounds__(kThreads)
dia_nmajor_win_kernel(const uint32_t* __restrict__ mask,
                      const float* __restrict__ x, float* __restrict__ y,
                      long long n, int L, int halo,
                      const __grid_constant__ NMajorParams p) {
  constexpr int V = 4;
  extern __shared__ __align__(16) float win[];
  __shared__ __align__(8) uint64_t bar;
  const int G = L / V;
  const int runs = kThreads / G;
  const int t = threadIdx.x;
  const int run = t / G;
  const int lane = (t - run * G) * V;
  const uint32_t bar_addr = smem_u32(&bar);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long sub_rows = static_cast<long long>(runs) * kRows;
  const long long cta0 = static_cast<long long>(blockIdx.x) * kSubBlocks *
                         sub_rows;
  uint32_t phase = 0;
  for (int s = 0; s < kSubBlocks; ++s) {
    const long long sub0 = cta0 + s * sub_rows;
    if (sub0 >= n) break;
    const long long ws = sub0 - halo > 0 ? sub0 - halo : 0;
    const long long we = sub0 + sub_rows + halo < n ? sub0 + sub_rows + halo
                                                    : n;
    if (t == 0) {
      const uint32_t bytes = static_cast<uint32_t>((we - ws) * L * 4);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              bar_addr),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_u32(win)),
          "l"(x + ws * L), "r"(bytes), "r"(bar_addr)
          : "memory");
    }
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n .reg .pred q;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n"
          " selp.u32 %0, 1, 0, q;\n}"
          : "=r"(done)
          : "r"(bar_addr), "r"(phase)
          : "memory");
    } while (!done);
    phase ^= 1;
    const long long i0 = sub0 + static_cast<long long>(run) * kRows;
    if (run < runs && i0 < n) {
      uint32_t w[kRows];
      load_mask(mask, n, i0, w);
      float acc[kRows][V];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[q][e] = 0.0f;
      }
      for (int k = 0; k < p.K; ++k) {
        const int off = p.offsets[k];
        const long long j0 = i0 + off;
        const bool near = off <= halo && -off <= halo;
        float xv[kRows][V];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const long long j = j0 + q;
          if (j >= 0 && j < n) {
            const float4 u =
                near ? *reinterpret_cast<const float4*>(win + (j - ws) * L +
                                                        lane)
                     : __ldg(reinterpret_cast<const float4*>(x + j * L +
                                                             lane));
            Lanes<V>::unpack(u, xv[q]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) xv[q][e] = 0.0f;
          }
        }
        const float v = p.vals[k];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float c = ((w[q] >> k) & 1u) ? v : 0.0f;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[q][e] = tps_rn::add(acc[q][e], tps_rn::mul(c, xv[q][e]));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (i0 + q < n) {
          *reinterpret_cast<float4*>(y + (i0 + q) * L + lane) =
              Lanes<V>::pack(acc[q]);
        }
      }
    }
    __syncthreads();
  }
}

int launch_win(const uint32_t* mask, const float* x, float* y, long long n,
               int L, const NMajorParams& p, cudaStream_t s) {
  int halo = 0;
  for (int k = 0; k < p.K; ++k) {
    const int a = p.offsets[k] < 0 ? -p.offsets[k] : p.offsets[k];
    if (static_cast<long long>(a) * L * 4 <= kHaloBytes && a > halo) {
      halo = a;
    }
  }
  const long long sub_rows = static_cast<long long>(kThreads / (L / 4)) *
                             kRows;
  const long long rows = kSubBlocks * sub_rows;
  const long long ctas = (n + rows - 1) / rows;
  const size_t smem = static_cast<size_t>(sub_rows + 2 * halo) * L * 4;
  dia_nmajor_win_kernel<<<static_cast<unsigned>(ctas), kThreads, smem, s>>>(
      mask, x, y, n, L, halo, p);
  return static_cast<int>(cudaGetLastError());
}

"""

PY_LANE_GROUP = "    for v in (K7_VECTOR_BYTES // 4, 2, 1):"


def _sub(text: str, old: str, new: str, what: str) -> str:
    if old not in text:
        raise SystemExit(f"{what}: anchor not found")
    return text.replace(old, new)


def _const(cu, py, c, pyc, old, new, what):
    cu = _sub(cu, f"constexpr int {c} = {old};", f"constexpr int {c} = {new};",
              what)
    py = _sub(py, f"{pyc} = {old}\n", f"{pyc} = {new}\n", what)
    return cu, py


def apply(name: str, f: dict) -> dict:
    """Apply variant ``name`` to the texts ``f`` (keys k7cu, k7py)."""
    if name in ("sub4", "sub8"):
        f["k7cu"], f["k7py"] = _const(f["k7cu"], f["k7py"], "kSubBlocks",
                                      "K7_SUB_BLOCKS", 1, int(name[3:]), name)
    elif name == "v1":
        f["k7py"] = _sub(f["k7py"], PY_LANE_GROUP, "    for v in (1,):", name)
    elif name in ("rows1", "rows2", "rows8"):
        f["k7cu"], f["k7py"] = _const(f["k7cu"], f["k7py"], "kRows",
                                      "K7_ROWS", 4, int(name[4:]), name)
    elif name == "rwin":
        f["k7cu"] = _sub(f["k7cu"], K7_PLANE_LOOP, K7_RWIN, name)
    elif name == "smem":
        f["k7cu"] = _sub(f["k7cu"], K7_LAUNCH_ANCHOR,
                         K7_WIN + K7_LAUNCH_ANCHOR, name)
        f["k7cu"] = _sub(f["k7cu"], K7_LAUNCH4, K7_LAUNCH4_WIN, name)
    elif name == "consec":
        cu = _sub(f["k7cu"], K7_KERNEL, K7_LOAD_MASK + K7_KERNEL, name)
        a = cu.index(K7_SUB_LOOP_START)
        b = cu.index(K7_SUB_LOOP_END, a)
        f["k7cu"] = cu[:a] + K7_CONSEC + cu[b:]
    elif name == "t128":
        f["k7cu"], f["k7py"] = _const(f["k7cu"], f["k7py"], "kThreads",
                                      "K7_THREADS", 256, 128, name)
    elif name == "cs":
        f["k7cu"] = _sub(f["k7cu"], K7_STORE, K7_STORE_CS, name)
    else:
        raise SystemExit(f"unknown variant {name}")
    return f


def main() -> None:
    out = Path(sys.argv[1])
    for spec in sys.argv[2:]:
        tree = out / spec
        if tree.exists():
            shutil.rmtree(tree)
        shutil.copytree(ROOT / "tpusparse_torch", tree / "tpusparse_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        pkg = tree / "tpusparse_torch"
        paths = {"k7cu": pkg / "csrc" / "dia_nmajor.cu",
                 "k7py": pkg / "kernels" / "dia_nmajor.py"}
        f = {k: p.read_text() for k, p in paths.items()}
        for name in spec.split("+"):
            f = apply(name, f)
        for k, p in paths.items():
            p.write_text(f[k])
        print(f"{tree}: {spec}")


if __name__ == "__main__":
    main()
