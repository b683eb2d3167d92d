"""Write the variant trees of K5's A/B (``scripts/torch_k5_ab.py``).

Each variant is a copy of this tree's ``tpusparse_torch`` package with
``csrc/dia_planes.cu`` (and, where the geometry changes,
``kernels/dia_stream.py``) changed in one respect, so that a design step
is timed against the kernel without it, or a variant against the
design:

  rows1    one row a thread (step 1's run of rows undone: element loads
           of x, element stores);
  gridy    the lanes spread over grid.y, a CTA one lane (step 1's lane
           walk undone; with no plane tile, which a CTA of one lane
           cannot reuse: rows1+gridy undoes step 1 whole);
  notile   every lane reads the planes from global memory (step 2
           undone);
  xvec     x read as K1 reads it: 16-byte loads from the rounded-down
           address and a lane-uniform shift, element loads only where a
           run reaches past 0 or num_cols;
  rows2, rows8
           8 or 32 bytes of rows a thread (2 or 8 with float32 and bf16
           planes, 1 or 4 in float64; the tile grows with them);
  t128     128 threads a CTA;
  pstream  the first lane reads the planes with streaming loads
           (``__ldcs``, evict first), to leave L1 and L2 to x;
  a+b      variant a, then variant b.

    python3 scripts/torch_k5_variants.py build/ab rows1+gridy xvec

Rounds 1 and 2 of the A/B ran on earlier designs, with variants of
those (PERF.md §6 names them). Round 3 ran on ``xvec`` (its "new"),
with ``xvec+`` each of ``notile``, ``gridy``, ``rows1+gridy``,
``rows2``, ``rows8``, ``pstream`` and ``t128``; its ``scalar`` is this
tree. Every variant computes the same products and sums in the same
order, so its Y equals the design's bit for bit.
"""

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ROWS = "  return kRowBytes / static_cast<int>(sizeof(T));\n}"
PY_ROWS = "    return (K5_THREADS, K5_ROW_BYTES // itemsize,"

TILE_GATE = "  if (L == 1 || tile > static_cast<size_t>(kMaxTileBytes)) {"
LANE_LOOP = "  for (int l = 0; l < L; ++l) {\n    const T* xl"
LANE_LOOP_Y = ("  for (int l = blockIdx.y; l < L; l += gridDim.y) {\n"
               "    const T* xl")
LAUNCH = "<<<grid, kThreads, 0, s>>>("
LAUNCH_Y = "<<<dim3(grid, L < 65535 ? L : 65535), kThreads, 0, s>>>("

X_READ = (
    "      const long long c0 = i0 + p.offsets[k];\n"
    "#pragma unroll\n"
    "      for (int j = 0; j < R; ++j) {\n"
    "        x[j] = (c0 + j >= 0 && c0 + j < num_cols) ? __ldg(xl + c0 + j)"
    " : T(0);\n"
    "      }\n")
X_READ_VECTOR = \
    "      row_values<T, R>(xl, num_cols, i0 + p.offsets[k], x);\n"

CONSTS = {"rows2": ("kRowBytes", "K5_ROW_BYTES", 16, 8),
          "rows8": ("kRowBytes", "K5_ROW_BYTES", 16, 32),
          "t128": ("kThreads", "K5_THREADS", 256, 128)}


def _sub(text: str, old: str, new: str, what: str) -> str:
    if old not in text:
        raise SystemExit(f"{what}: anchor not found")
    return text.replace(old, new)


def apply(name: str, cu: str, py: str) -> tuple:
    if name == "rows1":
        cu = _sub(cu, ROWS, "  return 1;\n}", name)
        py = _sub(py, PY_ROWS, "    return (K5_THREADS, 1,", name)
    elif name == "notile":
        cu = _sub(cu, TILE_GATE, "  if (true) {", name)
    elif name == "gridy":
        cu = _sub(cu, TILE_GATE, "  if (true) {", name)
        cu = _sub(cu, LANE_LOOP, LANE_LOOP_Y, name)
        cu = _sub(cu, LAUNCH, LAUNCH_Y, name)
    elif name == "xvec":
        cu = _sub(cu, X_READ, X_READ_VECTOR, name)
    elif name == "pstream":
        cu = _sub(cu, "__ldg(pk + j)", "__ldcs(pk + j)", name)
    elif name in CONSTS:
        c, pyc, old, new = CONSTS[name]
        cu = _sub(cu, f"constexpr int {c} = {old};",
                  f"constexpr int {c} = {new};", name)
        py = _sub(py, f"{pyc} = {old}\n", f"{pyc} = {new}\n", name)
    else:
        raise SystemExit(f"unknown variant {name}")
    return cu, py


def main() -> None:
    out = Path(sys.argv[1])
    for spec in sys.argv[2:]:
        tree = out / spec
        if tree.exists():
            shutil.rmtree(tree)
        shutil.copytree(ROOT / "tpusparse_torch", tree / "tpusparse_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu_path = tree / "tpusparse_torch" / "csrc" / "dia_planes.cu"
        py_path = tree / "tpusparse_torch" / "kernels" / "dia_stream.py"
        cu, py = cu_path.read_text(), py_path.read_text()
        for name in spec.split("+"):
            cu, py = apply(name, cu, py)
        cu_path.write_text(cu)
        py_path.write_text(py)
        print(f"{tree}: {spec}")


if __name__ == "__main__":
    main()
