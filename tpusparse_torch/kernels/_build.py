"""Build and load the port's CUDA library.

Counterpart of ``tpusparse/kernels/_util.py``. The TPU wrappers there
(``kernel_no_x64``, ``tala32``) have no counterpart: here a kernel is
CUDA C++ in ``tpusparse_torch/csrc/``, compiled by ``nvcc`` into one
shared library with a plain C interface and loaded with ``ctypes``.

The build happens at first use (``library()``), never at import, and
only from the sources in the package. It writes into
``build/tpusparse_torch/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The sources compile in parallel, one
``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpusparse_torch"
LIB_NAME = "libtpusparse_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# C entry points: name -> argtypes. Every entry returns the
# cudaGetLastError() code after its launches (0 = success). Each float32
# kernel has a float64 twin, ``<name>_f64``, built from the same template
# and taking double operands (and, for the masked DIA kernel, double
# host coefficients).
SIGNATURES = {
    # mask, xt, yt, n, L, K, offsets (host int*), vals (host float* or
    # double*), stream
    "tps_dia_masked": (_P, _P, _P, _I64, _I32, _I32, _P, _P, _P),
    "tps_dia_masked_f64": (_P, _P, _P, _I64, _I32, _I32, _P, _P, _P),
    # planes, plane_bf16, xt, yt, num_rows, num_cols, L, K, offsets (host
    # long long*), stream
    "tps_dia_planes": (_P, _I32, _P, _P, _I64, _I64, _I32, _I32, _P, _P),
    # the same with float64 planes and no plane_bf16 flag
    "tps_dia_planes_f64": (_P, _P, _P, _I64, _I64, _I32, _I32, _P, _P),
    # row_offsets, col_indices, values, x, y, tile_coords, carry_rows,
    # carry_vals, num_rows, nnz, num_tiles, stream
    "tps_merge_spmv": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                       _P),
    "tps_merge_spmv_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                           _I32, _P),
    "tps_merge_tile_items": (),
    # row_offsets, col_indices, values, X, Y, tile_coords, carry_rows,
    # carry_vals, num_rows, nnz, num_tiles, L, stream
    "tps_merge_spmm": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                       _I32, _P),
    "tps_merge_spmm_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                           _I32, _I32, _P),
    # row_offsets, col_indices, values, X, Y, num_rows, L, stream
    "tps_rowsplit_spmm": (_P, _P, _P, _P, _P, _I32, _I32, _P),
    "tps_rowsplit_spmm_f64": (_P, _P, _P, _P, _P, _I32, _I32, _P),
}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built from tpusparse_torch/csrc at "
        "first use")


def _run(procs) -> None:
    """Wait for every (cmd, Popen) and raise on the first that failed."""
    outs = [(cmd, proc, *proc.communicate()) for cmd, proc in procs]
    for cmd, proc, out, err in outs:
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{out}\n{err}")


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed build directory (once) and
    return the library path. Each source compiles in its own ``nvcc``
    process, all started together; one more links them."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    _run(procs)
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *[str(o) for o in objs]]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry reports a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
