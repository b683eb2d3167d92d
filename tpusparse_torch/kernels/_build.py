"""Build and load the port's CUDA library.

Counterpart of ``tpusparse/kernels/_util.py``. The TPU wrappers there
(``kernel_no_x64``, ``tala32``) have no counterpart: here a kernel is
CUDA C++ in ``tpusparse_torch/csrc/``, compiled by ``nvcc`` into one
shared library with a plain C interface and loaded with ``ctypes``. The
same library holds the host C++ of the IC(0) factorization and the
triangular dependency levels (``csrc/ic0_host.cpp``).

The build happens at first use (``library()``), never at import, and
only from the sources in the package. It writes into
``build/tpusparse_torch/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The sources compile in parallel, one
``nvcc`` process each.

Every kernel launch goes through ``launch``, which runs the C entry on
the device's current stream, checks its CUDA error code and counts it in
``LAUNCHES``; every check of a kernel's geometry against its Python
mirror goes through ``geometry``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from tpusparse_torch.utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpusparse_torch"
LIB_NAME = "libtpusparse_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

# C entry points: name -> argtypes. Every kernel entry returns the
# cudaGetLastError() code after its launches (0 = success). Each float32
# kernel but the n-major one (float32 only, as in the JAX package) has a
# float64 twin, ``<name>_f64``, built from the same template and taking
# double operands (and, for the masked DIA kernel, double host
# coefficients).
SIGNATURES = {
    # mask, xt, yt, n, L, K, offsets (host int*), vals (host float* or
    # double*), number of runs, runs (host int*), stream
    "tps_dia_masked": (_P, _P, _P, _I64, _I32, _I32, _P, _P, _I32, _P, _P),
    "tps_dia_masked_f64": (_P, _P, _P, _I64, _I32, _I32, _P, _P, _I32, _P,
                           _P),
    # value bytes, out (host int[4]) -> K1's geometry (0 = known size)
    "tps_dia_masked_geometry": (_I32, _P),
    # planes, plane_bf16, xt, yt, num_rows, num_cols, L, K, offsets (host
    # long long*), stream
    "tps_dia_planes": (_P, _I32, _P, _P, _I64, _I64, _I32, _I32, _P, _P),
    # the same with float64 planes and no plane_bf16 flag
    "tps_dia_planes_f64": (_P, _P, _P, _I64, _I64, _I32, _I32, _P, _P),
    # value bytes, out (host int[3]) -> K5's geometry (0 = known size)
    "tps_dia_planes_geometry": (_I32, _P),
    # row_offsets, col_indices, values, x, y, tile_coords (the plan's),
    # carry_rows, carry_vals, num_rows, nnz, num_tiles, stream
    "tps_merge_spmv": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32,
                       _P),
    "tps_merge_spmv_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32,
                           _I32, _P),
    "tps_merge_spmv_tile_items": (),
    # row_offsets, col_indices, values, X, Y, tile_coords (the plan's, on
    # K2's tiles), carry_vals, num_rows, nnz, num_tiles, L, stream
    "tps_merge_spmm": (*(_P,) * 7, _I32, _I32, _I32, _I32, _P),
    "tps_merge_spmm_f64": (*(_P,) * 7, _I32, _I32, _I32, _I32, _P),
    # L, value bytes -> merge items of a K3 lane group's stretch
    "tps_merge_spmm_group_items": (_I32, _I32),
    # work_offsets, work_dest, col_indices, values, X, Y, partials,
    # split_rows, split_offsets, num_work, num_split, L, stream
    "tps_rowsplit_spmm": (*(_P,) * 9, *(_I32,) * 3, _P),
    "tps_rowsplit_spmm_f64": (*(_P,) * 9, *(_I32,) * 3, _P),
    # mask, x, y, n, L, V (values a lane group), K, offsets (host int*),
    # vals (host float*), stream: K7, float32 only
    "tps_dia_nmajor": (_P, _P, _P, _I64, _I32, _I32, _I32, _P, _P, _P),
    # out (host int[4]) -> K7's geometry
    "tps_dia_nmajor_geometry": (_P,),
    # block_row_offsets, block_col_indices, blocks, X, Y, num_rows,
    # num_cols, num_block_rows, block_rows, block_cols, L, stream
    "tps_bsr": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _P),
    "tps_bsr_f64": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32,
                    _P),
    # row_offsets, col_indices, values, X, Y, num_rows, L, index64,
    # stream: the reference product KR (KRd)
    "tps_csr_reference": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _P),
    "tps_csr_reference_f64": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _P),
    # perm, x, y, n, words per row, bytes per word, stream
    "tps_permute": (_P, _P, _P, _I64, _I32, _I32, _P),
    # host entries (ic0_host.cpp; no stream, nothing on the card):
    # n, row_offsets (int64), col_indices (int64), vals_in, vals_out,
    # max_attempts, initial_shift -> attempts used (0 = failed)
    "tps_ic0_factorize": (_I64, _P, _P, _P, _P, _I32, ctypes.c_double),
    # n, row_offsets (int64), col_indices (int32), lower, out_level
    # (int32) -> number of levels
    "tps_tri_levels": (_I64, _P, _P, _I32, _P),
}

_lib: ctypes.CDLL | None = None

# Kernel launches since the count was last reset, by kernel: K1, K1d,
# K2, K2d, K3, K3d, K4, K4d, K5, K5d, K6, K7, K8, K8d, KR, KRd (plain
# runs are not counted).
LAUNCHES: collections.Counter = collections.Counter()

# (geometry entry, its arguments) -> what the library answered
_geometry: dict = {}


def _units() -> list[Path]:
    """The compilation units: the CUDA sources and the host C++ ones."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cpp"))


def sources() -> list[Path]:
    return _units() + sorted(CSRC.glob("*.cuh"))


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
    """Compile ``csrc/*.cu`` and ``csrc/*.cpp`` into the hashed build
    directory (once) and return the library path. Each source compiles
    in its own ``nvcc`` process, all started together; one more links
    them."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if not lib.exists():
        with trace.span("kernels.build"):
            _compile(out_dir, lib)
    return lib


def _compile(out_dir: Path, lib: Path) -> None:
    """Compile every unit into ``out_dir`` and link them into ``lib``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs, procs = [], []
    for src in _units():
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


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        with trace.span("kernels.load"):
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


def launch(entry: str, label: str, device, *args) -> None:
    """Run the kernel entry ``entry`` with ``args`` and, as its last
    argument, ``device``'s current stream, under that device; raise on
    the CUDA error code it returns, naming it; count one launch of
    ``label`` in ``LAUNCHES``."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(rc, entry)
    LAUNCHES[label] += 1


def geometry(entry: str, args: tuple, want, kernel: str, mirror: str) -> None:
    """Raise unless the library's geometry entry ``entry`` gives
    ``want``, the value its Python mirror in ``mirror`` computes for
    kernel ``kernel``. A tuple ``want`` is read from an int array the
    entry fills after ``args`` (a nonzero return: no geometry for
    ``args``); a whole number is the entry's return value. The library
    is asked once for each ``(entry, args)``."""
    key = (entry, args)
    if key not in _geometry:
        fn = getattr(library(), entry)
        if isinstance(want, tuple):
            out = (ctypes.c_int * len(want))()
            if fn(*args, ctypes.addressof(out)):
                raise RuntimeError(f"{kernel} has no geometry {entry}{args} "
                                   "in the library")
            _geometry[key] = tuple(out)
        else:
            _geometry[key] = fn(*args)
    if _geometry[key] != want:
        raise RuntimeError(
            f"{kernel}'s geometry {entry}{args} is {_geometry[key]} in the "
            f"library, {want} in {mirror}")
