"""Time the two routes ``spmm`` has on a masked band for a row-major
float32 X (n, L): K7 on X as it is, against PyTorch's copy of X to (L, n)
followed by K1 (the route before K7 took these blocks), and check that
they give the same bits.

Cells: the 7-point lap3d-160 band (4,096,000 rows) at L = 2, 3, 4, 16,
32 and 128, and HPCG's 27-point band at 128^3 (2,097,152 rows) in
float32 at L = 16. Per cell, graph-replayed device milliseconds
(``bench/timing.graph_time_ms``) of: K7 alone (``nmajor_matmat`` on the
plan's band), the copy alone (``X.T.contiguous()``), K1 alone on a
ready (L, n) block, copy + K1, and ``spmm`` on the AUTO plan (whichever
route it takes); each timed twice, in the order K7, copy + K1, copy +
K1, K7. Also whether K7's Y equals K1's on X.T bit for bit, the bound
(``bench/models.bound_ms`` on ``dia_masked_bytes``), and the card's name
and power limit. Prints one JSON line and writes it to ``--out``; from
the repository root:

    PYTHONPATH=. python3 scripts/torch_spmm_route_ab.py \
        --out build/spmm_route.json
"""

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

# (name, lane counts) of the timed cells
CELLS = (("lap3d-160", (2, 3, 4, 16, 32, 128)), ("hpcg27-128", (16,)))


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _matrix(name):
    from tpusparse_torch import CsrMatrix
    from tpusparse_torch.io import generators as gen

    if name == "lap3d-160":
        return gen.make_laplacian_grid3d(160).to_csr()
    # HPCG's 27-point stencil: 26 on the diagonal, -1 for each neighbour
    width = 128
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(width, width))
    pattern = sp.kron(sp.kron(t, t), t, format="csr")
    return CsrMatrix.from_scipy(
        (27.0 * sp.eye(width ** 3, format="csr") - pattern).tocsr())


def _cell(A, nnz, L, seed) -> dict:
    from tpusparse_torch import spmm
    from tpusparse_torch.bench.models import (
        bound_ms,
        dia_masked_bytes,
        spmv_flops,
    )
    from tpusparse_torch.bench.timing import graph_time_ms
    from tpusparse_torch.kernels import dia_nmajor, dia_stream

    D = A.dia
    n = D.num_rows
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, L), generator=g, device="cuda")
    XT = X.T.contiguous()
    Y7 = dia_nmajor.nmajor_matmat(D, X)
    Y1 = dia_stream.spmm_dia_stream_t(D, XT)
    Ys = spmm(A, X)
    res = {"bitwise_k7_k1": bool(torch.equal(Y7, Y1.T)),
           "bitwise_spmm_k1": bool(torch.equal(Ys, Y1.T)),
           "spmm_contiguous": Ys.is_contiguous()}
    del Y7, Y1, Ys
    torch.cuda.empty_cache()

    def k7():
        return dia_nmajor.nmajor_matmat(D, X)

    def copy_k1():
        return dia_stream.spmm_dia_stream_t(D, X.T.contiguous())

    t = {"k7": [], "copy+k1": []}
    for what, fn in (("k7", k7), ("copy+k1", copy_k1),
                     ("copy+k1", copy_k1), ("k7", k7)):
        t[what].append(graph_time_ms(fn))
    res["k7_ms"] = t["k7"]
    res["copy+k1_ms"] = t["copy+k1"]
    res["copy_ms"] = graph_time_ms(lambda: X.T.contiguous())
    res["k1_ms"] = graph_time_ms(
        lambda: dia_stream.spmm_dia_stream_t(D, XT))
    res["spmm_ms"] = graph_time_ms(lambda: spmm(A, X))
    res["bound_ms"], res["bound_by"] = bound_ms(spmv_flops(nnz, L),
                                                dia_masked_bytes(n, L))
    k7_ms = statistics.median(t["k7"])
    res["k7_over_copy_k1"] = k7_ms / statistics.median(t["copy+k1"])
    res["k7_bound_share_pct"] = 100.0 * res["bound_ms"] / k7_ms
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path,
                    default=Path("build/spmm_route.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from tpusparse_torch import plan_kind, plan_matrix

    out = {"card": _smi(), "cells": {}}
    for name, lanes in CELLS:
        csr = _matrix(name)
        A = plan_matrix(csr, "auto", dtype=np.float32, device="cuda")
        if plan_kind(A) != "dia":
            raise SystemExit(f"{name}: AUTO planned {plan_kind(A)}, not dia")
        for L in lanes:
            key = f"{name} L={L} K={len(A.dia.offsets)}"
            out["cells"][key] = _cell(A, csr.nnz, L, 90 + L)
            print(key, json.dumps(out["cells"][key]), flush=True)
        del A, csr
        torch.cuda.empty_cache()
    line = json.dumps(out)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
