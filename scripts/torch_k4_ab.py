"""Time K4 and K4d (the port's row-split CSR SpMM) at chip_smoke.py
[6]/[11]'s shapes, for whichever ``tpusparse_torch`` comes first on the
path.

rmat-18-ef16 and lap3d-160 at L = 16, float32 (K4) and float64 (K4d):
the row-split plan's build seconds and the size of its work-row table
(where the tree's plan has one), per call and graph-replayed device
milliseconds, and a hash of Y's bytes; beside them, in the same run,
``torch.sparse`` CSR and K3 on the merge plan of the same matrix. Prints
the card's name and power limit and one JSON line. To compare two trees
on one card, run it once per tree, alternating (A, B, B, A):

    PYTHONPATH=/path/to/tree python3 /path/to/tree/scripts/torch_k4_ab.py
"""

import argparse
import hashlib
import json
import subprocess
import time

import torch


def _sha(Y) -> str:
    return hashlib.sha256(Y.cpu().numpy().tobytes()).hexdigest()[:16]


def _times(fn) -> dict:
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms

    return {"ms": cuda_time_ms(fn), "device_ms": graph_time_ms(fn)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--L", type=int, default=16)
    args = ap.parse_args()
    import tpusparse_torch
    from tpusparse_torch import plan_matrix
    from tpusparse_torch.io import generators as gen
    from tpusparse_torch.kernels import ell_spmm, spmm_merge

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"package": tpusparse_torch.__file__, "card": smi, "L": args.L}
    for name, make in (("rmat-18-ef16", lambda: gen.make_rmat(18, 16)),
                       ("lap3d-160",
                        lambda: gen.make_laplacian_grid3d(160))):
        csr = make().to_csr()
        for dtype, kernel in ((torch.float32, "K4"), (torch.float64, "K4d")):
            g = torch.Generator(device="cuda").manual_seed(34)
            X = torch.randn((csr.num_cols, args.L), generator=g,
                            device="cuda", dtype=dtype)
            M = plan_matrix(csr, "merge", dtype=dtype, device="cuda")
            lib = torch.sparse_csr_tensor(M.row_offsets, M.col_indices,
                                          M.values, size=csr.shape)
            row = {"torch.sparse": _times(lambda: lib @ X),
                   "K3": _times(lambda: spmm_merge.merge_matmat(M, X))}
            del M, lib
            t0 = time.perf_counter()
            A = ell_spmm.to_device_row_split(csr, "cuda", dtype)
            torch.cuda.synchronize()
            cell = {"plan_s": time.perf_counter() - t0,
                    "sha256": _sha(ell_spmm.row_split_matmat(A, X))}
            T = getattr(A, "table", None)
            for key in ("num_work_rows", "num_split", "num_chunks",
                        "num_blocks"):
                if hasattr(T, key):
                    cell[key] = getattr(T, key)
            cell.update(_times(lambda: ell_spmm.row_split_matmat(A, X)))
            row[kernel] = cell
            print(f"{name} {kernel}: {row}", flush=True)
            out[f"{name} {kernel}"] = row
            del A, X
            torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
