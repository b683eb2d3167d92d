"""Time K8 and K8d (the port's BSR panel SpMM) at chip_smoke.py [15]'s
shape, for whichever ``tpusparse_torch`` comes first on the path.

``make_block_random(8192, 4, seed=0)`` (65,536 x 1,048,576, 32,768
(8, 128) blocks) through ``plan_matrix(..., 'bsr')`` in float32 (K8) and
float64 (K8d), at L = 1 and 16: per call and graph-replayed device
milliseconds of the kernel and of its plain version, and a hash of Y's
bytes, so that runs of two versions of ``csrc/bsr.cu`` show whether
they agree bit for bit. Prints the card's name and power limit and one
JSON line. To compare two trees on one card, run it once per tree,
alternating (A, B, B, A):

    PYTHONPATH=/path/to/tree python3 scripts/torch_k8_ab.py
"""

import hashlib
import json
import subprocess

import numpy as np
import torch


def main() -> None:
    import tpusparse_torch
    from tpusparse_torch import plan_matrix
    from tpusparse_torch.bench.timing import cuda_time_ms, graph_time_ms
    from tpusparse_torch.io import generators as gen
    from tpusparse_torch.kernels import bsr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    csr = gen.make_block_random(8192, 4, seed=0).to_csr()
    out = {"package": tpusparse_torch.__file__, "card": smi}
    for dt, kernel in ((np.float32, "K8"), (np.float64, "K8d")):
        P = plan_matrix(csr, "bsr", dtype=dt, device="cuda")
        for L in (1, 16):
            g = torch.Generator(device="cuda").manual_seed(620 + L)
            X = torch.randn((csr.num_cols, L), generator=g, device="cuda",
                            dtype=P.blocks.dtype)
            Y = bsr.bsr_matmat(P, X)
            row = {"sha256": hashlib.sha256(
                Y.cpu().numpy().tobytes()).hexdigest()[:16]}
            for name, fn in (("kernel", lambda: bsr.bsr_matmat(P, X)),
                             ("plain", lambda: bsr.bsr_spmm_plain(P, X))):
                row[name + "_ms"] = cuda_time_ms(fn)
                row[name + "_device_ms"] = graph_time_ms(fn)
            out[f"{kernel} L={L}"] = row
        del P
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
