"""Hand-written CUDA kernels (sources in ``tpusparse_torch/csrc``).

Each kernel module holds the kernel's entry (``*_matvec``, ``*_matmat``,
``spmm_dia_stream_t``, ``spmm_dia_planes_t``, ``nmajor_matmat``,
``permute_apply``, ``csr_reference_kernel``), its argument checks and
its plain PyTorch version. An entry runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel through
``_build.launch``, which counts every launch in ``_build.LAUNCHES`` by
kernel, or raises. Choosing a kernel for a plan and X, casting, and
alpha/beta are the dispatch layer's (``ops/spmv.py``): nothing here
imports ``ops`` or ``solvers``.

  dia_stream    K1, masked constant-coefficient DIA (replaces
                tpusparse/kernels/dia_stream.py::_spmm_dia_stream_edge_mask),
                and K5, value-plane DIA with float32 or bf16 planes
                (replaces ::_spmm_dia_stream_edge and
                ::_spmm_dia_stream_edge_mxu)
  merge_spmv    K2, merge-path CSR SpMV (replaces
                tpusparse/kernels/merge_spmv.py::_spmv_tiles)
  spmm_merge    K3, merge-path CSR SpMM (replaces
                tpusparse/kernels/spmm_merge.py::_spmm_tiles)
  ell_spmm      K4, row-split CSR SpMM over work rows, long rows split
                (replaces tpusparse/kernels/ell_spmm.py::_spmm_ell)
  permute       K6, exact row permutation (replaces
                tpusparse/kernels/permute.py::_permute_call)
  dia_nmajor    K7, masked DIA SpMM on row-major (n, L) blocks (replaces
                tpusparse/kernels/dia_nmajor.py::_spmm_nmajor)
  bsr           K8, BCSR panel SpMM (replaces
                tpusparse/kernels/bsr.py::_bsr_spmm_panels_static)
  csr_reference KR, the reference CSR product, and the index_add_
                products every CSR plain version uses

Every kernel but K6 and K7 has a float64 twin from the same template
(K1d-K5d, K8d, KRd), counted apart.
"""
