"""Hand-written CUDA kernels (sources in ``tpusparse_torch/csrc``).

Each kernel module holds the kernel's wrapper, its plain PyTorch
version and a launch counter (``LAUNCHES``). The wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.

  dia_stream   K1, masked constant-coefficient DIA (replaces
               tpusparse/kernels/dia_stream.py::_spmm_dia_stream_edge_mask),
               and K5, value-plane DIA with float32 or bf16 planes
               (replaces ::_spmm_dia_stream_edge and
               ::_spmm_dia_stream_edge_mxu; its count is PLANES_LAUNCHES)
  merge_spmv   K2, merge-path CSR SpMV (replaces
               tpusparse/kernels/merge_spmv.py::_spmv_tiles)
  spmm_merge   K3, merge-path CSR SpMM (replaces
               tpusparse/kernels/spmm_merge.py::_spmm_tiles)
  ell_spmm     K4, row-split CSR SpMM (replaces
               tpusparse/kernels/ell_spmm.py::_spmm_ell)
"""
