"""Public ops: planning, SpMV dispatch, hybrid DIA + merge, BLAS-1."""
