"""Host sparse formats (numpy): COO, CSR and the DIA partition."""
