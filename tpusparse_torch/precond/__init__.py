"""Preconditioners: IC(0) with its triangular solves, and SPAI."""
