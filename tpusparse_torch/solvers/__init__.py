"""Iterative solvers."""
