"""Solvers built from the port's kernels."""
