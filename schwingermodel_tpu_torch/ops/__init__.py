"""Operators and kernels on the port layout."""
