"""Distributed algorithms: Cholesky, triangular solve, POTRS/POSV."""
