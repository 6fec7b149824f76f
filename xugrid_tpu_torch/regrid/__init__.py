"""Regridders, the apply, and its kernels."""
