"""Sparse weight containers."""
