"""Spatial index of the weight build (host)."""
