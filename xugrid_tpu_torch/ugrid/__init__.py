"""Mesh topology."""
