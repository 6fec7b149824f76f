"""Builds, native bindings and host timing."""
