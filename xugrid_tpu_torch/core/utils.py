"""Small shared helpers, the port's copy of ``xugrid_tpu/core/utils.py``."""

from __future__ import annotations


def either_dict_or_kwargs(positional, keywords, method_name: str):
    """The positional mapping, or the keyword arguments; not both."""
    if positional is not None:
        if keywords:
            raise ValueError(f"Cannot specify both keyword and positional arguments to .{method_name}")
        return positional
    return keywords


class UncachedAccessor:
    """Property-like accessor that constructs a new instance per access."""

    def __init__(self, accessor_cls):
        self._accessor_cls = accessor_cls

    def __get__(self, obj, cls):
        if obj is None:
            return self._accessor_cls
        return self._accessor_cls(obj)


def unique_grids(grids):
    """The grids without repeats (topology equality), in order."""
    unique = []
    for grid in grids:
        if not any(grid.equals(other) for other in unique):
            unique.append(grid)
    return unique
