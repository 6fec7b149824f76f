"""
CRS handling: CF grid-mapping attributes ⇄ pyproj.CRS (the port's copy
of ``xugrid_tpu/ugrid/crs.py``).

Behavior contract (xugrid/ugrid/crs.py): candidates are extracted from
CF grid-mapping attrs, WKT, and EPSG entries; agreement returns the
first candidate, disagreement is resolved through EPSG round-trips and
raises on genuine conflicts; a placeholder carries the raw attributes
when pyproj is unavailable.  The extraction/resolution machinery below
is a table-driven reimplementation of that contract.
"""

from __future__ import annotations


class CrsPlaceholder:
    """Stands in for pyproj.CRS when pyproj is not installed."""

    def __init__(self, attrs: dict):
        self._attrs = dict(attrs)

    def __eq__(self, other):
        if isinstance(other, CrsPlaceholder):
            return self._attrs == other._attrs
        return False

    def __hash__(self):
        return hash(tuple(sorted(map(str, self._attrs.items()))))

    def __repr__(self):
        return f"CrsPlaceholder({self._attrs})"


def _candidate_cf(attrs, pyproj):
    """CF grid-mapping attrs (from_cf also consumes any inline WKT)."""
    if attrs.get("grid_mapping_name") is None:
        return None
    try:
        return pyproj.CRS.from_cf(attrs)
    except pyproj.exceptions.CRSError:
        return None


def _candidate_wkt(attrs, pyproj):
    """Bare WKT — only consulted when no CF grid mapping is declared
    (from_cf would otherwise already have read it)."""
    if attrs.get("grid_mapping_name") is not None:
        return None
    wkt = attrs.get("crs_wkt") or attrs.get("spatial_ref")
    if wkt is None:
        return None
    try:
        return pyproj.CRS.from_wkt(wkt)
    except pyproj.exceptions.CRSError:
        return None


def _candidate_epsg(attrs, pyproj):
    entry = attrs.get("epsg") or attrs.get("epsg_code")
    if entry is None:
        return None
    try:
        return pyproj.CRS.from_user_input(entry)
    except (ValueError, pyproj.exceptions.CRSError):
        return None


_EXTRACTORS = (
    ("grid_mapping", _candidate_cf),
    ("wkt", _candidate_wkt),
    ("epsg", _candidate_epsg),
)


def crs_from_attrs(ds_attrs: dict):
    """
    Build a CRS object from grid-mapping attributes.

    Extracts every available candidate (CF attrs, WKT, EPSG identifier)
    and reconciles them: unanimous candidates return directly;
    otherwise the EPSG-round-trippable candidate wins, and candidates
    resolving to DIFFERENT EPSG codes raise ValueError.  Returns
    CrsPlaceholder when pyproj is missing or nothing parses.
    """
    try:
        import pyproj
    except ImportError:
        return CrsPlaceholder(ds_attrs)

    attrs = {str(k).lower(): v for k, v in ds_attrs.items()}
    candidates = {
        label: crs
        for label, extract in _EXTRACTORS
        if (crs := extract(attrs, pyproj)) is not None
    }
    if not candidates:
        return CrsPlaceholder(ds_attrs)

    ordered = list(candidates.values())
    if all(ordered[0].equals(other) for other in ordered[1:]):
        return ordered[0]

    # Disagreement: arbitrate by EPSG round-trip.
    with_epsg = {
        label: (crs, crs.to_epsg()) for label, crs in candidates.items()
    }
    resolved = {
        label: pair for label, pair in with_epsg.items() if pair[1] is not None
    }
    if len({code for _, code in resolved.values()}) > 1:
        lines = "\n".join(
            f"- {label}: EPSG={code}" for label, (_, code) in resolved.items()
        )
        raise ValueError(
            f"Contradictory CRS information in attributes:\n{lines}"
        )
    if resolved:
        return next(iter(resolved.values()))[0]
    return ordered[0]


def crs_to_attrs(crs) -> dict:
    """CF attribute encoding of a CRS (incl. GDAL's spatial_ref alias
    and a round-trippable EPSG entry when one exists)."""
    if isinstance(crs, CrsPlaceholder):
        return crs._attrs
    attrs = crs.to_cf()
    attrs["spatial_ref"] = attrs["crs_wkt"]
    attrs["name"] = crs.name
    epsg = crs.to_epsg()
    if epsg is not None:
        attrs["epsg"] = epsg
    return attrs
