"""regrid.wrap_us: the mean duration of the port's ``regrid.wrap`` span (the labelled result built from the regridded tensor: the raster's coordinates assigned, or the UgridDataArray made over the mesh with its position coordinates) over the untraced calls; None where the port has no such span."""


def read(ctx):
    spans = total_us = 0
    for call in ctx.untraced():
        wrap = (call.counters or {}).get("wrap", {})
        spans += wrap.get("spans", 0)
        total_us += wrap.get("span_us", 0.0)
    return total_us / spans if spans else None
