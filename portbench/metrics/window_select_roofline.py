"""window_select_roofline: the frozen bytes of one ``window_select`` launch (every weight and index, the source and the output, each once: ``rooflines.window_reduce_bytes``) at the published HBM bandwidth over its mean device time in the trace, each launch given the mean slab."""

from portbench import rooflines


def read(ctx):
    shapes = ctx.counts.get("window_select")
    found = ctx.trace.kernel("window_select_kernel") if ctx.trace is not None else None
    if shapes is None or found is None or not ctx.trace.calls:
        return None
    launches, seconds = found
    E = shapes["E"] * ctx.trace.calls / launches
    nbytes = rooflines.window_reduce_bytes(shapes["nnz"], shapes["m"], shapes["n"], E)
    return rooflines.share_pct(nbytes, seconds / launches)
