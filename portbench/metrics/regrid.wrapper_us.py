"""regrid.wrapper_us: the self time of the port's ``regrid`` span (less ``regrid.apply``), the labelled wrapper, per untraced call (the port's spans)."""

from portbench import spans


def read(ctx):
    return spans.mean_per_call(ctx, spans.wrapper_us)
