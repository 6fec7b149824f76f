"""regrid.dispatch_us: the port's ``regrid.apply`` span less its ``apply.kernel`` spans (the slab loop, ``apply_weights`` and the concatenation's enqueue), per untraced call (the port's spans)."""

from portbench import spans


def read(ctx):
    return spans.mean_per_call(ctx, spans.dispatch_us)
