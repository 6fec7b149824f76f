"""apply.kernels_per_call: the port's ``apply.kernel`` spans per untraced regrid call (one per slab)."""

from portbench import spans


def read(ctx):
    return spans.mean_per_call(ctx, spans.kernels)
