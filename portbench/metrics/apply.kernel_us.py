"""apply.kernel_us: the mean duration of the port's ``apply.kernel`` span, the host cost of one launch (checks, lane choice, output allocation, launch), over the untraced calls."""

from portbench import spans


def read(ctx):
    return spans.kernel_us(ctx)
