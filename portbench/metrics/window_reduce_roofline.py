"""window_reduce_roofline: the frozen bytes of one launch at the published HBM bandwidth over its mean device time in the trace."""

from portbench.readers import window_reduce_share


def read(ctx):
    return window_reduce_share(ctx)
