"""regrid.host_us_per_call: mean host time from the call until the labelled regrid returns, before the synchronise, over the untraced calls."""

from portbench.readers import host_us_per_call


def read(ctx):
    return host_us_per_call(ctx)
