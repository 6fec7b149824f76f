"""device_idle_pct, and device_idle_pct.<kind> in each kind of cell: the share of a call with no kernel, copy or memset on the card."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
