"""regrid.lead_us: per untraced call, from the start of the port's ``regrid`` span to the end of its first ``apply.kernel``: the host time the card waits on each call (the port's spans)."""

from portbench import spans


def read(ctx):
    return spans.mean_per_call(ctx, spans.lead_us)
