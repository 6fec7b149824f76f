"""first_result.p95_s: the 95th percentile of the untraced jobs' latency."""

from portbench.readers import p95


def read(ctx):
    return p95([c.latency for c in ctx.untraced()])
