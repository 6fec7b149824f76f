"""select.dispatch_us: the mean duration of the port's ``apply.select`` span (the checks, block and register choice and launch of ``window_select``) over the untraced calls; None where the port has no such span."""


def read(ctx):
    spans = total_us = 0
    for call in ctx.untraced():
        select = (call.counters or {}).get("select", {})
        spans += select.get("spans", 0)
        total_us += select.get("span_us", 0.0)
    return total_us / spans if spans else None
