"""first_result_s: the window's seconds over the jobs (new raster, weight build, one regrid) completed in it."""


def read(ctx):
    done = sum(not c.failed for c in ctx.calls)
    return ctx.window_s / done if done else None
