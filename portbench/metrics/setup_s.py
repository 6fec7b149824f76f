"""setup_s: seconds from the start of the run to the window's opening (import, card, build, inputs, weights, warm-up)."""


def read(ctx):
    return ctx.setup_s
