"""build.candidates_s: the grid hash's box candidates per job (the port's timings)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("grid_hash.query_boxes",))
