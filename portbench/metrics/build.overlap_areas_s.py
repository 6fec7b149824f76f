"""build.overlap_areas_s: the exact overlap areas per job (the port's timings)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("celltree.exact_overlap_areas",))
