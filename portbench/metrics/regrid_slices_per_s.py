"""regrid_slices_per_s: every slice regridded in the window over the window's seconds."""

from portbench.readers import slices_per_s


def read(ctx):
    return slices_per_s(ctx)
