"""build.assembly_s: CSR from the triplets and the padded layout per job (the port's timings)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, ("regridder.padded_csr", "sparse.csr_from_triplet"))
