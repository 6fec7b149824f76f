"""apply.copy_gb_per_call: the port's ``apply.copy_bytes`` counter per untraced regrid call, in GB: what the apply layer writes on the device outside the kernels (the slabs' concatenation, casts and layout copies)."""

from portbench import spans


def read(ctx):
    return spans.mean_per_call(ctx, spans.copy_gb)
