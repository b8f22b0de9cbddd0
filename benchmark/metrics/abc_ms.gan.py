"""Device ms a profiled GAN step in the forward launches of kernels A, B
and C (the generator's snake, conv and transposed conv; their backward
passes are the library's)."""

NEEDS = ("plain",)
KERNELS = ("snake_aa_kernel", "conv1d_mma_kernel", "conv1d_narrow_kernel",
           "conv_transpose1d_kernel")


def events(t):
    return [e for e in t.device if any(k in e["name"] for k in KERNELS)]


def read(ctx):
    t = ctx.plain
    if t is None or not ctx.driver.trace_steps:
        return None
    found = events(t)
    if not found:
        return None
    return 1e3 * t.seconds(found) / ctx.driver.trace_steps
