"""The window's model FLOPs (the vector field's and the vocoder's dots over
the valid frames of every clip whose result reached the host in the window)
over the window's seconds, as a share of the card's TF32 peak (the
configuration's products are float32)."""
from benchmark.harness.readers import mfu

NEEDS = ()


def read(ctx):
    return mfu(ctx, ctx.driver.cfg["serve"]["vocoder_conv_dtype"])
