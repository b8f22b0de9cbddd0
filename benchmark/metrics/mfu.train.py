"""The window's model FLOPs (the field's dots on the 2 s crops, forward and
twice that for the backward, and the mel filterbank's products) over the
window's seconds, as a share of the card's bfloat16 peak (the
configuration's training dtype)."""
from benchmark.harness.readers import mfu

NEEDS = ()


def read(ctx):
    return mfu(ctx, ctx.driver.cfg["train"]["amp_dtype"])
