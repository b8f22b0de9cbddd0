"""The window's model FLOPs (the generator's dots forward and twice for its
backward, the discriminators' on the real and generated segments in both
updates with their backward passes, and the mel filterbank's products) over
the window's seconds, as a share of the card's TF32 peak (the
configuration's products are float32)."""
from benchmark.harness.readers import mfu

NEEDS = ()


def read(ctx):
    return mfu(ctx, "float32")
