"""Kernels A, B and C's share of their roofline in a GAN step: the least
time the generator's forward needs without conv_pre and tanh, which the
library computes (``benchmark/work/vocoder.py`` at the step's batch and
frames, the card's peaks), over their device time a step."""
from benchmark.work import peaks, vocoder

NEEDS = ("plain",)
KERNELS = ("snake_aa_kernel", "conv1d_mma_kernel", "conv1d_narrow_kernel",
           "conv_transpose1d_kernel")


def read(ctx):
    t = ctx.plain
    d = ctx.driver
    if t is None or not d.trace_steps:
        return None
    found = [e for e in t.device if any(k in e["name"] for k in KERNELS)]
    if not found:
        return None
    work = vocoder.forward(d.cfg["vocoder"], d.frames, d.batch_size,
                           library=False)
    per_step = t.seconds(found) / d.trace_steps
    return 100.0 * peaks.bound_s(work, ctx.peaks) / per_step
