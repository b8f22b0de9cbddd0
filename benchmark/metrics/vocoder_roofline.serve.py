"""The vocoder's share of its roofline in the window: the least time its
function needs for an input second (``benchmark/work/vocoder.py`` over the
valid frames of the window's clips, no bucket padding; the card's peaks)
over the vocoder layer's device time an input second in the window's
profile (``vocoder_ms.serve``'s reading)."""
from benchmark.harness.readers import ms_per_audio_s
from benchmark.work import peaks, vocoder

NEEDS = ("plain", "stack")
LAYER = ("vocoder", ("flowhigh_tpu_torch/models/bigvgan.py",))
KERNELS = ("snake_aa", "act_conv1d", "amp_unit", "conv1d_mma", "conv1d_narrow",
           "conv1d_s8", "conv_transpose1d_kernel")


def read(ctx):
    ms = ms_per_audio_s(ctx, LAYER[0])
    d = ctx.driver
    done = d.window_done()
    if ms is None or not done:
        return None
    voc, dot = d.cfg["vocoder"], d.cfg["serve"]["vocoder_conv_dtype"]
    bound = sum(peaks.bound_s(vocoder.forward(voc, d.frames(r)), ctx.peaks,
                              dot) for r in done)
    return 100.0 * bound / sum(r.seconds for r in done) / (ms / 1e3)
