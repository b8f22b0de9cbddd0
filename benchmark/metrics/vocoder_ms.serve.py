"""Device ms an input second, in the window's profile, of the BigVGAN
vocoder."""
from benchmark.harness.readers import ms_per_audio_s

NEEDS = ("plain", "stack")
LAYER = ("vocoder", ("flowhigh_tpu_torch/models/bigvgan.py",))
# where a launch has no stack: the port's vocoder kernels, by name
KERNELS = ("snake_aa", "act_conv1d", "amp_unit", "conv1d_mma", "conv1d_narrow",
           "conv1d_s8", "conv_transpose1d_kernel")


def read(ctx):
    return ms_per_audio_s(ctx, LAYER[0])
