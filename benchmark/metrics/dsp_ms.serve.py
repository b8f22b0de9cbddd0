"""Device ms an input second, in the window's profile, of the signal
processing around the models: the resampler, the mel encoder and the
low-band splice."""
from benchmark.harness.readers import ms_per_audio_s

NEEDS = ("plain", "stack")
LAYER = ("dsp", ("flowhigh_tpu_torch/dsp/", "flowhigh_tpu_torch/models/melvoco.py",
                 "flowhigh_tpu_torch/postprocessing.py"))


def read(ctx):
    return ms_per_audio_s(ctx, LAYER[0])
