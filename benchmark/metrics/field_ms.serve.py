"""Device ms an input second, in the window's profile, of the vector
field and its solver (the prior, the Euler step, the network)."""
from benchmark.harness.readers import ms_per_audio_s

NEEDS = ("plain", "stack")
LAYER = ("field", ("flowhigh_tpu_torch/models/vector_field.py",
                   "flowhigh_tpu_torch/models/transformer.py",
                   "flowhigh_tpu_torch/cfm.py"))


def read(ctx):
    return ms_per_audio_s(ctx, LAYER[0])
