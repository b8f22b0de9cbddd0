"""Device ms a profiled GAN step under the autograd engine (the
discriminators' and the generator's backward passes)."""
from benchmark.harness.readers import under_ms

NEEDS = ("host",)


def read(ctx):
    return under_ms(ctx, "autograd::engine")
