"""Device ms a profiled update under the autograd engine (the backward
pass)."""
from benchmark.harness.readers import under_ms

NEEDS = ("host",)


def read(ctx):
    return under_ms(ctx, "autograd::engine")
