"""Device ms a profiled update under ``torch.optim``'s ``Optimizer.step``
(Adam)."""
from benchmark.harness.readers import under_ms

NEEDS = ("host",)


def read(ctx):
    return under_ms(ctx, "Optimizer.step#")
