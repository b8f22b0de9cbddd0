"""Device ms a profiled update outside the autograd engine and the
optimizer's step: the encode, the loss and the field's forward pass (and
the gradient clip, which runs before ``Optimizer.step``)."""

NEEDS = ("host",)


def read(ctx):
    t = ctx.host
    if t is None or not t.device or not ctx.driver.trace_steps:
        return None
    rest = (t.seconds(t.device) - t.seconds(t.under("autograd::engine"))
            - t.seconds(t.under("Optimizer.step#")))
    return 1e3 * rest / ctx.driver.trace_steps
