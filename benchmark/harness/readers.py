"""What the per-layer readers (``benchmark/metrics/<metric>.py``) share.

A reader is ``read(ctx) -> float | None``; it returns None where its run has
nothing to read, and the harness then leaves the metric out. ``ctx`` holds:

- ``driver``: the cell's driver after its window (its requests or steps,
  ``model_flops()``, ``t_start`` / ``t_end``, and what each reader needs:
  ``window_done()``, ``audio_rate()``, ``frames(request)`` and
  ``stack_clips`` of the serving cells, ``trace_steps`` of the training
  cells);
- ``plain``: the ``trace.Trace`` of the window's profiled part, the device
  alone (the host's operations unrecorded), or None;
- ``host``: the training cells' trace of as many steps with the host's
  operations recorded (``autograd::engine``, ``Optimizer.step#``), or
  None;
- ``stack``: the ``trace.Trace`` of the serving cells' attribution pass
  (Python stacks, after the window), or None;
- ``peaks``: ``work.peaks.PEAKS``;
- ``layers``: {layer: module paths} of every reader of the cell that names
  a ``LAYER`` (the layers a launch's stack is matched against).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Context:
    driver: object
    plain: object
    host: object
    stack: object
    peaks: dict
    layers: dict
    kernels: dict


def idle_share(ctx) -> float | None:
    """Percent of the profiled window in which no kernel, copy or set ran
    on the device."""
    t = ctx.plain
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def layer_events(ctx, layer: str) -> list | None:
    """The attribution pass's device operations of ``layer``: by the
    innermost frame that a layer of the cell names; an operation whose
    launch has no stack by its kernel's name (``KERNELS``)."""
    t = ctx.stack
    if t is None:
        return None
    names = ctx.kernels.get(layer, ())
    events = []
    by = t.by_layer(ctx.layers)
    events += by.get(layer, [])
    events += [e for e in by[None] if not t.stack_of(e)
               and any(n in e["name"] for n in names)]
    return events


def window_layer_s(ctx, layer: str) -> float | None:
    """Device seconds of ``layer`` in the window's profile: each kernel's
    time there, times the share of that kernel's time that the attribution
    pass gives ``layer`` (a kernel that several layers launch is split as
    the pass splits it)."""
    events = layer_events(ctx, layer)
    if not events or ctx.plain is None or not ctx.plain.device:
        return None
    total: dict = {}
    for e in ctx.stack.device:
        total[e["name"]] = total.get(e["name"], 0.0) + e["dur"]
    own: dict = {}
    for e in events:
        own[e["name"]] = own.get(e["name"], 0.0) + e["dur"]
    return sum(e["dur"] * own.get(e["name"], 0.0) / total[e["name"]]
               for e in ctx.plain.device if e["name"] in own) / 1e6


def ms_per_audio_s(ctx, layer: str) -> float | None:
    """Device ms of ``layer`` an input second in the window's profile: its
    device time there over the input seconds the profiled span stands for
    (the window's rate of input seconds done, times the span: the closed
    loop keeps the device busy at that rate)."""
    seconds = window_layer_s(ctx, layer)
    if seconds is None or ctx.plain.window_s <= 0:
        return None
    return 1e3 * seconds / (ctx.driver.audio_rate() * ctx.plain.window_s)


def mfu(ctx, dot: str) -> float | None:
    """Percent of the dtype's tensor-core peak that the window's model
    dots, over the window's host-clock seconds, reach."""
    d = ctx.driver
    seconds = d.t_end - d.t_start
    if seconds <= 0:
        return None
    from benchmark.work.peaks import DOT_PEAK
    return 100.0 * d.model_flops() / seconds / ctx.peaks[DOT_PEAK[dot]]


def under_ms(ctx, prefix: str) -> float | None:
    """Device ms a profiled step of the operations launched inside host
    ranges named ``prefix...``."""
    t = ctx.host
    if t is None or not t.device or not ctx.driver.trace_steps:
        return None
    return 1e3 * t.seconds(t.under(prefix)) / ctx.driver.trace_steps
