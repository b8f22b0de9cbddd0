"""Idle share of the device over the profiled part of the window (the field's training steps):
the share of it in which no kernel, copy or set ran."""
from benchmark.harness.readers import idle_share as read  # noqa: F401

NEEDS = ("plain",)
