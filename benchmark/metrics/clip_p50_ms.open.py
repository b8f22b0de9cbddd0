"""Median latency of the window's clips, from when each was due to its
result on the host (a failed or missing clip is infinite)."""
from benchmark.harness.result import percentile

NEEDS = ()


def read(ctx):
    return percentile(ctx.driver.latencies_ms(), 50)
