"""The device trace of a traced run, read from ``torch.profiler``'s Chrome
trace.

A run profiles a steady sub-window and writes the trace under
``benchmark/out/`` (git-ignored, one file a cell, overwritten). This module
reads it:

- the device's busy time is the union of its kernel, copy and set intervals
  (streams overlap, so a sum would count twice) within the window, which
  runs from the device's first operation in the trace to the end of its
  last;
- each device operation is tied to the host call that launched it by the
  trace's correlation ids: the launch's thread and time place it inside
  the host's ranges (``autograd::engine::evaluate_function``,
  ``Optimizer.step#...``) and, where the trace has Python frames
  (``with_stack=True``), under the stack of the Python function that made
  the call;
- each idle gap of the device is named by what the host thread that
  launched the next operation was doing, as the innermost host operation
  covering most of the gap.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
FRAME = re.compile(r"^(.*)\((\d+)\): (.*)$")


@contextlib.contextmanager
def profiled(path: Path, with_stack: bool = False):
    """Profile the body (host and CUDA activity) and export the Chrome
    trace to ``path`` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts, with_stack=with_stack) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


class Session:
    """A profiler session started and stopped by a driver inside its
    window. Its trace is exported before another session starts (once one
    has run, an earlier session's timestamps read back as zeros): on stop,
    or, with ``defer`` (a driver that must not stall its window), by
    ``export`` after the window."""

    def __init__(self, path: Path, activities):
        from torch.profiler import profile
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof = profile(activities=activities)
        self.defer = self.stopped = self.done = False

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()
        self.stopped = True
        if not self.defer:
            self.export()

    def export(self) -> None:
        if self.stopped and not self.done:
            self.prof.export_chrome_trace(str(self.path))
            self.done = True


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """One exported trace. Times in seconds."""

    def __init__(self, path: Path):
        data = json.loads(Path(path).read_text())
        events = data["traceEvents"] if isinstance(data, dict) else data
        events = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.runtime = {}
        self.host = {}    # tid -> [(start, end, name)] of host operations
        self.frames = {}  # tid -> [(start, end, file, function)]
        for e in events:
            cat, tid = e.get("cat"), e.get("tid")
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.runtime[corr] = e
            if cat in ("cpu_op", "user_annotation", "cuda_runtime",
                       "cuda_driver"):
                self.host.setdefault(tid, []).append(
                    (e["ts"], e["ts"] + e["dur"], e["name"]))
            elif cat == "python_function":
                m = FRAME.match(e["name"])
                if m:
                    self.frames.setdefault(tid, []).append(
                        (e["ts"], e["ts"] + e["dur"], m.group(1),
                         m.group(3)))
        for d in (self.host, self.frames):
            for tid in d:
                d[tid].sort()
        self.busy_intervals = _union(
            (e["ts"], e["ts"] + e["dur"]) for e in self.device)
        # the window is the span in which the device was observed: from its
        # first operation's start to its last one's end
        self.t0 = self.busy_intervals[0][0] if self.busy_intervals else 0.0
        self.t1 = self.busy_intervals[-1][1] if self.busy_intervals else 0.0

    # -- the whole window ---------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) / 1e6

    def launches(self) -> int:
        """Kernel launches the host made in the window."""
        return sum(1 for e in self.runtime.values()
                   if e["name"] in LAUNCHES)

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        by: dict = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(),
                                                key=lambda kv: -kv[1])[:top]]

    def seconds(self, device_events) -> float:
        return sum(e["dur"] for e in device_events) / 1e6

    # -- what launched each device operation ----------------------------------

    def launch_of(self, e):
        """The host launch event of device operation ``e``, or None."""
        return self.runtime.get(e.get("args", {}).get("correlation"))

    def under(self, prefix: str):
        """Device operations launched inside a host range whose name starts
        with ``prefix``."""
        ranges = {tid: _union((a, b) for a, b, n in ops if n.startswith(prefix))
                  for tid, ops in self.host.items()}
        starts = {tid: [a for a, _ in r] for tid, r in ranges.items()}
        out = []
        for e in self.device:
            launch = self.launch_of(e)
            if launch is None or launch["tid"] not in ranges:
                continue
            r, ts = ranges[launch["tid"]], launch["ts"]
            i = bisect.bisect_right(starts[launch["tid"]], ts) - 1
            if i >= 0 and r[i][0] <= ts <= r[i][1]:
                out.append(e)
        return out

    def stack_of(self, e) -> list:
        """The Python frames (file, function) around the launch of ``e``,
        innermost first; [] without frames."""
        if not hasattr(self, "_stacks"):
            self._stacks = {}
            for tid, frames in self.frames.items():
                corrs = [(r["ts"], c) for c, r in self.runtime.items()
                         if r["tid"] == tid]
                for (ts, c), stack in zip(sorted(corrs), _active(
                        frames, sorted(ts for ts, _ in corrs))):
                    self._stacks[c] = [(f, fn) for _, _, f, fn in stack]
        return self._stacks.get(e.get("args", {}).get("correlation"), [])

    def by_layer(self, layers: dict, skip=("flowhigh_tpu_torch/ops/",
                                           "flowhigh_tpu_torch/utils.py")):
        """{layer: [device operations]} for ``layers`` = {layer: (module
        paths, or prefixes of them)}: each operation goes to the layer of
        the innermost frame of its launch's stack whose file one of them
        names, past the shared helpers in ``skip``; None holds the rest."""
        out = {k: [] for k in layers}
        out[None] = []
        for e in self.device:
            layer = None
            for file, _ in self.stack_of(e):
                if file.startswith(skip):
                    continue
                layer = next((k for k, paths in layers.items()
                              if file.startswith(tuple(paths))), None)
                if layer is not None:
                    break
            out[layer].append(e)
        return out

    # -- idle gaps ---------------------------------------------------------------

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host did, seconds]] over the device's idle gaps in the
        window, grouped by that name, longest first."""
        starts = sorted(self.device, key=lambda e: e["ts"])
        first = [e["ts"] for e in starts]
        gaps, prev = [], self.t0
        for a, b in self.busy_intervals + [[self.t1, self.t1]]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        asks: dict = {}  # tid -> [(gap midpoint, gap seconds)]
        by: dict = {}
        for a, b in gaps:
            i = bisect.bisect_left(first, b)
            launch = self.launch_of(starts[i]) if i < len(starts) else None
            if launch is None:
                by["end of window"] = by.get("end of window", 0.0) + (b - a) / 1e6
            else:
                asks.setdefault(launch["tid"], []).append(((a + b) / 2,
                                                           (b - a) / 1e6))
        for tid, items in asks.items():
            items.sort()
            times = [t for t, _ in items]
            ops = _active(self.host.get(tid, []), times)
            frames = _active(self.frames.get(tid, []), times)
            for (_, sec), op, fr in zip(items, ops, frames):
                name = (op[0][2] if op else
                        f"python {fr[0][2]}: {fr[0][3]}" if fr
                        else "no host operation")
                by[name] = by.get(name, 0.0) + sec
        return [[k[:120], v] for k, v in sorted(by.items(),
                                                key=lambda kv: -kv[1])[:top]]


def _active(intervals: list, times: list):
    """For each of the sorted ``times``, the ``intervals`` (sorted tuples
    that start with (start, end), properly nested) that cover it, innermost
    first."""
    stack, i = [], 0
    for t in times:
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        yield [iv for iv in reversed(stack) if iv[1] >= t]
