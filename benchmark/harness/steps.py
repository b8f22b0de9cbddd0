"""Training cells: one trainer's steps back to back.

Set-up builds the trainer and its state from the configuration file and the
seeded weights, makes the mix's pool of distinct batches on the device, and
drives that same state through its first ``check_steps`` steps, through the
window's own call, on batches that all differ; those steps warm every
shape, and what they produce (losses, the first gradient as the optimizer
gets it, each leaf's change) is what the check holds against the plain
reference, which follows them from the same weights after the window. The
window runs steps until its time is up and ends in a synchronize; a traced
run profiles ``trace.steps`` of them, whole, from ``TRACE_FROM`` of the way
in, once for the device alone and once with the host's operations.
"""

from __future__ import annotations

import time

import torch

from .phases import Phases

# a traced run profiles its steps from TRACE_FROM of the window's length on
TRACE_FROM = 0.3


class Steps(Phases):
    """A driver's shared loop; the driver defines ``setup``, ``step(i)``
    (the i-th step after set-up's), ``units`` (crops or segments a step),
    ``end_to_end_name``, ``model_flops`` and ``check``."""

    trace_steps = 0

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.mix = cell.config, cell.traffic
        self.done = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def run_window(self, seconds: float, profiles=None) -> None:
        """``profiles``: {"plain": device-only profiler, "host": one that
        records the host's operations too}; each profiles ``trace.steps``
        whole steps in turn, from ``TRACE_FROM`` of the window on."""
        self.sync()
        self.t_start = time.perf_counter()
        end = self.t_start + seconds
        at = self.t_start + TRACE_FROM * seconds
        todo = list((profiles or {}).values())
        i = 0
        while time.perf_counter() < end:
            if todo and time.perf_counter() >= at:
                n = int(self.mix["trace"]["steps"])
                profile = todo.pop(0)
                self.sync()
                profile.start()
                for _ in range(n):
                    self.step(i)
                    i += 1
                self.sync()
                profile.stop()
                self.trace_steps = n
                continue
            self.step(i)
            i += 1
        self.sync()
        self.t_end = time.perf_counter()
        self.done = i

    def end_to_end(self) -> dict:
        return {self.end_to_end_name: self.units * self.done
                / (self.t_end - self.t_start)}

    def counts(self) -> tuple[int, int]:
        return self.done, 0

    def stack_pass(self, path) -> None:
        raise NotImplementedError("training cells read no Python stacks")
