"""An open loop: Poisson arrivals at the mix's ``rate`` (clips a second),
sent when due whatever is outstanding (an API service's independent
callers). A request's latency runs from when it was due, so a stall of the
sender counts against the requests behind it.

The arrivals are one cyclic schedule of rate x seconds gaps (the
exponential distribution's quantiles at (i + 0.5) / n) and clip sizes (the
pool's, by length rank, each as often), in an order drawn once from the
mix's ``schedule_seed``. A run's seed draws where in the cycle its window
starts; ``preroll_seconds`` of the cycle before that point are sent before
the window, so that the queue is as the cycle leaves it. Every seed thus
sends the same arrivals and sizes, each with the same predecessors, in
another order: a shuffle drawn from the seed instead moved the 95th
percentile by 30-50% from seed to seed (the tail is where bursts fall).
"""

from __future__ import annotations

import math
import time

import numpy as np

from .. import weights
from ..result import percentile
from ..serving import Serving, Window, wait_until


class Driver(Serving):
    def schedule(self, seconds: float):
        """(gaps, pool clip indices) of the cycle, and the window's first
        index in it."""
        rate, mix = float(self.mix["rate"]), self.mix
        n = max(1, round(rate * seconds))
        fixed = np.random.default_rng(int(mix["schedule_seed"]))
        q = (np.arange(n) + 0.5) / n
        gaps = fixed.permutation(-np.log1p(-q) / rate)
        by_length = np.argsort(self.sizes)
        ranks = np.concatenate([fixed.permutation(len(self.sizes))
                                for _ in range(-(-n // len(self.sizes)))])[:n]
        start = int(np.random.default_rng(
            weights.sub_seed(self.seed, 9)).integers(n))
        return gaps, by_length[ranks], start

    def run_window(self, seconds: float, profiles=None) -> None:
        gaps, clips, start = self.schedule(seconds)
        n = len(gaps)
        pre = math.ceil(float(self.mix["rate"])
                        * float(self.mix["preroll_seconds"]))
        due, w = time.perf_counter(), None
        for k in range(pre + n):
            i = (start - pre + k) % n
            if k == pre:  # the window opens with its first arrival's gap
                w = Window(seconds, profiles, start=due)
            due += gaps[i]
            if w is None:
                time.sleep(max(0.0, due - time.perf_counter()))
            else:
                wait_until(due, w)
            self.send(self.request(k, due, int(clips[i])))
        wait_until(w.end, w)
        w.finish()
        self.t_start, self.t_end = w.start, w.end
        self.drain()
        # the window's requests are those due in it, not the pre-roll's
        self.requests = self.requests[pre:]
        self.late_ms = max((r.sent - r.due) * 1e3 for r in self.requests)

    def latencies_ms(self) -> list:
        """Due to result on the host, every request due in the window; a
        failed or missing one is infinite."""
        return [math.inf if r.error is not None or r.done is None
                else (r.done - r.due) * 1e3 for r in self.requests]

    def end_to_end(self) -> dict:
        return {"clip_p95_ms": percentile(self.latencies_ms(), 95)}
