"""A closed loop: ``in_flight`` requests outstanding at all times, the next
sent as soon as one returns (a corpus restored offline, or a saturated
service)."""

from __future__ import annotations

import threading
import time

from ..serving import Serving, Window


class Driver(Serving):
    def run_window(self, seconds: float, profiles=None) -> None:
        w = Window(seconds, profiles)
        slots = threading.Semaphore(int(self.mix["in_flight"]))
        index = 0
        while True:
            w.tick()
            if time.perf_counter() >= w.end:
                break
            if not slots.acquire(timeout=0.005):
                continue
            now = time.perf_counter()
            if now >= w.end:
                slots.release()
                break
            self.send(self.request(index, now), lambda r: slots.release())
            index += 1
        w.finish()
        self.t_start, self.t_end = w.start, w.end
        self.drain()

    def end_to_end(self) -> dict:
        """rtf: input seconds whose results reached the host in the window,
        over the window's seconds."""
        return {"rtf": self.audio_rate()}
