"""Seconds of each phase of a driver's set-up, printed to standard error
(what a faster set-up would have to shorten)."""

from __future__ import annotations

import time


class Phases:
    def mark(self, what: str) -> None:
        """Ends the phase ``what``, begun at the last mark (or at the
        object's first mark)."""
        now = time.perf_counter()
        last = getattr(self, "_last_mark", None)
        self.__dict__.setdefault("phases", []).append(
            (what, 0.0 if last is None else now - last))
        self._last_mark = now
