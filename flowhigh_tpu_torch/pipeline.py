"""Three-stage thread pipeline under ``serving.ServingPipeline``: the port's
own copy of ``flowhigh_tpu/pipeline.py:StagePipeline`` (that module imports
no JAX, but this package imports nothing of the JAX package).

One thread per blocking stage lets a clip's host-to-device upload, its
dispatch and its device-to-host download overlap those of its neighbours.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional, Sequence

_CLOSE = object()  # shutdown sentinel, forwarded stage to stage


class StagePipeline:
    """Chain of worker threads connected by FIFO queues.

    ``stages`` are callables ``value -> value | None``, each running on its
    own daemon thread, consuming from its input queue and forwarding
    non-None results to the next stage. Returning ``None`` drops the item:
    the convention for "this stage already routed the failure itself"
    (e.g. ``Future.set_exception``). One thread per stage and FIFO queues
    keep submission order end to end.

    ``depths[i]`` bounds the queue feeding stage ``i + 1`` (backpressure:
    the dispatch-to-fetch depth bounds the clips queued on the device but
    not yet fetched). The queue feeding stage 0 is unbounded, so ``put``
    never blocks the caller.

    A stage that raises (a bug: stages route their own per-item errors)
    does not kill its thread or deadlock ``close``: the exception is
    recorded in ``stage_errors`` and the item is dropped.
    """

    def __init__(self, stages: Sequence[Callable],
                 depths: Sequence[Optional[int]]):
        if len(depths) != len(stages) - 1:
            raise ValueError(
                f"need {len(stages) - 1} inter-stage depths, got {len(depths)}")
        self._qs = [queue.Queue()] + [
            queue.Queue(maxsize=d) if d else queue.Queue() for d in depths]
        self.stage_errors: List[BaseException] = []
        self._threads = []
        for i, fn in enumerate(stages):
            th = threading.Thread(target=self._worker, args=(i, fn),
                                  daemon=True)
            th.start()
            self._threads.append(th)

    def _worker(self, i: int, fn: Callable):
        q_in = self._qs[i]
        q_out = self._qs[i + 1] if i + 1 < len(self._qs) else None
        while True:
            item = q_in.get()
            if item is _CLOSE:
                if q_out is not None:
                    q_out.put(_CLOSE)
                return
            try:
                out = fn(item)
            except Exception as e:  # backstop: record, keep draining
                self.stage_errors.append(e)
                continue
            if out is not None and q_out is not None:
                q_out.put(out)

    def put(self, item) -> None:
        """Enqueue one work item; never blocks (stage-0 queue unbounded)."""
        self._qs[0].put(item)

    def close(self) -> None:
        """Flush every queued item through all stages, then join the
        threads. Call once; callers guard re-entry."""
        self._qs[0].put(_CLOSE)
        for th in self._threads:
            th.join()
