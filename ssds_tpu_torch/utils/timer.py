"""Wall-clock accumulator for FPS and latency reports (counterpart of :mod:`ssds_tpu.utils.timer`).

Reference ``lib/utils/timer.py``: ``tic`` / ``toc`` with a running average,
used by the demo's ``-t time`` mode. When timing work on the card, call
``torch.cuda.synchronize()`` before ``toc``: a launch returns before the
device finishes (:func:`ssds_tpu_torch.utils.profiler.timed` does so).
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average=True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff

    def clear(self):
        self.__init__()
