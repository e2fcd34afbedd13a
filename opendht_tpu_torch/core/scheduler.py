"""Time-ordered job scheduler — the single-threaded event loop heart.

Re-design of the reference scheduler (ref: include/opendht/scheduler.h:38-123):
a time-ordered queue of closures; ``run()`` executes everything due and
returns the next wakeup time.  The reference uses a ``multimap``; we use a
lazy-deletion binary heap (cancelled/edited jobs are skipped on pop), which
keeps ``edit`` O(log n) instead of O(n).

The scheduler is clock-agnostic (see :mod:`opendht_tpu_torch.utils.clock`) so the
same core logic runs under real time, virtual test time, and the quantized
lock-step time of the device swarm simulator.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional

from ..utils.clock import Clock, SteadyClock, TIME_MAX


class Job:
    __slots__ = ("fn", "time", "_cancelled")

    def __init__(self, fn: Optional[Callable[[], None]], t: float):
        self.fn = fn
        self.time = t
        self._cancelled = fn is None

    def cancel(self) -> None:
        self._cancelled = True
        self.fn = None

    @property
    def active(self) -> bool:
        return not self._cancelled


class Scheduler:
    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or SteadyClock()
        self._heap: list = []
        self._seq = itertools.count()
        self._now = self.clock.now()

    # -- time --------------------------------------------------------------
    def time(self) -> float:
        """Scheduler time: frozen during a run() pass (ref: scheduler.h:82)."""
        return self._now

    def sync_time(self) -> float:
        self._now = self.clock.now()
        return self._now

    # -- jobs --------------------------------------------------------------
    def add(self, t: float, fn: Callable[[], None]) -> Job:
        job = Job(fn, t)
        heapq.heappush(self._heap, (t, next(self._seq), job))
        return job

    def run_soon(self, fn: Callable[[], None]) -> Job:
        return self.add(self._now, fn)

    def edit(self, job: Optional[Job], t: float) -> Optional[Job]:
        """Move a job to a new time (ref: scheduler.h:63-80).

        The old heap entry is abandoned (lazy deletion); the returned Job is
        the live handle.
        """
        if job is None or not job.active:
            return job
        fn = job.fn
        job.cancel()
        return self.add(t, fn)

    # -- loop --------------------------------------------------------------
    def run(self) -> float:
        """Run all due jobs; return the next wakeup time (ref: scheduler.h:87-106)."""
        self.sync_time()
        while self._heap:
            t, _, job = self._heap[0]
            if not job.active:
                heapq.heappop(self._heap)
                continue
            if t > self._now:
                break
            heapq.heappop(self._heap)
            fn = job.fn
            job.cancel()
            if fn is not None:
                fn()
        return self.next_wakeup()

    def next_wakeup(self) -> float:
        while self._heap and not self._heap[0][2].active:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else TIME_MAX

    def pending(self) -> int:
        return sum(1 for _, _, j in self._heap if j.active)
