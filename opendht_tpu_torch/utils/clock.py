"""Time sources for the runtime.

The reference binds everything to ``std::chrono::steady_clock``
(ref: include/opendht/utils.h:37-60).  We instead inject a ``Clock`` so the
whole core can run against a *virtual* clock — this is what makes the DHT
core deterministically unit-testable and lets the lock-step device simulator
and the event-driven runtime share one code path.

Times are float seconds.  ``TIME_INVALID`` (= -inf) sorts before every real
time, mirroring the reference's ``time_point::min()`` conventions.
"""

from __future__ import annotations

import time as _time

TIME_INVALID = float("-inf")
TIME_MAX = float("inf")


class Clock:
    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class SteadyClock(Clock):
    """Monotonic wall clock for the real (threaded / UDP) runtime."""

    def now(self) -> float:
        return _time.monotonic()


class VirtualClock(Clock):
    """Manually advanced clock for deterministic tests and simulation."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        assert dt >= 0
        self._t += dt
        return self._t

    def set(self, t: float) -> None:
        assert t >= self._t
        self._t = t
