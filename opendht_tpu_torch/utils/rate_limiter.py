"""Token-bucket rate limiting for the serve engine's admission control.

The port's own copy of the one limiter the serve engine uses: the
O(1) token bucket (``quota`` tokens a second accrue up to a ``burst``
ceiling, one token per admitted hit), the counterpart of
``TokenBucket`` in ``opendht_tpu/utils/rate_limiter.py`` — the same
arithmetic in the same order, so an admission decision taken at the
same ``now`` is the same in both packages.
"""

from __future__ import annotations


class TokenBucket:
    """``quota`` tokens per second accrue up to ``burst`` (default
    ``quota``); each admitted hit spends one.  A ``now`` that goes
    backwards accrues nothing."""

    __slots__ = ("quota", "burst", "_tokens", "_last")

    def __init__(self, quota: float, burst: float | None = None):
        if quota <= 0:
            raise ValueError(f"token-bucket quota must be > 0, got "
                             f"{quota}")
        self.quota = float(quota)
        self.burst = float(burst) if burst is not None else float(quota)
        if self.burst < 1.0:
            raise ValueError(f"token-bucket burst must be >= 1, got "
                             f"{self.burst}")
        self._tokens = self.burst
        self._last: float | None = None

    def _refill(self, now: float) -> None:
        # ``_last`` only moves forward, so a backwards sample cannot
        # re-credit time that was already banked.
        if self._last is None:
            self._last = now
            return
        dt = now - self._last
        if dt > 0:
            self._tokens = min(self.burst, self._tokens + dt * self.quota)
            self._last = now

    def limit(self, now: float) -> bool:
        """Record a hit at ``now``; True if a token was available (and
        is now spent)."""
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def peek(self, now: float) -> bool:
        """True if a token is available at ``now``, spending none: a
        caller holding several buckets checks them all before it
        charges any.  ``peek`` then ``limit`` at one ``now`` is atomic
        (the second refill sees no elapsed time)."""
        self._refill(now)
        return self._tokens >= 1.0

    @property
    def tokens(self) -> float:
        return self._tokens
