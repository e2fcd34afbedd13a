"""Rate limiting: the host node's inbound limiters and the serve
engine's admission control (ref: include/opendht/rate_limiter.h:26-48).

The port's own copy of ``opendht_tpu/utils/rate_limiter.py``, the same
arithmetic in the same order, so a decision taken at the same ``now``
is the same in both packages:

* :class:`RateLimiter` — the reference's sliding window: ``quota`` hits
  per trailing second, a deque of timestamps;
* :class:`TokenBucket` — ``quota`` tokens a second accrue up to a
  ``burst`` ceiling, one token per admitted hit: O(1) state, so the
  network engine's per-IP map and the serve engine use it;
* :func:`make_rate_limiter` — the network engine's factory (the native
  sliding window where the host library loaded, else its Python twin).
"""

from __future__ import annotations

from collections import deque


class RateLimiter:
    __slots__ = ("quota", "_hist")

    def __init__(self, quota: int):
        self.quota = quota
        self._hist: deque = deque()

    def limit(self, now: float) -> bool:
        """Record a hit at ``now``; return True if within quota."""
        while self._hist and self._hist[0] < now - 1.0:
            self._hist.popleft()
        if len(self._hist) >= self.quota:
            return False
        self._hist.append(now)
        return True

    def maintain(self, now: float) -> int:
        while self._hist and self._hist[0] < now - 1.0:
            self._hist.popleft()
        return len(self._hist)


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

    def maintain(self, now: float) -> int:
        """The spent capacity (``burst - tokens``, rounded): the
        bucket's analogue of the window's in-flight count."""
        self._refill(now)
        return int(round(self.burst - self._tokens))

    @property
    def tokens(self) -> float:
        return self._tokens


def make_rate_limiter(quota: int, kind: str = "sliding"):
    """A limiter for the inbound path: ``"sliding"`` is the native
    sliding window where the host library loaded, else
    :class:`RateLimiter`; ``"token-bucket"`` is a :class:`TokenBucket`."""
    if kind == "token-bucket":
        return TokenBucket(quota)
    if kind != "sliding":
        raise ValueError(f"unknown rate-limiter kind {kind!r}")
    try:
        from ..native import NativeRateLimiter, available
        if available():
            return NativeRateLimiter(quota)
    except Exception:
        pass
    return RateLimiter(quota)
