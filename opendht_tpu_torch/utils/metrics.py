"""The cumulative-bucket latency histogram the soak timeline derives its
quantiles from.

The port's own copy of ``Histogram`` from ``opendht_tpu/utils/metrics.py``
(its bounds, ``observe``, ``observe_bulk`` and ``quantile``), without
labels: the soak timeline and its ledger build one histogram per
quantile they derive.  The metrics registry and its Prometheus
rendering are not ported.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations ≤ its bound; the last, ``+Inf``, counts
    all)."""

    DEFAULT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

    # Latency-shaped bounds (seconds) for wall-clock distributions.
    LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                         0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                         60.0)

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None):
        bs = tuple(sorted(buckets if buckets is not None
                          else self.DEFAULT_BUCKETS))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.name, self.help, self.buckets = name, help, bs
        self.counts = [0] * (len(bs) + 1)     # cumulative, +Inf last
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
        self.counts[-1] += 1
        self.total += value
        self.n += 1

    def observe_bulk(self, bucket_counts: Sequence[int],
                     total: float) -> None:
        """Merge pre-aggregated per-bucket counts (NON-cumulative, one
        per bound, overflow last)."""
        if len(bucket_counts) != len(self.buckets) + 1:
            raise ValueError(
                f"expected {len(self.buckets) + 1} bucket counts "
                f"(one per bound + overflow), got {len(bucket_counts)}")
        cum = 0
        for i in range(len(self.buckets)):
            cum += int(bucket_counts[i])
            self.counts[i] += cum
        self.counts[-1] += cum + int(bucket_counts[-1])
        self.total += total
        self.n += cum + int(bucket_counts[-1])

    def quantile(self, q: float) -> float:
        """Bucket-based quantile (``histogram_quantile`` semantics):
        linear inside the bucket holding the q-th observation, the
        first bucket's lower bound 0; ``nan`` with no observations; the
        overflow bucket clamps to the largest finite bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.n == 0:
            return float("nan")
        target = q * self.n
        for i, b in enumerate(self.buckets):
            if self.counts[i] >= target:
                lo = self.buckets[i - 1] if i else 0.0
                prev = self.counts[i - 1] if i else 0
                width = self.counts[i] - prev
                if width <= 0:
                    return float(b)
                return float(lo + (b - lo) * (target - prev) / width)
        return float(self.buckets[-1])
