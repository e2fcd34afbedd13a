"""Per-request latency plane for the host metrics surface.

The port's own copy of ``opendht_tpu/obs/latency.py``.  A
:class:`LatencyPlane` owns one latency histogram family (labelled by
request class) plus the derived SLO gauges: target, objective, observed
violation ratio, and the error-budget burn rate (violation ratio over
the budget ``1 - objective``; above 1 the budget is spent faster than
it accrues).  The serve, resident and soak loops publish through it.

Also here: :func:`publish_hop_histogram`, which folds the device-side
hop-count histogram (``[max_steps + 1]`` bins, e.g. a ``torch.bincount``
of a lookup's hops) into the registry as a real Prometheus histogram
via ``observe_bulk``.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from ..utils.metrics import Histogram, MetricsRegistry


class LatencyPlane:
    """One request-latency histogram family + its SLO gauge set.

    ``prefix`` names the family (metrics are ``<prefix>_latency_
    seconds``, ``<prefix>_slo_target_seconds``, ``<prefix>_slo_
    violation_ratio``, ``<prefix>_slo_error_budget_burn_rate``).
    ``slo_target_s`` is the latency objective per request;
    ``slo_objective`` the fraction of requests that must meet it
    (0.99 → a 1 % error budget).  Thread-safe like the registry
    underneath.
    """

    def __init__(self, registry: MetricsRegistry,
                 prefix: str = "dht_request",
                 label_names: Sequence[str] = (),
                 slo_target_s: float = 0.25,
                 slo_objective: float = 0.99,
                 buckets: Optional[Sequence[float]] = None):
        if not 0.0 < slo_objective < 1.0:
            raise ValueError(
                f"slo_objective must be in (0, 1), got {slo_objective}")
        if slo_target_s <= 0:
            raise ValueError(
                f"slo_target_s must be > 0, got {slo_target_s}")
        self.registry = registry
        self.slo_target_s = float(slo_target_s)
        self.slo_objective = float(slo_objective)
        self.hist = registry.histogram(
            f"{prefix}_latency_seconds",
            "Per-request arrival-to-completion latency",
            label_names,
            buckets=buckets or Histogram.LATENCY_BUCKETS_S)
        self._target = registry.gauge(
            f"{prefix}_slo_target_seconds",
            "Latency SLO target per request")
        self._objective = registry.gauge(
            f"{prefix}_slo_objective_ratio",
            "Fraction of requests that must meet the target")
        self._violation = registry.gauge(
            f"{prefix}_slo_violation_ratio",
            "Observed fraction of requests over the SLO target")
        self._burn = registry.gauge(
            f"{prefix}_slo_error_budget_burn_rate",
            "Violation ratio over the error budget (1 - objective); "
            ">1 burns budget faster than it accrues")
        self._target.set(self.slo_target_s)
        self._objective.set(self.slo_objective)
        self._lock = threading.Lock()
        self._n = 0
        self._over = 0
        self._win_n = 0
        self._win_over = 0

    def observe(self, seconds: float, **labels) -> None:
        """Record one request and refresh the SLO gauges."""
        if seconds < 0:
            raise ValueError(f"latency must be >= 0, got {seconds}")
        self.hist.observe(seconds, **labels)
        with self._lock:
            self._n += 1
            self._win_n += 1
            if seconds > self.slo_target_s:
                self._over += 1
                self._win_over += 1
            ratio = self._over / self._n
        self._violation.set(ratio)
        self._burn.set(ratio / (1.0 - self.slo_objective))

    def take_window(self) -> tuple[int, int]:
        """Drain the windowed counters: ``(observations, violations)``
        since the previous ``take_window`` call.  The short-window half
        of the SRE multiwindow burn-rate rule for live consumers (a
        scrape loop calling this per scrape gets per-window violation
        ratios next to the cumulative gauges); the soak derives its
        per-interval ratios from the timeline's own counts instead."""
        with self._lock:
            n, over = self._win_n, self._win_over
            self._win_n = 0
            self._win_over = 0
        return n, over

    @property
    def violation_ratio(self) -> float:
        with self._lock:
            return self._over / self._n if self._n else 0.0

    @property
    def burn_rate(self) -> float:
        return self.violation_ratio / (1.0 - self.slo_objective)

    def quantile(self, q: float, **labels) -> float:
        return self.hist.quantile(q, **labels)


def publish_hop_histogram(registry: MetricsRegistry, counts,
                          name: str = "dht_lookup_hops",
                          help: str = "Solicitation rounds per lookup "
                                      "(device hop_histogram)",
                          **labels) -> Histogram:
    """Fold a device hop-count histogram into the registry.

    ``counts`` is a ``[max_steps + 1]`` hop histogram: bin ``r`` counts lookups converging in exactly ``r`` rounds,
    the last bin absorbing ``>= max_steps``.  Published with integer
    ``le`` bounds ``0..max_steps-1`` plus the overflow bucket — a REAL
    Prometheus histogram (quantile-able by ``histogram_quantile`` and
    :meth:`Histogram.quantile`), not a trace-dump list.
    """
    counts = [int(v) for v in counts]
    if len(counts) < 2:
        raise ValueError("hop histogram needs >= 2 bins")
    bounds = tuple(float(i) for i in range(len(counts) - 1))
    label_names = tuple(sorted(labels))
    h = registry.histogram(name, help, label_names, buckets=bounds)
    # Exact total: bin r holds lookups of exactly r hops; the overflow
    # bin is >= max_steps, counted at its floor (a lower bound).
    total = float(sum(i * c for i, c in enumerate(counts)))
    h.observe_bulk(counts, total, **labels)
    return h
