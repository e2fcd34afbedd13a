"""Host utilities of the port: the metrics registry and its Prometheus
exposition, 160-bit ``InfoHash`` ids, and the token-bucket rate
limiter."""

from .infohash import InfoHash  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Metric,
    MetricsRegistry,
    serve_metrics,
)
