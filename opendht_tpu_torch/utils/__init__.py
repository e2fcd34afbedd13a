"""Host utilities of the port: the metrics registry and its Prometheus
exposition, 160-bit ``InfoHash`` ids, the rate limiters, the MessagePack
codec (``mpack``), clocks, the logger and socket addresses."""

from .infohash import InfoHash  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Metric,
    MetricsRegistry,
    serve_metrics,
)
