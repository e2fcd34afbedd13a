"""Host-plane metrics registry: counters, gauges, histograms with
labels, plus Prometheus text exposition and a JSON view.

The port's own copy of ``opendht_tpu/utils/metrics.py`` (pure host
code, no tensors): :class:`Metric`, :class:`Counter`, :class:`Gauge`,
the labelled :class:`Histogram`, :class:`MetricsRegistry` (Prometheus
text exposition format 0.0.4 through :meth:`~MetricsRegistry.
render_prometheus`, a JSON view through :meth:`~MetricsRegistry.
to_dict`, and the type-mismatch, label and bucket checks) and
:func:`serve_metrics`, a standalone ``/metrics`` scrape surface.  The
latency, health, soak, resident and ledger planes publish through it,
and their rendered text equals the JAX package's for the same inputs
(``tests/test_torch_metrics.py``).

``help`` defaults to ``""`` so the soak timeline's unlabelled scratch
histograms (``Histogram("soak_interval", buckets=...)``) need no help
text.  Dependency-free and threadsafe: a serving loop writes while a
scrape thread reads.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

#: Content type of the text exposition every scrape surface serves
#: (``serve_metrics``).
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"


def _label_key(label_names: Sequence[str], labels: Dict[str, str]
               ) -> LabelKey:
    if set(labels) != set(label_names):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(label_names)}")
    return tuple((k, str(labels[k])) for k in label_names)


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class Metric:
    """Base: a named family of (label-set → value) series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    def _key(self, labels: Dict[str, str]) -> LabelKey:
        return _label_key(self.label_names, labels)

    def get(self, **labels) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    def series(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._series.items())

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        series = self.series() or ([((), 0.0)] if not self.label_names
                                   else [])
        for key, val in series:
            out.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(val)}")
        return out

    def to_json(self):
        series = self.series()
        if not self.label_names:
            return series[0][1] if series else 0.0
        return [{**dict(k), "value": v} for k, v in series]


class Counter(Metric):
    """Monotone counter.  ``inc`` only — a decrease is a bug."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counter increments must be >= 0")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Gauge(Metric):
    """Point-in-time value; set/add freely."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def add(self, amount: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations ≤ its bound; ``+Inf`` counts all)."""

    kind = "histogram"

    DEFAULT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

    # Latency-shaped bounds (seconds) for wall-clock distributions —
    # the ledger's per-invocation kernel walls and the serve-mode SLO
    # gauges.  The hop-shaped DEFAULT_BUCKETS above stay
    # the default for count-like observations; pass
    # ``buckets=Histogram.LATENCY_BUCKETS_S`` for time series.
    LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                         0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                         60.0)

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help, label_names)
        bs = tuple(sorted(buckets if buckets is not None
                          else self.DEFAULT_BUCKETS))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        # per label-set: ([counts per bound] + [inf], sum, count)
        self._h: Dict[LabelKey, Tuple[List[int], float, int]] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts, total, n = self._h.get(
                key, ([0] * (len(self.buckets) + 1), 0.0, 0))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1
            self._h[key] = (counts, total + value, n + 1)

    def observe_bulk(self, bucket_counts: Sequence[int], total: float,
                     **labels) -> None:
        """Merge pre-aggregated per-bucket counts (NON-cumulative, one
        per bound, overflow last) — how device-side hop histograms are
        folded in without observing L scalars one by one."""
        if len(bucket_counts) != len(self.buckets) + 1:
            raise ValueError(
                f"expected {len(self.buckets) + 1} bucket counts "
                f"(one per bound + overflow), got {len(bucket_counts)}")
        key = self._key(labels)
        with self._lock:
            counts, tot, n = self._h.get(
                key, ([0] * (len(self.buckets) + 1), 0.0, 0))
            cum = 0
            for i in range(len(self.buckets)):
                cum += int(bucket_counts[i])
                counts[i] += cum
            counts[-1] += cum + int(bucket_counts[-1])
            self._h[key] = (counts, tot + total,
                            n + cum + int(bucket_counts[-1]))

    def snapshot(self) -> List[Tuple[LabelKey, Tuple[List[int], float, int]]]:
        with self._lock:
            return sorted((k, (list(c), s, n))
                          for k, (c, s, n) in self._h.items())

    def quantile(self, q: float, **labels) -> float:
        """Bucket-based quantile estimate (Prometheus
        ``histogram_quantile`` semantics): find the bucket the q-th
        observation falls in and interpolate LINEARLY inside it, with
        the first bucket's lower bound taken as 0.  Returns ``nan``
        with no observations; quantiles landing in the ``+Inf``
        overflow bucket clamp to the largest finite bound (past it
        there is nothing to interpolate against)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        key = self._key(labels)
        with self._lock:
            counts, _total, n = self._h.get(
                key, ([0] * (len(self.buckets) + 1), 0.0, 0))
            counts = list(counts)
        if n == 0:
            return float("nan")
        target = q * n
        for i, b in enumerate(self.buckets):
            if counts[i] >= target:
                lo = self.buckets[i - 1] if i else 0.0
                prev = counts[i - 1] if i else 0
                width = counts[i] - prev
                if width <= 0:
                    return float(b)
                return float(lo + (b - lo) * (target - prev) / width)
        return float(self.buckets[-1])

    def bucket_bounds_of_quantile(self, q: float, **labels
                                  ) -> Tuple[float, float]:
        """``(lo, hi]`` bounds of the bucket holding the q-th
        observation (``hi = inf`` for the overflow bucket) — what a
        checker needs to prove a reported quantile is consistent with
        the recorded distribution."""
        key = self._key(labels)
        with self._lock:
            counts, _total, n = self._h.get(
                key, ([0] * (len(self.buckets) + 1), 0.0, 0))
            counts = list(counts)
        if n == 0:
            return (float("nan"), float("nan"))
        target = q * n
        for i, b in enumerate(self.buckets):
            if counts[i] >= target:
                return (self.buckets[i - 1] if i else 0.0, float(b))
        return (float(self.buckets[-1]), float("inf"))

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        snaps = self.snapshot() or (
            [((), ([0] * (len(self.buckets) + 1), 0.0, 0))]
            if not self.label_names else [])
        for key, (counts, total, n) in snaps:
            for i, b in enumerate(self.buckets):
                lk = key + (("le", _fmt_value(b)),)
                out.append(f"{self.name}_bucket{_fmt_labels(lk)} "
                           f"{counts[i]}")
            lk = key + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(lk)} {counts[-1]}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} "
                       f"{_fmt_value(total)}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {n}")
        return out

    def to_json(self):
        out = []
        for key, (counts, total, n) in self.snapshot():
            out.append({**dict(key),
                        "buckets": {**{_fmt_value(b): counts[i]
                                       for i, b in enumerate(self.buckets)},
                                    "+Inf": counts[-1]},
                        "sum": total, "count": n})
        if not self.label_names:
            return out[0] if out else {"buckets": {}, "sum": 0.0,
                                       "count": 0}
        return out


class MetricsRegistry:
    """Named metric families; idempotent getters (the second
    ``counter(name)`` call returns the first's object — the engine and
    core share one registry without coordinating construction order)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_make(self, cls, name: str, help: str, label_names,
                     **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or \
                        m.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type or label set")
                # A histogram's bucket bounds are part of its contract:
                # a second registrant asking for DIFFERENT bounds would
                # silently observe into the first's buckets and export
                # a distribution neither asked for.
                want = kw.get("buckets")
                if want is not None and isinstance(m, Histogram) \
                        and tuple(sorted(want)) != m.buckets:
                    raise ValueError(
                        f"histogram {name!r} re-registered with "
                        f"different buckets {tuple(sorted(want))} != "
                        f"{m.buckets}")
                return m
            m = cls(name, help, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_make(Histogram, name, help, label_names,
                                 buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4), newline-terminated."""
        lines: List[str] = []
        for m in self.collect():
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def to_dict(self) -> Dict[str, object]:
        return {m.name: m.to_json() for m in self.collect()}


def serve_metrics(registry: MetricsRegistry, port: int,
                  host: str = "127.0.0.1"):
    """Serve ``registry`` as Prometheus text exposition 0.0.4 on
    ``http://host:port/metrics`` from a daemon thread.

    Standalone scrape surface for anything long-running enough to
    scrape (a soak or serve run on the card).

    Returns the server; ``shutdown()`` also closes the listening
    socket. ``port=0`` binds an ephemeral port (read it back from
    ``server_address[1]``).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("/metrics", ""):
                self.send_error(404)
                return
            body = registry.render_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet: progress lives in metrics
            pass

    class Server(ThreadingHTTPServer):
        daemon_threads = True

        def shutdown(self):
            super().shutdown()
            self.server_close()

    srv = Server((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
