"""dhtscanner: crawl the whole DHT keyspace
(ref: tools/dhtscanner.cpp:43-113).

Recursively splits the 160-bit keyspace: a search at a target returns
the closest nodes; when a subtree still yields a full bucket of new
nodes, both halves at the next depth are scanned too.

The port's copy of the JAX package's ``tools/dhtscanner.py``.  Crawl
progress publishes through the metrics registry (``utils.metrics``)
instead of bare prints — nodes discovered,
duplicate sightings, bucket splits, lookup outcomes, values seen/
verified and the discovery rate — so a scanner run is scrapeable
exactly like the HTTP gateway: pass ``--metrics-port`` to serve
Prometheus text exposition on ``/metrics`` for the duration of the
scan (and the final registry state is printed with ``--dump-metrics``).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

from ..core.constants import TARGET_NODES
from ..utils.infohash import InfoHash
from ..utils.metrics import MetricsRegistry, serve_metrics
from .common import add_common_args, start_node

__all__ = ["Scanner", "serve_metrics", "main"]

MAX_DEPTH = 12


class Scanner:
    def __init__(self, node, registry: MetricsRegistry | None = None):
        self.node = node
        self.seen = {}
        self.pending = 0
        self.lock = threading.Lock()
        self.done_evt = threading.Event()
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self.m_lookups = r.counter(
            "dht_scanner_lookups_total",
            "Keyspace-split searches completed", ("status",))
        self.m_nodes = r.counter("dht_scanner_nodes_discovered_total",
                                 "Distinct nodes discovered")
        self.m_dup = r.counter(
            "dht_scanner_duplicate_nodes_total",
            "Node sightings already known (dedup hits)")
        self.m_splits = r.counter(
            "dht_scanner_buckets_split_total",
            "Subtrees split into both halves at the next depth")
        self.m_values = r.counter("dht_scanner_values_seen_total",
                                  "Values returned during the crawl")
        self.g_pending = r.gauge("dht_scanner_pending_lookups",
                                 "Searches in flight")
        self.g_depth = r.gauge("dht_scanner_depth_max",
                               "Deepest keyspace split reached")
        self.g_rate = r.gauge(
            "dht_scanner_nodes_per_second",
            "Discovery rate over the whole scan (set at completion)")

    def _on_value(self, vals) -> bool:
        n = len(vals) if hasattr(vals, "__len__") else 1
        self.m_values.inc(n)
        return True

    def step(self, target: InfoHash, depth: int) -> None:
        """ref: step() tools/dhtscanner.cpp:43-67."""
        with self.lock:
            self.pending += 1
            self.g_pending.set(self.pending)
            if depth > self.g_depth.get():
                self.g_depth.set(depth)

        def on_done(ok: bool, nodes) -> None:
            fresh = dup = 0
            with self.lock:
                for n in nodes:
                    if n.id not in self.seen:
                        self.seen[n.id] = n.addr
                        fresh += 1
                    else:
                        dup += 1
            self.m_lookups.inc(status="ok" if ok else "failed")
            if fresh:
                self.m_nodes.inc(fresh)
            if dup:
                self.m_dup.inc(dup)
            if ok and fresh >= TARGET_NODES and depth < MAX_DEPTH:
                self.m_splits.inc()
                for bit in (False, True):
                    self.step(target.set_bit(depth + 1, bit), depth + 1)
            with self.lock:
                self.pending -= 1
                self.g_pending.set(self.pending)
                if self.pending == 0:
                    self.done_evt.set()

        self.node.get(target, self._on_value, on_done)

    def scan(self) -> dict:
        t0 = time.monotonic()
        # Hold a guard ref across the root dispatches: a root lookup
        # completing synchronously would otherwise drop pending to 0
        # and set done_evt while the sibling root is still unscanned
        # (inside on_done the parent's own pending covers the splits).
        with self.lock:
            self.pending += 1
        for bit in (False, True):
            self.step(InfoHash.get_random().set_bit(0, bit), 0)
        with self.lock:
            self.pending -= 1
            self.g_pending.set(self.pending)
            if self.pending == 0:
                self.done_evt.set()
        self.done_evt.wait()
        dt = time.monotonic() - t0
        self.g_rate.set(len(self.seen) / dt if dt > 0 else 0.0)
        print(f"Scan complete: {len(self.seen)} nodes in {dt:.1f}s")
        return self.seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dhtscanner", description=__doc__)
    add_common_args(ap)
    ap.add_argument("--wait", type=float, default=3.0,
                    help="seconds to wait for bootstrap before scanning")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve Prometheus /metrics on this local port "
                         "during the scan (0 = off)")
    ap.add_argument("--dump-metrics", action="store_true",
                    help="print the final Prometheus exposition after "
                         "the node list")
    args = ap.parse_args(argv)
    node = start_node(args)
    time.sleep(args.wait)
    registry = MetricsRegistry()
    srv = (serve_metrics(registry, args.metrics_port)
           if args.metrics_port else None)
    scanner = Scanner(node, registry)
    nodes = scanner.scan()
    for nid, addr in sorted(nodes.items()):
        print(f"{nid} {addr.host}:{addr.port}")
    if args.dump_metrics:
        print(registry.render_prometheus(), end="")
    if srv is not None:
        srv.shutdown()
    node.shutdown()
    node.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
