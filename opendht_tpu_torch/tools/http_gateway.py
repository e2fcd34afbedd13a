"""HTTP → DHT REST gateway (ref: python/tools/http_server.py, the
Twisted-based gateway in the reference harness); the port's copy of the
JAX package's ``tools/http_gateway.py``.

    GET  /<key>          -> JSON list of values stored at the key
    POST /<key>  (body)  -> put the body as a value; 200 on announce
    GET  /metrics        -> Prometheus text exposition (node metrics)
    GET  /stats.json     -> NodeStats + wire counters as JSON

Keys are free-form strings (SHA-1 hashed) or 40-char hex infohashes.
``metrics`` and ``stats.json`` are reserved paths; a DHT key with one
of those literal names must be queried by its 40-char hex form.

Every proxied DHT request is timed end-to-end (HTTP arrival →
callback completion) into the per-request latency plane
(``opendht_tpu_torch.obs.latency.LatencyPlane``): ``/metrics`` exposes
``dht_gateway_request_latency_seconds{op="get"|"put"}`` plus the SLO
gauge set (target, violation ratio, error-budget burn rate) — the
host-path twin of the serve bench's gauges, tunable with ``--slo-ms``.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..core.value import Value
from ..obs.latency import LatencyPlane
from ..utils.infohash import InfoHash
from ..utils.metrics import PROMETHEUS_CONTENT_TYPE
from ..utils.sockaddr import AF_INET, AF_INET6
from .common import add_common_args, start_node


def _h(word: str) -> InfoHash:
    return InfoHash(word) if len(word) == 40 else InfoHash.get(word)


def node_stats_json(node) -> dict:
    """JSON-able snapshot for /stats.json: per-af NodeStats + the
    canonical wire counters."""
    stats_in, stats_out = node.get_stats()
    return {
        "node_id": str(node.get_node_id()),
        "status": node.get_status() if hasattr(node, "get_status")
        else None,
        "ipv4": node.get_node_stats(AF_INET).to_dict(),
        "ipv6": node.get_node_stats(AF_INET6).to_dict(),
        "messages": {"in": stats_in, "out": stats_out},
    }


def make_handler(node, latency: LatencyPlane | None = None):
    if latency is None:
        latency = LatencyPlane(node.metrics, prefix="dht_gateway_request",
                               label_names=("op",))

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, text: str,
                        ctype: str = PROMETHEUS_CONTENT_TYPE) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            key = self.path.strip("/")
            if key == "metrics":
                # Refresh derived gauges at scrape time so the scrape
                # reflects the node NOW, not the last maintenance tick.
                # These are cross-thread diagnostics reads of loop-
                # thread state (snapshot-copied in update_metrics); a
                # scrape racing a resize returns 503 and the scraper
                # simply retries — never a crashed handler.
                try:
                    node.dht.update_metrics()
                    body = node.metrics.render_prometheus()
                except RuntimeError:
                    self._reply(503, {"error": "stats race, retry"})
                    return
                self._reply_text(200, body)
                return
            if key == "stats.json":
                try:
                    obj = node_stats_json(node)
                except RuntimeError:
                    self._reply(503, {"error": "stats race, retry"})
                    return
                self._reply(200, obj)
                return
            if not key:
                self._reply(400, {"error": "missing key"})
                return
            t0 = time.perf_counter()
            done = threading.Event()
            vals = []

            def gcb(vs):
                vals.extend(vs)
                return True

            node.get(_h(key), gcb, lambda ok, nodes: done.set())
            done.wait(timeout=30)
            latency.observe(time.perf_counter() - t0, op="get")
            self._reply(200, [
                {"id": f"{v.id:016x}", "type": v.type,
                 "data": base64.b64encode(v.data).decode(),
                 "signed": v.is_signed(), "encrypted": v.is_encrypted()}
                for v in vals])

        def do_POST(self):
            key = self.path.strip("/")
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            if not key or not data:
                self._reply(400, {"error": "missing key or body"})
                return
            t0 = time.perf_counter()
            done = threading.Event()
            res = {}

            def dcb(ok, nodes):
                res["ok"] = ok
                done.set()

            node.put(_h(key), Value(data), dcb)
            done.wait(timeout=30)
            latency.observe(time.perf_counter() - t0, op="put")
            self._reply(200 if res.get("ok") else 502,
                        {"ok": res.get("ok", False)})

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="http_gateway", description=__doc__)
    add_common_args(ap)
    ap.add_argument("--http-port", type=int, default=8080)
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="per-request latency SLO target for the "
                         "gateway gauge set (milliseconds)")
    args = ap.parse_args(argv)
    if args.slo_ms <= 0:
        ap.error(f"--slo-ms must be > 0, got {args.slo_ms}")
    node = start_node(args)
    latency = LatencyPlane(node.metrics, prefix="dht_gateway_request",
                           label_names=("op",),
                           slo_target_s=args.slo_ms / 1e3)
    srv = ThreadingHTTPServer(("127.0.0.1", args.http_port),
                              make_handler(node, latency))
    print(f"HTTP gateway on 127.0.0.1:{args.http_port} "
          f"(DHT port {node.get_bound_port()})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    node.shutdown()
    node.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
