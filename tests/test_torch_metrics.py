"""The port's metrics registry and Prometheus planes against the JAX
package's: one sequence of counter, gauge, labelled-histogram,
``observe_bulk`` and escaping calls renders the same exposition text and
JSON view in both, with the same refusals; one ``serve_metrics`` GET
returns that text; ``LatencyPlane`` (render, violation ratio, burn rate,
quantiles, windows), ``publish_hop_histogram``, ``SwarmHealthPlane``
(sweep records and the density gauges), ``SoakPlane`` and
``ResidentPlane`` render equally from the same records.  The planes fed
from each package's own engine records are held in
``test_torch_monitor.py``, ``test_torch_resident.py`` and
``test_torch_soak.py``, where those records are made."""

import math
import urllib.request

import numpy as np
import pytest

from opendht_tpu.obs import health as jh
from opendht_tpu.obs import latency as jl
from opendht_tpu.obs import timeline as jt
from opendht_tpu.utils import metrics as jm
from opendht_tpu_torch.obs import health as th
from opendht_tpu_torch.obs import latency as tl
from opendht_tpu_torch.obs import timeline as tt
from opendht_tpu_torch.utils import metrics as tm


def _drive(m):
    """One call sequence on a fresh registry of module ``m``."""
    r = m.MetricsRegistry()
    c = r.counter("dht_msgs_total", "Messages", ("type", "dir"))
    c.inc(type="ping", dir="in")
    c.inc(2.5, type="ping", dir="in")
    c.inc(3, type='fi"nd\\x\nq', dir="out")
    r.counter("dht_plain_total", "Unlabelled")        # never incremented
    assert r.counter("dht_msgs_total", "again", ("type", "dir")) is c
    g = r.gauge("dht_nodes", "Nodes", ("bucket",))
    g.set(7, bucket="0")
    g.add(-2.25, bucket="0")
    g.set(1e-7, bucket="1")
    g.set(float("inf"), bucket="2")
    r.gauge("dht_up", "Up").set(1)
    h = r.histogram("dht_lat_seconds", "Latency", ("op",),
                    buckets=m.Histogram.LATENCY_BUCKETS_S)
    rng = np.random.default_rng(3)
    for v in rng.exponential(0.2, 200):
        h.observe(float(v), op="get")
    h.observe(0.0025, op="put")
    h.observe(100.0, op="put")
    hops = r.histogram("dht_hops", "Hops")
    hops.observe_bulk([1, 0, 4, 2, 0, 0, 1, 3], 37.5)
    hops.observe(3)
    r.histogram("dht_empty", "Never observed", ("op",))
    out = {"text": r.render_prometheus(), "dict": r.to_dict(),
           "q": [h.quantile(q, op="get") for q in (0, 0.5, 0.9, 0.99, 1)]
           + [hops.quantile(0.5), h.quantile(0.5, op="none")],
           "bounds": [h.bucket_bounds_of_quantile(q, op="get")
                      for q in (0.1, 0.5, 0.999)]
           + [h.bucket_bounds_of_quantile(1.0, op="put")],
           "get": [c.get(type="ping", dir="in"), g.get(bucket="9")],
           "series": c.series(), "snap": h.snapshot()}
    errs = []
    for bad in (lambda: r.gauge("dht_msgs_total", "", ("type", "dir")),
                lambda: r.counter("dht_msgs_total", "", ("type",)),
                lambda: r.histogram("dht_lat_seconds", "", ("op",),
                                    buckets=(1.0, 2.0)),
                lambda: c.inc(-1, type="a", dir="b"),
                lambda: c.inc(type="a"),
                lambda: hops.observe_bulk([1, 2], 0.0),
                lambda: h.quantile(1.5, op="get"),
                lambda: m.Histogram("x", "", buckets=())):
        with pytest.raises(ValueError) as e:
            bad()
        errs.append(str(e.value))
    out["errs"] = errs
    return r, out


def _same(a, b):
    """Equal, with NaN equal to NaN."""
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_registry_equal_to_jax():
    _rj, oj = _drive(jm)
    rt, ot = _drive(tm)
    assert oj.keys() == ot.keys()
    for k in oj:
        assert _same(oj[k], ot[k]), k
    text = ot["text"]
    assert text.endswith("\n")
    assert 'type="fi\\"nd\\\\x\\nq"' in text
    assert "dht_nodes{bucket=\"2\"} +Inf" in text
    assert "dht_plain_total 0" in text
    assert tm.PROMETHEUS_CONTENT_TYPE == jm.PROMETHEUS_CONTENT_TYPE
    # The port's unlabelled scratch form (the soak timeline's) needs no
    # help text.
    h = tm.Histogram("scratch", buckets=(1.0, 2.0))
    hj = jm.Histogram("scratch", "", buckets=(1.0, 2.0))
    for x in (h, hj):
        x.observe_bulk([1, 1, 1], 4.0)
    assert h.quantile(0.5) == hj.quantile(0.5) == 1.5


def test_serve_metrics_get():
    reg, out = _drive(tm)
    srv = tm.serve_metrics(reg, 0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"] == \
                tm.PROMETHEUS_CONTENT_TYPE
            body = resp.read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=10)
    finally:
        srv.shutdown()
    assert body == out["text"]


def _latency(m, mh):
    r = mh.MetricsRegistry()
    p = m.LatencyPlane(r, "dht_serve_request", ("klass",),
                       slo_target_s=0.05, slo_objective=0.95)
    rng = np.random.default_rng(8)
    wins = []
    for i, v in enumerate(rng.lognormal(-3.5, 1.0, 300)):
        p.observe(float(v), klass=("get", "put")[i % 3 == 0])
        if i % 100 == 99:
            wins.append(p.take_window())
    errs = []
    for bad in (lambda: p.observe(-1.0, klass="get"),
                lambda: m.LatencyPlane(mh.MetricsRegistry(),
                                       slo_objective=1.0),
                lambda: m.LatencyPlane(mh.MetricsRegistry(),
                                       slo_target_s=0.0)):
        with pytest.raises(ValueError) as e:
            bad()
        errs.append(str(e.value))
    hop = mh.MetricsRegistry()
    m.publish_hop_histogram(hop, [0, 3, 40, 17, 2, 0, 1])
    m.publish_hop_histogram(hop, [0, 1, 4, 1, 0, 0, 9],
                            name="dht_shard_hops", shard="1")
    m.publish_hop_histogram(hop, [2, 0, 1, 1, 0, 0, 0],
                            name="dht_shard_hops", shard="0")
    hh = m.publish_hop_histogram(mh.MetricsRegistry(), np.arange(5))
    return {"text": r.render_prometheus(), "dict": r.to_dict(),
            "ratio": p.violation_ratio, "burn": p.burn_rate,
            "q": [p.quantile(q, klass=k) for q in (0.5, 0.9, 0.99)
                  for k in ("get", "put")], "wins": wins, "errs": errs,
            "hop": hop.render_prometheus(),
            "hop_q": [hh.quantile(q) for q in (0.25, 0.5, 0.75)]}


def test_latency_plane_and_hop_histogram_equal():
    a, b = _latency(jl, jm), _latency(tl, tm)
    for k in a:
        assert _same(a[k], b[k]), k
    assert 0.0 < b["ratio"] < 1.0
    with pytest.raises(ValueError):
        tl.publish_hop_histogram(tm.MetricsRegistry(), [3])


def _health_records():
    """Monitor sweep records in ``MonitorEngine.records``' shape: a
    freshness-off sweep, sweeps with and without confirmed deaths."""
    base = {"sweep": 0, "buckets_probed": 64, "lookups": 64}
    on = dict(base, coverage=0.75, tracked_alive=1500, actual_alive=2000,
              false_alive=12, false_dead=3, age_p50=1.0, age_p99=4.0,
              nodes_seen=1400, lag_count=0, lag_sum=0, lag_max=0)
    return [base, dict(on, sweep=1),
            dict(on, sweep=2, coverage=0.9925, lag_count=5, lag_sum=7,
                 lag_max=3, nodes_seen=1700)]


def test_swarm_health_plane_equal():
    out = []
    for h, m in ((jh, jm), (th, tm)):
        r = m.MetricsRegistry()
        plane = h.SwarmHealthPlane(r)
        for rec in _health_records():
            plane.publish_sweep(rec)
        rng = np.random.default_rng(4)
        prof = plane.publish_density(rng.poisson(6.0, 256))
        small = h.SwarmHealthPlane(m.MetricsRegistry(), prefix="x",
                                   density_depth=2)
        prof2 = small.publish_density([3, 0, 5])
        out.append((r.render_prometheus(), prof, prof2,
                    small.registry.render_prometheus()))
    assert out[0] == out[1]


def _soak_rows():
    rows = []
    for i in range(3):
        rows.append({
            "slot_rounds": {"read": 10 + i, "write": 2, "repub": i,
                            "monitor": 3 * i},
            "admitted": {"read": 5, "write": i}, "completed": {"read": 4},
            "expired": {"write": i}, "sweeps_finished": {"repub": i % 2,
                                                         "monitor": 0},
            "maint_ops": i, "maint_ops_wall_s": 0.1234567 * i,
            "latency_p50_s": None if i == 0 else 0.01 * i,
            "latency_p99_s": None if i == 0 else 0.05 * i,
            "latency_count": 4 * i, "slo_violations": i,
            "occupancy_serve": 0.5, "occupancy_maint": 0.125 * i,
            "coverage": None if i < 2 else 0.98})
    return rows


def _resident_report(xchg):
    return {"elapsed_s": 2.0, "resident": {
        "iterations": 40, "device_rounds": 200,
        "host_orchestration_frac": 0.123456789,
        "host_orchestration_budget": 0.5, "blocked_get_s": 0.3333333,
        "ring_depth_mean": 3.5, "ring_depth_max": 17, "ring_slots": 128,
        "ring_enqueued": 900, "ring_shed": xchg, "rung_select": "device",
        "in_jit_rung_counts": [1, 2, 3],
        "exchange": {"rows_init": 64 * xchg, "rows_round": 7 * xchg,
                     "row_bytes": 72}}}


def test_soak_and_resident_planes_equal():
    outs = []
    for t, m in ((jt, jm), (tt, tm)):
        r = m.MetricsRegistry()
        sp = t.SoakPlane(r)
        for row in _soak_rows():
            sp.publish_interval(row)
        rp = t.ResidentPlane(r)
        rp.publish_run(_resident_report(0))
        rp.publish_run(_resident_report(3))
        outs.append((r.render_prometheus(), r.to_dict(),
                     t.resident_summary(_resident_report(3))))
    assert outs[0] == outs[1]
