"""The soak timeline, its interference ledger, and the resident loop's
headline aggregates.

The port's own copies of ``SoakTimeline``, ``_p99_of``,
``interference_ledger`` and ``resident_summary`` from
``opendht_tpu/obs/timeline.py`` (host arithmetic on the soak and
resident loops' bookkeeping; no tensors).  A :class:`SoakTimeline` cuts a
:func:`~opendht_tpu_torch.models.soak.soak_open_loop` run into fixed wall
intervals and books, per interval, the serve plane (arrivals, admissions,
completions and expiries per work class, a latency histogram, SLO
violations), the slot plane (slot-rounds split serve vs maintenance: the
split from the device work-class plane, the total from the host's
occupancy), the maintenance plane (sweeps, store-sweep ops with their
walls, the monitor's coverage) and cumulative lifecycle snapshots.
:func:`interference_ledger` aligns a maintenance-on and a
maintenance-off timeline over one schedule and attributes the serve-p99
delta to maintenance-active intervals.  :class:`SoakPlane` and
:class:`ResidentPlane` publish the soak timeline's rows and a resident
serve report through the Prometheus registry
(:mod:`opendht_tpu_torch.utils.metrics`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.metrics import Histogram, MetricsRegistry

# Work-class names, mirrored from models.soak (this module imports no
# tensor code).
WCLASS_NAMES = ("read", "write", "repub", "monitor")
SERVE_NAMES = ("read", "write")
MAINT_NAMES = ("repub", "monitor")


class SoakTimeline:
    """Per-wall-interval accumulator for one soak run.

    ``interval_s`` fixes the row width (both A/B runs must use the
    same width or the ledger cannot align them); ``slots`` the serve
    slot count (occupancy denominators); ``bounds`` the latency
    histogram bucket bounds (default: the Prometheus latency shape);
    ``slo_target_s`` the per-request SLO the violation counts key on.

    All ``note_*`` timestamps are seconds on the soak clock (monotone
    within a run).  Scan completions count toward the interval's
    ``completed`` but NOT its latency histogram — scans execute
    through the trie engine at a different latency scale, and mixing
    them in would blur exactly the serve-tail signal the interference
    ledger exists to isolate (their latencies are summarized
    separately).
    """

    def __init__(self, interval_s: float, slots: int,
                 bounds: Optional[Sequence[float]] = None,
                 slo_target_s: float = 0.25):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got "
                             f"{interval_s}")
        self.interval_s = float(interval_s)
        self.slots = int(slots)
        self.bounds = [float(b) for b in
                       (bounds or Histogram.LATENCY_BUCKETS_S)]
        self.slo_target_s = float(slo_target_s)
        self.rows: List[dict] = []
        self._i = 0
        self._cur = self._new_row(0)
        self._closed = False

    # -- row plumbing --------------------------------------------------

    def _new_row(self, i: int) -> dict:
        z = {w: 0 for w in WCLASS_NAMES}
        return {
            "i": i,
            "t_start": round(i * self.interval_s, 6),
            "t_end": round((i + 1) * self.interval_s, 6),
            "arrivals": dict(z, scan=0, chunk=0),
            "admitted": dict(z),
            "completed": dict(z, scan=0, chunk=0),
            "expired": dict(z),
            "queue_samples": [],
            "bursts": 0,
            "rounds": 0,
            "total_slot_rounds": 0,
            "slot_rounds": dict(z),
            "latency_counts": [0] * (len(self.bounds) + 1),
            "latency_sum_s": 0.0,
            "slo_violations": 0,
            "scan_latency_sum_s": 0.0,
            "chunk_latency_sum_s": 0.0,
            "maint_ops": 0,
            "maint_ops_wall_s": 0.0,
            "other_ops": 0,
            "other_ops_wall_s": 0.0,
            "ops": [],
            "sweeps_finished": {"repub": 0, "monitor": 0},
            "coverage": None,
            "lifecycle": None,
        }

    def _roll(self, t: float) -> None:
        if self._closed:
            raise RuntimeError("timeline already closed")
        while t >= (self._i + 1) * self.interval_s:
            self._finalize_cur()
            self._i += 1
            self._cur = self._new_row(self._i)

    def _finalize_cur(self) -> None:
        row = self._cur
        qs = row.pop("queue_samples")
        row["queue_depth_mean"] = round(float(np.mean(qs)), 2) \
            if qs else 0.0
        row["queue_depth_max"] = int(np.max(qs)) if qs else 0
        n_lat = int(sum(row["latency_counts"]))
        row["latency_count"] = n_lat
        row["latency_sum_s"] = round(row["latency_sum_s"], 6)
        if n_lat:
            h = Histogram("soak_interval", "", buckets=self.bounds)
            h.observe_bulk(row["latency_counts"],
                           row["latency_sum_s"])
            row["latency_p50_s"] = round(h.quantile(0.50), 6)
            row["latency_p99_s"] = round(h.quantile(0.99), 6)
        else:
            row["latency_p50_s"] = None
            row["latency_p99_s"] = None
        denom = self.slots * row["rounds"]
        row["occupancy_serve"] = round(
            sum(row["slot_rounds"][w] for w in SERVE_NAMES)
            / denom, 4) if denom else 0.0
        row["occupancy_maint"] = round(
            sum(row["slot_rounds"][w] for w in MAINT_NAMES)
            / denom, 4) if denom else 0.0
        row["maint_ops_wall_s"] = round(row["maint_ops_wall_s"], 6)
        row["other_ops_wall_s"] = round(row["other_ops_wall_s"], 6)
        row["scan_latency_sum_s"] = round(row["scan_latency_sum_s"], 6)
        row["chunk_latency_sum_s"] = round(
            row["chunk_latency_sum_s"], 6)
        self.rows.append(row)

    # -- the note surface ---------------------------------------------

    def note_arrival(self, cls: str, t: float) -> None:
        self._roll(t)
        self._cur["arrivals"][cls] += 1

    def note_queue(self, depth: int, t: float) -> None:
        self._roll(t)
        self._cur["queue_samples"].append(depth)

    def note_admit(self, counts: Dict[str, int], t: float) -> None:
        self._roll(t)
        for cls, n in counts.items():
            self._cur["admitted"][cls] += n

    def note_complete(self, cls: str, latency_s: Optional[float],
                      t: float) -> None:
        self._roll(t)
        self._cur["completed"][cls] += 1
        if latency_s is None or cls in ("scan", "chunk"):
            # Station-served classes (scans, chunked reads/writes)
            # complete outside the slot plane at a different latency
            # scale — summarized separately, never mixed into the
            # serve histogram the interference ledger isolates.
            if latency_s is not None:
                self._cur[f"{cls}_latency_sum_s"] += latency_s
            return
        b = int(np.searchsorted(self.bounds, latency_s, side="left"))
        self._cur["latency_counts"][b] += 1
        self._cur["latency_sum_s"] += latency_s
        if latency_s > self.slo_target_s:
            self._cur["slo_violations"] += 1

    def note_expire(self, cls: str, t: float) -> None:
        self._roll(t)
        self._cur["expired"][cls] += 1

    def note_burst(self, rounds: int, entry_occ: Sequence[int],
                   retired: Sequence[int], dev_active: Sequence[int],
                   t: float) -> None:
        """Book one burst: ``entry_occ`` is the HOST's per-class slot
        occupancy at burst entry, ``retired``/``dev_active`` the
        harvest's per-class retirements and the DEVICE plane's
        per-class active counts after it.  The row's total uses the
        host side, the split uses the device side — the checker's
        cross-observer identity."""
        self._roll(t)
        row = self._cur
        row["bursts"] += 1
        row["rounds"] += rounds
        row["total_slot_rounds"] += rounds * int(sum(entry_occ))
        for x, w in enumerate(WCLASS_NAMES):
            row["slot_rounds"][w] += rounds * (
                int(retired[x]) + int(dev_active[x]))

    def note_lifecycle(self, by_class: Dict[str, Dict[str, int]],
                       t: float) -> None:
        """Cumulative per-class lifecycle counters; the value standing
        at each interval boundary is the row's conservation
        snapshot."""
        self._roll(t)
        self._cur["lifecycle"] = {
            cls: dict(v) for cls, v in by_class.items()}

    def note_op(self, name: str, t: float, wall_s: float,
                maint: bool = True) -> None:
        """Book an out-of-band op with its wall.  ``maint=False`` for
        work that runs in BOTH A/B arms (write flushes, scenario
        faults): only true maintenance ops may mark an interval
        maintenance-active, or the interference ledger would attribute
        churn/write costs to maintenance — the exact mis-attribution
        the A/B exists to rule out."""
        self._roll(t)
        kind = "maint_ops" if maint else "other_ops"
        self._cur[kind] += 1
        self._cur[f"{kind}_wall_s"] += wall_s
        self._cur["ops"].append(
            {"op": name, "t": round(t, 4),
             "wall_s": round(wall_s, 6), "maint": bool(maint)})

    def note_sweep(self, kind: str, record: dict, t: float) -> None:
        self._roll(t)
        self._cur["sweeps_finished"][kind] += 1
        if kind == "monitor" and "coverage" in record:
            self._cur["coverage"] = record["coverage"]

    def close(self, t: float) -> None:
        """Finalize through ``t`` (the run's elapsed wall)."""
        if self._closed:
            return
        self._roll(t + self.interval_s)  # flush the holding row
        # _roll appended up to and including the row containing t;
        # drop trailing all-empty rows past the run end.
        while self.rows and self.rows[-1]["t_start"] > t:
            self.rows.pop()
        self._closed = True

    # -- export --------------------------------------------------------

    def to_obj(self) -> dict:
        return {
            "interval_s": self.interval_s,
            "slots": self.slots,
            "slo_target_s": self.slo_target_s,
            "latency_bounds_s": self.bounds,
            "rows": self.rows,
        }


def _p99_of(rows: Sequence[dict], bounds: Sequence[float],
            q: float = 0.99) -> Optional[float]:
    counts = np.sum([r["latency_counts"] for r in rows], axis=0) \
        if rows else np.zeros(len(bounds) + 1)
    if counts.sum() == 0:
        return None
    h = Histogram("ledger_agg", "", buckets=list(bounds))
    h.observe_bulk([int(v) for v in counts], 0.0)
    return round(h.quantile(q), 6)


def interference_ledger(on: dict, off: dict) -> dict:
    """Attribute the serve-p99 delta to maintenance bursts.

    ``on``/``off`` are two :meth:`SoakTimeline.to_obj` exports over
    the SAME arrival schedule — one with maintenance interleaved, one
    without (the A/B contract: writes, scans and scenario faults run
    in both arms; only republish/monitor/listener maintenance is
    withheld).  Returns per-aligned-interval delta rows plus the
    attribution summary: the overall bucket-derived p99 of each arm,
    the p99 delta on maintenance-ACTIVE intervals vs quiet ones, and
    the maintenance work that ran (slot-rounds, op walls).

    Raises if the two arms disagree on interval width or latency
    bounds — misaligned ledgers attribute nothing.
    """
    if on["interval_s"] != off["interval_s"]:
        raise ValueError(
            f"interval mismatch: on={on['interval_s']} vs "
            f"off={off['interval_s']} — the A/B arms cannot align")
    if list(on["latency_bounds_s"]) != list(off["latency_bounds_s"]):
        raise ValueError("latency bounds differ between the A/B arms")
    bounds = on["latency_bounds_s"]
    rows_on, rows_off = on["rows"], off["rows"]
    n = min(len(rows_on), len(rows_off))
    deltas = []
    active_d, quiet_d = [], []
    for i in range(n):
        a, b = rows_on[i], rows_off[i]
        maint_rounds = sum(a["slot_rounds"][w] for w in MAINT_NAMES)
        maint_active = maint_rounds > 0 or a["maint_ops"] > 0
        p_on, p_off = a["latency_p99_s"], b["latency_p99_s"]
        d = round(p_on - p_off, 6) \
            if p_on is not None and p_off is not None else None
        deltas.append({
            "i": i,
            "maint_active": bool(maint_active),
            "maint_slot_rounds": int(maint_rounds),
            "maint_ops_wall_s": a["maint_ops_wall_s"],
            "p99_on_s": p_on,
            "p99_off_s": p_off,
            "p99_delta_s": d,
        })
        if d is not None:
            (active_d if maint_active else quiet_d).append(d)
    p99_on = _p99_of(rows_on, bounds)
    p99_off = _p99_of(rows_off, bounds)
    return {
        "interval_s": on["interval_s"],
        "intervals_compared": n,
        "p99_on_s": p99_on,
        "p99_off_s": p99_off,
        "p99_delta_s": round(p99_on - p99_off, 6)
        if p99_on is not None and p99_off is not None else None,
        "p50_on_s": _p99_of(rows_on, bounds, 0.50),
        "p50_off_s": _p99_of(rows_off, bounds, 0.50),
        "maint_active_intervals": len(active_d),
        "p99_delta_maint_mean_s": round(float(np.mean(active_d)), 6)
        if active_d else None,
        "p99_delta_maint_max_s": round(float(np.max(active_d)), 6)
        if active_d else None,
        "p99_delta_quiet_mean_s": round(float(np.mean(quiet_d)), 6)
        if quiet_d else None,
        "maint_slot_rounds_total": int(sum(
            d["maint_slot_rounds"] for d in deltas)),
        "maint_ops_wall_total_s": round(sum(
            d["maint_ops_wall_s"] for d in deltas), 6),
        "intervals": deltas,
    }


class SoakPlane:
    """The soak gauge catalogue on the registry (``prefix``
    defaults to ``dht_soak``):

    * counters ``<p>_slot_rounds_total{wclass}``,
      ``<p>_requests_total{op,event}`` (event ∈ admitted / completed /
      expired), ``<p>_sweeps_total{kind}``, ``<p>_maint_ops_total``;
    * gauges ``<p>_interval_latency_seconds{q}`` (last interval's
      bucket-derived p50/p99), ``<p>_interval_slo_violation_ratio``,
      ``<p>_occupancy_ratio{side}``, ``<p>_monitor_coverage_ratio``,
      ``<p>_maint_ops_wall_seconds`` (cumulative).
    """

    def __init__(self, registry: MetricsRegistry,
                 prefix: str = "dht_soak"):
        self.registry = registry
        c, g = registry.counter, registry.gauge
        self._rounds = c(f"{prefix}_slot_rounds_total",
                         "Dispatched slot-rounds", ("wclass",))
        self._reqs = c(f"{prefix}_requests_total",
                       "Request lifecycle events", ("op", "event"))
        self._sweeps = c(f"{prefix}_sweeps_total",
                         "Maintenance sweeps finished", ("kind",))
        self._ops = c(f"{prefix}_maint_ops_total",
                      "Slot-free maintenance store sweeps")
        self._lat = g(f"{prefix}_interval_latency_seconds",
                      "Bucket-derived interval latency quantile",
                      ("q",))
        self._slo = g(f"{prefix}_interval_slo_violation_ratio",
                      "SLO violations over completions, last interval")
        self._occ = g(f"{prefix}_occupancy_ratio",
                      "Slot-round occupancy share of the interval",
                      ("side",))
        self._cov = g(f"{prefix}_monitor_coverage_ratio",
                      "Monitor coverage after the last finished sweep")
        self._opw = g(f"{prefix}_maint_ops_wall_seconds",
                      "Cumulative slot-free maintenance wall")
        self._ops_wall = 0.0

    def publish_interval(self, row: dict) -> None:
        for w in WCLASS_NAMES:
            self._rounds.inc(row["slot_rounds"][w], wclass=w)
        for op_name in row["admitted"]:
            self._reqs.inc(row["admitted"][op_name], op=op_name,
                           event="admitted")
        for op_name in row["completed"]:
            self._reqs.inc(row["completed"][op_name], op=op_name,
                           event="completed")
        for op_name in row["expired"]:
            self._reqs.inc(row["expired"][op_name], op=op_name,
                           event="expired")
        for kind, nswp in row["sweeps_finished"].items():
            if nswp:
                self._sweeps.inc(nswp, kind=kind)
        if row["maint_ops"]:
            self._ops.inc(row["maint_ops"])
        self._ops_wall += row["maint_ops_wall_s"]
        self._opw.set(round(self._ops_wall, 6))
        if row["latency_p50_s"] is not None:
            self._lat.set(row["latency_p50_s"], q="p50")
            self._lat.set(row["latency_p99_s"], q="p99")
        n_lat = row.get("latency_count", 0)
        if n_lat:
            self._slo.set(round(row["slo_violations"] / n_lat, 6))
        self._occ.set(row["occupancy_serve"], side="serve")
        self._occ.set(row["occupancy_maint"], side="maint")
        if row["coverage"] is not None:
            self._cov.set(row["coverage"])


def resident_summary(report: dict) -> dict:
    """Derive the resident loop's headline aggregates from a
    :func:`~opendht_tpu_torch.models.serve.serve_resident` report — the
    shared arithmetic between the bench's printed summary, the trace
    artifact and ``check_trace``'s resident block, so all three read
    the SAME numbers.

    ``overlap_frac`` is the double-buffer's yield: the share of the
    run wall spent blocked in the drain's read — near 0 means
    the readback fully overlapped device compute, near 1 means the
    loop degenerated to the burst engine's sync cadence.
    ``exchange_mb`` prices the routed exchange from the row counters
    (0 on the local engine) — the number that drops when mesh cache
    hits skip the ``all_to_all``.
    """
    r = report["resident"]
    elapsed = report["elapsed_s"]
    iters = r["iterations"]
    xchg = r["exchange"]
    rows = xchg["rows_init"] + xchg["rows_round"]
    return {
        "iterations": iters,
        "device_rounds": r["device_rounds"],
        "rounds_per_macro": (r["device_rounds"] / iters
                             if iters else 0.0),
        "host_orchestration_frac": r["host_orchestration_frac"],
        "host_orchestration_budget": r["host_orchestration_budget"],
        "overlap_frac": (r["blocked_get_s"] / elapsed
                         if elapsed > 0 else 0.0),
        "ring_utilization": (r["ring_depth_mean"] / r["ring_slots"]
                             if r["ring_slots"] else 0.0),
        "ring_shed": r["ring_shed"],
        "rung_select": r["rung_select"],
        "in_jit_rung_counts": list(r["in_jit_rung_counts"]),
        "exchange_rows": rows,
        "exchange_mb": rows * xchg["row_bytes"] / 1e6,
    }


class ResidentPlane:
    """Resident serve-loop gauges on the registry (``prefix``
    defaults to ``dht_resident``): counters for macro iterations,
    device rounds, ring lifecycle events (enqueued / shed) and routed-
    exchange rows, plus gauges for the host-orchestration share, the
    drain-blocked (non-overlapped) share and the ring depth — the
    Prometheus face of :func:`resident_summary`."""

    def __init__(self, registry: MetricsRegistry,
                 prefix: str = "dht_resident"):
        self.registry = registry
        c, g = registry.counter, registry.gauge
        self._iters = c(f"{prefix}_macro_iterations_total",
                        "Resident macro steps dispatched")
        self._rounds = c(f"{prefix}_device_rounds_total",
                         "Lookup rounds run inside resident programs")
        self._ring = c(f"{prefix}_ring_events_total",
                       "Request-ring lifecycle events", ("event",))
        self._xchg = c(f"{prefix}_exchange_rows_total",
                       "Routed-exchange rows", ("leg",))
        self._orch = g(f"{prefix}_host_orchestration_ratio",
                       "Host share of the serve wall")
        self._blocked = g(f"{prefix}_drain_blocked_ratio",
                          "Non-overlapped drain share of the wall")
        self._depth = g(f"{prefix}_ring_depth",
                        "Device ring backlog", ("stat",))

    def publish_run(self, report: dict) -> None:
        r = report["resident"]
        self._iters.inc(r["iterations"])
        self._rounds.inc(r["device_rounds"])
        self._ring.inc(r["ring_enqueued"], event="enqueued")
        if r["ring_shed"]:
            self._ring.inc(r["ring_shed"], event="shed")
        xchg = r["exchange"]
        if xchg["rows_init"]:
            self._xchg.inc(xchg["rows_init"], leg="init")
        if xchg["rows_round"]:
            self._xchg.inc(xchg["rows_round"], leg="round")
        s = resident_summary(report)
        self._orch.set(round(s["host_orchestration_frac"], 6))
        self._blocked.set(round(s["overlap_frac"], 6))
        self._depth.set(r["ring_depth_mean"], stat="mean")
        self._depth.set(r["ring_depth_max"], stat="max")
