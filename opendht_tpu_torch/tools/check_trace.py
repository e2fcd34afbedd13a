"""Validate a flight-recorder or cost-ledger bench artifact.

The gate's trace leg runs a small-N bench with the recorder on, then
this checker proves the artifact is USABLE — it parses, the per-round
counters are shape-consistent and monotone where the semantics demand
it, and the trace agrees with the BENCH row it rode along with (the
degradation numbers must be explainable FROM the trace, or the
recorder is decoration).  Exit 0 on success; exit 1 with one line per
violation otherwise.

    python -m opendht_tpu_torch.tools.check_trace /tmp/trace.json
    python -m opendht_tpu_torch.tools.check_trace /tmp/ledger.json
    python -m opendht_tpu_torch.tools.check_trace /tmp/serve.json
    python -m opendht_tpu_torch.tools.check_trace MONITOR_r08.json

``swarm_monitor_trace`` artifacts (``bench.py --mode monitor
--monitor-out``) get the swarm-health checks: per-sweep freshness
conservation, churn-detection lag within the scheduler's stated bound,
and the measured hop histogram within the stated band of the analytic
hop-count model — recomputed here from the swarm geometry, the repo's
first MODEL-BASED fidelity gate (see :func:`check_monitor_obj`).

``swarm_serve_trace`` artifacts (``bench.py --mode serve
--serve-out``) get the serve-plane checks: lifecycle conservation
(admitted == completed + in-flight), non-negative latencies, the
latency histogram agreeing with the bench row's request count, and
every reported quantile falling inside the histogram bucket that holds
it (see :func:`check_serve_obj`).

``cost_ledger`` artifacts (``bench.py --ledger-out``) get the cost
checks instead: round sub-phase rows must sum to the bench's measured
``round_wall_p50`` within ``LEDGER_SUM_TOL`` (an attribution that
can't reproduce the fused round is priced fiction), repub-profile rows
must sum to the measured sweep wall, FLOPs/bytes must be non-negative,
peak HBM ≥ live HBM, and the attribution pass's compile count must be
zero (a compile inside a burst clock poisons ``round_wall_p50``).

The port's own copy of ``opendht_tpu/tools/check_trace.py``: the same
public names, tolerances and messages, so the two give one verdict on
one artifact; the hop model and the histogram come from the port's
``obs/health.py`` and ``utils/metrics.py``.
"""

from __future__ import annotations

import json
import sys
from typing import List

COUNTERS = ("requests", "replies", "drops", "poison", "strikes",
            "convictions", "churn", "done", "active_rows")


def check_trace_obj(obj: dict) -> List[str]:
    """All violations found in a loaded trace artifact (empty = pass)."""
    errs: List[str] = []
    for field in ("kind", "bench", "trace", "hop_histogram"):
        if field not in obj:
            errs.append(f"missing top-level field {field!r}")
    if errs:
        return errs
    bench, trace, hist = obj["bench"], obj["trace"], obj["hop_histogram"]

    rounds = trace.get("rounds", 0)
    n_lookups = trace.get("n_lookups") or bench.get("n_lookups", 0)
    if rounds < 1:
        errs.append(f"trace recorded {rounds} rounds; expected >= 1")
    if not 0 < rounds <= trace.get("max_steps", 0):
        errs.append(f"rounds {rounds} outside (0, max_steps "
                    f"{trace.get('max_steps')}]")

    counters = trace.get("counters", {})
    for name in COUNTERS:
        row = counters.get(name)
        if row is None:
            errs.append(f"counter {name!r} missing")
            continue
        if len(row) != rounds:
            errs.append(f"counter {name!r} has {len(row)} rows for "
                        f"{rounds} rounds")
        if any(v < 0 for v in row):
            errs.append(f"counter {name!r} went negative: {row}")
    if errs:
        return errs

    # Semantics-mandated monotonicity/consistency:
    done = counters["done"]
    if any(b < a for a, b in zip(done, done[1:])):
        errs.append(f"done gauge not monotone: {done}")
    if counters["requests"][0] <= 0:
        errs.append("round 0 issued no solicitations")
    for r, (d, req) in enumerate(zip(counters["drops"],
                                     counters["requests"])):
        if d > req:
            errs.append(f"round {r}: drops {d} > requests {req}")
    # The active-rows gauge (pending at round entry) must never grow —
    # done is monotone — and must be the exact complement of the
    # previous round's done gauge (this survives merge_traces' fills:
    # a converged chunk contributes 0 pending and L done).
    active = counters["active_rows"]
    if any(b > a for a, b in zip(active, active[1:])):
        errs.append(f"active_rows gauge increased: {active}")
    if n_lookups:
        if active[0] != n_lookups:
            errs.append(f"round 0 active_rows {active[0]} != "
                        f"{n_lookups} lookups")
        for r in range(1, rounds):
            if active[r] != n_lookups - done[r - 1]:
                errs.append(
                    f"round {r}: active_rows {active[r]} != lookups - "
                    f"done[{r - 1}] = {n_lookups - done[r - 1]}")
                break
        wasted = trace.get("wasted_row_rounds")
        want_wasted = sum(n_lookups - a for a in active)
        if wasted is not None and wasted != want_wasted:
            errs.append(f"wasted_row_rounds {wasted} != sum(L - "
                        f"active) = {want_wasted}")

    # Cross-check against the bench row the trace must explain.  The
    # chaos-lookup mode nests its traced leg's numbers under
    # bench["headline"] (the trace rides that leg), so fall back there
    # — otherwise chaos artifacts would skip these checks entirely.
    headline = bench.get("headline")
    row = headline if isinstance(headline, dict) else {}
    if n_lookups:
        final_frac = done[-1] / n_lookups
        reported = bench.get("done_frac", row.get("done_frac"))
        if reported is not None and abs(final_frac - reported) > 1e-6:
            errs.append(f"trace final done_frac {final_frac:.6f} != "
                        f"bench done_frac {reported:.6f}")
        if sum(hist) != n_lookups:
            errs.append(f"hop histogram sums to {sum(hist)}, expected "
                        f"{n_lookups} lookups")
    # A usable recall needs converged lookups; a trace whose done gauge
    # never moved cannot explain any recall > 0.
    recall = bench.get("recall_at_8", row.get("recall_at_8"))
    if recall and recall > 0 and done[-1] == 0:
        errs.append(f"bench reports recall {recall} but the trace saw "
                    f"0 lookups converge")

    # Phase attribution (round 9): when the bench row carries the
    # init/loop/finalize split, the parts must be non-negative and sum
    # to the attribution pass's total (they are measured back-to-back,
    # so only the per-field rounding can open a gap), and the per-round
    # p50 must be a positive figure that fits inside the loop phase.
    phase = bench.get("phase_wall")
    if phase is not None:
        parts = ("init_s", "loop_s", "finalize_s", "total_s")
        missing = [p for p in parts if not isinstance(
            phase.get(p), (int, float))]
        if missing:
            errs.append(f"phase_wall missing/non-numeric {missing}")
        else:
            if any(phase[p] < 0 for p in parts):
                errs.append(f"phase_wall has negative phases: {phase}")
            gap = abs(phase["init_s"] + phase["loop_s"]
                      + phase["finalize_s"] - phase["total_s"])
            if gap > max(1e-3, 0.01 * phase["total_s"]):
                errs.append(f"phase_wall parts sum off total by "
                            f"{gap:.4f}s: {phase}")
    p50 = bench.get("round_wall_p50")
    if p50 is not None:
        if not (isinstance(p50, (int, float)) and p50 > 0):
            errs.append(f"round_wall_p50 not a positive number: {p50}")
        elif phase is not None and not missing \
                and p50 > phase["loop_s"] + 1e-9:
            errs.append(f"round_wall_p50 {p50} exceeds the whole loop "
                        f"phase {phase['loop_s']}")
    return errs


# Relative tolerance for "attributed rows must sum to the measured
# wall" — both the round sub-phases vs round_wall_p50 and the
# repub-profile rows vs the sweep wall (±10%).
LEDGER_SUM_TOL = 0.10
# Absolute grace: burst-clock round walls carry a fixed per-burst cost
# (dispatch + the done-check readback, amortized over the burst's
# rounds) that a barriered best-of phase pass never sees.  That cost
# is milliseconds regardless of round size, so on sub-10 ms rounds
# (tiny profiling configs) it would swamp the relative tolerance while
# meaning nothing about attribution quality.  Production-size rounds
# (the gate's 0.4 s, the 10M 97 ms) are gated by the 10 % term.
LEDGER_SUM_ABS_TOL_S = 0.005


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _check_phase_rows(rows, total: float, what: str, target_name: str,
                      errs: List[str], allow_negative_frac: float = 0.0
                      ) -> None:
    """Shared row validation: numeric non-negative walls (phase rows
    from telescoping prefix diffs may carry bounded timing noise below
    zero), non-negative FLOPs/bytes, and the ±10% sum-to-measured-wall
    consistency gate."""
    if not rows:
        errs.append(f"{what}: no rows")
        return
    # Relative grace for telescoped-row noise, plus 1 ms absolute so
    # sub-millisecond rounds (tiny test swarms) don't trip on clock
    # granularity.  (A missing/invalid total is reported below; it
    # must not crash the row checks here.)
    tot = total if _num(total) else 0.0
    floor = -(allow_negative_frac * max(tot, 0.0)
              + (1e-3 if allow_negative_frac else 0.0))
    for row in rows:
        name = row.get("phase", "?")
        w = row.get("wall_s")
        if not _num(w):
            errs.append(f"{what} row {name!r}: non-numeric wall_s {w!r}")
            return
        if w < floor:
            errs.append(f"{what} row {name!r}: wall_s {w} below noise "
                        f"floor {floor:.6f}")
        for field in ("flops", "bytes_accessed"):
            v = row.get(field)
            if v is not None and (not _num(v) or v < 0):
                errs.append(f"{what} row {name!r}: {field} {v!r} "
                            f"negative or non-numeric")
    if _num(total) and total > 0:
        s = sum(row["wall_s"] for row in rows)
        if abs(s - total) > max(LEDGER_SUM_TOL * total,
                                LEDGER_SUM_ABS_TOL_S):
            errs.append(
                f"{what} rows sum to {s:.4f}s but the measured "
                f"{target_name} is {total:.4f}s — drift "
                f"{abs(s - total) / total:.1%} > {LEDGER_SUM_TOL:.0%}")
    else:
        errs.append(f"{what}: measured {target_name} missing or "
                    f"non-positive ({total!r})")


def check_ledger_obj(obj: dict) -> List[str]:
    """All violations found in a loaded cost-ledger artifact (empty =
    pass).  See the module docstring for the contract."""
    errs: List[str] = []
    for field in ("platform", "hbm", "kernels"):
        if field not in obj:
            errs.append(f"missing top-level field {field!r}")
    if errs:
        return errs

    hbm = obj["hbm"]
    live, peak = hbm.get("live_bytes"), hbm.get("peak_bytes")
    if not (_num(live) and live >= 0):
        errs.append(f"hbm live_bytes invalid: {live!r}")
    if not (_num(peak) and _num(live) and peak >= live):
        errs.append(f"hbm peak_bytes {peak!r} < live_bytes {live!r} "
                    f"(a peak below live is not a watermark)")

    if not obj["kernels"]:
        errs.append("no kernels recorded — the ledger observed nothing")
    for k in obj["kernels"]:
        name = k.get("name", "?")
        if not (_num(k.get("calls")) and k["calls"] >= 1):
            errs.append(f"kernel {name!r}: calls {k.get('calls')!r}")
        if not (_num(k.get("wall_s")) and k["wall_s"] >= 0):
            errs.append(f"kernel {name!r}: wall_s {k.get('wall_s')!r}")
        for field in ("flops", "bytes_accessed"):
            v = k.get(field)
            if v is not None and (not _num(v) or v < 0):
                errs.append(f"kernel {name!r}: {field} {v!r} negative "
                            f"or non-numeric")

    bench = obj.get("bench") or {}
    rp = obj.get("round_phases")
    if rp is not None:
        # Cross-check target: the table's own recorded target first —
        # the bench writes the FULL-WIDTH burst-clock p50 there (the
        # sub-phase table measures a full-width round; the all-rounds
        # bench p50 includes the ladder's shrunken rounds and would
        # book compaction savings as drift) — else the bench row's
        # p50, else the ledger's independently compiled lookup_step
        # timing (sharded-mode artifacts).
        p50 = (rp.get("round_wall_p50")
               or bench.get("round_wall_p50")
               or rp.get("lookup_step_wall_s"))
        _check_phase_rows(rp.get("rows"), p50, "round_phases",
                          "round_wall_p50", errs,
                          allow_negative_frac=0.05)
        if not rp.get("prefix_equivalent"):
            errs.append("round_phases: prefix decomposition not "
                        "asserted equivalent to the fused round")
    rpl = obj.get("round_phases_laddered")
    if rpl is not None:
        # Width-laddered attribution: self-consistent against
        # its OWN fused-round measurement (the laddered table runs at
        # a tail-round state, so the bench's full-width round_wall_p50
        # is not its target), prefix-equivalence mandatory like the
        # primary table, and the rung it priced must be recorded.
        _check_phase_rows(rpl.get("rows"),
                          rpl.get("fused_round_wall_s"),
                          "round_phases_laddered",
                          "fused_round_wall_s", errs,
                          allow_negative_frac=0.05)
        if not rpl.get("prefix_equivalent"):
            errs.append("round_phases_laddered: prefix decomposition "
                        "not asserted equivalent to the fused round")
        if not (_num(rpl.get("merge_w")) and rpl["merge_w"] > 0):
            errs.append(f"round_phases_laddered: merge_w "
                        f"{rpl.get('merge_w')!r} missing or invalid — "
                        f"a laddered table must record its rung")
    repub = obj.get("repub_profile")
    if repub is not None:
        _check_phase_rows(repub.get("rows"), repub.get("sweep_wall_s"),
                          "repub_profile", "sweep_wall_s", errs)
    if rp is None and repub is None:
        errs.append("ledger carries neither round_phases nor "
                    "repub_profile — nothing to gate")

    acc = obj.get("attr_compile_count")
    if acc is not None and acc != 0:
        errs.append(f"attr_compile_count {acc} != 0 — a fresh compile "
                    f"ran inside the clocked attribution pass, so "
                    f"round_wall_p50 includes compile time")
    return errs


# Quantiles a serve artifact must report, with the bench-row field
# they land in.
SERVE_QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99),
                   ("p999", 0.999))


def check_serve_obj(obj: dict) -> List[str]:
    """All violations found in a loaded serve artifact (empty = pass).

    The serve gate's contract: per-request lifecycle must CONSERVE
    (``admitted == completed + in_flight + expired``), latencies
    must be non-negative, the latency histogram must agree with the
    bench row's request count, and every reported quantile must fall
    inside the histogram bucket that holds that quantile — a p99 the
    recorded distribution cannot produce is a fabricated SLO.
    """
    errs: List[str] = []
    for field in ("kind", "bench", "lifecycle", "latency_histogram",
                  "latency_quantiles_s"):
        if field not in obj:
            errs.append(f"missing top-level field {field!r}")
    if errs:
        return errs
    bench, life = obj["bench"], obj["lifecycle"]
    hist, quants = obj["latency_histogram"], obj["latency_quantiles_s"]

    admitted = life.get("admitted")
    completed = life.get("completed")
    in_flight = life.get("in_flight")
    expired = life.get("expired", 0)
    never = life.get("never_admitted", 0)
    shed = life.get("shed", 0)
    cache_hits = life.get("cache_hits", 0)
    for name, v in (("admitted", admitted), ("completed", completed),
                    ("in_flight", in_flight), ("expired", expired),
                    ("never_admitted", never), ("shed", shed),
                    ("cache_hits", cache_hits)):
        if not (_num(v) and v >= 0):
            errs.append(f"lifecycle {name} invalid: {v!r}")
    if errs:
        return errs
    if admitted != completed + in_flight + expired:
        errs.append(f"lifecycle does not conserve: admitted {admitted} "
                    f"!= completed {completed} + in_flight {in_flight} "
                    f"+ expired {expired}")
    if cache_hits > completed:
        errs.append(f"lifecycle cache_hits {cache_hits} > completed "
                    f"{completed} — a hit IS a completion")
    if completed == 0:
        errs.append("no request completed — nothing to stand behind")

    # Cache block: every admission is booked as exactly one
    # of hit or miss, hits are conserved against the lifecycle plane,
    # and every hit's service-rounds sample lands in the FIRST bucket
    # — a hit that took a lookup round is not a hit.
    cache = obj.get("cache")
    if cache is None and cache_hits:
        errs.append(f"lifecycle books {cache_hits} cache_hits but the "
                    f"artifact has no cache block")
    if cache is not None:
        hits = cache.get("hits")
        misses = cache.get("misses")
        degr = cache.get("degraded_hits", 0)
        for name, v in (("hits", hits), ("misses", misses),
                        ("degraded_hits", degr)):
            if not (_num(v) and v >= 0):
                errs.append(f"cache {name} invalid: {v!r}")
                return errs
        if hits + misses != admitted:
            errs.append(f"cache does not conserve: hits {hits} + "
                        f"misses {misses} != admitted {admitted} "
                        f"(each admission is exactly one of the two)")
        if hits != cache_hits:
            errs.append(f"cache hits {hits} != lifecycle cache_hits "
                        f"{cache_hits}")
        if degr > hits:
            errs.append(f"cache degraded_hits {degr} > hits {hits}")
        hh = cache.get("hit_rounds_histogram") or {}
        h_counts = hh.get("counts") or []
        if not h_counts:
            errs.append("cache block missing hit_rounds_histogram")
        else:
            if sum(h_counts) != hits:
                errs.append(f"hit_rounds_histogram holds "
                            f"{sum(h_counts)} samples for {hits} hits")
            if h_counts[0] != hits:
                errs.append(
                    f"hit_rounds_histogram first bucket holds "
                    f"{h_counts[0]} of {hits} hits — a cache hit must "
                    f"complete in zero service rounds")

    bounds = hist.get("bounds") or []
    counts = hist.get("counts") or []
    if len(counts) != len(bounds) + 1:
        errs.append(f"latency histogram has {len(counts)} counts for "
                    f"{len(bounds)} bounds (+overflow expected)")
        return errs
    if any(c < 0 for c in counts):
        errs.append(f"latency histogram counts negative: {counts}")
    if any(b <= 0 for b in bounds) or \
            any(b >= c for b, c in zip(bounds, bounds[1:])):
        errs.append(f"latency histogram bounds not positive-increasing:"
                    f" {bounds}")
    if sum(counts) != completed:
        errs.append(f"latency histogram holds {sum(counts)} "
                    f"observations but {completed} requests completed")
    if _num(hist.get("sum")) and hist["sum"] < 0:
        errs.append(f"latency histogram sum negative: {hist['sum']}")

    # Reported quantiles: non-negative, monotone across q, and inside
    # the bucket the recorded distribution puts that quantile in.
    # The bucket walk reuses the REAL estimator
    # (utils.metrics.Histogram — the class the bench derived the
    # quantiles from), not a local re-implementation that could
    # silently diverge from it.
    from ..utils.metrics import Histogram
    hist_obj = None
    hist_ok = (bounds and not any(c < 0 for c in counts)
               and sum(counts) > 0
               and all(b > 0 for b in bounds)
               and all(b < c for b, c in zip(bounds, bounds[1:])))
    if hist_ok:
        hist_obj = Histogram("serve_check", "", buckets=bounds)
        hist_obj.observe_bulk(counts, 0.0)
    prev = -1.0
    # Zero-completed artifacts already failed above; walking quantiles
    # against an empty distribution would only bury that diagnosis
    # under nonsense (nan, nan] bucket lines.
    for name, q in SERVE_QUANTILES if completed else ():
        v = quants.get(name)
        if not (_num(v) and v >= 0):
            errs.append(f"latency quantile {name} invalid: {v!r}")
            continue
        if v < prev - 1e-12:
            errs.append(f"latency quantiles not monotone at {name}: "
                        f"{v} < {prev}")
        prev = v
        if hist_obj is None:
            continue
        lo, hi = hist_obj.bucket_bounds_of_quantile(q)
        if not (lo - 1e-9 <= v <= hi + 1e-9):
            errs.append(f"latency {name} {v:.6f}s outside its "
                        f"histogram bucket ({lo:.6f}, {hi:.6f}]")
        # The bench-row copy of this quantile is what check_bench
        # gates (latency_p99_s ceiling) — a row field diverging from
        # the histogram-consistent value is a fabricated SLO.
        row_v = bench.get(f"latency_{name}_s")
        if row_v is not None and (not _num(row_v)
                                  or abs(row_v - v) > 1e-6):
            errs.append(f"bench latency_{name}_s {row_v!r} != artifact "
                        f"quantile {v} (the gated field must match the "
                        f"histogram-derived one)")

    # Bench-row consistency: the row the artifact rides must agree with
    # the lifecycle plane it claims to summarize.
    if bench.get("completed") is not None \
            and bench["completed"] != completed:
        errs.append(f"bench row completed {bench['completed']} != "
                    f"lifecycle completed {completed}")
    rate = bench.get("value")
    el = bench.get("elapsed_s")
    if _num(rate) and _num(el) and el > 0:
        want = completed / el
        if abs(rate - want) > max(0.02 * want, 0.5):
            errs.append(f"bench sustained rate {rate} inconsistent "
                        f"with completed/elapsed = {want:.1f}")
    df = bench.get("done_frac")
    if _num(df) and admitted:
        # Offered = everything the schedule produced: admitted + shed
        # (dropped by admission control / overload shedding) + never
        # admitted.  Shedding must show up in done_frac — a row that
        # sheds 90% of traffic and reports done_frac 1.0 is a lie.
        want_df = completed / (admitted + never + shed)
        if abs(df - want_df) > 1e-6:
            errs.append(f"bench done_frac {df} != completed/offered "
                        f"{want_df:.6f}")
    for name, v in (("shed", shed), ("cache_hits", cache_hits)):
        row_v = bench.get(name)
        if row_v is not None and row_v != v:
            errs.append(f"bench row {name} {row_v} != lifecycle "
                        f"{name} {v}")
    occ = bench.get("slot_occupancy_frac")
    if occ is not None and not (_num(occ) and 0.0 <= occ <= 1.0):
        errs.append(f"slot_occupancy_frac not a fraction: {occ!r}")

    # Resident-loop block (round 20): ring conservation, depth bounds,
    # the host-orchestration share against the artifact's own recorded
    # budget, and the in-jit rung counts against the device rounds.
    res = obj.get("resident")
    if res is None and bench.get("serve_engine") == "resident":
        errs.append("bench row claims serve_engine 'resident' but the "
                    "artifact has no resident block")
    if res is not None:
        _check_resident_block(res, bench, admitted, never, errs)
    return errs


def _check_resident_block(res: dict, bench: dict, admitted, never,
                          errs: List[str]) -> None:
    """The resident serve loop's contract (round 20), held against the
    artifact: every ring-enqueued row is accounted (admitted, still in
    the device ring, or shed BY the ring), ring depths stay inside the
    ring, the host-orchestration share is a fraction at or under the
    RECORDED budget (the <5 % acceptance gate rides in the artifact,
    so a regressed run fails its own file), and with rung selection on
    the in-jit counts must sum to the device rounds — each round picks
    exactly one rung."""
    iters = res.get("iterations")
    ring_slots = res.get("ring_slots")
    enq = res.get("ring_enqueued")
    r_shed = res.get("ring_shed", 0)
    backlog = res.get("ring_backlog_final", 0)
    d_mean = res.get("ring_depth_mean")
    d_max = res.get("ring_depth_max")
    orch = res.get("host_orchestration_frac")
    budget = res.get("host_orchestration_budget")
    dev_rounds = res.get("device_rounds")
    for name, v in (("iterations", iters), ("ring_slots", ring_slots),
                    ("ring_enqueued", enq), ("ring_shed", r_shed),
                    ("ring_backlog_final", backlog),
                    ("ring_depth_mean", d_mean),
                    ("ring_depth_max", d_max),
                    ("device_rounds", dev_rounds)):
        if not (_num(v) and v >= 0):
            errs.append(f"resident {name} invalid: {v!r}")
            return
    if iters < 1:
        errs.append("resident block with zero macro iterations — "
                    "nothing resident ran")
    # The ring's own conservation: rows handed to the device ring are
    # admitted into slots, still queued, or shed by the ring —
    # admitted here includes cache hits (a hit is admitted-and-
    # completed at pop time without occupying a slot).
    if _num(admitted) and enq != admitted + backlog + r_shed:
        errs.append(f"resident ring does not conserve: ring_enqueued "
                    f"{enq} != admitted {admitted} + "
                    f"ring_backlog_final {backlog} + ring_shed "
                    f"{r_shed}")
    if _num(never) and backlog > never:
        errs.append(f"resident ring_backlog_final {backlog} > "
                    f"never_admitted {never} — queued ring rows must "
                    f"be booked never-admitted")
    if d_max > ring_slots:
        errs.append(f"resident ring_depth_max {d_max} > ring_slots "
                    f"{ring_slots}")
    if d_mean > d_max + 1e-9:
        errs.append(f"resident ring_depth_mean {d_mean} > "
                    f"ring_depth_max {d_max}")
    if not (_num(orch) and 0.0 <= orch <= 1.0):
        errs.append(f"resident host_orchestration_frac not a "
                    f"fraction: {orch!r}")
    elif _num(budget) and orch > budget + 1e-9:
        errs.append(f"resident host_orchestration_frac {orch:.4f} "
                    f"exceeds the recorded budget {budget} — the "
                    f"serve wall is no longer device-dominated")
    rung = res.get("rung_select")
    counts = res.get("in_jit_rung_counts") or []
    if rung:
        if any((not _num(c)) or c < 0 for c in counts):
            errs.append(f"resident in_jit_rung_counts invalid: "
                        f"{counts!r}")
        elif sum(counts) != dev_rounds:
            errs.append(f"resident in_jit_rung_counts sum "
                        f"{sum(counts)} != device_rounds {dev_rounds} "
                        f"— each round selects exactly one rung")
    xchg = res.get("exchange") or {}
    for name in ("rows_init", "rows_round", "row_bytes"):
        v = xchg.get(name, 0)
        if not (_num(v) and v >= 0):
            errs.append(f"resident exchange {name} invalid: {v!r}")


# Hard ceiling on the hop-fidelity band a monitor artifact may state:
# the band is part of the recorded contract, but an artifact that
# "passes" by declaring a band of 1.0 has gated nothing.
MONITOR_MAX_BAND_TV = 0.25


def _check_sweep_conservation(sweeps, bound, errs: List[str]) -> None:
    """The monitor fold's EXACT per-sweep identities, shared by the
    monitor checker and the soak checker (soak sweeps come from the
    same ``fold_sweep`` program, interleaved instead of closed-loop):
    freshness conservation, probe accounting, fresh⇔seen, coverage
    arithmetic, and detection lag within ``bound``."""
    count_fields = ("nodes_seen", "newly_discovered", "resurrected",
                    "newly_dead", "tracked_alive", "covered",
                    "actual_alive", "false_alive", "false_dead",
                    "probed_tracked", "probed_seen", "probed_missed",
                    "lag_sum", "lag_count", "nodes_fresh")
    prev_alive = 0
    for r in sweeps:
        s = r.get("sweep", "?")
        missing = [f for f in count_fields
                   if not (_num(r.get(f)) and r[f] >= 0)]
        if missing:
            errs.append(f"sweep {s}: missing/negative counters "
                        f"{missing}")
            return
        # (a) freshness conservation — exact identities of the fold.
        want = (prev_alive + r["newly_discovered"] + r["resurrected"]
                - r["newly_dead"])
        if r["tracked_alive"] != want:
            errs.append(
                f"sweep {s}: tracked_alive {r['tracked_alive']} != "
                f"prev + discovered + resurrected - dead = {want} "
                f"(freshness does not conserve)")
        if r["probed_tracked"] != r["probed_seen"] + r["probed_missed"]:
            errs.append(
                f"sweep {s}: probed_tracked {r['probed_tracked']} != "
                f"probed_seen {r['probed_seen']} + probed_missed "
                f"{r['probed_missed']}")
        if r["nodes_fresh"] != r["nodes_seen"]:
            errs.append(f"sweep {s}: nodes_fresh {r['nodes_fresh']} != "
                        f"nodes_seen {r['nodes_seen']} — a node must "
                        f"be fresh iff this sweep saw it")
        if r["covered"] > min(r["tracked_alive"], r["actual_alive"]):
            errs.append(f"sweep {s}: covered {r['covered']} exceeds "
                        f"tracked/actual population")
        cov = r.get("coverage")
        want_cov = r["covered"] / max(1, r["actual_alive"])
        if not (_num(cov) and abs(cov - want_cov) <= 1e-5):
            errs.append(f"sweep {s}: coverage {cov!r} != covered/"
                        f"actual_alive {want_cov:.6f}")
        if r["lag_count"] > r["newly_dead"]:
            errs.append(f"sweep {s}: lag_count {r['lag_count']} > "
                        f"newly_dead {r['newly_dead']}")
        if r["lag_count"] and not (_num(r.get("lag_max"))
                                   and 0 <= r["lag_max"] <= bound):
            errs.append(f"sweep {s}: lag_max {r.get('lag_max')!r} "
                        f"outside [0, {bound}] — detection slower "
                        f"than the stated sweep period")
        prev_alive = r["tracked_alive"]


def check_monitor_obj(obj: dict) -> List[str]:
    """All violations found in a loaded swarm-monitor artifact (empty
    = pass).

    The monitor gate's contract:

    a. **freshness conservation** — per sweep, the tracked-alive
       population must conserve exactly (``tracked_alive' ==
       tracked_alive + newly_discovered + resurrected - newly_dead``),
       probes must account (``probed_tracked == probed_seen +
       probed_missed``), and a node is fresh iff this sweep saw it
       (``nodes_fresh == nodes_seen``);
    b. **detection lag** — every sweep's ``lag_max`` must sit within
       the scheduler's stated bound, and the stated bound must equal
       the one the config implies (``period + miss_limit - 1``);
    c. **analytic hop fidelity** — the initial full-crawl hop
       histogram must sit within the stated band of the analytic
       model, RECOMPUTED here from the swarm geometry
       (``obs.health.analytic_hop_pmf``) so the artifact cannot ship a
       fabricated prediction; the band itself is capped at
       :data:`MONITOR_MAX_BAND_TV`.
    """
    errs: List[str] = []
    for field in ("kind", "bench", "monitor"):
        if field not in obj:
            errs.append(f"missing top-level field {field!r}")
    if errs:
        return errs
    bench, mon = obj["bench"], obj["monitor"]
    cfg = mon.get("config") or {}
    sweeps = mon.get("sweeps") or []
    if not sweeps:
        errs.append("monitor block has no sweeps")
        return errs
    for knob in ("period", "miss_limit", "fresh_ttl", "depth",
                 "detection_lag_bound_sweeps", "bucket_k", "alpha",
                 "quorum"):
        if not (_num(cfg.get(knob)) and cfg[knob] >= 0):
            errs.append(f"monitor config {knob} invalid: "
                        f"{cfg.get(knob)!r}")
    if errs:
        return errs

    # (b) detection-lag bound: stated == derived, measured <= stated.
    bound = cfg["detection_lag_bound_sweeps"]
    want_bound = cfg["period"] + cfg["miss_limit"] - 1
    if bound != want_bound:
        errs.append(f"detection_lag_bound_sweeps {bound} != period + "
                    f"miss_limit - 1 = {want_bound}")

    n_before = len(errs)
    _check_sweep_conservation(sweeps, bound, errs)
    if any("missing/negative counters" in e for e in errs[n_before:]):
        # Malformed records can't be read further; every OTHER
        # conservation violation still lets the hop-fidelity and
        # bench-row checks below run and report alongside it.
        return errs

    # (c) hop-histogram-vs-analytic-model fidelity, recomputed.
    hist = mon.get("hop_histogram_initial")
    n_alive = mon.get("initial_alive")
    fid = mon.get("hop_fidelity") or {}
    if not hist or not (_num(n_alive) and n_alive >= 2):
        errs.append("monitor artifact lacks hop_histogram_initial/"
                    "initial_alive — nothing to hold the model "
                    "against")
        return errs
    band = fid.get("band_tv")
    if not (_num(band) and 0 < band <= MONITOR_MAX_BAND_TV):
        errs.append(f"hop_fidelity band_tv {band!r} missing or above "
                    f"the {MONITOR_MAX_BAND_TV} ceiling")
        return errs
    from ..obs.health import HOP_MEDIAN_TOL, hop_fidelity
    re_fid = hop_fidelity(hist, int(n_alive),
                          bucket_k=int(cfg["bucket_k"]),
                          alpha=int(cfg["alpha"]),
                          quorum=int(cfg["quorum"]), band_tv=band)
    if abs(re_fid["tv"] - fid.get("tv", -1)) > 1e-4:
        errs.append(f"hop_fidelity tv {fid.get('tv')!r} != recomputed "
                    f"{re_fid['tv']} (the recorded comparison must "
                    f"match the model this checker derives)")
    if re_fid["tv"] > band:
        errs.append(f"measured hop histogram {re_fid['tv']:.4f} total "
                    f"variation from the analytic model — outside the "
                    f"stated band {band}")
    if abs(re_fid["median_measured"] - re_fid["median_model"]) \
            > HOP_MEDIAN_TOL:
        errs.append(
            f"hop median {re_fid['median_measured']} vs analytic "
            f"{re_fid['median_model']} — beyond the ±{HOP_MEDIAN_TOL} "
            f"round tolerance")

    # Bench-row consistency: the gated coverage value must be the
    # steady-state mean of the sweeps it claims to summarize.
    post = sweeps[1:] or sweeps
    want_val = sum(r["coverage"] for r in post) / len(post)
    if _num(bench.get("value")) and abs(bench["value"] - want_val) \
            > 1e-5:
        errs.append(f"bench coverage {bench['value']} != mean post-"
                    f"initial sweep coverage {want_val:.6f}")
    lag_max_all = [r["lag_max"] for r in sweeps if r["lag_count"]]
    row_lag = bench.get("detection_lag_max")
    if lag_max_all and (not _num(row_lag)
                        or row_lag != max(lag_max_all)):
        errs.append(f"bench detection_lag_max {row_lag!r} != max over "
                    f"sweeps {max(lag_max_all)}")
    return errs


def check_index_obj(obj: dict) -> List[str]:
    """Validate a ``swarm_index_trace`` artifact (``bench.py --mode
    index --index-out``).  All violations (empty = pass):

    a. **leaf capacity** — no leaf may hold more than 16 entries (the
       reference's ``MAX_NODE_ENTRY_COUNT`` is STRUCTURAL in the
       device encoding: a 17th slot key does not exist), and the
       occupancy histogram must account for every leaf;
    b. **split accounting conservation** — a binary trie grown only by
       splits satisfies ``n_leaves == 1 + split_levels``, and every
       distinct inserted entry is either in a leaf or counted as a
       structural overfull drop (``entries_in_leaves + overfull_drops
       == entries_distinct``);
    c. **exact recall** — the range scans must return EXACTLY the
       sequential host-PHT oracle's entry sets: recall 1.0 AND zero
       extras (a scan that pads its recall with spurious entries must
       fail, not average out);
    d. **probe-round bound** — the measured leaf-walk rounds must sit
       within the artifact's stated binary-search bound, which must
       itself equal the one the prefix width implies
       (``2·(⌈log2(prefix_bits+1)⌉+1)``, the hint-miss-restart bound
       of ``DeviceIndex.leaf_search``).
    """
    import math as _math

    errs: List[str] = []
    for field in ("kind", "bench", "index"):
        if field not in obj:
            errs.append(f"missing top-level field {field!r}")
    if errs:
        return errs
    bench, ix = obj["bench"], obj["index"]
    for f in ("prefix_bits", "probe_round_bound", "walk_rounds_max",
              "entries_distinct", "entries_in_leaves",
              "overfull_drops", "n_leaves", "split_levels"):
        if not (_num(ix.get(f)) and ix[f] >= 0):
            errs.append(f"index field {f} missing/negative: "
                        f"{ix.get(f)!r}")
    if errs:
        return errs

    # (a) leaf capacity + histogram accounting
    occ_max = ix.get("leaf_occupancy_max")
    hist = ix.get("leaf_occupancy_hist")
    if not (_num(occ_max) and 0 <= occ_max <= 16):
        errs.append(f"leaf_occupancy_max {occ_max!r} outside [0, 16] "
                    f"— a leaf exceeded MAX_NODE_ENTRY_COUNT")
    if not (isinstance(hist, list) and len(hist) == 17
            and all(_num(v) and v >= 0 for v in hist)):
        errs.append(f"leaf_occupancy_hist malformed: {hist!r}")
    else:
        if sum(hist) != ix["n_leaves"]:
            errs.append(f"leaf_occupancy_hist sums to {sum(hist)} for "
                        f"{ix['n_leaves']} leaves")
        deepest = max((i for i, v in enumerate(hist) if v), default=0)
        if _num(occ_max) and deepest != occ_max:
            errs.append(f"leaf_occupancy_max {occ_max} != histogram "
                        f"max occupied bin {deepest}")
        if sum(i * v for i, v in enumerate(hist)) \
                != ix["entries_in_leaves"]:
            errs.append("entries_in_leaves disagrees with the "
                        "occupancy histogram")

    # (b) split conservation
    if ix["n_leaves"] != 1 + ix["split_levels"]:
        errs.append(f"n_leaves {ix['n_leaves']} != 1 + split_levels "
                    f"{ix['split_levels']} (split accounting does not "
                    f"conserve)")
    if ix["entries_in_leaves"] + ix["overfull_drops"] \
            != ix["entries_distinct"]:
        errs.append(
            f"entries_in_leaves {ix['entries_in_leaves']} + "
            f"overfull_drops {ix['overfull_drops']} != "
            f"entries_distinct {ix['entries_distinct']} — entries "
            f"leaked or were double-stored")
    if ix.get("oracle_agrees") is not True:
        errs.append("oracle_agrees is not true — the device trie "
                    "diverged from the sequential host-PHT oracle")

    # (c) exact recall
    scans = ix.get("scans") or {}
    if scans.get("recall") != 1.0:
        errs.append(f"scan recall {scans.get('recall')!r} != 1.0")
    if scans.get("exact") is not True:
        errs.append("scan exact is not true (extras "
                    f"{scans.get('extras')!r})")
    if _num(scans.get("extras")) and scans["extras"] != 0:
        errs.append(f"scans returned {scans['extras']} entries the "
                    f"oracle does not hold")
    if bench.get("scan_recall") != scans.get("recall"):
        errs.append(f"bench scan_recall {bench.get('scan_recall')!r} "
                    f"!= artifact recall {scans.get('recall')!r}")

    # (d) probe-round bound, recomputed from the prefix width
    want_bound = 2 * (int(_math.ceil(
        _math.log2(ix["prefix_bits"] + 1))) + 1)
    if ix["probe_round_bound"] != want_bound:
        errs.append(f"probe_round_bound {ix['probe_round_bound']} != "
                    f"derived 2*(ceil(log2(prefix_bits+1))+1) = "
                    f"{want_bound}")
    if ix["walk_rounds_max"] > ix["probe_round_bound"]:
        errs.append(f"walk_rounds_max {ix['walk_rounds_max']} exceeds "
                    f"the binary-search bound "
                    f"{ix['probe_round_bound']}")
    return errs


# Soak-artifact contract ceilings: the artifact STATES its SLO
# violation bound and value-survival floor (knobs of the run), but a
# bound loose enough to gate nothing must itself fail.  The survival
# floor is SCENARIO-derived: a contiguous keyspace outage of fraction
# f kills every replica of the keys wholly inside it at once — no
# republish can recover data that no longer exists anywhere — so the
# tightest honest floor is ~(1 - f); the checker requires the stated
# floor to be at least ``1 - 2f - 0.005`` (and never below
# SOAK_SURVIVAL_FLOOR_ABS), recomputed from the bench row's own
# outage_frac so a run cannot loosen its floor beyond what its
# scenario justifies.
SOAK_MAX_SLO_BOUND = 0.25
SOAK_SURVIVAL_FLOOR_ABS = 0.90
_SOAK_CLASSES = ("read", "write", "repub", "monitor")
_SOAK_SERVE = ("read", "write")


def _soak_life_ok(d: dict) -> bool:
    return all(_num(d.get(f)) and d[f] >= 0 for f in
               ("admitted", "completed", "expired", "in_flight"))


def check_soak_obj(obj: dict) -> List[str]:
    """All violations found in a loaded ``swarm_soak_trace`` artifact
    (empty = pass).  The soak gate's contract:

    a. **lifecycle conservation, per work class** — ``admitted ==
       completed + expired + in_flight`` for read/write/repub/monitor,
       at the run level AND at every timeline interval boundary; the
       scan station conserves ``arrived == completed + pending``; the
       device work-class plane never disagreed with the host slot
       bookkeeping (``wclass_mismatches == 0``);
    b. **slot-round split** — per interval, serve + maintenance
       slot-rounds (device-plane testimony) must equal total
       dispatched slot-rounds (host bookkeeping) exactly;
    c. **latency integrity** — each interval's completions equal its
       histogram count, every derived quantile (per-interval and
       overall) sits inside the bucket holding it, the interval
       histograms sum to the run histogram, and the run histogram
       holds exactly ``completed`` observations;
    d. **monitor plane** — the interleaved sweeps satisfy the same
       exact freshness-conservation identities as ``--mode monitor``
       (shared checker), detection lag sits within the config-derived
       scheduler bound, and the embedded summary matches the records;
    e. **re-replication** — final value survival on the tracked keyset
       meets the stated floor (itself capped ≥
       :data:`SOAK_MIN_SURVIVAL_FLOOR`), with at least one republish
       sweep completed;
    f. **SLO** — the measured violation ratio sits within the stated
       bound (capped at :data:`SOAK_MAX_SLO_BOUND`);
    g. **interference ledger** — when present, the A/B arms align on
       interval width, the overall p99s are reproducible from the two
       embedded timelines, and the attributed delta equals their
       difference (a fabricated interference number is rejected).
    """
    from ..utils.metrics import Histogram

    errs: List[str] = []
    for field in ("kind", "bench", "lifecycle", "timeline",
                  "latency_histogram", "latency_quantiles_s"):
        if field not in obj:
            errs.append(f"missing top-level field {field!r}")
    if errs:
        return errs
    bench, life = obj["bench"], obj["lifecycle"]
    tl, hist = obj["timeline"], obj["latency_histogram"]
    quants = obj["latency_quantiles_s"]

    # (a) run-level lifecycle, per class ------------------------------
    by_cls = life.get("by_class") or {}
    for cls in _SOAK_CLASSES:
        d = by_cls.get(cls)
        if not (isinstance(d, dict) and _soak_life_ok(d)):
            errs.append(f"lifecycle class {cls!r} missing/invalid: "
                        f"{d!r}")
            continue
        if d["admitted"] != d["completed"] + d["expired"] \
                + d["in_flight"]:
            errs.append(
                f"lifecycle [{cls}] does not conserve: admitted "
                f"{d['admitted']} != completed {d['completed']} + "
                f"expired {d['expired']} + in_flight {d['in_flight']}")
    if errs:
        return errs
    serve_adm = sum(by_cls[c]["admitted"] for c in _SOAK_SERVE)
    serve_com = sum(by_cls[c]["completed"] for c in _SOAK_SERVE)
    if life.get("admitted") != serve_adm:
        errs.append(f"lifecycle admitted {life.get('admitted')} != "
                    f"serve-class sum {serve_adm}")
    if life.get("completed") != serve_com:
        errs.append(f"lifecycle completed {life.get('completed')} != "
                    f"serve-class sum {serve_com}")
    if serve_com == 0:
        errs.append("no serve request completed — nothing to stand "
                    "behind")
    wmm = life.get("wclass_mismatches")
    if wmm != 0:
        errs.append(f"wclass_mismatches {wmm!r} != 0 — the device "
                    f"work-class plane disagreed with the host slot "
                    f"bookkeeping")
    scan = life.get("scan") or {}
    if scan and scan.get("arrived") != scan.get("completed", 0) \
            + scan.get("pending", 0):
        errs.append(f"scan station does not conserve: arrived "
                    f"{scan.get('arrived')} != completed "
                    f"{scan.get('completed')} + pending "
                    f"{scan.get('pending')}")
    chunked = life.get("chunked") or {}
    if chunked:
        # Chunked station: opt-in like the scan block —
        # conserves arrivals, and a chunked READ that completed must
        # be byte-exact or missing, never garbled.
        if chunked.get("arrived") != chunked.get("completed", 0) \
                + chunked.get("pending", 0):
            errs.append(f"chunked station does not conserve: arrived "
                        f"{chunked.get('arrived')} != completed "
                        f"{chunked.get('completed')} + pending "
                        f"{chunked.get('pending')}")
        if chunked.get("garbled", 0) != 0:
            errs.append(f"chunked station served "
                        f"{chunked.get('garbled')} garbled reads — "
                        f"the contract is missing, NEVER garbled")
    if life.get("cache_slots"):
        # Probe-fused soak cache: every READ
        # admission is exactly one of hit (instant completion, no
        # slot) or miss (a normal slot lookup) — writes and
        # maintenance are never probed, so the identity is against
        # the read class alone.
        hits = life.get("cache_hits")
        misses = life.get("cache_misses")
        if not (_num(hits) and _num(misses)
                and hits >= 0 and misses >= 0):
            errs.append(f"soak cache counters invalid: hits {hits!r} "
                        f"misses {misses!r}")
        elif hits + misses != by_cls["read"]["admitted"]:
            errs.append(
                f"soak cache does not conserve: hits {hits} + misses "
                f"{misses} != read-class admitted "
                f"{by_cls['read']['admitted']}")
        for nm in ("cache_hits", "cache_misses"):
            if bench.get(nm) is not None \
                    and bench.get(nm) != life.get(nm):
                errs.append(f"bench {nm} {bench.get(nm)!r} != "
                            f"lifecycle {life.get(nm)!r}")

    # (b)+(c) the timeline rows ---------------------------------------
    bounds = tl.get("latency_bounds_s") or []
    rows = tl.get("rows") or []
    if not rows:
        errs.append("timeline has no rows")
        return errs
    if not (_num(tl.get("interval_s")) and tl["interval_s"] > 0):
        errs.append(f"timeline interval_s invalid: "
                    f"{tl.get('interval_s')!r}")
        return errs
    if any(b <= 0 for b in bounds) or \
            any(x >= y for x, y in zip(bounds, bounds[1:])):
        errs.append("timeline latency bounds not positive-increasing")
        return errs
    sum_counts = [0] * (len(bounds) + 1)
    sum_viol = 0
    prev_life = None
    last_life = None
    for r in rows:
        i = r.get("i", "?")
        sr = r.get("slot_rounds") or {}
        split = sum(int(sr.get(w, 0)) for w in _SOAK_CLASSES)
        if r.get("total_slot_rounds") != split:
            errs.append(
                f"interval {i}: serve+maintenance slot-rounds {split} "
                f"!= total dispatched {r.get('total_slot_rounds')} — "
                f"the device plane and host bookkeeping disagree")
        counts = r.get("latency_counts") or []
        n_lat = int(sum(counts))
        if r.get("latency_count") != n_lat:
            errs.append(f"interval {i}: latency_count "
                        f"{r.get('latency_count')} != counts sum "
                        f"{n_lat}")
        comp = r.get("completed") or {}
        serve_done = sum(int(comp.get(w, 0)) for w in _SOAK_SERVE)
        if serve_done != n_lat:
            errs.append(f"interval {i}: serve completions "
                        f"{serve_done} != latency observations "
                        f"{n_lat}")
        if len(counts) == len(bounds) + 1:
            for j, v in enumerate(counts):
                sum_counts[j] += int(v)
        else:
            errs.append(f"interval {i}: latency_counts has "
                        f"{len(counts)} bins for {len(bounds)} bounds")
        viol = r.get("slo_violations", 0)
        if not (_num(viol) and 0 <= viol <= n_lat):
            errs.append(f"interval {i}: slo_violations {viol!r} "
                        f"outside [0, {n_lat}]")
        else:
            sum_viol += int(viol)
        if n_lat:
            h = Histogram("soak_check_iv", "", buckets=bounds)
            h.observe_bulk(counts, 0.0)
            for nm, q in (("latency_p50_s", 0.50),
                          ("latency_p99_s", 0.99)):
                v = r.get(nm)
                if not _num(v):
                    errs.append(f"interval {i}: {nm} {v!r} with "
                                f"{n_lat} observations")
                    continue
                lo, hi = h.bucket_bounds_of_quantile(q)
                if not (lo - 1e-9 <= v <= hi + 1e-9):
                    errs.append(f"interval {i}: {nm} {v:.6f}s outside "
                                f"its histogram bucket ({lo:.6f}, "
                                f"{hi:.6f}]")
        lf = r.get("lifecycle")
        if lf is not None:
            for cls in _SOAK_CLASSES:
                d = lf.get(cls)
                if not (isinstance(d, dict) and _soak_life_ok(d)):
                    errs.append(f"interval {i}: lifecycle snapshot "
                                f"class {cls!r} invalid")
                    continue
                if d["admitted"] != d["completed"] + d["expired"] \
                        + d["in_flight"]:
                    errs.append(
                        f"interval {i} [{cls}]: boundary conservation "
                        f"broken: admitted {d['admitted']} != "
                        f"completed {d['completed']} + expired "
                        f"{d['expired']} + in_flight {d['in_flight']}")
                if prev_life is not None and cls in prev_life:
                    for mono in ("admitted", "completed", "expired"):
                        if d[mono] < prev_life[cls][mono]:
                            errs.append(
                                f"interval {i} [{cls}]: cumulative "
                                f"{mono} decreased "
                                f"({prev_life[cls][mono]} -> "
                                f"{d[mono]})")
            prev_life = lf
            last_life = lf
    if errs:
        return errs
    if sum_counts != [int(v) for v in (hist.get("counts") or [])]:
        errs.append("run latency histogram != sum of interval "
                    "histograms")
    if sum(sum_counts) != serve_com:
        errs.append(f"latency histogram holds {sum(sum_counts)} "
                    f"observations but {serve_com} serve requests "
                    f"completed")
    if last_life is not None:
        for cls in _SOAK_CLASSES:
            if last_life[cls] != by_cls[cls]:
                errs.append(
                    f"final lifecycle [{cls}] {by_cls[cls]} != last "
                    f"interval boundary snapshot {last_life[cls]}")

    # (c) overall quantiles + bench-row copies ------------------------
    hist_obj = None
    if sum(sum_counts) > 0:
        hist_obj = Histogram("soak_check_run", "", buckets=bounds)
        hist_obj.observe_bulk(sum_counts, 0.0)
    prev = -1.0
    for name, q in SERVE_QUANTILES if serve_com else ():
        v = quants.get(name)
        if not (_num(v) and v >= 0):
            errs.append(f"latency quantile {name} invalid: {v!r}")
            continue
        if v < prev - 1e-12:
            errs.append(f"latency quantiles not monotone at {name}")
        prev = v
        if hist_obj is not None:
            lo, hi = hist_obj.bucket_bounds_of_quantile(q)
            if not (lo - 1e-9 <= v <= hi + 1e-9):
                errs.append(f"latency {name} {v:.6f}s outside its "
                            f"histogram bucket ({lo:.6f}, {hi:.6f}]")
        row_v = bench.get(f"latency_{name}_s")
        if row_v is not None and (not _num(row_v)
                                  or abs(row_v - v) > 1e-6):
            errs.append(f"bench latency_{name}_s {row_v!r} != "
                        f"artifact quantile {v}")

    # (f) SLO bound ---------------------------------------------------
    ratio = bench.get("slo_violation_ratio")
    bound_slo = bench.get("slo_violation_max")
    if not (_num(bound_slo) and 0 < bound_slo <= SOAK_MAX_SLO_BOUND):
        errs.append(f"slo_violation_max {bound_slo!r} missing or "
                    f"above the {SOAK_MAX_SLO_BOUND} ceiling")
    elif not (_num(ratio) and 0 <= ratio <= bound_slo):
        errs.append(f"slo_violation_ratio {ratio!r} outside the "
                    f"stated bound {bound_slo} — the SLO is burned")
    want_ratio = round(sum_viol / sum(sum_counts), 6) \
        if sum(sum_counts) else 0.0
    if _num(ratio) and abs(ratio - want_ratio) > 1e-6:
        errs.append(f"slo_violation_ratio {ratio} != interval "
                    f"violations / completions {want_ratio}")

    # (d) monitor plane ----------------------------------------------
    mon = obj.get("monitor") or {}
    sweeps = mon.get("sweeps") or []
    if bench.get("monitor_sweeps"):
        cfg = mon.get("config") or {}
        for knob in ("period", "miss_limit",
                     "detection_lag_bound_sweeps"):
            if not (_num(cfg.get(knob)) and cfg[knob] >= 0):
                errs.append(f"monitor config {knob} invalid: "
                            f"{cfg.get(knob)!r}")
                return errs
        bound = cfg["detection_lag_bound_sweeps"]
        if bound != cfg["period"] + cfg["miss_limit"] - 1:
            errs.append(f"detection_lag_bound_sweeps {bound} != "
                        f"period + miss_limit - 1")
        if not sweeps:
            errs.append("bench reports monitor sweeps but the "
                        "monitor block has none")
            return errs
        _check_sweep_conservation(sweeps, bound, errs)
        summary = mon.get("summary") or {}
        from ..obs.health import summarize_sweeps
        try:
            re_sum = summarize_sweeps(sweeps)
        except (KeyError, ValueError) as e:
            errs.append(f"monitor summary not recomputable: {e}")
            re_sum = None
        if re_sum is not None:
            for f in ("coverage_mean", "coverage_min",
                      "deaths_detected", "detection_lag_max"):
                if summary.get(f) != re_sum.get(f):
                    errs.append(
                        f"monitor summary {f} {summary.get(f)!r} != "
                        f"recomputed {re_sum.get(f)!r}")
            lag = re_sum.get("detection_lag_max")
            if lag is not None and lag > bound:
                errs.append(f"detection_lag_max {lag} exceeds the "
                            f"scheduler bound {bound}")
            if bench.get("detection_lag_max") != lag:
                errs.append(
                    f"bench detection_lag_max "
                    f"{bench.get('detection_lag_max')!r} != summary "
                    f"{lag!r}")

    # (e) re-replication ----------------------------------------------
    rep = obj.get("repub") or {}
    if bench.get("repub_sweeps"):
        floor = rep.get("survival_floor")
        surv = rep.get("survival_final")
        of = bench.get("outage_frac")
        of = of if _num(of) and of >= 0 else 0.0
        min_floor = max(SOAK_SURVIVAL_FLOOR_ABS,
                        1.0 - 2.0 * of - 0.005)
        if not (_num(floor) and min_floor <= floor <= 1.0):
            errs.append(f"repub survival_floor {floor!r} missing or "
                        f"below the scenario-derived minimum "
                        f"{min_floor:.4f} (outage_frac {of})")
        elif not (_num(surv) and surv >= floor):
            errs.append(f"value survival {surv!r} below the stated "
                        f"floor {floor} — re-replication did not "
                        f"complete")
        off_surv = rep.get("survival_off_arm")
        if _num(surv) and _num(off_surv) \
                and surv < off_surv - 0.005:
            errs.append(f"value survival {surv} WORSE than the "
                        f"maintenance-off arm {off_surv} — "
                        f"re-replication is doing harm")
        rsweeps = rep.get("sweeps") or []
        if len(rsweeps) != bench["repub_sweeps"]:
            errs.append(f"bench repub_sweeps {bench['repub_sweeps']} "
                        f"!= {len(rsweeps)} recorded sweeps")
        for k, sw in enumerate(rsweeps):
            if sw.get("admitted") != sw.get("completed", 0) \
                    + sw.get("expired", 0) + sw.get("in_flight", 0):
                errs.append(f"repub sweep {k}: admitted "
                            f"{sw.get('admitted')} != completed + "
                            f"expired + in_flight")
            if _num(sw.get("admitted")) and _num(sw.get("rows")) \
                    and sw["admitted"] > sw["rows"]:
                errs.append(f"repub sweep {k}: admitted "
                            f"{sw['admitted']} > rows {sw['rows']}")
        if bench.get("value_survival_final") != surv:
            errs.append(f"bench value_survival_final "
                        f"{bench.get('value_survival_final')!r} != "
                        f"repub block {surv!r}")

    # (g) interference ledger -----------------------------------------
    led = obj.get("interference")
    tl_off = obj.get("timeline_off")
    if led is not None:
        if tl_off is None:
            errs.append("interference ledger without timeline_off — "
                        "the A/B arm is missing")
            return errs
        if led.get("interval_s") != tl.get("interval_s") \
                or tl_off.get("interval_s") != tl.get("interval_s"):
            errs.append("interference/timeline interval widths "
                        "disagree — the arms cannot align")
        for side, tline in (("on", tl), ("off", tl_off)):
            tot = [0] * (len(bounds) + 1)
            for r in tline.get("rows") or []:
                cc = r.get("latency_counts") or []
                if len(cc) == len(bounds) + 1:
                    for j, v in enumerate(cc):
                        tot[j] += int(v)
            want = None
            if sum(tot):
                h = Histogram(f"soak_check_{side}", "", buckets=bounds)
                h.observe_bulk(tot, 0.0)
                want = round(h.quantile(0.99), 6)
            stated = led.get(f"p99_{side}_s")
            if stated != want:
                errs.append(f"interference p99_{side}_s {stated!r} "
                            f"not reproducible from the embedded "
                            f"{side}-arm timeline (recomputed "
                            f"{want!r})")
        d = led.get("p99_delta_s")
        p_on, p_off = led.get("p99_on_s"), led.get("p99_off_s")
        if _num(p_on) and _num(p_off):
            if not (_num(d) and abs(d - round(p_on - p_off, 6))
                    <= 1e-9):
                errs.append(f"interference p99_delta_s {d!r} != "
                            f"p99_on - p99_off "
                            f"{round(p_on - p_off, 6)}")
        if bench.get("maint_interference_p99_delta_s") != d:
            errs.append(
                f"bench maint_interference_p99_delta_s "
                f"{bench.get('maint_interference_p99_delta_s')!r} != "
                f"ledger {d!r}")

    # bench-row consistency -------------------------------------------
    rate = bench.get("value")
    el = bench.get("elapsed_s")
    if _num(rate) and _num(el) and el > 0:
        want = serve_com / el
        if abs(rate - want) > max(0.02 * want, 0.5):
            errs.append(f"bench sustained rate {rate} inconsistent "
                        f"with completed/elapsed = {want:.1f}")
    if bench.get("wclass_mismatches") != 0:
        errs.append(f"bench wclass_mismatches "
                    f"{bench.get('wclass_mismatches')!r} != 0")
    return errs


# Ceiling on the statable verify-overhead budget: the acceptance
# contract is <= 10% on the announce/get gate legs, and an artifact
# that "passes" by declaring a looser budget has gated nothing.
AUTH_MAX_OVERHEAD_BUDGET = 0.10
# The ratio-vs-budget gate only fires when the UNVERIFIED wall is at
# least this long: on a sub-200 ms leg (CI smoke shapes) a 10% band
# is single-digit milliseconds — pure scheduler noise on a shared
# runner, not a verify-cost signal (measured: -0.5%..+17% run-to-run
# at the 2k-node smoke shape vs a stable +4.7% at the 16k gate
# shape).  The gate legs the acceptance contract names are all well
# above this floor, so the budget still gates where it is stated.
AUTH_OVERHEAD_MIN_WALL_S = 0.2
# The undefended arm must be visibly degraded or the injection never
# bit and the defended 1.0 proves nothing.
AUTH_MIN_DEFENSE_GAIN = 0.10
_AUTH_TRACE_FIELDS = ("requests", "accepts_update", "accepts_new",
                      "rejects", "notified", "integrity_rejects")
_AUTH_LEGS = ("honest", "honest_refresh", "attack_flip",
              "attack_forge", "attack_replay")


def check_auth_obj(obj: dict) -> List[str]:
    """All violations found in a loaded ``swarm_auth_trace`` artifact
    (empty = pass).  The auth gate's contract:

    a. **digest parity** — the device content-id kernel agreed with
       hashlib on the sampled rows (``digest_parity`` true);
    b. **conservation, exact** — every leg's StoreTrace satisfies
       ``requests == accepts_update + accepts_new + rejects +
       integrity_rejects`` in BOTH arms; honest legs book zero
       integrity rejects, and the undefended arm books zero
       everywhere (the plane is off — a nonzero count there means the
       off-arm silently ran the verify);
    c. **the defense fired** — the defended arm's forged-payload and
       forged-id legs accepted NOTHING and booked integrity rejects;
       defended integrity is exactly 1.0; the undefended arm is
       degraded by at least :data:`AUTH_MIN_DEFENSE_GAIN` (an
       injection that didn't bite gates nothing);
    d. **overhead** — the stated ratio is reproducible from the two
       recorded walls, within the stated budget, and the budget
       itself is capped at :data:`AUTH_MAX_OVERHEAD_BUDGET`;
    e. **signature stage** — with crypto available the stage's
       verified+failed must equal submitted; without it every crypto
       figure must be null (the optional-dep contract), never a
       fabricated rate.
    """
    errs: List[str] = []
    for field in ("kind", "bench", "overhead", "arms", "signature",
                  "serve_signed"):
        if field not in obj:
            errs.append(f"missing top-level field {field!r}")
    if errs:
        return errs
    bench, arms, ov = obj["bench"], obj["arms"], obj["overhead"]

    # (a) digest parity
    if obj.get("digest_parity") is not True:
        errs.append("digest_parity is not true — the device content-id"
                    " kernel disagreed with hashlib")

    # (b) per-leg conservation, both arms
    for arm_name in ("defended", "undefended"):
        arm = arms.get(arm_name)
        if not isinstance(arm, dict):
            errs.append(f"arm {arm_name!r} missing")
            return errs
        legs = arm.get("legs") or {}
        for leg_name in _AUTH_LEGS:
            tr = legs.get(leg_name)
            if not isinstance(tr, dict):
                errs.append(f"{arm_name}: leg {leg_name!r} missing")
                continue
            bad = [f for f in _AUTH_TRACE_FIELDS
                   if not (_num(tr.get(f)) and tr[f] >= 0)]
            if bad:
                errs.append(f"{arm_name}/{leg_name}: missing/negative "
                            f"counters {bad}")
                continue
            want = tr["accepts_update"] + tr["accepts_new"] \
                + tr["rejects"] + tr["integrity_rejects"]
            if tr["requests"] != want:
                errs.append(
                    f"{arm_name}/{leg_name}: requests "
                    f"{tr['requests']} != accepts + rejects + "
                    f"integrity_rejects = {want} (conservation is "
                    f"EXACT by construction)")
            if leg_name.startswith("honest") \
                    and tr["integrity_rejects"] != 0:
                errs.append(f"{arm_name}/{leg_name}: honest leg "
                            f"booked {tr['integrity_rejects']} "
                            f"integrity rejects")
            if arm_name == "undefended" \
                    and tr["integrity_rejects"] != 0:
                errs.append(f"undefended/{leg_name}: integrity "
                            f"rejects {tr['integrity_rejects']} with "
                            f"the verify plane OFF")
    if errs:
        return errs

    # (c) the defense fired
    dlegs = arms["defended"]["legs"]
    for leg_name in ("attack_flip", "attack_forge"):
        tr = dlegs[leg_name]
        if tr["accepts_update"] + tr["accepts_new"] != 0:
            errs.append(f"defended/{leg_name}: ACCEPTED "
                        f"{tr['accepts_update'] + tr['accepts_new']} "
                        f"forged rows")
        if tr["requests"] and tr["integrity_rejects"] == 0:
            errs.append(f"defended/{leg_name}: no integrity rejects "
                        f"booked for {tr['requests']} forged requests")
    d_int = arms["defended"].get("integrity")
    u_int = arms["undefended"].get("integrity")
    if d_int != 1.0:
        errs.append(f"defended integrity {d_int!r} != 1.0 — a forged "
                    f"payload entered a result set")
    if not (_num(u_int) and u_int <= (d_int or 1.0)
            - AUTH_MIN_DEFENSE_GAIN):
        errs.append(f"undefended integrity {u_int!r} not degraded by "
                    f">= {AUTH_MIN_DEFENSE_GAIN} — the injection "
                    f"never bit, so the defended 1.0 proves nothing")
    if bench.get("value") != d_int:
        errs.append(f"bench value {bench.get('value')!r} != defended "
                    f"integrity {d_int!r}")
    if bench.get("undefended_integrity") != u_int:
        errs.append(f"bench undefended_integrity "
                    f"{bench.get('undefended_integrity')!r} != arm "
                    f"{u_int!r}")

    # (d) overhead
    tv, tu = ov.get("verified_wall_s"), ov.get("unverified_wall_s")
    ratio, budget = ov.get("ratio"), ov.get("budget")
    if not (_num(tv) and _num(tu) and tv > 0 and tu > 0):
        errs.append(f"overhead walls invalid: verified {tv!r} / "
                    f"unverified {tu!r}")
    elif not (_num(ratio) and abs(ratio - (tv - tu) / tu) <= 1e-3):
        errs.append(f"overhead ratio {ratio!r} not reproducible from "
                    f"the recorded walls ({(tv - tu) / tu:.4f})")
    if not (_num(budget) and 0 < budget
            <= AUTH_MAX_OVERHEAD_BUDGET + 1e-12):
        errs.append(f"overhead budget {budget!r} missing or above the "
                    f"{AUTH_MAX_OVERHEAD_BUDGET} ceiling")
    elif _num(ratio) and ratio > budget \
            and _num(tu) and tu >= AUTH_OVERHEAD_MIN_WALL_S:
        # Below the wall floor the ratio is timing noise, not signal
        # (see AUTH_OVERHEAD_MIN_WALL_S) — recorded, never gated.
        errs.append(f"on-device verify overhead {ratio:.4f} above the "
                    f"stated budget {budget}")
    if bench.get("overhead_ratio") != ratio:
        errs.append(f"bench overhead_ratio "
                    f"{bench.get('overhead_ratio')!r} != artifact "
                    f"{ratio!r}")

    # (e) signature stage: null-or-consistent, never fabricated
    sig = obj["signature"]
    avail = bench.get("crypto_available")
    if avail:
        if not (_num(sig.get("verified")) and _num(sig.get("failed"))
                and sig["verified"] + sig["failed"]
                == sig.get("submitted")):
            errs.append(f"signature stage does not conserve: verified "
                        f"{sig.get('verified')!r} + failed "
                        f"{sig.get('failed')!r} != submitted "
                        f"{sig.get('submitted')!r}")
    ss = obj["serve_signed"]
    if not avail:
        # The null contract covers EVERY signature block — the serve
        # leg embeds the same stage stats, so a fabricated figure
        # there is the same lie.
        for blk_name, blk in (("signature", sig),
                              ("serve_signed", ss)):
            for f in ("verified", "failed", "verify_wall_s",
                      "verifies_per_sec"):
                if blk.get(f) is not None:
                    errs.append(
                        f"{blk_name} {f} {blk[f]!r} without the "
                        f"cryptography dep — a fabricated figure, "
                        f"not the null the optional-dep contract "
                        f"requires")
    if _num(ss.get("sig_submitted")) \
            and _num(ss.get("signed_requests")) \
            and ss["sig_submitted"] > ss["signed_requests"]:
        errs.append(f"serve_signed submitted {ss['sig_submitted']} > "
                    f"signed requests {ss['signed_requests']}")
    return errs


# ---------------------------------------------------------------------------
# chunked-value chaos artifacts (bench --mode chunked)
# ---------------------------------------------------------------------------

# The undefended arm must be visibly garbled under the single-part
# forge or the injection never bit and the defended 1.0 proves
# nothing (same rationale as AUTH_MIN_DEFENSE_GAIN).
CHUNK_MIN_DEFENSE_GAIN = 0.10
_CHUNK_TRACE_FIELDS = _AUTH_TRACE_FIELDS
_CHUNK_LEGS = ("clean", "torn_drop", "kill_mid", "torn_overwrite",
               "forge")
# Legs whose injection tears SOME parts of a value: every affected
# row must read back MISSING — never truncated, never garbled.
_CHUNK_TORN_LEGS = ("torn_drop", "kill_mid", "torn_overwrite")


def _chunk_integrity(legs: dict) -> float:
    """Reproduce an arm's integrity from its per-leg counters: the
    fraction of served (hit) rows that were byte-exact against the
    pre-announce oracle, across every leg.  1.0 when nothing hit."""
    hits = sum(legs[ln]["hit"] for ln in _CHUNK_LEGS)
    exact = sum(legs[ln]["exact"] for ln in _CHUNK_LEGS)
    return 1.0 if hits == 0 else exact / hits


def check_chunked_obj(obj: dict) -> List[str]:
    """All violations found in a loaded ``swarm_chunked_trace``
    artifact (empty = pass).  The chunked gate's contract:

    a. **digest parity** — the device chunked content-id kernel
       (hash-list root over per-part SHA-1 digests) agreed with
       hashlib on the announced rows (``digest_parity`` true);
    b. **parts conservation, exact** — every leg's StoreTrace (the
       SUM over per-part routed insert exchanges) conserves
       ``requests == accepts + rejects + integrity_rejects`` in BOTH
       arms, with ``integrity_rejects == 0`` everywhere (parts ride
       the unverified insert programs by design; the defense lives at
       the get-merge), and the clean leg's summed trace equals the
       whole-value oracle (``conservation.requests ==
       oracle_requests``, same for ``accepts_new``);
    c. **exact reassembly** — the clean leg reads every value back
       byte-exact in both arms (``hit == exact == values``,
       ``garbled == 0``);
    d. **missing, never garbled** — the defended arm served ZERO
       garbled rows across all legs, and on every torn leg (per-part
       drop, mid-announce kill, higher-seq torn overwrite) every
       affected row read back missing (``hit == values - affected``,
       ``torn_missing_rate`` exactly 1.0);
    e. **the defense fired** — the defended arm's forge leg served no
       affected row and booked ``root_rejects >= affected`` at the
       get-merge, the undefended arm is garbled on at least the
       affected rows, defended integrity is exactly 1.0 and the
       undefended arm is degraded by at least
       :data:`CHUNK_MIN_DEFENSE_GAIN`; both stated integrities are
       reproducible from the per-leg counters;
    f. **heal** — the churn leg's torn values were re-replicated by
       republish sweeps: ``post_hit == values`` with zero garbled, in
       at least one sweep.
    """
    errs: List[str] = []
    for field in ("kind", "bench", "params", "conservation", "arms",
                  "heal"):
        if field not in obj:
            errs.append(f"missing top-level field {field!r}")
    if errs:
        return errs
    bench, arms, cons = obj["bench"], obj["arms"], obj["conservation"]
    heal, params = obj["heal"], obj["params"]
    values = params.get("values")
    if not (_num(values) and values > 0):
        errs.append(f"params.values invalid: {values!r}")
        return errs

    # (a) digest parity
    if obj.get("digest_parity") is not True:
        errs.append("digest_parity is not true — the device chunked "
                    "content-id kernel disagreed with hashlib")

    # (b) per-leg structure + parts conservation, both arms
    for arm_name in ("defended", "undefended"):
        arm = arms.get(arm_name)
        if not isinstance(arm, dict):
            errs.append(f"arm {arm_name!r} missing")
            return errs
        legs = arm.get("legs") or {}
        for leg_name in _CHUNK_LEGS:
            leg = legs.get(leg_name)
            if not isinstance(leg, dict):
                errs.append(f"{arm_name}: leg {leg_name!r} missing")
                continue
            bad = [f for f in ("hit", "missing", "garbled", "exact",
                               "affected")
                   if not (_num(leg.get(f)) and leg[f] >= 0)]
            if bad:
                errs.append(f"{arm_name}/{leg_name}: missing/negative "
                            f"counters {bad}")
                continue
            if leg["hit"] + leg["missing"] != values:
                errs.append(f"{arm_name}/{leg_name}: hit {leg['hit']} "
                            f"+ missing {leg['missing']} != values "
                            f"{values}")
            if leg["exact"] + leg["garbled"] != leg["hit"]:
                errs.append(f"{arm_name}/{leg_name}: exact "
                            f"{leg['exact']} + garbled "
                            f"{leg['garbled']} != hit {leg['hit']}")
            tr = leg.get("trace")
            if not isinstance(tr, dict):
                errs.append(f"{arm_name}/{leg_name}: trace missing")
                continue
            bad = [f for f in _CHUNK_TRACE_FIELDS
                   if not (_num(tr.get(f)) and tr[f] >= 0)]
            if bad:
                errs.append(f"{arm_name}/{leg_name}: trace "
                            f"missing/negative counters {bad}")
                continue
            want = tr["accepts_update"] + tr["accepts_new"] \
                + tr["rejects"] + tr["integrity_rejects"]
            if tr["requests"] != want:
                errs.append(
                    f"{arm_name}/{leg_name}: part-summed requests "
                    f"{tr['requests']} != accepts + rejects + "
                    f"integrity_rejects = {want} (conservation is "
                    f"EXACT across parts by construction)")
            if tr["integrity_rejects"] != 0:
                errs.append(
                    f"{arm_name}/{leg_name}: integrity_rejects "
                    f"{tr['integrity_rejects']} != 0 — parts ride the "
                    f"unverified insert by design; a nonzero count "
                    f"means the write path silently ran the verify")
    if errs:
        return errs

    # (b) clean-leg parts-conservation vs the whole-value oracle
    for f in ("requests", "accepts_new"):
        got, want = cons.get(f), cons.get(f"oracle_{f}")
        if not (_num(got) and got > 0):
            errs.append(f"conservation.{f} invalid: {got!r}")
        elif got != want:
            errs.append(f"conservation.{f} {got} != whole-value "
                        f"oracle {want}")

    # (c) exact reassembly on the clean leg, both arms
    for arm_name in ("defended", "undefended"):
        leg = arms[arm_name]["legs"]["clean"]
        if not (leg["hit"] == leg["exact"] == values
                and leg["garbled"] == 0):
            errs.append(f"{arm_name}/clean: not byte-exact — hit "
                        f"{leg['hit']}, exact {leg['exact']}, garbled "
                        f"{leg['garbled']} over {values} values")

    # (d) missing-never-garbled on the defended arm
    dlegs = arms["defended"]["legs"]
    g_total = sum(dlegs[ln]["garbled"] for ln in _CHUNK_LEGS)
    if g_total != 0:
        errs.append(f"defended arm served {g_total} garbled rows — "
                    f"the contract is missing, NEVER garbled")
    for leg_name in _CHUNK_TORN_LEGS:
        leg = dlegs[leg_name]
        if leg["affected"] <= 0:
            errs.append(f"defended/{leg_name}: affected 0 — the "
                        f"injection never bit, the leg gates nothing")
        elif leg["hit"] != values - leg["affected"]:
            errs.append(
                f"defended/{leg_name}: hit {leg['hit']} != values "
                f"{values} - affected {leg['affected']} — a torn row "
                f"was served (or an untorn row was lost)")
    tmr = bench.get("torn_missing_rate")
    if tmr != 1.0:
        errs.append(f"bench torn_missing_rate {tmr!r} != 1.0 — a "
                    f"torn value read back as something other than "
                    f"missing")

    # (e) the defense fired
    fd = dlegs["forge"]
    if fd["affected"] <= 0:
        errs.append("defended/forge: affected 0 — no part was forged")
    else:
        if fd["hit"] != values - fd["affected"]:
            errs.append(f"defended/forge: hit {fd['hit']} != values "
                        f"{values} - affected {fd['affected']} — a "
                        f"forged row entered a result set")
        rr = fd.get("root_rejects")
        if not (_num(rr) and rr >= fd["affected"]):
            errs.append(f"defended/forge: root_rejects {rr!r} < "
                        f"affected {fd['affected']} — the get-merge "
                        f"never booked the rejections")
        fu = arms["undefended"]["legs"]["forge"]
        if fu["garbled"] < fd["affected"]:
            errs.append(f"undefended/forge: garbled {fu['garbled']} <"
                        f" affected {fd['affected']} — the forge "
                        f"never bit, the defended arm proves nothing")
    d_int = arms["defended"].get("integrity")
    u_int = arms["undefended"].get("integrity")
    if d_int != 1.0:
        errs.append(f"defended integrity {d_int!r} != 1.0 — a garbled"
                    f" reassembly entered a result set")
    if not (_num(u_int)
            and u_int <= (d_int or 1.0) - CHUNK_MIN_DEFENSE_GAIN):
        errs.append(f"undefended integrity {u_int!r} not degraded by "
                    f">= {CHUNK_MIN_DEFENSE_GAIN} — the injection "
                    f"never bit, so the defended 1.0 proves nothing")
    for arm_name in ("defended", "undefended"):
        arm = arms[arm_name]
        stated, derived = arm.get("integrity"), _chunk_integrity(
            arm["legs"])
        if not (_num(stated) and abs(stated - derived) <= 1e-9):
            errs.append(f"{arm_name} integrity {stated!r} not "
                        f"reproducible from the per-leg counters "
                        f"({derived:.6f})")

    # (f) heal by republish
    bad = [f for f in ("pre_hit", "post_hit", "sweeps")
           if not (_num(heal.get(f)) and heal[f] >= 0)]
    if bad:
        errs.append(f"heal: missing/negative fields {bad}")
    else:
        if heal["pre_hit"] >= values:
            errs.append(f"heal: pre_hit {heal['pre_hit']} not below "
                        f"values {values} — nothing was torn, the "
                        f"heal leg gates nothing")
        if heal["post_hit"] != values:
            errs.append(f"heal: post_hit {heal['post_hit']} != values"
                        f" {values} — republish did not re-replicate "
                        f"every torn value")
        if heal["sweeps"] < 1:
            errs.append("heal: no republish sweep completed")
        if heal.get("post_garbled") != 0:
            errs.append(f"heal: post_garbled "
                        f"{heal.get('post_garbled')!r} != 0")

    # bench-row cross-checks
    if bench.get("value") != d_int:
        errs.append(f"bench value {bench.get('value')!r} != defended "
                    f"integrity {d_int!r}")
    if bench.get("undefended_integrity") != u_int:
        errs.append(f"bench undefended_integrity "
                    f"{bench.get('undefended_integrity')!r} != arm "
                    f"{u_int!r}")
    if bench.get("garbled_reads") != g_total:
        errs.append(f"bench garbled_reads "
                    f"{bench.get('garbled_reads')!r} != defended-arm "
                    f"sum {g_total}")
    if bench.get("root_rejects") != dlegs["forge"].get("root_rejects"):
        errs.append(f"bench root_rejects "
                    f"{bench.get('root_rejects')!r} != forge leg "
                    f"{dlegs['forge'].get('root_rejects')!r}")
    if _num(heal.get("sweeps")) \
            and bench.get("heal_sweeps") != heal["sweeps"]:
        errs.append(f"bench heal_sweeps {bench.get('heal_sweeps')!r} "
                    f"!= heal block {heal['sweeps']}")
    return errs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        return 2
    path = argv[0]
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        print(f"check_trace: cannot load {path}: {e}")
        return 1
    if obj.get("kind") == "swarm_serve_trace":
        errs = check_serve_obj(obj)
        if errs:
            for e in errs:
                print(f"check_trace: {e}")
            return 1
        life, q = obj["lifecycle"], obj["latency_quantiles_s"]
        print(f"check_trace: serve OK — {life['completed']} completed "
              f"({life['in_flight']} in flight), p50 "
              f"{q['p50'] * 1e3:.1f} ms, p99 {q['p99'] * 1e3:.1f} ms")
        return 0
    if obj.get("kind") == "swarm_soak_trace":
        errs = check_soak_obj(obj)
        if errs:
            for e in errs:
                print(f"check_trace: {e}")
            return 1
        b = obj["bench"]
        led = obj.get("interference") or {}
        delta = led.get("p99_delta_s")
        print(f"check_trace: soak OK — {b['completed']} served at "
              f"{b['value']} req/s with {b['repub_sweeps']} repub + "
              f"{b['monitor_sweeps']} monitor sweeps interleaved, "
              f"p99 {b['latency_p99_s'] * 1e3:.1f} ms"
              + (f" (maintenance delta {delta * 1e3:+.1f} ms)"
                 if delta is not None else ""))
        return 0
    if obj.get("kind") == "swarm_monitor_trace":
        errs = check_monitor_obj(obj)
        if errs:
            for e in errs:
                print(f"check_trace: {e}")
            return 1
        sweeps = obj["monitor"]["sweeps"]
        fid = obj["monitor"]["hop_fidelity"]
        print(f"check_trace: monitor OK — {len(sweeps)} sweeps, "
              f"final coverage {sweeps[-1]['coverage']:.4f}, "
              f"hop tv {fid['tv']:.4f} (band {fid['band_tv']})")
        return 0
    if obj.get("kind") == "swarm_auth_trace":
        errs = check_auth_obj(obj)
        if errs:
            for e in errs:
                print(f"check_trace: {e}")
            return 1
        b = obj["bench"]
        print(f"check_trace: auth OK — defended integrity "
              f"{b['value']} vs undefended "
              f"{b['undefended_integrity']}, "
              f"{b['integrity_rejects']} forged rows rejected in-jit, "
              f"verify overhead {b['overhead_ratio']:+.1%} "
              f"(budget {b['overhead_budget']:.0%})")
        return 0
    if obj.get("kind") == "swarm_chunked_trace":
        errs = check_chunked_obj(obj)
        if errs:
            for e in errs:
                print(f"check_trace: {e}")
            return 1
        b = obj["bench"]
        print(f"check_trace: chunked OK — defended integrity "
              f"{b['value']} vs undefended "
              f"{b['undefended_integrity']:.4f}, "
              f"{b['garbled_reads']} garbled reads, "
              f"{b['root_rejects']} forged rows rejected at the "
              f"get-merge, torn==missing "
              f"{b['torn_missing_rate']:.0%}, healed in "
              f"{b['heal_sweeps']} sweep(s)")
        return 0
    if obj.get("kind") == "swarm_index_trace":
        errs = check_index_obj(obj)
        if errs:
            for e in errs:
                print(f"check_trace: {e}")
            return 1
        ix = obj["index"]
        print(f"check_trace: index OK — {ix['n_leaves']} leaves / "
              f"{ix['entries_in_leaves']} entries, scan recall "
              f"{ix['scans']['recall']}, walk rounds "
              f"{ix['walk_rounds_max']} <= {ix['probe_round_bound']}")
        return 0
    if obj.get("kind") == "cost_ledger":
        errs = check_ledger_obj(obj)
        if errs:
            for e in errs:
                print(f"check_trace: {e}")
            return 1
        n_k = len(obj["kernels"])
        parts = [f"{n_k} kernels"]
        if obj.get("round_phases"):
            rows = obj["round_phases"]["rows"]
            parts.append(f"{len(rows)} round phases summing "
                         f"{sum(r['wall_s'] for r in rows):.4f}s")
        if obj.get("repub_profile"):
            rp = obj["repub_profile"]
            parts.append(f"repub sweep {rp['sweep_wall_s']:.3f}s in "
                         f"{len(rp['rows'])} phases")
        print(f"check_trace: ledger OK — {', '.join(parts)}")
        return 0
    errs = check_trace_obj(obj)
    if errs:
        for e in errs:
            print(f"check_trace: {e}")
        return 1
    t = obj["trace"]
    print(f"check_trace: OK — {t['rounds']} rounds, "
          f"{t['counters']['requests'][0]} round-0 requests, "
          f"final done {t['counters']['done'][-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
