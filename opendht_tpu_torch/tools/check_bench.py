"""Gate a bench run against a recorded perf register row.

    python -m opendht_tpu_torch.tools.check_bench CURRENT BASELINE \
        [--min-ratio 0.95]

``CURRENT`` and ``BASELINE`` are JSON files holding either a raw BENCH
row (the ``{"metric": ..., "value": ...}`` line bench.py prints) or a
``--trace-out`` flight-recorder artifact (whose ``bench`` field holds
the row) — the gate reuses the trace artifact it already produced, so
no extra bench run is paid.

Checks, in decreasing severity:

* ``value`` (lookups/s) must not drop below ``min-ratio`` × the
  recorded baseline — but ONLY when the two rows ran on the same
  ``platform``: a CPU container comparing itself against a TPU row (or
  vice versa) would always fail or always pass meaninglessly, so
  cross-platform rate comparison is reported as SKIPPED, never as a
  verdict.  Quality metrics are platform-independent and always gate:
* ``recall_at_8`` must not regress (> 0.005 absolute drop fails);
* ``done_frac`` must not regress (> 1e-6 drop fails);
* ``median_hops`` must not grow by more than 0.5 (a compaction or
  schedule bug that trades rounds for rate shows up here).

SERVE rows (``swarm_serve_req_per_sec`` — from ``--mode serve`` or its
``swarm_serve_trace`` artifact) additionally gate the tail latency:
``latency_p99_s`` must not exceed ``--max-p99-ratio`` (default 1.5) ×
the recorded baseline — same-platform only, like the rate floor
(latency is a property of the machine the row was recorded on).

COVERAGE rows (``swarm_crawl_coverage`` / ``swarm_monitor_coverage`` —
the crawl leg and ``--mode monitor``, incl. its
``swarm_monitor_trace`` artifact) replace the rate floor with a
QUALITY floor that gates on any platform: coverage must not drop below
0.99 × the recorded value (the crawl row was the one bench mode with
no regression gate), and a monitor row's measured ``detection_lag_max``
must stay within the recorded row's stated sweep-period bound.

INDEX rows (``swarm_index_scan_entries_per_sec`` — ``--mode index``
or its ``swarm_index_trace`` artifact) keep the same-platform rate
floor and add any-platform EXACTNESS gates: ``scan_recall`` must be
exactly 1.0, ``scan_exact`` must hold, and ``overfull_drops`` must
not grow past the recorded row's.

Exit 0 on pass; exit 1 with one line per violation.

The port's own copy of ``opendht_tpu/tools/check_bench.py``: the same
gates and messages.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List


def _load_row(path: str) -> dict:
    with open(path) as f:
        obj = json.load(f)
    if obj.get("kind") in ("swarm_lookup_trace", "swarm_serve_trace",
                           "swarm_monitor_trace", "swarm_index_trace",
                           "swarm_soak_trace", "swarm_auth_trace",
                           "swarm_chunked_trace"):
        obj = obj["bench"]                           # ...artifacts
    if "value" not in obj or "metric" not in obj:
        raise ValueError(f"{path}: no BENCH row found (need "
                         f"'metric'/'value' or a trace artifact)")
    return obj


# Coverage rows (the crawl leg and the monitor's steady-state
# coverage) gate as QUALITY metrics: platform-independent (the crawl
# is seed-deterministic arithmetic, not a rate), floored at
# COVERAGE_MIN_RATIO x the recorded value: the crawl and the monitor
# are the bench modes with no rate floor.
COVERAGE_METRICS = ("swarm_crawl_coverage", "swarm_monitor_coverage")
COVERAGE_MIN_RATIO = 0.99


def check_bench_rows(cur: dict, base: dict,
                     min_ratio: float = 0.95,
                     max_p99_ratio: float = 1.5) -> List[str]:
    """All violations of ``cur`` against ``base`` (empty = pass)."""
    errs: List[str] = []
    if cur.get("metric") != base.get("metric"):
        errs.append(f"metric mismatch: {cur.get('metric')!r} vs "
                    f"baseline {base.get('metric')!r}")
        return errs

    if cur.get("metric") == "swarm_auth_defended_integrity":
        # Auth rows gate as QUALITY on any platform: integrity is a
        # correctness statement, not a machine rate.  The defended arm
        # must be EXACTLY 1.0 (a 0.999 means a forged payload entered
        # a result set), the defense must demonstrably have fired, and
        # the undefended arm must stay degraded (an attack that
        # stopped biting would let a broken verify gate green).
        if cur["value"] != 1.0:
            errs.append(f"defended integrity {cur['value']} != 1.0")
        ir = cur.get("integrity_rejects")
        if ir is not None and ir < 1:
            errs.append("integrity_rejects 0 — the verify plane never "
                        "fired under injection")
        ui, ub = cur.get("undefended_integrity"), base.get(
            "undefended_integrity")
        if ui is not None and ub is not None and ui > ub + 0.1:
            errs.append(f"undefended integrity {ui} well above the "
                        f"recorded {ub} — the injection regressed")
        # Verify overhead is a timing ratio: same-platform only, like
        # every rate floor, and only where the wall is long enough to
        # be signal — the SAME noise floor check_trace applies
        # (AUTH_OVERHEAD_MIN_WALL_S), so the two checkers can never
        # disagree on one artifact.
        from .check_trace import AUTH_OVERHEAD_MIN_WALL_S
        tu = cur.get("unverified_wall_s")
        if cur.get("platform") == base.get("platform") \
                and tu is not None and tu >= AUTH_OVERHEAD_MIN_WALL_S:
            ov, ob = cur.get("overhead_ratio"), cur.get(
                "overhead_budget")
            if ov is not None and ob is not None and ov > ob:
                errs.append(f"verify overhead_ratio {ov} above the "
                            f"stated budget {ob}")
        return errs

    if cur.get("metric") == "swarm_chunked_defended_integrity":
        # Chunked rows gate as QUALITY on any platform:
        # reassembly exactness and the missing-never-garbled contract
        # are correctness statements, not machine rates.
        if cur["value"] != 1.0:
            errs.append(f"chunked defended integrity {cur['value']} "
                        f"!= 1.0")
        if cur.get("garbled_reads") != 0:
            errs.append(f"garbled_reads {cur.get('garbled_reads')!r} "
                        f"!= 0 — a torn or forged value was served")
        if cur.get("torn_missing_rate") != 1.0:
            errs.append(f"torn_missing_rate "
                        f"{cur.get('torn_missing_rate')!r} != 1.0")
        rr = cur.get("root_rejects")
        if rr is not None and rr < 1:
            errs.append("root_rejects 0 — the per-part integrity "
                        "plane never fired under injection")
        hs = cur.get("heal_sweeps")
        if hs is not None and hs < 1:
            errs.append("heal_sweeps 0 — no republish sweep healed "
                        "the torn values")
        ui, ub = cur.get("undefended_integrity"), base.get(
            "undefended_integrity")
        if ui is not None and ub is not None and ui > ub + 0.1:
            errs.append(f"undefended integrity {ui} well above the "
                        f"recorded {ub} — the injection regressed")
        return errs

    if cur.get("metric") in COVERAGE_METRICS:
        # Coverage is a fraction, not a machine rate: the floor gates
        # on ANY platform, and the generic same-platform rate floor
        # below would be both looser and semantically wrong for it.
        floor = COVERAGE_MIN_RATIO * base["value"]
        if cur["value"] < floor:
            errs.append(
                f"{cur['metric']} {cur['value']} below "
                f"{COVERAGE_MIN_RATIO:.0%} of recorded baseline "
                f"{base['value']} (floor {floor:.4f})")
        # Monitor rows also carry the lag contract: detection must not
        # exceed the RECORDED row's stated bound (the sweep period).
        lag, lag_bound = cur.get("detection_lag_max"), base.get(
            "detection_lag_bound_sweeps")
        if lag is not None and lag_bound is not None \
                and lag > lag_bound:
            errs.append(f"detection_lag_max {lag} exceeds the "
                        f"recorded sweep-period bound {lag_bound}")
    elif cur.get("platform") == base.get("platform"):
        floor = min_ratio * base["value"]
        if cur["value"] < floor:
            errs.append(
                f"{cur['metric']} {cur['value']} below {min_ratio:.0%} "
                f"of recorded baseline {base['value']} "
                f"(floor {floor:.1f}, platform {cur.get('platform')})")
        # Serve rows carry a tail-latency SLO leg: p99 is as
        # load-bearing as the rate — a serve engine that got "faster"
        # by queueing the tail must not gate green.
        p_cur, p_base = cur.get("latency_p99_s"), base.get(
            "latency_p99_s")
        if p_cur is not None and p_base is not None \
                and p_cur > max_p99_ratio * p_base:
            errs.append(
                f"latency_p99_s {p_cur} above {max_p99_ratio:.1f}x "
                f"recorded baseline {p_base} (ceiling "
                f"{max_p99_ratio * p_base:.4f}s)")
        # Cache-on serve rows also hold their hit fraction: a row
        # that kept its rate by hammering the slot plane because the
        # cache stopped hitting must not gate green.  Same-platform
        # (hit rate depends on completion timing, which is a machine
        # property) with a 0.9x floor — the Zipf schedule is seeded,
        # so the band is run noise, not workload variance.
        c_cur, c_base = cur.get("cache_hit_frac"), base.get(
            "cache_hit_frac")
        if c_cur is not None and c_base and c_cur < 0.9 * c_base:
            errs.append(f"cache_hit_frac {c_cur} below 90% of "
                        f"recorded baseline {c_base}")
    else:
        print(f"check_bench: rate comparison SKIPPED — platform "
              f"{cur.get('platform')!r} vs baseline "
              f"{base.get('platform')!r} (quality gates still apply)")

    # Soak rows (swarm_soak_req_per_sec): the rate floor and p99
    # ceiling above already apply; these are the any-platform QUALITY
    # gates — an always-on node that serves fast by dropping its
    # maintenance duties must never gate green.
    if cur.get("metric") == "swarm_soak_req_per_sec":
        if cur.get("wclass_mismatches") != 0:
            errs.append(f"wclass_mismatches "
                        f"{cur.get('wclass_mismatches')!r} != 0 — "
                        f"the work-class plane lost integrity")
        sv, sv_max = cur.get("slo_violation_ratio"), cur.get(
            "slo_violation_max")
        if sv is not None and sv_max is not None and sv > sv_max:
            errs.append(f"slo_violation_ratio {sv} above the stated "
                        f"bound {sv_max}")
        lag, lag_bound = cur.get("detection_lag_max"), base.get(
            "detection_lag_bound_sweeps")
        if lag is not None and lag_bound is not None \
                and lag > lag_bound:
            errs.append(f"detection_lag_max {lag} exceeds the "
                        f"recorded sweep-period bound {lag_bound}")
        cov, cov_b = cur.get("monitor_coverage"), base.get(
            "monitor_coverage")
        if cov is not None and cov_b is not None \
                and cov < COVERAGE_MIN_RATIO * cov_b:
            errs.append(f"monitor_coverage {cov} below "
                        f"{COVERAGE_MIN_RATIO:.0%} of recorded "
                        f"{cov_b}")
        surv, surv_b = cur.get("value_survival_final"), base.get(
            "value_survival_final")
        if surv is not None and surv_b is not None \
                and surv < COVERAGE_MIN_RATIO * surv_b:
            errs.append(f"value_survival_final {surv} below "
                        f"{COVERAGE_MIN_RATIO:.0%} of recorded "
                        f"{surv_b} — re-replication regressed")
        rs, rs_b = cur.get("repub_sweeps"), base.get("repub_sweeps")
        ms, ms_b = cur.get("monitor_sweeps"), base.get(
            "monitor_sweeps")
        if rs is not None and rs_b and rs < 1:
            errs.append("no republish sweep completed (baseline "
                        f"recorded {rs_b})")
        if ms is not None and ms_b and ms < 1:
            errs.append("no monitor sweep completed (baseline "
                        f"recorded {ms_b})")

    # Index rows (swarm_index_scan_entries_per_sec): exactness is a
    # hard quality gate on ANY platform — a scan that got faster by
    # dropping entries (or inventing them) must never gate green.
    sr = cur.get("scan_recall")
    if sr is not None and sr != 1.0:
        errs.append(f"scan_recall {sr} != 1.0 — range scans are not "
                    f"exact vs the host-PHT oracle")
    if cur.get("scan_exact") is False:
        errs.append("scan_exact false — scans returned entries the "
                    "oracle does not hold")
    od = cur.get("overfull_drops")
    ob = base.get("overfull_drops")
    if od is not None and ob is not None and od > ob:
        errs.append(f"overfull_drops grew: {od} vs baseline {ob}")

    r_cur, r_base = cur.get("recall_at_8"), base.get("recall_at_8")
    if r_cur is not None and r_base is not None \
            and r_cur < r_base - 0.005:
        errs.append(f"recall_at_8 regressed: {r_cur} vs baseline "
                    f"{r_base}")
    d_cur, d_base = cur.get("done_frac"), base.get("done_frac")
    if d_cur is not None and d_base is not None \
            and d_cur < d_base - 1e-6:
        errs.append(f"done_frac regressed: {d_cur} vs baseline "
                    f"{d_base}")
    h_cur, h_base = cur.get("median_hops"), base.get("median_hops")
    if h_cur is not None and h_base is not None \
            and h_cur > h_base + 0.5:
        errs.append(f"median_hops grew: {h_cur} vs baseline {h_base}")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("current")
    ap.add_argument("baseline")
    ap.add_argument("--min-ratio", type=float, default=0.95)
    ap.add_argument("--max-p99-ratio", type=float, default=1.5)
    args = ap.parse_args(argv)
    try:
        cur = _load_row(args.current)
        base = _load_row(args.baseline)
    except (OSError, ValueError) as e:
        print(f"check_bench: {e}")
        return 1
    errs = check_bench_rows(cur, base, args.min_ratio,
                            args.max_p99_ratio)
    if errs:
        for e in errs:
            print(f"check_bench: {e}")
        return 1
    extra = ""
    if "mean_active_frac" in cur:
        extra = (f", mean_active_frac {cur['mean_active_frac']}"
                 f" over {cur.get('rounds_dispatched')} rounds")
    print(f"check_bench: OK — {cur['metric']} {cur['value']} "
          f"{cur.get('unit', '')} vs baseline {base['value']}"
          f"{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
