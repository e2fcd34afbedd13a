"""Roofline verdict for a cost-ledger artifact.

    python -m opendht_tpu_torch.tools.roofline LEDGER.json \
        [--peak-gflops G] [--peak-gbps B] [--json OUT]

Consumes a ``bench.py --ledger-out`` artifact (``kind: cost_ledger``)
plus a machine peak spec and classifies every round sub-phase (and
every cost-analyzed kernel) as **compute-bound**, **memory-bound**, or
**gather-issue-bound** — the verdict a change to the round core
needs first:

* achieved FLOP/s and bytes/s come from the ledger's measured walls and
  its ``flops`` / ``bytes_accessed`` counts (the port's ledger writes
  them as null, so its rows read ``unmeasured``);
* a phase running within ``BOUND_FRAC`` of either roof is bound by that
  roof (arithmetic intensity vs the ridge point breaks ties);
* a phase far below BOTH roofs is *issue*-bound — the ALU and the
  memory bus are both idle, so the limiter is instruction issue:
  scalar-issue gathers, scatter chains, kernel-launch gaps.  That is
  the signature of the whole-row table gather, whose cost is one
  fetch a row regardless of the row's width, hence the name.

The sub-phase rows are also re-checked against the bench row's
``round_wall_p50`` (±10 %) — a roofline over rows that don't sum to
the measured round would be priced fiction; exit 1 in that case.

Peak defaults are deliberately conservative per-platform placeholders
(recorded as ``spec_source: default-<platform>`` in the report); pass
the real machine's numbers for a calibrated verdict (an H100 SXM:
``--peak-gflops 67000 --peak-gbps 3350``).

The port's own copy of ``opendht_tpu/tools/roofline.py``: the same
peaks, classes and report, with the ledger gate through the port's
:func:`~opendht_tpu_torch.tools.check_trace.check_ledger_obj`.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

# A phase achieving at least this fraction of a roof is bound by it.
BOUND_FRAC = 0.33

# Conservative order-of-magnitude peaks per backend, used only when the
# caller does not pass the machine's real spec.  cpu: one modern server
# socket's SIMD FP32 / ~6-channel DDR; tpu: v5e-1; gpu: a generic
# older card.
DEFAULT_PEAKS = {
    "cpu": (200.0, 80.0),        # (GFLOP/s, GB/s)
    "tpu": (197_000.0, 819.0),
    "gpu": (19_500.0, 600.0),
}


def classify(wall_s: float, flops: Optional[float],
             byts: Optional[float], peak_gflops: float,
             peak_gbps: float) -> dict:
    """One row's roofline placement (see module docstring)."""
    out = {"wall_s": wall_s, "flops": flops, "bytes_accessed": byts}
    if not wall_s or wall_s <= 0 or flops is None or byts is None:
        out.update(bound="unmeasured", note="no wall or cost analysis")
        return out
    gf = flops / wall_s / 1e9
    gb = byts / wall_s / 1e9
    frac_c = gf / peak_gflops
    frac_m = gb / peak_gbps
    out.update(
        achieved_gflops=round(gf, 3), achieved_gbps=round(gb, 3),
        intensity_flop_per_byte=(round(flops / byts, 4) if byts
                                 else None),
        frac_compute_roof=round(frac_c, 4),
        frac_memory_roof=round(frac_m, 4))
    if max(frac_c, frac_m) >= BOUND_FRAC:
        out["bound"] = "compute" if frac_c >= frac_m else "memory"
    else:
        out["bound"] = "gather-issue"
    return out


def roofline_report(ledger: dict, peak_gflops: Optional[float] = None,
                    peak_gbps: Optional[float] = None) -> dict:
    """Build the full report dict from a loaded ledger artifact."""
    platform = ledger.get("platform", "cpu")
    spec_source = "caller"
    if peak_gflops is None or peak_gbps is None:
        dg, db = DEFAULT_PEAKS.get(platform, DEFAULT_PEAKS["cpu"])
        peak_gflops = peak_gflops if peak_gflops is not None else dg
        peak_gbps = peak_gbps if peak_gbps is not None else db
        spec_source = f"default-{platform}"
    # ONE consistency gate, shared with check_trace (same tolerance,
    # same target precedence, same noise floors): a roofline over rows
    # that cannot reproduce the measured round/sweep is priced fiction,
    # and the two checkers must never disagree about it.
    from .check_trace import check_ledger_obj
    errs: List[str] = list(check_ledger_obj(ledger))

    phases = []
    rp = ledger.get("round_phases")
    if rp:
        for row in rp.get("rows", []):
            phases.append({"phase": row["phase"], **classify(
                row.get("wall_s"), row.get("flops"),
                row.get("bytes_accessed"), peak_gflops, peak_gbps)})

    # Width-laddered attribution (tail-round state, merge
    # priced at a ladder rung): classified like the primary table so
    # the narrowed planes get their own verdict row.
    phases_laddered = []
    rpl = ledger.get("round_phases_laddered")
    if rpl:
        for row in rpl.get("rows", []):
            phases_laddered.append({"phase": row["phase"], **classify(
                row.get("wall_s"), row.get("flops"),
                row.get("bytes_accessed"), peak_gflops, peak_gbps)})

    kernels = []
    for k in ledger.get("kernels", []):
        kernels.append({
            "kernel": k["name"], "calls": k["calls"],
            "donated": k.get("donated"),
            **classify(
                (k["wall_s"] / k["calls"]) if k.get("calls") else None,
                (k["flops"] / 1.0) if k.get("flops") is not None
                else None,
                k.get("bytes_accessed"), peak_gflops, peak_gbps)})

    repub = []
    for row in (ledger.get("repub_profile") or {}).get("rows", []):
        repub.append({"phase": row["phase"], **classify(
            row.get("wall_s"), row.get("flops"),
            row.get("bytes_accessed"), peak_gflops, peak_gbps)})

    return {
        "kind": "roofline_report",
        "platform": platform,
        "machine": {"peak_gflops": peak_gflops, "peak_gbps": peak_gbps,
                    "ridge_flop_per_byte": round(
                        peak_gflops / peak_gbps, 3),
                    "spec_source": spec_source},
        "round_phases": phases,
        "round_phases_laddered": phases_laddered,
        "laddered_merge_w": (rpl or {}).get("merge_w"),
        "kernels": kernels,
        "repub_profile": repub,
        "errors": errs,
    }


def _md_table(rows: List[dict], key: str) -> List[str]:
    out = [f"| {key} | wall_s | GFLOP/s | GB/s | %compute | %memory "
           f"| verdict |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        fc, fm = r.get("frac_compute_roof"), r.get("frac_memory_roof")
        w = r.get("wall_s")
        out.append(
            f"| {r.get('phase') or r.get('kernel')} "
            f"| {round(w, 6) if w is not None else '—'} "
            f"| {r.get('achieved_gflops', '—')} "
            f"| {r.get('achieved_gbps', '—')} "
            f"| {f'{100 * fc:.1f}%' if fc is not None else '—'} "
            f"| {f'{100 * fm:.1f}%' if fm is not None else '—'} "
            f"| **{r['bound']}** |")
    return out


def render_markdown(report: dict) -> str:
    m = report["machine"]
    lines = [
        f"## Roofline — {report['platform']} "
        f"(peak {m['peak_gflops']:.0f} GFLOP/s, {m['peak_gbps']:.0f} "
        f"GB/s, ridge {m['ridge_flop_per_byte']} FLOP/B, spec: "
        f"{m['spec_source']})", ""]
    if report["round_phases"]:
        lines += ["### Round sub-phases", ""]
        lines += _md_table(report["round_phases"], "phase") + [""]
    if report.get("round_phases_laddered"):
        lines += [f"### Round sub-phases — width-laddered merge "
                  f"(rung {report.get('laddered_merge_w')})", ""]
        lines += _md_table(report["round_phases_laddered"],
                           "phase") + [""]
    if report["repub_profile"]:
        lines += ["### Republish sweep phases", ""]
        lines += _md_table(report["repub_profile"], "phase") + [""]
    if report["kernels"]:
        lines += ["### Kernels (per-invocation)", ""]
        lines += _md_table(report["kernels"], "kernel") + [""]
    for e in report["errors"]:
        lines.append(f"**ERROR:** {e}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ledger")
    ap.add_argument("--peak-gflops", type=float, default=None)
    ap.add_argument("--peak-gbps", type=float, default=None)
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the report as JSON to this path")
    args = ap.parse_args(argv)
    try:
        with open(args.ledger) as f:
            ledger = json.load(f)
    except (OSError, ValueError) as e:
        print(f"roofline: cannot load {args.ledger}: {e}")
        return 1
    if ledger.get("kind") != "cost_ledger":
        print(f"roofline: {args.ledger} is not a cost_ledger artifact "
              f"(kind={ledger.get('kind')!r})")
        return 1
    report = roofline_report(ledger, args.peak_gflops, args.peak_gbps)
    print(render_markdown(report))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    if report["errors"]:
        for e in report["errors"]:
            print(f"roofline: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
