"""Headline aggregates of the resident serve loop.

The port's own copy of ``resident_summary`` from
``opendht_tpu/obs/timeline.py`` (numpy-free arithmetic on a
:func:`~opendht_tpu_torch.models.serve.serve_resident` report).  The
soak timeline and the Prometheus gauges of that module are not
ported.
"""

from __future__ import annotations


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
