"""The port's artifact checkers against the JAX package's.

``opendht_tpu_torch/tools/check_trace.py``, ``check_bench.py`` and
``roofline.py`` are the port's own copies of the JAX package's checkers.
On every committed artifact and on seeded mutations of each (a dropped
field, a broken conservation count, a quantile pushed out of its
bucket, a phase row moved by +20 %, a NaN, a negative wall, a wrong
``kind``) both give the same violation list, string for string, and
their ``main`` the same exit code and standard output.  Pure JSON: no
engine runs here.
"""

from __future__ import annotations

import copy
import json
import math
import os
import zlib

import pytest

from opendht_tpu.tools import check_bench as jcb
from opendht_tpu.tools import check_trace as jct
from opendht_tpu.tools import roofline as jrl
from opendht_tpu_torch.tools import check_bench as tcb
from opendht_tpu_torch.tools import check_trace as tct
from opendht_tpu_torch.tools import roofline as trl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every committed artifact: the BENCH rows (``parsed`` of a bench log),
# the gate rows, and the trace / ledger artifacts.
ROWS = ["BENCH_r03.json", "BENCH_r04.json", "BENCH_r05.json"]
GATES = ["BENCH_GATE_r05.json", "BENCH_GATE_r06.json", "BENCH_GATE_r07.json",
         "BENCH_GATE_r08.json", "BENCH_GATE_r10.json", "BENCH_GATE_r11.json",
         "BENCH_GATE_r12.json", "BENCH_GATE_r12_sharded.json",
         "BENCH_GATE_r13.json", "BENCH_GATE_r14.json", "BENCH_GATE_r16.json",
         "BENCH_GATE_r17.json", "MONITOR_GATE_r08.json"]
TRACES = ["MONITOR_r08.json", "SERVE_r07.json", "SERVE_SHARDED_r12.json",
          "SOAK_r11.json", "INDEX_r10.json"]
LEDGERS = ["LEDGER_r06.json", "LEDGER_r14.json", "LEDGER_REPUB_r06.json",
           "LEDGER_REPUB_r10.json"]
ARTIFACTS = ROWS + GATES + TRACES + LEDGERS

# The checker ``main`` dispatches each kind to (anything else: the
# flight-recorder checker).
KIND_FN = {"swarm_serve_trace": "check_serve_obj",
           "swarm_soak_trace": "check_soak_obj",
           "swarm_monitor_trace": "check_monitor_obj",
           "swarm_auth_trace": "check_auth_obj",
           "swarm_chunked_trace": "check_chunked_obj",
           "swarm_index_trace": "check_index_obj",
           "cost_ledger": "check_ledger_obj"}

MUTATIONS = ["none", "drop_field", "conservation", "quantile",
             "phase_plus20", "nan", "negative_wall", "wrong_kind"]

# Leaf keys each mutation may touch.
COUNT_KEYS = {"admitted", "completed", "in_flight", "expired", "shed",
              "tracked_alive", "newly_discovered", "probed_seen",
              "entries_in_leaves", "n_leaves", "split_levels", "requests",
              "accepts_new", "hit", "calls", "count", "total_slot_rounds",
              "arrived", "latency_count", "never_admitted", "cache_hits",
              "ring_enqueued", "lag_count", "nodes_seen"}
QUANTILE_KEYS = {"p50", "p95", "p99", "p999", "latency_p50_s",
                 "latency_p99_s", "tv", "recall", "coverage"}


def load(name: str) -> dict:
    with open(os.path.join(REPO, name)) as f:
        obj = json.load(f)
    return obj["parsed"] if name.startswith("BENCH_r") else obj


def leaves(obj, path=()):
    """``(path, key, value)`` of every numeric leaf, in document order."""
    items = (obj.items() if isinstance(obj, dict)
             else enumerate(obj) if isinstance(obj, list) else ())
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from leaves(v, path + (k,))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield path + (k,), k, v


def put(obj, path, value) -> None:
    for k in path[:-1]:
        obj = obj[k]
    obj[path[-1]] = value


def _rows_plus20(obj, key):
    """Move one phase row (seeded below) by +20 % of its table's sum."""
    def edit(o, rng):
        rows = o[key]["rows"]
        i = int(rng.integers(len(rows)))
        rows[i]["wall_s"] += 0.2 * sum(r["wall_s"] for r in rows)
    return edit


def _set(path, fn):
    def edit(o, _rng):
        for k in path[:-1]:
            o = o[k]
        o[path[-1]] = fn(o[path[-1]])
    return edit


# Per kind, the edit each mutation makes: a conservation count off by
# one, a quantile (or the figure a checker recomputes) pushed out of its
# bucket, +20 %, a NaN, a negative wall.
NAN = lambda v: math.nan                            # noqa: E731
NEG = lambda v: -abs(v) - 1.0                       # noqa: E731
TARGETS = {
    "swarm_serve_trace": {
        "conservation": _set(("lifecycle", "admitted"), lambda v: v + 1),
        "quantile": _set(("latency_quantiles_s", "p99"),
                         lambda v: 10 * v + 1.0),
        "phase_plus20": _set(("bench", "value"), lambda v: v * 1.2),
        "nan": _set(("latency_quantiles_s", "p50"), NAN),
        "negative_wall": _set(("bench", "elapsed_s"), NEG)},
    "swarm_soak_trace": {
        "conservation": _set(("lifecycle", "by_class", "read", "admitted"),
                             lambda v: v + 1),
        "quantile": _set(("latency_quantiles_s", "p99"),
                         lambda v: 10 * v + 1.0),
        "phase_plus20": _set(("bench", "value"), lambda v: v * 1.2),
        "nan": _set(("timeline", "rows", 1, "latency_p99_s"), NAN),
        "negative_wall": _set(("timeline", "interval_s"), NEG)},
    "swarm_monitor_trace": {
        "conservation": _set(("monitor", "sweeps", 1, "tracked_alive"),
                             lambda v: v + 1),
        "quantile": _set(("monitor", "hop_fidelity", "tv"),
                         lambda v: v + 0.3),
        "phase_plus20": _set(("bench", "value"), lambda v: v * 1.2),
        "nan": _set(("monitor", "sweeps", 2, "coverage"), NAN),
        "negative_wall": _set(("monitor", "sweeps", 1, "lag_max"), NEG)},
    "swarm_index_trace": {
        "conservation": _set(("index", "entries_in_leaves"),
                             lambda v: v + 1),
        "quantile": _set(("index", "scans", "recall"), lambda v: v * 0.5),
        "phase_plus20": _set(("index", "walk_rounds_max"),
                             lambda v: int(v * 1.2) + 10),
        "nan": _set(("index", "n_leaves"), NAN),
        "negative_wall": _set(("index", "overfull_drops"), NEG)},
    "cost_ledger": {
        "conservation": _set(("hbm", "peak_bytes"), lambda v: -1),
        "quantile": _set(("kernels", 0, "calls"), lambda v: 0),
        "nan": _set(("hbm", "live_bytes"), NAN),
        "negative_wall": _set(("kernels", 0, "wall_s"), NEG)},
}


# The top-level fields each kind's checker requires (a row: its metric
# and value).
REQUIRED = {
    "swarm_serve_trace": ("kind", "bench", "lifecycle", "latency_histogram",
                          "latency_quantiles_s"),
    "swarm_soak_trace": ("kind", "bench", "lifecycle", "timeline",
                         "latency_histogram", "latency_quantiles_s"),
    "swarm_monitor_trace": ("kind", "bench", "monitor"),
    "swarm_index_trace": ("kind", "bench", "index"),
    "cost_ledger": ("platform", "hbm", "kernels")}


def mutate(obj: dict, how: str, seed: int) -> dict:
    """A seeded mutation of a deep copy of ``obj``: the kind's own edit
    from :data:`TARGETS` where it has one, else a seeded numeric leaf of
    the wanted sort (the nearest numeric leaf where there is none)."""
    import numpy as np
    obj = copy.deepcopy(obj)
    rng = np.random.default_rng(seed)
    if how == "none":
        return obj
    if how == "drop_field":
        keys = sorted(k for k in REQUIRED.get(obj.get("kind"),
                                              ("metric", "value"))
                      if k in obj) or sorted(obj)
        del obj[keys[int(rng.integers(len(keys)))]]
        return obj
    if how == "wrong_kind":
        obj["kind"] = ("swarm_lookup_trace" if obj.get("kind")
                       else "cost_ledger")
        return obj
    edits = dict(TARGETS.get(obj.get("kind"), {}))
    if obj.get("kind") == "cost_ledger":
        key = "round_phases" if obj.get("round_phases") else "repub_profile"
        edits["phase_plus20"] = _rows_plus20(obj, key)
    if how in edits:
        edits[how](obj, rng)
        return obj
    num = list(leaves(obj))

    def pick(pred):
        got = [x for x in num if pred(x[0], x[1], x[2])] or num
        return got[int(rng.integers(len(got)))]

    if how == "conservation":
        path, _k, v = pick(lambda p, k, v: k in COUNT_KEYS
                           and isinstance(v, int))
        put(obj, path, v + 1)
    elif how == "quantile":
        path, _k, v = pick(lambda p, k, v: k in QUANTILE_KEYS)
        put(obj, path, 10 * v + 1.0)
    elif how == "phase_plus20":
        path, _k, v = pick(lambda p, k, v: "wall" in str(k))
        put(obj, path, v * 1.2)
    elif how == "nan":
        path, _k, _v = pick(lambda p, k, v: isinstance(v, float))
        put(obj, path, math.nan)
    elif how == "negative_wall":
        path, _k, v = pick(lambda p, k, v: "wall" in str(k)
                           or "elapsed" in str(k) or str(k).endswith("_s"))
        put(obj, path, -abs(v) - 1.0)
    return obj


def outcome(fn, *args):
    """``fn(*args)``'s result, or the exception it raised by type and
    message."""
    try:
        return ("ok", fn(*args))
    except Exception as e:                          # noqa: BLE001
        return ("raised", type(e).__name__, str(e))


def run_main(main, argv, capsys):
    """``main(argv)``'s exit code (``SystemExit`` included), standard
    output and standard error."""
    capsys.readouterr()
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    except Exception as e:                          # noqa: BLE001
        rc = ("raised", type(e).__name__, str(e))
    out = capsys.readouterr()
    return rc, out.out, out.err


def dump(tmp_path, name: str, obj) -> str:
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def seed_of(case: str) -> int:
    return zlib.crc32(case.encode())


# ---------------------------------------------------------------------------
# check_trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", MUTATIONS)
@pytest.mark.parametrize("name", ARTIFACTS)
def test_check_trace_equal(name, how, tmp_path, capsys):
    obj = mutate(load(name), how, seed_of(f"{name}/{how}"))
    fns = {KIND_FN.get(obj.get("kind"), "check_trace_obj"), "check_trace_obj"}
    for fn in sorted(fns):
        want = outcome(getattr(jct, fn), copy.deepcopy(obj))
        got = outcome(getattr(tct, fn), copy.deepcopy(obj))
        assert got == want, fn
    path = dump(tmp_path, "artifact.json", obj)
    assert run_main(tct.main, [path], capsys) == run_main(jct.main, [path],
                                                          capsys)


@pytest.mark.parametrize("argv", [[], ["a.json", "b.json"], ["missing.json"]],
                         ids=["no-args", "two-args", "missing-file"])
def test_check_trace_cli_exit_codes(argv, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc_t, out_t, _ = run_main(tct.main, argv, capsys)
    rc_j, out_j, _ = run_main(jct.main, argv, capsys)
    assert rc_t == rc_j
    if len(argv) == 1:
        assert out_t == out_j
    else:                       # the usage text: each package's docstring
        assert out_t.strip() == tct.__doc__.strip()
        assert out_j.strip() == jct.__doc__.strip()


def test_constants_equal():
    names = [n for n in dir(jct) if n.isupper()]
    assert names and names == [n for n in dir(tct) if n.isupper()]
    for n in names:
        assert getattr(tct, n) == getattr(jct, n), n
    for n in ("COVERAGE_METRICS", "COVERAGE_MIN_RATIO"):
        assert getattr(tcb, n) == getattr(jcb, n)
    assert (trl.BOUND_FRAC, trl.DEFAULT_PEAKS) == (jrl.BOUND_FRAC,
                                                   jrl.DEFAULT_PEAKS)


# ---------------------------------------------------------------------------
# check_bench
# ---------------------------------------------------------------------------

def _row(src: str) -> dict:
    obj = load(src)
    return obj["bench"] if "bench" in obj else obj


# (id, current, baseline, edits of the current row): every metric family
# the checker branches on, on one platform and across platforms.
BENCH_CASES = [
    ("lookups-same", "BENCH_GATE_r14.json", "BENCH_GATE_r05.json", {}),
    ("lookups-self", "BENCH_GATE_r06.json", "BENCH_GATE_r06.json", {}),
    ("lookups-slow", "BENCH_GATE_r14.json", "BENCH_GATE_r05.json",
     {"value": lambda v: v * 0.5}),
    ("lookups-recall", "BENCH_GATE_r05.json", "BENCH_GATE_r05.json",
     {"recall_at_8": lambda v: v - 0.02, "done_frac": lambda v: v - 0.01,
      "median_hops": lambda v: v + 1.0}),
    ("lookups-cross-tpu", "BENCH_GATE_r05.json", "BENCH_r05.json", {}),
    ("lookups-cross-gpu", "BENCH_r05.json", "BENCH_r05.json",
     {"platform": lambda v: "gpu", "value": lambda v: v * 0.01}),
    ("lookups-cross-gpu-hops", "BENCH_r05.json", "BENCH_r05.json",
     {"platform": lambda v: "gpu", "median_hops": lambda v: v + 1.0}),
    ("lookups-old-rows", "BENCH_r04.json", "BENCH_r03.json", {}),
    ("serve-same", "SERVE_r07.json", "BENCH_GATE_r07.json", {}),
    ("serve-p99", "BENCH_GATE_r07.json", "BENCH_GATE_r07.json",
     {"latency_p99_s": lambda v: v * 2.0}),
    ("serve-cache", "BENCH_GATE_r17.json", "BENCH_GATE_r17.json",
     {"cache_hit_frac": lambda v: v * 0.5}),
    ("serve-sharded", "SERVE_SHARDED_r12.json", "BENCH_GATE_r12_sharded.json",
     {}),
    ("serve-cross", "BENCH_GATE_r12.json", "BENCH_GATE_r12.json",
     {"platform": lambda v: "gpu", "latency_p99_s": lambda v: v * 9.0}),
    ("crawl-same", "BENCH_GATE_r08.json", "BENCH_GATE_r08.json", {}),
    ("crawl-low", "BENCH_GATE_r08.json", "BENCH_GATE_r08.json",
     {"value": lambda v: v * 0.9, "platform": lambda v: "gpu"}),
    ("monitor-same", "MONITOR_r08.json", "MONITOR_GATE_r08.json", {}),
    ("monitor-lag", "MONITOR_GATE_r08.json", "MONITOR_GATE_r08.json",
     {"detection_lag_max": lambda v: v + 10}),
    ("index-same", "INDEX_r10.json", "BENCH_GATE_r10.json", {}),
    ("index-inexact", "BENCH_GATE_r10.json", "BENCH_GATE_r10.json",
     {"scan_recall": lambda v: 0.9, "scan_exact": lambda v: False,
      "overfull_drops": lambda v: v + 5}),
    ("soak-same", "SOAK_r11.json", "BENCH_GATE_r11.json", {}),
    ("soak-quality", "BENCH_GATE_r11.json", "BENCH_GATE_r11.json",
     {"wclass_mismatches": lambda v: 1, "slo_violation_ratio": lambda v: 1.0,
      "value_survival_final": lambda v: 0.5, "repub_sweeps": lambda v: 0,
      "monitor_sweeps": lambda v: 0, "monitor_coverage": lambda v: 0.1,
      "detection_lag_max": lambda v: 99}),
    ("soak-cross", "SOAK_r11.json", "BENCH_GATE_r11.json",
     {"platform": lambda v: "gpu", "value": lambda v: v * 0.1}),
    ("auth-same", "BENCH_GATE_r13.json", "BENCH_GATE_r13.json", {}),
    ("auth-broken", "BENCH_GATE_r13.json", "BENCH_GATE_r13.json",
     {"value": lambda v: 0.99, "integrity_rejects": lambda v: 0,
      "undefended_integrity": lambda v: v + 0.5,
      "overhead_ratio": lambda v: 1.0, "unverified_wall_s": lambda v: 5.0}),
    ("auth-cross", "BENCH_GATE_r13.json", "BENCH_GATE_r13.json",
     {"platform": lambda v: "gpu", "overhead_ratio": lambda v: 1.0,
      "unverified_wall_s": lambda v: 5.0}),
    ("chunked-same", "BENCH_GATE_r16.json", "BENCH_GATE_r16.json", {}),
    ("chunked-broken", "BENCH_GATE_r16.json", "BENCH_GATE_r16.json",
     {"value": lambda v: 0.9, "garbled_reads": lambda v: 1,
      "torn_missing_rate": lambda v: 0.5, "root_rejects": lambda v: 0,
      "heal_sweeps": lambda v: 0, "undefended_integrity": lambda v: 1.0}),
    ("metric-mismatch", "BENCH_GATE_r07.json", "BENCH_GATE_r05.json", {}),
]


def _bench_pair(cur_src, base_src, edits):
    cur, base = copy.deepcopy(_row(cur_src)), copy.deepcopy(_row(base_src))
    for k, f in edits.items():
        cur[k] = f(cur.get(k))
    return cur, base


@pytest.mark.parametrize("case", BENCH_CASES, ids=[c[0] for c in BENCH_CASES])
def test_check_bench_equal(case, tmp_path, capsys):
    _id, cur_src, base_src, edits = case
    cur, base = _bench_pair(cur_src, base_src, edits)
    results = []
    for mod in (jcb, tcb):
        capsys.readouterr()
        res = outcome(mod.check_bench_rows, copy.deepcopy(cur),
                      copy.deepcopy(base))
        results.append((res, capsys.readouterr().out))
    assert results[1] == results[0]
    c = dump(tmp_path, "cur.json", cur)
    b = dump(tmp_path, "base.json", base)
    for argv in ([c, b], [c, b, "--min-ratio", "1.5", "--max-p99-ratio",
                          "0.5"]):
        assert run_main(tcb.main, argv, capsys) == run_main(jcb.main, argv,
                                                            capsys)


@pytest.mark.parametrize("src", TRACES + ["LEDGER_r06.json"])
def test_check_bench_loads_artifacts_equal(src, tmp_path, capsys):
    """``main`` reads a trace artifact's ``bench`` row (and refuses a
    file without a row) as JAX's does."""
    path = os.path.join(REPO, src)
    assert outcome(tcb._load_row, path) == outcome(jcb._load_row, path)
    assert run_main(tcb.main, [path, path], capsys) == run_main(
        jcb.main, [path, path], capsys)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

PEAKS = {"default": (None, None), "h100": (67_000.0, 3_350.0),
         "bytes-only": (None, 3_350.0)}


@pytest.mark.parametrize("peaks", list(PEAKS))
@pytest.mark.parametrize("name", LEDGERS + ["LEDGER_r06.json/plus20",
                                            "LEDGER_REPUB_r10.json/plus20"])
def test_roofline_equal(name, peaks, tmp_path, capsys):
    src, _, how = name.partition("/")
    obj = load(src)
    if how:
        obj = mutate(obj, "phase_plus20", seed_of(name))
    g, b = PEAKS[peaks]
    want = jrl.roofline_report(copy.deepcopy(obj), g, b)
    got = trl.roofline_report(copy.deepcopy(obj), g, b)
    assert got == want
    assert trl.render_markdown(got) == jrl.render_markdown(want)
    path = dump(tmp_path, "ledger.json", obj)
    argv = [path] + (["--peak-gflops", str(g)] if g else []) + (
        ["--peak-gbps", str(b)] if b else [])
    outs = []
    for mod, js in ((jrl, "j.json"), (trl, "t.json")):
        res = run_main(mod.main, argv + ["--json", str(tmp_path / js)],
                       capsys)
        with open(tmp_path / js) as f:
            outs.append((res, json.load(f)))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("src", ["SERVE_r07.json", "missing.json"])
def test_roofline_refusals_equal(src, capsys):
    path = os.path.join(REPO, src)
    assert run_main(trl.main, [path], capsys) == run_main(jrl.main, [path],
                                                          capsys)


def test_port_ledger_rows_read_unmeasured():
    """The port's ledger writes ``flops`` / ``bytes_accessed`` as null,
    so every row of its roofline reads ``unmeasured`` (in both
    packages' reports)."""
    obj = load("LEDGER_r14.json")
    for row in (obj["kernels"] + obj["round_phases"]["rows"]):
        row["flops"] = row["bytes_accessed"] = None
    rep = trl.roofline_report(obj, 67_000.0, 3_350.0)
    assert rep == jrl.roofline_report(obj, 67_000.0, 3_350.0)
    rows = rep["round_phases"] + rep["kernels"]
    assert rows and {r["bound"] for r in rows} == {"unmeasured"}


def test_jax_soak_burns_default_slo():
    """JAX's own soak artifact (``SOAK_r11.json``: ``bench.py --mode
    soak`` at 1M nodes on the CPU, stated at a 45 s SLO) restated at
    ``bench.py``'s default SLO (250 ms, bound 0.10), each interval's
    violations recounted from its histogram at the 250 ms bucket bound:
    both checkers then find the SLO burned and nothing else, and give
    the same message the port's 10M soak legs give on the card.  A CPU
    run's latencies say nothing of JAX's on its chip, so this pins the
    verdict, not a shared cause: the card's burn is a port finding
    (``chip_smoke.py``'s ``SOAK_SLO_CAP``)."""
    obj = load("SOAK_r11.json")
    tl = obj["timeline"]
    cut = tl["latency_bounds_s"].index(0.25) + 1
    tl["slo_target_s"] = 0.25
    for r in tl["rows"]:
        r["slo_violations"] = sum(r["latency_counts"][cut:])
    n = sum(sum(r["latency_counts"]) for r in tl["rows"])
    viol = sum(r["slo_violations"] for r in tl["rows"])
    obj["bench"].update(slo_target_s=0.25, slo_violation_max=0.10,
                        slo_violation_ratio=round(viol / n, 6))
    want = jct.check_soak_obj(copy.deepcopy(obj))
    assert tct.check_soak_obj(copy.deepcopy(obj)) == want
    assert len(want) == 1 and want[0].startswith("slo_violation_ratio ")
    assert want[0].endswith("the SLO is burned")
