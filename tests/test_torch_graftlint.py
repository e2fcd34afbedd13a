"""The port's graftlint (``opendht_tpu_torch/tools/graftlint.py`` and
``graftlint_ranges.py``): every rule fires on a fixture that breaks it
and stays silent on one that does not; the port's own tree is clean on
every plane on the CPU; seeded mutations of the real code are caught;
and the planes JAX's and the port's share (lock, pragmas, stale
pragmas) give JAX's findings on ``tests/test_graftlint.py``'s fixtures.

One canonical-workload pass (2,048 nodes, 512 targets, the CPU, one
torch thread) is shared by the ``lower`` and ``ranges`` cases; JAX is
imported only by the parity cases.
"""

import ast
import os
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from opendht_tpu_torch.tools import graftlint as gl
from opendht_tpu_torch.tools import graftlint_ranges as gr

ROOT = str(Path(__file__).resolve().parent.parent)
JAX_TESTS = Path(__file__).resolve().parent / "test_graftlint.py"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lint(src, path=f"{gl.PKG}/models/fix.py", **kw):
    return gl.lint_sources({path: textwrap.dedent(src)}, **kw)


def _rules(fs):
    return [f.rule for f in fs]


# ---------------------------------------------------------------------------
# plane ast: fixtures that fire, and their clean twins
# ---------------------------------------------------------------------------

CAPTURE_TMPL = """
import time
import numpy as np
import torch

def helper(x, cfg: int):
    {body}

def capture(g, x):
    with torch.cuda.graph(g):
        y = helper(x, 3)
    return y
"""

CAPTURED_CASES = [
    ("np.sum(x)", "host-call-in-jit"),
    ("return time.perf_counter()", "host-call-in-jit"),
    ("return torch.as_tensor(cfg, device='cuda') + x", "host-call-in-jit"),
    ("return x.item()", "tracer-coercion"),
    ("return int(x.sum())", "tracer-coercion"),
    ("return x.tolist()", "tracer-coercion"),
]

CAPTURED_CLEAN = [
    "return x + int(cfg)",
    "return torch.zeros(x.shape[0], device=x.device)",
    "return torch.where(x > 0, x, cfg)",
]


@pytest.mark.parametrize("body,rule", CAPTURED_CASES)
def test_captured_context_rules_fire(body, rule):
    fs = _lint(CAPTURE_TMPL.format(body=body), sync_loops=False)
    assert _rules(fs) == [rule], fs


@pytest.mark.parametrize("body", CAPTURED_CLEAN)
def test_captured_context_clean(body):
    assert _lint(CAPTURE_TMPL.format(body=body), sync_loops=False) == []


def test_uncaptured_function_not_linted_as_captured():
    src = CAPTURE_TMPL.format(body="return x.item()").replace(
        "with torch.cuda.graph(g):", "if g:")
    assert _lint(src, sync_loops=False) == []


def test_host_copy_inside_a_captured_callee():
    """The PR 10 fault: a host scalar copied to the card inside a
    function a capture reaches through another function."""
    fs = _lint("""
        import torch

        def inner(st, n_new):
            return st + torch.as_tensor(n_new, device="cuda")

        def outer(st, n_new):
            return inner(st, n_new)

        class Engine:
            def _graph(self, st):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    out = outer(st, 3)
                return out
    """, sync_loops=False)
    assert _rules(fs) == ["host-call-in-jit"]
    assert fs[0].line == 5


SYNC_SRC = """
import torch

def _pending(st):
    return int((~st.done).sum())

def run(st, n):
    for _ in range(n):
        {loop}
    return st
"""


@pytest.mark.parametrize("loop,hit", [
    ("st.done.tolist()", True),
    ("torch.cuda.synchronize()", True),
    ("bool(torch.any(st.done))", True),
    ("_pending(st)", True),          # a helper's readback, followed
    ("st = st + 1", False),
    ("n = len(st)", False),
])
def test_sync_in_loop(loop, hit):
    fs = _lint(SYNC_SRC.format(loop=loop))
    assert _rules(fs) == (["sync-in-loop"] if hit else []), fs


def test_sync_in_loop_interprocedural_anchors_at_the_call():
    """The burst loop's shape: a helper's ``.tolist()`` called in the
    loop is found at the loop's call site, two calls deep."""
    fs = _lint("""
        import torch

        def _read(st):
            p, w = torch.stack([st.a, st.b]).tolist()
            return p, w

        def _pending_and_wneed(st, cfg):
            return _read(st)

        def loop(st, cfg):
            while True:
                p, w = _pending_and_wneed(st, cfg)
                if p == 0:
                    break
    """)
    assert _rules(fs) == ["sync-in-loop"]
    assert fs[0].line == 13 and ".tolist()" in fs[0].msg


@pytest.mark.parametrize("test,hit", [
    ("not bool(st.done.all())", True),          # a local NamedTuple's field
    ("int(st.hops.max()) < 9", True),
    ("not bool(self.flags.all())", False),      # an object's attribute
    ("not bool(h.all())", False),               # a numpy array
])
def test_sync_in_loop_local_fields(test, hit):
    fs = _lint(f"""
        import numpy as np

        class Loop:
            def run(self, step, st0):
                st = step(st0)
                h = np.zeros(3, bool)
                while {test}:
                    st = step(st)
    """)
    assert _rules(fs) == (["sync-in-loop"] if hit else []), fs


def test_declared_readback_does_not_propagate():
    """A pragma'd per-burst readback is declared once: the callers of
    the loop's function are not flagged again."""
    fs = _lint("""
        import torch

        def burst_loop(st):
            while True:
                # graftlint: disable=sync-in-loop (one readback a burst)
                if bool(st.done.all()):
                    break
            return st

        def sweep(sts):
            for st in sts:
                burst_loop(st)
    """)
    assert fs == []


def test_sync_outside_engine_modules_ignored():
    src = SYNC_SRC.format(loop="st.done.tolist()")
    assert _lint(src, path=f"{gl.PKG}/tools/x.py") == []


LEDGER_SRC = """
_PKG = "pkg"
ENTRY_POINTS: tuple = (
    (f"{_PKG}.mod", "insert", (0,)),
    (f"{_PKG}.mod", "probe", ()),
)
"""

MOD_SRC = """
import torch

def insert(store, rows, vals):
    store[rows] = vals
    return store

def probe(store, rows):
    return store[rows]

def user(store, rows, vals):
    {body}
"""


def _registry_lint(mod_src, ledger=LEDGER_SRC):
    return gl.lint_sources({"pkg/mod.py": textwrap.dedent(mod_src),
                            "pkg/ledger.py": textwrap.dedent(ledger)},
                           ledger_src=textwrap.dedent(ledger),
                           ledger_path="pkg/ledger.py", sync_loops=False)


def test_donated_reuse_fires_and_rebinding_is_clean():
    bad = _registry_lint(MOD_SRC.format(
        body="insert(store, rows, vals)\n    return probe(store, rows)"))
    assert _rules(bad) == ["donated-reuse"]
    good = _registry_lint(MOD_SRC.format(
        body="store = insert(store, rows, vals)\n"
             "    return probe(store, rows)"))
    assert good == []


def test_registry_drift_cases():
    ok = MOD_SRC.format(body="return 0")
    assert _registry_lint(ok) == []
    # an unlisted in-place write (through a helper)
    fs = _registry_lint(ok.replace(
        "    return store[rows]",
        "    store.index_put_((rows,), rows)\n    return store"))
    assert _rules(fs) == ["registry-drift"]
    assert "writes parameter 0" in fs[0].msg
    # a listed write the function never makes
    fs = _registry_lint(ok.replace("    store[rows] = vals\n", ""))
    assert _rules(fs) == ["registry-drift"]
    assert "never writes" in fs[0].msg
    # a row naming no function
    fs = _registry_lint(ok, LEDGER_SRC.replace('"probe"', '"gone"'))
    assert _rules(fs) == ["registry-drift"]
    assert "no function" in fs[0].msg


def test_registry_parses_the_port_ledger():
    rows = gl.parse_entry_points(
        Path(ROOT, gl.LEDGER_PATH).read_text())
    from opendht_tpu_torch.obs.ledger import ENTRY_POINTS, entry_row
    assert rows == [entry_row(r) for r in ENTRY_POINTS]
    assert ("opendht_tpu_torch.serve" not in {r[0] for r in rows})


KEY_SRC = """
import functools

class Engine:
    def __init__(self):
        self.graphs = {{}}

    def _graph(self, use_cache, rounds, expire):
        key = (use_cache, rounds, expire)
        if key in self.graphs:
            return self.graphs[key]
        self.graphs[key] = 1
        return 1

    def macro_step(self, st, rounds=2, expire=True):
        return self._graph(False, rounds, expire)

@functools.lru_cache(maxsize=None)
def table(widths):
    return widths

def use(eng):
    {body}
"""


@pytest.mark.parametrize("body,hit", [
    ("return eng.macro_step(0, rounds=[2])", True),
    ("return eng.macro_step(0, 2, {True})", True),
    ("return table([1, 2])", True),
    ("return eng.macro_step(0, rounds=2)", False),
    ("return table((1, 2))", False),
])
def test_unhashable_static(body, hit):
    fs = _lint(KEY_SRC.format(body=body), sync_loops=False)
    assert _rules(fs) == (["unhashable-static"] if hit else []), fs


# ---------------------------------------------------------------------------
# pragmas, the summary, the CLI
# ---------------------------------------------------------------------------

def test_pragma_grammar():
    src = ("import torch\n"
           "def f(st):\n"
           "    for _ in range(3):\n"
           "        # graftlint: disable=sync-in-loop (one a burst)\n"
           "        st.done.tolist()\n"
           "        # graftlint: disable=sync-in-loop\n"
           "        st.done.tolist()\n")
    fs = gl.lint_sources({f"{gl.PKG}/models/p.py": src})
    assert sorted(_rules(fs)) == ["bad-pragma", "sync-in-loop"]
    bad = gl.parse_pragmas("# graftlint: disable=nope (x)\n", "p.py")[1]
    assert _rules(bad) == ["bad-pragma"] and "nope" in bad[0].msg


def test_list_rules_and_exit_codes(capsys):
    assert gl.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in gl.RULES:
        assert rule in out
    assert gl.main(["--plane", "lock", "--root", ROOT]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("graftlint summary: lock=0 pragmas=0")
    assert gl.Finding("a.py", 3, 7, "f64-leak", "x").render() == \
        "a.py:3:7: f64-leak: x"


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    return gl._read_tree(ROOT)


@pytest.fixture(scope="module")
def ast_raw(tree):
    raw = []
    fs = gl.run_plane_ast(ROOT, raw_sink=raw, srcs=tree)
    return fs, raw


def test_tree_clean_on_ast_lock_and_pragmas(tree, ast_raw):
    fs, raw = ast_raw
    assert fs == [], [f.render() for f in fs]
    lock_fs, inv = gl.run_plane_lock(ROOT, raw_sink=raw, srcs=tree)
    assert lock_fs == []
    assert inv["classes"] >= 5
    stale, n = gl.run_stale_pragmas(ROOT, raw, {"ast", "lock"}, srcs=tree)
    assert stale == [] and n >= 8


def test_jax_pragma_sites_have_counterparts(tree):
    """JAX's eight sync-in-loop pragma sites each have one in the port:
    the burst loops, the resident drain, the sharded ladder, the
    ledger's timing pass."""
    want = {f"{gl.PKG}/models/swarm.py": 2, f"{gl.PKG}/models/serve.py": 2,
            f"{gl.PKG}/parallel/sharded.py": 1, f"{gl.PKG}/obs/ledger.py": 3}
    for path, n in want.items():
        pr, bad = gl.parse_pragmas(tree[path], path)
        assert bad == []
        assert sum("sync-in-loop" in r for r in pr.values()) >= n, path


def test_mutation_stale_pragma_caught(tree, ast_raw):
    _fs, raw = ast_raw
    path = f"{gl.PKG}/models/monitor.py"
    lines = tree[path].rstrip("\n").split("\n")
    lines.append("# graftlint: disable=sync-in-loop (nothing here)")
    srcs = dict(tree)
    srcs[path] = "\n".join(lines) + "\n"
    assert gl.check_stale_pragmas(raw, {"sync-in-loop"}, tree) == []
    stale = gl.check_stale_pragmas(raw, {"sync-in-loop"}, srcs)
    assert [(f.path, f.line) for f in stale] == [(path, len(lines))]


# ---------------------------------------------------------------------------
# lower / ranges / strict on the canonical workload (the CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run():
    return gl.recorded_run(ROOT, "cpu", ranges=True)


def test_lower_clean_and_every_row_called(run):
    src = Path(ROOT, gl.LEDGER_PATH).read_text()
    fs = gl.suppress_by_source(ROOT, gl.lower_findings(run, src))
    assert fs == [], [f.render() for f in fs]
    rows = gl.parse_entry_points(src)
    for mod, attr, donate, _b in rows:
        name = gl._entry_name(mod, attr)
        if name in gl.CARD_ONLY:
            continue
        assert run.lint.calls.get(name, 0) > 0, name
        # every declared in-place write was seen to move _version
        assert set(donate) <= run.lint.moved.get(name, set()), name


def test_ranges_clean(run):
    fs = gl.suppress_by_source(ROOT, run.ranges)
    assert fs == [], [f.render() for f in fs]
    st = run.range_stats
    assert st["entries"] >= 40 and st["casts_proven"] > 20


def test_strict_cpu_clean():
    fs, st = gl.run_plane_strict(ROOT, "cpu")
    assert fs == [] and st["device"] == "cpu"


def test_budget_cpu_nothing_built(run):
    fs, table = gr.run_plane_budget(ROOT, "cpu")
    assert fs == []
    assert table["serve._resident_replay"]["budget"] == 1
    assert all(v["measured"] == 0 for v in table.values())


# ---------------------------------------------------------------------------
# the runtime rules, on fixtures and on seeded mutations of the real code
# ---------------------------------------------------------------------------

def _observe(hook_cls, *hook_args, entry="swarm.lookup_step"):
    stack = [entry]
    hook = hook_cls(ROOT, *hook_args) if hook_args else \
        hook_cls(ROOT, stack)
    return hook, gl._make_observer_mode()([hook]), stack


def test_lower_hook_rules():
    hook, mode, stack = _observe(gl.LowerHook)
    x = torch.arange(6)
    with mode:
        (x + 1).to(torch.int32)                         # clean
        assert hook.findings == []
        x.to(torch.float64)                             # f64
        int(x.sum())                                    # a readback
    assert sorted(_rules(hook.findings)) == ["f64-leak", "host-callback"]
    stack[:] = ["swarm._finalize"]                      # not a round loop
    hook.findings.clear()
    hook._seen.clear()
    with mode:
        int(x.sum())
    assert hook.findings == []


def _cpu_swarm(n=512):
    from opendht_tpu_torch.models import swarm as sw
    cfg = sw.SwarmConfig.for_nodes(n, device="cpu")
    swarm = sw.build_swarm(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    tg = torch.randint(0, 2**32, (64, 5),
                       generator=torch.Generator().manual_seed(2))
    return sw, cfg, swarm, tg


def _observed(fn):
    """Run ``fn`` under a fresh lint ledger and lower hook → (lint, hook)."""
    lint = gl.LintLedger("cpu")
    hook = gl.LowerHook(ROOT, lint.stack)
    with lint.instrument(), gl._make_observer_mode()([hook]):
        fn()
    return lint, hook


def test_mutation_float64_in_lookup_step(monkeypatch):
    """A copy of ``lookup_step`` that makes a float64 tensor: f64-leak,
    anchored in the copy."""
    sw, cfg, swarm, tg = _cpu_swarm()
    real = sw.lookup_step

    def lookup_step(swarm, cfg, st, merge_w=None, *, rnd=None):
        st.dist.to(torch.float64)
        return real(swarm, cfg, st, merge_w, rnd=rnd)

    monkeypatch.setattr(sw, "lookup_step", lookup_step)
    _lint, hook = _observed(lambda: sw.lookup(
        swarm, cfg, tg, torch.Generator().manual_seed(3), device="cpu"))
    assert "f64-leak" in _rules(hook.findings)
    f = [f for f in hook.findings if f.rule == "f64-leak"][0]
    assert "swarm.lookup_step" in f.msg and f.path.startswith(gl.PKG)


def test_mutation_dropped_in_place_write(monkeypatch):
    """``_store_insert`` writing a copy of its store: the declared
    overwrite of argument 0 never moves its ``_version``."""
    from opendht_tpu_torch.models import storage as stg
    real = stg._store_insert

    def _store_insert(store, *a, **k):
        return real(type(store)(*[t.clone() for t in store]), *a, **k)

    monkeypatch.setattr(stg, "_store_insert", _store_insert)
    scfg = stg.StoreConfig(slots=4, listen_slots=2, max_listeners=16,
                           payload_words=2)
    store = stg.empty_store(64, scfg, device="cpu")
    m = 8
    z = torch.zeros((m,), dtype=torch.int64)
    lint, _hook = _observed(lambda: stg._store_insert(
        store, scfg, torch.arange(m), torch.zeros((m, 5), dtype=torch.int64),
        z + 1, z + 1, torch.arange(m), 0, z + 1, z,
        torch.zeros((m, 2), dtype=torch.int64)))
    run = gl.LintRun("cpu", lint, [], [], {}, [], 0.0)
    src = Path(ROOT, gl.LEDGER_PATH).read_text()
    fs = [f for f in gl.lower_findings(run, src)
          if "_store_insert" in f.msg]
    assert _rules(fs) == ["donation-drop"]
    assert not [f for f in gl.lower_findings(run, src)
                if f.rule == "registry-drift"]


def test_unexercised_and_undeclared_writes():
    lint = gl.LintLedger("cpu")
    lint.calls["swarm.lookup_step"] = 1
    lint.moved["swarm.lookup_step"] = {2}
    run = gl.LintRun("cpu", lint, [], [], {}, [], 0.0)
    fs = gl.lower_findings(run, Path(ROOT, gl.LEDGER_PATH).read_text())
    by = {}
    for f in fs:
        by.setdefault(f.rule, []).append(f.msg)
    assert any("swarm.lookup_step" in m and "argument 2" in m
               for m in by["registry-drift"])
    assert any("swarm.lookup_init" in m for m in by["unexercised-entry"])
    assert not any("serve._resident_replay" in m
                   for m in by["unexercised-entry"])       # card only


class _FakeLint:
    def __init__(self):
        self.on_enter, self.on_exit = [], []


def _ranges(fn, args):
    lint = _FakeLint()
    hook = gr.RangeHook(ROOT, lint)
    with gl._make_observer_mode()([hook]):
        hook._enter("fixture.entry", fn, args, {})
        fn(*args)
        hook._exit("fixture.entry")
    return hook


def test_ranges_uint8_accumulate_over_256_rows():
    def acc(rows):
        out = torch.zeros(4, dtype=torch.uint8)
        return out.index_add_(0, torch.zeros(rows, dtype=torch.int64),
                              torch.ones(rows, dtype=torch.uint8))
    bad = _ranges(lambda n: acc(256), (0,))
    assert _rules(bad.findings) == ["narrow-overflow"]
    assert "[0, 256]" in bad.findings[0].msg
    good = _ranges(lambda n: acc(255), (0,))
    assert good.findings == [] and good.accums_proven == 1


def test_ranges_narrow_casts():
    x = torch.randint(0, 2**40, (8,))
    assert _rules(_ranges(lambda t: t.to(torch.int32), (x,)).findings) == \
        ["narrow-cast-unproven"]
    ok = _ranges(lambda t: (t & 0xFFFF).to(torch.int32), (x,))
    assert ok.findings == [] and ok.casts_proven == 1
    ok = _ranges(lambda t: ((t >> 40) & 0xFF).to(torch.uint8), (x,))
    assert ok.findings == []
    bad = _ranges(lambda t: (t >> 40).to(torch.uint8), (x,))   # negatives
    assert _rules(bad.findings) == ["narrow-cast-unproven"]
    idx = _ranges(lambda t: torch.argsort(t).to(torch.int32), (x,))
    assert idx.findings == []


def test_strict_hook_rank_promotion_and_nan():
    hook = gl.StrictHook(ROOT)
    mode = gl._make_observer_mode()([hook])
    hook.active = True
    with mode:
        torch.ones(3, 4) + torch.ones(1, 4)
        torch.ones(3, 4) + 1.0
        assert hook.findings == []
        torch.ones(3, 4) + torch.ones(4)
        torch.zeros(2) / torch.zeros(2)
    msgs = [f.msg for f in hook.findings]
    assert _rules(hook.findings) == ["strict-replay"] * 2
    assert "rank promotion" in msgs[0] and "NaN" in msgs[1]


def test_strict_sync_judge():
    """The card's sync contract on recorded stacks: a sync through a
    declared site within its count is clean; an extra one, or one in a
    loop through no declared site, is a finding; one outside loops is a
    one-off."""
    m = f"{gl.PKG}/models/swarm.py"
    site = gl.SyncSite(m, 100, 101, 99)
    loops = {m: [(90, 120)], f"{gl.PKG}/models/serve.py": [(10, 20)]}
    ev_site = [(m, 500), (m, 100)]
    fs, by, one = gl.judge_syncs([ev_site, ev_site], [site], {site: 2},
                                 loops)
    assert fs == [] and by == {f"{m}:100": 2} and one == 0
    fs, _by, _ = gl.judge_syncs([ev_site] * 3, [site], {site: 2}, loops)
    assert _rules(fs) == ["strict-replay"] and "3 times" in fs[0].msg
    fs, _by, _ = gl.judge_syncs(
        [[(f"{gl.PKG}/models/serve.py", 15)]], [site], {site: 0}, loops)
    assert _rules(fs) == ["strict-replay"]
    fs, _by, one = gl.judge_syncs([[(m, 300)]], [site], {site: 0}, loops)
    assert fs == [] and one == 1


def test_sync_recorder_counts_site_runs(tree, monkeypatch):
    """The card's run counts, here without a card: each run of the
    compacted burst loop's declared readback statement is counted once
    (it spans one line), as many times as the helper is called."""
    sw, cfg, swarm, tg = _cpu_swarm()
    srcs = {p: s for p, s in tree.items() if p.startswith(gl.PKG + "/")}
    sites = [s for s in gl.declared_sync_sites(srcs)
             if s.path.endswith("models/swarm.py") and "_pending_and_wneed"
             in srcs[s.path].split("\n")[s.first - 1]]
    calls = []
    real = sw._pending_and_wneed
    monkeypatch.setattr(sw, "_pending_and_wneed",
                        lambda *a: calls.append(1) or real(*a))
    rec = gl.SyncRecorder(ROOT, sites)
    with rec.record():
        sw.lookup(swarm, cfg, tg, torch.Generator().manual_seed(3),
                  device="cpu")
    assert calls and rec.runs[sites[0]] == len(calls)
    assert rec.events == []                     # the CPU syncs nothing


def test_declared_sites_of_the_tree(tree):
    srcs = {p: s for p, s in tree.items() if p.startswith(gl.PKG + "/")}
    sites = gl.declared_sync_sites(srcs)
    lines = {(s.path, s.first) for s in sites}
    swarm = srcs[f"{gl.PKG}/models/swarm.py"].split("\n")
    loop = [s for s in sites if s.path.endswith("models/swarm.py") and
            "_pending_and_wneed" in swarm[s.first - 1]]
    assert loop and len(lines) >= 30


def test_budget_check(monkeypatch):
    from opendht_tpu_torch.models import serve
    from opendht_tpu_torch.ops import kernels
    monkeypatch.setattr(kernels, "BUILDS", {"merge_round": 2})
    monkeypatch.setattr(serve, "GRAPH_KEYS", {(0, (False, 2, True)): 1})
    rows = gl.parse_entry_points(Path(ROOT, gl.LEDGER_PATH).read_text())
    table = gr.measure_budgets(rows)
    fs = gr.check_budgets({k: v["measured"] for k, v in table.items()},
                          {k: v["budget"] for k, v in table.items()})
    names = sorted(f.msg.split(":")[0] for f in fs)
    assert "serve._resident_replay" not in names
    assert "swarm.lookup_step" in names and all(
        f.rule == "specialization-budget" for f in fs)


# ---------------------------------------------------------------------------
# parity with JAX's graftlint (lock plane, pragmas, stale pragmas)
# ---------------------------------------------------------------------------

def _jax_fixture_sources():
    """The source strings of test_graftlint.py's lock and pragma
    fixtures: the arguments of its ``_lock_scan`` / ``_lint`` calls in
    the lock and pragma classes, ``parse_pragmas`` strings, and the
    module-level ``CYCLE_SRC``."""
    tree = ast.parse(JAX_TESTS.read_text())
    lock, pragma = [], []
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            consts[node.targets[0].id] = node.value.value
        if not isinstance(node, ast.ClassDef):
            continue
        for call in ast.walk(node):
            if not (isinstance(call, ast.Call) and call.args and
                    isinstance(call.args[0], ast.Constant) and
                    isinstance(call.args[0].value, str)):
                continue
            fname = getattr(call.func, "id", None)
            src = textwrap.dedent(call.args[0].value)
            if node.name.startswith("TestLock") and \
                    fname in ("_lock_scan", "_lint"):
                lock.append(src)
            elif node.name == "TestPragmas" and \
                    fname in ("_lint", "parse_pragmas"):
                pragma.append(src)
    cycle = textwrap.dedent(consts["CYCLE_SRC"])
    lock += [cycle, cycle.replace("self.peer.alpha_locked()", "pass")]
    return lock, pragma


def _key(fs):
    return [(f.rule, f.line, f.msg) for f in fs]


def test_parity_lock_fixtures():
    from opendht_tpu.tools import graftlint as jgl
    lock, _ = _jax_fixture_sources()
    assert len(lock) >= 14
    for src in lock:
        fj, ij = jgl.lock_lint_sources({"fixture.py": src})
        ft, it = gl.lock_lint_sources({"fixture.py": src})
        assert _key(fj) == _key(ft), src
        assert {k: ij[k] for k in ij} == {k: it[k] for k in ij}, src


def test_parity_pragma_fixtures():
    from opendht_tpu.tools import graftlint as jgl
    _, pragma = _jax_fixture_sources()
    assert len(pragma) >= 4
    extra = ["# graftlint: disable=sync-in-loop,f64-leak (both)\n",
             "#graftlint:disable=lock-order(x)\n",
             "# graftlint: disable=sync-in-loop ()\n",
             "x = 1  # graftlint: enable=all\n"]
    for src in pragma + extra:
        pj, bj = jgl.parse_pragmas(src, "p.py")
        pt, bt = gl.parse_pragmas(src, "p.py")
        assert pj == pt and _key(bj) == _key(bt), src
    assert set(jgl.RULES) == set(gl.RULES)
    assert jgl.PLANE_RULES["lock"] == gl.PLANE_RULES["lock"]
    assert jgl.PLANE_RULES["ranges"] == gl.PLANE_RULES["ranges"]


def test_parity_stale_pragma_fixtures():
    from opendht_tpu.tools import graftlint as jgl
    src = ("import jax\n"
           "# graftlint: disable=sync-in-loop (amortized readback)\n"
           "x = 1\n")
    narrow = ("# graftlint: disable=narrow-cast-unproven (bounded)\n"
              "x = 1\n")
    cases = [
        ([jgl.Finding("m.py", 3, 0, "sync-in-loop", "s")], src),
        ([jgl.Finding("m.py", 2, 0, "sync-in-loop", "s")], src),
        ([], src),
        ([], narrow),
        ([jgl.Finding("m.py", 40, 0, "sync-in-loop", "s")], src),
    ]
    for raw, s in cases:
        fj = jgl.check_stale_pragmas(raw, {"sync-in-loop"}, {"m.py": s})
        ft = gl.check_stale_pragmas([gl.Finding(*f) for f in raw],
                                    {"sync-in-loop"}, {"m.py": s})
        assert _key(fj) == _key(ft)
    kept = gl.apply_pragmas([gl.Finding("m.py", 2, 0, "stale-pragma", "d")],
                            {2: {"stale-pragma"}})
    assert len(kept) == 1


def test_parity_lock_inventory_of_the_trees():
    """The port's lock-owning classes, locks and guarded attributes are
    JAX's on JAX's tree (the port copies the host modules)."""
    from opendht_tpu.tools import graftlint as jgl
    fj, ij = jgl.run_plane_lock(ROOT)
    ft, it = gl.run_plane_lock(ROOT)
    assert fj == [] and ft == []
    for k in ("classes", "locks", "guarded_attrs", "class_names"):
        assert ij[k] == it[k], k
    jsrcs = {p: s for p, s in jgl._read_tree(ROOT).items()
             if p.startswith("opendht_tpu/")}
    _, jdetail = gl.lock_lint_sources(jsrcs)
    assert jdetail["detail"] == it["detail"]


def test_u32_table_matches_jax_dtypes():
    """Every field of the u32 table is uint32 in the JAX counterpart
    that convert.py carries across, and every uint32 field of those
    JAX NamedTuples is in the table."""
    import jax
    import jax.numpy as jnp

    from opendht_tpu.models import serve as js
    from opendht_tpu.models import storage as jst
    from opendht_tpu.models import swarm as jsw

    cfg = jsw.SwarmConfig.for_nodes(256)
    scfg = jst.StoreConfig(slots=2, listen_slots=1, max_listeners=4,
                           payload_words=2)
    shapes = {
        "Swarm": jax.eval_shape(
            lambda: jsw.build_swarm(jax.random.PRNGKey(0), cfg)),
        "LookupState": jax.eval_shape(
            lambda: js.empty_serve_state(cfg, 8)),
        "SwarmStore": jax.eval_shape(
            lambda: jst.empty_store(cfg.n_nodes, scfg)),
        "ResultCache": jax.eval_shape(
            lambda: js.empty_result_cache(cfg, 8)),
        "ServeRings": jax.eval_shape(
            lambda: js.empty_serve_rings(8, 16)),
    }
    assert set(shapes) == set(gr.U32_FIELDS)
    for cls, tup in shapes.items():
        assert type(tup).__name__ == cls
        u32 = {f for f, v in zip(tup._fields, tup)
               if v is not None and v.dtype == jnp.uint32}
        assert u32 == set(gr.U32_FIELDS[cls]), cls


def test_u32_params_name_real_parameters():
    import inspect
    import importlib
    rows = {gl._entry_name(m, a): (m, a) for m, a, _d, _b in
            gl.parse_entry_points(Path(ROOT, gl.LEDGER_PATH).read_text())}
    for entry, params in gr.U32_PARAMS.items():
        mod, attr = rows[entry]
        fn = getattr(importlib.import_module(mod), attr)
        names = set(inspect.signature(fn).parameters)
        assert set(params) <= names, (entry, set(params) - names)


def test_graftlint_imports_no_torch_at_module_level():
    for name in ("graftlint.py", "graftlint_ranges.py"):
        tree = ast.parse(Path(ROOT, gl.PKG, "tools", name).read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                      ast.ImportFrom))]
        mods = {a.name.split(".")[0] for n in top for a in n.names
                if isinstance(n, ast.Import)} | {
            (n.module or "").split(".")[0] for n in top
            if isinstance(n, ast.ImportFrom) and not n.level}
        assert "torch" not in mods and "opendht_tpu" not in mods


def test_numpy_readback_not_a_sync():
    fs = _lint("""
        import numpy as np

        def f(a: np.ndarray, n):
            h = np.asarray(a)
            for i in range(n):
                h[i].tolist()
                a.tolist()
    """)
    assert fs == []
    assert os.path.basename(__file__).startswith("test_torch_")
    assert np.uint32 is not None
