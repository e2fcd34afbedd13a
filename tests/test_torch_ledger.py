"""The port's cost ledger against the JAX package's.

* The ledger is a pure observer: plain, traced (with its trace) and
  chaos (with its strikes) lookups are bit-identical with it on or off,
  and every patched attribute — aliases in importing modules included —
  is restored after the block, also when the block raises.
* A wrapped call inside a wrapped call is recorded once, in the outer
  row (JAX inlines it into the outer program).
* On one call sequence (a lookup, an announce, a get on the 512-node
  swarm, JAX's origins handed across) the rows both tables have carry
  the same names and calls (the port's ``swarm.lookup_step`` is JAX's
  ``swarm._lookup_step_d``).
* ``measure_round_phases``: JAX's phase names, telescoping rows, the
  full prefix equal to ``lookup_step`` (augmented, plain and fused-round
  tables, and the laddered table of the CPU's rank merge).
* The port's artifact passes ``check_ledger_obj``, JAX's and the
  port's; the corrupted artifacts of ``tests/test_ledger.py`` fail both;
  ``export_metrics`` renders JAX's gauge names.  ``CostLedger()`` and
  ``hbm_watermark()`` raise where there is no card.
* The memory plane's peak is at least its live figure and tracks the
  largest sample; nothing is built or captured across a replay.
"""

import copy
import functools
import importlib
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import storage as jst
from opendht_tpu.models import swarm as jsw
from opendht_tpu.obs import ledger as jled
from opendht_tpu.utils import metrics as jmet
from opendht_tpu_torch.models import storage as tst
from opendht_tpu_torch.models import swarm as tsw
from opendht_tpu_torch.obs import ledger as tled
from opendht_tpu_torch.utils import metrics as tmet

from torch_port_cases import jax_origins, jax_swarm, port_cfg, port_swarm

P = 32                  # every JAX batch in this file: one compile each


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    sw, cfg = jax_swarm()
    return sw, cfg, port_swarm(sw), port_cfg(cfg)


def _targets(seed, n=P):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(0, 2**32, (n, 5), dtype=np.int64))


def _equal(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# a pure observer
# ---------------------------------------------------------------------------

def test_results_bit_identical_with_ledger_on(world):
    _sw, _cfg, s, cfg = world
    tg = _targets(1, 256)
    g = lambda: torch.Generator().manual_seed(2)        # noqa: E731
    r0 = tsw.lookup(s, cfg, tg, g(), device="cpu")
    t0 = tsw.traced_lookup(s, cfg, tg, g(), device="cpu")
    bz = tsw.corrupt_swarm(s, torch.Generator().manual_seed(3), 0.1, cfg)
    f = tsw.LookupFaults(drop_frac=0.15, seed=6)
    c0 = tsw.chaos_lookup(bz, cfg, tg, g(), f, collect_trace=True,
                          device="cpu")
    led = tled.CostLedger(device="cpu")
    with led.instrument(barrier=True):
        r1 = tsw.lookup(s, cfg, tg, g(), device="cpu")
        t1 = tsw.traced_lookup(s, cfg, tg, g(), device="cpu")
        c1 = tsw.chaos_lookup(bz, cfg, tg, g(), f, collect_trace=True,
                              device="cpu")
    assert _equal(r0, r1)
    assert _equal(t0[0], t1[0]) and _equal(t0[1], t1[1])
    assert _equal(c0[0], c1[0]) and torch.equal(c0[1], c1[1])
    assert _equal(c0[2], c1[2])
    calls = {k: r["calls"] for k, r in led.kernels.items() if r["calls"]}
    # Every engine reached its rows, through the aliases too (the
    # compaction ladder runs at 256 rows).
    for name in ("swarm.lookup_init", "swarm.lookup_step",
                 "swarm.traced_lookup_step", "swarm.chaos_lookup_init",
                 "swarm.chaos_lookup_step", "swarm._compact_slice",
                 "swarm._writeback_prefix", "swarm._finalize_scattered"):
        assert calls.get(name, 0) > 0, (name, calls)
    assert calls["swarm.lookup_init"] == 2      # chaos_lookup_init's is inner


def test_entry_points_restored_after_the_block(world):
    def snapshot():
        out = {}
        for row in tled.ENTRY_POINTS:
            mod = importlib.import_module(row[0])
            out[(row[0], row[1])] = getattr(mod, row[1])
        for m in tled._port_modules():
            for name, val in vars(m).items():
                if callable(val) and (name.startswith("_") or "lookup" in
                                      name):
                    out[(m.__name__, name)] = val
        return out
    before = snapshot()
    from opendht_tpu_torch.parallel import sharded
    led = tled.CostLedger(device="cpu")
    with pytest.raises(RuntimeError, match="inside"):
        with led.instrument():
            assert getattr(tsw.lookup_step, "_ledger_wrapper", False)
            # An alias imported by name is patched too.
            assert sharded._finalize is not before[
                ("opendht_tpu_torch.parallel.sharded", "_finalize")]
            raise RuntimeError("raised inside the block")
    after = snapshot()
    assert after.keys() == before.keys()
    for k, fn in before.items():
        assert after[k] is fn, k


def test_nested_calls_recorded_once(world):
    _sw, _cfg, s, cfg = world
    scfg = tst.StoreConfig(slots=4, listen_slots=1, max_listeners=16)
    store = tst.empty_store(cfg.n_nodes, scfg, "cpu")
    keys = _targets(4)
    led = tled.CostLedger(device="cpu")
    with led.instrument():
        store, _ = tst.announce(s, cfg, store, scfg, keys,
                                torch.arange(P) + 1,
                                torch.ones(P, dtype=torch.int64), 0,
                                torch.Generator().manual_seed(5),
                                device="cpu")
    calls = {k: r["calls"] for k, r in led.kernels.items() if r["calls"]}
    # _announce_insert runs _store_insert inside it: one row, the outer.
    assert calls["storage._announce_insert"] == 1
    assert "storage._store_insert" not in calls
    with led.instrument():
        tst._store_insert(store, scfg, torch.zeros(1, dtype=torch.int64),
                          keys[:1], torch.ones(1, dtype=torch.int64),
                          torch.ones(1, dtype=torch.int64),
                          torch.zeros(1, dtype=torch.int64), 1)
    assert led.kernels["storage._store_insert"]["calls"] == 1
    assert led.kernels["storage._store_insert"]["donate_argnums"] == (0,)


def test_rows_match_jax_on_one_call_sequence(world):
    """A lookup, an announce and a get: the rows both ledgers have carry
    the same calls."""
    sw, cfg, s, cfg_t = world
    keys = np.asarray(_targets(6))
    scfg_j = jst.StoreConfig(slots=4, listen_slots=1, max_listeners=16)
    scfg_t = tst.StoreConfig(*scfg_j)
    ks = [jax.random.PRNGKey(i) for i in (11, 12, 13)]
    lj = jled.CostLedger()
    with lj.instrument():
        jsw.lookup(sw, cfg, jnp.asarray(keys, jnp.uint32), ks[0])
        store, _ = jst.announce(
            sw, cfg, jst.empty_store(cfg.n_nodes, scfg_j), scfg_j,
            jnp.asarray(keys, jnp.uint32), jnp.arange(P, dtype=jnp.uint32),
            jnp.ones(P, jnp.uint32), 0, ks[1])
        jst.get_values(sw, cfg, store, scfg_j, jnp.asarray(keys, jnp.uint32),
                       ks[2])
    lt = tled.CostLedger(device="cpu")
    tk = torch.from_numpy(keys)
    with lt.instrument():
        tsw.lookup(s, cfg_t, tk, origins=jax_origins(sw, ks[0], P),
                   device="cpu")
        store_t, _ = tst.announce(
            s, cfg_t, tst.empty_store(cfg.n_nodes, scfg_t, "cpu"), scfg_t,
            tk, torch.arange(P), torch.ones(P, dtype=torch.int64), 0,
            origins=jax_origins(sw, ks[1], P), device="cpu")
        tst.get_values(s, cfg_t, store_t, scfg_t, tk,
                       origins=jax_origins(sw, ks[2], P), device="cpu")
    rows_j = {r["name"]: r for r in lj.to_dict()["kernels"]}
    rows_t = {r["name"]: r for r in lt.to_dict()["kernels"]}
    both = set(rows_j) & set(rows_t)
    assert {"swarm.lookup_init", "swarm._finalize_scattered",
            "storage._announce_insert", "storage._get_probe"} <= both
    for name in both:
        assert rows_j[name]["calls"] == rows_t[name]["calls"], name
        assert rows_j[name]["donated"] == rows_t[name]["donated"], name
    assert rows_j["swarm._lookup_step_d"]["calls"] == \
        rows_t["swarm.lookup_step"]["calls"]
    # Only JAX's donating specialisations and the port's own step row
    # lie outside the shared set.
    assert set(rows_j) - both == {"swarm._lookup_step_d"}
    assert set(rows_t) - both == {"swarm.lookup_step"}


# ---------------------------------------------------------------------------
# the phase plane
# ---------------------------------------------------------------------------

NAMES_AUG = ["alpha-select", "gather", "window-decode", "merge",
             "scatter-writeback"]
NAMES_PLAIN = ["alpha-select", "respond", "merge", "scatter-writeback"]


def _check_table(t, names, width):
    assert [r["phase"] for r in t["rows"]] == names
    s = sum(r["wall_s"] for r in t["rows"])
    assert abs(s - t["fused_round_wall_s"]) < 1e-6 * (len(names) + 1)
    assert all(r["wall_s"] >= 0 and r["flops"] is None
               and r["bytes_accessed"] is None for r in t["rows"])
    assert t["prefix_equivalent"] and t["lookup_step_wall_s"] > 0
    assert t["width"] == width


@pytest.fixture(params=["jax", "port"])
def ct(request):
    """The JAX package's artifact checker and the port's own copy."""
    if request.param == "jax":
        from opendht_tpu.tools import check_trace
    else:
        from opendht_tpu_torch.tools import check_trace
    return check_trace


@functools.lru_cache(maxsize=None)
def _phase_tables(form):
    """The swarm, targets and phase tables of one form (measured once for
    both checkers)."""
    cfg = tsw.SwarmConfig.for_nodes(1024, device="cpu",
                                    aug_tables=form != "plain",
                                    merge_impl=("fused-round"
                                                if form == "fused-round"
                                                else "auto"))
    s = tsw.build_swarm(cfg, torch.Generator().manual_seed(7), device="cpu")
    s = tsw.churn(s, torch.Generator().manual_seed(9), 0.2, cfg)
    tg = _targets(2, 256)
    t = tled.measure_round_phases(s, cfg, tg,
                                  torch.Generator().manual_seed(5),
                                  repeats=2)
    lad = None if form == "fused-round" else tled.measure_round_phases(
        s, cfg, tg, torch.Generator().manual_seed(5), repeats=2, merge_w=32,
        advance_rounds=3)
    return cfg, s, tg, t, lad


@pytest.mark.parametrize("form", ["aug", "plain", "fused-round"])
def test_round_phases_telescope_and_equal_the_round(form, ct):
    cfg, s, tg, t, lad = _phase_tables(form)
    t, lad = copy.deepcopy(t), copy.deepcopy(lad)
    _check_table(t, NAMES_PLAIN if form == "plain" else NAMES_AUG, 256)
    if form == "fused-round":
        with pytest.raises(ValueError, match="full width"):
            tled.measure_round_phases(s, cfg, tg, merge_w=32)
        return
    _check_table(lad, NAMES_PLAIN if form == "plain" else NAMES_AUG, 256)
    assert lad["merge_w"] == 32 and lad["advance_rounds"] == 3
    if form == "aug":
        led = tled.CostLedger(device="cpu")
        led.record_call("swarm.lookup_step", 0.01)
        led.round_phases, led.round_phases_laddered = t, lad
        led.attr_compile_count = 0
        obj = json.loads(json.dumps(led.to_dict(bench_row={
            "metric": "swarm_lookups_per_sec", "value": 1.0,
            "round_wall_p50": t["fused_round_wall_s"]})))
        assert ct.check_ledger_obj(obj) == []
        _rejects(obj, ct.check_ledger_obj)


def _rejects(base, check_ledger_obj):
    """``tests/test_ledger.py``'s corrupted artifacts, on the port's."""
    def bad(edit):
        obj = json.loads(json.dumps(base))
        edit(obj)
        return check_ledger_obj(obj)
    assert any("drift" in e for e in bad(lambda o: o["bench"].__setitem__(
        "round_wall_p50",
        10 * max(o["round_phases"]["fused_round_wall_s"], 1e-3))))
    assert any("flops" in e for e in bad(
        lambda o: o["round_phases"]["rows"][0].__setitem__("flops", -1.0)))
    assert any("peak_bytes" in e for e in bad(lambda o: o["hbm"].__setitem__(
        "peak_bytes", o["hbm"]["live_bytes"] - 1)))
    assert any("compile" in e for e in bad(
        lambda o: o.__setitem__("attr_compile_count", 2)))

    def nothing(o):
        del o["round_phases"]
        del o["round_phases_laddered"]
    assert any("nothing to gate" in e for e in bad(nothing))

    def no_target(o):
        nothing(o)
        o["repub_profile"] = {"rows": [{"phase": "lookup", "wall_s": 1.0}]}
    assert any("sweep_wall_s missing" in e for e in bad(no_target))
    assert any("merge_w" in e for e in bad(
        lambda o: o["round_phases_laddered"].pop("merge_w")))


# ---------------------------------------------------------------------------
# memory, compile count, Prometheus
# ---------------------------------------------------------------------------

def test_memory_plane_and_step_cache(world):
    _sw, _cfg, s, cfg = world
    wm = tled.hbm_watermark("cpu")
    assert wm["source"] == "live_tensors"
    assert wm["peak_bytes"] >= wm["live_bytes"] > 0
    led = tled.CostLedger(device="cpu")
    base = led.hbm()["peak_bytes"]
    big = torch.zeros(4 << 20, dtype=torch.int64)       # 32 MiB
    led.sample_hbm()
    del big
    led.sample_hbm()
    hbm = led.hbm()
    assert hbm["peak_bytes"] >= base + (32 << 20) > hbm["live_bytes"]
    n0 = tled.step_cache_size()
    tsw.lookup(s, cfg, _targets(8), device="cpu")
    assert tled.step_cache_size() - n0 == 0


def test_export_metrics_gauge_names_equal_jax(world):
    sw, cfg, s, cfg_t = world
    texts = []
    for mod, met, run in (
            (jled, jmet, lambda: jsw.lookup(
                sw, cfg, jnp.asarray(np.asarray(_targets(9)), jnp.uint32),
                jax.random.PRNGKey(2))),
            (tled, tmet, lambda: tsw.lookup(s, cfg_t, _targets(9),
                                            device="cpu"))):
        led = mod.CostLedger() if mod is jled else mod.CostLedger("cpu")
        with led.instrument():
            run()
        led.round_phases = {"rows": [{"phase": "merge", "wall_s": 0.5}]}
        led.repub_profile = {"rows": [{"phase": "lookup", "wall_s": 0.25}]}
        reg = met.MetricsRegistry()
        led.export_metrics(reg)
        led.export_metrics(reg)             # a second scrape adds nothing
        texts.append(reg.render_prometheus())
        n = sum(c for k, (_b, _s, c) in reg.get(
            "dht_ledger_invocation_seconds").snapshot())
        assert n == sum(r["calls"] for r in led.kernels.values())
    names = [sorted(line for line in t.splitlines()
                    if line.startswith("# ")) for t in texts]
    assert names[0] == names[1]
    assert 'dht_ledger_round_phase_wall_seconds{phase="merge"} 0.5' \
        in texts[1]
    assert 'kernel="swarm.lookup_step"' in texts[1]


@pytest.mark.parametrize("make", ["hbm_watermark", "CostLedger"])
def test_ledger_default_device_needs_a_card(monkeypatch, make):
    """Without a card the default device raises, as the entry points'
    does; ``device="cpu"`` is the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tled, make)()
    if make == "CostLedger":
        assert tled.CostLedger("cpu").device.type == "cpu"
    else:
        assert tled.hbm_watermark("cpu")["source"] == "live_tensors"
