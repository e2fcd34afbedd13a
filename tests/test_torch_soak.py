"""The port's soak engine against the JAX package's, bit for bit, on the
512-node swarm with 64 slots and admission cap 32: each device function
of ``models/soak.py`` on one mid-run serve state, ``mixed_events``, the
maintenance-off soak against the port's own ``serve_open_loop`` on the
same schedule, and three whole ``soak_open_loop`` reports under the
shared virtual clock — read-heavy with churn and an outage (both A/B
arms), scan-heavy over a PHT index, chunk-heavy — with their
``SoakTimeline`` rows and the interference ledger.  JAX's draws (the
admission origins, and every ``maint_key`` fold: maintenance origins,
kill and heal draws, the chunked station's origins) are handed across;
the initial store and index are JAX's, carried over with ``convert``.
The read-heavy on arm runs both loops with a ``LatencyPlane`` labelled
by ``op`` (and publishes its timeline through a ``SoakPlane``): the
rendered registries are equal.  The loop refuses what it cannot serve,
and a port-made ``swarm_soak_trace`` artifact passes JAX's
``check_soak_obj``."""

import copy
import hashlib
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conftest import virtual_clock
from opendht_tpu.models import index as ji
from opendht_tpu.models import monitor as jm
from opendht_tpu.models import serve as js
from opendht_tpu.models import soak as jk
from opendht_tpu.models import storage as jst
from opendht_tpu.models import swarm as jsw
from opendht_tpu.obs import latency as jlat
from opendht_tpu.obs import timeline as jtl
from opendht_tpu.utils import metrics as jmet
from opendht_tpu_torch import convert
from opendht_tpu_torch.models import index as ti
from opendht_tpu_torch.models import monitor as tm
from opendht_tpu_torch.models import serve as tsv
from opendht_tpu_torch.models import soak as tk
from opendht_tpu_torch.models import storage as tst
from opendht_tpu_torch.obs import health as th
from opendht_tpu_torch.obs import latency as tlat
from opendht_tpu_torch.obs import timeline as ttl
from opendht_tpu_torch.utils import metrics as tmet

from torch_port_cases import (SERVE_ADMIT, SERVE_SLOTS, assert_same,
                              jax_key_pool, jax_swarm, patch_index_widths,
                              port_cfg, port_swarm, to_torch)

MAINT_KEY = jax.random.PRNGKey(0x50AC)
ADMIT_KEY = jax.random.PRNGKey(3)
IX_WIDTH = 512        # every index get / put of both packages
KEY_POOL = 64
PUTS = 96
SOAK_CFG = dict(interval_s=0.25, repub_period_s=0.3, maint_cap=32,
                write_flush=32, listen_period_s=0.4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The JAX swarm (tables copied: the JAX heal consumes its table
    buffer) and the port's own copy."""
    sw, cfg = jax_swarm()
    return sw, cfg, port_cfg(cfg)


@pytest.fixture(scope="module")
def patched():
    """One index batch shape for JAX (``patch_index_widths``)."""
    mp = pytest.MonkeyPatch()
    patch_index_widths(mp, IX_WIDTH)
    yield
    mp.undo()


def _np_alive(alive):
    return jnp.asarray(alive.cpu().numpy())


def jax_draws(n, k):
    """The port's draw source giving JAX's ``maint_key`` folds."""
    def draws(kind, path, alive, m):
        key = MAINT_KEY
        for x in path:
            key = jax.random.fold_in(key, x)
        if kind == "origins":
            return torch.from_numpy(np.array(
                jsw._sample_origins(key, _np_alive(alive), m)))
        if kind == "kill":
            return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
        assert kind == "heal"
        return lambda b: torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, b), (n, k))))
    return draws


def admission_origins(soak_t):
    """The serve admissions' origins as JAX draws them, on the port
    engine's current alive mask."""
    def origins_of(i):
        return torch.from_numpy(np.array(jsw._sample_origins(
            jax.random.fold_in(ADMIT_KEY, i), _np_alive(soak_t.swarm.alive),
            soak_t.serve.admit_cap)))
    return origins_of


def schedule(write=0.05, scan=0.0, chunk=0.0, rate=300.0, duration=0.9):
    kw = dict(rate=rate, duration=duration, key_pool=KEY_POOL, zipf_s=1.1,
              seed=7, write_frac=write, scan_frac=scan, scan_span=8,
              chunk_frac=chunk, chunk_write_frac=0.25)
    out_j = jk.mixed_events(**kw)
    out_t = tk.mixed_events(**kw, pool=jax_key_pool(7, KEY_POOL))
    return out_j, out_t


def index_entries():
    """``bench.py --mode soak``'s index entry list (uniform ranks, rank →
    4-byte key, at most 16 a key), cut to 24 entries over 12 ranks."""
    rng = np.random.default_rng(7)
    per, ranks, dups = {}, [], []
    for r in rng.integers(0, 12, size=24):
        c = per.get(int(r), 0)
        if c >= 16:
            continue
        per[int(r)] = c + 1
        ranks.append(int(r))
        dups.append(c)
    keys = [{"k": struct.pack(">I", r)} for r in ranks]
    ehash = np.stack([np.frombuffer(hashlib.sha1(b"e%d.%d" % rd).digest(),
                                    dtype=">u4") for rd in zip(ranks, dups)]
                     ).astype(np.uint32)
    return keys, ehash, np.arange(len(ranks), dtype=np.uint32)


def scan_key(rank):
    return {"k": struct.pack(">I", int(rank))}


def build_pair(world, *, monitor=True, scan=False, chunk=False):
    """One JAX soak engine and its port twin from the same state: the
    same store (JAX's announce of ``PUTS`` tracked values and 16
    listeners, carried over), monitor, index (JAX-built, carried over)
    and chunked station; the port drawing JAX's ``maint_key`` folds."""
    sw, cfg, cfg_t = world
    sw_j = sw._replace(tables=jnp.array(sw.tables, copy=True))
    sw_t = port_swarm(sw)
    kw = dict(slots=4, listen_slots=4, max_listeners=64,
              payload_words=2 if chunk else 0)
    scfg_j, scfg_t = jst.StoreConfig(**kw), tst.StoreConfig(**kw)
    pk = jax.random.bits(jax.random.PRNGKey(11), (PUTS, 5), jnp.uint32)
    store_j = jst.empty_store(cfg.n_nodes, scfg_j)
    store_j, _ = jst.announce(sw_j, cfg, store_j, scfg_j, pk,
                              jnp.arange(PUTS, dtype=jnp.uint32) + 1,
                              jnp.ones((PUTS,), jnp.uint32), 0,
                              jax.random.PRNGKey(12))
    store_j, _ = jst.listen_at(sw_j, cfg, store_j, scfg_j, pk[:16],
                               jnp.arange(16, dtype=jnp.int32),
                               jax.random.PRNGKey(13), 0)
    store_t = convert.store_from_numpy(*map(np.asarray, store_j),
                                       device="cpu")
    mcfg = jm.MonitorConfig.for_nodes(cfg.n_nodes)
    mon_j = jm.MonitorEngine(sw_j, cfg, mcfg) if monitor else None
    mon_t = (tm.MonitorEngine(sw_t, cfg_t, tm.MonitorConfig(*mcfg),
                              device="cpu") if monitor else None)
    ix_j = ix_t = key_fn = None
    if scan:
        spec_j = ji.IndexSpec.from_key_spec("bench", {"k": 4})
        spec_t = ti.IndexSpec(*spec_j)
        ikw = dict(slots=24, listen_slots=1, max_listeners=64,
                   payload_words=spec_j.payload_words)
        isc_j, isc_t = jst.StoreConfig(**ikw), tst.StoreConfig(**ikw)
        ix_j = ji.DeviceIndex(sw_j, cfg, jst.empty_store(cfg.n_nodes, isc_j),
                              isc_j, spec_j, seed=3)
        ix_j.insert_batch(*index_entries())
        root = jax.random.PRNGKey(3)
        ix_t = ti.DeviceIndex(
            sw_t, cfg_t, tst.empty_store(cfg.n_nodes, isc_t, "cpu"), isc_t,
            spec_t, device="cpu",
            draws=lambda op, p: torch.from_numpy(np.array(jsw._sample_origins(
                jax.random.fold_in(root, op), _np_alive(sw_t.alive), p))))
        convert.load_index_state(ix_t, list(map(np.asarray, ix_j.store)),
                                 ix_j._max_depth, ix_j._op, ix_j.stats)
        key_fn = scan_key
    st_j = st_t = None
    if chunk:
        # Eager: compiling JAX's multi-block SHA-1 (the content ids)
        # takes minutes.
        with jax.disable_jit():
            st_j = js.ChunkedStation(cfg, scfg_j, parts=4, pool=32,
                                     batch=16, seed=5)
        st_t = tsv.ChunkedStation(cfg_t, scfg_t, parts=4, pool=32, batch=16,
                                  seed=5, device="cpu")
    sc = jk.SoakConfig(**SOAK_CFG)
    soak_j = jk.SoakEngine(sw_j, cfg, slots=SERVE_SLOTS, scfg=scfg_j,
                           store=store_j, monitor=mon_j, index=ix_j,
                           scan_key_fn=key_fn, admit_cap=SERVE_ADMIT,
                           soak_cfg=sc, maint_key=MAINT_KEY,
                           chunk_station=st_j)
    soak_t = tk.SoakEngine(sw_t, cfg_t, SERVE_SLOTS, scfg=scfg_t,
                           store=store_t, monitor=mon_t, index=ix_t,
                           scan_key_fn=key_fn, admit_cap=SERVE_ADMIT,
                           soak_cfg=tk.SoakConfig(*sc), chunk_station=st_t,
                           draws=jax_draws(cfg.n_nodes, cfg.bucket_k),
                           device="cpu")
    convert.load_soak_state(soak_t, np.asarray(soak_j.wc), soak_j.store_now)
    return soak_j, soak_t


SCENARIO = ((0.3, "churn", 0.05), (0.55, "outage", 0.02))


def run_pair(soak_j, soak_t, sched, maintenance=True, scenario=(),
             planes=None):
    """Both loops on one schedule under fresh virtual clocks, each with
    a timeline → ``(report_j, report_t, timeline_j, timeline_t)``.  With
    a ``planes`` dict, each loop also observes into a
    ``LatencyPlane("dht_soak_request", ("op",))`` of its own package's
    registry, left in ``planes["j"]`` / ``planes["t"]``."""
    (ts, keys, klass, ops, lo, hi), (ts2, keys2, _k, ops2, lo2, hi2) = sched
    assert np.array_equal(keys, keys2) and np.array_equal(ops, ops2)
    kw = dict(klass=klass, ops=ops, scan_lo=lo, scan_hi=hi, burst=2,
              duration=float(ts[-1]), maintenance=maintenance)
    lat = {}
    if planes is not None:
        for side, met, mod in (("j", jmet, jlat), ("t", tmet, tlat)):
            planes[side] = mod.LatencyPlane(met.MetricsRegistry(),
                                            "dht_soak_request", ("op",))
            lat[side] = dict(latency_plane=planes[side])
    c, s = virtual_clock()
    tlj = jtl.SoakTimeline(SOAK_CFG["interval_s"], SERVE_SLOTS,
                           slo_target_s=0.25)
    rj = jk.soak_open_loop(
        soak_j, ts, keys, ADMIT_KEY, timeline=tlj, clock=c, sleep=s,
        scenario=tuple(jk.ScenarioEvent(*e) for e in scenario),
        **lat.get("j", {}), **kw)
    c, s = virtual_clock()
    tlt = ttl.SoakTimeline(SOAK_CFG["interval_s"], SERVE_SLOTS,
                           slo_target_s=0.25)
    fired = []
    rt = tk.soak_open_loop(
        soak_t, ts, keys, timeline=tlt, clock=c, sleep=s,
        origins_of=admission_origins(soak_t),
        scenario=tuple(tk.ScenarioEvent(*e) for e in scenario),
        on_event=lambda ev, now: fired.append((ev.t, ev.kind, now)),
        **lat.get("t", {}), **kw)
    # The hook sees each event once, in order, at or after its second.
    assert [f[:2] for f in fired] == [e[:2] for e in sorted(scenario)]
    assert all(now >= t for t, _k, now in fired)
    return rj, rt, tlj, tlt


def assert_soak_same(rj, rt, soak_j, soak_t, what):
    """Every key of JAX's report equal in the port's (arrays element for
    element, floats exactly); the port's own key is ``found``, whose
    heads agree with ``found_nonempty``; the end states equal."""
    assert set(rt) - set(rj) == {"found"}, what
    assert set(rj) <= set(rt), what
    assert np.array_equal(rt["found"][:, 0] >= 0, rj["found_nonempty"])
    for k in rj:
        a, b = rj[k], rt[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype, f"{what}: {k} dtype"
            assert np.array_equal(a, np.asarray(b)), f"{what}: {k}"
        else:
            assert a == b, f"{what}: {k} {a!r} != {b!r}"
    assert_same(convert.store_from_numpy(*map(np.asarray, soak_j.store),
                                         device="cpu"),
                soak_t.store, f"{what}: store")
    assert_same([soak_j.wc, soak_j.swarm.alive, soak_j.swarm.tables],
                [soak_t.wc, soak_t.swarm.alive, soak_t.swarm.tables],
                f"{what}: plane and swarm")
    assert soak_j.store_now == soak_t.store_now
    if soak_j.mon is not None:
        assert_same(soak_j.mon.fresh, soak_t.mon.fresh, f"{what}: freshness")
        assert soak_j.mon.records == soak_t.mon.records


# ---------------------------------------------------------------------------
# device functions and the schedule
# ---------------------------------------------------------------------------

def _mid_state(world):
    """A 64-slot serve state with 40 rows admitted, stepped 2 rounds,
    then 8 more admitted (JAX's, and carried to the port)."""
    sw, cfg, cfg_t = world
    r = np.random.default_rng(5)
    st = js.empty_serve_state(cfg, SERVE_SLOTS)
    for n, rnd in ((40, 0), (8, 2)):
        slots = np.flatnonzero(np.asarray(st.done))[:n].astype(np.int32)
        tg = r.integers(0, 2**32, (n, 5), dtype=np.uint64).astype(np.uint32)
        orig = jsw._sample_origins(jax.random.PRNGKey(rnd), sw.alive, n)
        st = js._admit(sw, cfg, st, jnp.asarray(tg), jnp.asarray(slots),
                       orig, jnp.int32(rnd))
        for k in range(2 if rnd == 0 else 0):
            st = jsw.lookup_step(sw, cfg, st, jnp.int32(k))
    return st


def test_device_functions_equal(world):
    sw, cfg, cfg_t = world
    sw_t = port_swarm(sw)
    st_j = _mid_state(world)
    st_t = convert.state_from_numpy(*map(np.asarray, st_j), device="cpu")
    r = np.random.default_rng(9)
    c, a = SERVE_SLOTS, SERVE_ADMIT
    wc = r.integers(0, 4, c).astype(np.int32)
    slots = r.permutation(c)[:a].astype(np.int32)
    slots[a // 2:] = c                                   # drop sentinels
    cls = r.integers(0, 4, a).astype(np.int32)
    # _scatter_wclass, per-row classes and a scalar
    assert_same([jk._scatter_wclass(jnp.asarray(wc), jnp.asarray(slots),
                                    jnp.asarray(cls))],
                [tk._scatter_wclass(to_torch(wc), to_torch(slots),
                                    to_torch(cls))], "scatter wclass")
    assert_same([jk._scatter_wclass(jnp.asarray(wc), jnp.asarray(slots),
                                    jnp.int32(2))],
                [tk._scatter_wclass(to_torch(wc), to_torch(slots), 2)],
                "scatter wclass scalar")
    # _soak_snapshot
    assert_same(jk._soak_snapshot(sw, cfg, st_j, jnp.asarray(wc)),
                tk._soak_snapshot(sw_t, cfg_t, st_t, to_torch(wc)),
                "soak snapshot")
    # _fold_completed: W = 40 rows, pads at the sentinel
    w = 40
    buf = r.integers(-1, 512, (w, cfg.quorum)).astype(np.int32)
    sl = r.integers(0, c, a).astype(np.int32)
    pos = r.permutation(w)[:a].astype(np.int32)
    pos[::3] = w
    sl[::3] = 0
    assert_same([jk._fold_completed(jnp.asarray(buf), sw.ids, st_j, cfg,
                                    jnp.asarray(sl), jnp.asarray(pos))],
                [tk._fold_completed(to_torch(buf), sw_t.ids, st_t, cfg_t,
                                    to_torch(sl), to_torch(pos))], "fold")
    # _admit_maintenance from a key pool (pad -1 / C)
    pool = r.integers(0, 2**32, (w, 5), dtype=np.uint64).astype(np.uint32)
    pidx = r.integers(0, w, a).astype(np.int32)
    pidx[a // 2:] = -1
    orig = jsw._sample_origins(jax.random.PRNGKey(4), sw.alive, a)
    out_j = jk._admit_maintenance(
        sw, cfg, jax.tree.map(jnp.copy, st_j), jnp.asarray(wc),
        jnp.asarray(pool), jnp.asarray(pidx), jnp.asarray(slots), orig,
        jnp.int32(5), jnp.int32(3))
    out_t = tk._admit_maintenance(
        sw_t, cfg_t, st_t, to_torch(wc), to_torch(pool), to_torch(pidx),
        to_torch(slots), torch.from_numpy(np.array(orig)), 5, 3)
    assert_same([*out_j[0], out_j[1]], [*out_t[0], out_t[1]], "admit maint")
    # _admit_serve_cached with a filled cache; writes never probe
    cache_j = js.empty_result_cache(cfg, 16)
    keys = r.integers(0, 2**32, (a, 5), dtype=np.uint64).astype(np.uint32)
    fk = keys[:12]
    cache_j = js._cache_fill(
        cache_j, jnp.asarray(fk), jnp.asarray(r.integers(
            0, 512, (12, cfg.quorum)).astype(np.int32)),
        jnp.asarray(np.arange(12, dtype=np.int32)),
        jnp.ones((12,), bool), jnp.int32(1))
    cache_t = convert.cache_from_numpy(*map(np.asarray, cache_j),
                                       device="cpu")
    probe_ok = cls == 0
    out_j = jk._admit_serve_cached(
        sw, cfg, jax.tree.map(jnp.copy, st_j), jnp.asarray(wc),
        jax.tree.map(jnp.copy, cache_j), jnp.asarray(keys),
        jnp.asarray(slots), jnp.asarray(cls), jnp.asarray(probe_ok), orig,
        jnp.int32(6))
    out_t = tk._admit_serve_cached(
        sw_t, cfg_t, st_t, to_torch(wc), cache_t, to_torch(keys),
        to_torch(slots), to_torch(cls), torch.from_numpy(probe_ok),
        torch.from_numpy(np.array(orig)), 6)
    assert_same([*out_j[0], out_j[1], *out_j[2], *out_j[3:]],
                [*out_t[0], out_t[1], *out_t[2], *out_t[3:]], "admit cached")
    assert np.asarray(out_j[3]).any()
    # _ring_enqueue_maintenance into a ring with room for 20
    rings_j = js.empty_serve_rings(c, 64)
    rings_j = rings_j._replace(tail=rings_j.tail + 44)
    rings_t = convert.rings_from_numpy(*map(np.asarray, rings_j),
                                       device="cpu")
    out_j = jk._ring_enqueue_maintenance(rings_j, jnp.asarray(pool),
                                         jnp.asarray(pidx), jnp.int32(a),
                                         jnp.int32(2))
    out_t = tk._ring_enqueue_maintenance(rings_t, to_torch(pool),
                                         to_torch(pidx), a, 2)
    assert_same(out_j, out_t, "ring enqueue")
    # _repub_insert_completed: pools from JAX's compacted extract
    soak_j, soak_t = build_pair(world, monitor=False)
    scfg_j, store_j = soak_j.scfg, soak_j.store
    nidx = jnp.arange(cfg.n_nodes, dtype=jnp.int32)
    order, nlive = jst._repub_live(sw.alive, store_j, nidx, cfg, scfg_j)
    wdt = jst.pow2_width(int(nlive), jst._REPUB_COMPACT_FLOOR)
    pools_j = jst._repub_extract_rows(sw.alive, store_j, nidx, order[:wdt],
                                      cfg, scfg_j)
    pools_t = [to_torch(np.asarray(x)) for x in pools_j]
    sl = r.integers(0, c, a).astype(np.int32)
    pos = r.permutation(wdt)[:a].astype(np.int32)
    pos[::4] = wdt
    acc = np.array([3, 17, 2], np.int32)
    out_j = jk._repub_insert_completed(
        sw.ids, sw.alive, cfg, scfg_j, store_j, st_j, jnp.asarray(sl),
        jnp.asarray(pos), *pools_j, jnp.asarray(acc), jnp.uint32(9))
    out_t = tk._repub_insert_completed(
        sw_t.ids, sw_t.alive, cfg_t, soak_t.scfg, soak_t.store, st_t,
        to_torch(sl), to_torch(pos), *pools_t, to_torch(acc), 9)
    assert_same(convert.store_from_numpy(*map(np.asarray, out_j[0]),
                                         device="cpu"), out_t[0],
                "repub insert store")
    assert_same([out_j[1]], [out_t[1]], "repub accumulator")
    assert int(out_t[1][0]) > 3


def test_mixed_events_equal():
    (a, b) = schedule(write=0.2, scan=0.2, chunk=0.3, rate=400.0)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert set(np.unique(b[3])) == {"read", "write", "scan", "chunk",
                                    "chunkw"}
    for bad in (dict(write_frac=0.7, scan_frac=0.4),
                dict(chunk_write_frac=1.5)):
        with pytest.raises(ValueError):
            tk.mixed_events(100, 1.0, 16, 1.1, **bad)


# ---------------------------------------------------------------------------
# whole loops
# ---------------------------------------------------------------------------

def test_maintenance_off_equals_serve_open_loop(world):
    """No store, monitor, index or scenario, maintenance off: the soak
    is the serve loop (every shared report key equal)."""
    sw, cfg, cfg_t = world
    _, (ts, keys, klass, _ops, _lo, _hi) = schedule(write=0.0)
    soak = tk.SoakEngine(port_swarm(sw), cfg_t, SERVE_SLOTS,
                         admit_cap=SERVE_ADMIT, device="cpu")
    eng = tsv.ServeEngine(port_swarm(sw), cfg_t, SERVE_SLOTS,
                          admit_cap=SERVE_ADMIT, device="cpu")
    c1, s1 = virtual_clock()
    rs = tsv.serve_open_loop(eng, ts, keys, klass=klass, burst=2,
                             clock=c1, sleep=s1,
                             generator=torch.Generator().manual_seed(8))
    c2, s2 = virtual_clock()
    rk = tk.soak_open_loop(soak, ts, keys, klass=klass, burst=2,
                           maintenance=False, clock=c2, sleep=s2,
                           generator=torch.Generator().manual_seed(8))
    shared = set(rs) & set(rk)
    assert shared >= {"admitted", "completed", "latency_s", "burst_marks",
                      "found", "request", "hops"}
    for k in shared:
        a, b = rs[k], rk[k]
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), k
        else:
            assert a == b, k
    assert rk["completed"] > 0 and rk["wclass_mismatches"] == 0


@pytest.fixture(scope="module")
def read_heavy(world):
    """Read-heavy (writes 5 %) with churn and an outage: both arms, JAX
    and port."""
    sched = schedule(write=0.05)
    on = build_pair(world)
    planes = {}
    out_on = run_pair(*on, sched, scenario=SCENARIO, planes=planes)
    off = build_pair(world, monitor=False)
    out_off = run_pair(*off, sched, maintenance=False, scenario=SCENARIO)
    return sched, on, out_on, off, out_off, planes


def test_read_heavy_reports_equal(read_heavy):
    _, on, (rj, rt, tlj, tlt), off, (rj2, rt2, tlj2, tlt2), planes = \
        read_heavy
    assert_soak_same(rj, rt, *on, "read-heavy on")
    assert_soak_same(rj2, rt2, *off, "read-heavy off")
    assert rt["repub_sweeps"] and rt["monitor_sweeps"] and rt["maint_ops"]
    assert rt["lifecycle_by_class"]["write"]["completed"] > 0
    assert any(r["lag_count"] for r in rt["monitor_sweeps"])
    assert rt["wclass_mismatches"] == 0 and not rt2["maintenance"]
    # Under the outage every answer still names a node, in both packages.
    assert rj["found_nonempty"].all() and rj2["found_nonempty"].all()
    assert tlj.to_obj() == tlt.to_obj()
    assert tlj2.to_obj() == tlt2.to_obj()
    led_j = jtl.interference_ledger(tlj.to_obj(), tlj2.to_obj())
    led_t = ttl.interference_ledger(tlt.to_obj(), tlt2.to_obj())
    assert led_j == led_t and led_t["maint_active_intervals"] > 0
    for q in (0.5, 0.99):
        assert jtl._p99_of(tlj.rows, tlj.bounds, q) == ttl._p99_of(
            tlt.rows, tlt.bounds, q)
    with pytest.raises(ValueError, match="interval"):
        ttl.interference_ledger(tlt.to_obj(),
                                dict(tlt2.to_obj(), interval_s=1.0))
    # The latency plane saw every serve completion, labelled by op, and
    # renders as JAX's; the timeline's rows publish equally through a
    # SoakPlane.
    pj, pt = planes["j"], planes["t"]
    assert pj.registry.render_prometheus() == pt.registry.render_prometheus()
    assert pj.registry.to_dict() == pt.registry.to_dict()
    n_obs = sum(n for _k, (_c, _s, n) in pt.hist.snapshot())
    assert n_obs == rt["completed"] > 0
    lats = np.asarray(rt["latency_s"])
    assert pt.violation_ratio == pj.violation_ratio == \
        float(np.mean(lats > pt.slo_target_s))
    assert pt.burn_rate == pj.burn_rate
    for q in (0.5, 0.99):
        assert pt.quantile(q, op="read") == pj.quantile(q, op="read")
    reg_j, reg_t = jmet.MetricsRegistry(), tmet.MetricsRegistry()
    plane_j, plane_t = jtl.SoakPlane(reg_j), ttl.SoakPlane(reg_t)
    for rj_row, rt_row in zip(tlj.rows, tlt.rows):
        plane_j.publish_interval(rj_row)
        plane_t.publish_interval(rt_row)
    assert reg_j.render_prometheus() == reg_t.render_prometheus()
    # The counters book the sweeps closed inside the loop; one still
    # open when the schedule drains closes after it, at elapsed_s.
    sweeps = reg_t.get("dht_soak_sweeps_total")
    end = round(rt["elapsed_s"], 4)
    for kind in ("repub", "monitor"):
        recs = rt[f"{kind}_sweeps"]
        assert sweeps.get(kind=kind) == sum(r["finished_t"] != end
                                            for r in recs) > 0


def test_scan_heavy_report_equal(world, patched):
    soak_j, soak_t = build_pair(world, scan=True)
    rj, rt, tlj, tlt = run_pair(soak_j, soak_t,
                                schedule(write=0.05, scan=0.2, duration=0.5))
    assert_soak_same(rj, rt, soak_j, soak_t, "scan-heavy")
    assert soak_j.index.stats == soak_t.index.stats
    assert rt["scan"]["completed"] > 0 and rt["scan"]["entries_returned"]
    assert tlj.to_obj() == tlt.to_obj()


def test_chunk_heavy_report_equal(world):
    soak_j, soak_t = build_pair(world, chunk=True)
    rj, rt, tlj, tlt = run_pair(soak_j, soak_t,
                                schedule(write=0.05, chunk=0.2))
    assert_soak_same(rj, rt, soak_j, soak_t, "chunk-heavy")
    ch = rt["chunked"]
    assert ch["reads"] and ch["writes"] and ch["garbled"] == 0
    assert soak_t.chunk.seqs.tolist() == soak_j.chunk.seqs.tolist()
    assert tlj.to_obj() == tlt.to_obj()


@pytest.mark.parametrize("case", ["latency-plane", "write-no-store",
                                  "scan-no-index", "chunk-no-station",
                                  "no-maintenance-slot"])
def test_soak_open_loop_rejects(world, case):
    """What the loop cannot serve is refused before the clock starts: a
    latency plane without ``observe``, a write, scan or chunked request
    without its store, index or station, and a maintenance share that
    reserves no whole slot."""
    sw, _cfg, cfg_t = world
    scfg = tst.StoreConfig(slots=4, listen_slots=4, max_listeners=64)
    store = (tst.empty_store(cfg_t.n_nodes, scfg, "cpu")
             if case == "no-maintenance-slot" else None)
    soak = tk.SoakEngine(
        port_swarm(sw), cfg_t, SERVE_SLOTS, scfg=scfg, store=store,
        admit_cap=SERVE_ADMIT, soak_cfg=tk.SoakConfig(maint_slot_frac=0.01),
        device="cpu")
    ops = {"write-no-store": "write", "scan-no-index": "scan",
           "chunk-no-station": "chunk"}.get(case, "read")
    kw = dict(ops=np.full(4, ops), scan_lo=np.zeros(4, np.int64),
              scan_hi=np.zeros(4, np.int64), clock=virtual_clock()[0])
    if case == "latency-plane":
        kw["latency_plane"] = object()
    with pytest.raises(ValueError):
        tk.soak_open_loop(soak, np.linspace(0.0, 0.1, 4),
                          np.zeros((4, 5), np.uint32), **kw)


@pytest.fixture(params=["jax", "port"])
def ct(request):
    """The JAX package's artifact checker and the port's own copy."""
    if request.param == "jax":
        from opendht_tpu.tools import check_trace
    else:
        from opendht_tpu_torch.tools import check_trace
    return check_trace


def test_port_artifact_passes_check_soak_obj(world, read_heavy, ct):
    """The port's read-heavy pair written as ``bench.py --mode soak``'s
    artifact passes ``check_soak_obj``, JAX's and the port's; a broken
    slot-round split is caught."""
    check_soak_obj = ct.check_soak_obj
    from opendht_tpu_torch.utils.metrics import Histogram
    _, (_sj, soak), (_rj, rep, _tlj, tl), _off, (_r2, rep_off, _t2, tl_off), \
        _planes = read_heavy
    cfg = world[1]
    pk = torch.from_numpy(np.asarray(jax.random.bits(
        jax.random.PRNGKey(11), (PUTS, 5), jnp.uint32)).astype(np.int64))
    res = tst.get_values(soak.swarm, soak.cfg, soak.store, soak.scfg, pk,
                         torch.Generator().manual_seed(99), device="cpu")
    surv = round(float(res.hit.float().mean()), 6)
    ledger = ttl.interference_ledger(tl.to_obj(), tl_off.to_obj())
    bounds = tl.bounds
    counts = np.sum([r["latency_counts"] for r in tl.rows], axis=0)
    agg = Histogram("agg", buckets=bounds)
    agg.observe_bulk([int(v) for v in counts], 0.0)
    quants = {nm: round(agg.quantile(q), 6) for nm, q in (
        ("p50", 0.50), ("p95", 0.95), ("p99", 0.99), ("p999", 0.999))}
    n_lat = int(counts.sum())
    viol = sum(r["slo_violations"] for r in tl.rows)
    summary = th.summarize_sweeps(soak.mon.records)
    mcfg = soak.mon.mcfg
    outage = SCENARIO[1][2]
    obj = {
        "kind": "swarm_soak_trace",
        "bench": {
            "latency_p50_s": quants["p50"], "latency_p99_s": quants["p99"],
            "value_survival_final": surv,
            "maint_interference_p99_delta_s": ledger["p99_delta_s"],
            "wclass_mismatches": rep["wclass_mismatches"],
            "slo_violation_ratio": round(viol / n_lat, 6),
            "slo_violation_max": 0.25,
            "monitor_sweeps": len(rep["monitor_sweeps"]),
            "repub_sweeps": len(rep["repub_sweeps"]),
            "detection_lag_max": summary["detection_lag_max"],
            "outage_frac": outage},
        "lifecycle": {"by_class": rep["lifecycle_by_class"],
                      **{k: rep[k] for k in (
                          "admitted", "completed", "expired", "in_flight",
                          "never_admitted", "wclass_mismatches", "scan",
                          "chunked", "cache_slots", "cache_hits",
                          "cache_misses")}},
        "timeline": tl.to_obj(), "timeline_off": tl_off.to_obj(),
        "interference": ledger,
        "monitor": {"config": {"period": mcfg.period,
                               "miss_limit": mcfg.miss_limit,
                               "detection_lag_bound_sweeps":
                                   mcfg.detection_lag_bound},
                    "sweeps": soak.mon.records, "summary": summary},
        "repub": {"sweeps": rep["repub_sweeps"], "survival_final": surv,
                  "survival_floor": round(max(0.9, 1 - 1.5 * outage - 0.002),
                                          6),
                  "tracked_values": PUTS},
        "latency_histogram": {"bounds": bounds,
                              "counts": [int(v) for v in counts],
                              "count": n_lat},
        "latency_quantiles_s": quants,
    }
    assert check_soak_obj(obj) == [], check_soak_obj(obj)
    assert rep_off["monitor_sweeps"] == [] and cfg.n_nodes == 512
    obj = copy.deepcopy(obj)        # the rows are the fixture's timeline's
    obj["timeline"]["rows"][1]["total_slot_rounds"] += 1
    assert any("slot-rounds" in e for e in check_soak_obj(obj))
