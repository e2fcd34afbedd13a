"""The port's burst serve engine against the JAX package's, bit for bit:
the schedule, the result cache (slot hash, fill / probe / invalidate,
colliding fills, negative results), ``closed_loop_replay`` against JAX's
and against the port's ``lookup``, and whole ``serve_open_loop`` reports
under the shared virtual clock — cache off, cache on, the cold-cache
overlay, the ``shed`` / ``queue`` / ``degrade`` admission policies and
per-key buckets, expiry of stuck requests, the hard wall and the
overload error.  Every report array
and scalar (latencies and burst marks included) is compared exactly;
JAX's admission origins are handed across through ``origins_of``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conftest import virtual_clock
from opendht_tpu.models import serve as js
from opendht_tpu.models import swarm as jsw
from opendht_tpu_torch.convert import cache_from_numpy, state_from_numpy
from opendht_tpu_torch.models import serve as ts
from opendht_tpu_torch.models import swarm as tsw

from torch_port_cases import (SERVE_ADMIT, SERVE_SLOTS, assert_reports_same,
                              assert_same, jax_admission_origins,
                              jax_key_pool, jax_origins, jax_swarm, port_cfg,
                              port_swarm, serve_schedule, to_torch)

KEY = jax.random.PRNGKey(3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread (the JAX runtime's threads
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    sw, cfg = jax_swarm()
    return sw, cfg, port_swarm(sw), port_cfg(cfg)


@pytest.fixture(scope="module")
def schedule():
    return serve_schedule()


def engines(world, cache_slots=0, slots=SERVE_SLOTS, admit_cap=SERVE_ADMIT):
    sw, cfg, sw_t, cfg_t = world
    return (js.ServeEngine(sw, cfg, slots=slots, admit_cap=admit_cap,
                           cache_slots=cache_slots),
            ts.ServeEngine(sw_t, cfg_t, slots=slots, admit_cap=admit_cap,
                           cache_slots=cache_slots, device="cpu"))


# ---------------------------------------------------------------------------
# schedule, slot hash, cache
# ---------------------------------------------------------------------------

def test_poisson_zipf_events_equal(schedule):
    (tsj, kj, clj), pool = schedule
    tst, kt, clt = ts.poisson_zipf_events(rate=400.0, duration=0.5,
                                          key_pool=64, zipf_s=1.1, seed=5,
                                          pool=pool)
    assert np.array_equal(tsj, tst) and np.array_equal(clj, clt)
    assert kt.dtype == np.uint32 and np.array_equal(kj, kt)
    # Uniform keys and the rank return, JAX's pool handed across.
    a = js.poisson_zipf_events(300, 0.3, 16, 0.0, seed=2, return_draw=True)
    b = ts.poisson_zipf_events(300, 0.3, 16, 0.0, seed=2, return_draw=True,
                               pool=jax_key_pool(2, 16))
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    # Without a pool the port draws its own; the numpy parts are equal.
    c = ts.poisson_zipf_events(300, 0.3, 16, 0.0, seed=2)
    assert np.array_equal(c[0], a[0]) and np.array_equal(c[2], a[2])
    for bad in (dict(rate=0, duration=1), dict(rate=100, duration=-1)):
        with pytest.raises(ValueError):
            ts.poisson_zipf_events(key_pool=8, zipf_s=1.0, **bad)


@pytest.mark.parametrize("k_slots", [1, 64, 4096, 4099])
def test_cache_slot_of_equals_numpy(k_slots):
    keys = np.random.default_rng(k_slots).integers(
        0, 2**32, (512, 5), dtype=np.uint64).astype(np.uint32)
    keys[:4] = 0xFFFFFFFF
    want = js._cache_slot_np(keys, k_slots)
    assert np.array_equal(ts._cache_slot_np(keys, k_slots), want)
    got = ts._cache_slot_of(to_torch(keys), k_slots)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_cache_fill_probe_invalidate(world):
    """Fill (some rows masked), probe, invalidate, refill, and the
    standalone probe — every cache field equal after every step."""
    cfg, cfg_t = world[1], world[3]
    cj = js.empty_result_cache(cfg, 64)
    ct = ts.empty_result_cache(cfg_t, 64, device="cpu")
    assert_same(cj, ct, "empty cache")
    assert_same(cj, cache_from_numpy(*map(np.asarray, cj), device="cpu"),
                "converted")
    r = np.random.default_rng(5)
    keys = r.integers(0, 2**32, (8, 5), dtype=np.uint64).astype(np.uint32)
    found = np.arange(8 * cfg.quorum, dtype=np.int32).reshape(8, -1)
    hops = np.arange(8, dtype=np.int32)
    mask = np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)
    for rnd in (3, 9):
        cj = js._cache_fill(cj, *map(jnp.asarray, (keys, found, hops, mask)),
                            jnp.int32(rnd))
        ct = ts._cache_fill(ct, to_torch(keys), to_torch(found),
                            to_torch(hops), torch.from_numpy(mask), rnd)
        assert_same(cj, ct, f"fill at round {rnd}")
        pj = js._cache_probe(cj, jnp.asarray(keys))
        pt = ts._cache_probe(ct, to_torch(keys))
        assert_same(pj, pt, "probe")
        assert np.array_equal(np.asarray(pj[0]), mask)
        cj, ct = js._cache_invalidate(cj), ts._cache_invalidate(ct)
        assert_same(cj, ct, "invalidate")
        assert not ts._cache_probe(ct, to_torch(keys))[0].any()


def test_colliding_fills_and_negative_results(world):
    """Engine fills with rows colliding on a 4-slot cache (the host
    dedupe keeps the last), rows past the admission cap, and negative
    results (an empty found head, never cached)."""
    ej, et = engines(world, cache_slots=4)
    q = world[1].quorum
    r = np.random.default_rng(6)
    for n in (12, 40):
        keys = r.integers(0, 2**32, (n, 5), dtype=np.uint64).astype(
            np.uint32)
        found = r.integers(-1, 512, (n, q)).astype(np.int32)
        found[::5, 0] = -1                    # negative results
        hops = r.integers(0, 9, n).astype(np.int32)
        mj = ej.fill_cache(keys, found, hops, n)
        mt = et.fill_cache(keys, found, hops, n)
        assert mj == mt
        assert_same(ej.cache, et.cache, f"fill of {n} rows")
        hj, hf, hh = ej.probe_cache(jnp.asarray(keys))
        ht, tf, th = et.probe_cache(keys)
        for a, b in ((hj, ht), (hf, tf), (hh, th)):
            assert np.array_equal(np.asarray(a), b)
        assert not ht[found[:, 0] < 0].any()
    ej.invalidate_cache(), et.invalidate_cache()
    assert_same(ej.cache, et.cache, "invalidate")
    with pytest.raises(ValueError, match="cache_slots"):
        ts.ServeEngine(world[2], world[3], slots=8, cache_slots=-1,
                       device="cpu")


# ---------------------------------------------------------------------------
# closed-loop replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("churned", [False, True])
def test_closed_loop_replay_equals_jax_and_lookup(churned, world):
    """The replay (slots = L = 64, everything admitted at round 0) equals
    JAX's replay (found, hops, done and the lifecycle rows) and the
    port's ``lookup`` from the same origins — on both port engines."""
    sw, cfg, sw_t, cfg_t = world
    if churned:
        sw = jsw.churn(sw, jax.random.PRNGKey(9), 0.25, cfg)
        sw_t = port_swarm(sw)
    tg = np.asarray(jax.random.bits(jax.random.PRNGKey(1), (SERVE_SLOTS, 5),
                                    jnp.uint32))
    key = jax.random.PRNGKey(2)
    rj, stj = js.closed_loop_replay(sw, cfg, jnp.asarray(tg), key)
    og = jax_origins(sw, key, SERVE_SLOTS)
    for impl in ("auto", "fused-round"):
        c = cfg_t._replace(merge_impl=impl)
        rt, stt = ts.closed_loop_replay(sw_t, c, to_torch(tg), origins=og,
                                        device="cpu")
        assert_same(rj, rt, f"replay result ({impl})")
        assert_same(stj, stt, f"final state, lifecycle rows too ({impl})")
        lk = tsw.lookup(sw_t, c, to_torch(tg), origins=og, device="cpu")
        assert_same(lk, rt, f"replay vs lookup ({impl})")
    assert (stt.admitted_round == 0).all()
    # A JAX serve state carried across is the port's.
    empty = js.empty_serve_state(cfg, SERVE_SLOTS)
    assert_same(empty, state_from_numpy(*map(np.asarray, empty),
                                        device="cpu"), "carried state")
    assert_same(empty, ts.empty_serve_state(cfg_t, SERVE_SLOTS, "cpu"),
                "empty serve state")
    # The default draw is lookup's: the same generator seed, the same
    # origins.
    a, _ = ts.closed_loop_replay(sw_t, cfg_t, to_torch(tg), device="cpu",
                                 generator=torch.Generator().manual_seed(4))
    b = tsw.lookup(sw_t, cfg_t, to_torch(tg), device="cpu",
                   generator=torch.Generator().manual_seed(4))
    assert_same(a, b, "replay vs lookup, drawn origins")
    with pytest.raises(ValueError, match="slots == L"):
        ts.closed_loop_replay(sw_t, cfg_t, to_torch(tg),
                              engine=engines(world)[1], device="cpu")


# ---------------------------------------------------------------------------
# open-loop serving
# ---------------------------------------------------------------------------

FORMS = {
    "cache_off": dict(),
    "cache_on": dict(cache_slots=64),
    "shed": dict(cache_slots=64,
                 admission=lambda: policy_spec(200, 20, "shed")),
    "degrade": dict(cache_slots=64,
                    admission=lambda: policy_spec(200, 20, "degrade")),
    "shed_per_key": dict(admission=lambda: policy_spec(
        300, 30, "shed", per_key_rate=20, per_key_burst=3, max_keys=16)),
}


def policy_spec(rate, burst, policy, **kw):
    """An admission policy's arguments: each package's loop gets its own
    policy built from them (the buckets carry state)."""
    return (rate, burst, policy, kw)


def _policy(mod, spec):
    rate, burst, policy, kw = spec
    return mod.AdmissionControl(rate=rate, burst=burst, policy=policy, **kw)


def run_form(world, sched, cache_slots=0, admission=None, fills=True, **kw):
    (tsj, kj, clj), _ = sched
    ej, et = engines(world, cache_slots=cache_slots)
    ej.cache_fill_enabled = et.cache_fill_enabled = fills
    c1, s1 = virtual_clock()
    c2, s2 = virtual_clock()
    spec = admission() if admission else None
    rj = js.serve_open_loop(ej, tsj, kj, KEY, klass=clj, clock=c1, sleep=s1,
                            admission=_policy(js, spec) if spec else None,
                            **kw)
    rt = ts.serve_open_loop(et, tsj, kj, klass=clj, clock=c2, sleep=s2,
                            admission=_policy(ts, spec) if spec else None,
                            origins_of=jax_admission_origins(world[0], KEY),
                            **kw)
    assert_reports_same(rj, rt, "serve report")
    if ej.cache is not None:
        assert_same(ej.cache, et.cache, "final cache")
    return rt


@pytest.fixture(scope="module")
def reports():
    """Reports of the forms already run (the overlay test reuses the
    cache-off one)."""
    return {}


def report_of(form, world, schedule, reports):
    if form not in reports:
        reports[form] = run_form(world, schedule, **FORMS[form])
    return reports[form]


@pytest.mark.parametrize("form", list(FORMS))
def test_serve_open_loop_equal(form, world, schedule, reports):
    rep = report_of(form, world, schedule, reports)
    assert rep["admitted"] == (rep["completed"] + rep["in_flight"]
                               + rep["expired"])
    assert rep["completed"] > 0 and rep["found_nonempty"].all()
    assert (rep["latency_s"] >= 0).all()
    if FORMS[form].get("cache_slots"):
        assert rep["cache_hits"] > 0
        assert rep["cache_hits"] + rep["cache_misses"] == rep["admitted"]
    if form in ("shed", "degrade", "shed_per_key"):
        assert rep["shed"] > 0
    if form == "degrade":
        assert rep["degraded_hits"] > 0


def test_cold_cache_overlay_equals_cache_off(world, schedule, reports):
    """Cache-on programs with fills disabled give the cache-off report
    (JAX's too), every probe a miss."""
    off = report_of("cache_off", world, schedule, reports)
    cold = run_form(world, schedule, cache_slots=64, fills=False)
    assert cold["cache_hits"] == 0
    assert cold["cache_misses"] == cold["admitted"]
    for k in off:
        if k not in ("cache_misses", "cache_slots", "layer_walls_s"):
            a, b = off[k], cold[k]
            assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                    else a == b), k


def unqueried_first(ids, target, q):
    """A shortlist head whose exact re-sort puts an unqueried entry
    first: places ``0 … q-1`` hold the 2nd … (q+1)-th exactly closest
    nodes, queried; place ``q`` the closest, unqueried; place ``q+1`` the
    (q+2)-th, unqueried.  Returns ``(idx, d0, queried)`` for those
    ``q + 2`` places."""
    d = ids ^ target[None, :]
    order = np.lexsort([d[:, i] for i in reversed(range(5))])
    head = np.concatenate([order[1:q + 1], order[:1], order[q + 1:q + 2]])
    queried = np.arange(q + 2) < q
    return head.astype(np.int32), d[head, 0], queried


def craft_row(ids, st, row, q):
    """``(idx, dist, queried)`` of a state as numpy, with ``row``'s head
    rewritten by :func:`unqueried_first`."""
    idx, dist, queried = (np.array(x) for x in (st.idx, st.dist, st.queried))
    h, d0, qd = unqueried_first(ids, np.asarray(st.targets)[row]
                                .astype(np.uint32), q)
    idx[row, :q + 2], dist[row, :q + 2], queried[row, :q + 2] = h, d0, qd
    return idx, dist.astype(np.uint32), queried


def test_unqueried_head_reads_empty(world, schedule):
    """A finished row whose exact re-sort ranks an unqueried entry first
    reports found head -1 — JAX's ``_finalize`` and the port's alike —
    and JAX's serve report books it ``found_nonempty`` false, while the
    rest of its found set is not empty.  This is why the card's serve
    legs check for a non-empty found set, not a non-negative head."""
    sw, cfg, sw_t, cfg_t = world
    ids = np.asarray(sw.ids)
    q, s = cfg.quorum, cfg.search_width
    r = np.random.default_rng(11)
    targets = r.integers(0, 2**32, (3, 5), dtype=np.uint64).astype(np.uint32)
    idx = np.full((3, s), -1, np.int32)
    dist = np.full((3, s), 0xFFFFFFFF, np.uint32)
    queried = np.zeros((3, s), bool)
    for row in range(3):
        d = ids ^ targets[row][None, :]
        order = np.lexsort([d[:, i] for i in reversed(range(5))])
        idx[row, :q + 2], dist[row, :q + 2] = order[:q + 2], d[order[:q + 2], 0]
        queried[row, :q] = True
    h, d0, qd = unqueried_first(ids, targets[0], q)
    idx[0, :q + 2], dist[0, :q + 2], queried[0, :q + 2] = h, d0, qd
    fields = (targets, idx, dist, queried, np.ones(3, bool),
              np.zeros(3, np.int32))
    fj = np.asarray(jsw._finalize(sw.ids, jsw.LookupState(
        *map(jnp.asarray, fields)), cfg))
    ft = tsw._finalize(sw_t.ids, state_from_numpy(*fields, device="cpu"),
                       cfg_t)
    assert np.array_equal(fj, ft.numpy())
    assert list(fj[:, 0] >= 0) == [False, True, True]
    assert (fj[0, 1:] >= 0).all()

    # The same head written into the first row that completes in a
    # serve loop, in both packages.
    crafted = {}

    def wrap(step, put):
        def crafting_step(st, rnd):
            st = step(st, rnd)
            if "row" not in crafted:
                new = np.flatnonzero(np.asarray(st.completed_round) == rnd)
                if len(new):
                    crafted["row"] = int(new[0])
            if crafted.get("rnd", rnd) == rnd and "row" in crafted:
                crafted["rnd"] = rnd
                st = put(st, *craft_row(ids, st, crafted["row"], q))
            return st
        return crafting_step

    ej, et = engines(world)
    ej.step = wrap(ej.step, lambda st, i, d, qd: st._replace(
        idx=jnp.asarray(i), dist=jnp.asarray(d), queried=jnp.asarray(qd)))
    et.step = wrap(et.step, lambda st, i, d, qd: st._replace(
        idx=torch.from_numpy(i), dist=torch.from_numpy(d.astype(np.int64)),
        queried=torch.from_numpy(qd)))
    (tsj, kj, clj), _ = schedule
    c1, s1 = virtual_clock()
    c2, s2 = virtual_clock()
    rj = js.serve_open_loop(ej, tsj, kj, KEY, klass=clj, clock=c1, sleep=s1)
    crafted.pop("row"), crafted.pop("rnd")
    rt = ts.serve_open_loop(et, tsj, kj, klass=clj, clock=c2, sleep=s2,
                            origins_of=jax_admission_origins(world[0], KEY))
    assert_reports_same(rj, rt, "crafted head")
    empty = ~rj["found_nonempty"]
    assert empty.sum() == 1
    assert (rt["found"][empty, 0] == -1).all()
    assert (rt["found"][empty, 1:] >= 0).all()


def test_queue_policy_and_admission_slots_unique(world):
    """The queue policy holds the head of line (nothing shed); every
    admission batch names distinct slots besides the sentinel."""
    ts_ = np.zeros(30)
    keys = np.asarray(jax.random.bits(jax.random.PRNGKey(2), (30, 5),
                                      jnp.uint32))
    ej, et = engines(world)
    seen = []
    admit = et.admit

    def recording_admit(st, k, slots, origins, rnd):
        s = np.asarray(slots)
        real = s[s < et.slots]
        assert len(np.unique(real)) == len(real)
        seen.append(len(real))
        return admit(st, k, slots, origins, rnd)

    et.admit = recording_admit
    c1, s1 = virtual_clock()
    c2, s2 = virtual_clock()
    spec = (100, 10, "queue", {})
    rj = js.serve_open_loop(ej, ts_, keys, KEY, clock=c1, sleep=s1,
                            admission=_policy(js, spec),
                            overload_queue_factor=64)
    rt = ts.serve_open_loop(et, ts_, keys, clock=c2, sleep=s2,
                            admission=_policy(ts, spec),
                            overload_queue_factor=64,
                            origins_of=jax_admission_origins(world[0], KEY))
    assert_reports_same(rj, rt, "queue policy")
    assert rt["shed"] == 0 and rt["admitted"] == rt["completed"] == 30
    assert sum(seen) == 30 + 1          # the warm pass admits one row


def test_stuck_requests_expire(world):
    """A step that never finishes anything: every request expires past
    ``max_steps`` rounds and its slot recycles, in both packages."""
    ts_ = np.zeros(40)
    keys = np.zeros((40, 5), np.uint32)
    ej, et = engines(world, slots=16, admit_cap=16)
    ej.step = lambda st, rnd: st
    et.step = lambda st, rnd: st
    c1, s1 = virtual_clock()
    c2, s2 = virtual_clock()
    rj = js.serve_open_loop(ej, ts_, keys, KEY, clock=c1, sleep=s1,
                            overload_queue_factor=64)
    rt = ts.serve_open_loop(et, ts_, keys, clock=c2, sleep=s2,
                            overload_queue_factor=64,
                            origins_of=jax_admission_origins(world[0], KEY,
                                                             16))
    assert_reports_same(rj, rt, "expiry")
    assert rt["completed"] == 0 and rt["expired"] == rt["admitted"] == 40


def test_overload_raises_and_degrade_needs_cache(world):
    ts_ = np.linspace(0.0, 0.01, 2000)
    keys = np.asarray(jax.random.bits(jax.random.PRNGKey(1), (2000, 5),
                                      jnp.uint32))
    et = ts.ServeEngine(world[2], world[3], slots=8, admit_cap=8,
                        device="cpu")
    with pytest.raises(ts.ServeOverloadError, match="arrival rate"):
        ts.serve_open_loop(et, ts_, keys, overload_queue_factor=8,
                           generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="cache"):
        ts.serve_open_loop(et, np.zeros(4), np.zeros((4, 5), np.uint32),
                           admission=ts.AdmissionControl(rate=10,
                                                         policy="degrade"))


def test_shed_policy_hard_wall(world):
    """A clock that blows the hard wall sheds the whole backlog under
    ``shed``, the same way in both packages."""
    ts_ = np.linspace(0.0, 2.0, 300)
    keys = np.asarray(jax.random.bits(jax.random.PRNGKey(4), (300, 5),
                                      jnp.uint32))
    ej, et = engines(world)
    c1, s1 = virtual_clock(step=5.0)
    c2, s2 = virtual_clock(step=5.0)
    spec = (1000, 1000, "shed", {})
    rj = js.serve_open_loop(ej, ts_, keys, KEY, clock=c1, sleep=s1,
                            admission=_policy(js, spec))
    rt = ts.serve_open_loop(et, ts_, keys, clock=c2, sleep=s2,
                            admission=_policy(ts, spec),
                            origins_of=jax_admission_origins(world[0], KEY))
    assert_reports_same(rj, rt, "hard wall")
    assert rt["shed"] > 0
    assert rt["admitted"] + rt["shed"] + rt["never_admitted"] == 300


def test_admission_control_decisions_equal():
    """Per-class and per-key buckets (LRU-capped key map) decide alike on
    one random request stream; validation errors match."""
    r = np.random.default_rng(8)
    now = np.cumsum(r.exponential(0.002, 3000))
    klass = r.choice(["hot", "cold"], 3000)
    keys = r.integers(0, 40, 3000)
    for kw in (dict(rate=100, burst=5), dict(rate=300, per_key_rate=20,
                                             per_key_burst=2, max_keys=16)):
        aj, at = js.AdmissionControl(**kw), ts.AdmissionControl(**kw)
        dj = [aj.allow(k, t, key=int(x)) for k, t, x in zip(klass, now, keys)]
        dt = [at.allow(k, t, key=int(x)) for k, t, x in zip(klass, now, keys)]
        assert dj == dt and 0 < sum(dt) < len(dt)
        assert aj.key_evictions == at.key_evictions
    for kw in (dict(rate=100, policy="drop"), dict(rate=0),
               dict(rate=10, burst=0.5), dict(rate=10, per_key_rate=-1),
               dict(rate=10, per_key_rate=5, policy="queue"),
               dict(rate=10, max_keys=0)):
        with pytest.raises(ValueError) as ej:
            js.AdmissionControl(**kw)
        with pytest.raises(ValueError) as et:
            ts.AdmissionControl(**kw)
        assert str(ej.value) == str(et.value)


def test_autotune_and_round_wall(world):
    cfg, cfg_t = world[1], world[3]
    for args in ((1000, 0.01), (4000, 0.01), (0.001, 0.0001),
                 (1e9, 1.0, 0.5, 128, 4096), (300, 0.02, 0.25)):
        assert (ts.autotune_serve_slots(cfg_t, *args)
                == js.autotune_serve_slots(cfg, *args))
    for bad in ((0, 0.01), (10, 0.01, 0.0)):
        with pytest.raises(ValueError):
            ts.autotune_serve_slots(cfg_t, *bad)
    assert ts.measure_round_wall(world[2], cfg_t, slots=16, rounds=2) > 0
