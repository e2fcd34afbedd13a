"""The port's resident serve engine against the JAX package's, bit for
bit: the admission ring (backpressure shed, wraparound FIFO, lowest-free
slot pairing), the device-deduplicated cache fill, every ``ResidentOut``
field with the state, rings and cache after macro steps (cache off, on,
with merge-width rung counts, with expiry), the gated round loop (the
form a CUDA graph captures) against the early-exit one,
``resident_closed_loop_replay`` against JAX's and the port's ``lookup``,
and whole ``serve_resident`` reports under the shared virtual clock.  A
port-written ``swarm_serve_trace`` artifact with its resident block
passes JAX's checker.  JAX's origin draws are handed across; every
comparison is exact."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conftest import virtual_clock
from opendht_tpu.models import serve as js
from opendht_tpu.models import swarm as jsw
from opendht_tpu_torch.convert import rings_from_numpy
from opendht_tpu_torch.models import serve as ts
from opendht_tpu_torch.models import swarm as tsw
from opendht_tpu_torch.obs.timeline import resident_summary

from torch_port_cases import (SERVE_ADMIT, SERVE_SLOTS, assert_reports_same,
                              assert_same, jax_admission_origins, jax_origins,
                              jax_swarm, port_cfg, port_swarm, serve_schedule,
                              to_torch)

RING = 4 * SERVE_ADMIT
KEY = jax.random.PRNGKey(3)


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


def engines(world, cfg=None, **kw):
    sw, cfg_j, sw_t, cfg_t = world
    cfg_j = cfg or cfg_j
    kw = dict(dict(slots=SERVE_SLOTS, admit_cap=SERVE_ADMIT,
                   ring_slots=RING), **kw)
    return (js.ResidentServeEngine(sw, cfg_j, **kw),
            ts.ResidentServeEngine(sw_t, port_cfg(cfg_j), device="cpu",
                                   **kw))


def bits(seed, n):
    return np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (n, 5),
                                      jnp.uint32))


# ---------------------------------------------------------------------------
# the ring and the device-deduplicated cache fill
# ---------------------------------------------------------------------------

def _ring_batches(case):
    """``(slots, ring, a, busy slots, [(keys, reqs, n_new, pop)])``."""
    if case == "backpressure":       # 6 + 6 rows into an 8-deep ring
        return 8, 8, 6, [], [(bits(0, 6), 0, 6, False),
                             (bits(1, 6), 6, 6, True)]
    if case == "wraparound":         # 5 cycles of 4 through 8 places
        return 8, 8, 4, [], [(bits(2 + c, 4), 4 * c, 4, True)
                             for c in range(5)]
    return 8, 16, 6, [0, 2, 3, 6], [(bits(3, 6), 0, 6, True),   # pairing
                                    (bits(4, 6), 6, 5, True)]


@pytest.mark.parametrize("case", ["backpressure", "wraparound", "pairing"])
def test_ring_enqueue_pop_equal(case):
    """Full-ring shed (the batch's tail, counted), FIFO order across the
    wrap point, and pops paired with the lowest free slots (slots 0, 2, 3
    and 6 busy) — every ring field and popped row equal."""
    slots, ring, a, busy, batches = _ring_batches(case)
    done = np.ones(slots, bool)
    done[busy] = False
    sj = js.empty_serve_state(jsw.SwarmConfig.for_nodes(64), slots)
    sj = sj._replace(done=jnp.asarray(done))
    st = ts.empty_serve_state(tsw.SwarmConfig.for_nodes(64, device="cpu"),
                              slots, "cpu")._replace(done=torch.from_numpy(
                                  done))
    rj = js.empty_serve_rings(slots, ring)
    rt = rings_from_numpy(*map(np.asarray, rj), device="cpu")
    assert_same(rj, ts.empty_serve_rings(slots, ring, "cpu"), "empty rings")
    for keys, req0, n_new, pop in batches:
        reqs = np.arange(req0, req0 + len(keys), dtype=np.int32)
        cls = (reqs % 3).astype(np.int32)
        rj = js._ring_enqueue(rj, jnp.asarray(keys), jnp.asarray(reqs),
                              jnp.asarray(cls), jnp.int32(n_new))
        rt = ts._ring_enqueue(rt, to_torch(keys), to_torch(reqs),
                              to_torch(cls), n_new)
        assert_same(rj, rt, f"{case}: enqueue")
        if pop:
            pj = js._ring_pop(sj, rj, a)
            pt = ts._ring_pop(st, rt, a)
            assert_same(pj[1:], pt[1:], f"{case}: popped rows")
            rj, rt = pj[0], pt[0]
            assert_same(rj, rt, f"{case}: after the pop")
    if case == "backpressure":
        assert int(rt.shed) == 4 and int(rt.tail) == 8
    if case == "pairing":
        assert pt[4][pt[5]].tolist() == [1, 4, 5, 7]


def test_cache_fill_sorted_with_colliding_slots(world):
    """Rows colliding on a 4-slot cache (the last row of each slot
    wins), masked rows dropped, a fill after an invalidation — the whole
    cache equal after each."""
    cfg, cfg_t = world[1], world[3]
    cj = js.empty_result_cache(cfg, 4)
    ct = ts.empty_result_cache(cfg_t, 4, device="cpu")
    r = np.random.default_rng(7)
    for rnd in (5, 11):
        keys = r.integers(0, 2**32, (24, 5), dtype=np.uint64).astype(
            np.uint32)
        found = r.integers(-1, 512, (24, cfg.quorum)).astype(np.int32)
        hops = r.integers(0, 9, 24).astype(np.int32)
        mask = r.random(24) < 0.7
        cj = js._cache_fill_sorted(cj, *map(jnp.asarray, (keys, found, hops,
                                                          mask)),
                                   jnp.int32(rnd))
        ct = ts._cache_fill_sorted(ct, to_torch(keys), to_torch(found),
                                   to_torch(hops), torch.from_numpy(mask), rnd)
        assert_same(cj, ct, f"fill at round {rnd}")
        cj, ct = js._cache_invalidate(cj), ts._cache_invalidate(ct)


# ---------------------------------------------------------------------------
# macro steps
# ---------------------------------------------------------------------------

N_NEW = [32, 32, 20, 0, 32, 5, 0, 0]


def _macro_inputs(step, pool):
    r = np.random.default_rng(100 + step)
    keys = pool[r.integers(0, len(pool), SERVE_ADMIT)]
    reqs = np.arange(step * SERVE_ADMIT, (step + 1) * SERVE_ADMIT,
                     dtype=np.int32)
    return keys, reqs, (reqs % 2).astype(np.int32)


FORMS = {
    "cache_off": dict(),
    "cache_on": dict(cache_slots=64),
    "rung": dict(rung_block=8),
    "expire": dict(max_steps=2),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_macro_steps_equal(form, world):
    """Eight macro steps (full, partial and empty enqueues) from one
    state: every ``ResidentOut`` field, the state, the rings and the
    cache equal after each step.  ``cache_on`` keys come from a 16-key
    pool, so later steps hit; ``expire`` cuts ``max_steps`` to 2, so
    rows still pending at the end of their first macro step retire."""
    kw = dict(FORMS[form])
    cfg = world[1]._replace(max_steps=kw.pop("max_steps", 48))
    ej, et = engines(world, cfg=cfg, **kw)
    stj, rj = ej.empty(), ej.empty_rings()
    stt, rt = et.empty(), et.empty_rings()
    pool = bits(8, 16)
    rnd = 0
    totals = np.zeros(4, np.int64)
    for step, n_new in enumerate(N_NEW):
        keys, reqs, cls = _macro_inputs(step, pool)
        key = jax.random.fold_in(KEY, step)
        stj, rj, oj = ej.macro_step(stj, rj, jnp.asarray(keys),
                                    jnp.asarray(reqs), jnp.asarray(cls), key,
                                    n_new, rnd)
        stt, rt, ot = et.macro_step(stt, rt, keys, reqs, cls,
                                    jax_origins(world[0], key, SERVE_ADMIT),
                                    n_new, rnd)
        assert_same(oj, ot, f"{form}: ResidentOut, step {step}")
        assert_same(stj, stt, f"{form}: state, step {step}")
        assert_same(rj, rt, f"{form}: rings, step {step}")
        if ej.cache is not None:
            assert_same(ej.cache, et.cache, f"{form}: cache, step {step}")
        o = et.read_out(ot)
        totals += [int(o.hits), int((o.comp & (o.comp_com < 0)).sum()),
                   int(o.rung_counts.sum()), int(o.rounds_run)]
        rnd += ej.rounds_per_iter
    assert et.readbacks == len(N_NEW)
    if form == "cache_on":
        assert totals[0] > 0
    if form == "expire":
        assert totals[1] > 0
    if form == "rung":
        assert et.n_rungs > 1 and o.rung_counts.shape == (et.n_rungs,)
        assert totals[2] == totals[3]


GATED = {
    "k1_rounds6_cache": dict(cache_slots=64, rounds_per_iter=6),
    "rung_rounds5": dict(rung_block=8, rounds_per_iter=5),
    "fused_rounds4": dict(merge_impl="fused-round", rounds_per_iter=4),
}


@pytest.mark.parametrize("form", list(GATED))
def test_gated_rounds_equal_early_exit(form, world):
    """The gated loop (all ``rounds`` trips, the state kept where
    nothing is pending — what a graph replays) equals the early-exit
    loop, step after step, with round budgets that outlast the work."""
    kw = dict(GATED[form])
    cfg = world[3]._replace(merge_impl=kw.pop("merge_impl", "auto"))
    rounds = kw.pop("rounds_per_iter")
    eng = ts.ResidentServeEngine(world[2], cfg, slots=SERVE_SLOTS,
                                 admit_cap=SERVE_ADMIT, device="cpu", **kw)
    carry = {g: (eng.empty(), eng.empty_rings(), eng.cache)
             for g in (False, True)}
    pool = bits(9, 16)
    idle = 0
    for step, n_new in enumerate(N_NEW):
        keys, reqs, cls = _macro_inputs(step, pool)
        og = torch.from_numpy(np.random.default_rng(step).integers(
            0, 512, SERVE_ADMIT).astype(np.int32))
        outs = {}
        for g, (st, rings, cache) in carry.items():
            st, rings, cache, out = ts._resident_core(
                world[2], cfg, st, rings, cache, to_torch(keys),
                to_torch(reqs), to_torch(cls), og, n_new, step * rounds,
                rounds, True, eng.rung_block, gated=g)
            carry[g] = (st, rings, cache)
            outs[g] = out
        for a, b in zip(carry[False], carry[True]):
            if a is not None:
                assert_same(a, b, f"{form}: carries {step}")
        assert_same(outs[False], outs[True], f"{form}: output {step}")
        idle += rounds - int(outs[True].rounds_run)
    assert idle > 0          # some trips ran with nothing pending


# ---------------------------------------------------------------------------
# the closed-loop replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("churned", [False, True])
def test_resident_replay_equals_jax_and_lookup(churned, world):
    """One macro step of ``max_steps`` rounds over L = 64 rows: JAX's
    result, final state and output, and the port's ``lookup`` from the
    same origins, on both port engines; slot j serves request j."""
    sw, cfg, sw_t, cfg_t = world
    if churned:
        sw = jsw.churn(sw, jax.random.PRNGKey(9), 0.25, cfg)
        sw_t = port_swarm(sw)
    tg = bits(1, SERVE_SLOTS)
    key = jax.random.PRNGKey(2)
    rj, stj, oj = js.resident_closed_loop_replay(sw, cfg, jnp.asarray(tg),
                                                 key)
    og = jax_origins(sw, key, SERVE_SLOTS)
    for impl in ("auto", "fused-round"):
        c = cfg_t._replace(merge_impl=impl)
        rt, stt, ot = ts.resident_closed_loop_replay(
            sw_t, c, to_torch(tg), origins=og, device="cpu")
        assert_same(rj, rt, f"replay result ({impl})")
        assert_same(stj, stt, f"final state ({impl})")
        assert_same(oj, ot, f"ResidentOut ({impl})")
        lk = tsw.lookup(sw_t, c, to_torch(tg), origins=og, device="cpu")
        assert_same(lk, rt, f"replay vs lookup ({impl})")
        assert ot.comp_req.tolist() == list(range(SERVE_SLOTS))
        assert int(ot.adm) == SERVE_SLOTS and int(ot.shed) == 0
    with pytest.raises(ValueError, match="slots == L"):
        ts.resident_closed_loop_replay(sw_t, cfg_t, to_torch(tg),
                                       engine=engines(world)[1])


# ---------------------------------------------------------------------------
# serve_resident
# ---------------------------------------------------------------------------

SERVE_FORMS = {
    "cache_off": dict(),
    "cache_on": dict(cache_slots=64),
    "shed": dict(admission=(200, 20, "shed")),
}


@pytest.fixture(scope="module")
def schedule():
    return serve_schedule()


def assert_planes_same(rj, rt, max_steps):
    """Each package's report published as ``bench.py --mode serve``
    publishes a resident run — a ``LatencyPlane`` by class, the hop
    histogram and the ``ResidentPlane`` — renders the same text, and the
    plane's count and violation ratio match the report."""
    from opendht_tpu.obs import latency as jl
    from opendht_tpu.obs import timeline as jt
    from opendht_tpu.utils import metrics as jm
    from opendht_tpu_torch.obs import latency as tl
    from opendht_tpu_torch.obs import timeline as tt
    from opendht_tpu_torch.utils import metrics as tm
    texts, planes = [], []
    for rep, lat, tl_, met in ((rj, jl, jt, jm), (rt, tl, tt, tm)):
        reg = met.MetricsRegistry()
        plane = lat.LatencyPlane(reg, "dht_serve_request", ("klass",),
                                 slo_target_s=0.01)
        for sec, k in zip(rep["latency_s"], rep["klass"]):
            plane.observe(float(sec), klass=str(k))
        lat.publish_hop_histogram(reg, np.bincount(
            np.clip(rep["hops"], 0, max_steps), minlength=max_steps + 1))
        tl_.ResidentPlane(reg).publish_run(rep)
        texts.append(reg.render_prometheus())
        planes.append(plane)
    assert texts[0] == texts[1]
    n = sum(c for _k, (_b, _s, c) in planes[1].hist.snapshot())
    assert n == rt["completed"] == len(rt["latency_s"])
    assert planes[1].violation_ratio == float(
        np.mean(np.asarray(rt["latency_s"]) > 0.01))


@pytest.mark.parametrize("form", list(SERVE_FORMS))
def test_serve_resident_equal(form, world, schedule):
    """Whole reports under the virtual clock — every array and scalar,
    latencies, marks and the resident block — and the conservation of
    requests and ring rows, with no device shed."""
    kw = dict(SERVE_FORMS[form])
    spec = kw.pop("admission", None)
    (tsj, kj, clj), _ = schedule
    ej, et = engines(world, **kw)
    c1, s1 = virtual_clock()
    c2, s2 = virtual_clock()
    pol = (lambda mod: mod.AdmissionControl(rate=spec[0], burst=spec[1],
                                            policy=spec[2])
           if spec else None)
    rj = js.serve_resident(ej, tsj, kj, KEY, klass=clj, clock=c1, sleep=s1,
                           admission=pol(js))
    rt = ts.serve_resident(et, tsj, kj, klass=clj, clock=c2, sleep=s2,
                           admission=pol(ts),
                           origins_of=jax_admission_origins(world[0], KEY))
    assert_reports_same(rj, rt, f"resident report ({form})")
    assert_planes_same(rj, rt, et.cfg.max_steps)
    assert set(rt["layer_walls_s"]) == {"dispatch", "drain_blocked", "sleep",
                                        "host"}
    res = rt["resident"]
    assert rt["admitted"] == (rt["completed"] + rt["in_flight"]
                              + rt["expired"])
    assert res["ring_enqueued"] == (rt["admitted"] + res["ring_backlog_final"]
                                    + res["ring_shed"])
    assert res["ring_shed"] == 0 and rt["found_nonempty"].all()
    assert et.readbacks == res["iterations"]
    if et.cache is not None:
        assert_same(ej.cache, et.cache, "final cache")
        assert rt["cache_hits"] > 0
    if spec:
        assert rt["shed"] > 0
        assert rt["admitted"] + rt["shed"] + rt["never_admitted"] == len(tsj)


def test_degrade_and_constructor_checks(world):
    _, et = engines(world, cache_slots=64)
    with pytest.raises(ValueError, match="degrade"):
        ts.serve_resident(et, np.zeros(2), np.zeros((2, 5), np.uint32),
                          admission=ts.AdmissionControl(rate=5,
                                                        policy="degrade"))
    sw_t, cfg_t = world[2], world[3]
    for kw, match in ((dict(ring_slots=100, admit_cap=64), "ring_slots"),
                      (dict(rounds_per_iter=0), "rounds_per_iter")):
        with pytest.raises(ValueError, match=match):
            ts.ResidentServeEngine(sw_t, cfg_t, slots=64, device="cpu", **kw)
    with pytest.raises(ValueError, match="rung_block"):
        ts.ResidentServeEngine(sw_t, cfg_t._replace(merge_impl="fused-round"),
                               slots=64, rung_block=8, device="cpu")
    with pytest.raises(ValueError, match="cache_slots"):
        eng = engines(world)[1]
        eng.macro_step(eng.empty(), eng.empty_rings(),
                       np.zeros((SERVE_ADMIT, 5), np.uint32),
                       *[np.zeros(SERVE_ADMIT, np.int32)] * 3, 0, 0,
                       use_cache=True)


def serve_artifact(rep: dict) -> dict:
    """A ``swarm_serve_trace`` artifact from a resident report, in
    ``bench.py --mode serve``'s layout (histogram-derived quantiles, the
    lifecycle and cache blocks, the resident block with its summary)."""
    from opendht_tpu.utils.metrics import Histogram
    lat = rep["latency_s"]
    bounds = list(Histogram.LATENCY_BUCKETS_S)
    counts = np.bincount(np.searchsorted(bounds, lat, side="left"),
                         minlength=len(bounds) + 1)
    agg = Histogram("serve_latency_agg", "", buckets=bounds)
    agg.observe_bulk([int(c) for c in counts], float(lat.sum()))
    quants = {name: round(agg.quantile(q), 6) for name, q in
              (("p50", 0.5), ("p95", 0.95), ("p99", 0.99), ("p999", 0.999))}
    offered = rep["admitted"] + rep["never_admitted"] + rep["shed"]
    sr = rep["service_rounds"]
    return {
        "kind": "swarm_serve_trace",
        "bench": {"metric": "swarm_serve_req_per_sec",
                  "value": round(rep["sustained_rps"], 1),
                  "elapsed_s": round(rep["elapsed_s"], 4),
                  "completed": rep["completed"], "shed": rep["shed"],
                  "cache_hits": rep["cache_hits"],
                  "done_frac": round(rep["completed"] / offered, 6),
                  "slot_occupancy_frac": round(rep["slot_occupancy_frac"], 4),
                  "latency_p50_s": quants["p50"],
                  "latency_p99_s": quants["p99"],
                  "serve_engine": "resident", "platform": "cpu"},
        "lifecycle": {k: rep[k] for k in ("admitted", "completed", "expired",
                                          "in_flight", "never_admitted",
                                          "shed", "cache_hits")},
        "latency_histogram": {"bounds": bounds,
                              "counts": [int(c) for c in counts],
                              "sum": round(float(lat.sum()), 6),
                              "count": int(len(lat))},
        "latency_quantiles_s": quants,
        "cache": {"slots": rep["cache_slots"], "hits": rep["cache_hits"],
                  "misses": rep["cache_misses"], "degraded_hits": 0,
                  "hit_rounds_histogram": {
                      "bounds": [0.0, 1.0],
                      "counts": [int((sr == 0).sum()), 0, 0]}},
        "resident": dict(rep["resident"], summary=resident_summary(rep)),
    }


@pytest.fixture(params=["jax", "port"])
def ct(request):
    """The JAX package's artifact checker and the port's own copy."""
    if request.param == "jax":
        from opendht_tpu.tools import check_trace
    else:
        from opendht_tpu_torch.tools import check_trace
    return check_trace


@pytest.fixture(scope="module")
def resident_report(world, schedule):
    """A resident run with the cache on, under the virtual clock."""
    (tsj, kj, clj), _ = schedule
    et = engines(world, cache_slots=64)[1]
    clock, sleep = virtual_clock()
    return ts.serve_resident(et, tsj, kj, klass=clj, clock=clock,
                             sleep=sleep, host_orchestration_budget=1.0,
                             generator=torch.Generator().manual_seed(5))


def test_port_artifact_passes_check_serve_obj(resident_report, ct):
    """A port-written resident artifact passes ``check_serve_obj``, JAX's
    and the port's (ring conservation, depth bounds, cache block,
    quantiles).  Under the virtual clock every clock read is a tick, so
    the host orchestration share is tick arithmetic, not a measurement:
    the run records a budget of 1.0 for it.  A broken ring count is
    caught."""
    check_serve_obj = ct.check_serve_obj
    rep = resident_report
    art = serve_artifact(rep)
    assert check_serve_obj(art) == []
    summary = resident_summary(rep)
    assert summary["iterations"] == rep["resident"]["iterations"]
    art["resident"]["ring_enqueued"] += 1
    assert any("ring does not conserve" in e for e in check_serve_obj(art))
