"""The port's swarm-health monitor against the JAX package's, bit for
bit: the crawl grid's targets, the kill ledger and range outages,
``fold_sweep`` (every statistic, the freshness histogram and the three
per-bucket counts) from one freshness state, and whole ``MonitorEngine``
sweeps with kills and heals (JAX's draws and origins handed across) on
the plain and the defended chaos engine — the records, the freshness
plane, the lookup results and the hop histograms.  The plane is a pure
observer (the same results with it off), the ``obs.health`` copies
equal JAX's functions, and a port-written ``swarm_monitor_trace``
artifact passes JAX's checker and the port's.  Every comparison is
exact."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import monitor as jm
from opendht_tpu.models import swarm as jsw
from opendht_tpu.obs import health as jh
from opendht_tpu_torch.convert import freshness_from_numpy
from opendht_tpu_torch.models import monitor as tm
from opendht_tpu_torch.models import swarm as tsw
from opendht_tpu_torch.obs import health as th

from torch_port_cases import (assert_same, jax_origins, jax_swarm, port_cfg,
                              port_swarm, to_torch)


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


def test_config_targets_kills_and_outage(world):
    sw, cfg, sw_t, cfg_t = world
    for n in (16, 512, 4096, 10_000_000):
        assert tuple(tm.MonitorConfig.for_nodes(n)) == tuple(
            jm.MonitorConfig.for_nodes(n))
    mj = jm.MonitorConfig.for_nodes(512, period=3, miss_limit=4)
    assert (tm.MonitorConfig(*mj).detection_lag_bound
            == mj.detection_lag_bound == 6)
    buckets = np.array([0, 1, 5, 77, 127])
    assert_same([jm.bucket_targets(buckets, 7)],
                [tm.bucket_targets(buckets, 7, "cpu")], "targets")
    r = np.random.default_rng(1)
    ks = r.integers(-1, 4, 512).astype(np.int32)
    prev = r.random(512) < 0.9
    new = prev & (r.random(512) < 0.8)
    assert_same([jm.record_kills(*map(jnp.asarray, (ks, prev, new)),
                                 jnp.int32(6))],
                [tm.record_kills(*map(torch.from_numpy, (ks, prev, new)), 6)],
                "kill ledger")
    assert_same(jm.kill_node_range(sw, jnp.int32(100), jnp.int32(228), cfg),
                tm.kill_node_range(sw_t, 100, 228, cfg_t), "range outage")


def _fold_inputs(seed, n, g, q=8, s=24):
    """A freshness state with tracked, never-seen, presumed-dead and
    suspect nodes; found rows with -1 pads and repeats; a random probe
    set; a kill ledger; an alive mask."""
    r = np.random.default_rng(seed)
    disc = np.where(r.random(n) < 0.7, r.integers(0, 5, n), -1)
    last = np.where(disc >= 0, disc + r.integers(0, 3, n), -1)
    dead = np.where((disc >= 0) & (r.random(n) < 0.1), last + 1, -1)
    missed = np.where(disc >= 0, r.integers(0, 3, n), 0)
    fr = [x.astype(np.int32) for x in (last, disc, missed, dead)]
    found = r.integers(-1, n, (s, q)).astype(np.int32)
    found[3] = found[2]
    probed = r.random(g) < 0.4
    kill = np.where(r.random(n) < 0.15, r.integers(0, 7, n), -1).astype(
        np.int32)
    alive = r.random(n) < 0.85
    return fr, found, probed, kill, alive


@pytest.mark.parametrize("seed,sweep", [(0, 7), (1, 9)])
def test_fold_sweep_equal(seed, sweep, world):
    """Every output of one fold from the same state: the new state, each
    statistic (int32), the age histogram and the tracked / stale /
    pending counts; the identities the checker holds."""
    sw, cfg, sw_t, _ = world
    mcfg = jm.MonitorConfig.for_nodes(cfg.n_nodes)
    g = 1 << mcfg.depth
    fr, found, probed, kill, alive = _fold_inputs(seed, cfg.n_nodes, g)
    out_j = jm.fold_sweep(jm.FreshnessState(*map(jnp.asarray, fr)),
                          jnp.asarray(found), jnp.asarray(probed),
                          sw.ids[:, 0], jnp.int32(sweep), jnp.asarray(alive),
                          jnp.asarray(kill), mcfg)
    out_t = tm.fold_sweep(freshness_from_numpy(*fr, device="cpu"),
                          to_torch(found), torch.from_numpy(probed),
                          sw_t.ids[:, 0], sweep, torch.from_numpy(alive),
                          to_torch(kill), tm.MonitorConfig(*mcfg))
    assert_same(out_j[0], out_t[0], "freshness state")
    sj, st = jax.device_get(out_j[1]), out_t[1]
    assert set(sj) == set(st)
    for k in sj:
        assert st[k].dtype == torch.int32 and int(st[k]) == int(sj[k]), k
    assert_same([out_j[2], *out_j[3]], [out_t[2], *out_t[3]],
                "age histogram and bucket counts")
    assert int(out_t[2][0]) == int(st["nodes_seen"])
    assert int(st["probed_tracked"]) == int(st["probed_seen"]
                                            + st["probed_missed"])
    assert int(st["lag_count"]) > 0 and int(st["newly_dead"]) > 0


def _engines(world, faults):
    sw, cfg = world[0], world[1]
    fj = ft = None
    if faults:
        sw = jsw.corrupt_swarm(sw, jax.random.PRNGKey(9), 0.05, cfg)
        fj, ft = jsw.LookupFaults(seed=11), tsw.LookupFaults(seed=11)
    sw_t = port_swarm(sw)
    if faults:
        sw_t = sw_t._replace(byzantine=torch.from_numpy(np.array(
            sw.byzantine)))
    return (jm.MonitorEngine(sw, cfg, faults=fj),
            tm.MonitorEngine(sw_t, world[3], faults=ft, device="cpu"),
            tm.MonitorEngine(sw_t._replace(tables=sw_t.tables.clone()),
                             world[3], faults=ft, track_freshness=False,
                             device="cpu"))


@pytest.mark.parametrize("faults", [False, True], ids=["plain", "chaos"])
def test_monitor_sweeps_equal(faults, world):
    """Three sweeps (a full crawl, then kill 0.05 + heal before each):
    the scheduler's bucket sets, every record field, the freshness plane,
    the probes' found / hops / done and the hop histograms equal JAX's;
    the port's plane-off engine returns the same lookups."""
    ej, et, off = _engines(world, faults)
    n, k = world[1].n_nodes, world[1].bucket_k
    for s in range(3):
        if s:
            kk, hk = jax.random.PRNGKey(100 + s), jax.random.PRNGKey(200 + s)
            ej.kill(0.05, kk)
            ej.heal(hk)
            u = torch.from_numpy(np.array(jax.random.uniform(kk, (n,))))

            def draws(b, hk=hk):
                return torch.from_numpy(np.array(jax.random.uniform(
                    jax.random.fold_in(hk, b), (n, k))))
            for eng in (et, off):
                eng.kill(0.05, u)
                eng.heal(draws)
        key = jax.random.PRNGKey(300 + s)
        buckets = ej.select_buckets()
        assert np.array_equal(buckets, et.select_buckets())
        honest = ej.swarm.alive if not faults else (ej.swarm.alive
                                                    & ~ej.swarm.byzantine)
        og = jax_origins(ej.swarm._replace(alive=honest), key, len(buckets))
        rj, res_j = ej.sweep(key)
        rt, res_t = et.sweep(origins=og)
        _, res_off = off.sweep(origins=og, buckets=buckets)
        assert rj == rt, (rj, rt)
        assert_same(res_j, res_t, f"sweep {s} results")
        assert_same(res_t, res_off, f"sweep {s} with the plane off")
        assert_same(ej.fresh, et.fresh, f"sweep {s} freshness")
        assert_same(ej.kill_sweep[None], et.kill_sweep[None], "kill ledger")
    assert np.array_equal(ej.hop_hist, et.hop_hist)
    assert np.array_equal(ej.hop_hist_initial, et.hop_hist_initial)
    assert ej.initial_alive == et.initial_alive
    assert all(np.array_equal(a, b) for a, b in zip(ej.bucket_counts,
                                                    et.bucket_counts))
    assert "coverage" not in off.records[-1]
    assert sum(r["lag_count"] for r in et.records) > 0
    # Each package's records through its SwarmHealthPlane: one text.
    from opendht_tpu.utils import metrics as jmet
    from opendht_tpu_torch.utils import metrics as tmet
    texts = []
    for h, met, eng in ((jh, jmet, ej), (th, tmet, et)):
        reg = met.MetricsRegistry()
        plane = h.SwarmHealthPlane(reg)
        for rec in eng.records:
            plane.publish_sweep(rec)
        plane.publish_density(eng.bucket_counts[-1])
        texts.append(reg.render_prometheus())
        assert reg.get("dht_swarm_sweeps_total").get() == len(eng.records)
    assert texts[0] == texts[1]
    # mesh= is ported (tests/test_torch_sharded_serve.py runs its sweeps):
    # the engine takes the mesh's device and sweeps at least its width.
    from opendht_tpu_torch.parallel.mesh import Mesh
    eng8 = tm.MonitorEngine(world[2], world[3],
                            mesh=Mesh(0, 8, torch.device("cpu"), "gloo"))
    assert eng8.device == torch.device("cpu")
    assert len(eng8.select_buckets()) >= 8


def test_health_copies_equal():
    """The analytic hop model, its median, the fidelity record, the
    Poisson profile, the sweep summary and the histogram percentile."""
    for n in (2, 512, 2048, 1 << 20, 10_000_000):
        for kw in ({}, dict(bucket_k=4, alpha=3, quorum=5, max_steps=20)):
            a, b = jh.analytic_hop_pmf(n, **kw), th.analytic_hop_pmf(n, **kw)
            assert np.array_equal(a, b)
            assert jh._pmf_median(a) == th._pmf_median(b)
    for lam, q in ((0.1, 8), (8.0, 8), (90.0, 3)):
        assert jh._poisson_tail_ge(lam, q) == th._poisson_tail_ge(lam, q)
    hist = [0] * 49
    hist[3], hist[4], hist[5] = 900, 1000, 148
    assert jh.hop_fidelity(hist, 2048) == th.hop_fidelity(hist, 2048)
    with pytest.raises(ValueError):
        th.hop_fidelity([0] * 49, 2048)
    counts = np.random.default_rng(3).poisson(4.0, 4096)
    assert (jh.poisson_density_profile(counts)
            == th.poisson_density_profile(counts))
    recs = [{"lookups": 8, "coverage": 0.9, "lag_count": 0, "lag_sum": 0,
             "lag_max": -1, "false_dead": 0, "false_alive": 1, "age_p50": 0,
             "age_p99": 2},
            {"lookups": 4, "coverage": 0.95, "lag_count": 3, "lag_sum": 5,
             "lag_max": 2, "false_dead": 1, "false_alive": 0, "age_p50": 1,
             "age_p99": 3}]
    assert jh.summarize_sweeps(recs) == th.summarize_sweeps(recs)
    assert (jh.summarize_sweeps([{"lookups": 3}])
            == th.summarize_sweeps([{"lookups": 3}]))
    h = np.array([5, 0, 3, 2])
    for q in (0.0, 0.5, 0.99):
        assert jm._percentile_from_hist(h, q) == tm._percentile_from_hist(h, q)


@pytest.fixture(params=["jax", "port"])
def ct(request):
    """The JAX package's artifact checker and the port's own copy."""
    if request.param == "jax":
        from opendht_tpu.tools import check_trace
    else:
        from opendht_tpu_torch.tools import check_trace
    return check_trace


@pytest.fixture(scope="module")
def monitor_artifact():
    """A port-only run on a 2,048-node swarm (a full crawl, then four
    sweeps of kill 0.05 + heal) written as ``bench.py --mode
    monitor``'s artifact, and its sweep summary."""
    cfg = tsw.SwarmConfig.for_nodes(2048, device="cpu")
    gen = torch.Generator().manual_seed(4)
    eng = tm.MonitorEngine(tsw.build_swarm(cfg, gen, device="cpu"), cfg,
                           device="cpu")
    for s in range(5):
        if s:
            eng.kill(0.05, gen)
            eng.heal(gen)
        eng.sweep(gen)
    mcfg = eng.mcfg
    fid = th.hop_fidelity(eng.hop_hist_initial, eng.initial_alive,
                          bucket_k=cfg.bucket_k, alpha=cfg.alpha,
                          quorum=cfg.quorum)
    summary = th.summarize_sweeps(eng.records)
    obj = {
        "kind": "swarm_monitor_trace",
        "bench": {"metric": "swarm_monitor_coverage",
                  "value": summary["coverage_mean"],
                  "detection_lag_max": summary["detection_lag_max"]},
        "monitor": {
            "config": {"depth": mcfg.depth, "period": mcfg.period,
                       "fresh_ttl": mcfg.fresh_ttl,
                       "stale_threshold": mcfg.stale_threshold,
                       "miss_limit": mcfg.miss_limit,
                       "age_cap": mcfg.age_cap,
                       "detection_lag_bound_sweeps": mcfg.detection_lag_bound,
                       "bucket_k": cfg.bucket_k, "alpha": cfg.alpha,
                       "quorum": cfg.quorum, "max_steps": cfg.max_steps},
            "sweeps": eng.records,
            "hop_histogram_initial": [int(v) for v in eng.hop_hist_initial],
            "initial_alive": eng.initial_alive,
            "hop_fidelity": fid,
            "density": th.poisson_density_profile(eng.bucket_counts[0]),
        },
    }
    return obj, summary


def test_port_artifact_passes_check_monitor_obj(monitor_artifact, ct):
    """The port's monitor artifact passes JAX's ``check_monitor_obj``
    and the port's; a broken conservation count is caught."""
    obj, summary = copy.deepcopy(monitor_artifact)
    assert ct.check_monitor_obj(obj) == []
    assert summary["deaths_detected"] > 0
    obj["monitor"]["sweeps"][2]["tracked_alive"] += 1
    assert any("conserve" in e for e in ct.check_monitor_obj(obj))
