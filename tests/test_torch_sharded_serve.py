"""The port's sharded serve engine and sharded monitor against the JAX
package's, bit for bit: one group of 4 gloo ranks (spawned once for the
module) against JAX's ``ShardedServeEngine`` and ``MonitorEngine(mesh=)``
on a ``make_mesh(4)`` slice of the conftest's CPU mesh, on the same
churned 512-node swarm, with JAX's per-shard origin draws handed across.

* ``closed_loop_replay`` through the sharded engine: result and the
  whole serve state;
* a cache-probed admission (``admit_probed``): state, hits, their found
  heads and hops, ``xchg_init_rows`` (hit rows never ride the exchange)
  and the cache;
* whole ``serve_open_loop`` reports, cache off and on, under the virtual
  clock, with the final cache and ``xchg_init_rows``;
* three ``MonitorEngine(mesh=)`` sweeps with kills and heals: bucket
  sets, records, results, the freshness plane and each rank's healed
  table rows.

Every comparison is exact."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import monitor as jm
from opendht_tpu.models import serve as jsv
from opendht_tpu.models import swarm as jsw
from opendht_tpu.parallel import make_mesh
from opendht_tpu_torch.convert import state_shard_from_numpy
from opendht_tpu_torch.parallel import mesh as pm

import torch_sharded_ranks as ranks
from conftest import virtual_clock
from torch_port_cases import (SERVE_ADMIT, SERVE_SLOTS, assert_reports_same,
                              assert_same, jax_swarm, port_cfg,
                              serve_schedule)

D = 4
KEY = jax.random.PRNGKey(77)
N_ADMISSIONS = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shard_origins(key, alive, l, d=D):
    return np.concatenate([np.asarray(jsw._sample_origins(
        jax.random.fold_in(key, me), alive, l // d)) for me in range(d)])


def admission_origins(alive, a=SERVE_ADMIT):
    """``[N_ADMISSIONS, a]``: admission ``i``'s origins as JAX's sharded
    admit draws them, ``fold_in(fold_in(KEY, i), shard)`` per shard."""
    def one(i):
        k = jax.random.fold_in(KEY, i)
        return jnp.concatenate([jsw._sample_origins(
            jax.random.fold_in(k, me), alive, a // D) for me in range(D)])
    return np.asarray(jax.vmap(one)(jnp.arange(N_ADMISSIONS)))


def _np_swarm(sw):
    return tuple(np.array(x) for x in (sw.ids, sw.tables, sw.alive)) + (None,)


def _monitor_plan(sw, cfg, mesh):
    """JAX's three mesh sweeps (a full crawl, then kill 0.05 + heal before
    each), and the plan that replays them: kill uniforms, heal draws and
    per-sweep origins."""
    ej = jm.MonitorEngine(sw, cfg, mesh=mesh)
    n, k = cfg.n_nodes, cfg.bucket_k
    plan, ref = [], []
    for s in range(3):
        step = {}
        if s:
            kk, hk = jax.random.PRNGKey(100 + s), jax.random.PRNGKey(200 + s)
            step.update(frac=0.05, kill=np.array(jax.random.uniform(kk, (n,))),
                        heal=np.stack([np.array(jax.random.uniform(
                            jax.random.fold_in(hk, b), (n, k)))
                            for b in range(cfg.n_buckets)]))
            ej.kill(0.05, kk)
            ej.heal(hk)
        key = jax.random.PRNGKey(300 + s)
        buckets = ej.select_buckets()
        step["origins"] = shard_origins(key, ej.swarm.alive, len(buckets))
        rec, res = ej.sweep(key)
        ref.append({"buckets": buckets, "record": rec, "result": res,
                    "fresh": [np.array(x) for x in ej.fresh],
                    "table": np.array(ej.swarm.tables)})
        plan.append(step)
    return plan, ref, ej.hop_hist


@pytest.fixture(scope="module")
def runs():
    sw0, cfg = jax_swarm()
    sw = jsw.churn(sw0, jax.random.PRNGKey(30), 0.2, cfg)
    np_sw = _np_swarm(sw)
    cfg_d = port_cfg(cfg)._asdict()
    mesh = make_mesh(D)
    plan, mon_ref, hop_hist = _monitor_plan(
        sw._replace(tables=jnp.array(np_sw[1])), cfg, mesh)

    tg = jax.random.bits(jax.random.PRNGKey(31), (64, 5), jnp.uint32)
    k_rep = jax.random.PRNGKey(32)
    # The probed admission: 4 cached keys among 32, slots spread over
    # every rank's rows, two sentinel rows.
    keys = np.array(jax.random.bits(jax.random.PRNGKey(33), (SERVE_ADMIT, 5),
                                    jnp.uint32))
    fill_keys = keys[[1, 7, 18, 30]]
    fill_found = np.arange(32, dtype=np.int32).reshape(4, 8) * 3
    fill_hops = np.array([2, 3, 4, 5], np.int32)
    slots_of = (np.arange(SERVE_ADMIT) * 2).astype(np.int64)
    slots_of[[5, 22]] = SERVE_SLOTS
    k_probe = jax.random.PRNGKey(34)
    (tsj, kj, clj), _ = serve_schedule()
    adm = admission_origins(sw.alive)
    loops = [dict(name="loop_cache_off", slots=SERVE_SLOTS,
                  admit_cap=SERVE_ADMIT, cache_slots=0),
             dict(name="loop_cache_on", slots=SERVE_SLOTS,
                  admit_cap=SERVE_ADMIT, cache_slots=64)]
    spec = {
        "replay": dict(targets=np.asarray(tg), cf=2.0,
                       origins=shard_origins(k_rep, sw.alive, 64)),
        "probe": dict(slots=SERVE_SLOTS, admit_cap=SERVE_ADMIT,
                      cache_slots=64, fill_keys=fill_keys,
                      fill_found=fill_found, fill_hops=fill_hops, keys=keys,
                      slots_of=slots_of,
                      origins=shard_origins(k_probe, sw.alive, SERVE_ADMIT)),
        "loops": [dict(f, ts=tsj, keys=kj, klass=clj, origins=adm)
                  for f in loops],
    }
    with ThreadPoolExecutor(2) as ex:
        fut_serve = ex.submit(pm.spawn, ranks.serve_cases, D, backend="gloo",
                              device="cpu", args=(np_sw, cfg_d, spec), timeout=30.0,
                              limit=240.0, threads=1)
        fut_mon = ex.submit(pm.spawn, ranks.monitor_sweeps, D,
                            backend="gloo", device="cpu", args=(np_sw, cfg_d, plan),
                            timeout=30.0, limit=240.0, threads=1)
        ref = {"monitor": mon_ref, "hop_hist": hop_hist}
        eng = jsv.ShardedServeEngine(sw, cfg, 64, mesh, admit_cap=64,
                                     capacity_factor=2.0)
        ref["replay"] = jsv.closed_loop_replay(sw, cfg, tg, k_rep,
                                               engine=eng)
        eng = jsv.ShardedServeEngine(sw, cfg, SERVE_SLOTS, mesh,
                                     admit_cap=SERVE_ADMIT, cache_slots=64)
        eng.fill_cache(fill_keys, fill_found, fill_hops, 0)
        st, h, f, hp = eng.admit_probed(
            eng.empty(), jnp.asarray(keys),
            jnp.asarray(slots_of.astype(np.int32)), k_probe, 3)
        ref["probe"] = dict(state=st, hit=h, found=f, hops=hp,
                            xchg=eng.xchg_init_rows, cache=eng.cache)
        for form in loops:
            eng = jsv.ShardedServeEngine(
                sw, cfg, form["slots"], mesh, admit_cap=form["admit_cap"],
                cache_slots=form["cache_slots"])
            clock, sleep = virtual_clock()
            rep = jsv.serve_open_loop(eng, tsj, kj, KEY, klass=clj,
                                      clock=clock, sleep=sleep)
            ref[form["name"]] = (rep, eng.xchg_init_rows, eng.cache)
        serve = fut_serve.result()
        mon = fut_mon.result()
    return ref, serve, mon


def _cat(parts):
    return np.concatenate(parts)


def test_closed_loop_replay_equal(runs):
    """The replay's result and final state (every field, the lifecycle
    rows too) equal JAX's, each rank holding its rows."""
    (res_j, st_j), serve = runs[0]["replay"], runs[1]
    n_res = len(res_j)
    res_t = [_cat([o["replay"][i] for o in serve]) for i in range(n_res)]
    assert_same(res_j, res_t, "replay result")
    st_t = [_cat([o["replay"][n_res][i] for o in serve])
            for i in range(len(st_j))]
    assert_same(st_j, st_t, "replay state")
    assert np.all(res_t[2])
    # convert carries JAX's sharded serve state to each rank's rows.
    for r, o in enumerate(serve):
        mine = state_shard_from_numpy(*[np.asarray(x) for x in st_j],
                                      rank=r, size=D, device="cpu")
        assert_same(mine, o["replay"][n_res], f"rank {r}'s state rows")


def test_admit_probed_equal(runs):
    """The cache is probed before the routed init: hits (the 4 cached
    keys, 2 of them on sentinel rows) never ride the exchange —
    ``xchg_init_rows`` = 32 − hits on both sides, and the solicitations
    the ranks' init ``all_to_all`` shipped sum to the same — and the
    admitted state, the hit rows and the cache equal JAX's."""
    pj, serve = runs[0]["probe"], runs[1]
    st_t = [_cat([o["probe"]["state"][i] for o in serve])
            for i in range(len(pj["state"]))]
    assert_same(pj["state"], st_t, "probed admission state")
    for o in serve:
        p = o["probe"]
        assert_same([pj["hit"], pj["found"], pj["hops"]],
                    [p["hit"], p["found"], p["hops"]], "probe rows")
        assert_same(pj["cache"], p["cache"], "cache")
        assert p["xchg"] == pj["xchg"] == SERVE_ADMIT - int(p["hit"].sum())
    assert int(serve[0]["probe"]["hit"].sum()) == 4
    assert sum(o["probe"]["sent"] for o in serve) == SERVE_ADMIT - 4
    assert all(o["probe"]["dropped"] == 0 for o in serve)


@pytest.mark.parametrize("form", ["loop_cache_off", "loop_cache_on"])
def test_serve_open_loop_equal(form, runs):
    """Whole open-loop reports under the virtual clock equal JAX's on
    every rank (every key, arrays element for element), with the final
    cache and the routed init-row count."""
    rep_j, xchg_j, cache_j = runs[0][form]
    for o in runs[1]:
        rep_t = dict(o[form])
        xchg_t = rep_t.pop("xchg_init_rows")
        cache_t = rep_t.pop("cache")
        assert_reports_same(rep_j, rep_t, form)
        assert xchg_t == xchg_j
        if cache_j is not None:
            assert_same(cache_j, cache_t, f"{form} cache")
    if form == "loop_cache_on":
        assert rep_j["cache_hits"] > 0
    assert rep_j["completed"] > 0


def test_monitor_mesh_sweeps_equal(runs):
    """Three mesh sweeps: bucket sets (at least the mesh size wide),
    records, gathered results, the freshness plane and the hop histogram
    equal JAX's; each rank's healed table rows are its rows of JAX's
    healed table."""
    ref, mon = runs[0]["monitor"], runs[2]
    for s, rj in enumerate(ref):
        for o in mon:
            rt = o["sweeps"][s]
            assert np.array_equal(rj["buckets"], rt["buckets"])
            assert len(rt["buckets"]) >= D
            assert rj["record"] == rt["record"], (rj["record"], rt["record"])
            assert_same(rj["result"], rt["result"], f"sweep {s} result")
            assert_same(rj["fresh"], rt["fresh"], f"sweep {s} freshness")
        tab = _cat([o["sweeps"][s]["table"] for o in mon])
        assert np.array_equal(rj["table"], tab), f"sweep {s} healed table"
    for o in mon:
        assert np.array_equal(runs[0]["hop_hist"], o["hop_hist"])
