"""The port's mesh resident serve engine against the JAX package's, bit
for bit: one group of 2 gloo ranks (spawned once for the module) against
JAX's ``ShardedResidentServeEngine`` on a ``make_mesh(2)`` slice of the
conftest's CPU mesh, on the same churned 512-node swarm, with JAX's
per-shard origin draws handed across.

* ``resident_closed_loop_replay`` through the mesh engine: result, final
  state and every ``ResidentOut`` field equal JAX's, and equal JAX's
  ``sharded_lookup(compact=False)`` from the same key (the replay
  identity); ``xchg_init_rows`` is the batch;
* eight macro steps of each form — cache off, cache on, expiry
  (``max_steps=2``): every ``ResidentOut`` field, the state, the rings
  and the cache after each step;
* the gated round loop (what a CUDA graph replays) equals the
  early-exit one, collectives included;
* whole ``serve_resident`` reports, cache off and on, under the virtual
  clock (the resident block's exchange rows too);
* the refusals: slots or admit cap that do not divide the mesh, and a
  graph asked for on a gloo mesh.

Every comparison is exact."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import serve as jsv
from opendht_tpu.models import swarm as jsw
from opendht_tpu.parallel import make_mesh
from opendht_tpu.parallel import sharded as jsh
from opendht_tpu_torch.parallel import mesh as pm

import torch_sharded_ranks as ranks
from conftest import virtual_clock
from torch_port_cases import (SERVE_ADMIT, SERVE_SLOTS, assert_reports_same,
                              assert_same, jax_swarm, port_cfg,
                              serve_schedule)

D = 2
RING = 4 * SERVE_ADMIT
KEY = jax.random.PRNGKey(41)
N_NEW = [32, 32, 20, 0, 32, 5, 0, 0]
FORMS = {"cache_off": {}, "cache_on": dict(cache_slots=64),
         "expire": dict(max_steps=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shard_origins(key, alive, l, d=D):
    """JAX's per-shard draws ``_sample_origins(fold_in(key, shard), alive,
    l/d)``, concatenated in shard order."""
    return np.concatenate([np.asarray(jsw._sample_origins(
        jax.random.fold_in(key, me), alive, l // d)) for me in range(d)])


def bits(seed, n):
    return np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (n, 5),
                                      jnp.uint32))


def _macro_steps(alive, pool, rounds):
    """``(keys, reqs, cls, origins, n_new, rnd0)`` a step, and the JAX
    key each step's origins came from."""
    steps, keys_j = [], []
    for step, n_new in enumerate(N_NEW):
        r = np.random.default_rng(100 + step)
        keys = pool[r.integers(0, len(pool), SERVE_ADMIT)]
        reqs = np.arange(step * SERVE_ADMIT, (step + 1) * SERVE_ADMIT,
                         dtype=np.int32)
        key = jax.random.fold_in(KEY, step)
        steps.append((keys, reqs, (reqs % 2).astype(np.int32),
                      shard_origins(key, alive, SERVE_ADMIT), n_new,
                      step * rounds))
        keys_j.append(key)
    return steps, keys_j


@pytest.fixture(scope="module")
def runs():
    sw0, cfg = jax_swarm()
    sw = jsw.churn(sw0, jax.random.PRNGKey(40), 0.2, cfg)
    np_sw = tuple(np.array(x) for x in (sw.ids, sw.tables, sw.alive)) + (None,)
    cfg_d = port_cfg(cfg)._asdict()
    mesh = make_mesh(D)
    tg = bits(42, SERVE_SLOTS)
    k_rep = jax.random.PRNGKey(43)
    pool = bits(44, 16)
    steps, step_keys = _macro_steps(sw.alive, pool, 2)
    (tsj, kj, clj), _ = serve_schedule()
    adm = np.asarray(jax.vmap(lambda i: jnp.concatenate([
        jsw._sample_origins(jax.random.fold_in(jax.random.fold_in(KEY, i),
                                               me), sw.alive, SERVE_ADMIT // D)
        for me in range(D)]))(jnp.arange(256)))
    serve_forms = [dict(name="serve_cache_off", cache_slots=0),
                   dict(name="serve_cache_on", cache_slots=64)]
    spec = {
        "replay": dict(targets=tg, cf=2.0,
                       origins=shard_origins(k_rep, sw.alive, SERVE_SLOTS)),
        "forms": [dict(name=n, slots=SERVE_SLOTS, admit_cap=SERVE_ADMIT,
                       ring=RING, steps=steps,
                       cache_slots=f.get("cache_slots", 0),
                       cfg={k: v for k, v in f.items() if k == "max_steps"})
                  for n, f in FORMS.items()],
        "gated": dict(slots=SERVE_SLOTS, admit_cap=SERVE_ADMIT,
                      cache_slots=64, rounds=6,
                      steps=[s[:5] + (i * 6,) for i, s in enumerate(steps)]),
        "serve": [dict(f, slots=SERVE_SLOTS, admit_cap=SERVE_ADMIT, ring=RING,
                       ts=tsj, keys=kj, klass=clj, origins=adm)
                  for f in serve_forms],
    }
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(pm.spawn, ranks.resident_cases, D, backend="gloo",
                        device="cpu", args=(np_sw, cfg_d, spec), timeout=30.0,
                        limit=240.0, threads=1)
        ref = {}
        eng = jsv.ShardedResidentServeEngine(sw, cfg, SERVE_SLOTS, mesh,
                                             admit_cap=SERVE_SLOTS,
                                             ring_slots=2 * SERVE_SLOTS)
        ref["replay"] = jsv.resident_closed_loop_replay(
            sw, cfg, jnp.asarray(tg), k_rep, engine=eng)
        ref["lookup"] = jsh.sharded_lookup(sw, cfg, jnp.asarray(tg), k_rep,
                                           mesh, 2.0, compact=False)
        for name, f in FORMS.items():
            ej = jsv.ShardedResidentServeEngine(
                sw, cfg._replace(max_steps=f.get("max_steps", cfg.max_steps)),
                SERVE_SLOTS, mesh, admit_cap=SERVE_ADMIT, ring_slots=RING,
                cache_slots=f.get("cache_slots", 0))
            st, rings = ej.empty(), ej.empty_rings()
            rec = []
            for (keys, reqs, cls, _og, n_new, rnd0), key in zip(steps,
                                                               step_keys):
                st, rings, o = ej.macro_step(
                    st, rings, jnp.asarray(keys), jnp.asarray(reqs),
                    jnp.asarray(cls), key, n_new, rnd0)
                # The next step donates these carries: copy them now.
                rec.append(jax.device_get({"out": o, "state": st,
                                           "rings": rings,
                                           "cache": ej.cache}))
            ref[name] = rec
        for f in serve_forms:
            ej = jsv.ShardedResidentServeEngine(
                sw, cfg, SERVE_SLOTS, mesh, admit_cap=SERVE_ADMIT,
                ring_slots=RING, cache_slots=f["cache_slots"])
            clock, sleep = virtual_clock()
            ref[f["name"]] = (jsv.serve_resident(ej, tsj, kj, KEY, klass=clj,
                                                 clock=clock, sleep=sleep),
                              ej.cache)
        got = fut.result()
    return ref, got


def test_replay_equals_jax_and_sharded_lookup(runs):
    """The replay's result, final state and output equal JAX's on every
    rank (the state is whole on each), and equal JAX's
    ``sharded_lookup(compact=False)``; each rank's
    ``sharded_lookup(compact=False)`` rows are its rows of the replay."""
    ref, got = runs
    rj, stj, oj = ref["replay"]
    for o in got:
        rep = o["replay"]
        assert rep["graph"] is False
        assert_same(rj, rep["result"], "replay result")
        assert_same(stj, rep["state"], "replay state")
        assert_same(oj, rep["out"], "replay ResidentOut")
        assert_same(ref["lookup"], rep["result"], "replay vs sharded_lookup")
        assert int(rep["out"][ranks.tsv.ResidentOut._fields.index(
            "xchg_init_rows")]) == SERVE_SLOTS
    lk = [np.concatenate([o["replay"]["lookup"][i] for o in got])
          for i in range(3)]
    assert_same(ref["lookup"], lk, "port sharded_lookup rows")


@pytest.mark.parametrize("form", list(FORMS))
def test_macro_steps_equal(form, runs):
    """Eight macro steps: every ``ResidentOut`` field (exchange counters
    included), the state, the rings and the cache after each step, on
    every rank."""
    ref, got = runs
    totals = np.zeros(3, np.int64)
    for step, rj in enumerate(ref[form]):
        for o in got:
            rt = o[form][step]
            assert_same(rj["out"], rt["out"], f"{form}: out, step {step}")
            assert_same(rj["state"], rt["state"], f"{form}: state {step}")
            assert_same(rj["rings"], rt["rings"], f"{form}: rings {step}")
            if rj["cache"] is not None:
                assert_same(rj["cache"], rt["cache"], f"{form}: cache {step}")
        out = dict(zip(ranks.tsv.ResidentOut._fields, got[0][form][step]["out"]))
        assert int(out["xchg_init_rows"]) == int(out["adm"])
        totals += [int(out["hits"]), int((out["comp"] & (out["comp_com"] < 0)
                                          ).sum()), int(out["xchg_round_rows"])]
    assert totals[2] > 0
    # The init rows that rode the exchange, counted in it and summed over
    # the ranks, are the admitted rows: hits and padding never ride it.
    adm = sum(int(dict(zip(ranks.tsv.ResidentOut._fields, s["out"]))["adm"])
              for s in got[0][form])
    assert sum(o[form + "_shipped"] for o in got) == adm
    if form == "cache_on":
        assert totals[0] > 0
    if form == "expire":
        assert totals[1] > 0


def test_gated_rounds_equal_early_exit(runs):
    """The gated routed loop (six trips a step, all run) equals the
    early-exit one, carries and outputs, step after step."""
    for o in runs[1]:
        assert o["gated"]["same"]
        assert o["gated"]["idle"] > 0


@pytest.mark.parametrize("form", ["serve_cache_off", "serve_cache_on"])
def test_serve_resident_equal(form, runs):
    """Whole reports under the virtual clock equal JAX's on every rank,
    the resident block's exchange rows included; one read a macro step;
    the final cache equal."""
    (rj, cache_j), got = runs[0][form], runs[1]
    for o in got:
        rt = dict(o[form])
        readbacks = rt.pop("readbacks")
        cache_t = rt.pop("cache")
        assert_reports_same(rj, rt, form)
        assert readbacks == rt["resident"]["iterations"]
        if cache_j is not None:
            assert_same(cache_j, cache_t, f"{form} cache")
    ex = rj["resident"]["exchange"]
    assert ex["rows_init"] == rj["admitted"] - rj["cache_hits"]
    assert ex["rows_round"] > 0 and rj["completed"] > 0


def test_refusals(runs):
    """Slots and admit cap must divide the mesh; a CUDA graph needs an
    NCCL mesh on the card (no silent eager fallback)."""
    for o in runs[1]:
        err = o["errors"]
        assert "must divide" in err["slots"]
        assert "must divide" in err["admit_cap"]
        assert "CUDA graph" in err["graph_on_gloo"]
