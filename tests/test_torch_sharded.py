"""The port's table-sharded lookup engines against the JAX package's, bit
for bit: gloo ranks (one process each, spawned once for the module)
against JAX's ``shard_map`` on a ``make_mesh(D)`` slice of the conftest's
8-device CPU mesh, on the same swarm, targets and per-shard origin draws
(JAX folds the shard index into its key; its draws are handed across).

* the routing core's pieces (``_bucketize``, ``_fill_buckets``,
  ``_shard_positions``, ``_rebuild_pair_window``) on random inputs with
  owners piled onto one shard;
* ``sharded_lookup`` at 4,096 nodes with 25-30 % churn in every
  formulation (while, burst with lifecycle, compacted, rebalanced) at
  ``capacity_factor`` inf / 2.0 / 0.25, with augmented and plain tables:
  ``found``, ``hops``, ``done`` and ``stats`` equal;
* ``traced_sharded_lookup`` (every trace row), ``chaos_sharded_lookup``
  (result, strikes, trace), ``data_parallel_lookup`` and
  ``contended_lookup`` (with ``dropped`` / ``attempted``);
* the identity: at ``capacity_factor=inf`` the routed engine equals the
  local engine started from the concatenated per-shard origins;
* the dispatcher at D=1 (``local_respond``) and D=2, and its refusals.

Every comparison is exact."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import swarm as jsw
from opendht_tpu.parallel import make_mesh
from opendht_tpu.parallel import sharded as js
from opendht_tpu_torch.parallel import mesh as pm
from opendht_tpu_torch.parallel import sharded as ps

import torch_sharded_ranks as ranks
from torch_port_cases import assert_same, port_cfg, port_swarm, to_torch

N, L, D = 4096, 1024, 4
INF = float("inf")
RANK_TIMEOUT, RANK_LIMIT = 30.0, 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shard_origins(key, alive, l, d):
    """JAX's per-shard origin draws, concatenated in shard order:
    ``_sample_origins(fold_in(key, me), alive, l/d)``."""
    return np.concatenate([np.asarray(jsw._sample_origins(
        jax.random.fold_in(key, me), alive, l // d)) for me in range(d)])


@pytest.fixture(scope="module")
def swarms():
    cfg = jsw.SwarmConfig.for_nodes(N)
    aug = jsw.churn(jsw.build_swarm(jax.random.PRNGKey(0), cfg),
                    jax.random.PRNGKey(1), 0.25, cfg)
    byz = jsw.corrupt_swarm(aug, jax.random.PRNGKey(9), 0.1, cfg)
    cfg_p = cfg._replace(aug_tables=False)
    plain = jsw.churn(jsw.build_swarm(jax.random.PRNGKey(5), cfg_p),
                      jax.random.PRNGKey(6), 0.3, cfg_p)
    return {"aug": (aug, cfg), "byz": (byz, cfg), "plain": (plain, cfg_p)}


# name: (engine, swarm, options).  The key is PRNGKey(10 + position).
CASES = [
    ("while_inf", "sharded", "aug", dict(cf=INF, local=True)),
    ("while_cf2", "sharded", "aug", dict(cf=2.0)),
    ("compact_inf", "sharded", "aug", dict(cf=INF, compact=True,
                                           local=True)),
    ("compact_cf025", "sharded", "aug", dict(cf=0.25, compact=True)),
    ("rebalance_inf", "sharded", "aug", dict(cf=INF, rebalance=True,
                                             local=True)),
    ("rebalance_cf025", "sharded", "aug", dict(cf=0.25, rebalance=True)),
    ("burst_lifecycle_cf2", "sharded", "aug", dict(cf=2.0, compact=False,
                                                   track=True)),
    ("compact_lifecycle_cf025", "sharded", "aug", dict(cf=0.25, compact=True,
                                                       track=True)),
    ("plain_compact_cf025", "sharded", "plain", dict(cf=0.25, compact=True)),
    ("traced_cf2", "traced", "aug", dict(cf=2.0)),
    ("chaos_random_traced", "chaos", "byz", dict(
        cf=2.0, trace=True, faults=dict(seed=11))),
    ("chaos_eclipse_drop_cf025", "chaos", "byz", dict(
        cf=0.25, trace=True, faults=dict(seed=12, eclipse=True,
                                         drop_frac=0.2))),
    ("chaos_undefended", "chaos", "byz", dict(
        cf=2.0, faults=dict(seed=13, eclipse=True, defend=False))),
    ("data_parallel", "dp", "aug", dict(cf=None)),
]


def _jax_case(kind, sw, cfg, tg, key, mesh, o):
    """JAX's outputs of one case: (result, extras dict)."""
    if kind == "sharded":
        stats = {}
        res = js.sharded_lookup(sw, cfg, tg, key, mesh,
                                capacity_factor=o["cf"],
                                compact=o.get("compact"),
                                rebalance=o.get("rebalance", False),
                                stats=stats,
                                track_lifecycle=o.get("track", False))
        return res, {"stats": stats}
    if kind == "traced":
        res, tr = js.traced_sharded_lookup(sw, cfg, tg, key, mesh,
                                           capacity_factor=o["cf"])
        return res, {"trace": tr}
    if kind == "chaos":
        out = js.chaos_sharded_lookup(
            sw, cfg, tg, key, mesh, faults=jsw.LookupFaults(**o["faults"]),
            capacity_factor=o["cf"], collect_trace=o.get("trace", False))
        ex = {"strikes": out[1]}
        if o.get("trace"):
            ex["trace"] = out[2]
        return out[0], ex
    return js.data_parallel_lookup(sw, cfg, tg, key, mesh), {}


@pytest.fixture(scope="module")
def runs(swarms):
    """Every case, both packages: the port's D=4 group (and the D=1 and
    D=2 groups) run in spawned ranks while JAX computes its side."""
    tg = jax.random.bits(jax.random.PRNGKey(3), (L, 5), jnp.uint32)
    np_sw = {k: tuple(np.asarray(x) if x is not None else None
                      for x in (sw.ids, sw.tables, sw.alive, sw.byzantine))
             for k, (sw, _) in swarms.items()}
    cfgs = {k: port_cfg(cfg)._asdict() for k, (_, cfg) in swarms.items()}
    specs = []
    for i, (name, kind, swn, o) in enumerate(CASES):
        sw = swarms[swn][0]
        key = jax.random.PRNGKey(10 + i)
        if kind == "dp":
            og = np.asarray(jsw._sample_origins(key, sw.alive, L))
        else:
            alive = sw.alive if kind != "chaos" else sw.alive & ~sw.byzantine
            og = shard_origins(key, alive, L, D)
        specs.append(dict(o, name=name, kind=kind, swarm=swn, cfg=swn,
                          targets=np.asarray(tg), origins=og))
    # The dispatcher at other sizes: D=2 compacted, D=1 local_respond and
    # routed, each against JAX on a mesh of its size.
    small = {2: [("d2_compact_cf2", dict(cf=2.0, compact=True))],
             1: [("d1_local_respond", dict(cf=2.0, compact=True,
                                           local_respond=True)),
                 ("d1_routed_inf", dict(cf=INF, local=True))]}
    small_specs = {}
    for d, cases in small.items():
        small_specs[d] = []
        for j, (name, o) in enumerate(cases):
            key = jax.random.PRNGKey(40 + 10 * d + j)
            small_specs[d].append(dict(
                o, name=name, kind="sharded", swarm="aug", cfg="aug",
                targets=np.asarray(tg),
                origins=shard_origins(key, swarms["aug"][0].alive, L, d)))
    aug_np = {"aug": np_sw["aug"]}
    with ThreadPoolExecutor(3) as ex:
        fut = ex.submit(pm.spawn, ranks.lookup_cases, D, backend="gloo",
                        device="cpu", args=(np_sw, cfgs, specs), timeout=RANK_TIMEOUT,
                        limit=RANK_LIMIT, threads=1)
        fut_small = {d: ex.submit(pm.spawn, ranks.lookup_cases, d,
                                  backend="gloo", device="cpu",
                                  args=(aug_np, cfgs, small_specs[d],
                                        "aug" if d == 2 else None),
                                  timeout=RANK_TIMEOUT, limit=RANK_LIMIT,
                                  threads=1)
                     for d in small}
        jax_out = {}
        mesh = make_mesh(D)
        for i, (name, kind, swn, o) in enumerate(CASES):
            sw, cfg = swarms[swn]
            jax_out[name] = _jax_case(kind, sw, cfg, tg,
                                      jax.random.PRNGKey(10 + i), mesh, o)
        for d, cases in small.items():
            m = make_mesh(d)
            for j, (name, o) in enumerate(cases):
                stats = {}
                res = js.sharded_lookup(
                    swarms["aug"][0], swarms["aug"][1], tg,
                    jax.random.PRNGKey(40 + 10 * d + j), m,
                    capacity_factor=o["cf"], compact=o.get("compact"),
                    local_respond=o.get("local_respond", False), stats=stats)
                jax_out[name] = (res, {"stats": stats})
        port = fut.result()
        port_small = {d: f.result() for d, f in fut_small.items()}
    return jax_out, {D: port, **port_small}


def _port_rows(outs, name, field):
    """A per-rank output concatenated in rank order (P(AXIS) rows)."""
    parts = [o[name][field] for o in outs]
    return [np.concatenate([p[i] for p in parts]) for i in range(len(parts[0]))]


def _stats_equal(sj, st_ranks, what):
    """JAX's stats dict against every rank's: scalars and width lists
    equal on every rank; lifecycle rows concatenated."""
    assert set(sj) == set(st_ranks[0]), what
    for k, v in sj.items():
        if k in ("admitted_round", "completed_round"):
            got = np.concatenate([s[k] for s in st_ranks])
            assert np.array_equal(np.asarray(v), got), f"{what}: {k}"
        else:
            for s in st_ranks:
                assert s[k] == v, f"{what}: {k} {s[k]!r} != {v!r}"


def _outs_of(runs, name):
    for d, outs in runs[1].items():
        if name in outs[0]:
            return outs
    raise KeyError(name)


ALL_NAMES = [c[0] for c in CASES] + ["d2_compact_cf2", "d1_local_respond",
                                     "d1_routed_inf"]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_sharded_engines_equal(name, runs):
    """found / hops / done (and stats, trace, strikes) of each case equal
    JAX's; the replicated outputs equal on every rank."""
    res_j, ex_j = runs[0][name]
    outs = _outs_of(runs, name)
    assert_same(res_j, _port_rows(outs, name, "result"), name)
    if "stats" in ex_j:
        _stats_equal(ex_j["stats"], [o[name]["stats"] for o in outs], name)
    if "trace" in ex_j:
        for o in outs:
            assert_same(ex_j["trace"], o[name]["trace"], f"{name} trace")
    if "strikes" in ex_j:
        for o in outs:
            assert_same([ex_j["strikes"]], [o[name]["strikes"]],
                        f"{name} strikes")


@pytest.mark.parametrize("name", [n for n in ALL_NAMES
                                  if n.endswith("_inf")])
def test_uncapped_equals_local_engine(name, runs):
    """At capacity_factor=inf the routed engine (while, compacted,
    rebalanced; D=4 and D=1) equals the local engine from the
    concatenated per-shard origins, bit for bit."""
    outs = _outs_of(runs, name)
    assert_same(_port_rows(outs, name, "local"),
                _port_rows(outs, name, "result"), name)


def test_tight_capacity_drops_and_collectives(runs):
    """cf=0.25 costs rounds (drops retry) yet finishes; the routed rounds
    ride two all_to_all a round and the while loop one pending
    all_reduce a round; the data-parallel engine runs no collective."""
    outs = runs[1][D]
    st_q = outs[0]["compact_cf025"]["stats"]
    st_i = outs[0]["compact_inf"]["stats"]
    assert st_q["rounds_dispatched"] > st_i["rounds_dispatched"]
    assert all(np.all(o["compact_cf025"]["result"][2]) for o in outs)
    calls = outs[0]["while_cf2"]["calls"]
    assert calls["all_to_all"] == 2 * calls["all_reduce_sum"] > 0
    assert outs[0]["data_parallel"]["calls"] == {}


def test_routing_pieces_equal(swarms):
    """``_bucketize`` / ``_shard_positions`` / ``_fill_buckets`` on random
    owners (70 % piled onto shard 2) and ok masks, at capacities below,
    at and above the load; ``_rebuild_pair_window`` on random wire rows
    with empty slots."""
    r = np.random.default_rng(7)
    for q, d, cap in ((200, 4, 30), (200, 4, 200), (200, 1, 200)):
        owner = np.where(r.random(q) < 0.7, min(2, d - 1),
                         r.integers(0, d, q)).astype(np.int32)
        ok = r.random(q) < 0.8
        sj = js._bucketize(jnp.asarray(owner), jnp.asarray(ok), d, cap)
        st = ps._bucketize(to_torch(owner), torch.from_numpy(ok), d, cap)
        assert_same(sj, st, f"bucketize q={q} d={d} cap={cap}")
        assert_same([js._shard_positions(jnp.asarray(owner), jnp.asarray(ok),
                                         d)],
                    [ps._shard_positions(to_torch(owner),
                                         torch.from_numpy(ok), d)],
                    "shard positions")
        pay = r.integers(-5, 1000, (q, 3)).astype(np.int32)
        assert_same([js._fill_buckets(jnp.asarray(pay), sj[0], d, cap, -1)],
                    [ps._fill_buckets(to_torch(pay), st[0], d, cap, -1)],
                    "fill buckets")
    sw, cfg = swarms["aug"]
    k, q = cfg.bucket_k, 96
    idx = r.integers(0, N, (q, 4 * k)).astype(np.uint32)
    idx[r.random((q, 4 * k)) < 0.2] = 0xFFFFFFFF
    wire = np.concatenate([np.concatenate([idx[:, h * k:(h + 1) * k] & 0xFFFF,
                                           idx[:, h * k:(h + 1) * k] >> 16],
                                          axis=1) for h in range(2)],
                          axis=1).astype(np.uint16)
    w0 = r.integers(0, cfg.n_buckets - 1, q).astype(np.int32)
    out_j = js._rebuild_pair_window(jnp.asarray(wire), jnp.asarray(w0),
                                    sw.ids, cfg.n_nodes, k)
    out_t = ps._rebuild_pair_window(
        torch.from_numpy(wire.astype(np.int64)), to_torch(w0),
        to_torch(np.asarray(sw.ids)), cfg.n_nodes, k)
    assert_same([out_j], [out_t], "rebuilt pair window")


def test_contended_lookup_equal(swarms):
    """The capacity rule on one device: a hot-key batch (half the targets
    one of 4 keys) at cf 0.5 over 4 logical shards — result, dropped and
    attempted equal JAX's; drops happen."""
    sw, cfg = swarms["aug"]
    tg = np.array(jax.random.bits(jax.random.PRNGKey(21), (256, 5),
                                    jnp.uint32))
    tg[::2] = tg[np.arange(0, 256, 2) % 8]
    key = jax.random.PRNGKey(22)
    out_j = js.contended_lookup(sw, cfg, jnp.asarray(tg), key, 4, 0.5)
    og = torch.from_numpy(np.array(jsw._sample_origins(key, sw.alive, 256)))
    out_t = ps.contended_lookup(port_swarm(sw), port_cfg(cfg), to_torch(tg),
                                4, 0.5, origins=og, device="cpu")
    assert_same(out_j[0], out_t[0], "contended result")
    assert_same(out_j[1:], out_t[1:], "dropped / attempted")
    assert int(out_t[1]) > 0


def test_dispatch_refusals(runs):
    """A 2-rank group refuses what JAX refuses or cannot shard: a rank
    holding the whole table, rows that do not divide the mesh,
    rebalance without compaction, lifecycle with rebalance,
    ``local_respond`` over 2 ranks, serve slots / admit caps that do not
    divide the mesh; a mismatched collective fails within the timeout
    instead of hanging; NCCL needs a card per rank."""
    for o in runs[1][2]:
        err = dict(o["errors"])
        assert err.pop("transport") == "gloo on cpu"
        assert all(v is not None for v in err.values()), err
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        pm.spawn(ranks.hang_one_rank, 2, backend="gloo", device="cpu",
                 timeout=2.0, limit=60.0, threads=1)
    with pytest.raises(ValueError, match="card per rank|CUDA"):
        pm.make_mesh(2, 0, backend="nccl", device="cuda",
                     init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="backend"):
        pm.make_mesh(1, 0, backend="mpi", device="cpu",
                     init_method="file:///nonexistent")
