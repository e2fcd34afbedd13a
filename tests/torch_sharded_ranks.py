"""Rank bodies of the sharded-engine tests: what each spawned rank runs.

The tests spawn one group of gloo ranks per module
(:func:`opendht_tpu_torch.parallel.mesh.spawn`) and hand it numpy
inputs — the JAX package's swarm arrays, targets and per-shard origin
draws; each rank builds its shard, runs every case and returns numpy
outputs (its rows of each result, and what every rank should hold
alike).  This module imports no JAX: the children import it by name.
"""

import numpy as np
import torch

from opendht_tpu_torch.convert import swarm_from_numpy, swarm_shard_from_numpy
from opendht_tpu_torch.models import monitor as tm
from opendht_tpu_torch.models import serve as tsv
from opendht_tpu_torch.models import swarm as tsw
from opendht_tpu_torch.parallel import mesh as pm
from opendht_tpu_torch.parallel import sharded as ps


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def _rows(mesh, x):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return pm.shard_rows(mesh, x)


def _u32(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def lookup_cases(mesh, swarms, cfgs, cases, errors_on=None):
    """Run each lookup case on this rank → ``{name: outputs}`` (and, with
    ``errors_on`` naming a swarm, :func:`dispatch_errors` on it under
    ``"errors"``).

    ``swarms[name] = (ids, tables, alive, byzantine)`` numpy arrays;
    ``cfgs[name]`` a SwarmConfig as a dict; a case names its swarm,
    config, engine (``kind``: ``sharded`` / ``traced`` / ``chaos`` /
    ``dp``), global targets and origins, and the engine's options."""
    shards, wholes = {}, {}
    for name, (ids, tables, alive, byz) in swarms.items():
        shards[name] = swarm_shard_from_numpy(ids, tables, alive, byz,
                                              rank=mesh.rank, size=mesh.size,
                                              device="cpu")
        wholes[name] = (ids, tables, alive, byz)
    out = {}
    for c in cases:
        cfg = tsw.SwarmConfig(**cfgs[c["cfg"]])
        tg = _rows(mesh, _u32(c["targets"]))
        og = _rows(mesh, c["origins"])
        kind = c["kind"]
        rec = {}
        if kind == "sharded":
            stats = {}
            res = ps.sharded_lookup(
                shards[c["swarm"]], cfg, tg, mesh, origins=og,
                capacity_factor=c["cf"], compact=c.get("compact"),
                rebalance=c.get("rebalance", False), stats=stats,
                track_lifecycle=c.get("track", False),
                local_respond=c.get("local_respond", False))
            rec["stats"] = _np(stats)
        elif kind == "traced":
            res, trace = ps.traced_sharded_lookup(
                shards[c["swarm"]], cfg, tg, mesh, origins=og,
                capacity_factor=c["cf"])
            rec["trace"] = _np(list(trace))
        elif kind == "chaos":
            faults = tsw.LookupFaults(**c["faults"])
            out_c = ps.chaos_sharded_lookup(
                shards[c["swarm"]], cfg, tg, mesh, faults=faults,
                origins=og, capacity_factor=c["cf"],
                collect_trace=c.get("trace", False))
            res = out_c[0]
            rec["strikes"] = _np(out_c[1])
            if c.get("trace", False):
                rec["trace"] = _np(list(out_c[2]))
        elif kind == "dp":
            whole = swarm_from_numpy(*wholes[c["swarm"]][:3], device="cpu")
            res = ps.data_parallel_lookup(whole, cfg, tg, mesh, origins=og)
        else:
            raise ValueError(kind)
        rec["result"] = _np(list(res))
        if c.get("local"):
            # The identity: the local engine on the whole swarm from the
            # concatenated per-rank origins, this rank's rows (each rank
            # runs its rows of the batch: rows are independent).
            whole = swarm_from_numpy(*wholes[c["swarm"]][:3], device="cpu")
            loc = tsw.lookup(whole, cfg, tg, origins=og, compact=False,
                             device="cpu")
            rec["local"] = _np(list(loc))
        rec["calls"] = dict(mesh.calls)
        mesh.reset_counters()
        out[c["name"]] = rec
    if errors_on is not None:
        ids, tables, alive, _ = swarms[errors_on]
        out["errors"] = dispatch_errors(mesh, ids, tables, alive,
                                        cfgs[errors_on])
    return out


def dispatch_errors(mesh, ids, tables, alive, cfg_d):
    """The refusals of a 2-rank mesh: a rank holding the whole table, a
    batch that does not divide the mesh, rebalance without compaction,
    lifecycle with rebalance, ``local_respond`` on more than one rank,
    and serve slots that do not divide the mesh."""
    cfg = tsw.SwarmConfig(**cfg_d)
    whole = swarm_from_numpy(ids, tables, alive, device="cpu")
    shard = swarm_shard_from_numpy(ids, tables, alive, rank=mesh.rank,
                                   size=mesh.size, device="cpu")
    tg = torch.zeros((8, 5), dtype=torch.int64)
    og = torch.zeros((8,), dtype=torch.int32)
    calls = {
        "whole_table": lambda: ps.sharded_lookup(whole, cfg, tg, mesh,
                                                 origins=og),
        "odd_rows": lambda: pm.shard_rows(mesh, torch.zeros((7, 5))),
        "rebalance_uncompacted": lambda: ps.sharded_lookup(
            shard, cfg, tg, mesh, origins=og, rebalance=True, compact=False),
        "lifecycle_rebalance": lambda: ps.sharded_lookup(
            shard, cfg, tg, mesh, origins=og, rebalance=True,
            track_lifecycle=True),
        "local_respond": lambda: ps.sharded_lookup(
            shard, cfg, tg, mesh, origins=og, local_respond=True),
        "serve_slots": lambda: tsv.ShardedServeEngine(shard, cfg, 63, mesh),
        "serve_admit_cap": lambda: tsv.ShardedServeEngine(
            shard, cfg, 64, mesh, admit_cap=31),
    }
    out = {}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["transport"] = mesh.transport
    return out


def virtual_clock(step: float = 0.002):
    """``tests/conftest.py``'s deterministic (clock, sleep) pair, copied
    (that module imports JAX): every read advances time by ``step``."""
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]

    def sleep(s):
        t[0] += s

    return clock, sleep


def serve_cases(mesh, swarm_np, cfg_d, spec):
    """The sharded serve engine on this rank: a closed-loop replay, a
    cache-probed admission, and whole open-loop runs (cache off and on)
    under the virtual clock with the given admission origins."""
    cfg = tsw.SwarmConfig(**cfg_d)
    shard = swarm_shard_from_numpy(*swarm_np, rank=mesh.rank, size=mesh.size,
                                   device="cpu")
    out = {}
    r = spec["replay"]
    eng = tsv.ShardedServeEngine(shard, cfg, slots=len(r["targets"]),
                                 mesh=mesh, admit_cap=len(r["targets"]),
                                 capacity_factor=r["cf"])
    res, st = tsv.closed_loop_replay(shard, cfg, _u32(r["targets"]),
                                     engine=eng,
                                     origins=torch.from_numpy(r["origins"]))
    out["replay"] = _np(list(res)) + [_np(list(st))]
    p = spec["probe"]
    eng = tsv.ShardedServeEngine(shard, cfg, slots=p["slots"], mesh=mesh,
                                 admit_cap=p["admit_cap"],
                                 cache_slots=p["cache_slots"])
    st0 = eng.empty()
    eng.fill_cache(p["fill_keys"], p["fill_found"], p["fill_hops"], 0)
    st1, h, f, hp = eng.admit_probed(st0, p["keys"], p["slots_of"],
                                     p["origins"], 3)
    out["probe"] = {"state": _np(list(st1)), "hit": h, "found": f,
                    "hops": hp, "xchg": eng.xchg_init_rows,
                    "sent": int(eng.init_exchange["attempted"]),
                    "dropped": int(eng.init_exchange["dropped"]),
                    "cache": _np(list(eng.cache))}
    for form in spec["loops"]:
        eng = tsv.ShardedServeEngine(shard, cfg, slots=form["slots"],
                                     mesh=mesh, admit_cap=form["admit_cap"],
                                     cache_slots=form["cache_slots"])
        clock, sleep = virtual_clock()
        origins = form["origins"]
        rep = tsv.serve_open_loop(
            eng, form["ts"], form["keys"], klass=form["klass"], clock=clock,
            sleep=sleep, origins_of=lambda i: torch.from_numpy(origins[i]))
        rep["xchg_init_rows"] = eng.xchg_init_rows
        rep["cache"] = None if eng.cache is None else _np(list(eng.cache))
        out[form["name"]] = rep
    out["calls"] = dict(mesh.calls)
    return out


def monitor_sweeps(mesh, swarm_np, cfg_d, plan):
    """Sweeps of ``MonitorEngine(mesh=)`` on this rank: before each
    sweep after the first, a kill from the given uniforms and a heal
    from the given per-bucket draws; each sweep's origins given."""
    cfg = tsw.SwarmConfig(**cfg_d)
    shard = swarm_shard_from_numpy(*swarm_np, rank=mesh.rank, size=mesh.size,
                                   device="cpu")
    eng = tm.MonitorEngine(shard, cfg, mesh=mesh)
    out = []
    for step in plan:
        if "kill" in step:
            eng.kill(step["frac"], torch.from_numpy(step["kill"]))
            heal = step["heal"]
            eng.heal(lambda b: torch.from_numpy(heal[b]))
        buckets = eng.select_buckets()
        rec, res = eng.sweep(origins=torch.from_numpy(step["origins"]))
        out.append({"buckets": buckets, "record": rec,
                    "result": _np(list(res)),
                    "fresh": _np(list(eng.fresh)),
                    "table": eng.swarm.tables.numpy().copy()})
    return {"sweeps": out, "hop_hist": eng.hop_hist}


def hang_one_rank(mesh):
    """Rank 0 enters a collective that rank 1 never joins: rank 0's
    collective must time out and fail the run (rank 1 is killed)."""
    if mesh.rank == 1:
        import time
        time.sleep(600)
    mesh.all_reduce(torch.zeros(1))


# ---------------------------------------------------------------------------
# the node-sharded store, the sharded index, the mesh resident engine
# ---------------------------------------------------------------------------

def _rows_of(mesh, x):
    """This rank's rows of a host array or tensor (None stays None)."""
    if x is None:
        return None
    return _rows(mesh, x if isinstance(x, torch.Tensor) else _t(x))


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                            else np.ascontiguousarray(x))


def _store_np(store):
    return [x.numpy().copy() for x in store]


def storage_steps(mesh, swarm_np, cfg_d, scfg_d, steps):
    """Run a sequence of sharded storage ops on this rank, from a store
    made by ``store_shard_from_numpy`` of the first step's whole store.
    Every step's inputs are the whole batch's (host arrays); the rank
    takes its rows.  Returns per step this rank's store leaves and the
    op's outputs (this rank's rows; traces mesh-global)."""
    from opendht_tpu_torch.convert import store_shard_from_numpy
    from opendht_tpu_torch.models import storage as tst
    from opendht_tpu_torch.parallel import sharded_storage as ss
    cfg = tsw.SwarmConfig(**cfg_d)
    scfg = tst.StoreConfig(**scfg_d)
    ids, tables, alive = swarm_np[:3]
    shard = swarm_shard_from_numpy(ids, tables, alive, rank=mesh.rank,
                                   size=mesh.size, device="cpu")
    store = None
    out = []
    r = lambda x: _rows_of(mesh, x)  # noqa: E731
    for st in steps:
        op = st["op"]
        rec = {}
        if op == "load":
            store = store_shard_from_numpy(*st["store"], rank=mesh.rank,
                                           size=mesh.size, device="cpu")
        elif op == "empty":
            store = ss.sharded_empty_store(cfg.n_nodes, scfg, mesh)
        elif op == "alive":
            shard = shard._replace(alive=torch.from_numpy(st["alive"]))
        elif op == "announce":
            store, rep = ss.sharded_announce(
                shard, cfg, store, scfg, r(st["keys"]), r(st["vals"]),
                r(st["seqs"]), st["now"], mesh,
                capacity_factor=st["cf"], sizes=r(st.get("sizes")),
                ttls=r(st.get("ttls")), payloads=r(st.get("payloads")),
                probe=st.get("probe", False),
                full_capacity_factor=st.get("fcf"),
                drop_frac=st.get("drop", 0.0), drop_keep=r(st.get("keep")),
                origins=r(st["origins"]))
            rec["report"] = _np(list(rep[:3])) + [_np(list(rep.trace))]
        elif op == "get":
            res = ss.sharded_get(shard, cfg, store, scfg, r(st["keys"]), mesh,
                                 capacity_factor=st["cf"],
                                 origins=r(st["origins"]))
            rec["result"] = _np(list(res))
        elif op == "listen":
            store, done = ss.sharded_listen_at(
                shard, cfg, store, scfg, r(st["keys"]), r(st["ids"]), mesh,
                capacity_factor=st["cf"], now=st["now"],
                origins=r(st["origins"]))
            rec["done"] = _np(done)
        elif op == "republish":
            og, kp = st["origins"], st.get("keeps")
            store, rep = ss.sharded_republish(
                shard, cfg, store, scfg, st["now"], mesh,
                capacity_factor=st["cf"], probe=st.get("probe", False),
                full_capacity_factor=st.get("fcf"), chunk=st["chunk"],
                node_range=st.get("node_range"), drop_frac=st.get("drop", 0.0),
                origins_of=lambda i: r(og[i]),
                drop_keep_of=None if kp is None else (lambda i: r(kp[i])))
            rec["report"] = _np(list(rep[:3])) + [_np(list(rep.trace))]
        elif op == "expire":
            store = ss.sharded_expire(store, scfg, st["now"])
        elif op == "cancel":
            store = ss.sharded_cancel_listen(store, scfg, _t(st["ids"]))
        elif op == "ack":
            store = ss.sharded_ack_listeners(store, _t(st["ids"]))
        elif op == "refresh":
            store = ss.sharded_refresh_listeners(store, scfg,
                                                 _t(st["active"]), st["now"])
        elif op == "expire_listeners":
            store = ss.sharded_expire_listeners(store, scfg, st["now"])
        elif op == "announce_chunked":
            kp = st.get("keeps")
            store, rep = ss.sharded_announce_chunked(
                shard, cfg, store, scfg, r(st["keys"]), r(st["vals"]),
                r(st["seqs"]), st["now"], mesh, r(st["payloads"]),
                r(st["lengths"]), capacity_factor=st["cf"],
                drop_frac=st.get("drop", 0.0),
                part_drop_mask=r(st.get("part_drop")),
                part_range=st.get("part_range"), origins=r(st["origins"]),
                drop_keep_of=None if kp is None else (lambda j: r(kp[j])))
            rec["report"] = _np(list(rep[:3])) + [_np(list(rep.trace))]
        elif op == "get_chunked":
            res = ss.sharded_get_chunked(shard, cfg, store, scfg,
                                         r(st["keys"]), mesh, st["parts"],
                                         capacity_factor=st["cf"],
                                         origins=r(st["origins"]))
            rec["result"] = _np(list(res))
        elif op == "listen_chunked":
            store, done = ss.sharded_listen_chunked(
                shard, cfg, store, scfg, r(st["keys"]), r(st["ids"]), mesh,
                st["parts"], capacity_factor=st["cf"], now=st["now"],
                origins=r(st["origins"]))
            rec["done"] = _np(done)
        elif op == "collect_chunked":
            res = ss.sharded_collect_chunked(store, scfg, _t(st["ids"]),
                                             st["parts"])
            rec["result"] = _np(list(res))
        elif op == "ack_chunked":
            store = ss.sharded_ack_chunked(store, _t(st["ids"]), st["parts"])
        elif op == "cancel_chunked":
            store = ss.sharded_cancel_chunked(store, scfg, _t(st["ids"]),
                                              st["parts"])
        elif op == "wire":
            rec["words"] = ss.storage_wire_words(
                cfg, scfg, st["p"], mesh.size, st["cf"],
                probe=st.get("probe", False),
                full_capacity_factor=st.get("fcf"))
        else:
            raise ValueError(op)
        rec["store"] = None if store is None else _store_np(store)
        out.append(rec)
    return {"steps": out, "calls": dict(mesh.calls)}


def index_build(mesh, swarm_np, cfg_d, scfg_d, spec_args, width, keys, ehash,
                evid, draws, ranges):
    """The sharded PHT index on this rank: an insert batch, a walk and a
    range scan, every store batch padded to ``width`` rows (the JAX
    side's one batch shape) and each op's origins given whole."""
    from opendht_tpu_torch.models import index as ti
    from opendht_tpu_torch.models import storage as tst
    from opendht_tpu_torch.parallel import sharded_index as si
    from opendht_tpu_torch.parallel import sharded_storage as ss
    ti._pow2_width = (lambda m, floor=16:
                      max(width, tst.pow2_width(m, floor)))
    cfg = tsw.SwarmConfig(**cfg_d)
    scfg = tst.StoreConfig(**scfg_d)
    shard = swarm_shard_from_numpy(*swarm_np[:3], rank=mesh.rank,
                                   size=mesh.size, device="cpu")
    spec = ti.IndexSpec.from_key_spec(*spec_args)
    ix = si.ShardedDeviceIndex(
        shard, cfg, ss.sharded_empty_store(cfg.n_nodes, scfg, mesh), scfg,
        spec, mesh, draws=lambda op, p: torch.from_numpy(draws[op][:p]))
    ins = ix.insert_batch(keys, ehash, evid)
    found = ix.lookup_batch(keys[:4])
    lo, hi = ranges
    scan = ix.range_query(ix.linearize(lo), ix.linearize(hi))
    return {"insert": ins, "lookup": found, "scan": scan,
            "stats": dict(ix.stats), "trie": ix.trie_snapshot(),
            "store": _store_np(ix.store), "ops": ix._op}


def resident_cases(mesh, swarm_np, cfg_d, spec):
    """The mesh resident engine on this rank: the closed-loop replay
    (and ``sharded_lookup(compact=False)`` from the same origins), macro
    steps of each form with their outputs and carries, the gated round
    loop against the early-exit one, whole ``serve_resident`` reports
    under the virtual clock, and the engine's refusals.  Origins are the
    whole batch's (JAX's per-shard draws, concatenated)."""
    cfg = tsw.SwarmConfig(**cfg_d)
    shard = swarm_shard_from_numpy(*swarm_np, rank=mesh.rank, size=mesh.size,
                                   device="cpu")
    out = {}
    r = spec["replay"]
    l = len(r["targets"])
    eng = tsv.ShardedResidentServeEngine(shard, cfg, l, mesh, admit_cap=l,
                                         ring_slots=2 * l,
                                         capacity_factor=r["cf"])
    res, st, o = tsv.resident_closed_loop_replay(
        shard, cfg, _u32(r["targets"]), engine=eng,
        origins=torch.from_numpy(r["origins"]))
    lk = ps.sharded_lookup(shard, cfg, _rows(mesh, _u32(r["targets"])), mesh,
                           origins=_rows(mesh, r["origins"]),
                           capacity_factor=r["cf"], compact=False)
    out["replay"] = {"result": _np(list(res)), "state": _np(list(st)),
                     "out": list(o), "lookup": _np(list(lk)),
                     "graph": eng.graph}
    for form in spec["forms"]:
        c = cfg._replace(**form.get("cfg", {}))
        eng = tsv.ShardedResidentServeEngine(
            shard, c, form["slots"], mesh, admit_cap=form["admit_cap"],
            ring_slots=form["ring"], cache_slots=form.get("cache_slots", 0))
        st, rings = eng.empty(), eng.empty_rings()
        steps = []
        for keys, reqs, cls, og, n_new, rnd0 in form["steps"]:
            st, rings, o = eng.macro_step(st, rings, keys, reqs, cls,
                                          torch.from_numpy(og), n_new, rnd0)
            steps.append({"out": list(eng.read_out(o)), "state": _np(list(st)),
                          "rings": _np(list(rings)),
                          "cache": None if eng.cache is None
                          else _np(list(eng.cache))})
        out[form["name"]] = steps
        out[form["name"] + "_shipped"] = int(eng.init_shipped)
    g = spec["gated"]
    eng = tsv.ShardedResidentServeEngine(shard, cfg, g["slots"], mesh,
                                         admit_cap=g["admit_cap"],
                                         cache_slots=g["cache_slots"])
    carry = {k: (eng.empty(), eng.empty_rings(), eng.cache)
             for k in (False, True)}
    same, idle = True, 0
    for keys, reqs, cls, og, n_new, rnd0 in g["steps"]:
        outs = {}
        for k, (st, rings, cache) in carry.items():
            st, rings, cache, o = ps._sharded_resident_step(
                mesh, shard, cfg, st, rings, cache, _u32(keys), _t(reqs),
                _t(cls), torch.from_numpy(og), n_new, rnd0, 2.0,
                g["rounds"], True, gated=k)
            carry[k] = (st, rings, cache)
            outs[k] = o
        for a, b in list(zip(carry[False], carry[True])) + [
                (outs[False], outs[True])]:
            if a is not None:
                same &= all(torch.equal(x, y) for x, y in zip(a, b))
        idle += g["rounds"] - int(outs[True].rounds_run)
    out["gated"] = {"same": same, "idle": idle}
    for form in spec["serve"]:
        eng = tsv.ShardedResidentServeEngine(
            shard, cfg, form["slots"], mesh, admit_cap=form["admit_cap"],
            ring_slots=form["ring"], cache_slots=form["cache_slots"])
        clock, sleep = virtual_clock()
        origins = form["origins"]
        rep = tsv.serve_resident(
            eng, form["ts"], form["keys"], klass=form["klass"], clock=clock,
            sleep=sleep, origins_of=lambda i: torch.from_numpy(origins[i]))
        rep["readbacks"] = eng.readbacks
        rep["cache"] = None if eng.cache is None else _np(list(eng.cache))
        out[form["name"]] = rep
    errors = {}
    for name, fn in {
        "slots": lambda: tsv.ShardedResidentServeEngine(shard, cfg, 63, mesh),
        "admit_cap": lambda: tsv.ShardedResidentServeEngine(
            shard, cfg, 64, mesh, admit_cap=31, ring_slots=64),
        "graph_on_gloo": lambda: tsv.ShardedResidentServeEngine(
            shard, cfg, 64, mesh, graph=True),
    }.items():
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    out["calls"] = dict(mesh.calls)
    return out
