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
