"""The resident engine's CUDA graphs on the card: a captured macro step
equals the eager body step for step (the output, state, rings and
cache), on the K1 and the fused engine, and the closed-loop replay
through a graph equals ``lookup``; the mesh resident engine on one rank
over NCCL captures its macro step, collectives included, equal to the
eager body, and its replay equals ``sharded_lookup(compact=False)``;
with the cost ledger's wrappers on, a capture is unchanged (the wrappers
forward while the stream captures) and each replay is one
``serve._resident_replay`` row.  Every test needs a CUDA card and
skips without one; none imports JAX (run them on the card with
``--noconftest``)."""

import numpy as np
import pytest
import torch

from opendht_tpu_torch.models import serve as sv
from opendht_tpu_torch.models import swarm as sw
from opendht_tpu_torch.ops import kernels

N_NODES, SLOTS, ADMIT = 4096, 256, 64


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs replay on the device")
    return torch.device("cuda")


def _swarm(dev):
    cfg = sw.SwarmConfig.for_nodes(N_NODES, device=dev)
    return cfg, sw.build_swarm(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)


def _same(a, b) -> bool:
    return all(torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu())
               for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("impl,cache_slots", [("auto", 0), ("auto", 128),
                                              ("fused-round", 128)])
def test_graph_macro_steps_equal_eager(impl, cache_slots):
    """Six macro steps from a 32-key pool (so the cache hits) through the
    engine's graph and through the eager body on copies of the carries;
    one readback and one replay a step, and the replays' launches
    counted."""
    dev = _need_card()
    cfg, swarm = _swarm(dev)
    cfg = cfg._replace(merge_impl=impl)
    eng = sv.ResidentServeEngine(swarm, cfg, slots=SLOTS, admit_cap=ADMIT,
                                 cache_slots=cache_slots, device=dev)
    st, rings = eng.empty(), eng.empty_rings()
    e_st, e_rings = eng.empty(), eng.empty_rings()
    e_cache = (None if eng.cache is None     # the graph updates eng.cache
               else type(eng.cache)(*[x.clone() for x in eng.cache]))
    gen = torch.Generator().manual_seed(1)
    pool = torch.randint(0, 2**32, (32, 5), generator=gen)
    eng.warm_resident()
    kernels.reset_launches()
    for step, n_new in enumerate([64, 64, 40, 0, 64, 0]):
        keys = pool[torch.randint(0, 32, (ADMIT,), generator=gen)]
        reqs = torch.arange(step * ADMIT, (step + 1) * ADMIT,
                            dtype=torch.int32)
        cls = torch.zeros(ADMIT, dtype=torch.int32)
        og = torch.randint(0, N_NODES, (ADMIT,), generator=gen,
                           dtype=torch.int32)
        st, rings, out = eng.macro_step(st, rings, keys.numpy(),
                                        reqs.numpy(), cls.numpy(), og.numpy(),
                                        n_new, 2 * step)
        args = (keys.to(dev), reqs.to(dev), cls.to(dev), og.to(dev), n_new,
                2 * step)
        if cache_slots:
            e_st, e_rings, e_cache, e_out = sv._resident_step_cached(
                swarm, cfg, e_st, e_rings, e_cache, *args,
                rounds=eng.rounds_per_iter)
        else:
            e_st, e_rings, e_out = sv._resident_step(
                swarm, cfg, e_st, e_rings, *args, rounds=eng.rounds_per_iter)
        o = eng.read_out(out)
        assert _same(o, [x.cpu().numpy() for x in e_out]), step
        assert _same(st, e_st) and _same(rings, e_rings), step
        if cache_slots:
            assert _same(eng.cache, e_cache), step
    torch.cuda.synchronize()
    assert eng.replays == 6 and eng.readbacks == 6
    graph = eng.graphs[(bool(cache_slots), eng.rounds_per_iter, True)]
    name = "fused_round" if impl == "fused-round" else "merge_round"
    per_replay = graph["launches"][name]
    assert per_replay == eng.rounds_per_iter
    assert kernels.LAUNCHES[name] >= 6 * per_replay


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "fused-round"])
def test_graph_replay_equals_lookup(impl):
    dev = _need_card()
    cfg, swarm = _swarm(dev)
    cfg = cfg._replace(merge_impl=impl)
    gen = torch.Generator(device=dev).manual_seed(2)
    tg = torch.randint(0, 2**32, (512, 5), generator=gen, device=dev)
    og = sw._sample_origins(gen, swarm.alive, 512)
    res, st, out = sv.resident_closed_loop_replay(swarm, cfg, tg, origins=og)
    look = sw.lookup(swarm, cfg, tg, origins=og)
    assert _same(res, look)
    assert np.array_equal(out.comp_req, np.arange(512))
    assert int(out.rounds_run) <= cfg.max_steps and bool(res.done.all())


@pytest.mark.cuda
@pytest.mark.parametrize("cache_slots", [0, 128])
def test_sharded_resident_graph_equals_eager(cache_slots, tmp_path):
    """The mesh resident engine on one rank over NCCL: its macro step is
    one captured graph, collectives included, and equals the eager
    early-exit body step for step; a replay counts its capture's
    collectives; the replay through the graph equals
    ``sharded_lookup(compact=False)``."""
    from opendht_tpu_torch.parallel import mesh as pm
    from opendht_tpu_torch.parallel import sharded as ps
    dev = _need_card()
    cfg, swarm = _swarm(dev)
    mesh = pm.make_mesh(1, 0, backend="nccl", device=dev,
                        init_method="file://" + str(tmp_path / "store"),
                        timeout=60.0)
    try:
        eng = sv.ShardedResidentServeEngine(swarm, cfg, SLOTS, mesh,
                                            admit_cap=ADMIT,
                                            cache_slots=cache_slots)
        assert eng.graph
        st, rings = eng.empty(), eng.empty_rings()
        e_st, e_rings = eng.empty(), eng.empty_rings()
        e_cache = (None if eng.cache is None
                   else type(eng.cache)(*[x.clone() for x in eng.cache]))
        gen = torch.Generator().manual_seed(3)
        pool = torch.randint(0, 2**32, (32, 5), generator=gen)
        eng.warm_resident()
        mesh.reset_counters()
        for step, n_new in enumerate([64, 64, 40, 0, 64, 0]):
            keys = pool[torch.randint(0, 32, (ADMIT,), generator=gen)]
            reqs = torch.arange(step * ADMIT, (step + 1) * ADMIT,
                                dtype=torch.int32)
            cls = torch.zeros(ADMIT, dtype=torch.int32)
            og = torch.randint(0, N_NODES, (ADMIT,), generator=gen,
                               dtype=torch.int32)
            st, rings, out = eng.macro_step(st, rings, keys.numpy(),
                                            reqs.numpy(), cls.numpy(),
                                            og.numpy(), n_new, 2 * step)
            o = eng.read_out(out)
            e_st, e_rings, e_cache, e_out = ps._sharded_resident_step(
                mesh, swarm, cfg, e_st, e_rings, e_cache, keys.to(dev),
                reqs.to(dev), cls.to(dev), og.to(dev), n_new, 2 * step,
                eng.capacity_factor, eng.rounds_per_iter)
            assert _same(o, [x.cpu().numpy() for x in e_out]), step
            assert _same(st, e_st) and _same(rings, e_rings), step
            if cache_slots:
                assert _same(eng.cache, e_cache), step
        graph = eng.graphs[(bool(cache_slots), eng.rounds_per_iter, True)]
        assert graph["collectives"]["all_to_all"] > 0
        assert mesh.calls["all_to_all"] >= 6 * graph["collectives"][
            "all_to_all"]
        l = 512
        g2 = torch.Generator(device=dev).manual_seed(4)
        tg = torch.randint(0, 2**32, (l, 5), generator=g2, device=dev)
        og = sw._sample_origins(g2, swarm.alive, l)
        rep = sv.ShardedResidentServeEngine(swarm, cfg, l, mesh, admit_cap=l,
                                            ring_slots=2 * l)
        res, _, out = sv.resident_closed_loop_replay(swarm, cfg, tg,
                                                     engine=rep, origins=og)
        look = ps.sharded_lookup(swarm, cfg, tg, mesh, origins=og,
                                 compact=False)
        assert _same(res, look) and int(out.xchg_init_rows) == l
    finally:
        mesh.close()


@pytest.mark.cuda
def test_ledger_forwards_under_capture():
    """Two engines on one plan, one with ``CostLedger.instrument(
    barrier=True)`` on around its capture and replays: every output,
    state and ring equal; the capture was counted as one build; the
    eager pass before the capture is one ``serve._resident_core`` row
    and each replay one ``serve._resident_replay`` row."""
    from opendht_tpu_torch.obs import ledger as lg
    dev = _need_card()
    cfg, swarm = _swarm(dev)
    gen = torch.Generator().manual_seed(3)
    pool = torch.randint(0, 2**32, (32, 5), generator=gen)
    plan = []
    for step, n_new in enumerate([64, 40, 0, 64]):
        plan.append((pool[torch.randint(0, 32, (ADMIT,), generator=gen)],
                     torch.arange(step * ADMIT, (step + 1) * ADMIT,
                                  dtype=torch.int32),
                     torch.zeros(ADMIT, dtype=torch.int32),
                     torch.randint(0, N_NODES, (ADMIT,), generator=gen,
                                   dtype=torch.int32), n_new))

    def drive(eng):
        st, rings, outs = eng.empty(), eng.empty_rings(), []
        for step, (k, r, c, o, n_new) in enumerate(plan):
            st, rings, out = eng.macro_step(st, rings, k.numpy(), r.numpy(),
                                            c.numpy(), o.numpy(), n_new,
                                            2 * step)
            outs.append(eng.read_out(out))
            outs.append([x.clone() for x in (*st, *rings)
                         if isinstance(x, torch.Tensor)])
        return outs

    plain = sv.ResidentServeEngine(swarm, cfg, slots=SLOTS, admit_cap=ADMIT,
                                   device=dev)
    plain.warm_resident()
    want = drive(plain)
    led = lg.CostLedger()
    eng = sv.ResidentServeEngine(swarm, cfg, slots=SLOTS, admit_cap=ADMIT,
                                 device=dev)
    n0 = lg.step_cache_size()
    with led.instrument(barrier=True):
        eng.warm_resident()
        n1 = lg.step_cache_size()
        got = drive(eng)
    assert all(_same(a, b) for a, b in zip(want, got))
    assert n1 - n0 == 1 and lg.step_cache_size() == n1
    rows = {k: r["calls"] for k, r in led.kernels.items() if r["calls"]}
    assert rows == {"serve._resident_core": 1,
                    "serve._resident_replay": len(plan)}
    assert eng.replays == len(plan)
