"""The port's chaos engine (Byzantine responders, reply loss, the
strike/blacklist defence) against the JAX package's, bit for bit: the
fault hash, the colluder pool, one adversarial round, whole
``chaos_lookup`` runs (compacted or not, random or eclipse poison,
defended or not, with reply loss), every trace row, the deferred
blacklist passes, ``corrupt_swarm`` and ``honest_recall``.  The JAX
swarm, Byzantine mask and origins are handed across; every comparison
is exact.  The shapes are ``tests/test_chaos_lookup.py``'s."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import swarm as jsw
from opendht_tpu_torch.convert import state_from_numpy, swarm_from_numpy
from opendht_tpu_torch.models import swarm as tsw

from torch_port_cases import as_int64, assert_same, to_torch

N, NL = 2048, 128
CFG_J = jsw.SwarmConfig.for_nodes(N)
CFG_T = tsw.SwarmConfig.for_nodes(N, device="cpu")
KEY_RUN = jax.random.PRNGKey(4)


def to_port(sw):
    byz = None if sw.byzantine is None else np.asarray(sw.byzantine)
    return swarm_from_numpy(np.asarray(sw.ids), np.asarray(sw.tables),
                            np.asarray(sw.alive), byz, device="cpu")


@pytest.fixture(scope="module")
def byz_swarm():
    sw = jsw.build_swarm(jax.random.PRNGKey(7), CFG_J)
    return jsw.corrupt_swarm(sw, jax.random.PRNGKey(3), 0.05, CFG_J)


@pytest.fixture(scope="module")
def targets():
    return jax.random.bits(jax.random.PRNGKey(1), (NL, 5), jnp.uint32)


def honest_origins(sw, key=KEY_RUN, l=NL):
    """JAX's chaos origins: uniform over the honest alive nodes."""
    honest = sw.alive & ~sw.byzantine
    return torch.from_numpy(np.array(jsw._sample_origins(key, honest, l)))


@pytest.fixture(scope="module")
def jax_chaos(byz_swarm, targets):
    """JAX's uncompacted chaos run on the module's swarm and targets,
    once per (faults, trace) — its own tests hold the compacted run
    equal to it."""
    runs = {}

    def run(faults, trace=False):
        if (faults, trace) not in runs:
            runs[faults, trace] = jsw.chaos_lookup(
                byz_swarm, CFG_J, targets, KEY_RUN, faults,
                collect_trace=trace, compact=False)
        return runs[faults, trace]

    return run


@pytest.mark.parametrize("seed", [0, 5, 0x517CC1B7, 2**32 - 1, 2**40 + 3])
def test_fault_hash_elementwise(seed):
    """The u32 hash on edge values (0, 2^32-1) and random ones, as int
    and as tensor round indices, across seeds."""
    r = np.random.default_rng(seed & 0xFFFF)
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    x = np.concatenate([edge, r.integers(0, 2**32, 59, dtype=np.uint32)])
    y = np.concatenate([edge[::-1], r.integers(0, 2**32, 59,
                                               dtype=np.uint32)])
    for rnd in (0, 7, 47):
        want = jsw._fault_hash(jnp.asarray(x), jnp.asarray(y),
                               jnp.int32(rnd), seed)
        assert_same([want], [tsw._fault_hash(to_torch(x), to_torch(y), rnd,
                                             seed)], f"hash rnd={rnd}")
        got = tsw._fault_hash(to_torch(x)[:, None], to_torch(y)[None, :],
                              torch.tensor(rnd), seed)
        want = jsw._fault_hash(jnp.asarray(x)[:, None],
                               jnp.asarray(y)[None, :], jnp.int32(rnd), seed)
        assert_same([want], [got], f"hash broadcast rnd={rnd}")


@pytest.mark.parametrize("frac", [0.0, 0.05, 1.0])
def test_byz_colluder_pool(frac):
    mask = np.random.default_rng(3).random(N) < frac
    pool_j, n_j = jsw.byz_colluder_pool(jnp.asarray(mask))
    pool_t, n_t = tsw.byz_colluder_pool(torch.from_numpy(mask))
    assert_same([pool_j, n_j], [pool_t, n_t], f"pool frac={frac}")


def test_corrupt_swarm_mask_and_honest_recall(byz_swarm, targets,
                                              jax_chaos):
    """``corrupt_swarm`` takes JAX's mask as it is, its own draw hits
    about the fraction asked, and ``honest_recall`` (K3's plain version
    with alive & ~byzantine) equals JAX's on a chaos result."""
    sw_t = to_port(byz_swarm._replace(byzantine=None))
    got = tsw.corrupt_swarm(sw_t, None, 0.05, CFG_T,
                            mask=torch.from_numpy(
                                np.array(byz_swarm.byzantine)))
    assert np.array_equal(got.byzantine.numpy(),
                          np.asarray(byz_swarm.byzantine))
    drawn = tsw.corrupt_swarm(sw_t, torch.Generator().manual_seed(0), 0.05,
                              CFG_T)
    assert 0.03 < float(drawn.byzantine.float().mean()) < 0.07
    assert tsw.honest_recall(sw_t, CFG_T, tsw.LookupResult(
        torch.full((4, 8), -1, dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool)),
        to_torch(targets)[:4]).eq(0).all()
    faults = jsw.LookupFaults(eclipse=True, seed=5)
    res_j, _ = jax_chaos(faults)
    res_t = tsw.LookupResult(*(to_torch(np.asarray(x)) for x in res_j))
    want = jsw.honest_recall(byz_swarm, CFG_J, res_j, targets)
    got = tsw.honest_recall(got, CFG_T, res_t, to_torch(targets))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("eclipse,defend,drop",
                         [(False, True, 0.0), (True, False, 0.0),
                          (True, True, 0.3)])
def test_chaos_step_bit_equal(eclipse, defend, drop, byz_swarm, targets):
    """Three rounds of ``chaos_lookup_step`` from the same state and
    strikes (a few nodes pre-struck, one at the limit): state, strikes
    and every trace row."""
    faults_j = jsw.LookupFaults(drop_frac=drop, eclipse=eclipse, seed=5,
                                defend=defend)
    faults_t = tsw.LookupFaults(*faults_j)
    origins = honest_origins(byz_swarm)
    st_j = jsw.chaos_lookup_init(byz_swarm, CFG_J, targets,
                                 jnp.asarray(origins.numpy()))
    st_t = state_from_numpy(*(np.asarray(x) for x in st_j[:6]),
                            device="cpu")
    strikes = np.zeros(N, np.int32)
    strikes[np.random.default_rng(1).integers(0, N, 64)] = 2
    strikes[:8] = 3
    sk_j, sk_t = jnp.asarray(strikes), torch.from_numpy(strikes.copy())
    tr_j = jsw.empty_lookup_trace(CFG_J)
    tr_t = tsw.empty_lookup_trace(CFG_T, "cpu")
    sw_t = to_port(byz_swarm)
    aux_j = jsw.byz_colluder_pool(byz_swarm.byzantine) if eclipse else None
    aux_t = tsw.byz_colluder_pool(sw_t.byzantine) if eclipse else None
    for rnd in range(3):
        st_j, sk_j, tr_j = jsw.chaos_lookup_step(
            byz_swarm, CFG_J, faults_j, st_j, sk_j, jnp.int32(rnd), aux_j,
            trace=tr_j)
        st_t, sk_t, tr_t = tsw.chaos_lookup_step(
            sw_t, CFG_T, faults_t, st_t, sk_t, rnd, aux_t, trace=tr_t)
        assert_same(st_j, st_t, f"state round {rnd}")
        assert_same([sk_j], [sk_t], f"strikes round {rnd}")
    assert_same(tr_j, tr_t, "step trace")
    if defend:
        assert int(tr_t.poison.sum()) > 0 and int(tr_t.strikes.sum()) > 0


CHAOS_CASES = [(compact, eclipse, defend)
               for compact in (True, False)
               for eclipse in (False, True)
               for defend in (True, False)]


@pytest.mark.parametrize("compact,eclipse,defend", CHAOS_CASES)
def test_chaos_lookup_bit_equal(compact, eclipse, defend, byz_swarm,
                                targets, jax_chaos):
    """found, hops, done and strikes against JAX's uncompacted run."""
    faults = jsw.LookupFaults(eclipse=eclipse, seed=5, defend=defend)
    res_j, sk_j = jax_chaos(faults)
    res_t, sk_t = tsw.chaos_lookup(
        to_port(byz_swarm), CFG_T, to_torch(targets),
        faults=tsw.LookupFaults(*faults), origins=honest_origins(byz_swarm),
        compact=compact, device="cpu")
    assert_same(res_j, res_t, f"results {faults}")
    assert_same([sk_j], [sk_t], f"strikes {faults}")
    assert bool(res_t.done.all())


@pytest.fixture(params=["jax", "port"])
def ct(request):
    """The JAX package's artifact checker and the port's own copy."""
    if request.param == "jax":
        from opendht_tpu.tools import check_trace
    else:
        from opendht_tpu_torch.tools import check_trace
    return check_trace


@pytest.fixture(scope="module")
def port_drop_traced(byz_swarm, targets):
    """The port's traced and untraced runs of reply loss 0.3 with
    Byzantine responders, once per ``compact``."""
    runs = {}

    def run(compact):
        if compact not in runs:
            sw_t, tg_t = to_port(byz_swarm), to_torch(targets)
            faults = tsw.LookupFaults(drop_frac=0.3, eclipse=False, seed=11)
            stats = {}
            traced = tsw.chaos_lookup(
                sw_t, CFG_T, tg_t, faults=faults,
                origins=honest_origins(byz_swarm), collect_trace=True,
                compact=compact, stats=stats, track_lifecycle=True,
                device="cpu")
            plain = tsw.chaos_lookup(sw_t, CFG_T, tg_t, faults=faults,
                                     origins=honest_origins(byz_swarm),
                                     compact=compact, device="cpu")
            runs[compact] = traced, stats, plain
        return runs[compact]

    return run


@pytest.mark.parametrize("compact", [True, False])
def test_chaos_lookup_drop_traced_bit_equal(compact, jax_chaos,
                                            port_drop_traced, ct):
    """Reply loss 0.3 with Byzantine responders, the flight recorder on:
    results, strikes and every trace row (``poison``, ``strikes`` and
    ``convictions`` included) against JAX's traced run; the untraced
    port run agrees; the lifecycle rounds ride along; and the port's
    ``trace_to_dict``, wrapped as ``bench.py``'s ``dump_trace`` writes
    it, passes the trace checker, JAX's and the port's."""
    faults = jsw.LookupFaults(drop_frac=0.3, eclipse=False, seed=11)
    res_j, sk_j, tr_j = jax_chaos(faults, trace=True)
    (res_t, sk_t, tr_t), stats, plain = port_drop_traced(compact)
    assert_same(res_j, res_t, "traced results")
    assert_same([sk_j], [sk_t], "traced strikes")
    assert_same(tr_j, tr_t, f"trace compact={compact}")
    assert int(tr_t.poison.sum()) > 0 and int(tr_t.drops.sum()) > 0
    assert int(tr_t.convictions[int(tr_t.rounds) - 1]) > 0
    assert_same(list(res_t) + [sk_t], list(plain[0]) + [plain[1]],
                "traced vs untraced")
    assert bool((stats["completed_round"] >= 0).all())
    assert bool((stats["admitted_round"] == 0).all())
    hist = tsw.hop_histogram(res_t.hops, CFG_T.max_steps)
    obj = {"kind": "swarm_lookup_trace",
           "bench": {"n_lookups": NL,
                     "done_frac": float(res_t.done.float().mean())},
           "trace": tsw.trace_to_dict(tr_t, NL),
           "hop_histogram": [int(v) for v in hist]}
    assert ct.check_trace_obj(obj) == []
    assert obj["trace"] == jsw.trace_to_dict(tr_j, NL)


def test_deferred_blacklist_passes():
    """``_evict_blacklisted`` and ``_censor_convicted`` on a made-up
    state and strike vector (nodes at, below and above the limit)."""
    r = np.random.default_rng(9)
    l, s = 48, CFG_T.search_width
    idx = r.integers(-1, N, (l, s)).astype(np.int32)
    dist = np.where(idx < 0, 0xFFFFFFFF,
                    r.integers(0, 2**32, (l, s), dtype=np.uint32))
    order = np.argsort(dist, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, 1)
    dist = np.take_along_axis(dist, order, 1).astype(np.uint32)
    queried = (r.random((l, s)) < 0.5) & (idx >= 0)
    strikes = r.integers(0, 6, N).astype(np.int32)
    st_j = jsw.LookupState(jnp.zeros((l, 5), jnp.uint32), jnp.asarray(idx),
                           jnp.asarray(dist), jnp.asarray(queried),
                           jnp.zeros(l, bool), jnp.zeros(l, jnp.int32))
    st_t = state_from_numpy(np.zeros((l, 5), np.uint32), idx, dist, queried,
                            np.zeros(l, bool), np.zeros(l, np.int32),
                            device="cpu")
    blk = strikes >= 3
    want = jsw._evict_blacklisted(st_j, jnp.asarray(blk), CFG_J)
    got = tsw._evict_blacklisted(st_t, torch.from_numpy(blk), CFG_T)
    assert_same(want, got, "evict blacklisted")
    found = idx[:, :8]
    for defend in (True, False):
        f_j = jsw.LookupFaults(defend=defend)
        want = jsw._censor_convicted(jnp.asarray(found), jnp.asarray(strikes),
                                     CFG_J, f_j)
        got = tsw._censor_convicted(torch.from_numpy(found),
                                    torch.from_numpy(strikes), CFG_T,
                                    tsw.LookupFaults(*f_j))
        assert np.array_equal(as_int64(want), as_int64(got))
