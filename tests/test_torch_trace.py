"""The port's observers and maintenance against the JAX package, bit for
bit: the flight recorder (``traced_lookup``, ``merge_traces``,
``trace_to_dict``), the lifecycle plane, and ``heal_swarm``'s tables
from JAX's draws.  Every comparison is exact."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import swarm as jsw
from opendht_tpu_torch.convert import (swarm_from_numpy, trace_from_numpy,
                                       u32_tensor)
from opendht_tpu_torch.models import swarm as tsw

from torch_port_cases import assert_same

N, NL = 1024, 128
CFG_J = jsw.SwarmConfig.for_nodes(N)
CFG_T = tsw.SwarmConfig.for_nodes(N, device="cpu")
KEY = jax.random.PRNGKey(7)


def to_port(sw):
    return swarm_from_numpy(np.asarray(sw.ids), np.asarray(sw.tables),
                            np.asarray(sw.alive), device="cpu")


@pytest.fixture(scope="module")
def churned():
    sw = jsw.build_swarm(KEY, CFG_J)
    return jsw.churn(sw, jax.random.PRNGKey(9), 0.25, CFG_J)


@pytest.fixture(scope="module")
def targets():
    return jax.random.bits(jax.random.PRNGKey(1), (NL, 5), jnp.uint32)


def _origins(sw, key, l=NL):
    return torch.from_numpy(np.array(jsw._sample_origins(key, sw.alive, l)))


@pytest.mark.parametrize("impl", ["auto", "fused-round"])
@pytest.mark.parametrize("compact", [True, False])
def test_traced_lookup_bit_equal(compact, impl, churned, targets):
    """Results and every trace field, compacted or not, against JAX's
    uncompacted traced lookup (JAX's tests hold its compacted trace
    equal to it); under ``"fused-round"`` the traced engine takes K1's
    merge, as JAX's falls back to its merge-only kernel."""
    key = jax.random.PRNGKey(2)
    res_j, tr_j = jsw.traced_lookup(churned, CFG_J, targets, key,
                                    compact=False)
    res_t, tr_t = tsw.traced_lookup(
        to_port(churned), CFG_T._replace(merge_impl=impl),
        u32_tensor(np.asarray(targets), "cpu"),
        origins=_origins(churned, key), compact=compact, device="cpu")
    assert_same(res_j, res_t, f"traced results compact={compact}")
    assert_same(tr_j, tr_t, f"trace compact={compact} impl={impl}")
    plain = tsw.lookup(to_port(churned), CFG_T,
                       u32_tensor(np.asarray(targets), "cpu"),
                       origins=_origins(churned, key), device="cpu")
    assert_same(plain, res_t, "traced vs untraced")


def _synthetic_trace(seed, rounds, r_max=12, l=100):
    """A trace of a batch of ``l`` lookups that exits at ``rounds``."""
    r = np.random.default_rng(seed)
    done = np.zeros(r_max, np.int32)
    done[:rounds] = np.sort(r.integers(0, l + 1, rounds))
    done[rounds - 1] = l
    active = np.zeros(r_max, np.int32)
    active[:rounds] = l - np.concatenate([[0], done[:rounds - 1]])
    counts = [np.where(np.arange(r_max) < rounds,
                       r.integers(0, 50, r_max), 0).astype(np.int32)
              for _ in range(7)]
    req, rep, drops, poison, strikes, conv, churn = counts
    return (req, rep, drops, poison, strikes, conv, churn, done, active,
            np.int32(rounds))


def test_merge_traces_and_dict(churned, targets):
    """Two chunks: real traces of two target batches, and a synthetic
    pair exiting at different rounds (the gauge forward-fill)."""
    tg2 = jax.random.bits(jax.random.PRNGKey(3), (NL, 5), jnp.uint32)
    pairs = [[jsw.traced_lookup(churned, CFG_J, t, jax.random.PRNGKey(s),
                                compact=False)[1]
              for t, s in ((targets, 2), (tg2, 4))],
             [jsw.LookupTrace(*(jnp.asarray(x) for x in
                                _synthetic_trace(s, r)))
              for s, r in ((0, 3), (1, 7))]]
    for chunks in pairs:
        want = jsw.merge_traces(chunks)
        port = [trace_from_numpy(*(np.asarray(x) for x in t), device="cpu")
                for t in chunks]
        got = tsw.merge_traces(port)
        assert_same(want, got, "merge_traces")
        for n in (None, 2 * NL):
            assert tsw.trace_to_dict(got, n) == jsw.trace_to_dict(want, n)
            assert tsw.trace_to_dict(port[0], n) == jsw.trace_to_dict(
                chunks[0], n)


@pytest.mark.parametrize("compact,impl", [(True, "fused-round"),
                                          (False, "auto")])
def test_lifecycle_rounds_bit_equal(compact, impl, churned, targets):
    """Per-row rounds in batch order, compacted or not, against JAX's
    uncompacted tracked lookup."""
    key = jax.random.PRNGKey(2)
    st_j = {}
    res_j = jsw.lookup(churned, CFG_J, targets, key, compact=False,
                       stats=st_j, track_lifecycle=True)
    cfg = CFG_T._replace(merge_impl=impl)
    sw_t, tg_t = to_port(churned), u32_tensor(np.asarray(targets), "cpu")
    st_t = {}
    res_t = tsw.lookup(sw_t, cfg, tg_t, origins=_origins(churned, key),
                       compact=compact, stats=st_t, track_lifecycle=True,
                       device="cpu")
    assert_same(res_j, res_t, "tracked results")
    assert_same([st_j["admitted_round"], st_j["completed_round"]],
                [st_t["admitted_round"], st_t["completed_round"]],
                f"lifecycle rounds compact={compact}")
    untracked = tsw.lookup(sw_t, cfg, tg_t, origins=_origins(churned, key),
                           compact=compact, device="cpu")
    assert_same(untracked, res_t, "tracking changed the results")


def test_lifecycle_step_needs_round():
    cfg = tsw.SwarmConfig.for_nodes(256, device="cpu")
    sw = tsw.build_swarm(cfg, torch.Generator().manual_seed(1),
                         device="cpu")
    st = tsw.lookup_init(sw, cfg, torch.zeros((4, 5), dtype=torch.int64),
                         torch.arange(4, dtype=torch.int32))
    st = tsw.init_lifecycle(st)
    for c in (cfg, cfg._replace(merge_impl="fused-round")):
        with pytest.raises(ValueError, match="round index"):
            tsw.lookup_step(sw, c, st)
        assert tsw.lookup_step(sw, c, st, rnd=0).completed_round is not None


@pytest.mark.parametrize("aug", [True, False])
def test_heal_swarm_byte_equal(aug, churned):
    """JAX's draws (``fold_in(key, b)`` uniforms) give byte-equal healed
    tables, augmented and plain; every healed member is alive."""
    cfg_j = CFG_J._replace(aug_tables=aug)
    k, nb = cfg_j.bucket_k, cfg_j.n_buckets
    sw = churned
    if not aug:      # the same members as plain [N, B·K] int32 rows
        rows = np.asarray(sw.tables)[:, :nb * 3 * k].reshape(N, nb, 3, k)
        rows = rows.astype(np.uint32)
        plain = (rows[:, :, 0] | (rows[:, :, 1] << 16)).view(np.int32)
        sw = sw._replace(tables=jnp.asarray(plain.reshape(N, nb * k)))
    sw_t = to_port(sw)
    key = jax.random.PRNGKey(5)
    # heal_swarm donates the table: heal a copy, keep the fixture.
    copy = sw._replace(tables=jnp.array(sw.tables, copy=True))
    want = jsw.heal_swarm(copy, cfg_j, key)

    def draws(b):
        u = jax.random.uniform(jax.random.fold_in(key, b),
                               (N, cfg_j.bucket_k))
        return torch.from_numpy(np.array(u))

    got = tsw.heal_swarm(sw_t, CFG_T._replace(aug_tables=aug), draws)
    assert got.tables is sw_t.tables                      # in place
    assert np.array_equal(got.tables.numpy(), np.asarray(want.tables))
    t = got.tables.numpy()
    if aug:
        rows = t[:, :nb * 3 * k].reshape(N, nb, 3, k).astype(np.uint32)
        members = (rows[:, :, 0] | (rows[:, :, 1] << 16)).view(np.int32)
    else:
        members = t
    alive = np.asarray(sw.alive)
    assert alive[members[members >= 0]].all()
