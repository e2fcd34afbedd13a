"""The port's lookup engine against the JAX engine, bit for bit: the
same tables from the same draws, the same round from the same state,
the same lookups from the same swarm, targets and origins."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import swarm as jsw
from opendht_tpu_torch.convert import (state_from_numpy, swarm_from_numpy,
                                       trace_from_numpy, u32_tensor)
from opendht_tpu_torch.models import swarm as tsw

from torch_port_cases import as_int64, assert_same

N, NL = 2048, 256
CFG_J = jsw.SwarmConfig.for_nodes(N)
CFG_T = tsw.SwarmConfig.for_nodes(N, device="cpu")
KEY = jax.random.PRNGKey(7)


def to_port(sw):
    return swarm_from_numpy(np.asarray(sw.ids), np.asarray(sw.tables),
                            np.asarray(sw.alive), device="cpu")


@pytest.fixture(scope="module")
def healthy():
    return jsw.build_swarm(KEY, CFG_J)


@pytest.fixture(scope="module")
def churned(healthy):
    return jsw.churn(healthy, jax.random.PRNGKey(9), 0.25, CFG_J)


@pytest.fixture(scope="module")
def targets():
    return jax.random.bits(jax.random.PRNGKey(1), (NL, 5), jnp.uint32)


def test_configs_equal():
    assert tuple(CFG_T) == tuple(CFG_J)
    big_j = jsw.SwarmConfig.for_nodes(10_000_000)
    big_t = tsw.SwarmConfig.for_nodes(10_000_000, device="cpu")
    assert tuple(big_t) == tuple(big_j)
    assert tsw.table_bytes(big_t) == jsw.table_bytes(big_j)
    with pytest.raises(ValueError, match="quorum"):
        tsw.SwarmConfig(n_nodes=64, n_buckets=4, quorum=13)
    with pytest.raises(ValueError, match="merge_impl"):
        tsw.SwarmConfig.for_nodes(64, merge_impl="pallas")
    # On the card "auto" is the K1 kernel and a plain merge is refused.
    card = torch.device("cuda", 0)
    assert tsw.resolve_merge_impl(CFG_T, card) == "kernel"
    assert tsw.resolve_merge_impl(CFG_T, torch.device("cpu")) == "rank"
    with pytest.raises(ValueError, match="K1 kernel"):
        tsw.resolve_merge_impl(CFG_T._replace(merge_impl="sort"), card)


@pytest.mark.parametrize("aug", [True, False])
def test_build_tables_byte_equal(aug, healthy):
    """JAX's ids and JAX's per-bucket draws (split → fold_in(k_samp, b)
    → uniform) give byte-equal tables, augmented and plain."""
    cfg_j = CFG_J._replace(aug_tables=aug)
    sw = healthy if aug else jsw.build_swarm(KEY, cfg_j)
    k_ids, k_samp = jax.random.split(KEY)
    ids = np.asarray(jsw._build_ids(k_ids, cfg_j))
    assert np.array_equal(ids, np.asarray(sw.ids))

    def draws(b):
        u = jax.random.uniform(jax.random.fold_in(k_samp, b),
                               (N, cfg_j.bucket_k))
        return torch.from_numpy(np.array(u))

    tables = tsw.build_tables(u32_tensor(ids[:, 0], "cpu"),
                              CFG_T._replace(aug_tables=aug), draws)
    want = np.asarray(sw.tables)
    assert tables.numpy().dtype == want.dtype
    assert np.array_equal(tables.numpy(), want)


def test_lookup_step_bit_equal(churned, targets):
    """Three rounds from JAX's initial state on a churned swarm."""
    origins = jsw._sample_origins(jax.random.PRNGKey(2), churned.alive, NL)
    st_j = jsw.lookup_init(churned, CFG_J, targets, origins)
    sw_t = to_port(churned)
    st_t = tsw.lookup_init(sw_t, CFG_T, u32_tensor(np.asarray(targets),
                                                   "cpu"),
                           torch.from_numpy(np.array(origins)))
    for rnd in range(3):
        assert_same(st_j[:6], st_t, f"state before round {rnd}")
        st_j = jsw.lookup_step(churned, CFG_J, st_j)
        st_t = tsw.lookup_step(sw_t, CFG_T, st_t)
    # The port also steps from a state carried across from JAX.
    st_c = state_from_numpy(*(np.asarray(x) for x in st_j[:6]),
                            device="cpu")
    assert_same(jsw.lookup_step(churned, CFG_J, st_j)[:6],
                tsw.lookup_step(sw_t, CFG_T, st_c), "carried state")


@pytest.mark.parametrize("which", ["healthy", "churned"])
@pytest.mark.parametrize("compact", [True, False])
def test_lookup_bit_equal(which, compact, request, targets):
    sw = request.getfixturevalue(which)
    key = jax.random.PRNGKey(2)
    want = jsw.lookup(sw, CFG_J, targets, key, compact=compact)
    origins = torch.from_numpy(np.array(
        jsw._sample_origins(key, sw.alive, NL)))
    stats = {}
    got = tsw.lookup(to_port(sw), CFG_T, u32_tensor(np.asarray(targets),
                                                    "cpu"),
                     origins=origins, compact=compact, stats=stats,
                     device="cpu")
    assert_same(want, got, f"lookup {which} compact={compact}")
    assert bool(got.done.all())
    if compact:
        assert stats["rounds_dispatched"] >= 1


def test_sorted_merge_engine_bit_equal(churned, targets):
    """The two-pass sorted reference merge as the engine's merge."""
    key = jax.random.PRNGKey(2)
    want = jsw.lookup(churned, CFG_J, targets, key)
    origins = torch.from_numpy(np.array(
        jsw._sample_origins(key, churned.alive, NL)))
    got = tsw.lookup(to_port(churned), CFG_T._replace(merge_impl="sort"),
                     u32_tensor(np.asarray(targets), "cpu"),
                     origins=origins, device="cpu")
    assert_same(want, got, "sorted-merge engine")


def test_true_closest_and_recall(churned, targets):
    want = jsw.true_closest(churned, CFG_J, targets[:64])
    sw_t = to_port(churned)
    tg_t = u32_tensor(np.asarray(targets[:64]), "cpu")
    got = tsw.true_closest(sw_t, CFG_T, tg_t, device="cpu")
    assert_same([want], [got], "true_closest")
    key = jax.random.PRNGKey(2)
    res_j = jsw.lookup(churned, CFG_J, targets[:64], key)
    origins = torch.from_numpy(np.array(
        jsw._sample_origins(key, churned.alive, 64)))
    res_t = tsw.lookup(sw_t, CFG_T, tg_t, origins=origins, device="cpu")
    rec_j = np.asarray(jsw.lookup_recall(churned, CFG_J, res_j,
                                         targets[:64]))
    rec_t = tsw.lookup_recall(sw_t, CFG_T, res_t, tg_t).numpy()
    assert np.array_equal(rec_j, rec_t)
    hist = tsw.hop_histogram(res_t.hops, CFG_T.max_steps)
    assert np.array_equal(as_int64(jsw.hop_histogram(res_j.hops,
                                                     CFG_J.max_steps)),
                          as_int64(hist))


def test_port_generators_run_the_whole_path():
    """The port's own draws: a valid swarm, and lookups that converge
    with recall 1 on a healthy swarm."""
    cfg = tsw.SwarmConfig.for_nodes(1024, device="cpu")
    gen = torch.Generator().manual_seed(3)
    sw = tsw.build_swarm(cfg, gen, device="cpu")
    ids = sw.ids.numpy()
    assert np.all(np.diff(ids[:, 0]) >= 0)
    sw_c = tsw.churn(sw, gen, 0.1, cfg)
    assert 0 < int(sw_c.alive.sum()) < cfg.n_nodes
    tg = torch.randint(0, 2**32, (64, 5), generator=gen)
    res = tsw.lookup(sw, cfg, tg, gen, device="cpu")
    assert bool(res.done.all())
    assert float(tsw.lookup_recall(sw, cfg, res, tg).mean()) > 0.95


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = tsw.SwarmConfig.for_nodes(256, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsw.build_swarm(cfg)
    sw = tsw.build_swarm(cfg, device="cpu")
    tg = torch.zeros((4, 5), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsw.lookup(sw, cfg, tg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsw.true_closest(sw, cfg, tg)
    assert tsw.lookup(sw, cfg, tg, device="cpu").found.shape == (4, 8)


def test_state_carrier_needs_a_card_unless_cpu(healthy):
    """The carrier resolves its device as the entry points do: the card
    by default, so without one it raises unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    sw = (np.asarray(healthy.ids), np.asarray(healthy.tables),
          np.asarray(healthy.alive))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        swarm_from_numpy(*sw)
    st = [np.zeros((4, 5), np.uint32), np.zeros((4, 14), np.int32),
          np.zeros((4, 14, 5), np.uint32), np.zeros((4, 14), bool),
          np.zeros(4, bool), np.zeros(4, np.int32)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_numpy(*st)
    trace = [np.zeros(4, np.int32)] * (len(tsw.LookupTrace._fields) - 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trace_from_numpy(*trace, np.zeros((), np.int32))
    assert swarm_from_numpy(*sw, device="cpu").ids.device.type == "cpu"
    assert state_from_numpy(*st, device="cpu").idx.device.type == "cpu"
