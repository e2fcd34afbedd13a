"""The port's PHT index against the JAX package's, bit for bit: the
linearizer, the trie-node hash, slot keys, entry tokens and payload
packing on random inputs; then one index built by both packages on the
512-node swarm with ``StoreConfig(slots=24, ...)`` from the same entry
list (with splits), JAX's lookup origins handed across — the store,
``stats`` and ``trie_snapshot`` equal after the build, and
``leaf_search``, ``lookup_batch`` and ``range_query`` equal JAX's and
:class:`PhtOracle`'s.  A port-made ``swarm_index_trace`` artifact passes
JAX's ``check_index_obj`` and the port's.

Every store get and put of both packages is padded to one width
(``_pow2_width`` patched in both modules), so JAX compiles its get and
announce programs once."""

import copy
import hashlib
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import index as ji
from opendht_tpu.models import storage as jst
from opendht_tpu_torch.convert import store_from_numpy
from opendht_tpu_torch.models import index as ti
from opendht_tpu_torch.models import storage as tst

from torch_port_cases import (assert_same, jax_origins, jax_swarm,
                              patch_index_widths, port_cfg, port_swarm,
                              to_torch)

SPEC_J = ji.IndexSpec.from_key_spec("conf", {"id": 4})
SPEC_T = ti.IndexSpec.from_key_spec("conf", {"id": 4})
WIDTH = 512             # every store batch of both packages
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_width():
    """One index batch shape for JAX (``patch_index_widths``)."""
    mp = pytest.MonkeyPatch()
    patch_index_widths(mp, WIDTH)
    yield
    mp.undo()


def scfgs():
    kw = dict(slots=24, listen_slots=1, max_listeners=64,
              payload_words=SPEC_J.payload_words)
    return jst.StoreConfig(**kw), tst.StoreConfig(**kw)


def keyset():
    """24 entries over 16 two-byte keys (8 repeated with a second vid):
    dense shared prefixes force splits several levels down."""
    r = np.random.default_rng(11)
    raw = [bytes([a, b]) for a in b"ab" for b in b"abcdefgh"]
    raw = raw + [raw[i] for i in r.choice(16, 8, replace=False)]
    keys = [{"id": k} for k in raw]
    ehash = np.stack([np.frombuffer(hashlib.sha1(b"e%d" % i).digest(),
                                    dtype=">u4") for i in range(len(raw))]
                     ).astype(np.uint32)
    return keys, ehash, np.arange(len(raw), dtype=np.uint32)


def scan_ranges():
    """Inclusive ranges: from below every key, a prefix band, a single
    key, an empty band past the keys."""
    lo = [{"id": b"\x00"}, {"id": b"ae"}, {"id": b"bc"}, {"id": b"zz"}]
    hi = [{"id": b"ac"}, {"id": b"bb"}, {"id": b"bc"}, {"id": b"zzz"}]
    return lo, hi


@pytest.fixture(scope="module")
def built(one_width):
    """One index built by both packages from the same entries and
    origins, plus the oracle."""
    sw, cfg = jax_swarm()
    sw_t, cfg_t = port_swarm(sw), port_cfg(cfg)
    sj, st = scfgs()
    ixj = ji.DeviceIndex(sw, cfg, jst.empty_store(cfg.n_nodes, sj), sj,
                         SPEC_J, seed=SEED)
    root = jax.random.PRNGKey(SEED)
    ixt = ti.DeviceIndex(
        sw_t, cfg_t, tst.empty_store(cfg.n_nodes, st, "cpu"), st, SPEC_T,
        draws=lambda op, p: jax_origins(sw, jax.random.fold_in(root, op), p),
        device="cpu")
    keys, ehash, evid = keyset()
    out_j = ixj.insert_batch(keys, ehash, evid)
    out_t = ixt.insert_batch(keys, ehash, evid)
    orc = ti.PhtOracle(SPEC_T)
    bits = ixt.linearize(keys)
    for i in range(len(keys)):
        orc.insert(bits[i], ehash[i].astype(">u4").tobytes(), int(evid[i]))
    return ixj, ixt, orc, out_j, out_t


# ---------------------------------------------------------------------------
# the pure parts
# ---------------------------------------------------------------------------

def test_spec_and_constants():
    from opendht_tpu.indexation import pht
    assert ti.INDEX_PREFIX == pht.INDEX_PREFIX
    assert ti.MAX_NODE_ENTRY_COUNT == pht.MAX_NODE_ENTRY_COUNT
    for ks in ({"id": 4}, {"k": 4}, {"a": 3, "b": 7}):
        a = ji.IndexSpec.from_key_spec("x", ks)
        b = ti.IndexSpec.from_key_spec("x", ks)
        assert tuple(a) == tuple(b)
        for p in ("field_len", "prefix_bits", "prefix_words",
                  "payload_words", "value_type", "canary_type",
                  "probe_round_bound"):
            assert getattr(a, p) == getattr(b, p), p
    bench = ti.IndexSpec.from_key_spec("bench", {"k": 4})
    assert (bench.prefix_bits, bench.payload_words,
            bench.probe_round_bound) == (40, 9, 14)
    with pytest.raises(ValueError, match="too wide"):
        ti.IndexSpec.from_key_spec("x", {"a": 16, "b": 16})


def test_linearize_hash_slots_tokens_payloads():
    """The linearizer on random multi-field keys (every length 0..cap),
    the trie hash at every depth 0..prefix_bits, slot keys of every
    discriminator, entry tokens and packed payloads."""
    spec_j = ji.IndexSpec.from_key_spec("x", {"a": 3, "b": 5})
    spec_t = ti.IndexSpec(*spec_j)
    r = np.random.default_rng(1)
    keys = [{"a": r.bytes(int(r.integers(0, 4))),
             "b": r.bytes(int(r.integers(0, 6)))} for _ in range(64)]
    fb, fl = ji.fields_to_arrays(spec_j, keys)
    fb_t, fl_t = ti.fields_to_arrays(spec_t, keys)
    assert np.array_equal(fb, fb_t) and np.array_equal(fl, fl_t)
    lin_j = ji._linearize_batch(spec_j, jnp.asarray(fb), jnp.asarray(fl))
    lin_t = ti._linearize_batch(spec_t, to_torch(fb), to_torch(fl))
    assert_same([lin_j], [lin_t], "linearize")
    with pytest.raises(ValueError):
        ti.fields_to_arrays(spec_t, [{"a": b"toolong!"}])
    bits = np.asarray(lin_j)
    depth = r.integers(0, spec_j.prefix_bits + 1, 64).astype(np.int32)
    depth[:3] = (0, 1, spec_j.prefix_bits)
    with jax.disable_jit():     # compiling the SHA-1 unroll takes longer
        h_j = ji._trie_node_hash(spec_j, jnp.asarray(bits),
                                 jnp.asarray(depth))
    h_t = ti._trie_node_hash(spec_t, to_torch(bits), to_torch(depth))
    assert_same([h_j], [h_t], "trie node hash")
    pw = spec_j.prefix_words
    for d in (0, 5, 33, 47):
        dd = np.full(64, d)
        assert np.array_equal(ji.np_mask_bits(bits, dd),
                              ti.np_mask_bits(bits, dd))
        assert np.array_equal(ji.np_get_bit(bits, dd),
                              ti.np_get_bit(bits, dd))
        assert np.array_equal(ji.np_flip_bit(bits, dd),
                              ti.np_flip_bit(bits, dd))
        assert ji.np_bits_key(bits[0], d) == ti.np_bits_key(bits[0], d)
        assert_same([ji._word_masks(pw, jnp.asarray(dd))],
                    [ti._word_masks(pw, to_torch(dd))], "word masks")
    tk = np.asarray(h_j)
    d17 = np.arange(17, dtype=np.uint32)
    assert np.array_equal(ji.slot_keys(tk[:, None, :], d17[None, :]),
                          ti.slot_keys(tk[:, None, :], d17[None, :]))
    vid = r.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(ji.entry_tokens(tk[:, 0], vid),
                          ti.entry_tokens(tk[:, 0], vid))
    pl_j = ji._pack_entry_payloads(spec_j, jnp.asarray(tk),
                                   jnp.asarray(vid), jnp.asarray(bits))
    pl_t = ti._pack_entry_payloads(spec_t, to_torch(tk), to_torch(vid),
                                   to_torch(bits))
    assert_same([pl_j], [pl_t], "payloads")
    for nbits in (40, 48, 33):
        w = np.array([0xFFFFFFFF, 0xFFFF0000], np.uint32)
        for x in (w, np.zeros(2, np.uint32), np.array([7, 0], np.uint32)):
            a, b = ji._np_increment(x, nbits), ti._np_increment(x, nbits)
            assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert ti._pow2_width(17) == ji.pow2_width(17, 16) == 32


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_insert_store_stats_and_trie_equal(built):
    ixj, ixt, orc, out_j, out_t = built
    assert out_j == out_t and out_t["splits"] > 0
    assert ixj._max_depth == ixt._max_depth and ixj._op == ixt._op
    assert_same(store_from_numpy(*map(np.asarray, ixj.store), device="cpu"),
                ixt.store, "index store")
    leaves_j, interior_j = ixj.trie_snapshot()
    leaves_t, interior_t = ixt.trie_snapshot()
    assert leaves_j == leaves_t == orc.leaves()
    assert interior_j == interior_t
    assert len(leaves_t) == 1 + out_t["split_levels"]
    assert ixj.stats == ixt.stats


def test_leaf_search_lookup_and_range_equal(built):
    ixj, ixt, orc, _, _ = built
    keys, ehash, evid = keyset()
    probe = keys + [{"id": b"q"}, {"id": b"abz"}]
    bits = ixt.linearize(probe)
    assert np.array_equal(bits, ixj.linearize(probe))
    assert np.array_equal(ixj.leaf_search(bits), ixt.leaf_search(bits))
    dj, ej = ixj.lookup_batch(probe)
    dt, et = ixt.lookup_batch(probe)
    assert np.array_equal(dj, dt) and ej == et
    want = {}
    for i, k in enumerate(keys):
        want.setdefault(k["id"], set()).add(
            (ehash[i].astype(">u4").tobytes(), int(evid[i])))
    for k, got in zip(probe, et):
        assert set(got) == want.get(k["id"], set())
    lo, hi = scan_ranges()
    lo_b, hi_b = ixt.linearize(lo), ixt.linearize(hi)
    rj, lj = ixj.range_query(lo_b, hi_b)
    rt, lt = ixt.range_query(lo_b, hi_b)
    assert rj == rt and np.array_equal(lj, lt)
    for q in range(len(lo)):
        assert set(rt[q]) == orc.entries_in_range(lo_b[q], hi_b[q])
    assert rt[0] and rt[1] and rt[2] and rt[3] == []
    assert ixj.stats == ixt.stats
    assert ixt.stats["walk_rounds_max"] <= SPEC_T.probe_round_bound


def test_store_geometry_checks():
    sw, cfg = jax_swarm()
    sw_t, cfg_t = port_swarm(sw), port_cfg(cfg)
    for bad in (dict(slots=24, payload_words=3), dict(slots=8,
                                                      payload_words=8)):
        sc = tst.StoreConfig(listen_slots=1, max_listeners=8, **bad)
        with pytest.raises(ValueError):
            ti.DeviceIndex(sw_t, cfg_t, tst.empty_store(cfg.n_nodes, sc,
                                                        "cpu"),
                           sc, SPEC_T, device="cpu")


@pytest.fixture(params=["jax", "port"])
def ct(request):
    """The JAX package's artifact checker and the port's own copy."""
    if request.param == "jax":
        from opendht_tpu.tools import check_trace
    else:
        from opendht_tpu_torch.tools import check_trace
    return check_trace


@pytest.fixture(scope="module")
def index_artifact(one_width):
    """A port-only build (the port's own draws, its own batch widths)
    of ``bench.py --mode index``'s entry list, cut to 48 entries over 32
    ranks, on the 512-node swarm, scans exact against the oracle,
    written as the bench's artifact; and its build stats."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ti, "_pow2_width",
                   lambda m, floor=16: tst.pow2_width(m, floor))
        return _index_artifact()


def _index_artifact():
    sw, cfg = jax_swarm()
    sw_t, cfg_t = port_swarm(sw), port_cfg(cfg)
    spec = ti.IndexSpec.from_key_spec("bench", {"k": 4})
    _, st = scfgs()
    st = st._replace(payload_words=spec.payload_words)
    ix = ti.DeviceIndex(sw_t, cfg_t, tst.empty_store(cfg.n_nodes, st, "cpu"),
                        st, spec, seed=3, device="cpu")
    rng = np.random.default_rng(7)
    u = 32
    p = 1.0 / np.arange(1, u + 1) ** 1.2
    p /= p.sum()
    per, ranks, dups = {}, [], []
    for r in rng.choice(u, size=48, p=p):
        c = per.get(int(r), 0)
        if c >= 16:
            continue
        per[int(r)] = c + 1
        ranks.append(int(r))
        dups.append(c)
    keys = [{"k": struct.pack(">I", r)} for r in ranks]
    ehash = np.stack([np.frombuffer(hashlib.sha1(b"e%d.%d" % rd).digest(),
                                    dtype=">u4") for rd in zip(ranks, dups)]
                     ).astype(np.uint32)
    evid = np.arange(len(ranks), dtype=np.uint32)
    stats = ix.insert_batch(keys, ehash, evid)
    orc = ti.PhtOracle(spec)
    bits = ix.linearize(keys)
    for i in range(len(ranks)):
        orc.insert(bits[i], ehash[i].astype(">u4").tobytes(), int(evid[i]))
    lo_r = np.minimum(rng.choice(u, size=4, p=p), u - 1)
    hi_r = np.minimum(lo_r + 7, u - 1)
    lo_b = ix.linearize([{"k": struct.pack(">I", int(r))} for r in lo_r])
    hi_b = ix.linearize([{"k": struct.pack(">I", int(r))} for r in hi_r])
    want = [orc.entries_in_range(lo_b[i], hi_b[i]) for i in range(4)]
    res, leaves = ix.range_query(lo_b, hi_b)
    matched = sum(len(set(res[i]) & want[i]) for i in range(4))
    extras = sum(len(set(res[i]) - want[i]) for i in range(4))
    total = sum(len(w) for w in want)
    assert total > 0 and matched == total and extras == 0
    dev_leaves, dev_interior = ix.trie_snapshot()
    occ = [0] * 17
    for ents in dev_leaves.values():
        occ[len(ents)] += 1
    occ_orc = [0] * 17
    for ents in orc.leaves().values():
        occ_orc[len(ents)] += 1
    recall = 1.0
    obj = {"kind": "swarm_index_trace",
           "bench": {"scan_recall": recall},
           "index": {
               "prefix_bits": spec.prefix_bits,
               "probe_round_bound": spec.probe_round_bound,
               "walk_rounds_max": ix.stats["walk_rounds_max"],
               "entries_distinct": len(ranks),
               "entries_in_leaves": sum(len(v) for v in dev_leaves.values()),
               "overfull_drops": ix.stats["overfull_drops"],
               "n_leaves": len(dev_leaves), "n_interior": len(dev_interior),
               "splits": stats["splits"],
               "split_levels": stats["split_levels"],
               "leaf_occupancy_max": max(len(v) for v in dev_leaves.values()),
               "leaf_occupancy_hist": occ,
               "oracle_leaf_occupancy_hist": occ_orc,
               "oracle_agrees": occ == occ_orc
               and len(dev_leaves) == len(orc.leaves()),
               "build_stats": stats,
               "scans": {"n": 4, "recall": recall, "exact": True,
                         "entries_expected": total,
                         "entries_returned": sum(len(r) for r in res),
                         "extras": extras,
                         "leaves_touched_mean": float(leaves.mean())}}}
    return obj, stats


def test_port_artifact_passes_check_index_obj(index_artifact, ct):
    """The port's index artifact is accepted by ``check_index_obj``,
    JAX's and the port's; a broken split count is caught."""
    obj, stats = copy.deepcopy(index_artifact)
    assert ct.check_index_obj(obj) == []
    assert stats["splits"] > 0
    obj["index"]["split_levels"] += 1
    assert any("split" in e for e in ct.check_index_obj(obj))
