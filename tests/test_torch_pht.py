"""The port's host index against the JAX package's: ``InfoHash`` on
random and edge ids; the entry blob codec against ``msgpack``; the
port's ``Pht`` over the port's ``StoreDht`` and JAX's ``Pht`` over JAX's
``StoreDht`` inserting the same entries with the same rng, JAX's lookup
origins handed across — the stores equal after every insert, and the
trie equal to a port ``DeviceIndex`` built from the same entries and to
``PhtOracle``; host lookups over ``StoreDht.over`` a device-built index
read every entry; ``tests/test_pht.py``'s cluster cases (round trip,
missing key, multiple inserts, a split at capacity + 1 with
``parent_insert`` both ways) through each package's ``Pht`` over its
host ``Dht`` on ``DhtNetwork(6, seed=3)``, equal in callbacks, stores
and datagrams; and the off-path ``bucket_range`` and ``lookup_steps``
of the swarm module.

Every index store op of both packages runs at one width
(``patch_index_widths``), so JAX compiles its get and announce once."""

import hashlib
import random

import msgpack
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.harness import network as jnet
from opendht_tpu.indexation import pht as jp
from opendht_tpu.models import index as ji
from opendht_tpu.models import storage as jst
from opendht_tpu.models import swarm as jsw
from opendht_tpu.utils import infohash as jih
from opendht_tpu_torch.convert import store_from_numpy
from opendht_tpu_torch.harness import network as tnet
from opendht_tpu_torch.indexation import pht as tp
from opendht_tpu_torch.models import index as ti
from opendht_tpu_torch.models import storage as tst
from opendht_tpu_torch.models import swarm as tsw
from opendht_tpu_torch.utils import infohash as tih

from torch_port_cases import (assert_same, jax_origins, jax_swarm,
                              patch_index_widths, port_cfg, port_swarm,
                              to_torch)

WIDTH = 32
SEED = 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_width():
    mp = pytest.MonkeyPatch()
    patch_index_widths(mp, WIDTH)
    yield
    mp.undo()


def test_infohash_equal():
    r = np.random.default_rng(1)
    raw = [bytes(20), b"\xff" * 20, bytes(19) + b"\x01", b"\x80" + bytes(19)]
    raw += [r.bytes(20) for _ in range(40)]
    for a in raw:
        ja, ta = jih.InfoHash(a), tih.InfoHash(a)
        assert (ta.hex(), bool(ta), ta.lowbit(), bytes(ta)) == \
            (ja.hex(), bool(ja), ja.lowbit(), bytes(ja))
        assert np.array_equal(ta.to_u32(), ja.to_u32())
        assert tih.InfoHash.from_u32(ta.to_u32()) == ta
        for b in raw[:6]:
            jb, tb = jih.InfoHash(b), tih.InfoHash(b)
            assert ta.common_bits(tb) == ja.common_bits(jb)
            assert tih.InfoHash.cmp(ta, tb) == jih.InfoHash.cmp(ja, jb)
            assert tih.InfoHash.xor_cmp(ta, tb, tih.InfoHash(raw[7])) == \
                jih.InfoHash.xor_cmp(ja, jb, jih.InfoHash(raw[7]))
            assert bytes(ta.xor(tb)) == bytes(ja.xor(jb))
        for bit in (0, 7, 8, 159):
            assert ta.get_bit(bit) == ja.get_bit(bit)
            assert bytes(ta.set_bit(bit, True)) == \
                bytes(ja.set_bit(bit, True))
            assert bytes(ta.set_bit(bit, False)) == \
                bytes(ja.set_bit(bit, False))
    for s in ("key", b"", "x" * 100):
        assert tih.InfoHash.get(s) == tih.InfoHash(
            jih.InfoHash.get(s).data)
    for s in ("ab", "zz" * 20, "00" * 20):
        assert tih.InfoHash(s).data == jih.InfoHash(s).data
    rng = np.random.default_rng(2)
    ids = tih.random_ids(8, rng)
    assert np.array_equal(tih.pack_ids(tih.unpack_ids(ids)), ids)
    assert np.array_equal(jih.pack_ids(jih.unpack_ids(ids)), ids)
    with pytest.raises(ValueError):
        tih.InfoHash(b"short")


def test_entry_blob_and_prefix_equal():
    r = np.random.default_rng(3)
    for n in (0, 5, 40):
        p = tp.Prefix(r.bytes(n), None if n == 0 else 8 * n - 3)
        e = tp.IndexEntry(p, (tih.InfoHash(r.bytes(20)), 2**32 - 1 - n),
                          "index.pht.conf")
        v = e.pack_value()
        je = jp.IndexEntry(jp.Prefix(p.content, p.size),
                           (jih.InfoHash(bytes(e.value[0])), e.value[1]),
                           "index.pht.conf")
        assert v.data == je.pack_value().data == msgpack.packb({
            "p": p.content, "sz": p.size, "h": bytes(e.value[0]),
            "vid": e.value[1]})
        back = tp.IndexEntry.unpack_value(v)
        assert (back.prefix.content, back.prefix.size, back.value) == \
            (p.content, p.size, e.value)
        assert p.hash().data == jp.Prefix(p.content, p.size).hash().data
    # A blob that is no map fails in both packages' unpack the same way.
    for pkg in (tp, jp):
        with pytest.raises(TypeError):
            pkg.IndexEntry.unpack_value(pkg.Value(msgpack.packb([1, 2])))
    ph, pj = tp.Pht("x", {"a": 3, "b": 5}, None), jp.Pht("x", {"a": 3,
                                                               "b": 5}, None)
    for key in ({"a": b"", "b": b"hello"}, {"a": b"abc", "b": b"\x00"}):
        lt, lj = ph.linearize(key), pj.linearize(key)
        assert (lt.content, lt.size, lt.flags) == (lj.content, lj.size,
                                                   lj.flags)


def _keyset():
    """24 entries over 16 two-byte keys (8 repeated with a second vid):
    shared prefixes force splits."""
    r = np.random.default_rng(11)
    raw = [bytes([a, b]) for a in b"ab" for b in b"abcdefgh"]
    raw = raw + [raw[i] for i in r.choice(16, 8, replace=False)]
    ehash = [hashlib.sha1(b"e%d" % i).digest() for i in range(len(raw))]
    return [{"id": k} for k in raw], ehash, list(range(len(raw)))


def _scfgs(spec):
    kw = dict(slots=24, listen_slots=1, max_listeners=64,
              payload_words=spec.payload_words)
    return jst.StoreConfig(**kw), tst.StoreConfig(**kw)


@pytest.fixture(scope="module")
def host_built(one_width):
    """Both packages' host Pht over their own StoreDht, the same entries
    inserted in order with the same rng; stores compared after each."""
    sw, cfg = jax_swarm()
    sw_t, cfg_t = port_swarm(sw), port_cfg(cfg)
    spec_j = ji.IndexSpec.from_key_spec("conf", {"id": 4})
    spec_t = ti.IndexSpec(*spec_j)
    sj, st = _scfgs(spec_j)
    aj = ji.StoreDht(sw, cfg, jst.empty_store(cfg.n_nodes, sj), sj, spec_j,
                     seed=SEED)
    root = jax.random.PRNGKey(SEED)
    at = ti.StoreDht(sw_t, cfg_t, tst.empty_store(cfg.n_nodes, st, "cpu"),
                     st, spec_t,
                     draws=lambda op, p: jax_origins(
                         sw, jax.random.fold_in(root, op), p),
                     device="cpu")
    hj = jp.Pht("conf", {"id": 4}, aj, rng=random.Random(17),
                parent_insert=False)
    ht = tp.Pht("conf", {"id": 4}, at, rng=random.Random(17),
                parent_insert=False)
    keys, ehash, vids = _keyset()
    done_j, done_t = [], []
    for i, k in enumerate(keys):
        hj.insert(k, (jih.InfoHash(ehash[i]), vids[i]), done_j.append)
        ht.insert(k, (tih.InfoHash(ehash[i]), vids[i]), done_t.append)
        if i % 8 == 7 or i == len(keys) - 1:
            assert_same(store_from_numpy(*map(np.asarray, aj.store),
                                         device="cpu"),
                        at.store, f"store after insert {i}")
    assert done_j == done_t == [True] * len(keys)
    assert aj._ix._op == at._ix._op
    return sw_t, cfg_t, st, spec_t, at, keys, ehash, vids


def _device_index(sw_t, cfg_t, st, spec_t, keys, ehash, vids, seed):
    ix = ti.DeviceIndex(sw_t, cfg_t, tst.empty_store(cfg_t.n_nodes, st,
                                                     "cpu"), st, spec_t,
                        seed=seed, device="cpu")
    eh = np.stack([np.frombuffer(h, ">u4") for h in ehash]).astype(np.uint32)
    ix.insert_batch(keys, eh, np.asarray(vids, np.uint32))
    return ix, eh


def test_host_pht_trie_equals_device_index_and_oracle(host_built):
    sw_t, cfg_t, st, spec_t, at, keys, ehash, vids = host_built
    reader = ti.DeviceIndex(sw_t, cfg_t, at.store, st, spec_t, seed=9,
                            device="cpu")
    host_leaves, _ = reader.trie_snapshot()
    ix, eh = _device_index(sw_t, cfg_t, st, spec_t, keys, ehash, vids, 3)
    dev_leaves, _ = ix.trie_snapshot()
    orc = ti.PhtOracle(spec_t)
    bits = ix.linearize(keys)
    for i in range(len(keys)):
        orc.insert(bits[i], eh[i].astype(">u4").tobytes(), int(vids[i]))
    assert host_leaves == dev_leaves == orc.leaves()
    assert max(d for d, _b in host_leaves) > 0        # the trie split


def test_host_pht_reads_device_built_trie(host_built):
    sw_t, cfg_t, st, spec_t, _at, keys, ehash, vids = host_built
    ix, _eh = _device_index(sw_t, cfg_t, st, spec_t, keys, ehash, vids, 5)
    hp = tp.Pht("conf", {"id": 4}, ti.StoreDht.over(ix),
                rng=random.Random(23), parent_insert=False)
    for i, k in enumerate(keys):
        found = {}
        hp.lookup(k, lambda vals, p: found.update(vals=vals),
                  lambda ok: found.update(done=ok))
        assert found.get("done"), k
        want = {(tih.InfoHash(ehash[j]), vids[j]) for j in range(len(keys))
                if keys[j] == k}
        assert set(found["vals"]) == want, i


def test_split_listener_cancels_on_deep_keys(host_built):
    """Zipf-drawn 4-byte keys (``bench.py --mode index``'s entries, deep
    shared prefixes): the 17th insert splits the root leaf 28 levels
    down, and each split listener's re-insert puts canaries on listened
    keys from inside its callback.  The listener is off its list while
    its callback runs and cancels itself by returning ``False`` (the
    reference's listen), so the inserts end, and the trie equals
    ``PhtOracle``'s."""
    sw_t, cfg_t, _st, _spec, _at, _keys, _ehash, _vids = host_built
    spec = ti.IndexSpec.from_key_spec("bench", {"k": 4})
    _sj, st = _scfgs(spec)
    r = np.random.default_rng(7)
    p = 1.0 / np.arange(1, 257) ** 1.2
    ranks = r.choice(256, size=18, p=p / p.sum())
    keys = [{"k": int(k).to_bytes(4, "big")} for k in ranks]
    ehash = [hashlib.sha1(b"z%d" % i).digest() for i in range(len(keys))]
    vids = list(range(len(keys)))
    ad = ti.StoreDht(sw_t, cfg_t, tst.empty_store(cfg_t.n_nodes, st, "cpu"),
                     st, spec, seed=3, device="cpu")
    hp = tp.Pht("bench", {"k": 4}, ad, rng=random.Random(17),
                parent_insert=False)
    done = []
    for i, k in enumerate(keys):
        hp.insert(k, (tih.InfoHash(ehash[i]), vids[i]), done.append)
    assert done == [True] * len(keys)
    reader = ti.DeviceIndex(sw_t, cfg_t, ad.store, st, spec, seed=4,
                            device="cpu")
    host, _ = reader.trie_snapshot()
    orc = ti.PhtOracle(spec)
    bits = reader.linearize(keys)
    for i in range(len(keys)):
        orc.insert(bits[i], ehash[i], vids[i])
    assert host == orc.leaves() and max(d for d, _b in host) > 20


# ---------------------------------------------------------------------------
# the swarm module's off-path functions
# ---------------------------------------------------------------------------

def test_bucket_range_equal():
    r = np.random.default_rng(4)
    raw = r.integers(0, 2**32, (300, 5), dtype=np.uint32)
    srt = np.asarray(jnp.stack(jax.lax.sort(
        tuple(jnp.asarray(raw[:, i]) for i in range(5)), num_keys=5), -1))
    nodes = srt[r.choice(300, 12)]
    for b in (0, 1, 5, 31, 32, 33, 70, 159):
        for inc in (False, True):
            want = jsw.bucket_range(jnp.asarray(srt), jnp.asarray(nodes),
                                    jnp.int32(b), inclusive=inc)
            got = tsw.bucket_range(to_torch(srt), to_torch(nodes), b,
                                   inclusive=inc)
            assert_same(want, got, f"bucket_range b={b} inclusive={inc}")
    want = jsw.bucket_range(jnp.asarray(srt), jnp.asarray(nodes),
                            jnp.arange(12, dtype=jnp.int32) * 3)
    got = tsw.bucket_range(to_torch(srt), to_torch(nodes),
                           torch.arange(12) * 3)
    assert_same(want, got, "bucket_range per-node depths")


def test_lookup_steps_equal():
    sw, cfg = jax_swarm()
    s, cfg_t = port_swarm(sw), port_cfg(cfg)
    tg = np.random.default_rng(5).integers(0, 2**32, (32, 5),
                                           dtype=np.uint32)
    key = jax.random.PRNGKey(6)
    st_j = jsw.lookup_init(sw, cfg, jnp.asarray(tg),
                           jsw._sample_origins(key, sw.alive, 32))
    st_t = tsw.lookup_init(s, cfg_t, to_torch(tg), jax_origins(sw, key, 32))
    for n in (0, 3):
        assert_same(jsw.lookup_steps(sw, cfg, st_j, n),
                    tsw.lookup_steps(s, cfg_t, st_t, n),
                    f"lookup_steps {n}")


# ---------------------------------------------------------------------------
# the host Pht over the host Dht (tests/test_pht.py's cluster cases)
# ---------------------------------------------------------------------------

SPLIT_JOBS = 13_000


class _Cut(Exception):
    pass


def lookup_local(c, pht_mod, IH, key):
    """Which nodes hold an index entry for ``key`` (any prefix)."""
    want = bytes(IH.get(key.decode("latin1")))
    return [i for i, d in enumerate(c.nodes)
            if any(v.user_type == "index.pht.split17" and want in v.data
                   for st in d.store.values() for v in st.get())]


def _pht_cluster_case(case, pkg, parent_insert, monkeypatch):
    """One cluster case through one package: ``Pht`` on
    ``random.Random(17)`` over node 0 of ``DhtNetwork(6, seed=3)``,
    readers on other nodes; returns the callbacks, every node's store
    and the datagram log."""
    import os
    pht_mod, net_mod, ih_mod = ((tp, tnet, tih) if pkg == "port"
                                else (jp, jnet, jih))
    IH = ih_mod.InfoHash
    stream = random.Random(5)
    monkeypatch.setattr(os, "urandom", lambda n: stream.randbytes(n))
    random.seed(6)
    c = net_mod.DhtNetwork(6, seed=3)
    log, out = [], []
    orig = c.net.deliver

    def deliver(data, src, dest):
        log.append((c.clock.now(), str(src), str(dest), bytes(data)))
        orig(data, src, dest)

    c.net.deliver = deliver
    c.interconnect()
    c.run(2.0)

    def pht(node, name="test", seed=17):
        return pht_mod.Pht(name, {"id": 8}, c.nodes[node],
                           rng=random.Random(seed),
                           parent_insert=parent_insert)

    def insert(p, keys, one_by_one=False, state=None):
        state = [] if state is None else state
        for i, k in enumerate(keys):
            p.insert({"id": k}, (IH.get(k.decode("latin1")), i),
                     lambda ok: state.append(ok))
            if one_by_one:
                assert c.run_until(lambda: len(state) == i + 1, 120)
        assert c.run_until(lambda: len(state) == len(keys), 120)
        out.append(("inserted", state))

    def lookup(p, key):
        found = {}
        p.lookup({"id": key},
                 lambda vals, pre: found.setdefault("vals", []).append(
                     sorted((bytes(h), v) for h, v in vals)),
                 lambda ok: found.update(done=ok))
        assert c.run_until(lambda: "done" in found, 120)
        out.append(("lookup", key, found))
        return found

    if case == "roundtrip":
        insert(pht(0), [b"hello"])
        got = lookup(pht(1), b"hello")
        assert got["done"] and [(bytes(IH.get("hello")), 0)] in got["vals"]
    elif case == "missing":
        insert(pht(0), [b"exists"])
        got = lookup(pht(2), b"missing!")
        assert got.get("vals", [[]]) in ([[]], [])
    elif case == "multiple":
        keys = [f"k{i}".encode() for i in range(8)]
        insert(pht(0), keys)
        reader = pht(3)
        for k in keys:
            lookup(reader, k)
    else:                                   # split at capacity + 1
        # Over the host Dht the 17th insert reports done, and then, in
        # either package, the search steps reschedule each other without
        # end at a fixed virtual time.  The cluster is cut after SPLIT_JOBS
        # scheduled jobs, past that point, and compared up to the cut.
        keys = [b"pfx" + bytes([i]) for i in range(
            pht_mod.MAX_NODE_ENTRY_COUNT + 1)]
        p = pht(0, "split17", 19)
        jobs, add = [0], c.scheduler.add

        def capped(t, fn):
            jobs[0] += 1
            if jobs[0] > SPLIT_JOBS:
                raise _Cut(c.clock.now())
            return add(t, fn)

        c.scheduler.add = capped
        done = []
        with pytest.raises(_Cut) as cut:
            insert(p, keys, one_by_one=True, state=done)
        out.append(("cut", cut.value.args, len(log), done))
        found = [lookup_local(c, pht_mod, IH, k) for k in keys]
        out.append(("local", found))
    stores = [sorted((bytes(h), sorted(v.packed() for v in st.get()))
                     for h, st in d.store.items()) for d in c.nodes]
    return out, stores, log


@pytest.mark.parametrize("case,parent_insert", [
    ("roundtrip", True), ("missing", True), ("multiple", True),
    ("split", True), ("split", False)])
def test_host_pht_over_host_dht_equal(case, parent_insert, monkeypatch):
    want = _pht_cluster_case(case, "jax", parent_insert, monkeypatch)
    got = _pht_cluster_case(case, "port", parent_insert, monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    if case == "split":
        # All 17 inserts reported done, the 17th split the leaf (more
        # than one trie node holds a canary), and the run was cut with
        # virtual time stopped, in both packages alike.
        assert got[0][0][0] == "cut" and got[0][0][3] == [True] * 17
        canaries = {h for st in got[1] for h, vals in st
                    if any(b"canary" in v for v in vals)}
        assert len(canaries) > 1
