"""The port's node-sharded store, its listeners, chunked values and the
sharded PHT index against the JAX package's, bit for bit: groups of 2
gloo ranks (spawned once for the module, in parallel with JAX) against
JAX's ``shard_map`` storage on a ``make_mesh(2)`` slice of the
conftest's CPU mesh, on the same 512-node swarm, with JAX's per-shard
origin draws and its drop masks handed across.

* a storage sequence with ``StoreConfig(verify=True, listen_ttl=100)``:
  announce (plain with a forged row, two-phase probe with a shrunk full
  phase, with drops), listen (an id out of range), a delivering
  re-announce, get (verified), ack, refresh, listener expiry, cancel,
  churn, republish over a ``node_range`` with drops, a whole probe
  republish, get, the TTL sweep — after every step each rank's store
  shard equals its rows of JAX's store (``store_shard_from_numpy``), and
  every report (``AnnounceReport`` with its ``StoreTrace``,
  ``GetResult``) equals JAX's;
* chunked values: announce with torn parts (a part mask, drops, a
  ``part_range``), get, listen, a delivering announce, collect, ack and
  cancel;
* ``storage_wire_words`` equal JAX's (static accounting);
* a ``ShardedDeviceIndex`` build, walk and range scan: the insert
  report, stats, store, trie and results equal JAX's, and the trie and
  scans equal ``PhtOracle``'s.

Every comparison is exact."""

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import chunked_values as jcv
from opendht_tpu.models import index as ji
from opendht_tpu.models import storage as jst
from opendht_tpu.models import swarm as jsw
from opendht_tpu.ops.sha1 import sha1_words
from opendht_tpu.parallel import make_mesh
from opendht_tpu.parallel import sharded_index as jsi
from opendht_tpu.parallel import sharded_storage as jss
from opendht_tpu_torch.convert import store_shard_from_numpy
from opendht_tpu_torch.models import index as ti
from opendht_tpu_torch.parallel import mesh as pm

import torch_sharded_ranks as ranks
from torch_port_cases import (assert_same, jax_swarm, patch_index_widths,
                              port_cfg)

D = 2
P = 32
SCFG = dict(slots=4, listen_slots=2, max_listeners=64, payload_words=4,
            verify=True, listen_ttl=100)
CHUNK_SCFG = dict(slots=8, listen_slots=4, max_listeners=64, payload_words=2)
PARTS = 3
INDEX_WIDTH = 512
INDEX_OPS = 64          # origins drawn for this many index store ops


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


def drop_keep(key, rows, frac, quorum):
    """JAX's ``drop_exchanges`` draw: the kept (replica, request) pairs."""
    return np.asarray(jax.random.uniform(key, (rows, quorum)) >= frac)


def u32(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint64).astype(
                                                    np.uint32)


def _np_store(store):
    return [np.asarray(x) for x in jax.device_get(store)]


# ---------------------------------------------------------------------------
# the JAX sequences and their port plans
# ---------------------------------------------------------------------------

class Recorder:
    """Runs JAX ops on a sharded store, keeping the store after each
    step (copied: the next op donates it), and builds the port's plan of
    the same steps."""

    def __init__(self, sw, cfg, scfg, mesh):
        self.sw, self.cfg, self.scfg, self.mesh = sw, cfg, scfg, mesh
        self.store = jss.sharded_empty_store(cfg.n_nodes, scfg, mesh)
        self.plan = [{"op": "empty"}]
        self.ref = [{"store": _np_store(self.store)}]

    def add(self, step, rec=None, store=None):
        if store is not None:
            self.store = store
        self.plan.append(step)
        rec = dict(rec or {})
        rec["store"] = _np_store(self.store)
        self.ref.append(rec)

    def origins(self, key, rows):
        return shard_origins(key, self.sw.alive, rows)

    def announce(self, keys, vals, seqs, now, seed, cf=4.0, sizes=None,
                 ttls=None, payloads=None, probe=False, fcf=None, drop=0.0):
        key = jax.random.PRNGKey(seed)
        dk = jax.random.PRNGKey(seed + 1000) if drop else None
        store, rep = jss.sharded_announce(
            self.sw, self.cfg, self.store, self.scfg, jnp.asarray(keys),
            jnp.asarray(vals), jnp.asarray(seqs), now, key, self.mesh,
            capacity_factor=cf,
            sizes=None if sizes is None else jnp.asarray(sizes),
            ttls=None if ttls is None else jnp.asarray(ttls),
            payloads=None if payloads is None else jnp.asarray(payloads),
            probe=probe, full_capacity_factor=fcf, drop_frac=drop,
            drop_key=dk)
        step = dict(op="announce", keys=keys, vals=vals, seqs=seqs, now=now,
                    cf=cf, sizes=sizes, ttls=ttls, payloads=payloads,
                    probe=probe, fcf=fcf, drop=drop,
                    origins=self.origins(key, len(keys)),
                    keep=(drop_keep(dk, len(keys), drop, self.cfg.quorum)
                          if drop else None))
        self.add(step, {"report": list(rep[:3]) + [list(rep.trace)]}, store)
        return rep

    def get(self, keys, seed, cf=4.0):
        key = jax.random.PRNGKey(seed)
        res = jss.sharded_get(self.sw, self.cfg, self.store, self.scfg,
                              jnp.asarray(keys), key, self.mesh, cf)
        self.add(dict(op="get", keys=keys, cf=cf,
                      origins=self.origins(key, len(keys))),
                 {"result": list(res)})
        return res


def storage_sequence(sw, cfg, mesh):
    """The verified-store sequence; returns ``(plan, ref, alive_after)``."""
    scfg = jst.StoreConfig(**SCFG)
    rec = Recorder(sw, cfg, scfg, mesh)
    q = cfg.quorum
    pay_a = u32(1, (P, 4))
    keys_a = np.array(sha1_words(jnp.asarray(pay_a)))
    keys_a[5] = keys_a[6] ^ 1                  # forged: fails the SHA-1 gate
    vals_a = u32(2, P)
    sizes = (np.arange(P) % 16 + 1).astype(np.uint32)
    ttls = np.where(np.arange(P) % 2 == 0, 50, 0).astype(np.uint32)
    rec.announce(keys_a, vals_a, np.ones(P, np.uint32), 10, 11, sizes=sizes,
                 ttls=ttls, payloads=pay_a)
    seqs_b = np.where(np.arange(P) < 8, 2, 1).astype(np.uint32)
    rec.announce(keys_a, vals_a, seqs_b, 20, 12, sizes=sizes, ttls=ttls,
                 payloads=pay_a, probe=True, fcf=0.25)
    pay_c = u32(3, (P, 4))
    keys_c = np.array(sha1_words(jnp.asarray(pay_c)))
    vals_c = u32(4, P)
    rep_c = rec.announce(keys_c, vals_c, np.ones(P, np.uint32), 30, 13,
                         cf=2.0, payloads=pay_c, drop=0.3)
    lkeys = np.concatenate([keys_a[:16], keys_c[:16]])
    ids = np.arange(P, dtype=np.int32)
    ids[31] = 99                                # out of range: dropped
    key = jax.random.PRNGKey(14)
    store, done = jss.sharded_listen_at(sw, cfg, rec.store, scfg,
                                        jnp.asarray(lkeys), jnp.asarray(ids),
                                        key, mesh, 4.0, now=35)
    rec.add(dict(op="listen", keys=lkeys, ids=ids, cf=4.0, now=35,
                 origins=rec.origins(key, P)), {"done": done}, store)
    seqs_d = np.full(P, 3, np.uint32)
    rec.announce(keys_a, vals_a, seqs_d, 40, 15, sizes=sizes, payloads=pay_a)
    res_g = rec.get(lkeys, 16)
    ack = np.arange(4, dtype=np.int32)
    rec.add(dict(op="ack", ids=ack),
            store=jss.sharded_ack_listeners(rec.store, jnp.asarray(ack)))
    active = np.zeros(scfg.max_listeners, bool)
    active[:16] = True
    rec.add(dict(op="refresh", active=active, now=45),
            store=jss.sharded_refresh_listeners(rec.store, scfg,
                                                jnp.asarray(active), 45))
    rec.add(dict(op="expire_listeners", now=140),
            store=jss.sharded_expire_listeners(rec.store, scfg, 140))
    cancel = np.array([4, 5, 40], np.int32)
    rec.add(dict(op="cancel", ids=cancel),
            store=jss.sharded_cancel_listen(rec.store, scfg,
                                            jnp.asarray(cancel)))
    sw2 = jsw.churn(sw, jax.random.PRNGKey(17), 0.25, cfg)
    rec.sw = sw2
    rec.add(dict(op="alive", alive=np.asarray(sw2.alive)))
    # A republish over nodes [128, 384) in 64-node chunks with drops,
    # then a whole-store probe republish in 128-node chunks.
    for name, kw in (("range", dict(node_range=(128, 384), chunk=256,
                                    drop=0.2, now=50)),
                     ("probe", dict(chunk=512, probe=True, fcf=0.5,
                                    now=60))):
        key = jax.random.PRNGKey(18 if name == "range" else 19)
        dk = jax.random.PRNGKey(20) if kw.get("drop") else None
        lo, hi = kw.get("node_range", (0, cfg.n_nodes))
        cn = kw["chunk"] // scfg.slots
        store, rep = jss.sharded_republish(
            sw2, cfg, rec.store, scfg, kw["now"], key, mesh, 4.0,
            probe=kw.get("probe", False),
            full_capacity_factor=kw.get("fcf"), chunk=kw["chunk"],
            node_range=kw.get("node_range"), drop_frac=kw.get("drop", 0.0),
            drop_key=dk)
        rows = cn * scfg.slots
        n_chunks = (hi - lo) // cn
        step = dict(op="republish", cf=4.0, **kw, origins=[
            shard_origins(jax.random.fold_in(key, i), sw2.alive, rows)
            for i in range(n_chunks)])
        step["keeps"] = ([drop_keep(jax.random.fold_in(dk, i), rows,
                                    kw["drop"], q)
                          for i in range(n_chunks)] if dk is not None
                         else None)
        rec.add(step, {"report": list(rep[:3]) + [list(rep.trace)],
                       "chunk_rows": rows}, store)
    rec.get(lkeys, 21)
    rec.add(dict(op="expire", now=70),
            store=jss.sharded_expire(rec.store, scfg, 70))
    wire = []
    for kw in (dict(p=16, cf=4.0), dict(p=16, cf=2.0, probe=True),
               dict(p=256, cf=4.0, probe=True, fcf=0.5),
               dict(p=16, cf=float("inf"))):
        wire.append(jss.storage_wire_words(
            cfg, scfg, kw["p"], D, kw["cf"], probe=kw.get("probe", False),
            full_capacity_factor=kw.get("fcf")))
        rec.add(dict(op="wire", **kw), {"words": wire[-1]})
    return rec.plan, rec.ref, (rep_c, res_g)


def chunked_sequence(sw, cfg, mesh):
    """Chunked values on the mesh (verify off); ``(plan, ref)``."""
    scfg = jst.StoreConfig(**CHUNK_SCFG)
    rec = Recorder(sw, cfg, scfg, mesh)
    n = 16
    w = scfg.payload_words
    keys = u32(30, (n, 5))
    vals = u32(31, n)
    lengths = np.random.default_rng(32).integers(0, PARTS * w * 4 + 1,
                                                 n).astype(np.uint32)
    lengths[[3, 7]] = PARTS * w * 4             # every part needed
    pay = u32(33, (n, PARTS, w))
    part_drop = np.zeros((n, PARTS), bool)
    part_drop[[3, 7], 1] = True                 # torn: part 1 never sent

    def announce(seqs, seed, now, drop=0.0, part_range=None):
        key = jax.random.PRNGKey(seed)
        dk = jax.random.PRNGKey(seed + 1000) if drop else None
        store, rep = jss.sharded_announce_chunked(
            sw, cfg, rec.store, scfg, jnp.asarray(keys), jnp.asarray(vals),
            jnp.asarray(seqs), now, key, mesh, jnp.asarray(pay),
            jnp.asarray(lengths), 4.0, drop_frac=drop, drop_key=dk,
            part_drop_mask=jnp.asarray(part_drop), part_range=part_range)
        lo, hi = part_range or (0, PARTS)
        keeps = ({j: drop_keep(jax.random.fold_in(dk, j), n, drop,
                               cfg.quorum) for j in range(lo, hi)}
                 if drop else None)
        rec.add(dict(op="announce_chunked", keys=keys, vals=vals, seqs=seqs,
                     now=now, payloads=pay, lengths=lengths, cf=4.0,
                     drop=drop, part_drop=part_drop, part_range=part_range,
                     origins=rec.origins(key, n), keeps=keeps),
                {"report": list(rep[:3]) + [list(rep.trace)]}, store)

    def get(seed):
        key = jax.random.PRNGKey(seed)
        res = jss.sharded_get_chunked(sw, cfg, rec.store, scfg,
                                      jnp.asarray(keys), key, mesh, PARTS,
                                      4.0)
        rec.add(dict(op="get_chunked", keys=keys, parts=PARTS, cf=4.0,
                     origins=rec.origins(key, n)), {"result": list(res)})
        return res

    announce(np.ones(n, np.uint32), 34, 5, drop=0.2)
    res = get(35)
    ids = np.arange(n, dtype=np.int32) % 8
    ids[8:] = -1
    key = jax.random.PRNGKey(36)
    store, done = jss.sharded_listen_chunked(
        sw, cfg, rec.store, scfg, jnp.asarray(keys), jnp.asarray(ids), key,
        mesh, PARTS, 4.0, now=6)
    rec.add(dict(op="listen_chunked", keys=keys, ids=ids, parts=PARTS,
                 cf=4.0, now=6, origins=rec.origins(key, n)),
            {"done": done}, store)
    announce(np.full(n, 2, np.uint32), 37, 7, part_range=(0, 2))
    announce(np.full(n, 3, np.uint32), 38, 8)
    get(39)
    cids = np.arange(8, dtype=np.int32)
    col = jcv.collect_chunked(rec.store, scfg, jnp.asarray(cids), PARTS)
    rec.add(dict(op="collect_chunked", ids=cids, parts=PARTS),
            {"result": list(col), "whole": True})
    rec.add(dict(op="ack_chunked", ids=cids[:4], parts=PARTS),
            store=jss.sharded_ack_chunked(rec.store, jnp.asarray(cids[:4]),
                                          PARTS))
    rec.add(dict(op="cancel_chunked", ids=cids[4:6], parts=PARTS),
            store=jss.sharded_cancel_chunked(rec.store, scfg,
                                             jnp.asarray(cids[4:6]), PARTS))
    return rec.plan, rec.ref, (res, col)


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------

SPEC_ARGS = ("conf", {"id": 4})


def index_keyset():
    """24 entries over 16 two-byte keys (8 repeated with a second vid)."""
    r = np.random.default_rng(11)
    raw = [bytes([a, b]) for a in b"ab" for b in b"abcdefgh"]
    raw = raw + [raw[i] for i in r.choice(16, 8, replace=False)]
    ehash = np.stack([np.frombuffer(hashlib.sha1(b"e%d" % i).digest(),
                                    dtype=">u4") for i in range(len(raw))]
                     ).astype(np.uint32)
    return [{"id": k} for k in raw], ehash, np.arange(len(raw),
                                                      dtype=np.uint32)


INDEX_RANGES = ([{"id": b"\x00"}, {"id": b"ae"}, {"id": b"zz"}],
                [{"id": b"ac"}, {"id": b"bb"}, {"id": b"zzz"}])


def index_draws(sw, seed=3):
    """Op ``i``'s origins for the whole padded batch: JAX's sharded get
    and put draw ``fold_in(fold_in(PRNGKey(seed), i), shard)``."""
    root = jax.random.PRNGKey(seed)
    return {i: shard_origins(jax.random.fold_in(root, i), sw.alive,
                             INDEX_WIDTH) for i in range(1, INDEX_OPS + 1)}


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    sw, cfg = jax_swarm()
    np_sw = tuple(np.array(x) for x in (sw.ids, sw.tables, sw.alive))
    cfg_d = port_cfg(cfg)._asdict()
    mesh = make_mesh(D)
    spec_j = ji.IndexSpec.from_key_spec(*SPEC_ARGS)
    iscfg = dict(slots=24, listen_slots=1, max_listeners=64,
                 payload_words=spec_j.payload_words)
    keys, ehash, evid = index_keyset()
    draws = index_draws(sw)
    out = {}
    with ThreadPoolExecutor(3) as ex:
        # The index ranks need only the draws: start them first.
        fut_ix = ex.submit(pm.spawn, ranks.index_build, D, backend="gloo",
                           device="cpu", args=(np_sw, cfg_d, iscfg, SPEC_ARGS,
                                               INDEX_WIDTH, keys, ehash, evid,
                                               draws, INDEX_RANGES),
                           timeout=30.0, limit=240.0, threads=1)
        plan_s, ref_s, keep_s = storage_sequence(sw, cfg, mesh)
        fut_s = ex.submit(pm.spawn, ranks.storage_steps, D, backend="gloo",
                          device="cpu", args=(np_sw, cfg_d, SCFG, plan_s),
                          timeout=30.0, limit=240.0, threads=1)
        plan_c, ref_c, keep_c = chunked_sequence(sw, cfg, mesh)
        fut_c = ex.submit(pm.spawn, ranks.storage_steps, D, backend="gloo",
                          device="cpu", args=(np_sw, cfg_d, CHUNK_SCFG,
                                              plan_c),
                          timeout=30.0, limit=240.0, threads=1)
        mp = pytest.MonkeyPatch()
        patch_index_widths(mp, INDEX_WIDTH)
        try:
            ixj = jsi.ShardedDeviceIndex(
                sw, cfg, jss.sharded_empty_store(
                    cfg.n_nodes, jst.StoreConfig(**iscfg), mesh),
                jst.StoreConfig(**iscfg), spec_j, mesh, seed=3)
            ins = ixj.insert_batch(keys, ehash, evid)
            found = ixj.lookup_batch(keys[:4])
            lo, hi = INDEX_RANGES
            scan = ixj.range_query(ixj.linearize(lo), ixj.linearize(hi))
            out["index_ref"] = dict(insert=ins, lookup=found, scan=scan,
                                    stats=dict(ixj.stats),
                                    trie=ixj.trie_snapshot(),
                                    store=_np_store(ixj.store), ops=ixj._op)
            out["index_bits"] = ixj.linearize(keys)
            out["index_ranges"] = (ixj.linearize(lo), ixj.linearize(hi))
        finally:
            mp.undo()
        out["storage"] = (ref_s, fut_s.result(), keep_s)
        out["chunked"] = (ref_c, fut_c.result(), keep_c)
        out["index"] = fut_ix.result()
    out["spec"] = ti.IndexSpec.from_key_spec(*SPEC_ARGS)
    return out


def _check_sequence(ref, got, what):
    for i, rj in enumerate(ref):
        for r, o in enumerate(got):
            rt = o["steps"][i]
            assert_same(store_shard_from_numpy(*rj["store"], rank=r, size=D,
                                               device="cpu"),
                        rt["store"], f"{what} step {i}: rank {r}'s store")
            for k in ("result", "done"):
                if k in rj:
                    m = len(rj[k][0]) // D if k == "result" else \
                        len(rj[k]) // D
                    sl = slice(r * m, (r + 1) * m)
                    if k == "done":
                        assert np.array_equal(np.asarray(rj[k])[sl], rt[k])
                    elif rj.get("whole"):
                        assert_same(rj[k], rt[k], f"{what} step {i}")
                    else:
                        assert_same([np.asarray(x)[sl] for x in rj[k]],
                                    rt[k], f"{what} step {i}: {k}")
            if "report" in rj:
                rows = rj.get("chunk_rows")
                rep_j = [np.asarray(x) for x in rj["report"][:3]]
                if rows:          # republish: rank r's rows of each chunk
                    m = rows // D
                    sl = np.concatenate([np.arange(c + r * m, c + (r + 1) * m)
                                         for c in range(0, len(rep_j[0]),
                                                        rows)])
                else:
                    m = len(rep_j[0]) // D
                    sl = np.arange(r * m, (r + 1) * m)
                assert_same([x[sl] for x in rep_j], rt["report"][:3],
                            f"{what} step {i}: report rows")
                assert_same(rj["report"][3], rt["report"][3],
                            f"{what} step {i}: trace")
            if "words" in rj:
                assert rt["words"] == rj["words"]


def test_storage_sequence_equal(runs):
    """Each step's store shards and reports equal JAX's on every rank; the
    sequence exercised a forged row, refreshes, drops, delivered
    listeners, a dropped out-of-range listener and a churned republish
    that raised replication."""
    ref, got, (rep_c, res_g) = runs["storage"]
    _check_sequence(ref, got, "storage")
    traces = {i: dict(zip(jst.StoreTrace._fields, map(int, r["report"][3])))
              for i, r in enumerate(ref) if "report" in r}
    first, probe = traces[1], traces[2]
    assert first["integrity_rejects"] > 0 and first["accepts_new"] > 0
    assert probe["accepts_update"] > 0
    assert (np.asarray(rep_c.replicas) < 8).any()          # drops cost
    assert np.asarray(res_g.hit).sum() > P // 2
    delivered = next(r for r in ref if "done" in r)
    assert delivered is not None
    st = store_shard_from_numpy(*ref[-6]["store"], rank=0, size=1,
                                device="cpu")
    assert int(st.notified.sum()) > 0


def test_chunked_equal(runs):
    """Chunked puts (torn parts, drops, a part range), gets, listeners,
    collect, ack and cancel: stores, reports and results equal JAX's; a
    torn value reads missing and some listeners collect whole values."""
    ref, got, (res, col) = runs["chunked"]
    _check_sequence(ref, got, "chunked")
    hit = np.asarray(res.hit)
    assert not hit[[3, 7]].any() and hit.sum() > 0
    assert np.asarray(col.ready).any()


def test_storage_wire_words_equal(runs):
    ref, got, _ = runs["storage"]
    words = [r["words"] for r in ref if "words" in r]
    assert len(words) == 4 and words[0] != words[1]
    for o in got:
        assert [s["words"] for s in o["steps"] if "words" in s] == words


def test_sharded_index_equal(runs):
    """A ``ShardedDeviceIndex`` build, walk and scan: the insert report,
    op count, stats, store shards, trie and results equal JAX's on every
    rank; the trie and scans equal the oracle's."""
    rj = runs["index_ref"]
    assert rj["ops"] <= INDEX_OPS
    spec = runs["spec"]
    keys, ehash, evid = index_keyset()
    orc = ti.PhtOracle(spec)
    for r, o in enumerate(runs["index"]):
        assert o["insert"] == rj["insert"] and o["ops"] == rj["ops"]
        assert o["stats"] == rj["stats"]
        assert o["trie"] == rj["trie"]
        assert np.array_equal(rj["lookup"][0], o["lookup"][0])
        assert rj["lookup"][1] == o["lookup"][1]
        assert rj["scan"][0] == o["scan"][0]
        assert np.array_equal(rj["scan"][1], o["scan"][1])
        assert_same(store_shard_from_numpy(*rj["store"], rank=r, size=D,
                                           device="cpu"), o["store"],
                    f"index store, rank {r}")
    assert rj["insert"]["splits"] > 0
    bits = runs["index_bits"]
    for i in range(len(keys)):
        orc.insert(bits[i], ehash[i].astype(">u4").tobytes(), int(evid[i]))
    assert rj["trie"][0] == orc.leaves()
    lo_b, hi_b = runs["index_ranges"]
    for q in range(len(lo_b)):
        assert set(rj["scan"][0][q]) == orc.entries_in_range(lo_b[q], hi_b[q])
    assert rj["scan"][0][0] and not rj["scan"][0][2]


def test_jax_routed_equals_local_at_one_rank():
    """At one rank and ``capacity_factor=inf`` JAX's routed announce and
    get equal its local ones from the same origins (the sharded draw
    ``fold_in(key, 0)``): store, report, trace and get result — the
    identity ``chip_smoke.py`` then asserts on the card."""
    sw, cfg = jax_swarm()
    mesh1 = make_mesh(1)
    scfg = jst.StoreConfig(**SCFG)
    pay = u32(50, (P, 4))
    keys = jnp.asarray(sha1_words(jnp.asarray(pay)))
    vals = jnp.asarray(u32(51, P))
    seqs = jnp.ones((P,), jnp.uint32)
    k_put, k_get = jax.random.PRNGKey(52), jax.random.PRNGKey(53)
    inf = float("inf")
    s_r, rep_r = jss.sharded_announce(
        sw, cfg, jss.sharded_empty_store(cfg.n_nodes, scfg, mesh1), scfg,
        keys, vals, seqs, 5, k_put, mesh1, capacity_factor=inf,
        payloads=jnp.asarray(pay))
    s_l, rep_l = jst.announce(sw, cfg, jst.empty_store(cfg.n_nodes, scfg),
                              scfg, keys, vals, seqs, 5,
                              jax.random.fold_in(k_put, 0),
                              payloads=jnp.asarray(pay))
    s_r, s_l = _np_store(s_r), _np_store(s_l)
    assert_same(s_l, s_r, "store")
    assert_same(list(rep_l[:3]) + list(rep_l.trace),
                list(rep_r[:3]) + list(rep_r.trace), "announce report")
    g_r = jss.sharded_get(sw, cfg, jss.shard_store(
        jst.SwarmStore(*map(jnp.asarray, s_r)), mesh1), scfg, keys, k_get,
        mesh1, inf)
    g_l = jst.get_values(sw, cfg, jst.SwarmStore(*map(jnp.asarray, s_l)),
                         scfg, keys, jax.random.fold_in(k_get, 0))
    assert_same(list(g_l), list(g_r), "get result")
    assert int(np.asarray(g_r.hit).sum()) == P
