"""The port's storage plane against the JAX package's, bit for bit: the
raw insert (monotone seq, in-batch dedup, ring eviction, per-batch node
overflow, same-batch refresh + new key, equal-seq / different-bytes
rejection, the byte budget with its wrap case, per-value TTL, the
``verify`` gate with forged rows), the helpers, the geometry check, and
whole announce / get / listen / ack / cancel / refresh / expire /
republish sequences on one shared swarm.  After every step every store
field, the ``StoreTrace``, the reports and the ``GetResult`` are
compared exactly; JAX's flat key, payload and listener arrays are
compared with the port's shaped ones element for element.  JAX's
origins and drop masks are handed across."""

import hashlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.models import storage as jst
from opendht_tpu.models import swarm as jsw
from opendht_tpu_torch.convert import store_from_numpy, swarm_from_numpy
from opendht_tpu_torch.models import storage as tst
from opendht_tpu_torch.models import swarm as tsw

from torch_port_cases import as_int64, assert_same, to_torch

M = 16                       # request rows of every raw insert
W = 4                        # payload words
BASE = dict(slots=4, listen_slots=2, max_listeners=64, ttl=20,
            payload_words=W)
SCFG_U = jst.StoreConfig(**BASE)                        # unverified
SCFG_B = jst.StoreConfig(**BASE, budget=10)             # byte budget
SCFG_V = jst.StoreConfig(**BASE, listen_ttl=10, verify=True)
N, P = 512, 32
CFG_J = jsw.SwarmConfig.for_nodes(N)
CFG_T = tsw.SwarmConfig.for_nodes(N, device="cpu")


def port_cfg(scfg):
    return tst.StoreConfig(*scfg)


def content(seed, p):
    """``p`` random payloads ``[p, W]`` uint32 and their SHA-1 keys
    (``hashlib`` over the big-endian bytes)."""
    pl = np.random.default_rng(seed).integers(0, 2**32, (p, W),
                                              dtype=np.uint32)
    keys = np.stack([np.frombuffer(hashlib.sha1(r.astype(">u4").tobytes())
                                   .digest(), ">u4") for r in pl])
    return pl, keys.astype(np.uint32)


def assert_store_same(js, ts, what):
    for name in jst.SwarmStore._fields:
        a = as_int64(getattr(js, name)).reshape(-1)
        b = as_int64(getattr(ts, name)).reshape(-1)
        assert np.array_equal(a, b), f"{what}: store field {name} diverged"


def assert_trace_same(tj, tt, what):
    assert tj.to_dict() == tt.to_dict(), what


class Pair:
    """A JAX store and the port's copy of it, stepped together."""

    def __init__(self, n, scfg):
        self.scfg, self.scfg_t = scfg, port_cfg(scfg)
        self.j = jst.empty_store(n, scfg)
        self.t = tst.empty_store(n, self.scfg_t, device="cpu")
        assert_store_same(self.j, self.t, "empty store")

    def insert(self, rows, now, what):
        """``rows``: (node, key [5], val, seq, payload [W], size, ttl)
        tuples, padded to ``M`` with skipped rows (node -1)."""
        pad = (-1, np.zeros(5, np.uint32), 0, 0, np.zeros(W, np.uint32), 1,
               0)
        rows = list(rows) + [pad] * (M - len(rows))
        node = np.array([r[0] for r in rows], np.int32)
        key = np.stack([np.asarray(r[1], np.uint32) for r in rows])
        val, seq, size, ttl = (np.array([r[i] for r in rows], np.uint32)
                               for i in (2, 3, 5, 6))
        pl = np.stack([np.asarray(r[4], np.uint32) for r in rows])
        put = np.arange(M, dtype=np.int32)
        args = (node, key, val, seq, put)
        self.j, rep_j, tr_j = jst._store_insert(
            self.j, self.scfg, *(jnp.asarray(x) for x in args),
            jnp.uint32(now), jnp.asarray(size), jnp.asarray(ttl),
            jnp.asarray(pl))
        self.t, rep_t, tr_t = tst._store_insert(
            self.t, self.scfg_t, *(to_torch(x) for x in args), now,
            to_torch(size), to_torch(ttl), to_torch(pl))
        assert_store_same(self.j, self.t, what)
        assert_same([rep_j], [rep_t], f"{what}: replicas")
        assert_trace_same(tr_j, tr_t, f"{what}: trace")
        assert_trace_same(tr_j, tr_t + tst.StoreTrace.zeros(),
                          f"{what}: trace + zeros")
        return np.asarray(rep_j), tr_j.to_dict()

    def sweep(self, fn_j, fn_t, what):
        self.j, self.t = fn_j(self.j), fn_t(self.t)
        assert_store_same(self.j, self.t, what)


def row(node, seed, val, seq, size=1, ttl=0, pl=None):
    p, k = content(seed, 1)
    return (node, k[0], val, seq, p[0] if pl is None else pl, size, ttl)


def test_insert_edit_policy():
    """Monotone seq on one key: new, higher, stale, equal-seq refresh of
    the same token and bytes, equal seq with another token, equal seq
    with other bytes; then in-batch dedup keeping the highest seq."""
    s = Pair(8, SCFG_U)
    pl = content(1, 1)[0][0]
    other = pl ^ np.uint32(1)
    for val, seq, p, want in ((10, 5, pl, 1), (11, 6, pl, 1), (12, 4, pl, 0),
                              (11, 6, pl, 1), (12, 6, pl, 0),
                              (11, 6, other, 0)):
        rep, _ = s.insert([row(1, 1, val, seq, pl=p)], 0,
                          f"seq {seq} val {val}")
        assert rep[0] == want
    rep, tr = s.insert([row(2, 3, 7, 1), row(2, 3, 8, 3), row(2, 3, 9, 2),
                        row(3, 3, 4, 1), row(3, 3, 5, 1)], 1, "dedup")
    assert tr["requests"] == 5 and tr["accepts_new"] == 2


def test_insert_ring_and_overflow():
    """Six keys through a four-slot ring, one a batch; seven new keys to
    one node in one batch (four kept); a refresh and a new key whose
    ring slot is the refreshed one, in one batch."""
    s = Pair(8, SCFG_U)
    for i in range(6):
        s.insert([row(0, 10 + i, i, 0)], i, f"ring {i}")
    rep, _ = s.insert([row(2, 20 + i, i, 0) for i in range(7)], 7,
                      "overflow")
    assert rep[:7].sum() == 4
    s.insert([row(4, 30, 1, 0), row(4, 31, 2, 0), row(4, 32, 1, 0),
              row(4, 33, 2, 0)], 8, "fill")
    rep, _ = s.insert([row(4, 30, 10, 5), row(4, 34, 3, 0)], 9,
                      "refresh + new")
    assert rep[0] == 1


def test_insert_byte_budget():
    """Budget 10: oversize, two new keys that fit alone but not
    together, a growing refresh, two growing refreshes in one batch, a
    shrinking refresh, and sizes of 2^31 and 2^32-1 (the wrap case)."""
    s = Pair(8, SCFG_B)
    s.insert([row(0, 40, 1, 1, size=11)], 0, "oversize")
    s.insert([row(1, 41, 1, 1, size=6), row(1, 42, 2, 1, size=6)], 0,
             "pair over budget")
    s.insert([row(2, 43, 1, 1), row(2, 44, 2, 1)], 0, "base")
    s.insert([row(2, 43, 3, 2, size=9), row(2, 44, 4, 2, size=9)], 1,
             "in-batch growth")
    s.insert([row(2, 43, 5, 3, size=1)], 2, "shrink")
    s.insert([row(3, 45, 1, 1, size=2**31), row(3, 46, 1, 1,
                                                 size=2**32 - 1),
              row(3, 47, 1, 1, size=3)], 3, "wrap")
    s.insert([row(1, 41, 7, 2, size=100)], 4, "growing refresh")
    stored = np.asarray(jnp.sum(jnp.where(s.j.used, s.j.sizes, 0), axis=1))
    assert stored.max() <= 10


def test_insert_ttl_and_expire():
    """Per-value TTLs (0 falls back to the config's 20) swept at several
    times, including one before the values were stored (the u32 age
    wraps)."""
    s = Pair(8, SCFG_U)
    s.insert([row(0, 50, 1, 1, ttl=0), row(0, 51, 2, 1, ttl=3),
              row(1, 52, 3, 1, ttl=50), row(1, 53, 4, 1, ttl=2**32 - 1)],
             100, "ttl values")
    for now in (101, 104, 99, 121, 151, 2**31 - 1):
        s.sweep(lambda st: jst.expire(st, SCFG_U, now),
                lambda st: tst.expire(st, s.scfg_t, now), f"expire {now}")


def test_insert_verify_forged_rows():
    """The integrity gate: honest rows and forged ones (a flipped key
    bit, corrupted bytes, a key of another payload)."""
    s = Pair(8, SCFG_V)
    rows = [row(i % 5, 60 + i, i, 1) for i in range(9)]
    n, k, v, q, p, z, t = rows[0]
    rows.append((6, k ^ np.uint32(1), 1, 1, p, 1, 0))
    rows.append((6, k, 1, 2, p ^ np.uint32(4), 1, 0))
    rows.append((7, content(99, 1)[1][0], 1, 1, p, 1, 0))
    rep, tr = s.insert(rows, 0, "verify")
    assert tr["integrity_rejects"] == 3
    assert tr["requests"] == (tr["accepts_update"] + tr["accepts_new"]
                              + tr["rejects"] + tr["integrity_rejects"])


def test_helpers_bit_equal():
    r = np.random.default_rng(4)
    pl = r.integers(0, 2**32, (33, 7), dtype=np.uint32)
    assert_same([jst._payload_digest(jnp.asarray(pl))],
                [tst._payload_digest(to_torch(pl))], "payload digest")
    node = np.sort(r.integers(0, 9, 40)).astype(np.int32)
    flag = r.random(40) < 0.6
    assert_same([jst._segment_rank(jnp.asarray(node), jnp.asarray(flag))],
                [tst._segment_rank(to_torch(node).long(),
                                   torch.from_numpy(flag))], "segment rank")
    alive = r.random(N) < 0.7
    req = r.integers(-1, N, 50).astype(np.int32)
    assert_same([jst._mask_dead_idx(jnp.asarray(alive), CFG_J,
                                    jnp.asarray(req))],
                [tst._mask_dead_idx(torch.from_numpy(alive), CFG_T,
                                    to_torch(req))], "mask dead")
    assert all(jst.pow2_width(m, f) == tst.pow2_width(m, f)
               for m in (0, 1, 255, 256, 257, 5000) for f in (1, 256))
    win = r.random((20, 6)) < 0.3
    pls = r.integers(0, 2**32, (20, 6, 3), dtype=np.uint32)
    hit = win.any(axis=1)
    assert_same([jst._pick_payload(jnp.asarray(win), jnp.asarray(pls),
                                   jnp.asarray(hit))],
                [tst._pick_payload(torch.from_numpy(win), to_torch(pls),
                                   torch.from_numpy(hit))], "pick payload")


@pytest.mark.parametrize("n,kw", [
    (10_000_000, dict(slots=16, payload_words=8)),
    (10_000_000, dict(slots=4, payload_words=64)),
    (10_000_000, dict(slots=16, payload_words=16)),
    (200_000_000, dict(slots=4, listen_slots=4)),
    (1000, dict(max_listeners=2**31)),
    (1000, dict(verify=True)),
    (1000, dict(verify=True, payload_words=2)),
])
def test_validate_store_geometry(n, kw):
    """The port refuses exactly the configurations JAX refuses, with the
    same message."""
    def outcome(mod):
        try:
            mod.validate_store_geometry(n, mod.StoreConfig(**kw))
        except ValueError as e:
            return str(e)
        return None

    assert outcome(tst) == outcome(jst)
    if outcome(jst) is not None:
        with pytest.raises(ValueError):
            tst.empty_store(n, tst.StoreConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# whole sequences on one swarm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def swarm():
    return jsw.build_swarm(jax.random.PRNGKey(0), CFG_J)


def to_port(sw):
    return swarm_from_numpy(np.asarray(sw.ids), np.asarray(sw.tables),
                            np.asarray(sw.alive), device="cpu")


def origins(sw, seed, l=P):
    return torch.from_numpy(np.array(jsw._sample_origins(
        jax.random.PRNGKey(seed), sw.alive, l)))


class Plane:
    """A JAX store on a swarm and the port's copy, driven together."""

    def __init__(self, sw, scfg):
        self.sw, self.sw_t = sw, to_port(sw)
        self.scfg, self.scfg_t = scfg, port_cfg(scfg)
        self.j = jst.empty_store(N, scfg)
        self.t = store_from_numpy(*map(np.asarray, self.j), device="cpu")

    def check(self, what):
        assert_store_same(self.j, self.t, what)
        assert (tst.store_stats(self.t).to_dict()
                == jst.store_stats(self.j).to_dict()), what

    def announce(self, keys, vals, seqs, now, seed, payloads, what,
                 drop=0.0, **kw):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: to_torch(v) for k, v in kw.items()}
        dk = jax.random.PRNGKey(seed + 1000) if drop else None
        self.j, rep_j = jst.announce(
            self.sw, CFG_J, self.j, self.scfg, jnp.asarray(keys),
            jnp.asarray(vals), jnp.asarray(seqs), now,
            jax.random.PRNGKey(seed), payloads=jnp.asarray(payloads),
            drop_frac=drop, drop_key=dk, **jkw)
        keep = None
        if drop:
            keep = torch.from_numpy(np.array(jax.random.uniform(
                dk, (len(keys), CFG_J.quorum)) >= drop))
        self.t, rep_t = tst.announce(
            self.sw_t, CFG_T, self.t, self.scfg_t, to_torch(keys),
            to_torch(vals), to_torch(seqs), now,
            payloads=to_torch(payloads), drop_frac=drop, drop_keep=keep,
            origins=origins(self.sw, seed, len(keys)), device="cpu", **tkw)
        assert_same(rep_j[:3], rep_t[:3], f"{what}: report")
        assert_trace_same(rep_j.trace, rep_t.trace, f"{what}: trace")
        self.check(what)
        return rep_j

    def get(self, keys, seed, what):
        g_j = jst.get_values(self.sw, CFG_J, self.j, self.scfg,
                             jnp.asarray(keys), jax.random.PRNGKey(seed))
        g_t = tst.get_values(self.sw_t, CFG_T, self.t, self.scfg_t,
                             to_torch(keys), origins=origins(self.sw, seed,
                                                             len(keys)),
                             device="cpu")
        assert_same(g_j, g_t, f"{what}: get result")
        return g_j

    def listen(self, keys, regs, now, seed, what):
        self.j, res_j = jst.listen_at(
            self.sw, CFG_J, self.j, self.scfg, jnp.asarray(keys),
            jnp.asarray(regs), jax.random.PRNGKey(seed), now)
        self.t, res_t = tst.listen_at(
            self.sw_t, CFG_T, self.t, self.scfg_t, to_torch(keys),
            to_torch(regs), now=now, origins=origins(self.sw, seed,
                                                     len(keys)),
            device="cpu")
        assert_same(res_j, res_t, f"{what}: lookup")
        self.check(what)

    def sweep(self, name, *args, what):
        self.j = getattr(jst, name)(self.j, *(
            jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args))
        self.t = getattr(tst, name)(self.t, *(
            to_torch(a) if isinstance(a, np.ndarray) else
            (self.scfg_t if a is self.scfg else a) for a in args))
        self.check(what)


def test_put_get_listen_sequence(swarm):
    """announce (three forged rows, per-value TTLs, 20 % of exchanges
    dropped) → get → listen (one id out of range) → seq-2 re-announce
    (delivered) → ack → equal-seq re-announce (re-delivered) → cancel →
    refresh → listener expiry → seq-3 announce → value expiry → get.
    Every batch holds the same ``P`` keys (JAX compiles one program per
    batch shape): later announces refresh the keys they do not change,
    and the listen registers ids for the first 16 keys only."""
    pl, keys = content(7, P)
    keys[:3, 4] ^= 1                              # forged content ids
    vals = np.arange(P, dtype=np.uint32) + 1
    ttls = np.where(np.arange(P) % 3 == 0, 0, 40).astype(np.uint32)
    head = np.arange(P) < 16

    def seqs(changed, seq):
        return np.where(changed, seq, 1).astype(np.uint32)

    s = Plane(swarm, SCFG_V)
    rep = s.announce(keys, vals, np.ones(P, np.uint32), 1, 11, pl, "put",
                     drop=0.2, ttls=ttls)
    assert rep.trace.to_dict()["integrity_rejects"] > 0
    g = s.get(keys, 12, "get")
    assert not bool(np.asarray(g.hit)[:3].any())
    assert np.array_equal(np.asarray(g.payload)[np.asarray(g.hit)],
                          pl[np.asarray(g.hit)])
    regs = np.where(head, np.arange(P), -1).astype(np.int32)
    regs[15] = 99                                  # out of range: dropped
    s.listen(keys, regs, 2, 13, "listen")
    v2 = np.where(head, vals + 100, vals).astype(np.uint32)
    s.announce(keys, v2, seqs(head, 2), 3, 14, pl, "seq-2 re-announce")
    assert bool(np.asarray(s.j.notified)[3:15].all())
    s.sweep("ack_listeners", np.arange(4, dtype=np.int32), what="ack")
    s.announce(keys, v2, seqs(head, 2), 4, 15, pl, "equal-seq re-announce")
    s.sweep("cancel_listen", s.scfg, np.array([4, 5, 200], np.int32),
            what="cancel")
    active = np.zeros(SCFG_V.max_listeners, bool)
    active[6:10] = True
    s.sweep("refresh_listeners", s.scfg, active, 8, what="refresh")
    s.sweep("expire_listeners", s.scfg, 13, what="listener expiry")
    s.announce(keys, np.where(head, vals + 200, vals).astype(np.uint32),
               seqs(head, 3), 14, 16, pl, "seq-3 announce")
    s.sweep("expire", s.scfg, 30, what="value expiry")
    s.get(keys, 17, "get after expiry")


@pytest.mark.parametrize("compact", [True, False])
def test_republish_after_churn(compact, swarm):
    """announce → churn (JAX's mask) → ``republish_from`` over 128 alive
    nodes, compacted or not, with phase timing on → get: store, report,
    trace and the lookup-row count."""
    pl, keys = content(8, P)
    vals = np.arange(P, dtype=np.uint32) + 1
    s = Plane(swarm, SCFG_V)
    s.announce(keys, vals, np.ones(P, np.uint32), 0, 21, pl, "put")
    churned = jsw.churn(swarm, jax.random.PRNGKey(22), 0.3, CFG_J)
    s.sw, s.sw_t = churned, to_port(churned)
    node_idx = np.flatnonzero(np.asarray(churned.alive))[:128].astype(
        np.int32)
    st_j, st_t = {}, {"time_phases": True}
    s.j, rep_j = jst.republish_from(
        churned, CFG_J, s.j, SCFG_V, jnp.asarray(node_idx), 5,
        jax.random.PRNGKey(23), stats=st_j, compact=compact)
    rows = st_j["lookup_rows"]
    assert (rows < len(node_idx) * SCFG_V.slots) == compact
    s.t, rep_t = tst.republish_from(
        s.sw_t, CFG_T, s.t, s.scfg_t, to_torch(node_idx), 5, stats=st_t,
        compact=compact, origins=origins(churned, 23, rows), device="cpu")
    assert st_t["lookup_rows"] == rows
    assert st_t["batch_rows"] == st_j["batch_rows"]
    assert st_t["sweep_total_s"] >= st_t["lookup_s"] >= 0
    assert_same(rep_j[:3], rep_t[:3], "republish report")
    assert_trace_same(rep_j.trace, rep_t.trace, "republish trace")
    s.check("republish")
    s.get(keys, 24, "get after republish")
