"""The port's host Kademlia node against the JAX package's.

One scenario runs through each package's ``DhtNetwork``: 32 nodes and
one dual-stack node on a fixed seed, ``interconnect``, 10 virtual
seconds, then puts, gets, listens, a query, a cancelled listen, a
cancelled put, a ``kill``, a ``replace_cluster``, 15 % loss and a
dual-stack get.  ``os.urandom`` (token secrets, ``InfoHash.get_random``)
and the global ``random`` (``Value.random_id``) draw from one seeded
stream, reset before each package's run.  Every datagram is recorded by
wrapping the cluster's ``VirtualNetwork.deliver``.  JAX's run repeats
itself under that patch at the finest level, the datagram log (the
first test shows it), so the two packages are compared there: the
datagram logs byte for byte, every node's buckets in order, every
store, ``stats_in`` / ``stats_out``, the callback sequence, the
rendered metrics and the routing-table, search and storage logs.

Then unit cases: the routing table, the scheduler, the node cache,
storage, the rate limiters, and the native library against its
pure-Python twin and against JAX's."""

import os
import random

import numpy as np
import pytest

import opendht_tpu.core.node as jnode
import opendht_tpu.core.node_cache as jnc
import opendht_tpu.core.routing_table as jrt
import opendht_tpu.core.scheduler as jsch
import opendht_tpu.core.storage as jst
import opendht_tpu.core.value as jv
import opendht_tpu.harness.network as jnet
import opendht_tpu.native as jnative
import opendht_tpu.utils.clock as jclock
import opendht_tpu.utils.infohash as jih
import opendht_tpu.utils.rate_limiter as jrl
import opendht_tpu.utils.sockaddr as jsa
import opendht_tpu_torch.core.node as tnode
import opendht_tpu_torch.core.node_cache as tnc
import opendht_tpu_torch.core.routing_table as trt
import opendht_tpu_torch.core.scheduler as tsch
import opendht_tpu_torch.core.storage as tst
import opendht_tpu_torch.core.value as tv
import opendht_tpu_torch.harness.network as tnet
import opendht_tpu_torch.native as tnative
import opendht_tpu_torch.utils.clock as tclock
import opendht_tpu_torch.utils.infohash as tih
import opendht_tpu_torch.utils.rate_limiter as trl
import opendht_tpu_torch.utils.sockaddr as tsa

PKGS = {
    "jax": dict(net=jnet, v=jv, ih=jih, sa=jsa, rt=jrt, node=jnode,
                nc=jnc, sch=jsch, st=jst, clock=jclock, rl=jrl,
                native=jnative),
    "port": dict(net=tnet, v=tv, ih=tih, sa=tsa, rt=trt, node=tnode,
                 nc=tnc, sch=tsch, st=tst, clock=tclock, rl=trl,
                 native=tnative),
}


def seed_draws(monkeypatch, seed=1234):
    """One seeded stream for ``os.urandom`` and the global ``random``."""
    stream = random.Random(seed)
    monkeypatch.setattr(os, "urandom", lambda n: stream.randbytes(n))
    random.seed(seed + 1)


def _bucket_rows(table):
    return [(bytes(b.first), b.af, b.time,
             [(bytes(n.id), str(n.addr), n.time, n.reply_time,
               n.is_expired(), n.auth_errors) for n in b.nodes],
             None if b.cached is None else bytes(b.cached.id))
            for b in table.buckets]


def _store_rows(dht):
    return sorted(
        (bytes(h), st.value_count(), st.total_size,
         sorted((vs.value.packed(), vs.created) for vs in st.values),
         sorted((_plain(k), sorted((bytes(sid), l.socket_id, l.time,
                                   l.query.pack() if l.query else None)
                                  for sid, l in ls.items()))
                for k, ls in st.listeners.items()),
         len(st.local_listeners))
        for h, st in dht.store.items())


def run_cluster(pkg, monkeypatch):
    """The scenario through one package; returns the datagram log and
    what the comparisons read."""
    P = PKGS[pkg]
    IH, Value, AF_INET, AF_INET6 = (P["ih"].InfoHash, P["v"].Value,
                                    P["sa"].AF_INET, P["sa"].AF_INET6)
    seed_draws(monkeypatch)
    log, cbs = [], []
    net = P["net"].DhtNetwork(32, seed=5)
    orig = net.net.deliver

    def deliver(data, src, dest):
        log.append((net.clock.now(), str(src), str(dest), bytes(data)))
        orig(data, src, dest)

    net.net.deliver = deliver
    dual = net.add_node(family="dual")
    net.interconnect()
    net.run(10.0)
    nodes = net.nodes
    k1, k2 = IH.get("k1"), IH.get("k2")

    def cb(tag):
        return lambda *a: cbs.append((tag,) + tuple(_plain(x) for x in a))

    def vcb(tag, keep=True):
        return lambda vals, *a: cbs.append(
            (tag, [v.packed() for v in vals]) + tuple(_plain(x) for x in a)
        ) or keep

    nodes[1].put(k1, Value(b"hello", value_id=11), cb("put1"))
    nodes[6].put(k2, Value(b"random id"), cb("put_rid"))
    tok = nodes[2].listen(k1, vcb("listen"))
    net.run(3.0)
    nodes[3].get(k1, vcb("get_v"), cb("get_done"))
    nodes[7].query(k1, lambda fields: cbs.append(
        ("query", [repr(f) for f in fields])) or True, cb("query_done"))
    net.run(3.0)
    nodes[4].put(k1, Value(b"second", value_id=12), cb("put2"))
    nodes[8].put(k2, Value(b"cancelled", value_id=13), cb("put3"),
                 permanent=True)
    net.run(3.0)
    cbs.append(("cancel_listen", nodes[2].cancel_listen(k1, tok)))
    cbs.append(("cancel_put", nodes[8].cancel_put(k2, 13)))
    net.kill(nodes[5])
    fresh = net.replace_cluster(4)
    cbs.append(("fresh", [bytes(d.myid) for d in fresh]))
    net.run(5.0)
    net.net.loss = 0.15
    dual.get(k1, vcb("dual_get"), cb("dual_done"))
    nodes[9].get(IH.get_random(), vcb("miss_get"), cb("miss_done"))
    net.run(10.0)
    for d in net.nodes:
        d.update_metrics()
    state = {
        "buckets": [(_bucket_rows(d.buckets(AF_INET)),
                     _bucket_rows(d.buckets(AF_INET6)))
                    for d in net.nodes],
        "stores": [_store_rows(d) for d in net.nodes],
        "stats": [(d.engine.stats_in, d.engine.stats_out)
                  for d in net.nodes],
        "metrics": [d.metrics.render_prometheus() for d in net.nodes],
        "logs": [(d.get_routing_table_log(AF_INET),
                  d.get_routing_table_log(AF_INET6),
                  d.get_searches_log(), d.get_storage_log())
                 for d in net.nodes],
        "net": (net.net.packets_sent, net.net.packets_dropped,
                net.net.bytes_sent, net.clock.now()),
        "dual": (dual.get_status(AF_INET), dual.get_status(AF_INET6),
                 dual.get_nodes_stats(AF_INET6)),
    }
    return log, cbs, state


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(y) for y in x]
    if hasattr(x, "id") and hasattr(x, "addr"):      # a Node
        return (bytes(x.id), str(x.addr))
    return x


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    try:
        out = {"jax": run_cluster("jax", mp), "jax2": run_cluster("jax", mp),
               "port": run_cluster("port", mp)}
    finally:
        mp.undo()
    return out


def test_jax_run_repeats_under_patch(runs):
    assert len(runs["jax"][0]) > 2000
    assert runs["jax"][0] == runs["jax2"][0]
    assert runs["jax"][1] == runs["jax2"][1]


def test_datagram_logs_equal(runs):
    j, t = runs["jax"][0], runs["port"][0]
    assert len(j) == len(t)
    for i, (a, b) in enumerate(zip(j, t)):
        assert a == b, f"datagram {i} differs"


@pytest.mark.parametrize("what", ["buckets", "stores", "stats", "metrics",
                                  "logs", "net", "dual"])
def test_cluster_state_equal(runs, what):
    assert runs["jax"][2][what] == runs["port"][2][what]


def test_callback_sequences_equal(runs):
    j, t = runs["jax"][1], runs["port"][1]
    tags = [c[0] for c in j]
    for tag in ("put1", "put_rid", "listen", "get_v", "get_done", "query",
                "put2", "put3", "cancel_listen", "cancel_put", "dual_get",
                "dual_done", "miss_done"):
        assert tag in tags, tag
    assert j == t


@pytest.mark.parametrize("with_identity", [False, True])
def test_add_secure_node_builds_secure_dht(with_identity):
    """``add_secure_node`` adds the port's ``SecureDht`` with the same
    node id, types and announced certificate as JAX's."""
    pytest.importorskip("cryptography")
    import opendht_tpu.crypto.identity as jid
    import opendht_tpu_torch.crypto.identity as tid
    from opendht_tpu_torch.crypto.securedht import SecureDht
    ident = jid.generate_identity("n", key_length=1024) if with_identity \
        else None
    port_ident = None if ident is None else tid.Identity(
        tid.PrivateKey.from_der(ident.key.serialize()),
        tid.Certificate.from_der(ident.certificate.packed()))
    nodes = {}
    for name, net_mod, idt in (("jax", jnet, ident),
                               ("port", tnet, port_ident)):
        net = net_mod.DhtNetwork(2, seed=1)
        node = net.add_secure_node(idt)
        net.interconnect()
        net.run(2.0)
        nodes[name] = (node, net)
    (j, jn), (t, tn) = nodes["jax"], nodes["port"]
    assert isinstance(t, SecureDht) and tn.nodes[-1] is t
    assert bytes(t.myid) == bytes(j.myid)
    assert sorted(t.types) == sorted(j.types)
    assert (t.get_id() is None) == (ident is None)
    if ident is not None:
        assert bytes(t.get_id()) == bytes(j.get_id())
        cid = t.certificate.get_id()
        assert [v.packed() for v in t.get_local(cid)] == \
            [v.packed() for v in j.get_local(j.certificate.get_id())]
        assert t.get_local(cid)


# ---------------------------------------------------------------------------
# unit cases
# ---------------------------------------------------------------------------

def _mknodes(P, n, seed, cache=None):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        nid = P["ih"].InfoHash(bytes(rng.getrandbits(8) for _ in range(20)))
        addr = P["sa"].SockAddr(f"10.0.{(i >> 8) & 255}.{i & 255}", 4222)
        out.append(cache.get_node(nid, addr) if cache
                   else P["node"].Node(nid, addr))
    return out


def routing_table_ops(P):
    rt = P["rt"].RoutingTable(P["sa"].AF_INET)
    nodes = _mknodes(P, 300, 3)
    trace = []
    for i, n in enumerate(nodes):
        n.time = n.reply_time = float(i % 7)
        rt.find_bucket(n.id).nodes.append(n)
        idx = rt.find_bucket_index(n.id)
        while len(rt.buckets[idx].nodes) > 8 and rt.split(idx):
            idx = rt.find_bucket_index(n.id)
        trace.append((idx, len(rt.buckets), rt.depth(idx)))
    rng = random.Random(9)
    for t in ("a", "b", "c"):
        target = P["ih"].InfoHash.get(t)
        trace.append([bytes(n.id) for n in
                      rt.find_closest_nodes(target, 3.0, 8)])
        trace.append(bytes(rt.middle(rt.find_bucket_index(target))))
        trace.append(bytes(rt.random_id(rt.find_bucket_index(target), rng)))
        trace.append(bytes(rt.buckets[2].random_node(rng).id))
    trace.append((rt.node_count(), len(rt), _bucket_rows(rt)))
    return trace


def scheduler_ops(P):
    clock = P["clock"].VirtualClock()
    s = P["sch"].Scheduler(clock)
    seen = []
    jobs = [s.add(t, lambda t=t: seen.append(("job", t, clock.now())))
            for t in (5.0, 1.0, 3.0, 3.0, 9.0)]
    jobs[2].cancel()
    s.edit(jobs[4], 2.0)
    s.run_soon(lambda: seen.append(("soon", clock.now())))
    for t in (0.0, 1.5, 3.0, 10.0):
        clock.set(t)
        seen.append(("run", s.run(), s.pending(), s.next_wakeup()))
    return seen


def node_cache_ops(P):
    cache = P["nc"].NodeCache()
    nodes = _mknodes(P, 120, 4, cache)
    for i, n in enumerate(nodes):
        if i % 5 == 0:
            n.set_expired()
    again = _mknodes(P, 10, 4, cache)
    out = [all(a is b for a, b in zip(again, nodes[:10]))]
    for t in ("x", "y"):
        out.append([bytes(n.id) for n in cache.get_cached_nodes(
            P["ih"].InfoHash.get(t), P["sa"].AF_INET, 10)])
    cache.clear_bad_nodes()
    out.append(bytes(cache.find(nodes[1].id, P["sa"].AF_INET).id))
    return out


def storage_ops(P):
    V = P["v"].Value
    st = P["st"].Storage(0.0)
    out = []
    for i in range(40):
        v = V(bytes([i]) * (i * 13), value_id=i % 30 + 1)
        res = st.store(v, float(i), 4096)
        out.append((res[0] is not None if isinstance(res, tuple) else res,
                    st.value_count(), st.total_size))
    out.append(st.refresh(50.0, 3))
    out.append(st.refresh(50.0, 999))
    out.append([v.packed() for v in st.get()])
    out.append(st.get_by_id(5).packed())
    types = {0: P["v"].USER_DATA}
    exp = st.expire(lambda tid: types.get(tid, P["v"].USER_DATA), 640.0)
    out.append((exp[0], exp[1], [v.packed() for v in exp[2]]))
    out.append(st.clear())
    return out


def rate_limiter_ops(P):
    rl = P["rl"]
    out = []
    for make in (lambda: rl.RateLimiter(5), lambda: rl.TokenBucket(5, 3),
                 lambda: rl.make_rate_limiter(5),
                 lambda: rl.make_rate_limiter(5, "token-bucket")):
        lim = make()
        ts = np.cumsum(np.random.default_rng(2).exponential(0.05, 300))
        out.append([lim.limit(float(t)) for t in ts])
    with pytest.raises(ValueError):
        rl.make_rate_limiter(5, "nope")
    return out


@pytest.mark.parametrize("case", [routing_table_ops, scheduler_ops,
                                  node_cache_ops, storage_ops,
                                  rate_limiter_ops],
                         ids=lambda f: f.__name__)
def test_unit_ops_equal(case):
    assert case(PKGS["jax"]) == case(PKGS["port"])


def test_native_against_twin_and_jax():
    """Each native entry point against its pure-Python twin (the
    library's answers with the library loaded, the twin's with it
    hidden) and against JAX's library."""
    rng = np.random.default_rng(11)
    n = 300
    ids = rng.integers(0, 256, size=(n, 20), dtype=np.uint8).tobytes()
    target = bytes(rng.integers(0, 256, 20, dtype=np.uint8))
    a, b = ids[:20], ids[20:40]

    def calls(mod):
        return (mod.common_bits(a, b), mod.common_bits(a, a),
                mod.xor_topk(ids, n, target, 8),
                mod.common_bits_batch(ids, n, target),
                mod.xor_sort(ids, list(range(0, n, 3)), target),
                mod.token_eq(a, a), mod.token_eq(a, b),
                mod.token_eq(a, a[:5]))

    assert tnative.available()
    native_out = calls(tnative)
    assert native_out == calls(jnative)
    lim = tnative.NativeRateLimiter(3)
    ts = [0.0, 0.1, 0.2, 0.3, 1.15, 1.25, 2.5]
    got = [lim.limit(t) for t in ts]
    py = trl.RateLimiter(3)
    assert got == [py.limit(t) for t in ts]
    saved = (tnative._LIB, tnative._TRIED)
    try:
        tnative._LIB, tnative._TRIED = None, True       # the twins
        assert not tnative.available()
        assert calls(tnative) == native_out
        twin = tnative.NativeRateLimiter(3)
        assert [twin.limit(t) for t in ts] == got
        assert isinstance(trl.make_rate_limiter(3), trl.RateLimiter)
    finally:
        tnative._LIB, tnative._TRIED = saved
    so = tnative._build_path()
    assert os.path.dirname(so).endswith(os.path.join("opendht_tpu_torch",
                                                     "build"))
    assert os.path.exists(so)
