"""The port's runtime against the JAX package's: ``NodeSet`` bytes, and
the threaded ``DhtRunner`` and the process harness through interop on
loopback (the wire is byte-equal, so a node of either package serves
the other): bootstrap, put / get, listen, ``put_signed`` verified by the
other package's ``SecureDht`` filter, ``put_encrypted`` decrypted by the
other package, ``save_state`` read by the other's ``load_state``, and a
port ``ProcCluster`` that a JAX runner joins.  Every wait polls and is
bounded (at most 15 s)."""

import os
import subprocess
import sys
import textwrap
import time

import pytest

pytest.importorskip("cryptography", reason="optional crypto deps absent")
pytest.importorskip("argon2", reason="optional crypto deps absent")

import opendht_tpu.core.value as jv  # noqa: E402
import opendht_tpu.crypto.identity as jid  # noqa: E402
import opendht_tpu.runtime.dhtrunner as jdr  # noqa: E402
import opendht_tpu.runtime.nodeset as jns  # noqa: E402
import opendht_tpu.utils.infohash as jih  # noqa: E402
import opendht_tpu.utils.sockaddr as jsa  # noqa: E402
import opendht_tpu_torch.core.value as tv  # noqa: E402
import opendht_tpu_torch.crypto.identity as tid  # noqa: E402
import opendht_tpu_torch.runtime.dhtrunner as tdr  # noqa: E402
import opendht_tpu_torch.runtime.nodeset as tns  # noqa: E402
import opendht_tpu_torch.utils.infohash as tih  # noqa: E402
import opendht_tpu_torch.utils.sockaddr as tsa  # noqa: E402
from opendht_tpu_torch.harness.proc_node import ProcCluster  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": dict(dr=jdr, ns=jns, v=jv, ih=jih, sa=jsa, id=jid),
        "port": dict(dr=tdr, ns=tns, v=tv, ih=tih, sa=tsa, id=tid)}


def wait_for(pred, timeout=15.0, step=0.05):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(step)
    return pred()


# ---------------------------------------------------------------------------
# NodeSet
# ---------------------------------------------------------------------------

def _records(P, n=40):
    out = []
    for i in range(n):
        h = P["ih"].InfoHash.get(f"n{i % 33}")
        host = f"10.0.{i % 7}.{i % 33}" if i % 5 else f"2001:db8::{i:x}"
        fam = P["sa"].AF_INET6 if ":" in host else P["sa"].AF_INET
        out.append((h, P["sa"].SockAddr(host, 4222 + i % 3, fam)))
    return out + out[3:9]                       # repeats are dropped


def test_nodeset_bytes_equal():
    sets = {k: P["ns"].NodeSet(_records(P)) for k, P in PKGS.items()}
    jb, tb = sets["jax"].serialize(), sets["port"].serialize()
    assert jb == tb
    assert len(sets["port"]) == len(sets["jax"]) == 40
    back = tns.NodeSet.deserialize(jb)
    assert back.serialize() == jb
    assert [(bytes(h), a.host, a.port, a.family) for h, a in back] == [
        (bytes(h), a.host, a.port, a.family) for h, a in sets["jax"]]
    assert jns.NodeSet.deserialize(tb).serialize() == tb
    first = back.first()
    assert first in back and not back.insert(*first)
    assert tns.NodeSet().serialize() == jns.NodeSet().serialize()


# ---------------------------------------------------------------------------
# runners on loopback
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def identities():
    """One JAX identity per package's runner, and the port's copy."""
    j = {k: jid.generate_identity(f"runner-{k}", key_length=2048)
         for k in PKGS}
    port = tid.Identity(tid.PrivateKey.from_der(j["port"].key.serialize()),
                        tid.Certificate.from_der(
                            j["port"].certificate.packed()))
    return {"jax": j["jax"], "port": port}


def _pair(identities=None):
    """A JAX runner and a port runner on 127.0.0.1.  Without identities
    they ``bootstrap`` each other by address; with them, each inserts
    the other's exported node (``bootstrap_nodes``): a node with an
    identity announces its certificate at start, and its status turns
    Connected only at its next maintenance tick, 60-180 s later in both
    packages, which is when a bootstrapping runner releases its queued
    operations."""
    r = {}
    for k, P in PKGS.items():
        r[k] = P["dr"].DhtRunner()
        r[k].run(port=0, bind4="127.0.0.1",
                 identity=identities[k] if identities else None)
    for k, other in (("port", "jax"), ("jax", "port")):
        P = PKGS[k]
        if identities:
            r[k].bootstrap_nodes([(
                P["ih"].InfoHash(bytes(r[other].get_node_id())),
                P["sa"].SockAddr("127.0.0.1", r[other].get_bound_port()))])
        else:
            r[k].bootstrap("127.0.0.1", r[other].get_bound_port())
    assert wait_for(lambda: r["jax"].get_nodes_stats()[0] > 0
                    and r["port"].get_nodes_stats()[0] > 0)
    return r


@pytest.fixture()
def pair():
    r = _pair()
    yield r
    for x in r.values():
        x.join()


@pytest.fixture()
def secure_pair(identities):
    r = _pair(identities)
    yield r
    for x in r.values():
        x.join()


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_put_get_and_listen_across_packages(pair, src, dst):
    a, b = pair[src], pair[dst]
    Va = PKGS[src]["v"].Value
    h = PKGS[src]["ih"].InfoHash.get(f"runner-{src}")
    seen = []
    tok = b.listen(PKGS[dst]["ih"].InfoHash(bytes(h)),
                   lambda vs: seen.extend(vs) or True)
    tok.result(timeout=15)
    assert a.put_future(h, Va(f"from {src}".encode())).result(timeout=15)
    vals = b.get_future(PKGS[dst]["ih"].InfoHash(bytes(h))).result(
        timeout=15)
    assert [v.data for v in vals] == [f"from {src}".encode()]
    assert wait_for(lambda: seen)
    assert seen[0].data == f"from {src}".encode()
    b.cancel_listen(PKGS[dst]["ih"].InfoHash(bytes(h)), tok)


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_put_signed_verifies_across_packages(secure_pair, src, dst):
    """A signed value from one package passes the other's ``SecureDht``
    filter, owned by the putter's key."""
    a, b = secure_pair[src], secure_pair[dst]
    h = PKGS[src]["ih"].InfoHash.get(f"signed-{src}")
    done = []
    a.put_signed(h, PKGS[src]["v"].Value(b"signed", 0, value_id=5),
                 lambda ok, ns: done.append(ok))
    assert wait_for(lambda: done) and done[0]
    vals = b.get_future(PKGS[dst]["ih"].InfoHash(bytes(h))).result(
        timeout=15)
    assert len(vals) == 1 and vals[0].data == b"signed"
    assert vals[0].is_signed() and vals[0].seq == 0
    assert bytes(vals[0].owner.get_id()) == bytes(a.get_id())
    done2 = []
    a.put_signed(h, PKGS[src]["v"].Value(b"signed 2", 0, value_id=5),
                 lambda ok, ns: done2.append(ok))
    assert wait_for(lambda: done2) and done2[0]
    vals = b.get_future(PKGS[dst]["ih"].InfoHash(bytes(h))).result(
        timeout=15)
    assert [(v.data, v.seq) for v in vals] == [(b"signed 2", 1)]


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_put_encrypted_decrypts_across_packages(secure_pair, src, dst):
    a, b = secure_pair[src], secure_pair[dst]
    h = PKGS[src]["ih"].InfoHash.get(f"encrypted-{src}")
    to = PKGS[src]["ih"].InfoHash(bytes(b.get_id()))
    done = []
    a.put_encrypted(h, to, PKGS[src]["v"].Value(b"secret", 0),
                    lambda ok, ns: done.append(ok))
    assert wait_for(lambda: done) and done[0]
    vals = b.get_future(PKGS[dst]["ih"].InfoHash(bytes(h))).result(
        timeout=15)
    assert len(vals) == 1 and vals[0].data == b"secret"
    assert bytes(vals[0].owner.get_id()) == bytes(a.get_id())
    assert bytes(vals[0].recipient) == bytes(b.get_id())
    mine = a.get_future(h).result(timeout=15)
    assert mine == []          # encrypted for the other node only


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_state_file_read_by_other_package(tmp_path, src, dst):
    """One package's ``save_state`` file is read by the other's
    ``load_state``: the nodes come back, and so do the values."""
    S, D = PKGS[src], PKGS[dst]
    a, b = S["dr"].DhtRunner(), S["dr"].DhtRunner()
    a.run(port=0, bind4="127.0.0.1")
    b.run(port=0, bind4="127.0.0.1")
    try:
        b.bootstrap("127.0.0.1", a.get_bound_port())
        assert wait_for(lambda: b.get_nodes_stats()[0] > 0)
        h = S["ih"].InfoHash.get(f"persisted-{src}")
        assert b.put_future(h, S["v"].Value(b"saved")).result(timeout=15)
        path = os.path.join(tmp_path, "state.mp")
        b.save_state(path)
        c = D["dr"].DhtRunner()
        c.run(port=0, bind4="127.0.0.1")
        try:
            assert c.load_state(path) >= 1
            assert wait_for(lambda: c.get_nodes_stats()[0] > 0)
            hd = D["ih"].InfoHash(bytes(h))
            assert wait_for(lambda: any(
                v.data == b"saved" for v in c.dht.get_local(hd)))
        finally:
            c.join()
    finally:
        a.join()
        b.join()


def test_bootstrap_gives_up_and_releases_ops(monkeypatch):
    monkeypatch.setattr(tdr, "BOOTSTRAP_PERIOD", 0.05)
    monkeypatch.setattr(tdr, "BOOTSTRAP_MAX_TRIES", 3)
    r = tdr.DhtRunner()
    r.run(port=0, bind4="127.0.0.1")
    try:
        r.bootstrap("127.0.0.1", 1)
        assert r.get_future(tih.InfoHash.get("unreachable")).result(
            timeout=10) == []
        assert not r._bootstrapping
    finally:
        r.join()


def test_run_failure_releases_claim_and_shutdown_joins():
    a = tdr.DhtRunner()
    a.run(port=0, bind4="127.0.0.1")
    b = tdr.DhtRunner()
    try:
        with pytest.raises(OSError):
            b.run(port=a.get_bound_port(), bind4="127.0.0.1")
        assert not b.is_running()
        b.run(port=0, bind4="127.0.0.1")
        assert b.is_running() and b.get_bound_port() > 0
        done = []
        a.shutdown(lambda: done.append(True))
        assert wait_for(lambda: done)
        a.join()
        assert not a._thread
        assert b.metrics is not None and b.get_node_id() is not None
    finally:
        a.join()
        b.join()


# ---------------------------------------------------------------------------
# the process harness
# ---------------------------------------------------------------------------

def test_proc_cluster_with_a_jax_runner():
    """Four port node processes put and get among themselves; a JAX
    runner that joins through node 0 gets their value and its own put
    is got by node 3."""
    c = ProcCluster(4)
    r = jdr.DhtRunner()
    try:
        assert c.wait_connected(min_good=1, timeout=15)
        key = tih.InfoHash.get("proc-key")
        assert c.put(1, bytes(key), b"from a process")
        assert c.get(2, bytes(key)) == [b"from a process"]
        r.run(port=0, bind4="127.0.0.1")
        r.bootstrap("127.0.0.1", c.ports[0])
        assert wait_for(lambda: r.get_nodes_stats()[0] > 0)
        got = r.get_future(jih.InfoHash(bytes(key))).result(timeout=15)
        assert [v.data for v in got] == [b"from a process"]
        k2 = jih.InfoHash.get("runner-key")
        assert r.put_future(k2, jv.Value(b"from jax")).result(timeout=15)
        assert wait_for(lambda: c.get(3, bytes(k2)) == [b"from jax"])
        stats = c.stats()
        assert len(stats) == 4 and all(s.get("ok") for s in stats)
        tok = c.nodes[0].request(op="listen", key=bytes(k2))["token"]
        assert wait_for(lambda: c.nodes[0].request(
            op="poll_listen", token=tok)["values"] == [b"from jax"])
        assert c.nodes[0].request(op="nope") == {
            "ok": False, "error": "unknown op 'nope'",
            "rid": c.nodes[0]._next_rid}
    finally:
        r.join()
        c.close()
    assert all(n.proc.poll() is not None for n in c.nodes)


# ---------------------------------------------------------------------------
# the package's binding-parity names
# ---------------------------------------------------------------------------

BINDING_NAMES = ("InfoHash", "SockAddr", "Value", "ValueType", "Query",
                 "Select", "Where", "Node", "Dht", "DhtConfig", "NodeSet",
                 "Pht", "DhtNetwork", "Certificate", "Identity",
                 "PrivateKey", "PublicKey", "generate_identity", "SecureDht",
                 "SecureDhtConfig", "DhtRunner", "DhtRunnerConfig")


def test_binding_names_match_jax():
    import opendht_tpu
    import opendht_tpu_torch
    for name in BINDING_NAMES:
        j, t = getattr(opendht_tpu, name), getattr(opendht_tpu_torch, name)
        assert t.__name__ == j.__name__, name
        assert t.__module__.replace("opendht_tpu_torch", "opendht_tpu") \
            == j.__module__, name
    assert opendht_tpu_torch.build_swarm.__module__ == \
        "opendht_tpu_torch.models.swarm"
    with pytest.raises(AttributeError):
        opendht_tpu_torch.no_such_name


def test_package_import_is_light_and_crypto_names_gated():
    """Importing the package loads neither torch nor a native library;
    without ``cryptography`` the crypto names raise ImportError at use,
    and the host core still runs."""
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "cryptography":
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import opendht_tpu_torch as t
        assert "torch" not in sys.modules
        assert not any(m.startswith("opendht_tpu_torch.native")
                       for m in sys.modules)
        for name in ("PrivateKey", "SecureDht", "DhtRunner",
                     "generate_identity"):
            try:
                getattr(t, name)
            except ImportError as e:
                assert "cryptography" in str(e), e
            else:
                raise AssertionError(name)
        net = t.DhtNetwork(4, seed=1)
        net.interconnect()
        net.run(2.0)
        from opendht_tpu_torch.runtime import DhtRunner, NodeSet
        assert NodeSet().serialize() == b"\\x90"
        t.build_swarm
        assert "torch" in sys.modules
        print("light ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "light ok" in out.stdout, out.stderr
