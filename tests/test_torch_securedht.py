"""The port's crypto overlay against the JAX package's.

Identities are made once, by the JAX package, with 2048-bit keys, and
handed to the port as DER (``PrivateKey.serialize`` /
``Certificate.packed``): signatures are then deterministic and equal.
The identity helpers are compared exactly; the port's Argon2i (C++ and
its Python twin) against ``argon2-cffi``, JAX's ``stretch_key`` and RFC
9106's Argon2i vector.  Then one seeded secure ``DhtNetwork`` scenario
(signed puts, a seq-bump ``put_signed``, ``put_encrypted``,
``find_certificate``, a forged signature, a revoked certificate) runs
through each package with ``os.urandom`` and the global ``random``
drawing from one seeded stream: datagram logs, stores and callbacks are
compared byte for byte, except the RSA-wrapped head of an encrypted
value, whose padding comes from OpenSSL's own generator.  Each package
decrypts the other's ciphertexts to the same value, and every
ciphertext is replaced by a mark of that decryption, of the same length,
before the logs are compared.  Last, ``tests/test_conformance.py``'s
signed ``SEQ_STEPS`` host leg through each package."""

import hashlib
import os
import random

import pytest

pytest.importorskip("cryptography", reason="optional crypto deps absent")
pytest.importorskip("argon2", reason="optional crypto deps absent")

from argon2.low_level import Type, hash_secret_raw  # noqa: E402

import opendht_tpu.core.value as jv  # noqa: E402
import opendht_tpu.crypto.identity as jid  # noqa: E402
import opendht_tpu.crypto.securedht as jsd  # noqa: E402
import opendht_tpu.harness.network as jnet  # noqa: E402
import opendht_tpu.utils.infohash as jih  # noqa: E402
import opendht_tpu_torch.core.value as tv  # noqa: E402
import opendht_tpu_torch.crypto.identity as tid  # noqa: E402
import opendht_tpu_torch.crypto.securedht as tsd  # noqa: E402
import opendht_tpu_torch.harness.network as tnet  # noqa: E402
import opendht_tpu_torch.utils.infohash as tih  # noqa: E402
from opendht_tpu_torch.native import argon2 as targon2  # noqa: E402
from test_conformance import (  # noqa: E402
    SEQ_EXPECT,
    SEQ_EXPECT_SEQ,
    SEQ_STEPS,
    brute_closest,
    check_replica_outcomes,
)

KEY_LEN = 2048
PKGS = {"jax": dict(id=jid, sd=jsd, net=jnet, v=jv, ih=jih),
        "port": dict(id=tid, sd=tsd, net=tnet, v=tv, ih=tih)}


def seed_draws(monkeypatch, seed=4321):
    """One seeded stream for ``os.urandom`` and the global ``random``."""
    stream = random.Random(seed)
    monkeypatch.setattr(os, "urandom", lambda n: stream.randbytes(n))
    random.seed(seed + 1)


def port_identity(ident):
    """A JAX identity as the port's, through DER."""
    return tid.Identity(tid.PrivateKey.from_der(ident.key.serialize()),
                        tid.Certificate.from_der(ident.certificate.packed()))


@pytest.fixture(scope="module")
def ids():
    """JAX identities and their port copies: alice, bob, other (secure
    nodes), the author of the seq leg, a CA, a leaf it revokes and a
    leaf it keeps."""
    j = {n: jid.generate_identity(n, key_length=KEY_LEN)
         for n in ("alice", "bob", "other", "author", "ca")}
    j["leaf"] = jid.generate_identity("leaf", j["ca"], key_length=KEY_LEN)
    j["kept"] = jid.generate_identity("kept", j["ca"], key_length=KEY_LEN)
    return {"jax": j, "port": {n: port_identity(i) for n, i in j.items()}}


# ---------------------------------------------------------------------------
# identity helpers
# ---------------------------------------------------------------------------

def test_hash_data_and_aes_key_size_equal():
    data = bytes(range(200))
    for n in range(1, 65):
        assert tid.hash_data(data, n) == jid.hash_data(data, n), n
    for n in range(0, 80):
        assert tid.aes_key_size(n) == jid.aes_key_size(n), n


def test_aes_gcm_layout_equal(monkeypatch):
    key = bytes(range(32))
    out = {}
    for name, m in (("jax", jid), ("port", tid)):
        seed_draws(monkeypatch)
        out[name] = m.aes_encrypt(b"some data", key)
    assert out["jax"] == out["port"]
    assert len(out["port"]) == tid.GCM_IV_SIZE + 9 + tid.GCM_DIGEST_SIZE
    assert tid.aes_decrypt(out["jax"], key) == b"some data"
    for m in (jid, tid):
        with pytest.raises(m.DecryptError):
            m.aes_decrypt(out["port"][:-1] + b"\x00", key)
        with pytest.raises(m.DecryptError):
            m.aes_decrypt(out["port"][:28], key)


def test_private_key_der_both_ways(ids):
    jk, tk = ids["jax"]["alice"].key, ids["port"]["alice"].key
    assert tk.get_public_key().packed() == jk.get_public_key().packed()
    assert tk.serialize() == jk.serialize()
    assert tk.sign(b"msg") == jk.sign(b"msg")
    back = jid.PrivateKey.from_der(tk.serialize("pw"), "pw")
    assert back.get_public_key() == jk.get_public_key()
    fwd = tid.PrivateKey.from_der(jk.serialize("pw"), "pw")
    assert fwd.get_public_key().packed() == tk.get_public_key().packed()
    tp, jp = tk.get_public_key(), jk.get_public_key()
    assert bytes(tp.get_id()) == bytes(jp.get_id())
    assert tp.get_long_id() == jp.get_long_id()
    assert tp.check_signature(b"msg", jk.sign(b"msg"))
    assert not tp.check_signature(b"msh", jk.sign(b"msg"))


@pytest.mark.parametrize("size", [1, 100, KEY_LEN // 8 - 11,
                                  KEY_LEN // 8 - 10, 5000])
def test_public_key_encrypt_cross_decrypts(ids, size):
    """Plain RSA up to key_len - 11 bytes, hybrid above: each package
    decrypts the other's ciphertext."""
    data = bytes((i * 7) & 0xFF for i in range(size))
    jk, tk = ids["jax"]["bob"].key, ids["port"]["bob"].key
    tc = tk.get_public_key().encrypt(data)
    jc = jk.get_public_key().encrypt(data)
    assert len(tc) == len(jc)
    assert len(tc) == (KEY_LEN // 8 if size <= KEY_LEN // 8 - 11
                       else KEY_LEN // 8 + 12 + size + 16)
    assert jk.decrypt(tc) == data and tk.decrypt(jc) == data
    bad = bytearray(tc)
    bad[-1] ^= 0xFF
    if size > KEY_LEN // 8 - 11:
        with pytest.raises(tid.DecryptError):
            tk.decrypt(bytes(bad))
    with pytest.raises(tid.DecryptError):
        tk.decrypt(tc[:10])


def test_certificate_chain_from_der(ids):
    j, t = ids["jax"]["leaf"].certificate, ids["port"]["leaf"].certificate
    assert t.packed() == j.packed()
    assert (t.get_name(), t.is_ca(), bytes(t.get_id())) == (
        j.get_name(), j.is_ca(), bytes(j.get_id()))
    assert t.issuer is not None and t.issuer.issuer is None
    assert (t.issuer.get_name(), t.issuer.is_ca()) == ("ca", True)
    assert t.issuer.packed() == ids["jax"]["ca"].certificate.packed()
    assert t == tid.Certificate.from_der(j.packed())
    with pytest.raises(tid.CryptoException):
        tid.Certificate.from_der(b"\x31\x00")


def test_revocation_list_both_ways(ids):
    """A CRL signed by either package unpacks in the other with the
    same revocations, signer, number and issuer."""
    for src, dst in (("jax", "port"), ("port", "jax")):
        s, d = ids[src], ids[dst]
        crl = PKGS[src]["id"].RevocationList()
        crl.revoke(s["leaf"].certificate)
        assert crl.is_revoked(s["leaf"].certificate)     # pending counts
        crl.sign(s["ca"].key, s["ca"].certificate)
        back = PKGS[dst]["id"].RevocationList(crl.get_packed())
        assert back.get_packed() == crl.get_packed()
        assert back.is_revoked(d["leaf"].certificate)
        assert not back.is_revoked(d["kept"].certificate)
        assert back.is_signed_by(d["ca"].certificate)
        assert not back.is_signed_by(d["alice"].certificate)
        assert back.get_number() == crl.get_number() > 0
        assert back.get_issuer_name() == crl.get_issuer_name() == "ca"
        assert back.get_update_time() == crl.get_update_time()
        assert back.get_next_update_time() == crl.get_next_update_time()
    crl = tid.RevocationList()
    crl.revoke(ids["port"]["leaf"].certificate)
    crl.sign(ids["port"]["alice"].key, ids["port"]["alice"].certificate)
    ca = tid.Certificate.from_der(ids["jax"]["ca"].certificate.packed())
    with pytest.raises(tid.CryptoException):
        ca.add_revocation_list(crl)            # not signed by the CA
    assert not ca.is_revoked(ids["port"]["leaf"].certificate)


def test_generate_identity_chain():
    ca = tid.generate_identity("ca", key_length=1024)
    leaf = tid.generate_identity("node", ca, key_length=1024)
    assert ca.certificate.is_ca() and not leaf.certificate.is_ca()
    assert leaf.certificate.issuer is ca.certificate
    assert bytes(leaf.certificate.get_id()) == bytes(
        leaf.key.get_public_key().get_id())
    j = jid.Certificate.from_der(leaf.certificate.packed())
    assert j.issuer.get_name() == "ca" and not j.is_ca()
    assert jid.PrivateKey.from_der(leaf.key.serialize()).sign(b"x") == \
        leaf.key.sign(b"x")


def test_password_crypto_both_ways(monkeypatch):
    """``stretch_key`` equal at one salt; ``password_decrypt`` of either
    package's ``password_encrypt`` (the C++ Argon2i at full cost)."""
    assert targon2.available()
    salt = bytes(range(16))
    for n in (32, 64):
        assert tid.stretch_key("pw", salt, n) == jid.stretch_key("pw", salt,
                                                                 n)
    out = {}
    for name, m in (("jax", jid), ("port", tid)):
        seed_draws(monkeypatch)
        out[name] = m.password_encrypt(b"private key bytes", "hunter2")
    assert out["jax"] == out["port"]
    seed_draws(monkeypatch, 9)
    tc = tid.password_encrypt(b"other bytes", "hunter2")
    assert jid.password_decrypt(tc, "hunter2") == b"other bytes"
    with pytest.raises(tid.DecryptError):
        tid.password_decrypt(tc, "wrong")
    with pytest.raises(tid.DecryptError):
        tid.password_decrypt(tc[:16], "hunter2")


# ---------------------------------------------------------------------------
# Argon2i
# ---------------------------------------------------------------------------

# (password, salt, t, m KiB, lanes, tag length)
ARGON2_CASES = [
    (b"pw", b"saltsalt", 1, 8, 1, 32),
    (b"password", b"somesalt1234", 2, 16, 1, 16),
    (b"", bytes(16), 3, 64, 1, 64),
    (b"x" * 100, b"s" * 16, 1, 32, 2, 100),
    (b"abc", b"12345678", 2, 24, 3, 7),
    (bytes(range(256)), bytes(range(40)), 1, 130, 1, 1025),
]


@pytest.mark.parametrize("case", ARGON2_CASES, ids=lambda c: f"t{c[2]}m{c[3]}"
                         f"p{c[4]}h{c[5]}")
def test_argon2i_twin_and_native_equal_cffi(case):
    pw, salt, t, m, p, n = case
    want = hash_secret_raw(secret=pw, salt=salt, time_cost=t, memory_cost=m,
                           parallelism=p, hash_len=n, type=Type.I)
    assert targon2.argon2i_py(pw, salt, t, m, p, n) == want
    assert targon2.available()
    assert targon2.argon2i(pw, salt, t, m, p, n) == want


def test_argon2i_rfc9106_vector():
    """RFC 9106 §5.2: Argon2i, 32 KiB, 3 passes, 4 lanes, a secret and
    associated data."""
    want = bytes.fromhex("c814d9d1dc7f37aa13f0d77f2494bda1"
                         "c8de6b016dd388d29952a4c4672b6ce8")
    args = (b"\x01" * 32, b"\x02" * 16, 3, 32, 4, 32, b"\x03" * 8,
            b"\x04" * 12)
    assert targon2.argon2i(*args) == want
    assert targon2.argon2i_py(*args) == want


def test_argon2i_native_at_password_cost():
    """The C++ build at t = 16, m = 64 MiB against argon2-cffi and the
    reference KDF (JAX's ``stretch_key``)."""
    salt = b"\x02" * 16
    raw = targon2.argon2i(b"pw", salt, 16, 64 * 1024, 1, 32)
    assert raw == hash_secret_raw(secret=b"pw", salt=salt, time_cost=16,
                                  memory_cost=64 * 1024, parallelism=1,
                                  hash_len=32, type=Type.I)
    assert jid.stretch_key("pw", salt, 32)[0] == hashlib.sha256(raw).digest()


def test_argon2i_refuses_bad_parameters():
    for args in ((b"p", b"short", 1, 8, 1, 32), (b"p", b"saltsalt", 0, 8, 1,
                                                  32),
                 (b"p", b"saltsalt", 1, 7, 1, 32), (b"p", b"saltsalt", 1, 8,
                                                    1, 3)):
        with pytest.raises(ValueError):
            targon2.argon2i(*args)
        with pytest.raises(ValueError):
            targon2.argon2i_py(*args)


# ---------------------------------------------------------------------------
# the seeded secure scenario
# ---------------------------------------------------------------------------

def _mark(plain: bytes, n: int) -> bytes:
    """A stand-in of length ``n`` for a ciphertext of ``plain``."""
    return hashlib.shake_256(b"decrypted:" + plain).digest(n)


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(y) for y in x]
    if hasattr(x, "packed") and callable(x.packed):
        return x.packed()
    if hasattr(x, "id") and hasattr(x, "addr"):          # a Node
        return (bytes(x.id), str(x.addr))
    if type(x).__name__ == "InfoHash":
        return bytes(x)
    return x


def run_secure(pkg, ids, monkeypatch):
    """The scenario through one package; returns what is compared and
    every ciphertext its nodes made."""
    P, I = PKGS[pkg], ids[pkg]
    IH, Value = P["ih"].InfoHash, P["v"].Value
    ciphers = []
    enc = P["id"].PublicKey.encrypt

    def encrypt(self, data):
        c = enc(self, data)
        ciphers.append(c)
        return c

    monkeypatch.setattr(P["id"].PublicKey, "encrypt", encrypt)
    seed_draws(monkeypatch)
    log, cbs = [], []
    net = P["net"].DhtNetwork(0, seed=5)
    orig = net.net.deliver

    def deliver(data, src, dest):
        log.append((net.clock.now(), str(src), str(dest), bytes(data)))
        orig(data, src, dest)

    net.net.deliver = deliver
    a = net.add_secure_node(I["alice"])
    b = net.add_secure_node(I["bob"])
    o = net.add_secure_node(I["other"])
    for _ in range(5):
        net.add_node()
    net.interconnect()
    net.run(5.0)
    plain_node = net.nodes[3]

    def cb(tag):
        return lambda *a: cbs.append((tag,) + tuple(_plain(x) for x in a))

    def vcb(tag):
        return lambda vals: cbs.append((tag, [v.packed() for v in vals])) \
            or True

    def wait(tag, timeout=30.0):
        assert net.run_until(lambda: any(c[0] == tag for c in cbs),
                             timeout), tag

    h1, h2, h3, h4 = (IH.get(k) for k in ("signed-key", "seq-key", "enc-key",
                                          "forged"))
    a.put_signed(h1, Value(b"signed-data", 0), cb("ps1"))
    wait("ps1")
    b.get(h1, vcb("g1"), cb("g1_done"))
    wait("g1_done")

    v1 = Value(b"v1", 0, value_id=42)
    a.put_signed(h2, v1, cb("ps2"))
    wait("ps2")
    v2 = Value(b"v2", 0, value_id=42)
    a.put_signed(h2, v2, cb("ps3"))
    wait("ps3")
    cbs.append(("seqs", v1.seq, v2.seq))
    b.get(h2, vcb("g2"), cb("g2_done"))
    wait("g2_done")

    a.put_encrypted(h3, b.get_id(), Value(b"for-bob", 0), cb("pe"))
    wait("pe")
    b.get(h3, vcb("g3_bob"), cb("g3_bob_done"))
    wait("g3_bob_done")
    plain_node.get(h3, vcb("g3_raw"), cb("g3_raw_done"))
    wait("g3_raw_done")
    a.get(h3, vcb("g3_alice"), cb("g3_alice_done"))
    wait("g3_alice_done")

    a.find_certificate(b.certificate.get_id(), cb("crt_b"))
    wait("crt_b")
    o.find_public_key(a.get_id(), cb("pk_a"))
    wait("pk_a")

    v = Value(b"legit", 1)
    v.id = 77
    P["sd"].sign_value(a.key, v)
    v.data = b"forged"
    a.put(h4, v, cb("forged"))
    wait("forged")
    cbs.append(("forged_local", [x.packed() for x in b.get_local(h4)],
                [x.packed() for x in plain_node.get_local(h4)]))

    # The revoked leaf: refused once its CA's CRL is known, found over
    # the network before the CA is trusted, refused after.
    leaf, ca = I["leaf"].certificate, I["leaf"].certificate.issuer
    crl = P["id"].RevocationList()
    crl.revoke(leaf)
    crl.sign(I["ca"].key, ca)
    ca.add_revocation_list(crl)
    try:
        o.register_certificate(leaf)
        cbs.append(("register", "accepted"))
    except P["id"].CryptoException as e:
        cbs.append(("register", str(e)))
    cbs.append(("cached", o.get_certificate(leaf.get_id()) is None))
    ca.revocation_lists.clear()
    wire = Value(leaf.packed(), P["sd"].CERTIFICATE_TYPE_ID, value_id=1)
    net.nodes[-1].put(leaf.get_id(), wire, cb("leaf_put"))
    wait("leaf_put")
    o.find_certificate(leaf.get_id(), cb("crt_leaf"))
    wait("crt_leaf")
    ca.add_revocation_list(crl)
    o.add_trusted_certificate(ca)
    cbs.append(("evicted", o.get_certificate(leaf.get_id()) is None))
    o.find_certificate(leaf.get_id(), cb("crt_leaf_trusted"))
    wait("crt_leaf_trusted")
    ca.revocation_lists.clear()
    net.run(2.0)

    stores = sorted((bytes(h), sorted(vs.value.packed() for vs in st.values))
                    for d in net.nodes for h, st in d.store.items())
    return {"log": log, "cbs": cbs, "stores": stores, "ciphers": ciphers,
            "stats": [d.engine.get_stats() for d in net.nodes]}


@pytest.fixture(scope="module")
def secure_runs(ids):
    mp = pytest.MonkeyPatch()
    try:
        return {pkg: run_secure(pkg, ids, mp) for pkg in PKGS}
    finally:
        mp.undo()


def _normalize(obj, marks):
    if isinstance(obj, bytes):
        for c, m in marks:
            obj = obj.replace(c, m)
        return obj
    if isinstance(obj, (list, tuple)):
        return [_normalize(x, marks) for x in obj]
    return obj


@pytest.fixture(scope="module")
def marks(secure_runs, ids):
    """Each package's ciphertexts, decrypted by the other package's
    recipient key: (ciphertext, mark of its decryption) pairs."""
    out = {}
    for pkg, other in (("jax", "port"), ("port", "jax")):
        key = ids[other]["bob"].key
        out[pkg] = [(c, _mark(key.decrypt(c), len(c)))
                    for c in secure_runs[pkg]["ciphers"]]
    return out


def test_encrypted_values_cross_decrypt(secure_runs, ids, marks):
    """One ciphertext each (the put to bob); each package's bob decrypts
    the other's to the same signed value, from alice, for bob."""
    cj, ct = secure_runs["jax"]["ciphers"], secure_runs["port"]["ciphers"]
    assert len(cj) == len(ct) == 1
    assert len(cj[0]) == len(ct[0])
    assert [m for _, m in marks["jax"]] == [m for _, m in marks["port"]]
    assert cj[0][KEY_LEN // 8:] == ct[0][KEY_LEN // 8:]   # the AES part
    for pkg, c in (("port", cj[0]), ("jax", ct[0])):
        P = PKGS[pkg]
        net = P["net"].DhtNetwork(0, seed=9)
        bob = net.add_secure_node(ids[pkg]["bob"])
        ev = P["v"].Value(value_id=1)
        ev.cypher = c
        dv = bob.decrypt(ev)
        assert dv.data == b"for-bob"
        assert bytes(dv.owner.get_id()) == bytes(
            ids[pkg]["alice"].key.get_public_key().get_id())
        assert bytes(dv.recipient) == bytes(bob.get_id())


def test_secure_datagram_logs_equal(secure_runs, marks):
    j = _normalize(secure_runs["jax"]["log"], marks["jax"])
    t = _normalize(secure_runs["port"]["log"], marks["port"])
    assert len(j) == len(t) > 100
    for i, (a, b) in enumerate(zip(j, t)):
        assert a == b, i


@pytest.mark.parametrize("what", ["cbs", "stores", "stats"])
def test_secure_state_equal(secure_runs, marks, what):
    assert _normalize(secure_runs["jax"][what], marks["jax"]) == \
        _normalize(secure_runs["port"][what], marks["port"])


def test_secure_scenario_outcomes(secure_runs):
    """What the JAX package's ``tests/test_securedht.py`` asserts, read
    off the port's run."""
    cbs = {c[0]: c[1:] for c in secure_runs["port"]["cbs"]}
    assert cbs["ps1"][0] and cbs["pe"][0]
    assert cbs["g1"][0]
    s1, s2 = cbs["seqs"]
    assert s2 > s1
    assert cbs["g3_bob"][0] and not cbs.get("g3_alice")
    assert cbs["g3_raw"][0]
    assert cbs["crt_b"][0] is not None and cbs["pk_a"][0] is not None
    assert cbs["forged_local"][0] == [] and cbs["forged_local"][1] != []
    assert cbs["register"][0] == "certificate is revoked"
    assert cbs["cached"][0] is True
    assert cbs["crt_leaf"][0] is not None
    assert cbs["evicted"][0] is True
    assert cbs["crt_leaf_trusted"][0] is None


# ---------------------------------------------------------------------------
# the signed SEQ_STEPS host leg
# ---------------------------------------------------------------------------

def run_seq(pkg, ids):
    """``tests/test_conformance.py::test_storage_seq_semantics_host``
    through one package: the replica (seq, tag) sets at the key's true
    8 closest after each step."""
    P = PKGS[pkg]
    c = P["net"].DhtNetwork(0, seed=11)
    for _ in range(16):
        c.add_secure_node()
    c.interconnect()
    c.run(10.0)
    author = ids[pkg]["author"]
    key = P["ih"].InfoHash(b"\x42" * 20)
    ranked = brute_closest([d.myid for d in c.nodes], bytes(key), 16)
    closest, farthest = ranked[:8], ranked[8:]
    states = []
    for step, (seq, tag) in enumerate(SEQ_STEPS):
        v = P["v"].Value(bytes([tag]), value_id=77)
        v.seq = seq
        P["sd"].sign_value(author.key, v)
        done = []
        c.nodes[farthest[step % len(farthest)]].put(
            key, v, lambda ok, ns: done.append(ok))
        c.run_until(lambda: done, timeout=60.0)
        c.run(1.0)
        state = set()
        for i in closest:
            lv = c.nodes[i].get_local_by_id(key, 77)
            if lv is not None:
                state.add((lv.seq, lv.data[0]))
        states.append((sorted(state), list(done)))
    return states


def test_signed_seq_steps_equal(ids, monkeypatch):
    out = {}
    for pkg in PKGS:
        seed_draws(monkeypatch, 77)
        out[pkg] = run_seq(pkg, ids)
    assert out["port"] == out["jax"]
    for step, (state, _) in enumerate(out["port"]):
        assert state, f"step {step}: no replica stored"
        check_replica_outcomes(step, set(state))
        assert max(state)[0] == SEQ_EXPECT_SEQ[step]
        assert (SEQ_EXPECT_SEQ[step], SEQ_EXPECT[step]) in state
