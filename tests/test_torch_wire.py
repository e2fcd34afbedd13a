"""The port's wire layer against the JAX package's: every
``MessageBuilder`` query and reply and ``parse_message`` of it, node
buffers (IPv4 and IPv6), the ``Value`` to-sign / to-encrypt / wire
forms, and the ``Query`` / ``Select`` / ``Where`` algebra — byte-equal
and field-equal between the two packages."""

import pytest

import opendht_tpu.core.value as jv
import opendht_tpu.net.wire as jw
import opendht_tpu.utils.infohash as jih
import opendht_tpu.utils.sockaddr as jsa
import opendht_tpu_torch.core.value as tv
import opendht_tpu_torch.net.wire as tw
import opendht_tpu_torch.utils.infohash as tih
import opendht_tpu_torch.utils.sockaddr as tsa

PKGS = {"jax": (jv, jw, jih, jsa), "port": (tv, tw, tih, tsa)}


class _Node:
    def __init__(self, nid, addr):
        self.id = nid
        self.addr = addr


class _StubOwner:
    """A fixed owner: ``packed()`` gives fixed DER-like bytes (the
    layout without a real RSA key)."""
    DER = b"\x30\x0a" + bytes(10)

    def __init__(self, ih):
        self._ih = ih

    def packed(self):
        return self.DER

    def get_id(self):
        return self._ih(bytes(range(50, 70)))


def norm(x):
    """Plain, package-free data for comparing the two packages' objects."""
    if isinstance(x, (bytes, str, int, float, type(None))):
        return x
    if isinstance(x, (list, tuple)):
        return [norm(y) for y in x]
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    name = type(x).__name__
    if name == "InfoHash":
        return ("ih", bytes(x))
    if name == "SockAddr":
        return ("sa", str(x), x.family)
    if name == "Value":
        return ("value", x.packed(), x.id, x.seq, x.type, x.data,
                x.user_type, x.signature, x.cypher,
                None if x.owner is None else x.owner.packed(),
                None if x.recipient is None else bytes(x.recipient))
    if name == "Query":
        return ("query", norm(x.pack()))
    if name == "ParsedMessage":
        return {s: norm(getattr(x, s)) for s in type(x).__slots__}
    raise TypeError(name)


def _value(pkg, kind):
    v_mod, _, ih_mod, _ = PKGS[pkg]
    IH = ih_mod.InfoHash
    v = v_mod.Value(b"xyz\x00payload", user_type="ut" if kind != "plain"
                    else "", value_id=0xDEAD)
    if kind in ("signed", "signed_to"):
        v.owner = _StubOwner(IH)
        v.seq = 7
        v.signature = b"\x05\x06" * 64
        if kind == "signed_to":
            v.recipient = IH(bytes(range(30, 50)))
    if kind == "encrypted":
        v.cypher = b"\x09" * 300
    return v


def _query(pkg, kind):
    v_mod = PKGS[pkg][0]
    F = v_mod.Field
    if kind == "select_where":
        return v_mod.Query(v_mod.Select().field(F.Id).field(F.SeqNum),
                           v_mod.Where().seq(3).user_type("ut"))
    if kind == "where_id":
        return v_mod.Query(v_mod.Select(), v_mod.Where().id(2**40 + 5))
    if kind == "parsed":
        return v_mod.Query(q="SELECT id,value_type WHERE seq=4,id=0x10")
    return v_mod.Query()


MESSAGES = ["ping", "find", "find_nowant", "get", "get_query", "listen",
            "listen_query", "put", "put_signed", "put_nocreated", "refresh",
            "pong", "pong6", "nodes_values", "nodes_values_full",
            "listen_confirm", "value_announced", "error", "error_noid",
            "value_part", "value_part_indexed", "network_ping"]


def build(pkg, kind):
    v_mod, w, ih_mod, sa_mod = PKGS[pkg]
    IH, SA = ih_mod.InfoHash, sa_mod.SockAddr
    myid, target = IH(bytes(range(20))), IH(bytes(range(100, 120)))
    token = b"\xaa\xbb\xcc\xdd"
    a4 = SA("10.0.42.7", 4222, sa_mod.AF_INET)
    a6 = SA("2001:db9::17", 4224, sa_mod.AF_INET6)
    b = w.MessageBuilder(myid, network=9 if kind == "network_ping" else 0)
    tid = w.make_tid(b"gt", 0x1234 + MESSAGES.index(kind))
    n4 = w.pack_nodes([_Node(target, a4), _Node(myid, a4)], sa_mod.AF_INET)
    n6 = w.pack_nodes([_Node(target, a6)], sa_mod.AF_INET6)
    return {
        "ping": lambda: b.ping(tid),
        "network_ping": lambda: b.ping(tid),
        "find": lambda: b.find_node(tid, target, w.WANT4 | w.WANT6),
        "find_nowant": lambda: b.find_node(tid, target, 0),
        "get": lambda: b.get_values(tid, target, None, w.WANT6),
        "get_query": lambda: b.get_values(tid, target,
                                          _query(pkg, "select_where"),
                                          w.WANT4),
        "listen": lambda: b.listen(tid, target, token, w.make_tid(b"so", 4),
                                   None),
        "listen_query": lambda: b.listen(tid, target, token,
                                         w.make_tid(b"so", 5),
                                         _query(pkg, "where_id")),
        "put": lambda: b.announce_value(tid, target, _value(pkg, "ut"),
                                        1234.7, token),
        "put_signed": lambda: b.announce_value(
            tid, target, _value(pkg, "signed_to"), 99, token),
        "put_nocreated": lambda: b.announce_value(
            tid, target, _value(pkg, "encrypted"), None, token),
        "refresh": lambda: b.refresh_value(tid, target, 2**63 + 1, token),
        "pong": lambda: b.pong(tid, a4),
        "pong6": lambda: b.pong(tid, a6),
        "nodes_values": lambda: b.nodes_values(tid, a4, n4, b"",
                                               token=token),
        "nodes_values_full": lambda: b.nodes_values(
            tid, a6, n4, n6, values=[_value(pkg, "plain").pack(),
                                     _value(pkg, "signed").pack()],
            fields={"f": [0, 3], "v": [1, 2, 3, 4]}, token=token,
            values_size=2),
        "listen_confirm": lambda: b.listen_confirm(tid, a4),
        "value_announced": lambda: b.value_announced(tid, a4, 42),
        "error": lambda: b.error(tid, 401, "Unauthorized", include_id=True),
        "error_noid": lambda: b.error(tid, 404, "Not found"),
        "value_part": lambda: b.value_part(tid, 1280, b"\x01\x02\x03"),
        "value_part_indexed": lambda: b.value_part(tid, 0, b"\xff" * 600,
                                                   index=3),
    }[kind]()


@pytest.mark.parametrize("kind", MESSAGES)
def test_message_bytes_and_parse_equal(kind):
    jb, tb = build("jax", kind), build("port", kind)
    assert jb == tb
    jm, tm = jw.parse_message(jb), tw.parse_message(tb)
    assert norm(jm) == norm(tm)


@pytest.mark.parametrize("blob", [b"\x92\x01\x02", b"\xc1", b"\x81\xa1t",
                                  b"\x83\xa1y\xa1r\xa1r\x81\xa2sa\xc4\x01x"
                                  b"\xa1t\xc4\x00"])
def test_malformed_datagrams_equal(blob):
    """A bad datagram is refused, or parsed, the same way by both."""
    out = []
    for w in (jw, tw):
        try:
            out.append(("ok", norm(w.parse_message(blob))))
        except Exception as e:             # noqa: BLE001 - compared below
            out.append(("err", isinstance(e, ValueError)))
    assert out[0] == out[1]


@pytest.mark.parametrize("af", ["ipv4", "ipv6"])
def test_pack_unpack_nodes(af):
    out = {}
    for pkg, (_, w, ih_mod, sa_mod) in PKGS.items():
        fam = sa_mod.AF_INET if af == "ipv4" else sa_mod.AF_INET6
        hosts = (["10.1.2.3", "192.168.255.1", "1.0.0.0"] if af == "ipv4"
                 else ["2001:db9::1", "fe80::abcd:1", "::1"])
        nodes = [_Node(ih_mod.InfoHash.get(f"n{i}"),
                       sa_mod.SockAddr(h, 4222 + i, fam))
                 for i, h in enumerate(hosts)]
        blob = w.pack_nodes(nodes, fam)
        assert len(blob) == len(nodes) * (26 if af == "ipv4" else 38)
        out[pkg] = (blob, norm(w.unpack_nodes(blob, fam)),
                    norm(w.unpack_nodes(blob[:-1], fam)))
    assert out["jax"] == out["port"]


@pytest.mark.parametrize("kind", ["plain", "ut", "signed", "signed_to",
                                  "encrypted"])
def test_value_forms_equal(kind):
    jvv, tvv = _value("jax", kind), _value("port", kind)
    assert jvv.get_to_sign() == tvv.get_to_sign()
    assert jvv.get_to_encrypt() == tvv.get_to_encrypt()
    assert jvv.packed() == tvv.packed()
    assert jvv.pack() == tvv.pack()
    assert (jvv.size(), jvv.is_signed(), jvv.is_encrypted()) == (
        tvv.size(), tvv.is_signed(), tvv.is_encrypted())
    if kind not in ("signed", "signed_to"):   # owner needs a real key
        back_j = jv.Value.from_packed(jvv.packed())
        back_t = tv.Value.from_packed(tvv.packed())
        assert norm(back_j) == norm(back_t)
        assert back_t.packed() == tvv.packed()
    fields = [tv.Field.Id, tv.Field.ValueType, tv.Field.UserType,
              tv.Field.SeqNum]
    assert jvv.pack_fields([jv.Field(int(f)) for f in fields]) == \
        tvv.pack_fields(fields)


@pytest.mark.parametrize("kind", ["select_where", "where_id", "parsed",
                                  "empty"])
def test_query_algebra_equal(kind):
    jq, tq = _query("jax", kind), _query("port", kind)
    assert norm(jq) == norm(tq)
    assert norm(jv.Query.unpack(jq.pack())) == norm(
        tv.Query.unpack(tq.pack()))
    assert bool(jq) == bool(tq)
    assert jq.is_satisfied_by(jv.Query()) == tq.is_satisfied_by(tv.Query())
    assert tq.is_satisfied_by(tq) and jq.is_satisfied_by(jq)
    vals = {p: [_value(p, k) for k in ("plain", "ut", "encrypted")]
            for p in PKGS}
    for p, q in (("jax", jq), ("port", tq)):
        vals[p][1].seq = 3
        vals[p][2].id = 2**40 + 5
    hits = {p: [bool(q.where.get_filter()(v)) for v in vals[p]]
            for p, q in (("jax", jq), ("port", tq))}
    assert hits["jax"] == hits["port"]
    rows = {p: [v_mod.FieldValueIndex(v, q.select) for v in vals[p]]
            for p, q, v_mod in (("jax", jq, jv), ("port", tq, tv))}
    assert [repr(r) for r in rows["jax"]] == [repr(r) for r in rows["port"]]
