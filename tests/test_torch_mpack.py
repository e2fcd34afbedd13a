"""The port's MessagePack codec against ``msgpack``: hypothesis-drawn
nested objects over the type set the host modules pack (nil, bool,
ints at every width boundary, float64, str, bin, list, tuple, maps with
any key type), every message of ``tests/test_wire_golden.py`` built by
both packages, and the malformed inputs both refuse."""

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from opendht_tpu.core.value import (Field as JField, Query as JQuery,
                                    Select as JSelect, Value as JValue,
                                    Where as JWhere)
from opendht_tpu.net import wire as jw
from opendht_tpu.utils.infohash import InfoHash as JInfoHash
from opendht_tpu.utils.sockaddr import SockAddr as JSockAddr
from opendht_tpu_torch.core.value import (Field as TField, Query as TQuery,
                                          Select as TSelect, Value as TValue,
                                          Where as TWhere)
from opendht_tpu_torch.net import wire as tw
from opendht_tpu_torch.utils import mpack
from opendht_tpu_torch.utils.infohash import InfoHash as TInfoHash
from opendht_tpu_torch.utils.sockaddr import SockAddr as TSockAddr

# Every width boundary of the int forms, and one past it.
INT_BOUNDS = sorted({b + d for b in (0, 0x7F, 0xFF, 0xFFFF, 0xFFFFFFFF,
                                     2**63 - 1, 2**64 - 1, -32, -128,
                                     -2**15, -2**31, -2**63)
                     for d in (-1, 0, 1)
                     if -2**63 <= b + d <= 2**64 - 1})
LEN_BOUNDS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]

ints = st.one_of(st.sampled_from(INT_BOUNDS),
                 st.integers(-2**63, 2**64 - 1))
scalars = st.one_of(
    st.none(), st.booleans(), ints,
    st.floats(allow_nan=False),
    st.text(max_size=40), st.binary(max_size=300))
keys = st.one_of(st.none(), st.booleans(), ints, st.floats(allow_nan=False),
                 st.text(max_size=8), st.binary(max_size=8))
objects = st.recursive(
    scalars,
    lambda kids: st.one_of(
        st.lists(kids, max_size=20),
        st.lists(kids, max_size=5).map(tuple),
        st.dictionaries(keys, kids, max_size=18)),
    max_leaves=40)


def _both_unpack(blob, strict=False):
    return (msgpack.unpackb(blob, raw=False, strict_map_key=strict),
            mpack.unpackb(blob, strict_map_key=strict))


@settings(max_examples=300, deadline=None)
@given(objects)
def test_packb_unpackb_match_msgpack(obj):
    blob = msgpack.packb(obj)
    assert mpack.packb(obj) == blob
    want, got = _both_unpack(blob)
    assert got == want
    assert mpack.packb(got) == blob


@pytest.mark.parametrize("v", INT_BOUNDS)
def test_int_width_boundaries(v):
    blob = msgpack.packb(v)
    assert mpack.packb(v) == blob
    assert mpack.unpackb(blob) == v == msgpack.unpackb(blob)


@pytest.mark.parametrize("n", LEN_BOUNDS)
def test_length_forms(n):
    """str, bin, array and map headers at every length boundary."""
    for obj in ("é" * (n // 2) + "a" * (n % 2), b"\x07" * n,
                list(range(min(n, 70000))), {i: None for i in range(n)}):
        blob = msgpack.packb(obj)
        assert mpack.packb(obj) == blob
        assert mpack.unpackb(blob) == msgpack.unpackb(
            blob, raw=False, strict_map_key=False)


def test_subclasses_and_buffers_pack_as_their_base():
    import enum

    class E(enum.IntEnum):
        A = 300

    class D(dict):
        pass

    class S(str):
        pass

    for obj in (E.A, D(a=1), S("x"), bytearray(b"ab"),
                [True, False, 1.5, -0.0, float("inf")], (1, (2, [3]))):
        assert mpack.packb(obj) == msgpack.packb(obj)
    # An extension arriving from outside decodes as msgpack decodes it.
    for code, data in ((5, b"abc"), (1, b"x"), (127, bytes(16)),
                       (7, bytes(300))):
        ext = msgpack.packb(msgpack.ExtType(code, data))
        assert mpack.unpackb(ext) == mpack.ExtType(code, data)
        assert tuple(msgpack.unpackb(ext)) == (code, data)


@pytest.mark.parametrize("blob", [
    b"", b"\x92\x01", b"\x01\x02", b"\xc1", b"\xa2\xff\xfe", b"\xcd\x01",
    b"\xc4\x05ab", b"\xdc\x00\x02\x01", b"\x81\x01"])
def test_malformed_inputs_raise_value_error(blob):
    with pytest.raises(ValueError):
        msgpack.unpackb(blob, raw=False, strict_map_key=False)
    with pytest.raises(ValueError):
        mpack.unpackb(blob)


def test_strict_map_key_and_refusals():
    blob = msgpack.packb({1: 2, "a": {b"k": 3}})
    assert mpack.unpackb(blob) == msgpack.unpackb(blob, raw=False,
                                                  strict_map_key=False)
    for f in (lambda: msgpack.unpackb(blob, raw=False),
              lambda: mpack.unpackb(blob, strict_map_key=True)):
        with pytest.raises(ValueError):
            f()
    ok = msgpack.packb({"a": {b"k": 3}})
    assert mpack.unpackb(ok, strict_map_key=True) == msgpack.unpackb(
        ok, raw=False)
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(bad)
        with pytest.raises(OverflowError):
            mpack.packb(bad)
    for bad in (object(), {1, 2}):
        with pytest.raises(TypeError):
            mpack.packb(bad)
    with pytest.raises(TypeError):          # a list as a map key
        mpack.unpackb(b"\x81\x91\x01\x02")


class _Node:
    def __init__(self, nid, addr):
        self.id = nid
        self.addr = addr


def _golden_messages(w, Value, Query, Select, Where, Field, InfoHash,
                     SockAddr):
    """Every message ``tests/test_wire_golden.py`` pins, built by one
    package."""
    myid, target = InfoHash(bytes(range(20))), InfoHash(bytes(range(100,
                                                                    120)))
    token = b"\xaa\xbb\xcc\xdd"
    a4 = SockAddr("10.0.42.7", 4222)
    b = w.MessageBuilder(myid)
    v = Value(b"hello")
    v.id = 0xDEAD
    n4 = w.pack_nodes([_Node(target, a4)], 2)
    return [
        b.ping(w.make_tid(b"pn", 1)),
        b.find_node(w.make_tid(b"fn", 2), target, w.WANT4 | w.WANT6),
        b.get_values(w.make_tid(b"gt", 3), target,
                     Query(Select().field(Field.Id), Where().seq(3)),
                     w.WANT4),
        b.listen(w.make_tid(b"lt", 4), target, token,
                 w.make_tid(b"gt", 4), None),
        b.announce_value(w.make_tid(b"pt", 5), target, v, 1234, token),
        b.refresh_value(w.make_tid(b"rf", 6), target, 0xBEEF, token),
        b.pong(w.make_tid(b"pn", 7), a4),
        b.nodes_values(w.make_tid(b"gt", 8), a4, n4, b"", token=token),
        b.value_announced(w.make_tid(b"pt", 9), a4, 42),
        b.error(w.make_tid(b"lt", 10), 401, "Unauthorized",
                include_id=True),
        b.value_part(w.make_tid(b"pt", 11), 1280, b"\x01\x02\x03"),
    ]


def test_golden_wire_messages_both_packages():
    jm = _golden_messages(jw, JValue, JQuery, JSelect, JWhere, JField,
                          JInfoHash, JSockAddr)
    tm = _golden_messages(tw, TValue, TQuery, TSelect, TWhere, TField,
                          TInfoHash, TSockAddr)
    assert len(jm) == len(tm) == 11
    for j, t in zip(jm, tm):
        assert j == t
        want, got = _both_unpack(j)
        assert got == want
        assert mpack.packb(got) == msgpack.packb(want) == j
