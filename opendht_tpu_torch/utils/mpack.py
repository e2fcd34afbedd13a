"""MessagePack, the host node's wire and value encoding.

The port's one codec.  :func:`packb` gives the bytes ``msgpack.packb``
gives with its defaults (``use_bin_type=True``, float64, ``strict_types``
off: ``bool`` before ``int``, any ``int`` / ``str`` / ``dict`` subclass
packs as its base, list and tuple both as an array, ``bytes`` and
``bytearray`` as bin, the narrowest int and length forms; nothing the
host modules never pack, such as extension types).  :func:`unpackb` returns what ``msgpack.unpackb(b, raw=False,
strict_map_key=False)`` returns: str as ``str``, bin as ``bytes``,
arrays as lists, maps as dicts with keys of any hashable type, an
extension as :class:`ExtType`.  :class:`Unpacker` reads a stream of
objects fed in pieces, as ``msgpack.Unpacker(raw=False)`` fed with
``feed`` does.  Every malformed input raises
``ValueError`` (truncated input, trailing bytes, the reserved ``0xc1``
byte, invalid UTF-8, too deep a nesting), as msgpack's errors do; an
array or map as a map key raises ``TypeError`` (unhashable), as there.
"""

from __future__ import annotations

import struct
from collections import namedtuple

__all__ = ["ExtType", "Unpacker", "packb", "unpackb"]

ExtType = namedtuple("ExtType", "code data")

#: msgpack's default nesting limit for both directions.
NEST_LIMIT = 512

_B = struct.Struct(">B").pack
_H = struct.Struct(">H").pack
_I = struct.Struct(">I").pack
_Q = struct.Struct(">Q").pack
_b = struct.Struct(">b").pack
_h = struct.Struct(">h").pack
_i = struct.Struct(">i").pack
_q = struct.Struct(">q").pack
_d = struct.Struct(">d").pack


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 0x100:
            out += b"\xcc" + _B(v)
        elif v < 0x10000:
            out += b"\xcd" + _H(v)
        elif v < 0x100000000:
            out += b"\xce" + _I(v)
        elif v < 0x10000000000000000:
            out += b"\xcf" + _Q(v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += b"\xd0" + _b(v)
    elif v >= -0x8000:
        out += b"\xd1" + _h(v)
    elif v >= -0x80000000:
        out += b"\xd2" + _i(v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + _q(v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, tags: bytes,
              out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-bit
    (where ``tags[0]`` is non-zero), 16-bit and 32-bit forms."""
    if n < fix_max:
        out.append(fix | n)
    elif tags[0] and n < 0x100:
        out.append(tags[0])
        out.append(n)
    elif n < 0x10000:
        out.append(tags[1])
        out += _H(n)
    elif n < 0x100000000:
        out.append(tags[2])
        out += _I(n)
    else:
        raise ValueError("object too large for MessagePack")


def _pack_bin(b, out: bytearray) -> None:
    n = len(b)
    if n < 0x100:
        out.append(0xC4)
        out.append(n)
    elif n < 0x10000:
        out.append(0xC5)
        out += _H(n)
    elif n < 0x100000000:
        out.append(0xC6)
        out += _I(n)
    else:
        raise ValueError("bin too large for MessagePack")
    out += b


_STR_TAGS = b"\xd9\xda\xdb"
_ARR_TAGS = b"\x00\xdc\xdd"
_MAP_TAGS = b"\x00\xde\xdf"


def _pack(o, out: bytearray, depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    t = type(o)
    # Exact types first (the common case), then msgpack's subclass rules
    # in its own order.
    if o is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if o else 0xC2)
    elif t is int:
        _pack_int(o, out)
    elif t is bytes:
        _pack_bin(o, out)
    elif t is str:
        b = o.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, _STR_TAGS, out)
        out += b
    elif t is dict:
        _pack_len(len(o), 0x80, 16, _MAP_TAGS, out)
        for k, v in o.items():
            _pack(k, out, depth - 1)
            _pack(v, out, depth - 1)
    elif t is list or t is tuple:
        _pack_len(len(o), 0x90, 16, _ARR_TAGS, out)
        for v in o:
            _pack(v, out, depth - 1)
    elif t is float:
        out.append(0xCB)
        out += _d(o)
    elif isinstance(o, bool):
        out.append(0xC3 if o else 0xC2)
    elif isinstance(o, int):
        _pack_int(int(o), out)
    elif isinstance(o, float):
        out.append(0xCB)
        out += _d(float(o))
    elif isinstance(o, (bytes, bytearray)):
        _pack_bin(bytes(o), out)
    elif isinstance(o, str):
        b = str.encode(o, "utf-8")
        _pack_len(len(b), 0xA0, 32, _STR_TAGS, out)
        out += b
    elif isinstance(o, dict):
        _pack_len(len(o), 0x80, 16, _MAP_TAGS, out)
        for k, v in dict.items(o):
            _pack(k, out, depth - 1)
            _pack(v, out, depth - 1)
    elif isinstance(o, (list, tuple)):
        _pack_len(len(o), 0x90, 16, _ARR_TAGS, out)
        for v in o:
            _pack(v, out, depth - 1)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` with msgpack's defaults."""
    out = bytearray()
    _pack(obj, out, NEST_LIMIT)
    return bytes(out)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

_UNPACK = {w: struct.Struct(f">{c}").unpack_from for w, c in (
    ("B", "B"), ("H", "H"), ("I", "I"), ("Q", "Q"), ("b", "b"), ("h", "h"),
    ("i", "i"), ("q", "q"), ("f", "f"), ("d", "d"))}
# tag -> (struct code, width) of the fixed-width scalars
_SCALARS = {0xCA: ("f", 4), 0xCB: ("d", 8), 0xCC: ("B", 1), 0xCD: ("H", 2),
            0xCE: ("I", 4), 0xCF: ("Q", 8), 0xD0: ("b", 1), 0xD1: ("h", 2),
            0xD2: ("i", 4), 0xD3: ("q", 8)}
# tag -> width of the length field (str 8/16/32, bin 8/16/32, array and
# map 16/32, ext 8/16/32)
_LEN = {0xD9: 1, 0xDA: 2, 0xDB: 4, 0xC4: 1, 0xC5: 2, 0xC6: 4, 0xDC: 2,
        0xDD: 4, 0xDE: 2, 0xDF: 4, 0xC7: 1, 0xC8: 2, 0xC9: 4}
_LEN_CODE = {1: "B", 2: "H", 4: "I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Incomplete(ValueError):
    """The input ends inside an object."""


class _Reader:
    __slots__ = ("buf", "pos", "end", "strict")

    def __init__(self, buf: bytes, strict: bool):
        self.buf = buf
        self.pos = 0
        self.end = len(buf)
        self.strict = strict

    def take(self, n: int) -> bytes:
        p = self.pos
        if p + n > self.end:
            raise _Incomplete("Unpack failed: incomplete input")
        self.pos = p + n
        return self.buf[p:p + n]

    def scalar(self, code: str, width: int):
        p = self.pos
        if p + width > self.end:
            raise _Incomplete("Unpack failed: incomplete input")
        self.pos = p + width
        return _UNPACK[code](self.buf, p)[0]

    def obj(self, depth: int):
        if depth < 0:
            raise ValueError("recursion limit exceeded.")
        if self.pos >= self.end:
            raise _Incomplete("Unpack failed: incomplete input")
        t = self.buf[self.pos]
        self.pos += 1
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        if 0x90 <= t <= 0x9F:
            return [self.obj(depth - 1) for _ in range(t & 0x0F)]
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F, depth)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        sc = _SCALARS.get(t)
        if sc is not None:
            return self.scalar(*sc)
        w = _LEN.get(t)
        if w is not None:
            n = self.scalar(_LEN_CODE[w], w)
            if t in (0xD9, 0xDA, 0xDB):
                return self.take(n).decode("utf-8")
            if t in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if t in (0xDC, 0xDD):
                return [self.obj(depth - 1) for _ in range(n)]
            if t in (0xDE, 0xDF):
                return self.map(n, depth)
            code = self.scalar("b", 1)
            return ExtType(code, self.take(n))
        n = _FIXEXT.get(t)
        if n is not None:
            code = self.scalar("b", 1)
            return ExtType(code, self.take(n))
        raise ValueError(f"Unpack failed: reserved byte {t:#x}")

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(depth - 1)
            if self.strict and type(k) is not str and type(k) is not bytes:
                raise ValueError(f"{type(k).__name__} is not allowed for "
                                 "map key when strict_map_key=True")
            out[k] = self.obj(depth - 1)
        return out


def unpackb(blob, strict_map_key: bool = False) -> object:
    """``msgpack.unpackb(blob, raw=False, strict_map_key=False)``; with
    ``strict_map_key=True``, msgpack's default, a map key that is not
    str or bin raises ``ValueError``."""
    r = _Reader(bytes(blob), strict_map_key)
    o = r.obj(NEST_LIMIT)
    if r.pos != r.end:
        raise ValueError("unpack(b) received extra data.")
    return o


class Unpacker:
    """Objects from a byte stream fed in arbitrary pieces: ``feed``
    appends, iterating yields each whole object buffered and keeps a
    partial one for the next ``feed``."""

    def __init__(self, strict_map_key: bool = False):
        self._buf = b""
        self._strict = strict_map_key

    def feed(self, data) -> None:
        self._buf += bytes(data)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._buf:
            raise StopIteration
        r = _Reader(self._buf, self._strict)
        try:
            o = r.obj(NEST_LIMIT)
        except _Incomplete:
            raise StopIteration from None
        self._buf = self._buf[r.pos:]
        return o
