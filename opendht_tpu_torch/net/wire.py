"""The msgpack wire protocol: message building and parsing.

Re-design of the reference wire layer (ref: src/network_engine.cpp:604-1430).
Message envelope is a msgpack map with single-letter keys:

* ``t`` — 4-byte transaction id: 2-char method prefix + u16 seqno
  (prefixes pn/fn/gt/pt/rf/lt — ref src/network_engine.cpp:47-52)
* ``y`` — kind: "q" query / "r" reply / "e" error / "v" value part
* ``q`` + ``a`` — method name + argument map (queries)
* ``r`` — result map (replies; always carries ``id`` and echoed ``sa``)
* ``e`` — [code, message] (errors)
* ``v`` — agent tag ("RNG1"), ``n`` — optional network id

Argument keys: ``id`` sender, ``target``/``h`` lookup keys, ``token`` write
token, ``values``, ``vid`` value id, ``sid`` listen socket id, ``w`` want,
``c`` created offset, ``q`` query, ``n4``/``n6`` packed node lists
(26 B IPv4 / 38 B IPv6 per node — ref src/network_engine.cpp:943-992),
``sa`` echoed observed source address, ``p`` {o: offset, d: chunk} value
parts for fragmented transfers (ref :855-882).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..utils.mpack import packb, unpackb

from ..core.constants import AGENT
from ..core.value import Query, Value
from ..utils.infohash import HASH_LEN, InfoHash
from ..utils.sockaddr import AF_INET, AF_INET6, SockAddr

# method id <-> (name, tid prefix)
PING, FIND_NODE, GET_VALUES, ANNOUNCE_VALUE, REFRESH, LISTEN = range(6)
METHODS = {
    PING: ("ping", b"pn"),
    FIND_NODE: ("find", b"fn"),
    GET_VALUES: ("get", b"gt"),
    ANNOUNCE_VALUE: ("put", b"pt"),
    REFRESH: ("refresh", b"rf"),
    LISTEN: ("listen", b"lt"),
}
NAME_TO_METHOD = {name: m for m, (name, _) in METHODS.items()}

WANT4, WANT6 = 1, 2

# error codes (ref: include/opendht/net.h)
E_NON_AUTHORITATIVE_INFORMATION = 203
E_UNAUTHORIZED = 401
E_NOT_FOUND = 404


def make_tid(prefix: bytes, seq: int) -> bytes:
    return prefix + (seq & 0xFFFF).to_bytes(2, "little")


class MessageType:
    Error = "e"
    Reply = "r"
    Ping = "ping"
    FindNode = "find"
    GetValues = "get"
    AnnounceValue = "put"
    Refresh = "refresh"
    Listen = "listen"
    ValueData = "v"


def pack_nodes(nodes, af: int) -> bytes:
    """Compact node info: id ‖ ip ‖ port (ref: bufferNodes :943-992)."""
    out = bytearray()
    for n in nodes:
        out += bytes(n.id)
        out += n.addr.pack_ip()
    return bytes(out)


def unpack_nodes(blob: bytes, af: int) -> List[Tuple[InfoHash, SockAddr]]:
    """ref: deserializeNodes src/network_engine.cpp:788-828"""
    step = HASH_LEN + (6 if af == AF_INET else 18)
    out = []
    if len(blob) % step:
        return out
    for i in range(0, len(blob), step):
        nid = InfoHash(blob[i:i + HASH_LEN])
        addr = SockAddr.unpack_ip(blob[i + HASH_LEN:i + step])
        out.append((nid, addr))
    return out


class ParsedMessage:
    """Decoded inbound message (ref: ParsedMessage src/network_engine.cpp:
    1252-1430)."""

    __slots__ = ("type", "tid", "id", "network", "info_hash", "target",
                 "token", "value_id", "values", "fields", "field_values",
                 "nodes4", "nodes6", "addr", "created", "socket_id", "want",
                 "query", "error_code", "is_reply", "part_index",
                 "part_offset", "part_data", "value_parts_total")

    def __init__(self):
        self.type = None
        self.tid = b""
        self.id = None            # sender InfoHash
        self.network = 0
        self.info_hash = None
        self.target = None
        self.token = b""
        self.value_id = 0
        self.values: List[Value] = []
        self.fields: List[int] = []
        self.field_values: List[list] = []
        self.nodes4: List[Tuple[InfoHash, SockAddr]] = []
        self.nodes6: List[Tuple[InfoHash, SockAddr]] = []
        self.addr: Optional[SockAddr] = None   # our address as seen by peer
        self.created: Optional[float] = None   # age offset (seconds)
        self.socket_id = b""
        self.want = 0
        self.query: Optional[Query] = None
        self.error_code = 0
        self.is_reply = False
        self.part_index = 0
        self.part_offset = 0
        self.part_data = b""
        self.value_parts_total = 0


def parse_message(data: bytes) -> ParsedMessage:
    o = unpackb(data)
    if not isinstance(o, dict):
        raise ValueError("not a msgpack map")
    m = ParsedMessage()
    m.tid = bytes(o.get("t", b""))
    m.network = o.get("n", 0)
    y = o.get("y", "q")

    if y == "e":
        m.type = MessageType.Error
        e = o.get("e", [0, ""])
        m.error_code = int(e[0]) if e else 0
        r = o.get("r", {})
        if "id" in r:
            m.id = InfoHash(bytes(r["id"]))
        return m

    if y == "v":
        # fragmented value part: p = {value_index: {o, d}} (ref :872-875)
        m.type = MessageType.ValueData
        p = o.get("p", {})
        if p and not ("o" in p or "d" in p):
            m.part_index, inner = next(iter(p.items()))
            m.part_index = int(m.part_index)
        else:  # tolerate the un-indexed flat form
            inner = p
        m.part_offset = int(inner.get("o", 0))
        m.part_data = bytes(inner.get("d", b""))
        return m

    body = o.get("r") if y == "r" else o.get("a", {})
    body = body or {}
    m.is_reply = (y == "r")
    if "id" in body:
        m.id = InfoHash(bytes(body["id"]))
    if "sa" in body:
        try:
            m.addr = SockAddr.unpack_ip(bytes(body["sa"]))
        except ValueError:
            pass
    if "h" in body:
        m.info_hash = InfoHash(bytes(body["h"]))
    if "target" in body:
        m.target = InfoHash(bytes(body["target"]))
    if "token" in body:
        m.token = bytes(body["token"])
    if "vid" in body:
        m.value_id = int(body["vid"])
    if "sid" in body:
        m.socket_id = bytes(body["sid"])
    if "w" in body:
        m.want = unpack_want(body["w"])
    if "c" in body:
        m.created = float(body["c"])
    if "q" in body and y != "r" and isinstance(body["q"], dict):
        m.query = Query.unpack(body["q"])
    if "n4" in body:
        m.nodes4 = unpack_nodes(bytes(body["n4"]), AF_INET)
    if "n6" in body:
        m.nodes6 = unpack_nodes(bytes(body["n6"]), AF_INET6)
    if "values" in body:
        for vo in body["values"]:
            try:
                m.values.append(Value.unpack(vo))
            except Exception:
                continue
    if "psize" in body:
        m.value_parts_total = int(body["psize"])
    if "fields" in body:
        f = body["fields"]
        m.fields = [int(x) for x in f.get("f", [])]
        flat = f.get("v", [])
        k = len(m.fields)
        if k:
            m.field_values = [flat[i:i + k] for i in range(0, len(flat), k)]

    if y == "r":
        m.type = MessageType.Reply
    else:
        m.type = o.get("q", "")
    return m


# The ``w`` array carries the reference build platform's OS constants
# (Linux AF_INET=2 / AF_INET6=10, ref src/network_engine.cpp:705-709) —
# NOT our internal SockAddr family tags.
WIRE_AF_INET = 2
WIRE_AF_INET6 = 10


def pack_want(want: int) -> list:
    out = []
    if want & WANT4:
        out.append(WIRE_AF_INET)
    if want & WANT6:
        out.append(WIRE_AF_INET6)
    return out


def unpack_want(obj) -> int:
    if isinstance(obj, int):  # tolerate the bitmask form
        return obj
    w = 0
    for af in obj or []:
        if af == WIRE_AF_INET:
            w |= WANT4
        elif af == WIRE_AF_INET6:
            w |= WANT6
    return w


class MessageBuilder:
    """Builds outbound messages (the serialization half of the engine).

    Key order inside every map mirrors the reference packers exactly
    (src/network_engine.cpp:634-1250) so messages are byte-identical —
    pinned by tests/test_wire_golden.py.
    """

    def __init__(self, myid: InfoHash, network: int = 0):
        self.myid = myid
        self.network = network

    def _envelope(self, tid: bytes, y: str, payload_key: str, payload) -> bytes:
        env = {payload_key: payload}
        if y == "q":
            env["q"] = payload.pop("_q")
        env["t"] = tid
        env["y"] = y
        env["v"] = AGENT
        if self.network:
            env["n"] = self.network
        return packb(env)

    def _query(self, tid: bytes, method: str, args: dict) -> bytes:
        # "id" is always the first argument key (every reference packer
        # packs it before anything else).
        full = {"id": bytes(self.myid)}
        full.update(args)
        full["_q"] = method
        return self._envelope(tid, "q", "a", full)

    def _reply(self, tid: bytes, dest: Optional[SockAddr],
               pre: Optional[dict] = None,
               post: Optional[dict] = None) -> bytes:
        """Reply body: id, then ``pre`` fields, then the echoed source
        address, then ``post`` fields — the reference's insertAddr call
        position varies per reply type."""
        r = {"id": bytes(self.myid)}
        if pre:
            r.update(pre)
        if dest:
            # IP only, no port (insertAddr src/network_engine.cpp:604-613)
            r["sa"] = dest.pack_ip()[:-2]
        if post:
            r.update(post)
        return self._envelope(tid, "r", "r", r)

    # -- queries -----------------------------------------------------------
    def ping(self, tid: bytes) -> bytes:
        return self._query(tid, "ping", {})

    def find_node(self, tid: bytes, target: InfoHash, want: int) -> bytes:
        args = {"target": bytes(target)}
        if want > 0:
            args["w"] = pack_want(want)
        return self._query(tid, "find", args)

    def get_values(self, tid: bytes, info_hash: InfoHash, query: Optional[Query],
                   want: int) -> bytes:
        args = {"h": bytes(info_hash)}
        if query:
            args["q"] = query.pack()
        if want > 0:
            args["w"] = pack_want(want)
        return self._query(tid, "get", args)

    def listen(self, tid: bytes, info_hash: InfoHash, token: bytes,
               socket_id: bytes, query: Optional[Query]) -> bytes:
        args = {"h": bytes(info_hash), "token": token, "sid": socket_id}
        if query:
            args["q"] = query.pack()
        return self._query(tid, "listen", args)

    def announce_value(self, tid: bytes, info_hash: InfoHash, value: Value,
                       created: Optional[float], token: bytes) -> bytes:
        """``created`` is absolute seconds (the reference packs
        ``to_time_t(created)``, clamped to now by the receiver)."""
        args = {"h": bytes(info_hash), "values": [value.pack()]}
        if created is not None:
            args["c"] = int(created)
        args["token"] = token
        return self._query(tid, "put", args)

    def refresh_value(self, tid: bytes, info_hash: InfoHash, vid: int,
                      token: bytes) -> bytes:
        args = {"h": bytes(info_hash), "vid": vid, "token": token}
        return self._query(tid, "refresh", args)

    # -- replies -----------------------------------------------------------
    def pong(self, tid: bytes, dest: SockAddr) -> bytes:
        return self._reply(tid, dest)

    def nodes_values(self, tid: bytes, dest: SockAddr, nodes4: bytes,
                     nodes6: bytes, values: Optional[list] = None,
                     fields: Optional[dict] = None, token: bytes = b"",
                     values_size: int = 0) -> bytes:
        r = {}
        if nodes4:
            r["n4"] = nodes4
        if nodes6:
            r["n6"] = nodes6
        if token:
            r["token"] = token
        if values:
            r["values"] = values
        if values_size:
            r["psize"] = values_size
        if fields:
            r["fields"] = fields
        return self._reply(tid, dest, post=r)

    def listen_confirm(self, tid: bytes, dest: SockAddr) -> bytes:
        return self._reply(tid, dest)

    def value_announced(self, tid: bytes, dest: SockAddr, vid: int) -> bytes:
        # r = {id, vid, sa} (sendValueAnnounced :1198-1218)
        return self._reply(tid, dest, pre={"vid": vid})

    def value_part(self, tid: bytes, offset: int, chunk: bytes,
                   index: int = 0) -> bytes:
        """Fragment envelope: [n,] y, t, p{index: {o, d}}
        (sendValueParts :853-882 — network id first, no agent tag)."""
        env = {}
        if self.network:
            env["n"] = self.network
        env["y"] = "v"
        env["t"] = tid
        env["p"] = {index: {"o": offset, "d": chunk}}
        return packb(env)

    def error(self, tid: bytes, code: int, message: str,
              include_id: bool = False) -> bytes:
        env = {"e": [code, message]}
        if include_id:
            env["r"] = {"id": bytes(self.myid)}
        env["t"] = tid
        env["y"] = "e"
        env["v"] = AGENT
        if self.network:
            env["n"] = self.network
        return packb(env)
