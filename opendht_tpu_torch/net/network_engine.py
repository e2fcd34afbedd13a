"""The wire-protocol engine: RPC send/receive, retries, rate limits,
fragmentation, listen sockets.

Re-design of the reference ``net::NetworkEngine``
(ref: src/network_engine.cpp, include/opendht/network_engine.h).  The engine
owns parsing/sending and request lifecycles; the DHT core owns semantics and
is attached via a handler object exposing the nine callbacks the reference
injects with std::bind (ref: src/dht.cpp:2746-2755):

    on_error(request, code)
    on_new_node(node, confirm)          confirm: 0 seen / 1 queried-us / 2 replied
    on_reported_addr(node_id, addr)
    on_ping(node)                       -> RequestAnswer
    on_find(node, target, want)         -> RequestAnswer
    on_get_values(node, info_hash, want, query) -> RequestAnswer
    on_listen(node, info_hash, token, socket_id, query) -> RequestAnswer
    on_announce(node, info_hash, values, created, token) -> RequestAnswer
    on_refresh(node, info_hash, value_id, token) -> RequestAnswer

Handlers raise :class:`DhtProtocolException` to produce wire errors.

Inbound path (ref: processMessage :365-450): martian filter, blacklist,
per-IP + global rate limit, self-message drop, network-id check, then
dispatch.  Outbound requests retransmit every MAX_RESPONSE_TIME (1 s) up to
3 attempts via scheduler jobs (ref: requestStep :232-262).

Large-value transfers (>8 KB aggregate or >50 values) are fragmented: a
header message carries ``psize`` (total payload bytes), then MTU-sized
``ValueData`` part packets follow, reassembled with 3 s inter-part / 10 s
total timeouts (ref: packValueHeader/sendValueParts :831-882,
maintainRxBuffer :1433-1482).
"""

from __future__ import annotations

import ipaddress
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.mpack import packb, unpackb

from ..core.constants import (BLACKLIST_EXPIRE_TIME, MAX_BLACKLIST_SIZE,
                              MAX_PACKET_VALUE_SIZE, MAX_REQUESTS_PER_SEC,
                              MAX_REQUESTS_PER_SEC_PER_IP, MAX_RESPONSE_TIME,
                              MAX_MESSAGE_VALUE_COUNT, MTU, RX_MAX_PACKET_TIME,
                              RX_TIMEOUT)
from ..core.node import Node
from ..core.node_cache import NodeCache
from ..core.scheduler import Scheduler
from ..core.value import Query, Value
from ..utils.infohash import InfoHash
from ..utils.logger import NONE, Logger
from ..utils.metrics import MetricsRegistry
from ..utils.rate_limiter import (RateLimiter, TokenBucket,
                                  make_rate_limiter)
from ..utils.sockaddr import AF_INET, AF_INET6, SockAddr
from .request import Request, RequestState
from .transport import DatagramTransport
from .wire import (MessageBuilder, MessageType, ParsedMessage, make_tid,
                   pack_nodes, parse_message, E_NON_AUTHORITATIVE_INFORMATION,
                   E_UNAUTHORIZED, METHODS, PING, FIND_NODE, GET_VALUES,
                   ANNOUNCE_VALUE, REFRESH, LISTEN, WANT4, WANT6)

SEND_NODES = 8  # nodes per reply (ref: src/network_engine.cpp:58)

# Canonical message-type taxonomy for the per-type counters (ref:
# network_engine.h:509-516 keeps one enum-indexed array per direction).
# Request keys are the METHODS names — identical for inbound (wire "q"
# strings) and outbound, so stats_in/stats_out finally share ONE key
# set; replies/errors count under "reply"/"error" in BOTH directions
# (the previous code only counted the inbound side and keyed inbound
# requests on the RAW wire string, handing an attacker unbounded
# counter-key cardinality); fragmentation part packets count as
# "value_parts"; anything unrecognized folds into "other".
CANONICAL_TYPES = tuple(name for name, _ in METHODS.values()) + (
    "reply", "error", "value_parts", "other")


class DhtProtocolException(Exception):
    INVALID_TID_SIZE = 421
    UNKNOWN_TID = 422
    WRONG_NODE_INFO_BUF_LEN = 423
    UNAUTHORIZED = E_UNAUTHORIZED
    NOT_FOUND = 404

    def __init__(self, code: int, message: str = ""):
        super().__init__(message)
        self.code = code
        self.message = message


class RequestAnswer:
    """Reply payload produced by DHT-core handlers
    (ref: NetworkEngine::RequestAnswer network_engine.h:220-240)."""

    __slots__ = ("ntoken", "vid", "values", "fields", "nodes4", "nodes6",
                 "expired")

    def __init__(self):
        self.ntoken = b""
        self.vid = 0
        self.values: List[Value] = []
        self.fields: List["FieldValueIndex"] = []  # partial values
        self.nodes4: List[Node] = []
        self.nodes6: List[Node] = []
        self.expired = False  # listen push marked values as expired


class Socket:
    """A persistent tid a remote may reuse to push listen updates
    (ref: openSocket :190-205)."""

    __slots__ = ("id", "on_receive")

    def __init__(self, sid: bytes, cb: Callable):
        self.id = sid
        self.on_receive = cb


class PartialMessage:
    __slots__ = ("msg", "from_addr", "start", "last_part", "buf", "total",
                 "received")

    def __init__(self, msg: ParsedMessage, from_addr: SockAddr, now: float):
        self.msg = msg
        self.from_addr = from_addr
        self.start = now
        self.last_part = now
        self.total = msg.value_parts_total
        self.buf = bytearray(self.total)
        self.received = [False] * ((self.total + MTU - 1) // MTU) if self.total else []

    def append(self, offset: int, data: bytes, now: float) -> None:
        if offset + len(data) > self.total:
            return
        self.buf[offset:offset + len(data)] = data
        idx = offset // MTU
        if idx < len(self.received):
            self.received[idx] = True
        self.last_part = now

    def complete(self) -> bool:
        return bool(self.received) and all(self.received)


class NetworkEngine:
    def __init__(self, myid: InfoHash, network: int,
                 transport4: Optional[DatagramTransport],
                 transport6: Optional[DatagramTransport],
                 scheduler: Scheduler, handler, cache: NodeCache,
                 logger: Logger = NONE, rng: Optional[random.Random] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.myid = myid
        self.network = network
        self.scheduler = scheduler
        self.handler = handler
        self.cache = cache
        self.log = logger
        self.rng = rng or random.Random()
        self.builder = MessageBuilder(myid, network)

        self.t4 = transport4
        self.t6 = transport6
        if self.t4:
            self.t4.set_receive_callback(self._on_packet)
        if self.t6:
            self.t6.set_receive_callback(self._on_packet)

        self.requests: Dict[bytes, Request] = {}
        self.opened_sockets: Dict[bytes, Socket] = {}
        self._tid_seq = self.rng.randrange(1 << 16)
        self._sock_seq = self.rng.randrange(1 << 16)

        self.rate_limiter = make_rate_limiter(MAX_REQUESTS_PER_SEC)
        # Keyed by host string (IPv4) or 8-byte packed /64 prefix
        # (IPv6).  Token buckets, not sliding windows: the map grows
        # one entry per distinct sender, so per-sender state must be
        # O(1) floats, not a deque of up to 200 timestamps — same
        # steady-state admit rate (utils/rate_limiter.py).
        self.ip_limiters: Dict[object, RateLimiter | TokenBucket] = {}
        self.blacklist: Dict[SockAddr, float] = {}

        self.partial_messages: Dict[bytes, PartialMessage] = {}
        self._rx_job = None

        # Per-message-type counters in/out (ref: network_engine.h:
        # 509-516), now registry-backed so the Prometheus/JSON surface
        # and the legacy stats_in/stats_out dict views read ONE source
        # of truth.  Keys are CANONICAL_TYPES only.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._msg_ctr = self.metrics.counter(
            "dht_net_messages_total",
            "DHT wire messages by direction and canonical type",
            ("dir", "type"))
        self._drop_ctr = self.metrics.counter(
            "dht_net_dropped_total",
            "Inbound packets dropped before dispatch",
            ("reason",))

    # ------------------------------------------------------------------ #
    # sending                                                            #
    # ------------------------------------------------------------------ #

    def _next_tid(self, method: int) -> bytes:
        self._tid_seq = (self._tid_seq + 1) & 0xFFFF
        if self._tid_seq == 0:
            self._tid_seq = 1
        return make_tid(METHODS[method][1], self._tid_seq)

    def _transport_for(self, addr: SockAddr) -> Optional[DatagramTransport]:
        return self.t4 if addr.family == AF_INET else self.t6

    def _send(self, data: bytes, dest: SockAddr) -> None:
        t = self._transport_for(dest)
        if t is not None:
            t.send(data, dest)

    def _count(self, direction: str, key: str) -> None:
        """Count one wire message under the canonical taxonomy (raw
        wire strings fold into "other" — counter keys must stay a
        CLOSED set, never attacker-chosen)."""
        if key not in CANONICAL_TYPES:
            key = "other"
        self._msg_ctr.inc(dir=direction, type=key)

    @property
    def stats_in(self) -> Dict[str, int]:
        """Legacy dict view of the inbound counters (canonical keys)."""
        return self._stats_dict("in")

    @property
    def stats_out(self) -> Dict[str, int]:
        """Legacy dict view of the outbound counters (canonical keys)."""
        return self._stats_dict("out")

    def _stats_dict(self, direction: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for labels, value in self._msg_ctr.series():
            d = dict(labels)
            if d.get("dir") == direction:
                out[d["type"]] = int(value)
        return out

    def _send_request(self, method: int, node: Node, msg_for_tid, on_done,
                      on_expired) -> Request:
        tid = self._next_tid(method)
        msg = msg_for_tid(tid)
        req = Request(tid, node, msg, on_done, on_expired)
        self.requests[tid] = req
        node.requested(req)
        self._count("out", METHODS[method][0])
        self._request_step(req)
        return req

    def _request_step(self, req: Request) -> None:
        """Transmit + schedule retransmit (ref: requestStep :232-262)."""
        if not req.pending():
            return
        now = self.scheduler.time()
        if req.over_attempts():
            # 3 unanswered attempts: request and node expire
            # (ref: requestStep :243-247)
            req.state = RequestState.EXPIRED
            self.requests.pop(req.tid, None)
            if req.node is not None:
                req.node.request_expired(req)
                req.node.set_expired()
            if req.on_expired:
                req.on_expired(req, True)
            return
        if req.attempt_count == 0:
            req.start = now
        req.attempt_count += 1
        req.last_try = now
        self._send(req.msg, req.node.addr)
        req._job = self.scheduler.add(now + MAX_RESPONSE_TIME,
                                      lambda: self._request_step(req))

    # -- public RPC senders (ref: network_engine.h:131-218) ---------------
    def send_ping(self, node: Node, on_done=None, on_expired=None) -> Request:
        return self._send_request(
            PING, node, lambda tid: self.builder.ping(tid), on_done, on_expired)

    def send_find_node(self, node: Node, target: InfoHash, want: int = 0,
                       on_done=None, on_expired=None) -> Request:
        return self._send_request(
            FIND_NODE, node,
            lambda tid: self.builder.find_node(tid, target, want),
            on_done, on_expired)

    def send_get_values(self, node: Node, info_hash: InfoHash,
                        query: Optional[Query], want: int = 0,
                        on_done=None, on_expired=None) -> Request:
        return self._send_request(
            GET_VALUES, node,
            lambda tid: self.builder.get_values(tid, info_hash, query, want),
            on_done, on_expired)

    def send_listen(self, node: Node, info_hash: InfoHash, token: bytes,
                    query: Optional[Query] = None,
                    socket: Optional[Socket] = None,
                    on_done=None, on_expired=None, socket_cb=None
                    ) -> Tuple[Request, Socket]:
        if socket is None:
            socket = self.open_socket(socket_cb)
        req = self._send_request(
            LISTEN, node,
            lambda tid: self.builder.listen(tid, info_hash, token, socket.id,
                                            query),
            on_done, on_expired)
        return req, socket

    def send_announce_value(self, node: Node, info_hash: InfoHash, value: Value,
                            created: Optional[float], token: bytes,
                            on_done=None, on_expired=None) -> Request:
        # Absolute creation time, only sent when in the past (the
        # reference packs to_time_t(created) iff created < now,
        # src/network_engine.cpp:1103-1106; receiver clamps to now).
        created_abs = None
        if created is not None and created < self.scheduler.time():
            created_abs = created
        packed = value.packed()
        if len(packed) < MAX_PACKET_VALUE_SIZE:
            return self._send_request(
                ANNOUNCE_VALUE, node,
                lambda tid: self.builder.announce_value(
                    tid, info_hash, value, created_abs, token),
                on_done, on_expired)
        # fragmented announce: header + parts
        blob = packb([value.pack()])

        def build_header(tid: bytes) -> bytes:
            args = {"id": bytes(self.myid), "h": bytes(info_hash),
                    "token": token, "psize": len(blob), "_q": "put"}
            if created_abs is not None:
                args["c"] = int(created_abs)
            env = {"a": args, "q": args.pop("_q"), "t": tid, "y": "q",
                   "v": "RNG1"}
            if self.network:
                env["n"] = self.network
            return packb(env)

        req = self._send_request(ANNOUNCE_VALUE, node, build_header,
                                 on_done, on_expired)
        self._send_value_parts(req.tid, blob, node.addr)
        return req

    def send_refresh_value(self, node: Node, info_hash: InfoHash, vid: int,
                           token: bytes, on_done=None, on_expired=None
                           ) -> Request:
        return self._send_request(
            REFRESH, node,
            lambda tid: self.builder.refresh_value(tid, info_hash, vid, token),
            on_done, on_expired)

    def _send_value_parts(self, tid: bytes, blob: bytes, dest: SockAddr) -> None:
        """ref: sendValueParts :855-882"""
        for off in range(0, len(blob), MTU):
            self._send(self.builder.value_part(tid, off, blob[off:off + MTU]),
                       dest)

    # -- sockets / listen push (ref: :161-205) -----------------------------
    def open_socket(self, cb) -> Socket:
        self._sock_seq = (self._sock_seq + 1) & 0xFFFF
        sid = make_tid(b"so", self._sock_seq)
        s = Socket(sid, cb)
        self.opened_sockets[sid] = s
        return s

    def close_socket(self, socket: Optional[Socket]) -> None:
        if socket is not None:
            self.opened_sockets.pop(socket.id, None)

    def tell_listener(self, node: Node, socket_id: bytes, info_hash: InfoHash,
                      values: List[Value], ntoken: bytes = b"",
                      expired: bool = False) -> None:
        """Push value updates to a remote listener via its socket id
        (ref: tellListener :161-173; expired flag per sendUpdateValues)."""
        packed = [v.pack() for v in values]
        total = sum(len(packb(p)) for p in packed)
        r: Dict[str, object] = {"id": bytes(self.myid)}
        if ntoken:
            r["token"] = ntoken
        if expired:
            r["exp"] = True
        self._count("out", "reply")  # listen pushes ride reply envelopes
        if total < MAX_PACKET_VALUE_SIZE and len(values) <= MAX_MESSAGE_VALUE_COUNT:
            r["values"] = packed
            env = {"r": r, "t": socket_id, "y": "r", "v": "RNG1"}
            if self.network:
                env["n"] = self.network
            self._send(packb(env), node.addr)
        else:
            blob = packb(packed)
            r["psize"] = len(blob)
            env = {"r": r, "t": socket_id, "y": "r", "v": "RNG1"}
            if self.network:
                env["n"] = self.network
            self._send(packb(env), node.addr)
            self._send_value_parts(socket_id, blob, node.addr)

    # -- node blacklisting (ref: :344-356) ---------------------------------
    def blacklist_node(self, node: Optional[Node]) -> None:
        if node is None:
            return
        node.set_expired()
        for tid, req in list(self.requests.items()):
            if req.node is node:
                req.cancel()
                del self.requests[tid]
        self._purge_blacklist(self.scheduler.time())
        self.blacklist[node.addr] = (self.scheduler.time()
                                     + BLACKLIST_EXPIRE_TIME)

    def _purge_blacklist(self, now: float) -> None:
        """Blacklist hygiene: drop entries whose sentence is served
        (`is_node_blacklisted` only reaps the addresses it is asked
        about — addresses never heard from again would otherwise
        accumulate forever), then enforce the size cap by evicting the
        soonest-to-expire entries (they were convicted earliest; an
        attacker cycling source addresses must not grow the map
        without bound — SURVEY §4's bounded misbehaving-peer set)."""
        for addr, until in list(self.blacklist.items()):
            if until < now:
                del self.blacklist[addr]
        excess = len(self.blacklist) - (MAX_BLACKLIST_SIZE - 1)
        if excess > 0:
            for addr, _ in sorted(self.blacklist.items(),
                                  key=lambda kv: kv[1])[:excess]:
                del self.blacklist[addr]

    def is_node_blacklisted(self, addr: SockAddr) -> bool:
        until = self.blacklist.get(addr)
        if until is None:
            return False
        if until < self.scheduler.time():
            del self.blacklist[addr]
            return False
        return True

    # ------------------------------------------------------------------ #
    # receiving                                                          #
    # ------------------------------------------------------------------ #

    def _on_packet(self, data: bytes, from_addr: SockAddr) -> None:
        self.process_message(data, from_addr)

    def _is_martian(self, addr: SockAddr) -> bool:
        """ref: :308-339 — drop unusable source addresses."""
        return addr.port == 0

    def process_message(self, data: bytes, from_addr: SockAddr) -> None:
        if self._is_martian(from_addr):
            self._drop_ctr.inc(reason="martian")
            return
        if self.is_node_blacklisted(from_addr):
            self._drop_ctr.inc(reason="blacklist")
            return
        if not data:
            return
        try:
            msg = parse_message(data)
        except Exception:
            self.log.w("can't parse message from %s", from_addr)
            self._drop_ctr.inc(reason="parse")
            return
        now = self.scheduler.time()

        if msg.network != self.network:
            self._drop_ctr.inc(reason="network_mismatch")
            return  # ref: :387-390

        if msg.type == MessageType.ValueData:
            self._count("in", "value_parts")
            pm = self.partial_messages.get(msg.tid)
            if pm is not None and pm.from_addr == from_addr:
                pm.append(msg.part_offset, msg.part_data, now)
                if pm.complete():
                    del self.partial_messages[msg.tid]
                    self._deliver_assembled(pm)
            return

        if msg.id == self.myid:
            self._drop_ctr.inc(reason="self_message")
            return  # self-message drop (ref: :421)

        is_request = msg.type not in (MessageType.Error, MessageType.Reply)
        if is_request:
            # rate limits apply to requests only (ref: :287-305)
            if not self._rate_limit_ok(from_addr, now):
                self._drop_ctr.inc(reason="rate_limit")
                return
            # One canonical key per wire method — the raw "q" string is
            # never a counter key (unknown methods fold into "other").
            self._count("in", msg.type or "other")
        else:
            self._count("in", "reply" if msg.type == MessageType.Reply
                        else "error")

        if msg.value_parts_total and not msg.values:
            # header of a fragmented message: stash and await parts
            self.partial_messages[msg.tid] = PartialMessage(msg, from_addr, now)
            self._schedule_rx_maintenance()
            return

        self._process(msg, from_addr)

    def _rate_limit_ok(self, addr: SockAddr, now: float) -> bool:
        key = addr.host
        if addr.family == AF_INET6 and ":" in key:
            # Group IPv6 by /64 (ref: network_engine.h:572-599).  The
            # textual form may be compressed ("2001:db9::5"), so take
            # the first 8 of the 16 packed bytes, not string hextets.
            try:
                key = ipaddress.ip_address(key.split("%")[0]).packed[:8]
            except ValueError:
                key = ":".join(key.split(":")[:4])
        lim = self.ip_limiters.get(key)
        if lim is None:
            lim = self.ip_limiters[key] = make_rate_limiter(
                MAX_REQUESTS_PER_SEC_PER_IP, kind="token-bucket")
        return lim.limit(now) and self.rate_limiter.limit(now)

    def _deliver_assembled(self, pm: PartialMessage) -> None:
        try:
            packed_values = unpackb(bytes(pm.buf))
            for vo in packed_values:
                try:
                    pm.msg.values.append(Value.unpack(vo))
                except Exception:
                    continue
        except Exception:
            return
        pm.msg.value_parts_total = 0
        self._process(pm.msg, pm.from_addr)

    def _schedule_rx_maintenance(self) -> None:
        if self._rx_job is None or not self._rx_job.active:
            self._rx_job = self.scheduler.add(
                self.scheduler.time() + RX_TIMEOUT, self._maintain_rx_buffer)

    def _maintain_rx_buffer(self) -> None:
        """ref: maintainRxBuffer :1433-1444"""
        self._rx_job = None
        now = self.scheduler.time()
        for tid, pm in list(self.partial_messages.items()):
            if (pm.start + RX_MAX_PACKET_TIME < now
                    or pm.last_part + RX_TIMEOUT < now):
                del self.partial_messages[tid]
        if self.partial_messages:
            self._schedule_rx_maintenance()

    # -- dispatch (ref: process :453-594) ----------------------------------
    def _process(self, msg: ParsedMessage, from_addr: SockAddr) -> None:
        now = self.scheduler.time()

        if msg.type in (MessageType.Error, MessageType.Reply):
            req = self.requests.get(msg.tid)
            if req is not None and req.node.addr.host != from_addr.host:
                # reply from unexpected origin: ignore
                return
            if req is None:
                sock = self.opened_sockets.get(msg.tid)
                if sock is not None and msg.type == MessageType.Reply:
                    # listen push on a socket
                    node = self.cache.get_node(msg.id, from_addr) if msg.id else None
                    if node:
                        node.received(now, None)
                        self.handler.on_new_node(node, 2)
                    sock.on_receive(node, msg)
                return
            if not req.pending():
                self.requests.pop(msg.tid, None)
                return

            node = req.node
            if node.id != msg.id and msg.id:
                if not node.id:
                    # Reply to a message sent before we knew the node id
                    # (bootstrap ping): swap in the canonical cached Node
                    # so one id maps to one object everywhere
                    # (ref: src/network_engine.cpp:470-473).
                    node = self.cache.get_node(msg.id, from_addr)
                    req.node = node
                else:
                    # Reply from an unexpected node id
                    # (ref: src/network_engine.cpp:474-479).
                    node.received(now, req)
                    self.handler.on_new_node(node, 2)
                    self.log.w("[node %s] reply from unexpected node",
                               node.id)
                    return

            if msg.type == MessageType.Error:
                self.requests.pop(msg.tid, None)
                node.received(now, req)
                self.handler.on_new_node(node, 2)
                req.state = RequestState.COMPLETED
                req._cancel_job()
                self.handler.on_error(req, msg.error_code)
                return

            # Reply
            self.requests.pop(msg.tid, None)
            node.received(now, req)
            node.auth_success()
            self.handler.on_new_node(node, 2)
            if msg.addr is not None:
                self.handler.on_reported_addr(msg.id, msg.addr)
            req.set_done(now)
            self._process_discovered_nodes(msg)
            if req.on_done:
                req.on_done(req, self._answer_from(msg))
            return

        # request from remote
        if not msg.id:
            self.log.w("request with no id from %s", from_addr)
            return
        node = self.cache.get_node(msg.id, from_addr)
        node.update(from_addr)
        node.received(now, None)
        self.handler.on_new_node(node, 1)

        try:
            if msg.type == MessageType.Ping:
                self.handler.on_ping(node)
                self._send(self.builder.pong(msg.tid, from_addr), from_addr)
            elif msg.type == MessageType.FindNode:
                ans = self.handler.on_find(node, msg.target, msg.want)
                self._send_nodes_values(msg.tid, from_addr, ans)
            elif msg.type == MessageType.GetValues:
                ans = self.handler.on_get_values(node, msg.info_hash, msg.want,
                                                 msg.query)
                self._send_nodes_values(msg.tid, from_addr, ans, msg.query)
            elif msg.type == MessageType.AnnounceValue:
                created = None
                if msg.created is not None:
                    # Absolute time, clamped to now (importValues-style
                    # clamp, ref src/dht.cpp:3069-3073).
                    created = min(now, msg.created)
                ans = self.handler.on_announce(node, msg.info_hash, msg.values,
                                               created, msg.token)
                self._send(self.builder.value_announced(msg.tid, from_addr,
                                                        ans.vid), from_addr)
            elif msg.type == MessageType.Refresh:
                ans = self.handler.on_refresh(node, msg.info_hash, msg.value_id,
                                              msg.token)
                self._send(self.builder.value_announced(msg.tid, from_addr,
                                                        msg.value_id), from_addr)
            elif msg.type == MessageType.Listen:
                self.handler.on_listen(node, msg.info_hash, msg.token,
                                       msg.socket_id, msg.query)
                self._send(self.builder.listen_confirm(msg.tid, from_addr),
                           from_addr)
            else:
                self.log.w("unknown query type %r", msg.type)
                return
            # Every handled request above answered with one reply.
            self._count("out", "reply")
        except DhtProtocolException as e:
            self._count("out", "error")
            self._send(self.builder.error(msg.tid, e.code, e.message,
                                          include_id=True), from_addr)

    def _process_discovered_nodes(self, msg: ParsedMessage) -> None:
        """Insert nodes learned from reply node lists (confirm=0)."""
        for nid, addr in msg.nodes4 + msg.nodes6:
            if nid == self.myid:
                continue
            n = self.cache.get_node(nid, addr)
            self.handler.on_new_node(n, 0)

    def _answer_from(self, msg: ParsedMessage) -> RequestAnswer:
        from ..core.value import Field, FieldValueIndex
        ans = RequestAnswer()
        ans.ntoken = msg.token
        ans.vid = msg.value_id
        ans.values = msg.values
        ans.fields = [FieldValueIndex.from_fields(
            [Field(f) for f in msg.fields], row) for row in msg.field_values]
        ans.nodes4 = [self.cache.get_node(nid, a) for nid, a in msg.nodes4
                      if nid != self.myid]
        ans.nodes6 = [self.cache.get_node(nid, a) for nid, a in msg.nodes6
                      if nid != self.myid]
        return ans

    def _send_nodes_values(self, tid: bytes, dest: SockAddr,
                           ans: RequestAnswer,
                           query: Optional[Query] = None) -> None:
        """ref: sendNodesValues :885-940 (fields projection + fragmentation)"""
        n4 = pack_nodes(ans.nodes4[:SEND_NODES], AF_INET)
        n6 = pack_nodes(ans.nodes6[:SEND_NODES], AF_INET6)
        fields = None
        values = None
        psize = 0
        if ans.fields and query is not None:
            flat = []
            for v in ans.values:
                flat.extend(v.pack_fields([f for f in query.select.fields]))
            fields = {"f": [int(f) for f in query.select.fields], "v": flat}
        elif ans.values:
            packed = [v.pack() for v in ans.values]
            total = sum(len(packb(p)) for p in packed)
            if total < MAX_PACKET_VALUE_SIZE and \
                    len(packed) <= MAX_MESSAGE_VALUE_COUNT:
                values = packed
            else:
                blob = packb(packed)
                psize = len(blob)
                self._send(self.builder.nodes_values(
                    tid, dest, n4, n6, None, None, ans.ntoken, psize), dest)
                self._send_value_parts(tid, blob, dest)
                return
        self._send(self.builder.nodes_values(tid, dest, n4, n6, values,
                                             fields, ans.ntoken), dest)

    # ------------------------------------------------------------------ #
    # maintenance                                                        #
    # ------------------------------------------------------------------ #

    def cancel_request(self, req: Optional[Request]) -> None:
        if req is not None:
            req.cancel()
            self.requests.pop(req.tid, None)

    def get_stats(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        return dict(self.stats_in), dict(self.stats_out)
