"""The DHT core: searches, storage, listeners, maintenance.

Re-design of the reference ``class Dht`` (ref: src/dht.cpp, 3436 LoC;
include/opendht/dht.h:55-302).  The behavioral spec is preserved —
iterative Kademlia lookups with α=4 solicitation over a 14-node search set,
8-node sync quorum, announce-with-probe, listen refresh, write tokens,
bucket/neighbourhood maintenance, connectivity-loss detection — while the
structure is an explicit state machine over plain data, so the same spec is
shared with the lock-step device swarm engine
(:mod:`opendht_tpu_torch.models.swarm`), which vectorizes this per-search state
over millions of concurrent searches.

Key behavior pointers into the reference:

* SearchNode status logic: src/dht.cpp:244-461
* Search container + sync/done predicates: :467-713, 1466-1645
* insertNode sorted-merge with bad-node trimming: :961-1047
* searchStep: :1343-1464
* searchSendGetValues / searchSendAnnounceValue: :1170-1341
* storage + change notification + tokens: :2186-2467
* bucket maintenance / confirmNodes / expire: :2791-3030
* RPC handlers: :3180-3434
"""

from __future__ import annotations

import hashlib
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.mpack import packb, unpackb

from ..net.network_engine import (DhtProtocolException, NetworkEngine,
                                  RequestAnswer)
from ..net.request import Request
from ..net.wire import WANT4, WANT6
from ..utils.clock import TIME_INVALID, TIME_MAX
from ..utils.infohash import HASH_LEN, InfoHash
from ..utils.logger import NONE, Logger
from ..utils.metrics import MetricsRegistry
from ..utils.sockaddr import AF_INET, AF_INET6, SockAddr
from .constants import (LISTEN_EXPIRE_TIME, MAX_HASHES, MAX_SEARCHES,
                        MAX_STORAGE_MAINTENANCE_EXPIRE_TIME, MAX_STORAGE_SIZE,
                        MAX_REQUESTED_SEARCH_NODES, NODE_EXPIRE_TIME,
                        REANNOUNCE_MARGIN, SEARCH_EXPIRE_TIME,
                        SEARCH_MAX_BAD_NODES, SEARCH_NODES, TARGET_NODES)
from .node import Node
from .node_cache import NodeCache
from .routing_table import Bucket, RoutingTable
from .scheduler import Scheduler
from .storage import LocalListener, RemoteListener, Storage
from .value import (Field, FieldValueIndex, Filter, Query, Select, Value, Where,
                    ValueType, USER_DATA, f_chain_and)

LISTEN_NODES = 4  # ref: include/opendht/dht.h:330
TOKEN_SIZE = 64

# callback signatures
GetCallback = Callable[[List[Value]], bool]
QueryCallback = Callable[[List[FieldValueIndex]], bool]
DoneCallback = Callable[[bool, List[Node]], None]


def qkey(query: Optional[Query]) -> bytes:
    """Canonical dict key for a query (reference keys status maps by
    shared_ptr identity + isSatisfiedBy scans; we key by canonical bytes)."""
    if query is None:
        return b"\x00find"
    return packb(query.pack())


PROBE_QUERY = Query(Select([Field.Id, Field.SeqNum]))
PROBE_QKEY = qkey(PROBE_QUERY)


class DhtConfig:
    __slots__ = ("node_id", "network", "is_bootstrap", "maintain_storage")

    def __init__(self, node_id: Optional[InfoHash] = None, network: int = 0,
                 is_bootstrap: bool = False, maintain_storage: bool = False):
        self.node_id = node_id
        self.network = network
        self.is_bootstrap = is_bootstrap
        self.maintain_storage = maintain_storage


class NodeStatus:
    Disconnected = "disconnected"
    Connecting = "connecting"
    Connected = "connected"


class NodeStats:
    """Snapshot of one address family's node health + this node's
    search/storage load — the reference's ``NodeStats`` struct
    (returned by ``getNodesStats``, ref src/dht.cpp:2469-2495) grown
    with the search and storage counters the reference reports through
    separate log dumps.
    """

    __slots__ = ("good_nodes", "dubious_nodes", "cached_nodes",
                 "incoming_nodes", "searches", "storage_keys",
                 "storage_values", "storage_bytes")

    def __init__(self, good_nodes: int = 0, dubious_nodes: int = 0,
                 cached_nodes: int = 0, incoming_nodes: int = 0,
                 searches: int = 0, storage_keys: int = 0,
                 storage_values: int = 0, storage_bytes: int = 0):
        self.good_nodes = good_nodes
        self.dubious_nodes = dubious_nodes
        self.cached_nodes = cached_nodes
        self.incoming_nodes = incoming_nodes
        self.searches = searches
        self.storage_keys = storage_keys
        self.storage_values = storage_values
        self.storage_bytes = storage_bytes

    @property
    def total_nodes(self) -> int:
        return self.good_nodes + self.dubious_nodes

    def to_dict(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self) -> str:
        return (f"NodeStats(good={self.good_nodes}, "
                f"dubious={self.dubious_nodes}, "
                f"cached={self.cached_nodes}, "
                f"incoming={self.incoming_nodes}, "
                f"searches={self.searches}, "
                f"storage={self.storage_values} values/"
                f"{self.storage_bytes} B in {self.storage_keys} keys)")


class Get:
    __slots__ = ("start", "filter", "query", "query_cb", "get_cb", "done_cb")

    def __init__(self, start: float, f: Optional[Filter],
                 query: Optional[Query], query_cb: Optional[QueryCallback],
                 get_cb: Optional[GetCallback],
                 done_cb: Optional[DoneCallback]):
        self.start = start
        self.filter = f
        self.query = query or Query()
        self.query_cb = query_cb
        self.get_cb = get_cb
        self.done_cb = done_cb


class Announce:
    __slots__ = ("permanent", "value", "created", "callback")

    def __init__(self, permanent: bool, value: Value, created: float,
                 callback: Optional[DoneCallback]):
        self.permanent = permanent
        self.value = value
        self.created = created
        self.callback = callback


class SearchListener:
    __slots__ = ("query", "filter", "get_cb")

    def __init__(self, query: Optional[Query], f: Optional[Filter],
                 get_cb: GetCallback):
        self.query = query
        self.filter = f
        self.get_cb = get_cb


class _ListenEntry:
    __slots__ = ("query", "req", "socket")

    def __init__(self, query, req, socket):
        self.query = query
        self.req = req
        self.socket = socket


class SearchNode:
    """Per-node state inside a search (ref: src/dht.cpp:244-461)."""

    __slots__ = ("node", "token", "last_get_reply", "candidate",
                 "get_status", "listen_status", "acked", "probe_query",
                 "pagination_queries")

    def __init__(self, node: Node):
        self.node = node
        self.token = b""
        self.last_get_reply = TIME_INVALID
        self.candidate = False
        # qkey -> (query, Request)
        self.get_status: Dict[bytes, Tuple[Optional[Query], Request]] = {}
        # qkey -> _ListenEntry
        self.listen_status: Dict[bytes, _ListenEntry] = {}
        # vid -> (Request | None, refresh_time)
        self.acked: Dict[int, Tuple[Optional[Request], float]] = {}
        self.probe_query: Optional[Query] = None
        # qkey(original get query) -> [qkey of pagination sub-queries]
        # (ref: SearchNode::pagination_queries src/dht.cpp:258)
        self.pagination_queries: Dict[bytes, List[bytes]] = {}

    def has_started_pagination(self, qk: bytes) -> bool:
        """ref: SearchNode::hasStartedPagination src/dht.cpp:333-342."""
        pqs = self.pagination_queries.get(qk)
        if not pqs:
            return False
        return any(sq in self.get_status for sq in pqs)

    def is_synced(self, now: float) -> bool:
        return (not self.node.is_expired() and bool(self.token)
                and self.last_get_reply >= now - NODE_EXPIRE_TIME)

    def is_bad(self) -> bool:
        return self.node is None or self.node.is_expired() or self.candidate

    def pending_get(self) -> bool:
        return any(r.pending() for _, r in self.get_status.values())

    def can_get(self, now: float, update: float,
                query: Optional[Query] = None) -> bool:
        """ref: SearchNode::canGet src/dht.cpp:302-331

        ``query=None`` stands for the reference's find-node sentinel query
        (Query with none=true, satisfied by/satisfying everything)."""
        if self.node.is_expired():
            return False
        pending = False
        pending_sq = completed_sq = False
        for _, (q, r) in self.get_status.items():
            if r.pending():
                pending = True
            satisfied = (query is None or q is None
                         or query.is_satisfied_by(q))
            if satisfied:
                if r.pending():
                    pending_sq = True
                if r.completed() and not (update > r.reply_time):
                    completed_sq = True
        return ((not pending
                 and now > self.last_get_reply + NODE_EXPIRE_TIME)
                or not (self.has_started_pagination(qkey(query))
                        or completed_sq or pending_sq))

    def is_done(self, get: Get) -> bool:
        """ref: SearchNode::isDone src/dht.cpp:356-369 — a paginated
        get is done when none of its sub-requests are pending."""
        qk = qkey(get.query)
        if self.has_started_pagination(qk):
            return not any(
                self.get_status[sq][1].pending()
                for sq in self.pagination_queries.get(qk, ())
                if sq in self.get_status)
        entry = self.get_status.get(qk)
        return entry is not None and not entry[1].pending()

    def is_announced(self, vid: int, now: float) -> bool:
        ack = self.acked.get(vid)
        return ack is not None and ack[0] is not None and ack[1] > now

    def is_listening(self, now: float) -> bool:
        return any(e.req is not None
                   and e.req.reply_time + LISTEN_EXPIRE_TIME > now
                   for e in self.listen_status.values())

    def get_announce_time(self, vid: int) -> float:
        """ref: SearchNode::getAnnounceTime src/dht.cpp:431-441"""
        ack = self.acked.get(vid)
        probe = (self.get_status.get(qkey(self.probe_query))
                 if self.probe_query is not None else None)
        probe_pending = probe is not None and probe[1].pending()
        if (ack is None or ack[0] is None) and not probe_pending:
            return TIME_INVALID
        if probe_pending or ack is None or ack[0] is None or ack[0].pending():
            return TIME_MAX
        return ack[1] - REANNOUNCE_MARGIN

    def get_listen_time(self, query: Optional[Query]) -> float:
        """ref: SearchNode::getListenTime src/dht.cpp:447-453"""
        e = self.listen_status.get(qkey(query))
        if e is None or e.req is None:
            return TIME_INVALID
        if e.req.pending():
            return TIME_MAX
        return e.req.reply_time + LISTEN_EXPIRE_TIME - REANNOUNCE_MARGIN


class Search:
    """One iterative lookup + its pending operations
    (ref: Dht::Search src/dht.cpp:467-713)."""

    __slots__ = ("id", "af", "tid", "refill_time", "step_time", "step_job",
                 "expired", "done", "nodes", "announce", "callbacks",
                 "listeners", "listener_token")

    def __init__(self, target: InfoHash, af: int, tid: int):
        self.id = target
        self.af = af
        self.tid = tid
        self.refill_time = TIME_INVALID
        self.step_time = TIME_INVALID
        self.step_job = None
        self.expired = False
        self.done = False
        self.nodes: List[SearchNode] = []
        self.announce: List[Announce] = []
        self.callbacks: List[Get] = []
        self.listeners: Dict[int, SearchListener] = {}
        self.listener_token = 0

    # -- membership --------------------------------------------------------
    def get_node(self, node: Node) -> Optional[SearchNode]:
        for sn in self.nodes:
            if sn.node is node:
                return sn
        return None

    def insert_node(self, node: Node, now: float, token: bytes = b"") -> bool:
        """Sorted insert with bad-node-aware trimming
        (ref: Search::insertNode src/dht.cpp:961-1047)."""
        if node.family != self.af:
            return False
        target = self.id
        found = None
        pos = len(self.nodes)
        for i in range(len(self.nodes) - 1, -1, -1):
            sn = self.nodes[i]
            # Same object, or same id (the cache normally guarantees one
            # object per id; equal-id match is defense in depth — two
            # SearchNodes for one id would each count toward the sync
            # quorum while only one can ever reply).
            if sn.node is node or sn.node.id == node.id:
                found = sn
                break
            if InfoHash.xor_cmp(node.id, sn.node.id, target) > 0:
                pos = i + 1
                break
            pos = i

        new_node = False
        if found is None:
            bad = self.bad_node_count()
            if self.expired:
                full = len(self.nodes) >= SEARCH_NODES
                if full:
                    del self.nodes[SEARCH_NODES:]
            else:
                full = len(self.nodes) - bad >= SEARCH_NODES
                if full:
                    # trim so non-bad count stays at SEARCH_NODES
                    t = len(self.nodes)
                    b = bad
                    while t - b > SEARCH_NODES and t > 0:
                        t -= 1
                        if self.nodes[t].is_bad():
                            b -= 1
                    del self.nodes[t:]
            if full and pos >= len(self.nodes):
                return False
            if not self.nodes:
                self.step_time = TIME_INVALID
            found = SearchNode(node)
            self.nodes.insert(min(pos, len(self.nodes)), found)
            node.time = max(node.time, now)
            new_node = True
            if not node.is_expired() and self.expired:
                self.expired = False

        if token:
            found.candidate = False
            found.last_get_reply = now
            if len(token) <= TOKEN_SIZE:
                found.token = token
            self.expired = False
        if new_node:
            self.remove_expired_node(now)
        return new_node

    def remove_expired_node(self, now: float) -> bool:
        for i in range(len(self.nodes) - 1, -1, -1):
            n = self.nodes[i].node
            if n.is_expired() and n.time + NODE_EXPIRE_TIME < now:
                del self.nodes[i]
                return True
        return False

    # -- predicates --------------------------------------------------------
    def bad_node_count(self) -> int:
        return sum(1 for sn in self.nodes if sn.is_bad())

    def consecutive_bad_nodes(self) -> int:
        count = 0
        for sn in self.nodes:
            if not sn.is_bad():
                break
            count += 1
        return count

    def solicited_node_count(self) -> int:
        return sum(1 for sn in self.nodes
                   if not sn.is_bad() and sn.pending_get())

    def is_synced(self, now: float) -> bool:
        """First TARGET_NODES live nodes all synced
        (ref: Search::isSynced src/dht.cpp:1466-1479)."""
        i = 0
        for sn in self.nodes:
            if sn.is_bad():
                continue
            if not sn.is_synced(now):
                return False
            i += 1
            if i == TARGET_NODES:
                break
        return i > 0

    def get_last_get_time(self, query: Optional[Query] = None) -> float:
        last = TIME_INVALID
        for g in self.callbacks:
            if query is None or query.is_satisfied_by(g.query):
                last = max(last, g.start)
        return last

    def is_done(self, get: Get) -> bool:
        i = 0
        for sn in self.nodes:
            if sn.is_bad():
                continue
            if not sn.is_done(get):
                return False
            i += 1
            if i == TARGET_NODES:
                break
        return True

    def is_announced(self, vid: int, now: float) -> bool:
        if not self.nodes:
            return False
        i = 0
        for sn in self.nodes:
            if sn.is_bad():
                continue
            if not sn.is_announced(vid, now):
                return False
            i += 1
            if i == TARGET_NODES:
                break
        return i > 0

    def is_listening(self, now: float) -> bool:
        if not self.nodes or not self.listeners:
            return False
        i = 0
        for sn in self.nodes:
            if sn.is_bad():
                continue
            if not sn.is_listening(now):
                return False
            i += 1
            if i == LISTEN_NODES:
                break
        return i > 0

    # -- event times -------------------------------------------------------
    def get_update_time(self, now: float) -> float:
        """Next time a 'get' step is needed
        (ref: Search::getUpdateTime src/dht.cpp:1505-1533)."""
        ut = TIME_MAX
        last_get = self.get_last_get_time()
        i = t = d = 0
        solicited = self.solicited_node_count()
        for sn in self.nodes:
            if sn.node.is_expired() or (sn.candidate and t >= TARGET_NODES):
                continue
            pending = sn.pending_get()
            if sn.last_get_reply < max(now - NODE_EXPIRE_TIME, last_get) \
                    or pending:
                if not pending and solicited < MAX_REQUESTED_SEARCH_NODES:
                    ut = min(ut, now)
                if not sn.candidate:
                    d += 1
            else:
                ut = min(ut, sn.last_get_reply + NODE_EXPIRE_TIME)
            t += 1
            if not sn.candidate:
                i += 1
                if i == TARGET_NODES:
                    break
        if self.callbacks and d == 0:
            return now
        return ut

    def get_announce_time(self, now: float) -> float:
        if not self.nodes or not self.announce:
            return TIME_MAX
        ret = TIME_MAX
        for a in self.announce:
            if a.value is None:
                continue
            i = t = 0
            for sn in self.nodes:
                if not sn.is_synced(now) or (sn.candidate and t >= TARGET_NODES):
                    continue
                ret = min(ret, sn.get_announce_time(a.value.id))
                t += 1
                if not sn.candidate:
                    i += 1
                    if i == TARGET_NODES:
                        break
        return ret

    def get_listen_time(self, now: float) -> float:
        if not self.listeners:
            return TIME_MAX
        lt = TIME_MAX
        i = t = 0
        for sn in self.nodes:
            if not sn.is_synced(now) or (sn.candidate and t >= LISTEN_NODES):
                continue
            for l in self.listeners.values():
                lt = min(lt, sn.get_listen_time(l.query))
            t += 1
            if not sn.candidate:
                i += 1
                if i == LISTEN_NODES:
                    break
        return lt

    def get_next_step_time(self, now: float) -> float:
        if self.expired or self.done:
            return TIME_MAX
        nxt = self.get_update_time(now)
        if self.is_synced(now):
            nxt = min(nxt, self.get_announce_time(now))
            nxt = min(nxt, self.get_listen_time(now))
        return nxt

    # -- completion / teardown --------------------------------------------
    def get_nodes(self) -> List[Node]:
        return [sn.node for sn in self.nodes]

    def set_get_done(self, get: Get) -> None:
        k = qkey(get.query)
        for sn in self.nodes:
            sn.get_status.pop(k, None)
        if get.done_cb:
            get.done_cb(True, self.get_nodes())

    def set_done(self) -> None:
        for sn in self.nodes:
            sn.get_status.clear()
            sn.listen_status.clear()
            sn.acked.clear()
        self.done = True

    def check_announced(self, now: float, vid: Optional[int] = None) -> None:
        """ref: Search::checkAnnounced src/dht.cpp:687-702"""
        keep = []
        for a in self.announce:
            if vid is not None and (a.value is None or a.value.id != vid):
                keep.append(a)
                continue
            if self.is_announced(a.value.id, now):
                if a.callback:
                    a.callback(True, self.get_nodes())
                    a.callback = None
                if a.permanent:
                    keep.append(a)
            else:
                keep.append(a)
        self.announce = keep

    def expire_search(self) -> None:
        """ref: Search::expire src/dht.cpp:645-680"""
        self.expired = True
        self.nodes = []
        if not self.announce and not self.listeners:
            self.set_done()
        gets, self.callbacks = self.callbacks, []
        for g in gets:
            if g.done_cb:
                g.done_cb(False, [])
        keep = []
        cbs = []
        for a in self.announce:
            if a.callback:
                cbs.append(a.callback)
                a.callback = None
            if a.permanent:
                keep.append(a)
        self.announce = keep
        for cb in cbs:
            cb(False, [])


class Dht:
    """The DHT node core.  Single-threaded; driven by a scheduler.

    Acts as the handler object for :class:`NetworkEngine` (the nine-callback
    seam, ref src/dht.cpp:2746-2755).
    """

    def __init__(self, transport4=None, transport6=None,
                 config: Optional[DhtConfig] = None,
                 scheduler: Optional[Scheduler] = None,
                 logger: Logger = NONE,
                 rng: Optional[random.Random] = None):
        config = config or DhtConfig()
        self.myid = config.node_id or InfoHash.get_random()
        self.config = config
        self.log = logger
        self.rng = rng or random.Random()
        self.scheduler = scheduler or Scheduler()

        self.cache = NodeCache()
        # One registry shared with the engine: wire counters and core
        # gauges expose through a single /metrics surface.
        self.metrics = MetricsRegistry()
        self.engine = NetworkEngine(self.myid, config.network, transport4,
                                    transport6, self.scheduler, self,
                                    self.cache, logger, self.rng,
                                    metrics=self.metrics)
        self.running4 = transport4 is not None
        self.running6 = transport6 is not None

        self.buckets4 = RoutingTable(AF_INET)
        self.buckets6 = RoutingTable(AF_INET6)
        self.searches4: Dict[InfoHash, Search] = {}
        self.searches6: Dict[InfoHash, Search] = {}
        self.store: Dict[InfoHash, Storage] = {}
        self.total_store_size = 0
        self.total_values = 0
        self.max_store_size = MAX_STORAGE_SIZE

        self.types: Dict[int, ValueType] = {}
        for t in _default_types():
            self.register_type(t)

        self._search_id = 1
        self._listener_token = 0
        # api token -> (local_token, token4, token6, hash)
        self.listeners: Dict[int, Tuple[int, int, int, InfoHash]] = {}

        self.mybucket_grow_time = TIME_INVALID
        self.mybucket6_grow_time = TIME_INVALID
        self.reported_addr: List[List] = []   # [count, SockAddr]

        self.secret = os.urandom(16)
        self.oldsecret = self.secret
        self._rotate_secrets()

        now = self.scheduler.time()
        self._confirm_job = self.scheduler.add(
            now + self.rng.uniform(3, 5), self._confirm_nodes)
        self.scheduler.add(now + self.rng.uniform(120, 360), self._expire)

        self.on_status_changed: Optional[Callable] = None
        self._last_status = (self.get_status(AF_INET),
                             self.get_status(AF_INET6))

    # ------------------------------------------------------------------ #
    # basic accessors                                                    #
    # ------------------------------------------------------------------ #

    def buckets(self, af: int) -> RoutingTable:
        return self.buckets4 if af == AF_INET else self.buckets6

    def searches(self, af: int) -> Dict[InfoHash, Search]:
        return self.searches4 if af == AF_INET else self.searches6

    def is_running(self, af: int) -> bool:
        return self.running4 if af == AF_INET else self.running6

    def register_type(self, t: ValueType) -> None:
        self.types[t.id] = t

    def get_type(self, type_id: int) -> ValueType:
        t = self.types.get(type_id)
        if t is not None:
            return t
        return ValueType(type_id, "Unknown", USER_DATA.expiration)

    def get_status(self, af: int) -> str:
        good, dubious, _, incoming = self.get_nodes_stats(af)
        if good:
            return NodeStatus.Connected
        if dubious or self._has_pending_searches(af):
            return NodeStatus.Connecting
        return NodeStatus.Disconnected

    def _has_pending_searches(self, af: int) -> bool:
        return any(not s.done and not s.expired
                   for s in self.searches(af).values())

    def get_nodes_stats(self, af: int) -> Tuple[int, int, int, int]:
        """(good, dubious, cached, incoming) (ref: src/dht.cpp:2469-2495)."""
        now = self.scheduler.time()
        good = dubious = cached = incoming = 0
        for b in self.buckets(af):
            for n in b.nodes:
                if n.is_good(now):
                    good += 1
                    if n.time > n.reply_time:
                        incoming += 1
                elif not n.is_expired():
                    dubious += 1
            if b.cached is not None:
                cached += 1
        return good, dubious, cached, incoming

    def node_stats(self, af: int = AF_INET) -> NodeStats:
        """Full :class:`NodeStats` snapshot for one address family —
        the reference ``getNodesStats`` struct plus this node's search
        and storage load (storage totals are node-global: the store is
        not per-af)."""
        good, dubious, cached, incoming = self.get_nodes_stats(af)
        return NodeStats(
            good_nodes=good, dubious_nodes=dubious, cached_nodes=cached,
            incoming_nodes=incoming, searches=len(self.searches(af)),
            storage_keys=len(self.store),
            storage_values=self.total_values,
            storage_bytes=self.total_store_size)

    def update_metrics(self) -> None:
        """Refresh the registry's gauges from live core state.  Called
        by periodic maintenance (:meth:`_confirm_nodes`/:meth:`_expire`)
        and by exposition surfaces at scrape time — the gauges are
        derived state, so recomputing is always safe.

        Scrape-time calls arrive from gateway HTTP threads while the
        DHT loop thread mutates core state (same diagnostics-read
        contract as ``DhtRunner.get_nodes_stats``): the dict iterations
        below work on ``list()`` snapshots, and the gateway converts
        the residual snapshot race (a dict resized mid-copy raises
        RuntimeError) into a 503 — gauges then refresh on the next
        scrape or maintenance tick instead of crashing the handler."""
        nodes_g = self.metrics.gauge(
            "dht_nodes", "Routing-table nodes by state", ("af", "state"))
        searches_g = self.metrics.gauge(
            "dht_searches", "Live searches", ("af",))
        for af, name in ((AF_INET, "ipv4"), (AF_INET6, "ipv6")):
            good, dubious, cached, incoming = self.get_nodes_stats(af)
            nodes_g.set(good, af=name, state="good")
            nodes_g.set(dubious, af=name, state="dubious")
            nodes_g.set(cached, af=name, state="cached")
            nodes_g.set(incoming, af=name, state="incoming")
            searches_g.set(len(self.searches(af)), af=name)
        self.metrics.gauge(
            "dht_storage_keys", "Distinct stored info-hashes"
        ).set(len(self.store))
        self.metrics.gauge(
            "dht_storage_values", "Stored values"
        ).set(self.total_values)
        self.metrics.gauge(
            "dht_storage_bytes", "Stored value bytes"
        ).set(self.total_store_size)
        listeners = sum(
            sum(len(socks) for socks in list(st.listeners.values()))
            + len(st.local_listeners) for st in list(self.store.values()))
        self.metrics.gauge(
            "dht_storage_listeners", "Registered storage listeners"
        ).set(listeners)

    # ------------------------------------------------------------------ #
    # tokens (ref: src/dht.cpp:2404-2467)                                #
    # ------------------------------------------------------------------ #

    def _make_token(self, addr: SockAddr, old: bool) -> bytes:
        secret = self.oldsecret if old else self.secret
        try:
            ip = addr.pack_ip()
        except ValueError:
            ip = addr.host.encode()
        return hashlib.sha512(secret + ip).digest()[:TOKEN_SIZE]

    def _token_match(self, token: bytes, addr: SockAddr) -> bool:
        if len(token) != TOKEN_SIZE:
            return False
        from ..native import token_eq
        return (token_eq(token, self._make_token(addr, False))
                or token_eq(token, self._make_token(addr, True)))

    def _rotate_secrets(self) -> None:
        self.oldsecret = self.secret
        self.secret = os.urandom(16)
        self.scheduler.add(
            self.scheduler.time() + self.rng.uniform(15 * 60, 45 * 60),
            self._rotate_secrets)

    # ------------------------------------------------------------------ #
    # engine handler callbacks (the nine-callback seam)                  #
    # ------------------------------------------------------------------ #

    def on_error(self, req: Request, code: int) -> None:
        """ref: Dht::onError src/dht.cpp:3152-3176"""
        if code == DhtProtocolException.UNAUTHORIZED:
            node = req.node
            node.auth_error()
            self.engine.cancel_request(req)
            for sr in self.searches(node.family).values():
                for sn in sr.nodes:
                    if sn.node is node:
                        sn.token = b""
                        sn.last_get_reply = TIME_INVALID
                        self._search_send_get_values(sr)
                        break
        elif code == DhtProtocolException.NOT_FOUND:
            self.engine.cancel_request(req)

    def on_reported_addr(self, nid: InfoHash, addr: SockAddr) -> None:
        b = self.buckets(addr.family).find_bucket(nid)
        b.time = self.scheduler.time()
        # The ``sa`` echo carries no port (insertAddr packs the bare
        # ip); the reference records it anyway (onReportedAddr checks
        # socklen, not port — src/dht.cpp:3174-3180).
        if addr.host:
            for entry in self.reported_addr:
                if entry[1] == addr:
                    entry[0] += 1
                    return
            if len(self.reported_addr) < 32:
                self.reported_addr.append([1, addr])

    def get_public_address(self, af: int = 0) -> List[SockAddr]:
        """ref: Dht::getPublicAddress src/dht.cpp:803-814"""
        out = sorted(self.reported_addr, key=lambda e: -e[0])
        return [a for c, a in out if af == 0 or a.family == af]

    def on_new_node(self, node: Node, confirm: int) -> None:
        """Bucket insertion policy (ref: Dht::onNewNode src/dht.cpp:864-936)."""
        table = self.buckets(node.family)
        idx = table.find_bucket_index(node.id)
        b = table.buckets[idx]

        if any(n is node for n in b.nodes):
            if confirm:
                self._try_search_insert(node)
            return

        self._try_search_insert(node)

        now = self.scheduler.time()
        mybucket = idx == table.find_bucket_index(self.myid)
        if mybucket:
            if node.family == AF_INET:
                self.mybucket_grow_time = now
            else:
                self.mybucket6_grow_time = now

        # replace an expired node
        for i, n in enumerate(b.nodes):
            if n.is_expired():
                b.nodes[i] = node
                return

        if len(b.nodes) >= TARGET_NODES:
            dubious = False
            for n in b.nodes:
                if not n.is_good(now):
                    dubious = True
                    if not n.is_pending_message():
                        self.engine.send_ping(n)
                        break
            if (mybucket or (self.config.is_bootstrap
                             and table.depth(idx) < 6)) \
                    and (not dubious or len(table.buckets) == 1):
                self._send_cached_ping(b)
                table.split(idx)
                self.on_new_node(node, 0)
                return
            if confirm or b.cached is None:
                b.cached = node
        else:
            b.nodes.insert(0, node)

    def _send_cached_ping(self, b: Bucket) -> None:
        if b.cached is not None:
            self.engine.send_ping(b.cached)
            b.cached = None

    def _try_search_insert(self, node: Node) -> bool:
        """ref: Dht::trySearchInsert src/dht.cpp:818-849"""
        now = self.scheduler.time()
        inserted = False
        for sr in self.searches(node.family).values():
            if sr.insert_node(node, now):
                inserted = True
                self._schedule_step(sr, sr.get_next_step_time(now))
        return inserted

    # -- RPC request handlers (ref: src/dht.cpp:3183-3421) -----------------
    def on_ping(self, node: Node) -> RequestAnswer:
        return RequestAnswer()

    def on_find(self, node: Node, target: Optional[InfoHash],
                want: int) -> RequestAnswer:
        now = self.scheduler.time()
        ans = RequestAnswer()
        ans.ntoken = self._make_token(node.addr, False)
        if target is None:
            return ans
        if want <= 0:
            want = WANT4 if node.family == AF_INET else WANT6
        if want & WANT4:
            ans.nodes4 = self.buckets4.find_closest_nodes(target, now,
                                                          TARGET_NODES)
        if want & WANT6:
            ans.nodes6 = self.buckets6.find_closest_nodes(target, now,
                                                          TARGET_NODES)
        return ans

    def on_get_values(self, node: Node, info_hash: Optional[InfoHash],
                      want: int, query: Optional[Query]) -> RequestAnswer:
        if not info_hash:
            raise DhtProtocolException(203, "Get_values with no info_hash")
        now = self.scheduler.time()
        ans = RequestAnswer()
        ans.ntoken = self._make_token(node.addr, False)
        ans.nodes4 = self.buckets4.find_closest_nodes(info_hash, now,
                                                      TARGET_NODES)
        ans.nodes6 = self.buckets6.find_closest_nodes(info_hash, now,
                                                      TARGET_NODES)
        st = self.store.get(info_hash)
        if st is not None and not st.is_empty():
            f = query.where.get_filter() if query else None
            ans.values = st.get(f)
            if query is not None and query.select:
                # project to selected fields only
                ans.fields = [FieldValueIndex(v, query.select)
                              for v in ans.values]
        return ans

    def on_listen(self, node: Node, info_hash: Optional[InfoHash],
                  token: bytes, socket_id: bytes,
                  query: Optional[Query]) -> RequestAnswer:
        if not info_hash:
            raise DhtProtocolException(203, "Listen with no info_hash")
        if not self._token_match(token, node.addr):
            raise DhtProtocolException(DhtProtocolException.UNAUTHORIZED,
                                       "Listen with wrong token")
        self._storage_add_listener(info_hash, node, socket_id,
                                   query or Query())
        return RequestAnswer()

    def on_announce(self, node: Node, info_hash: Optional[InfoHash],
                    values: List[Value], created: Optional[float],
                    token: bytes) -> RequestAnswer:
        if not info_hash:
            raise DhtProtocolException(203, "Put with no info_hash")
        if not self._token_match(token, node.addr):
            raise DhtProtocolException(DhtProtocolException.UNAUTHORIZED,
                                       "Put with wrong token")
        now = self.scheduler.time()
        # proximity check (ref: :3351-3358)
        closest = self.buckets(node.family).find_closest_nodes(
            info_hash, now, SEARCH_NODES)
        if len(closest) >= TARGET_NODES and \
                InfoHash.xor_cmp(closest[-1].id, self.myid, info_hash) < 0:
            return RequestAnswer()

        created = min(created if created is not None else now, now)
        ans = RequestAnswer()
        for v in values:
            if v.id == 0:
                raise DhtProtocolException(203, "Put with invalid value id")
            lv = self.get_local_by_id(info_hash, v.id)
            if lv is not None:
                if not (lv == v):
                    t = self.get_type(lv.type)
                    if t.edit_policy(info_hash, lv, v, node.id, node.addr):
                        self._storage_store(info_hash, v, created)
            else:
                t = self.get_type(v.type)
                if t.store_policy(info_hash, v, node.id, node.addr):
                    self._storage_store(info_hash, v, created)
            ans.vid = v.id
        return ans

    def on_refresh(self, node: Node, info_hash: Optional[InfoHash],
                   vid: int, token: bytes) -> RequestAnswer:
        if not self._token_match(token, node.addr):
            raise DhtProtocolException(DhtProtocolException.UNAUTHORIZED,
                                       "Refresh with wrong token")
        now = self.scheduler.time()
        st = self.store.get(info_hash)
        if st is None or not st.refresh(now, vid):
            raise DhtProtocolException(DhtProtocolException.NOT_FOUND,
                                       "Storage not found")
        ans = RequestAnswer()
        ans.vid = vid
        return ans

    # ------------------------------------------------------------------ #
    # storage internals                                                  #
    # ------------------------------------------------------------------ #

    def _storage_store(self, info_hash: InfoHash, value: Value,
                       created: float) -> bool:
        """ref: Dht::storageStore src/dht.cpp:2227-2258"""
        now = self.scheduler.time()
        if created + self.get_type(value.type).expiration < now:
            return False
        st = self.store.get(info_hash)
        if st is None:
            if len(self.store) >= MAX_HASHES:
                return False
            st = self.store[info_hash] = Storage(now)
            if self.config.maintain_storage:
                st.maintenance_time = now + MAX_STORAGE_MAINTENANCE_EXPIRE_TIME
                self.scheduler.add(st.maintenance_time,
                                   lambda: self._data_persistence(info_hash))
        stored, size_diff, count_diff = st.store(
            value, created, self.max_store_size - self.total_store_size)
        if stored is not None:
            self.total_store_size += size_diff
            self.total_values += count_diff
            self._storage_changed(info_hash, st, stored.value)
        return stored is not None

    def _storage_changed(self, info_hash: InfoHash, st: Storage,
                         value: Value) -> None:
        """Notify local + remote listeners (ref: src/dht.cpp:2186-2225)."""
        for l in list(st.local_listeners.values()):
            if l.filter is None or l.filter(value):
                l.get_cb([value])
        for node, sockets in list(st.listeners.items()):
            for lst in list(sockets.values()):
                f = lst.query.where.get_filter() if lst.query else None
                if f is not None and not f(value):
                    continue
                ntoken = self._make_token(node.addr, False)
                self.engine.tell_listener(node, lst.socket_id, info_hash,
                                          [value], ntoken)

    def _storage_add_listener(self, info_hash: InfoHash, node: Node,
                              socket_id: bytes, query: Query) -> None:
        """ref: Dht::storageAddListener src/dht.cpp:2299-2322"""
        now = self.scheduler.time()
        st = self.store.get(info_hash)
        if st is None:
            if len(self.store) >= MAX_HASHES:
                return
            st = self.store[info_hash] = Storage(now)
        sockets = st.listeners.setdefault(node, {})
        entry = sockets.get(socket_id)
        if entry is None:
            vals = st.get(query.where.get_filter() if query else None)
            if vals:
                self.engine.tell_listener(
                    node, socket_id, info_hash, vals,
                    self._make_token(node.addr, False))
            sockets[socket_id] = RemoteListener(socket_id, now, query)
        else:
            entry.refresh(socket_id, now, query)

    def get_local(self, info_hash: InfoHash,
                  f: Optional[Filter] = None) -> List[Value]:
        st = self.store.get(info_hash)
        return st.get(f) if st is not None else []

    def get_local_by_id(self, info_hash: InfoHash, vid: int
                        ) -> Optional[Value]:
        st = self.store.get(info_hash)
        return st.get_by_id(vid) if st is not None else None

    # ------------------------------------------------------------------ #
    # searches                                                           #
    # ------------------------------------------------------------------ #

    def search(self, target: InfoHash, af: int,
               get_cb: Optional[GetCallback] = None,
               query_cb: Optional[QueryCallback] = None,
               done_cb: Optional[DoneCallback] = None,
               f: Optional[Filter] = None,
               query: Optional[Query] = None) -> Optional[Search]:
        """Create or reuse a search (ref: Dht::search src/dht.cpp:1672-1735)."""
        if not self.is_running(af):
            if done_cb:
                done_cb(False, [])
            return None
        srs = self.searches(af)
        sr = srs.get(target)
        if sr is not None:
            sr.done = False
            sr.expired = False
        else:
            if len(self.searches4) + len(self.searches6) >= MAX_SEARCHES:
                # reuse a finished search slot (LRU-ish)
                victim = None
                for key, s in srs.items():
                    if (s.done or s.expired) and not s.announce \
                            and not s.listeners:
                        victim = key
                        break
                if victim is None:
                    if done_cb:
                        done_cb(False, [])
                    return None
                old = srs.pop(victim)
                if old.step_job:
                    old.step_job.cancel()
            sr = Search(target, af, self._search_id)
            self._search_id += 1
            srs[target] = sr

        if get_cb or query_cb:
            sr.callbacks.append(Get(self.scheduler.time(), f, query,
                                    query_cb, get_cb, done_cb))
        self._refill(sr)
        now = self.scheduler.time()
        if sr.step_job is not None and sr.step_job.active:
            self._schedule_step(sr, sr.get_next_step_time(now))
        else:
            self._schedule_step(sr, now)
        return sr

    def _schedule_step(self, sr: Search, t: float) -> None:
        """(Re)schedule a search's step job.  Unlike the reference's
        Scheduler::edit (which re-schedules the stored closure,
        scheduler.h:63-80), our jobs are one-shot — so re-create the job
        when the handle is spent (e.g. while the step is executing)."""
        if t >= TIME_MAX:
            return
        if sr.step_job is not None and sr.step_job.active:
            sr.step_job = self.scheduler.edit(sr.step_job, t)
        else:
            sr.step_job = self.scheduler.add(
                t, lambda: self._search_step(sr))

    def _refill(self, sr: Search) -> int:
        """ref: Dht::refill src/dht.cpp:1647-1668"""
        now = self.scheduler.time()
        cached = self.cache.get_cached_nodes(sr.id, sr.af, SEARCH_NODES)
        inserted = 0
        for n in cached:
            if sr.insert_node(n, now):
                inserted += 1
        sr.refill_time = now
        return inserted

    def _search_step(self, sr: Search) -> None:
        """The search driver (ref: Dht::searchStep src/dht.cpp:1343-1464)."""
        if sr is None or sr.expired or sr.done:
            return
        now = self.scheduler.time()
        sr.step_time = now

        if sr.refill_time + NODE_EXPIRE_TIME < now and \
                len(sr.nodes) - sr.bad_node_count() < SEARCH_NODES:
            self._refill(sr)

        if sr.is_synced(now):
            # complete finished gets
            for g in list(sr.callbacks):
                if sr.is_done(g):
                    sr.set_get_done(g)
                    sr.callbacks.remove(g)
            sr.check_announced(now)
            if not sr.callbacks and not sr.announce and not sr.listeners:
                sr.set_done()

            # listen dispatch
            if sr.listeners:
                i = 0
                for sn in sr.nodes:
                    if not sn.is_synced(now):
                        continue
                    for l in sr.listeners.values():
                        if sn.get_listen_time(l.query) <= now:
                            self._send_listen(sr, sn, l.query)
                    if not sn.candidate:
                        i += 1
                        if i == LISTEN_NODES:
                            break

            # announce dispatch
            self._search_send_announce_value(sr)

            if not sr.callbacks and not sr.announce and not sr.listeners:
                sr.set_done()

        # keep alpha get/find requests in flight (bounded: candidates may
        # be solicited without counting toward alpha, ref :1438-1449)
        sends = 0
        while sr.solicited_node_count() < MAX_REQUESTED_SEARCH_NODES \
                and sends < 2 * SEARCH_NODES:
            if self._search_send_get_values(sr) is None:
                break
            sends += 1

        # connectivity-loss detection (ref: :1451-1457)
        if sr.consecutive_bad_nodes() >= min(len(sr.nodes),
                                             SEARCH_MAX_BAD_NODES):
            sr.expire_search()
            self._connectivity_changed(sr.af)

        if not sr.done:
            self._schedule_step(sr, sr.get_next_step_time(now))

    def _search_send_get_values(self, sr: Search,
                                pn: Optional[SearchNode] = None,
                                update: bool = True) -> Optional[SearchNode]:
        """ref: Dht::searchSendGetValues src/dht.cpp:1170-1235"""
        if sr.done or sr.solicited_node_count() >= MAX_REQUESTED_SEARCH_NODES:
            return None
        now = self.scheduler.time()

        gets = sr.callbacks or [None]
        for g in gets:
            query = g.query if g is not None else None
            up = sr.get_last_get_time(query) if (g is not None and update) \
                else TIME_INVALID
            n = None
            if pn is not None and pn.can_get(now, up, query):
                n = pn
            else:
                for sn in sr.nodes:
                    if sn.can_get(now, up, query):
                        n = sn
                        break
            if g is None:
                if n is None:
                    return None
                k = qkey(None)
                n.get_status[k] = (None, self.engine.send_find_node(
                    n.node, sr.id, self._want(),
                    on_done=lambda req, ans, q=None: self._search_node_get_done(
                        req, ans, sr, q),
                    on_expired=lambda req, over, q=None:
                        self._search_node_get_expired(req, over, sr, q)))
                return n
            else:
                if n is None:
                    continue
                # A get without an explicit selection is paginated:
                # SELECT id first, then one sub-get per value id
                # (ref: Dht::paginate src/dht.cpp:1117-1168, dispatch
                # :1216-1227).
                if query is None or not query.select.fields:
                    self._paginate(sr, query, n)
                    return n
                k = qkey(query)
                n.get_status[k] = (query, self.engine.send_get_values(
                    n.node, sr.id, query if (query and query) else None,
                    self._want(),
                    on_done=lambda req, ans, q=query:
                        self._search_node_get_done(req, ans, sr, q),
                    on_expired=lambda req, over, q=query:
                        self._search_node_get_expired(req, over, sr, q)))
                return n
        return None

    def _want(self) -> int:
        w = 0
        if self.running4:
            w |= WANT4
        if self.running6:
            w |= WANT6
        return w

    def _paginate(self, sr: Search, query: Optional[Query],
                  sn: SearchNode) -> None:
        """Split a select-less get per value id: a ``SELECT id`` probe,
        then one ``GET WHERE id=<vid>`` per discovered id — so huge
        storages stream incrementally (ref: Dht::paginate
        src/dht.cpp:1117-1168)."""
        select_q = Query(Select().field(Field.Id),
                         query.where if query is not None else None)
        qk = qkey(query)

        def on_select_done(req: Request, answer: RequestAnswer) -> None:
            ssr = sr
            nn = ssr.get_node(req.node)
            if nn is None:
                return
            if not answer.fields:
                # Node answered without field projection: fall back to
                # treating this as the whole get's answer.
                self._search_node_get_done(req, answer, ssr, query)
                return
            for fvi in answer.fields:
                vid = fvi.index.get(Field.Id)
                if not vid:
                    continue
                q_vid = Query(Select(), Where().id(int(vid)))
                kq = qkey(q_vid)
                nn.pagination_queries.setdefault(qk, []).append(kq)
                nn.get_status[kq] = (q_vid, self.engine.send_get_values(
                    req.node, ssr.id, q_vid, 0,
                    on_done=lambda r, a, q=query:
                        self._search_node_get_done(r, a, ssr, q),
                    on_expired=lambda r, over, q=q_vid:
                        self._search_node_get_expired(r, over, ssr, q)))

        sn.pagination_queries.setdefault(qk, []).append(qkey(select_q))
        sn.get_status[qkey(select_q)] = (select_q, self.engine.send_get_values(
            sn.node, sr.id, select_q, 0,
            on_done=on_select_done,
            on_expired=lambda r, over, q=select_q:
                self._search_node_get_expired(r, over, sr, q)))

    def _search_node_get_done(self, req: Request, answer: RequestAnswer,
                              sr: Search, query: Optional[Query]) -> None:
        """ref: Dht::searchNodeGetDone src/dht.cpp:1076-1099"""
        now = self.scheduler.time()
        sn = sr.get_node(req.node)
        if sn is not None and query is not None:
            # satisfy other pending gets covered by this answer
            for g in sr.callbacks:
                if g.query is not query and g.query.is_satisfied_by(query):
                    dummy = Request(b"", req.node, b"")
                    dummy.set_done(now)
                    sn.get_status[qkey(g.query)] = (g.query, dummy)
        sr.insert_node(req.node, now, answer.ntoken)
        self._on_get_values_done(req.node, answer, sr, query)

    def _search_node_get_expired(self, req: Request, over: bool, sr: Search,
                                 query: Optional[Query]) -> None:
        """ref: Dht::searchNodeGetExpired src/dht.cpp:1102-1115"""
        if over:
            sn = sr.get_node(req.node)
            if sn is not None:
                sn.get_status.pop(qkey(query), None)
        self._schedule_step(sr, self.scheduler.time())

    def _on_get_values_done(self, node: Node, a: RequestAnswer, sr: Search,
                            orig_query: Optional[Query]) -> None:
        """ref: Dht::onGetValuesDone src/dht.cpp:3227-3297"""
        if sr is None:
            return
        if a.ntoken:
            if a.values or a.fields:
                for g in sr.callbacks:
                    if not (g.get_cb or g.query_cb):
                        continue
                    if orig_query is not None and g.query and \
                            not g.query.is_satisfied_by(orig_query):
                        continue
                    if g.query_cb:
                        if a.fields:
                            g.query_cb(a.fields)
                        elif a.values:
                            g.query_cb([FieldValueIndex(
                                v, orig_query.select if orig_query else None)
                                for v in a.values])
                    elif g.get_cb:
                        vals = [v for v in a.values
                                if g.filter is None or g.filter(v)]
                        if vals:
                            g.get_cb(vals)
                for l in list(sr.listeners.values()):
                    if not l.get_cb:
                        continue
                    if orig_query is not None and l.query and \
                            not l.query.is_satisfied_by(orig_query):
                        continue
                    vals = [v for v in a.values
                            if l.filter is None or l.filter(v)]
                    if vals:
                        l.get_cb(vals)
        else:
            self.engine.blacklist_node(node)

        if not sr.done:
            self._search_send_get_values(sr)
            self._schedule_step(sr, self.scheduler.time())

    def _send_listen(self, sr: Search, sn: SearchNode,
                     query: Optional[Query]) -> None:
        """ref: listen dispatch in searchStep src/dht.cpp:1397-1429"""
        k = qkey(query)
        prev = sn.listen_status.get(k)
        prev_socket = prev.socket if prev is not None else None

        def on_done(req, answer):
            if not sr.done:
                self._search_send_get_values(sr)
                self._schedule_step(sr, self.scheduler.time())

        def on_expired(req, over):
            self._schedule_step(sr, self.scheduler.time())
            if over:
                s = sr.get_node(req.node)
                if s is not None:
                    s.listen_status.pop(k, None)

        def on_values(node, msg):
            ans = self.engine._answer_from(msg)
            if msg.values or msg.fields:
                self._on_get_values_done(node, ans, sr, query)
                self._schedule_step(sr, self.scheduler.time())

        req, socket = self.engine.send_listen(
            sn.node, sr.id, sn.token, query, prev_socket,
            on_done=on_done, on_expired=on_expired, socket_cb=on_values)
        sn.listen_status[k] = _ListenEntry(query, req, socket)

    def _search_send_announce_value(self, sr: Search) -> None:
        """Announce with probe (ref: Dht::searchSendAnnounceValue
        src/dht.cpp:1237-1341): per synced node, first a SELECT id,seq
        probe, then put / refresh / ack-skip depending on what it holds."""
        if not sr.announce:
            return
        now = self.scheduler.time()
        i = 0
        for sn in sr.nodes:
            if not any(sn.is_synced(now)
                       and sn.get_announce_time(a.value.id) <= now
                       for a in sr.announce):
                continue
            sn.probe_query = PROBE_QUERY
            sn.get_status[PROBE_QKEY] = (PROBE_QUERY, self.engine.send_get_values(
                sn.node, sr.id, PROBE_QUERY, self._want(),
                on_done=lambda req, ans: self._on_probe_done(req, ans, sr),
                on_expired=lambda req, over:
                    self._search_node_get_expired(req, over, sr, PROBE_QUERY)))
            if not sn.candidate:
                i += 1
                if i == TARGET_NODES:
                    break

    def _on_probe_done(self, req: Request, answer: RequestAnswer,
                       sr: Search) -> None:
        now = self.scheduler.time()
        sn = sr.get_node(req.node)
        if sn is None:
            return
        sr.insert_node(req.node, now, answer.ntoken)

        def on_done(r, ans):
            self._on_announce_done(r.node, ans, sr)
            self._search_step(sr)

        def on_expired(r, over):
            if over:
                self._schedule_step(sr, self.scheduler.time())

        for a in sr.announce:
            if not (sn.is_synced(now)
                    and sn.get_announce_time(a.value.id) <= now):
                self._schedule_step(sr, sr.get_next_step_time(now))
                continue
            has_value = False
            seq_no = 0
            for fvi in answer.fields:
                if fvi.index.get(Field.Id) == a.value.id:
                    has_value = True
                    seq_no = int(fvi.index.get(Field.SeqNum, 0) or 0)
                    break
            next_refresh = now + self.get_type(a.value.type).expiration
            if not has_value or seq_no < a.value.seq:
                r = self.engine.send_announce_value(
                    sn.node, sr.id, a.value,
                    None if a.permanent else a.created, sn.token,
                    on_done=on_done, on_expired=on_expired)
                sn.acked[a.value.id] = (r, next_refresh)
            elif has_value and a.permanent:
                r = self.engine.send_refresh_value(
                    sn.node, sr.id, a.value.id, sn.token,
                    on_done=on_done, on_expired=on_expired)
                sn.acked[a.value.id] = (r, next_refresh)
            else:
                ack = Request(b"", sn.node, b"")
                ack.set_done(now)
                sn.acked[a.value.id] = (ack, next_refresh)
                self._schedule_step(sr, next_refresh)

    def _on_announce_done(self, node: Node, answer: RequestAnswer,
                          sr: Search) -> None:
        now = self.scheduler.time()
        self._search_send_get_values(sr)
        sr.check_announced(now, answer.vid or None)

    def _connectivity_changed(self, af: int) -> None:
        """ref: Dht::connectivityChanged src/dht.cpp:2383-2402"""
        now = self.scheduler.time()
        if self._confirm_job is not None and self._confirm_job.active:
            self._confirm_job = self.scheduler.edit(self._confirm_job, now)
        else:
            self._confirm_job = self.scheduler.add(now, self._confirm_nodes)
        if af == AF_INET:
            self.mybucket_grow_time = now
        else:
            self.mybucket6_grow_time = now
        for b in self.buckets(af):
            b.time = TIME_INVALID
        self.cache.clear_bad_nodes(af)
        for sr in self.searches(af).values():
            for sn in sr.nodes:
                for e in sn.listen_status.values():
                    self.engine.cancel_request(e.req)
                    self.engine.close_socket(e.socket)
                sn.listen_status.clear()
        self.reported_addr = [e for e in self.reported_addr
                              if e[1].family != af]

    # ------------------------------------------------------------------ #
    # public API                                                         #
    # ------------------------------------------------------------------ #

    def put(self, info_hash: InfoHash, value: Value,
            done_cb: Optional[DoneCallback] = None,
            created: Optional[float] = None, permanent: bool = False) -> None:
        """Dual-stack announce (ref: Dht::put src/dht.cpp:1931-1967)."""
        if value.id == 0:
            value.id = Value.random_id(self.rng)
        now = self.scheduler.time()
        created = min(created if created is not None else now, now)
        state = {"done": False, "ok": False, "done4": False, "done6": False}

        def donecb(nodes):
            if done_cb and not state["done"] and state["done4"] \
                    and state["done6"]:
                state["done"] = True
                done_cb(state["ok"], nodes)

        def done4(ok, nodes):
            state["done4"] = True
            state["ok"] |= ok
            donecb(nodes)

        def done6(ok, nodes):
            state["done6"] = True
            state["ok"] |= ok
            donecb(nodes)

        self._announce(info_hash, AF_INET, value, done4, created, permanent)
        self._announce(info_hash, AF_INET6, value, done6, created, permanent)

    def _announce(self, info_hash: InfoHash, af: int, value: Value,
                  callback: Optional[DoneCallback], created: float,
                  permanent: bool) -> None:
        """ref: Dht::announce src/dht.cpp:1738-1796"""
        now = self.scheduler.time()
        if not self.is_running(af):
            if callback:
                callback(False, [])
            return
        self._storage_store(info_hash, value, created)
        sr = self.searches(af).get(info_hash) or self.search(info_hash, af)
        if sr is None:
            if callback:
                callback(False, [])
            return
        sr.done = False
        sr.expired = False
        existing = next((a for a in sr.announce
                         if a.value.id == value.id), None)
        if existing is None:
            sr.announce.append(Announce(permanent, value, created, callback))
            for sn in sr.nodes:
                sn.probe_query = None
                if value.id in sn.acked:
                    sn.acked[value.id] = (None, sn.acked[value.id][1])
        else:
            if existing.value is not value:
                existing.value = value
                for sn in sr.nodes:
                    if value.id in sn.acked:
                        sn.acked[value.id] = (None, sn.acked[value.id][1])
                    sn.probe_query = None
            if sr.is_announced(value.id, now):
                if existing.callback:
                    existing.callback(True, [])
                    existing.callback = None
                if callback:
                    callback(True, [])
                return
            else:
                if existing.callback:
                    existing.callback(False, [])
                existing.callback = callback
        self._schedule_step(sr, now)

    def get(self, info_hash: InfoHash, get_cb: Optional[GetCallback],
            done_cb: Optional[DoneCallback] = None,
            f: Optional[Filter] = None,
            where: Optional["Where"] = None) -> None:
        """Dual-stack iterative get (ref: Dht::get src/dht.cpp:2013-2052)."""
        from .value import Where as _Where
        q = Query(None, where if where is not None else _Where())
        op = {"done": False, "ok": False, "done4": False, "done6": False,
              "ok4": False, "ok6": False, "values": [], "nodes": []}
        ff = f_chain_and(f, q.where.get_filter())

        def add_values(values):
            newvals = []
            for v in values:
                if any(sv is v or sv == v for sv in op["values"]):
                    continue
                if ff is None or ff(v):
                    newvals.append(v)
            return newvals

        def gcb(values):
            if op["done"]:
                return False
            newvals = add_values(values)
            if newvals:
                if get_cb:
                    op["ok"] = not get_cb(newvals)
                op["values"].extend(newvals)
            done_wrapper([])
            return not op["ok"]

        def done_wrapper(nodes):
            if op["done"]:
                return
            op["nodes"].extend(nodes)
            if op["ok"] or (op["done4"] and op["done6"]):
                # ok = cancelled-satisfied OR either search completed —
                # NOT "values found": a completed search over a missing
                # key reports success with no values
                # (ref: doneCallbackWrapper src/dht.cpp:1983-1993).
                ok = op["ok"] or op["ok4"] or op["ok6"]
                op["done"] = True
                if done_cb:
                    done_cb(ok, op["nodes"])

        def done4(ok, nodes):
            op["done4"] = True
            op["ok4"] = ok
            done_wrapper(nodes)

        def done6(ok, nodes):
            op["done6"] = True
            op["ok6"] = ok
            done_wrapper(nodes)

        # answer locally first
        local = self.get_local(info_hash, ff)
        if local:
            gcb(local)

        self.search(info_hash, AF_INET, gcb, None, done4, ff, q)
        self.search(info_hash, AF_INET6, gcb, None, done6, ff, q)

    def query(self, info_hash: InfoHash, query_cb: QueryCallback,
              done_cb: Optional[DoneCallback] = None,
              q: Optional[Query] = None) -> None:
        """Remote-filtered field query (ref: Dht::query src/dht.cpp:2055-2103)."""
        q = q or Query()
        op = {"done": False, "ok": False, "done4": False, "done6": False,
              "ok4": False, "ok6": False, "values": [], "nodes": []}
        f = q.where.get_filter()

        def add_fields(fields):
            newvals = []
            for fv in fields:
                if any(fv is sf or fv.contained_in(sf) for sf in op["values"]):
                    continue
                op["values"] = [sf for sf in op["values"]
                                if not sf.contained_in(fv)]
                newvals.append(fv)
            return newvals

        def qcb(fields):
            if op["done"]:
                return False
            newvals = add_fields(fields)
            if newvals:
                op["ok"] = not query_cb(newvals)
                op["values"].extend(newvals)
            done_wrapper([])
            return not op["ok"]

        def done_wrapper(nodes):
            if op["done"]:
                return
            op["nodes"].extend(nodes)
            if op["ok"] or (op["done4"] and op["done6"]):
                # ok = cancelled-satisfied OR either search completed —
                # NOT "values found": a completed search over a missing
                # key reports success with no values
                # (ref: doneCallbackWrapper src/dht.cpp:1983-1993).
                ok = op["ok"] or op["ok4"] or op["ok6"]
                op["done"] = True
                if done_cb:
                    done_cb(ok, op["nodes"])

        def done4(ok, nodes):
            op["done4"] = True
            op["ok4"] = ok
            done_wrapper(nodes)

        def done6(ok, nodes):
            op["done6"] = True
            op["ok6"] = ok
            done_wrapper(nodes)

        local = self.get_local(info_hash, f)
        if local:
            qcb([FieldValueIndex(v, q.select) for v in local])

        self.search(info_hash, AF_INET, None, qcb, done4, f, q)
        self.search(info_hash, AF_INET6, None, qcb, done6, f, q)

    def listen(self, info_hash: InfoHash, cb: GetCallback,
               f: Optional[Filter] = None,
               where: Optional["Where"] = None) -> int:
        """Subscribe to value updates (ref: Dht::listen src/dht.cpp:1825-1874)."""
        from .value import Where as _Where
        q = Query(None, where if where is not None else _Where())
        query = q
        ff = f_chain_and(f, q.where.get_filter())
        self._listener_token += 1
        token = self._listener_token
        vals: Dict[int, Value] = {}

        def gcb(values):
            newvals = [v for v in values
                       if v.id not in vals or not (vals[v.id] == v)]
            if newvals:
                if not cb(newvals):
                    self.cancel_listen(info_hash, token)
                    return False
                for v in newvals:
                    vals[v.id] = v
            return True

        token_local = 0
        st = self.store.get(info_hash)
        if st is None and len(self.store) < MAX_HASHES:
            st = self.store[info_hash] = Storage(self.scheduler.time())
        if st is not None:
            existing = st.get(ff)
            if existing and not gcb(existing):
                return 0
            st.listener_token += 1
            token_local = st.listener_token
            st.local_listeners[token_local] = LocalListener(query, ff, gcb)

        token4 = self._listen_to(info_hash, AF_INET, gcb, ff, query)
        token6 = self._listen_to(info_hash, AF_INET6, gcb, ff, query)
        self.listeners[token] = (token_local, token4, token6, info_hash)
        return token

    def _listen_to(self, info_hash: InfoHash, af: int, cb: GetCallback,
                   f: Optional[Filter], query: Query) -> int:
        """ref: Dht::listenTo src/dht.cpp:1799-1822"""
        if not self.is_running(af):
            return 0
        sr = self.searches(af).get(info_hash) or self.search(info_hash, af)
        if sr is None:
            return 0
        sr.done = False
        sr.listener_token += 1
        t = sr.listener_token
        sr.listeners[t] = SearchListener(query, f, cb)
        self._schedule_step(sr, sr.get_next_step_time(self.scheduler.time()))
        return t

    def cancel_listen(self, info_hash: InfoHash, token: int) -> bool:
        """ref: Dht::cancelListen src/dht.cpp:1877-1927"""
        entry = self.listeners.pop(token, None)
        if entry is None:
            return False
        token_local, token4, token6, _ = entry
        st = self.store.get(info_hash)
        if st is not None and token_local:
            st.local_listeners.pop(token_local, None)
        for af, af_token in ((AF_INET, token4), (AF_INET6, token6)):
            if not af_token:
                continue
            sr = self.searches(af).get(info_hash)
            if sr is None:
                continue
            ll = sr.listeners.pop(af_token, None)
            for sn in sr.nodes:
                if not sr.listeners:
                    for e in sn.listen_status.values():
                        self.engine.cancel_request(e.req)
                        self.engine.close_socket(e.socket)
                    sn.listen_status.clear()
                elif ll is not None:
                    e = sn.listen_status.pop(qkey(ll.query), None)
                    if e is not None:
                        self.engine.cancel_request(e.req)
                        self.engine.close_socket(e.socket)
        return True

    def cancel_put(self, info_hash: InfoHash, vid: int) -> bool:
        """ref: Dht::cancelPut src/dht.cpp:2158-2180"""
        cancelled = False
        for srs in (self.searches4, self.searches6):
            sr = srs.get(info_hash)
            if sr is None:
                continue
            before = len(sr.announce)
            sr.announce = [a for a in sr.announce if a.value.id != vid]
            cancelled |= len(sr.announce) < before
        return cancelled

    def get_put(self, info_hash: InfoHash,
                vid: Optional[int] = None):
        out = []
        for srs in (self.searches4, self.searches6):
            sr = srs.get(info_hash)
            if sr is None:
                continue
            for a in sr.announce:
                if vid is None:
                    out.append(a.value)
                elif a.value.id == vid:
                    return a.value
        return out if vid is None else None

    def insert_node(self, nid: InfoHash, addr: SockAddr) -> None:
        """Direct node insertion without ping (bootstrap import)
        (ref: Dht::insertNode src/dht.cpp:3124-3131)."""
        if addr.family not in (AF_INET, AF_INET6):
            return
        node = self.cache.get_node(nid, addr)
        node.time = max(node.time, self.scheduler.time())
        self.on_new_node(node, 0)

    def ping_node(self, addr: SockAddr,
                  done_cb: Optional[Callable[[bool], None]] = None) -> None:
        """ref: Dht::pingNode src/dht.cpp:3134-3149"""
        node = Node(InfoHash.zero(), addr)

        def on_done(req, ans):
            if done_cb:
                done_cb(True)

        def on_expired(req, over):
            if over and done_cb:
                done_cb(False)

        self.engine.send_ping(node, on_done=on_done, on_expired=on_expired)

    # ------------------------------------------------------------------ #
    # maintenance jobs                                                   #
    # ------------------------------------------------------------------ #

    def periodic(self, data: Optional[bytes],
                 from_addr: Optional[SockAddr]) -> float:
        """Process one packet + run due jobs; returns next wakeup
        (ref: Dht::periodic src/dht.cpp:2970-2976)."""
        self.scheduler.sync_time()
        if data:
            self.engine.process_message(data, from_addr)
        return self.scheduler.run()

    def _confirm_nodes(self) -> None:
        """ref: Dht::confirmNodes src/dht.cpp:2991-3027"""
        now = self.scheduler.time()
        soon = False
        if self.running4 and not self.searches4 and \
                self.get_status(AF_INET) == NodeStatus.Connected:
            self.search(self.myid, AF_INET)
        if self.running6 and not self.searches6 and \
                self.get_status(AF_INET6) == NodeStatus.Connected:
            self.search(self.myid, AF_INET6)

        soon |= self._bucket_maintenance(self.buckets4)
        soon |= self._bucket_maintenance(self.buckets6)
        if not soon:
            if self.mybucket_grow_time >= now - 150:
                soon |= self._neighbourhood_maintenance(self.buckets4)
            if self.mybucket6_grow_time >= now - 150:
                soon |= self._neighbourhood_maintenance(self.buckets6)

        delay = self.rng.uniform(5, 25) if soon else self.rng.uniform(60, 180)
        self._confirm_job = self.scheduler.add(now + delay,
                                               self._confirm_nodes)
        self.metrics.counter(
            "dht_maintenance_total", "Periodic maintenance runs",
            ("op",)).inc(op="confirm_nodes")
        self.update_metrics()
        self._check_status_change()

    def _check_status_change(self) -> None:
        st = (self.get_status(AF_INET), self.get_status(AF_INET6))
        if st != self._last_status:
            self._last_status = st
            if self.on_status_changed:
                self.on_status_changed(*st)

    def _neighbourhood_maintenance(self, table: RoutingTable) -> bool:
        """Find nodes near own id (ref: src/dht.cpp:2791-2822)."""
        idx = table.find_bucket_index(self.myid)
        target = InfoHash(bytes(self.myid)[:-1]
                          + bytes([self.rng.getrandbits(8)]))
        q = idx
        if idx + 1 < len(table.buckets) and (
                not table.buckets[q].nodes or self.rng.random() < 1 / 8):
            q = idx + 1
        if idx > 0 and (not table.buckets[q].nodes
                        or self.rng.random() < 1 / 8):
            if table.buckets[idx - 1].nodes:
                q = idx - 1
        n = table.buckets[q].random_node(self.rng)
        if n is not None:
            self.engine.send_find_node(n, target, self._want())
            return True
        return False

    def _bucket_maintenance(self, table: RoutingTable) -> bool:
        """Random find in stale buckets (ref: src/dht.cpp:2824-2885)."""
        now = self.scheduler.time()
        for idx, b in enumerate(table.buckets):
            if b.time < now - 600 or not b.nodes:
                target = table.random_id(idx, self.rng)
                q = idx
                if idx + 1 < len(table.buckets) and (
                        not table.buckets[q].nodes
                        or self.rng.random() < 1 / 8):
                    q = idx + 1
                if idx > 0 and (not table.buckets[q].nodes
                                or self.rng.random() < 1 / 8):
                    if table.buckets[idx - 1].nodes:
                        q = idx - 1
                n = table.buckets[q].random_node(self.rng)
                if n is not None:
                    want = self._want() if self.rng.random() < 1 / 38 else 0
                    self.engine.send_find_node(n, target, want)
                    return True
        return False

    def _expire(self) -> None:
        """ref: Dht::expire src/dht.cpp:2978-2989"""
        now = self.scheduler.time()
        for table in (self.buckets4, self.buckets6):
            for b in table:
                before = len(b.nodes)
                b.nodes = [n for n in b.nodes if not n.is_expired()]
                if len(b.nodes) != before:
                    self._send_cached_ping(b)
        self._expire_storage()
        self._expire_searches()
        self.scheduler.add(now + self.rng.uniform(120, 360), self._expire)
        self.metrics.counter(
            "dht_maintenance_total", "Periodic maintenance runs",
            ("op",)).inc(op="expire")
        self.update_metrics()
        self._check_status_change()

    def _expire_storage(self) -> None:
        now = self.scheduler.time()
        for h in list(self.store.keys()):
            st = self.store[h]
            for node in list(st.listeners.keys()):
                socks = st.listeners[node]
                for sid in list(socks.keys()):
                    if socks[sid].time + NODE_EXPIRE_TIME < now:
                        del socks[sid]
                if not socks:
                    del st.listeners[node]
            size_diff, count_diff, _ = st.expire(self.get_type, now)
            self.total_store_size += size_diff
            self.total_values += count_diff
            if st.is_empty() and not st.listeners and not st.local_listeners:
                del self.store[h]

    def _expire_searches(self) -> None:
        t = self.scheduler.time() - SEARCH_EXPIRE_TIME
        for srs in (self.searches4, self.searches6):
            for key in list(srs.keys()):
                sr = srs[key]
                if not sr.callbacks and not sr.announce and \
                        not sr.listeners and sr.step_time < t:
                    if sr.step_job:
                        sr.step_job.cancel()
                    del srs[key]

    def _data_persistence(self, info_hash: InfoHash) -> None:
        """Republish when no longer among the 8 closest
        (ref: Dht::dataPersistence/maintainStorage src/dht.cpp:2887-2947)."""
        now = self.scheduler.time()
        st = self.store.get(info_hash)
        if st is None or now < st.maintenance_time:
            return
        self._maintain_storage(info_hash, st)
        st.maintenance_time = now + MAX_STORAGE_MAINTENANCE_EXPIRE_TIME
        self.scheduler.add(st.maintenance_time,
                           lambda: self._data_persistence(info_hash))

    def _maintain_storage(self, info_hash: InfoHash, st: Storage,
                          force: bool = False) -> int:
        now = self.scheduler.time()
        announced = 0
        want4 = want6 = True
        for af, table in ((AF_INET, self.buckets4), (AF_INET6, self.buckets6)):
            nodes = table.find_closest_nodes(info_hash, now, TARGET_NODES)
            if nodes and (force or InfoHash.xor_cmp(
                    nodes[-1].id, self.myid, info_hash) < 0):
                for vs in st.values:
                    vt = self.get_type(vs.value.type)
                    if force or vs.created + vt.expiration > \
                            now + MAX_STORAGE_MAINTENANCE_EXPIRE_TIME:
                        self._announce(info_hash, af, vs.value, None,
                                       vs.created, False)
                        announced += 1
                if af == AF_INET:
                    want4 = False
                else:
                    want6 = False
        if not want4 and not want6:
            size_diff, count_diff = st.clear()
            self.total_store_size += size_diff
            self.total_values += count_diff
        return announced

    # ------------------------------------------------------------------ #
    # log dumps (ref: dumpBucket/dumpSearch/getStorageLog                #
    # src/dht.cpp:2497-2730)                                             #
    # ------------------------------------------------------------------ #

    def get_routing_table_log(self, af: int) -> str:
        now = self.scheduler.time()
        out = []
        for b in self.buckets(af).buckets:
            line = f"Bucket {b.first.hex()[:8]}.. "
            if b.cached is not None:
                line += "(cached) "
            out.append(line)
            for n in b.nodes:
                age = now - n.time if n.time > TIME_INVALID else -1
                state = ("good" if n.is_good(now)
                         else "expired" if n.is_expired() else "dubious")
                out.append(f"    Node {n.id} {n.addr.host}:{n.addr.port}"
                           f" [{state}] heard {age:.0f}s ago")
        return "\n".join(out)

    def get_searches_log(self, af: int = 0) -> str:
        now = self.scheduler.time()
        out = []
        for a, srs in ((AF_INET, self.searches4), (AF_INET6,
                                                   self.searches6)):
            if af and a != af:
                continue
            for sr in srs.values():
                out.append(
                    f"Search IPv{a} {sr.id} "
                    f"{'done' if sr.done else 'expired' if sr.expired else 'active'}"
                    f" synced={sr.is_synced(now)}"
                    f" gets={len(sr.callbacks)}"
                    f" announces={len(sr.announce)}"
                    f" listeners={len(sr.listeners)}")
                for sn in sr.nodes:
                    flags = ""
                    flags += "s" if sn.is_synced(now) else "-"
                    flags += "b" if sn.is_bad() else "-"
                    flags += "c" if sn.candidate else "-"
                    out.append(f"    {sn.node.id} [{flags}]")
        return "\n".join(out)

    def get_storage_log(self) -> str:
        now = self.scheduler.time()
        out = [f"Storage: {len(self.store)} keys, "
               f"{self.total_store_size} bytes, "
               f"{self.total_values} values"]
        for h, st in self.store.items():
            listeners = sum(len(m) for m in st.listeners.values())
            out.append(f"  {h}: {len(st.values)} values, "
                       f"{st.total_size} B, {listeners} remote / "
                       f"{len(st.local_listeners)} local listeners")
            for vs in st.values:
                t = self.get_type(vs.value.type)
                exp = vs.created + t.expiration - now
                out.append(f"      id {vs.value.id:016x} type {t.name} "
                           f"{vs.value.size()} B, expires in {exp:.0f}s")
        return "\n".join(out)

    # ------------------------------------------------------------------ #
    # import / export (checkpoint-resume, ref: src/dht.cpp:3029-3121)    #
    # ------------------------------------------------------------------ #

    def export_nodes(self) -> List[Tuple[InfoHash, SockAddr]]:
        now = self.scheduler.time()
        out = []
        for table in (self.buckets4, self.buckets6):
            own = table.find_bucket_index(self.myid)
            order = [own] + [i for i in range(len(table.buckets)) if i != own]
            for i in order:
                for n in table.buckets[i].nodes:
                    if n.is_good(now):
                        out.append((n.id, n.addr))
        return out

    def export_values(self) -> List[Tuple[bytes, bytes]]:
        now = self.scheduler.time()
        out = []
        for h, st in self.store.items():
            vals = [{"v": vs.value.pack(), "a": max(0.0, now - vs.created)}
                    for vs in st.values]
            out.append((bytes(h), packb(vals)))
        return out

    def import_values(self, data: List[Tuple[bytes, bytes]]) -> None:
        now = self.scheduler.time()
        for hbytes, blob in data:
            h = InfoHash(bytes(hbytes))
            for entry in unpackb(blob):
                try:
                    v = Value.unpack(entry["v"])
                except Exception:
                    continue
                created = now - float(entry.get("a", 0.0))
                self._storage_store(h, v, created)

    def shutdown(self, done_cb: Optional[Callable[[], None]] = None) -> None:
        """Hand off storage then stop (ref: Dht::shutdown src/dht.cpp:736-761)."""
        remaining = [0]

        def on_done(ok, nodes):
            remaining[0] -= 1
            if remaining[0] <= 0 and done_cb:
                done_cb()

        count = 0
        for h, st in list(self.store.items()):
            count += self._maintain_storage(h, st, force=True)
        if count == 0 and done_cb:
            done_cb()
        remaining[0] = count


def _default_types():
    from .default_types import DEFAULT_TYPES
    return DEFAULT_TYPES
