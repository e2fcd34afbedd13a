"""Per-peer liveness state.

Re-design of the reference ``Node`` (ref: include/opendht/node.h:35-112,
src/node.cpp): tracks when a peer was last heard from / last replied,
pending requests, and auth errors.  Liveness policy (src/node.cpp:34-40):
good = replied within 120 min AND heard within 10 min; 3 unanswered request
attempts or 3 auth errors expire the node.
"""

from __future__ import annotations

import weakref
from typing import Optional

from ..utils.clock import TIME_INVALID
from ..utils.infohash import InfoHash
from ..utils.sockaddr import SockAddr
from .constants import NODE_EXPIRE_TIME, NODE_GOOD_TIME, NODE_MAX_AUTH_ERRORS


class Node:
    __slots__ = ("id", "addr", "time", "reply_time", "_expired",
                 "auth_errors", "_requests", "__weakref__")

    def __init__(self, node_id: InfoHash, addr: SockAddr):
        self.id = node_id
        self.addr = addr
        self.time = TIME_INVALID        # last time heard from (any packet)
        self.reply_time = TIME_INVALID  # last time we got a reply
        self._expired = False
        self.auth_errors = 0
        # tid -> weak Request; pending request bookkeeping (node.h:74-97)
        self._requests: dict = {}

    @property
    def family(self) -> int:
        return self.addr.family

    # -- liveness (ref: src/node.cpp:34-50) --------------------------------
    def is_expired(self) -> bool:
        return self._expired

    def is_good(self, now: float) -> bool:
        return (not self._expired
                and self.reply_time >= now - NODE_GOOD_TIME
                and self.time >= now - NODE_EXPIRE_TIME)

    def is_pending_message(self) -> bool:
        return any(r is not None and r.pending() for r in self._iter_requests())

    def is_message_pending(self) -> bool:
        return self.is_pending_message()

    # -- events ------------------------------------------------------------
    def update(self, new_addr: SockAddr) -> None:
        self.addr = new_addr

    def received(self, now: float, req=None) -> None:
        """Packet received from this node (ref: src/node.cpp:52-72)."""
        self.time = now
        self._expired = False
        if req is not None:
            self.reply_time = now
            self._requests.pop(req.tid, None)

    def requested(self, req) -> None:
        self._requests[req.tid] = weakref.ref(req)

    def request_expired(self, req) -> None:
        self._requests.pop(req.tid, None)

    def set_expired(self) -> None:
        """Mark expired and cancel pending requests (ref: src/node.cpp:99-109)."""
        self._expired = True
        for r in list(self._iter_requests()):
            if r is not None:
                r.set_expired()
        self._requests.clear()

    def reset_expired(self) -> None:
        """Clear the expired flag after a connectivity change
        (ref: NodeCache::clearBadNodes src/node_cache.cpp:68-77)."""
        self._expired = False
        self.auth_errors = 0

    def auth_error(self) -> None:
        self.auth_errors += 1
        if self.auth_errors >= NODE_MAX_AUTH_ERRORS:
            self.set_expired()

    def auth_success(self) -> None:
        self.auth_errors = 0

    def _iter_requests(self):
        for ref in list(self._requests.values()):
            yield ref()

    def get_request(self, tid: int):
        ref = self._requests.get(tid)
        return ref() if ref is not None else None

    def __repr__(self):
        return f"Node[{str(self.id)[:8]} {self.addr}]"
