"""Per-hash value storage with local and remote listeners.

Re-design of the reference storage layer (ref: src/dht.cpp:110-209 structs,
2227-2380 store/expire): each tracked hash owns a list of stored values
(with creation times), the set of remote listeners (per node, per listen
socket id) to notify on change, and local listener callbacks.  Global
accounting (64 MB / 16384 hashes / 1024 values) lives in the Dht.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..core.value import Filter, Query, Value
from ..utils.clock import TIME_INVALID


class ValueStorage:
    __slots__ = ("value", "created")

    def __init__(self, value: Value, created: float):
        self.value = value
        self.created = created


class RemoteListener:
    """A remote node listening on this hash via a socket id
    (ref: Listener src/dht.cpp:152-163)."""

    __slots__ = ("socket_id", "time", "query")

    def __init__(self, socket_id: bytes, time: float, query: Query):
        self.socket_id = socket_id
        self.time = time
        self.query = query

    def refresh(self, socket_id: bytes, time: float, query: Query) -> None:
        self.socket_id = socket_id
        self.time = time
        self.query = query


class LocalListener:
    """A local callback listening on this hash
    (ref: LocalListener src/dht.cpp:165-169)."""

    __slots__ = ("query", "filter", "get_cb")

    def __init__(self, query: Optional[Query], filter: Optional[Filter],
                 get_cb: Callable):
        self.query = query
        self.filter = filter
        self.get_cb = get_cb


class Storage:
    """Values stored at one hash (ref: struct Storage src/dht.cpp:171-242)."""

    __slots__ = ("values", "listeners", "local_listeners", "listener_token",
                 "maintenance_time", "total_size")

    def __init__(self, now: float):
        self.values: List[ValueStorage] = []
        # node -> {socket_id: RemoteListener}
        self.listeners: Dict[object, Dict[bytes, RemoteListener]] = {}
        self.local_listeners: Dict[int, LocalListener] = {}
        self.listener_token = 0
        self.maintenance_time = now
        self.total_size = 0

    def is_empty(self) -> bool:
        return not self.values

    def value_count(self) -> int:
        return len(self.values)

    def get(self, f: Optional[Filter] = None) -> List[Value]:
        if f is None:
            return [vs.value for vs in self.values]
        return [vs.value for vs in self.values if f(vs.value)]

    def get_by_id(self, vid: int) -> Optional[Value]:
        for vs in self.values:
            if vs.value.id == vid:
                return vs.value
        return None

    def store(self, value: Value, created: float, size_left: int
              ) -> Tuple[Optional[ValueStorage], int, int]:
        """Insert or replace; returns (stored, size_diff, count_diff)
        (ref: Storage::store src/dht.cpp:2260-2287)."""
        from .constants import MAX_VALUES
        for vs in self.values:
            if vs.value is value or vs.value.id == value.id:
                vs.created = created
                size_diff = value.size() - vs.value.size()
                if size_diff <= size_left and vs.value is not value:
                    vs.value = value
                    self.total_size += size_diff
                    return vs, size_diff, 0
                return (vs if vs.value is value else None), 0, 0
        size = value.size()
        if size <= size_left and len(self.values) < MAX_VALUES:
            vs = ValueStorage(value, created)
            self.values.append(vs)
            self.total_size += size
            return vs, size, 1
        return None, 0, 0

    def refresh(self, now: float, vid: int) -> bool:
        """Reset a value's creation time (ref: Storage::refresh)."""
        for vs in self.values:
            if vs.value.id == vid:
                vs.created = now
                return True
        return False

    def expire(self, get_type, now: float) -> Tuple[int, int, List[Value]]:
        """Drop expired values; returns (size_diff, count_diff, expired)
        (ref: Storage::expire src/dht.cpp:2361-2381)."""
        keep, dropped = [], []
        for vs in self.values:
            t = get_type(vs.value.type)
            if vs.created + t.expiration < now:
                dropped.append(vs.value)
            else:
                keep.append(vs)
        size_diff = -sum(v.size() for v in dropped)
        self.values = keep
        self.total_size += size_diff
        return size_diff, -len(dropped), dropped

    def clear(self) -> Tuple[int, int]:
        n, sz = len(self.values), self.total_size
        self.values = []
        self.total_size = 0
        return -sz, -n
