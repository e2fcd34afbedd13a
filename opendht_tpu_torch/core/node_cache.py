"""Global node identity cache.

Re-design of the reference ``NodeCache`` (ref: include/opendht/node_cache.h:
29-51, src/node_cache.cpp): one weakly-referenced ``Node`` object per
(id, address family), deduplicating node identity across routing-table
buckets and searches so liveness state is shared.  ``get_cached_nodes`` is
an XOR-closest walk outward from the target id over the sorted key space
(src/node_cache.cpp:36-66); ``clear_bad_nodes`` resets expiry flags on a
connectivity change (src/node_cache.cpp:68-77).
"""

from __future__ import annotations

import bisect
import weakref
from typing import List, Optional

from ..utils.infohash import InfoHash
from ..utils.sockaddr import AF_INET, AF_INET6, SockAddr
from .node import Node


class _FamilyCache:
    def __init__(self):
        self._map: "weakref.WeakValueDictionary[bytes, Node]" = \
            weakref.WeakValueDictionary()
        self._keys: List[bytes] = []   # sorted id bytes (lazily pruned)

    def get(self, nid: InfoHash) -> Optional[Node]:
        return self._map.get(bytes(nid))

    def get_node(self, nid: InfoHash, addr: SockAddr) -> Node:
        key = bytes(nid)
        n = self._map.get(key)
        if n is None:
            n = Node(nid, addr)
            self._map[key] = n
            i = bisect.bisect_left(self._keys, key)
            if i >= len(self._keys) or self._keys[i] != key:
                self._keys.insert(i, key)
        return n

    def closest(self, nid: InfoHash, count: int) -> List[Node]:
        self._keys = [k for k in self._keys if k in self._map]
        if not self._keys:
            return []
        start = bisect.bisect_left(self._keys, bytes(nid))
        lo, hi = start - 1, start
        out: List[Node] = []
        while len(out) < count and (lo >= 0 or hi < len(self._keys)):
            n_hi = self._map.get(self._keys[hi]) if hi < len(self._keys) else None
            n_lo = self._map.get(self._keys[lo]) if lo >= 0 else None
            if n_hi is not None and (
                    n_lo is None
                    or InfoHash.xor_cmp(n_hi.id, n_lo.id, nid) <= 0):
                pick, hi = n_hi, hi + 1
            elif n_lo is not None:
                pick, lo = n_lo, lo - 1
            else:
                # dead weakrefs on both sides: advance past them
                if hi < len(self._keys):
                    hi += 1
                if lo >= 0:
                    lo -= 1
                continue
            if not pick.is_expired():
                out.append(pick)
        return out

    def clear_bad(self) -> None:
        for n in list(self._map.values()):
            n.reset_expired()


class NodeCache:
    def __init__(self):
        self._c4 = _FamilyCache()
        self._c6 = _FamilyCache()

    def _fam(self, af: int) -> _FamilyCache:
        return self._c4 if af == AF_INET else self._c6

    def get_node(self, nid: InfoHash, addr: SockAddr) -> Node:
        """Find-or-create the canonical Node for (id, af)."""
        return self._fam(addr.family).get_node(nid, addr)

    def find(self, nid: InfoHash, af: int) -> Optional[Node]:
        return self._fam(af).get(nid)

    def get_cached_nodes(self, nid: InfoHash, af: int, count: int) -> List[Node]:
        return self._fam(af).closest(nid, count)

    def clear_bad_nodes(self, af: int = 0) -> None:
        if af in (0, AF_INET):
            self._c4.clear_bad()
        if af in (0, AF_INET6):
            self._c6.clear_bad()
