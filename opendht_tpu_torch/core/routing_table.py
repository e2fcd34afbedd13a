"""Kademlia routing table: ordered list of k-buckets.

Re-design of the reference routing table (ref:
include/opendht/routing_table.h:26-79, src/routing_table.cpp).  Buckets are
kept sorted by their ``first`` prefix id; a bucket covers the id range
[first, next.first).  Each holds up to ``TARGET_NODES`` (k=8) nodes plus one
cached replacement candidate.  ``find_closest_nodes`` walks outward from the
home bucket, XOR-merge-sorting good nodes (src/routing_table.cpp:67-111).

This is the host-side, event-driven implementation; the device-resident
batched equivalent is :func:`opendht_tpu_torch.models.swarm.build_tables` (the
same k-bucket semantics built as one vectorized pass over sorted ids).
"""

from __future__ import annotations

import random
from typing import List, Optional

from ..utils.clock import TIME_INVALID
from ..utils.infohash import HASH_BITS, HASH_LEN, InfoHash
from .constants import TARGET_NODES
from .node import Node


class Bucket:
    __slots__ = ("af", "first", "time", "nodes", "cached")

    def __init__(self, af: int, first: InfoHash, time: float = TIME_INVALID):
        self.af = af
        self.first = first
        self.time = time            # last time bucket was confirmed active
        self.nodes: List[Node] = []
        self.cached: Optional[Node] = None  # replacement candidate

    def contains(self, nid: InfoHash) -> bool:
        return any(n.id == nid for n in self.nodes)

    def find(self, nid: InfoHash) -> Optional[Node]:
        for n in self.nodes:
            if n.id == nid:
                return n
        return None

    def random_node(self, rng: Optional[random.Random] = None) -> Optional[Node]:
        if not self.nodes:
            return None
        return (rng or random).choice(self.nodes)


class RoutingTable:
    def __init__(self, af: int):
        self.af = af
        self.buckets: List[Bucket] = [Bucket(af, InfoHash.zero())]
        self.grow_time = TIME_INVALID

    def __len__(self):
        return len(self.buckets)

    def __iter__(self):
        return iter(self.buckets)

    def is_empty(self) -> bool:
        return len(self.buckets) == 1 and not self.buckets[0].nodes

    # -- bucket lookup (ref: src/routing_table.cpp:113-127) ----------------
    def find_bucket_index(self, nid: InfoHash) -> int:
        lo, hi = 0, len(self.buckets) - 1
        # binary search: last bucket with first <= id
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if InfoHash.cmp(nid, self.buckets[mid].first) < 0:
                hi = mid - 1
            else:
                lo = mid
        return lo

    def find_bucket(self, nid: InfoHash) -> Bucket:
        return self.buckets[self.find_bucket_index(nid)]

    # -- geometry (ref: src/routing_table.cpp:27-66) -----------------------
    def depth(self, idx: int) -> int:
        b = self.buckets[idx]
        bit1 = b.first.lowbit()
        bit2 = (self.buckets[idx + 1].first.lowbit()
                if idx + 1 < len(self.buckets) else -1)
        return max(bit1, bit2) + 1

    def middle(self, idx: int) -> InfoHash:
        bit = self.depth(idx)
        if bit >= HASH_BITS:
            raise IndexError("bucket not splittable")
        return self.buckets[idx].first.set_bit(bit, True)

    def random_id(self, idx: int, rng: Optional[random.Random] = None) -> InfoHash:
        """Random id inside the bucket's range (ref: routing_table.cpp:27-45)."""
        r = rng or random
        b = self.buckets[idx]
        bit = self.depth(idx)
        if bit >= HASH_BITS:
            return b.first
        byte_i = bit // 8
        out = bytearray(bytes(b.first))
        rb = r.getrandbits(8)
        out[byte_i] = (out[byte_i] & (0xFF00 >> (bit % 8)) & 0xFF) | (rb >> (bit % 8))
        for i in range(byte_i + 1, HASH_LEN):
            out[i] = r.getrandbits(8)
        return InfoHash(bytes(out))

    # -- split (ref: src/routing_table.cpp:139-163) ------------------------
    def split(self, idx: int) -> bool:
        try:
            new_first = self.middle(idx)
        except IndexError:
            return False
        b = self.buckets[idx]
        nb = Bucket(self.af, new_first, b.time)
        self.buckets.insert(idx + 1, nb)
        nodes = b.nodes
        b.nodes = []
        for n in nodes:
            self.find_bucket(n.id).nodes.insert(0, n)
        return True

    # -- closest nodes (ref: src/routing_table.cpp:67-111) -----------------
    def find_closest_nodes(self, nid: InfoHash, now: float,
                           count: int = TARGET_NODES) -> List[Node]:
        out: List[Node] = []

        def insert_bucket(b: Bucket) -> None:
            for n in b.nodes:
                if not n.is_good(now):
                    continue
                i = 0
                while i < len(out) and InfoHash.xor_cmp(out[i].id, n.id, nid) < 0:
                    i += 1
                out.insert(i, n)

        home = self.find_bucket_index(nid)
        lo, hi = home - 1, home
        while len(out) < count and (hi < len(self.buckets) or lo >= 0):
            if hi < len(self.buckets):
                insert_bucket(self.buckets[hi])
                hi += 1
            if lo >= 0:
                insert_bucket(self.buckets[lo])
                lo -= 1
        return out[:count]

    # -- stats -------------------------------------------------------------
    def all_nodes(self) -> List[Node]:
        return [n for b in self.buckets for n in b.nodes]

    def node_count(self) -> int:
        return sum(len(b.nodes) for b in self.buckets)
