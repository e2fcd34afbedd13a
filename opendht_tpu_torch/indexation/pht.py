"""Prefix Hash Tree: a distributed trie index over a DHT's get / put /
listen surface.

The port's own copy of ``opendht_tpu/indexation/pht.py`` (the
reference's ``dht::indexation::Pht``, src/indexation/pht.cpp): multi-
field keys padded, end-marked and z-curve interleaved into one binary
:class:`Prefix`; a trie node for a prefix lives at ``SHA-1(content ‖
size byte)``, its presence marked by a canary value; lookup is a binary
search on prefix length probing ``mid`` and ``mid + 1``; insert walks
to the leaf and splits a full leaf (more than ``MAX_NODE_ENTRY_COUNT``
entries) at the divergence point, and a listen on the next prefix
re-inserts when a deeper split appears; a client-side cache remembers
known trie depth.

It runs over anything with that surface; in the port that is
:class:`~opendht_tpu_torch.models.index.StoreDht`, the facade over the
device store, or the host node
:class:`~opendht_tpu_torch.core.dht.Dht`, with values of the port's
:class:`~opendht_tpu_torch.core.value.Value`.  An index entry's value
blob is the MessagePack map ``{"p", "sz", "h", "vid"}`` the JAX package
writes, encoded by the port's codec (:mod:`~opendht_tpu_torch.utils.
mpack`).
"""

from __future__ import annotations

import random
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from ..core.value import Value
from ..utils.infohash import InfoHash
from ..utils.mpack import packb, unpackb

INDEX_PREFIX = "index.pht."
MAX_NODE_ENTRY_COUNT = 16
CACHE_NODE_EXPIRE_TIME = 5 * 60.0
CACHE_MAX_ELEMENT = 1024

# An index entry points at (hash, value id) — ref pht.h:246.
IndexValue = Tuple[InfoHash, int]


class Prefix:
    """A bit-string prefix (MSB-first), with per-bit "known" flags
    (ref: pht.h:40-190)."""

    __slots__ = ("content", "flags", "size")

    def __init__(self, content: bytes = b"", size: Optional[int] = None,
                 flags: bytes = b""):
        self.content = bytes(content)
        self.flags = bytes(flags)
        self.size = len(self.content) * 8 if size is None else int(size)

    # -- bit helpers (MSB-first like the reference's isActiveBit) -------
    @staticmethod
    def _bit(b: bytes, pos: int) -> bool:
        return ((b[pos // 8] >> (7 - (pos % 8))) & 1) == 1

    @staticmethod
    def _with_bit_flipped(b: bytes, pos: int) -> bytes:
        ba = bytearray(b)
        ba[pos // 8] ^= 1 << (7 - (pos % 8))
        return bytes(ba)

    def is_content_bit_active(self, pos: int) -> bool:
        return self._bit(self.content, pos)

    def is_flag_active(self, pos: int) -> bool:
        return not self.flags or self._bit(self.flags, pos)

    # -- derivation -----------------------------------------------------
    def get_prefix(self, length: int) -> "Prefix":
        """Truncate to ``length`` bits (negative = relative to size)."""
        if abs(length) > len(self.content) * 8:
            raise IndexError("len larger than prefix size")
        if length < 0:
            length += self.size
        nbytes = length // 8
        rem = length % 8
        content = self.content[:nbytes]
        flags = self.flags[:nbytes] if self.flags else b""
        if rem:
            content += bytes([self.content[nbytes] & (0xFF << (8 - rem))])
            if self.flags:
                flags += bytes([self.flags[nbytes] & (0xFF << (8 - rem))])
        return Prefix(content, length, flags)

    def get_full_size(self) -> "Prefix":
        return Prefix(self.content, len(self.content) * 8, self.flags)

    def get_sibling(self) -> "Prefix":
        """Flip the last bit (ref: pht.h:94-101)."""
        if not self.size:
            return Prefix(self.content, self.size, self.flags)
        return Prefix(self._with_bit_flipped(self.content, self.size - 1),
                      self.size, self.flags)

    def hash(self) -> InfoHash:
        """Trie-node location: SHA-1(content ‖ size) (ref: pht.h:103-107;
        the reference truncates size to one byte — kept for shape)."""
        return InfoHash.get(self.content + bytes([self.size & 0xFF]))

    @staticmethod
    def common_bits(a: "Prefix", b: "Prefix") -> int:
        n = min(a.size, b.size)
        for i in range(n):
            if (a.is_content_bit_active(i) != b.is_content_bit_active(i)
                    or not a.is_flag_active(i) or not b.is_flag_active(i)):
                return i
        return n

    def __eq__(self, other):
        return (isinstance(other, Prefix) and self.size == other.size
                and self.content == other.content)

    def __repr__(self):
        bits = "".join("1" if self.is_content_bit_active(i) else "0"
                       for i in range(self.size))
        return f"Prefix({bits})"


class IndexEntry:
    """A stored index record: full linearized prefix + target
    (ref: pht.h:247-266)."""

    __slots__ = ("prefix", "value", "name")

    def __init__(self, prefix: Prefix, value: IndexValue, name: str = ""):
        self.prefix = prefix
        self.value = value
        self.name = name

    def pack_value(self) -> Value:
        blob = packb({
            "p": self.prefix.content,
            "sz": self.prefix.size,
            "h": bytes(self.value[0]),
            "vid": self.value[1],
        })
        return Value(blob, 0, user_type=self.name)

    @classmethod
    def unpack_value(cls, v: Value) -> "IndexEntry":
        o = unpackb(v.data)
        return cls(Prefix(bytes(o["p"]), int(o["sz"])),
                   (InfoHash(bytes(o["h"])), int(o["vid"])),
                   v.user_type)


class _CacheNode:
    __slots__ = ("children", "last_reply")

    def __init__(self):
        self.children: Dict[bool, "_CacheNode"] = {}
        self.last_reply = 0.0


class Cache:
    """Client-side trie depth cache (ref: pht.cpp:42-126)."""

    def __init__(self, now: Callable[[], float] = _time.monotonic):
        self.root = _CacheNode()
        self._now = now
        self._count = 0

    def insert(self, p: Prefix) -> None:
        now = self._now()
        node = self.root
        node.last_reply = now
        for i in range(p.size):
            bit = p.is_content_bit_active(i)
            nxt = node.children.get(bit)
            if nxt is None:
                nxt = _CacheNode()
                node.children[bit] = nxt
                self._count += 1
            nxt.last_reply = now
            node = nxt
        if self._count > CACHE_MAX_ELEMENT:
            self._expire(self.root, now)

    def lookup(self, p: Prefix) -> int:
        """Deepest cached trie depth along ``p`` (-1 if none)."""
        now = self._now()
        pos = -1
        node = self.root
        while node is not None and node.last_reply + \
                CACHE_NODE_EXPIRE_TIME >= now:
            pos += 1
            if pos >= len(p.content) * 8 or pos >= p.size:
                break
            node = node.children.get(p.is_content_bit_active(pos))
        return pos

    def _expire(self, node: _CacheNode, now: float) -> None:
        for bit, child in list(node.children.items()):
            if child.last_reply + CACHE_NODE_EXPIRE_TIME < now:
                del node.children[bit]
                self._count -= self._subtree_size(child)
            else:
                self._expire(child, now)

    @classmethod
    def _subtree_size(cls, node: _CacheNode) -> int:
        return 1 + sum(cls._subtree_size(c)
                       for c in node.children.values())


class Pht:
    """The index object (ref: pht.h:268-510)."""

    def __init__(self, name: str, key_spec: Dict[str, int], dht,
                 rng: Optional[random.Random] = None,
                 parent_insert: bool = True):
        self.name = INDEX_PREFIX + name
        self.canary = self.name + ".canary"
        self.key_spec = dict(key_spec)
        self.dht = dht
        self.rng = rng or random.Random()
        # The reference's _get_real_prefix heuristic (insert at the
        # parent while leaf+parent+sibling stay under the cap,
        # pht.cpp:423-476) is insertion-ORDER-dependent and parks
        # entries at interior nodes.  parent_insert=False pins inserts
        # to the true leaf — the deterministic rule the device index
        # (models/index.py) implements, and what the host↔device
        # conformance tests run both sides under.  Default True keeps
        # reference behavior.
        self.parent_insert = bool(parent_insert)
        now = getattr(dht, "scheduler", None)
        self.cache = Cache(now.time if now is not None else _time.monotonic)

    # ------------------------------------------------------------------ #
    # key linearization                                                  #
    # ------------------------------------------------------------------ #

    def valid_key(self, key: Dict[str, bytes]) -> bool:
        """ref: Pht::validKey pht.h:492-500."""
        return (set(key) == set(self.key_spec)
                and all(len(v) <= self.key_spec[k]
                        for k, v in key.items()))

    def linearize(self, key: Dict[str, bytes]) -> Prefix:
        """Pad each field to the max spec length + terminator, then
        z-curve interleave (ref: pht.cpp:400-421)."""
        if not self.valid_key(key):
            raise ValueError("Key does not match the PHT key spec.")
        max_len = max(self.key_spec.values()) + 1
        prefixes = []
        for field in sorted(self.key_spec):
            data = key[field]
            content = bytearray(data + bytes(max_len - len(data)))
            size = len(data) * 8
            # Terminator bit right after the content (disambiguates
            # "ab" from "ab\0") — the reference's addPadding end-marker.
            if len(data) < max_len:
                content[size // 8] |= 0x80 >> (size % 8)
            flags = bytes(b"\xFF" * max_len)
            prefixes.append(Prefix(bytes(content), len(content) * 8, flags))
        return self.zcurve(prefixes)

    @staticmethod
    def zcurve(prefixes: List[Prefix]) -> Prefix:
        """Bit-interleave the fields (ref: pht.cpp:352-398)."""
        if len(prefixes) == 1:
            return prefixes[0]
        nf = len(prefixes)
        nbits = len(prefixes[0].content) * 8
        content = bytearray((nbits * nf + 7) // 8)
        flags = bytearray(len(content))
        t = 0
        for i in range(nbits):
            for p in prefixes:
                if p.is_content_bit_active(i):
                    content[t // 8] |= 0x80 >> (t % 8)
                if p.is_flag_active(i):
                    flags[t // 8] |= 0x80 >> (t % 8)
                t += 1
        return Prefix(bytes(content), t, bytes(flags))

    # ------------------------------------------------------------------ #
    # lookup                                                             #
    # ------------------------------------------------------------------ #

    def _pht_filter(self, v: Value) -> bool:
        # Exact match (not startswith): trie-node hashes depend only on
        # the linearized key, so indexes named "foo" and "foobar" share
        # DHT keys and must be distinguished by user_type alone.
        return v.user_type in (self.name, self.canary)

    def lookup(self, key: Dict[str, bytes],
               cb: Callable[[List[IndexValue], Prefix], None],
               done_cb: Optional[Callable[[bool], None]] = None,
               exact: bool = True) -> None:
        """ref: Pht::lookup pht.cpp:270-289."""
        prefix = self.linearize(key)
        state = {"max_common": 0} if not exact else None
        self._lookup_step(
            prefix, [0], [prefix.size], [], cb, done_cb, state,
            self.cache.lookup(prefix), all_values=False)

    def _lookup_step(self, p: Prefix, lo: List[int], hi: List[int],
                     vals: List[IndexEntry], cb, done_cb,
                     inexact_state: Optional[dict], start: int,
                     all_values: bool) -> None:
        """Async binary search on prefix length
        (ref: Pht::lookupStep pht.cpp:131-268)."""
        # int() truncates toward zero like the reference's C int
        # division ((0 + -1)/2 == 0, not Python floor's -1)
        mid = start if start >= 0 else int((lo[0] + hi[0]) / 2)
        first = {"done": False, "is_pht": False}
        second = {"done": False, "is_pht": False}

        def on_done(ok: bool) -> None:
            is_leaf = first["is_pht"] and not second["is_pht"]
            if not ok:
                if done_cb:
                    done_cb(False)
            elif is_leaf or lo[0] > hi[0]:
                to_insert = p.get_prefix(mid)
                self.cache.insert(to_insert)
                if cb is not None:
                    if (not vals and inexact_state is not None
                            and mid > 0):
                        # Inexact miss: walk the sibling subtree.
                        p2 = p.get_prefix(mid).get_sibling().get_full_size()
                        lo[0] = mid
                        hi[0] = p2.size
                        self._lookup_step(p2, lo, hi, vals, cb, done_cb,
                                          inexact_state, -1, all_values)
                        return
                    cb([e.value for e in vals], to_insert)
                if done_cb:
                    done_cb(True)
            elif first["is_pht"]:
                lo[0] = mid + 1
                self._lookup_step(p, lo, hi, vals, cb, done_cb,
                                  inexact_state, -1, all_values)
            else:
                if done_cb:
                    done_cb(False)

        if lo[0] > hi[0]:
            on_done(True)
            return

        def on_get(values: List[Value], res: dict) -> bool:
            for value in values:
                if value.user_type == self.canary:
                    res["is_pht"] = True
                    continue
                try:
                    entry = IndexEntry.unpack_value(value)
                except Exception:
                    continue
                if any(e.value == entry.value for e in vals):
                    continue
                if inexact_state is not None:
                    cbits = Prefix.common_bits(p, entry.prefix)
                    if not vals:
                        vals.append(entry)
                        inexact_state["max_common"] = cbits
                    elif cbits == inexact_state["max_common"]:
                        vals.append(entry)
                    elif cbits > inexact_state["max_common"]:
                        vals.clear()
                        vals.append(entry)
                        inexact_state["max_common"] = cbits
                elif all_values or entry.prefix.content == p.content:
                    vals.append(entry)
            return True

        def first_done(ok: bool, nodes=None) -> None:
            if not ok:
                first["done"] = True
                if done_cb and second["done"]:
                    on_done(False)
                return
            if not first["is_pht"]:
                hi[0] = mid - 1
                self._lookup_step(p, lo, hi, vals, cb, done_cb,
                                  inexact_state, -1, all_values)
            else:
                first["done"] = True
                if second["done"] or mid >= p.size - 1:
                    on_done(True)

        def second_done(ok: bool, nodes=None) -> None:
            second["done"] = True
            if not ok:
                if done_cb and first["done"]:
                    on_done(False)
            elif first["done"]:
                on_done(True)

        self.dht.get(p.get_prefix(mid).hash(),
                     lambda vs: on_get(vs, first),
                     first_done, f=self._pht_filter)
        if mid < p.size - 1:
            self.dht.get(p.get_prefix(mid + 1).hash(),
                         lambda vs: on_get(vs, second),
                         second_done, f=self._pht_filter)
        else:
            second["done"] = True

    # ------------------------------------------------------------------ #
    # insert                                                             #
    # ------------------------------------------------------------------ #

    def insert(self, key: Dict[str, bytes], value: IndexValue,
               done_cb: Optional[Callable[[bool], None]] = None) -> None:
        """ref: Pht::insert pht.cpp:312-350."""
        kp = self.linearize(key)
        entry = IndexEntry(kp.get_full_size(), value, self.name)
        created = self._now()
        self._insert(kp, entry, [0], [kp.size], created, True, done_cb)

    def _now(self) -> float:
        sched = getattr(self.dht, "scheduler", None)
        return sched.time() if sched is not None else _time.monotonic()

    def _put(self, h: InfoHash, value: Value, done_cb=None) -> None:
        # Adapt our put's (ok, nodes) done signature to the simple one.
        self.dht.put(h, value,
                     (lambda ok, nodes: done_cb(ok)) if done_cb else None)

    def _insert(self, kp: Prefix, entry: IndexEntry, lo: List[int],
                hi: List[int], time_p: float, check_split: bool,
                done_cb) -> None:
        vals: List[IndexEntry] = []
        final_prefix: List[Optional[Prefix]] = [None]

        def on_leaf(values, p: Prefix) -> None:
            final_prefix[0] = p

        def on_lookup_done(ok: bool) -> None:
            if not ok:
                if done_cb:
                    done_cb(False)
                return

            def real_insert(p: Prefix, e: IndexEntry) -> None:
                self._update_canary(p)
                self._check_pht_update(p, e, time_p)
                self.cache.insert(p)
                self._put(p.hash(), e.pack_value(), done_cb)

            fp = final_prefix[0]
            if not check_split or (fp is not None and fp.size == kp.size):
                real_insert(fp if fp is not None else kp, entry)
            elif len(vals) < MAX_NODE_ENTRY_COUNT:
                if self.parent_insert:
                    self._get_real_prefix(fp, entry, real_insert)
                else:
                    real_insert(fp if fp is not None else kp, entry)
            else:
                self._split(fp, vals, entry, real_insert)

        self._lookup_step(kp, lo, hi, vals,
                          lambda values, p: on_leaf(values, p),
                          on_lookup_done, None, self.cache.lookup(kp),
                          all_values=True)

    def _update_canary(self, p: Prefix) -> None:
        """Mark trie-node presence, propagating up with p=1/2
        (ref: Pht::updateCanary pht.cpp:291-310)."""
        v = Value(b"", 0, user_type=self.canary)

        def done(ok, nodes=None):
            if p.size and self.rng.random() < 0.5:
                self._update_canary(p.get_prefix(-1))

        self.dht.put(p.hash(), v, done)
        if p.size:
            self.dht.put(p.get_sibling().hash(),
                         Value(b"", 0, user_type=self.canary), None)

    def _get_real_prefix(self, p: Optional[Prefix], entry: IndexEntry,
                         end_cb) -> None:
        """Count entries at leaf/parent/sibling; insert at the parent if
        the 3 together stay under the cap (ref: pht.cpp:423-476)."""
        if p is None or p.size == 0:
            end_cb(p if p is not None else Prefix(), entry)
            return
        total = [0]
        ended = [0]
        parent = p.get_prefix(-1)
        sibling = p.get_sibling()

        def count(values: List[Value]) -> bool:
            total[0] += sum(1 for v in values
                            if v.user_type != self.canary)
            return True

        def on_done(ok, nodes=None) -> None:
            ended[0] += 1
            if ended[0] == 3:
                if total[0] < MAX_NODE_ENTRY_COUNT:
                    end_cb(parent, entry)
                else:
                    end_cb(p, entry)

        for h in (parent.hash(), p.hash(), sibling.hash()):
            self.dht.get(h, count, on_done, f=self._pht_filter)

    def _check_pht_update(self, p: Prefix, entry: IndexEntry,
                          time_p: float) -> None:
        """Listen for a deeper split and re-insert when it happens
        (ref: Pht::checkPhtUpdate pht.cpp:478-501)."""
        full = entry.prefix
        if p.size + 1 > full.size:
            return
        next_prefix = full.get_prefix(p.size + 1)

        def on_values(values: List[Value]) -> bool:
            for v in values:
                if v.user_type == self.canary:
                    self._insert(full, entry, [0], [full.size], time_p,
                                 False, None)
                    return False
            return True

        self.dht.listen(next_prefix.hash(), on_values,
                        f=self._pht_filter)

    def _split(self, insert_p: Prefix, vals: List[IndexEntry],
               entry: IndexEntry, end_cb) -> None:
        """Split a full leaf at the divergence point
        (ref: Pht::split pht.cpp:503-514, foundSplitLocation
        pht.h:468-475)."""
        full = entry.prefix
        loc = self._found_split_location(full, vals)
        prefix_to_insert = full.get_prefix(loc)
        i = loc
        while i > insert_p.size - 1 and i > 0:
            self._update_canary(full.get_prefix(i))
            i -= 1
        end_cb(prefix_to_insert, entry)

    @staticmethod
    def _found_split_location(compared: Prefix,
                              vals: List[IndexEntry]) -> int:
        for i in range(len(compared.content) * 8 - 1):
            for e in vals:
                if (e.prefix.is_content_bit_active(i)
                        != compared.is_content_bit_active(i)):
                    return i + 1
        return len(compared.content) * 8 - 1
