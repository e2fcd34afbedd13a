"""160-bit DHT identifiers (InfoHash) and their packed limb form.

The port's own copy of ``opendht_tpu/utils/infohash.py`` (pure host
code): :class:`InfoHash`, an immutable wrapper around 20 bytes with the
reference's ``lowbit``, three-way ``cmp``, ``common_bits``, ``xor_cmp``,
bit get / set, SHA-1 ``get`` and ``get_random``
(include/opendht/infohash.h, src/infohash.cpp); and the packed
``uint32[5]`` limbs (big-endian limb order: limb 0 holds bytes 0-3)
the device engines hold ids in, where lexicographic limb order equals
160-bit id order (:func:`pack_ids`, :func:`unpack_ids`).  The host
:class:`~opendht_tpu_torch.indexation.pht.Pht` and
:class:`~opendht_tpu_torch.models.index.StoreDht` address trie nodes
with it.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterable, Union

import numpy as np

HASH_LEN = 20  # bytes
HASH_BITS = HASH_LEN * 8
N_LIMBS = 5  # 5 x uint32


class InfoHash:
    """An immutable 160-bit identifier with XOR-metric helpers."""

    __slots__ = ("_b",)

    def __init__(self, data: Union[bytes, bytearray, str, "InfoHash", None] = None):
        if data is None:
            b = bytes(HASH_LEN)
        elif isinstance(data, InfoHash):
            b = data._b
        elif isinstance(data, str):
            # hex string; short/invalid strings yield the zero hash like the
            # reference's fromString (infohash.h:176-189)
            try:
                b = bytes.fromhex(data)
            except ValueError:
                b = b""
            b = b[:HASH_LEN] if len(b) >= HASH_LEN else bytes(HASH_LEN)
        else:
            b = bytes(data)
            if len(b) != HASH_LEN:
                raise ValueError(f"InfoHash needs {HASH_LEN} bytes, got {len(b)}")
        object.__setattr__(self, "_b", b)

    # -- construction ------------------------------------------------------
    @classmethod
    def get(cls, data: Union[bytes, str]) -> "InfoHash":
        """SHA-1 of arbitrary key material (ref: src/infohash.cpp:46-61)."""
        if isinstance(data, str):
            data = data.encode("utf-8")
        return cls(hashlib.sha1(data).digest())

    @classmethod
    def get_random(cls, rng=None) -> "InfoHash":
        if rng is not None:
            return cls(bytes(rng.bytes(HASH_LEN)))
        return cls(os.urandom(HASH_LEN))

    @classmethod
    def zero(cls) -> "InfoHash":
        return cls()

    # -- bytes access ------------------------------------------------------
    def __bytes__(self) -> bytes:
        return self._b

    @property
    def data(self) -> bytes:
        return self._b

    def hex(self) -> str:
        return self._b.hex()

    # -- predicates & metric ----------------------------------------------
    def __bool__(self) -> bool:
        return self._b != bytes(HASH_LEN)

    def xor(self, other: "InfoHash") -> "InfoHash":
        return InfoHash(bytes(a ^ b for a, b in zip(self._b, other._b)))

    def lowbit(self) -> int:
        """Index of the lowest set bit, -1 if zero (ref: infohash.h:84-97)."""
        for i in range(HASH_LEN - 1, -1, -1):
            v = self._b[i]
            if v:
                j = 0
                while not (v & (1 << j)):
                    j += 1
                return 8 * i + (7 - j)
        return -1

    def common_bits(self, other: "InfoHash") -> int:
        """Length of the common binary prefix (ref: infohash.h:106-126)."""
        for i in range(HASH_LEN):
            x = self._b[i] ^ other._b[i]
            if x:
                j = 0
                while not (x & 0x80):
                    x = (x << 1) & 0xFF
                    j += 1
                return 8 * i + j
        return HASH_BITS

    @staticmethod
    def cmp(a: "InfoHash", b: "InfoHash") -> int:
        if a._b < b._b:
            return -1
        if a._b > b._b:
            return 1
        return 0

    @staticmethod
    def xor_cmp(a: "InfoHash", b: "InfoHash", target: "InfoHash") -> int:
        """-1 if ``a`` is XOR-closer to ``target``, 1 if ``b`` is
        (ref: infohash.h:131-146)."""
        for i in range(HASH_LEN):
            xa = a._b[i] ^ target._b[i]
            xb = b._b[i] ^ target._b[i]
            if xa != xb:
                return -1 if xa < xb else 1
        return 0

    def get_bit(self, bit: int) -> bool:
        return bool(self._b[bit // 8] & (0x80 >> (bit % 8)))

    def set_bit(self, bit: int, value: bool) -> "InfoHash":
        b = bytearray(self._b)
        if value:
            b[bit // 8] |= 0x80 >> (bit % 8)
        else:
            b[bit // 8] &= ~(0x80 >> (bit % 8)) & 0xFF
        return InfoHash(bytes(b))

    # -- packed limb form (device path) -----------------------------------
    def to_u32(self) -> np.ndarray:
        """Big-endian uint32 limbs; lexicographic limb order == id order."""
        return np.frombuffer(self._b, dtype=">u4").astype(np.uint32)

    @classmethod
    def from_u32(cls, limbs) -> "InfoHash":
        arr = np.asarray(limbs, dtype=np.uint32)
        return cls(arr.astype(">u4").tobytes())

    # -- dunder ------------------------------------------------------------
    def __eq__(self, other) -> bool:
        return isinstance(other, InfoHash) and self._b == other._b

    def __lt__(self, other: "InfoHash") -> bool:
        return self._b < other._b

    def __le__(self, other: "InfoHash") -> bool:
        return self._b <= other._b

    def __hash__(self) -> int:
        return hash(self._b)

    def __repr__(self) -> str:
        return self.hex()

    def __str__(self) -> str:
        return self.hex()


def pack_ids(ids: Iterable[Union[InfoHash, bytes]]) -> np.ndarray:
    """Pack N 160-bit ids into an ``[N, 5] uint32`` matrix (device layout)."""
    rows = []
    for h in ids:
        b = bytes(h) if isinstance(h, InfoHash) else h
        rows.append(np.frombuffer(b, dtype=">u4"))
    if not rows:
        return np.zeros((0, N_LIMBS), dtype=np.uint32)
    return np.stack(rows).astype(np.uint32)


def unpack_ids(mat: np.ndarray) -> list:
    """Inverse of :func:`pack_ids`."""
    mat = np.asarray(mat, dtype=np.uint32)
    return [InfoHash(row.astype(">u4").tobytes()) for row in mat]


def random_ids(n: int, rng: np.random.Generator) -> np.ndarray:
    """N random ids directly in packed ``[N, 5] uint32`` form."""
    return rng.integers(0, 2**32, size=(n, N_LIMBS), dtype=np.uint32)
