"""Argon2i (RFC 9106, version 0x13), the password hash behind
:func:`~opendht_tpu_torch.crypto.identity.stretch_key`.

``argon2.cpp`` (its own BLAKE2b and BLAKE2b-long) is built by g++ at
first use into ``opendht_tpu_torch/build/libargon2-<hash>.so``, as
``dhtcore.cpp`` is.  :func:`argon2i_py` is its pure-Python twin with
the same answers (BLAKE2b from ``hashlib``), used where no compiler
exists; at the password cost (t = 16, m = 64 MiB) it takes about a
million block compressions, far too many for Python, so it is meant
for small costs.  :func:`available` says whether the C++ build runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import Optional

from . import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "argon2.cpp")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

SYNC_POINTS = 4
VERSION = 0x13
TYPE_I = 1
_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    lib = build_library(_SRC, "argon2")
    if lib is None:
        return None
    p = ctypes.c_char_p
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.argon2i_hash_raw.argtypes = [u32, u32, u32, p, u64, p, u64, p, u64,
                                     p, u64, ctypes.c_void_p, u64]
    lib.argon2i_hash_raw.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _check(t_cost, m_cost, lanes, salt, hash_len) -> None:
    if (t_cost < 1 or lanes < 1 or hash_len < 4 or len(salt) < 8
            or m_cost < 8 * lanes):
        raise ValueError("argon2i: parameter out of range")


def argon2i(password: bytes, salt: bytes, t_cost: int, m_cost: int,
            lanes: int, hash_len: int, secret: bytes = b"",
            ad: bytes = b"") -> bytes:
    """The raw Argon2i tag of ``password`` (``m_cost`` in KiB): the C++
    build where it loads, else :func:`argon2i_py`."""
    _check(t_cost, m_cost, lanes, salt, hash_len)
    lib = _load()
    if lib is None:
        return argon2i_py(password, salt, t_cost, m_cost, lanes, hash_len,
                          secret, ad)
    out = ctypes.create_string_buffer(hash_len)
    rc = lib.argon2i_hash_raw(t_cost, m_cost, lanes, password,
                              len(password), salt, len(salt), secret,
                              len(secret), ad, len(ad), out, hash_len)
    if rc != 0:
        raise MemoryError(f"argon2i: native hash failed ({rc})")
    return out.raw


# ---------------------------------------------------------------------------
# the pure-Python twin
# ---------------------------------------------------------------------------

def _le32(v: int) -> bytes:
    return v.to_bytes(4, "little")


def _blake2b_long(data: bytes, outlen: int) -> bytes:
    """H' (RFC 9106 §3.3)."""
    if outlen <= 64:
        return hashlib.blake2b(_le32(outlen) + data,
                               digest_size=outlen).digest()
    v = hashlib.blake2b(_le32(outlen) + data).digest()
    out = [v[:32]]
    left = outlen - 32
    while left > 64:
        v = hashlib.blake2b(v).digest()
        out.append(v[:32])
        left -= 32
    out.append(hashlib.blake2b(v, digest_size=left).digest())
    return b"".join(out)


def _gb(v, a, b, c, d) -> None:
    va, vb, vc, vd = v[a], v[b], v[c], v[d]
    va = (va + vb + 2 * (va & _M32) * (vb & _M32)) & _M64
    vd ^= va
    vd = (vd >> 32) | ((vd << 32) & _M64)
    vc = (vc + vd + 2 * (vc & _M32) * (vd & _M32)) & _M64
    vb ^= vc
    vb = (vb >> 24) | ((vb << 40) & _M64)
    va = (va + vb + 2 * (va & _M32) * (vb & _M32)) & _M64
    vd ^= va
    vd = (vd >> 16) | ((vd << 48) & _M64)
    vc = (vc + vd + 2 * (vc & _M32) * (vd & _M32)) & _M64
    vb ^= vc
    vb = (vb >> 63) | ((vb << 1) & _M64)
    v[a], v[b], v[c], v[d] = va, vb, vc, vd


def _round(v, q) -> None:
    _gb(v, q[0], q[4], q[8], q[12])
    _gb(v, q[1], q[5], q[9], q[13])
    _gb(v, q[2], q[6], q[10], q[14])
    _gb(v, q[3], q[7], q[11], q[15])
    _gb(v, q[0], q[5], q[10], q[15])
    _gb(v, q[1], q[6], q[11], q[12])
    _gb(v, q[2], q[7], q[8], q[13])
    _gb(v, q[3], q[4], q[9], q[14])


_ROWS = [list(range(16 * i, 16 * i + 16)) for i in range(8)]
_COLS = [[2 * i + o for r in range(8) for o in (16 * r, 16 * r + 1)]
         for i in range(8)]


def _compress(prev, ref, old=None):
    """G: P(prev ^ ref) ^ prev ^ ref, XORed with ``old`` when given."""
    r = [x ^ y for x, y in zip(prev, ref)]
    v = list(r)
    for q in _ROWS:
        _round(v, q)
    for q in _COLS:
        _round(v, q)
    if old is None:
        return [x ^ y for x, y in zip(r, v)]
    return [x ^ y ^ z for x, y, z in zip(r, v, old)]


def _words(b: bytes):
    return [int.from_bytes(b[i:i + 8], "little") for i in range(0, 1024, 8)]


def argon2i_py(password: bytes, salt: bytes, t_cost: int, m_cost: int,
               lanes: int, hash_len: int, secret: bytes = b"",
               ad: bytes = b"") -> bytes:
    """Argon2i in Python; the same tag as the C++ build."""
    _check(t_cost, m_cost, lanes, salt, hash_len)
    blocks = max(m_cost, 2 * SYNC_POINTS * lanes)
    seg = blocks // (lanes * SYNC_POINTS)
    m_prime = seg * lanes * SYNC_POINTS
    lane_len = seg * SYNC_POINTS
    h0 = hashlib.blake2b(b"".join([
        _le32(lanes), _le32(hash_len), _le32(m_cost), _le32(t_cost),
        _le32(VERSION), _le32(TYPE_I), _le32(len(password)), password,
        _le32(len(salt)), salt, _le32(len(secret)), secret,
        _le32(len(ad)), ad])).digest()
    mem = [None] * m_prime
    for lane in range(lanes):
        for j in (0, 1):
            mem[lane * lane_len + j] = _words(
                _blake2b_long(h0 + _le32(j) + _le32(lane), 1024))
    zero = [0] * 128
    for pas in range(t_cost):
        for sl in range(SYNC_POINTS):
            for lane in range(lanes):
                inp = [0] * 128
                inp[:6] = [pas, lane, sl, m_prime, t_cost, TYPE_I]
                addr = None
                start = 2 if pas == 0 and sl == 0 else 0
                for i in range(start, seg):
                    if addr is None or i % 128 == 0:
                        inp[6] += 1
                        addr = _compress(zero, _compress(zero, inp))
                    pseudo = addr[i % 128]
                    ref_lane = (pseudo >> 32) % lanes
                    if pas == 0 and sl == 0:
                        ref_lane = lane
                    same = ref_lane == lane
                    if pas == 0:
                        if sl == 0:
                            area = i - 1
                        elif same:
                            area = sl * seg + i - 1
                        else:
                            area = sl * seg - (1 if i == 0 else 0)
                    else:
                        area = lane_len - seg + (i - 1 if same
                                                 else -(1 if i == 0 else 0))
                    rel = pseudo & _M32
                    rel = (rel * rel) >> 32
                    rel = area - 1 - ((area * rel) >> 32)
                    begin = (0 if pas == 0 or sl == SYNC_POINTS - 1
                             else (sl + 1) * seg)
                    ref = mem[ref_lane * lane_len + (begin + rel) % lane_len]
                    cur = lane * lane_len + sl * seg + i
                    prev = cur - 1 if cur % lane_len else cur + lane_len - 1
                    mem[cur] = _compress(mem[prev], ref,
                                         mem[cur] if pas else None)
    last = list(mem[lane_len - 1])
    for lane in range(1, lanes):
        last = [x ^ y for x, y in
                zip(last, mem[lane * lane_len + lane_len - 1])]
    return _blake2b_long(b"".join(w.to_bytes(8, "little") for w in last),
                         hash_len)
