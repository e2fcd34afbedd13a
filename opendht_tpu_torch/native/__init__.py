"""Native (C++17) host hot path, loaded via ctypes.

The port's own copy of ``opendht_tpu/native``.  ``libdhtcore-<hash>.so``
is built by g++ at first use into ``opendht_tpu_torch/build/`` (named
after a hash of the source, so an edit rebuilds it) and exposes the
exact 160-bit XOR-metric ops, k-closest selection, the sliding-window
rate limiter and the constant-time token compare.  Every entry point
has a pure-Python twin that gives the same answers, used where no
compiler exists; :func:`available` says which one runs.
:mod:`.argon2` (the password KDF's Argon2i) is built the same way
(:func:`build_library`).

The device engines own the batched work; this library owns the host
node's hot loops.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "dhtcore.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "build")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path(src: str, stem: str) -> str:
    """``build/lib<stem>-<hash of src>.so``: an edit rebuilds it."""
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD, f"lib{stem}-{tag}.so")


def _build_path() -> str:
    return library_path(_SRC, "dhtcore")


def build_library(src: str, stem: str) -> Optional[ctypes.CDLL]:
    """``src`` built by g++ into :func:`library_path` (once per source
    text) and loaded; ``None`` where there is no compiler or the build
    fails."""
    so = library_path(src, stem)
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            os.makedirs(_BUILD, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src,
                 "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except Exception as e:  # no compiler / failed build: fall back
            print(f"{stem}: native build unavailable ({e})",
                  file=sys.stderr)
            return None
    try:
        return ctypes.CDLL(so)
    except OSError:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    lib = build_library(_SRC, "dhtcore")
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.dhtcore_common_bits.argtypes = [u8p, u8p]
    lib.dhtcore_common_bits.restype = ctypes.c_int
    lib.dhtcore_xor_cmp.argtypes = [u8p, u8p, u8p]
    lib.dhtcore_xor_cmp.restype = ctypes.c_int
    lib.dhtcore_xor_topk.argtypes = [u8p, ctypes.c_int64, u8p,
                                     ctypes.c_int32, i32p]
    lib.dhtcore_xor_topk.restype = ctypes.c_int
    lib.dhtcore_common_bits_batch.argtypes = [u8p, ctypes.c_int64, u8p,
                                              i32p]
    lib.dhtcore_xor_sort.argtypes = [u8p, i32p, ctypes.c_int64, u8p]
    lib.dhtcore_rate_limiter_new.argtypes = [ctypes.c_uint64]
    lib.dhtcore_rate_limiter_new.restype = ctypes.c_void_p
    lib.dhtcore_rate_limiter_free.argtypes = [ctypes.c_void_p]
    lib.dhtcore_rate_limiter_limit.argtypes = [ctypes.c_void_p,
                                               ctypes.c_double]
    lib.dhtcore_rate_limiter_limit.restype = ctypes.c_int
    lib.dhtcore_token_eq.argtypes = [u8p, u8p, ctypes.c_uint64]
    lib.dhtcore_token_eq.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _u8(b: bytes):
    return ctypes.cast(ctypes.create_string_buffer(b, len(b)),
                       ctypes.POINTER(ctypes.c_uint8))


def common_bits(a: bytes, b: bytes) -> int:
    lib = _load()
    if lib is None:
        from ..utils.infohash import InfoHash
        return InfoHash(a).common_bits(InfoHash(b))
    return lib.dhtcore_common_bits(_u8(a), _u8(b))


def xor_topk(ids: bytes, n: int, target: bytes, k: int) -> list:
    """k exact XOR-closest row indices of a packed n×20-byte matrix."""
    lib = _load()
    if lib is None:
        from ..utils.infohash import InfoHash
        t = InfoHash(target)
        order = sorted(
            range(n),
            key=lambda i: bytes(
                x ^ y for x, y in zip(ids[i * 20:(i + 1) * 20],
                                      bytes(t))))
        return order[:k]
    out = (ctypes.c_int32 * k)()
    got = lib.dhtcore_xor_topk(_u8(ids), n, _u8(target), k, out)
    return list(out[:got])


class NativeRateLimiter:
    """Sliding 1 s window quota (ref: include/opendht/rate_limiter.h).

    Falls back to the pure-Python limiter when the library is absent.
    """

    def __init__(self, quota: int):
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.dhtcore_rate_limiter_new(quota)
        else:
            from ..utils.rate_limiter import RateLimiter
            self._py = RateLimiter(quota)

    def limit(self, now: float) -> bool:
        if self._lib is not None:
            return bool(self._lib.dhtcore_rate_limiter_limit(self._h, now))
        return self._py.limit(now)

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.dhtcore_rate_limiter_free(self._h)


def token_eq(a: bytes, b: bytes) -> bool:
    """Constant-time compare for write tokens."""
    lib = _load()
    if lib is None or len(a) != len(b):
        import hmac
        return hmac.compare_digest(a, b)
    return bool(lib.dhtcore_token_eq(_u8(a), _u8(b), len(a)))


def common_bits_batch(ids: bytes, n: int, target: bytes) -> list:
    """Common prefix bits of ``target`` vs each packed 20-byte row."""
    lib = _load()
    if lib is None:
        from ..utils.infohash import InfoHash
        t = InfoHash(target)
        return [InfoHash(ids[i * 20:(i + 1) * 20]).common_bits(t)
                for i in range(n)]
    out = (ctypes.c_int32 * n)()
    lib.dhtcore_common_bits_batch(_u8(ids), n, _u8(target), out)
    return list(out)


def xor_sort(ids: bytes, idx: list, target: bytes) -> list:
    """Sort indices into a packed id matrix by XOR distance to target."""
    lib = _load()
    if lib is None:
        t = bytes(target)
        return sorted(idx, key=lambda i: bytes(
            x ^ y for x, y in zip(ids[i * 20:(i + 1) * 20], t)))
    arr = (ctypes.c_int32 * len(idx))(*idx)
    lib.dhtcore_xor_sort(_u8(ids), arr, len(idx), _u8(target))
    return list(arr)
