"""The lookup engine's hand-written CUDA kernels, their wrappers and
their plain PyTorch versions.

* K1 :func:`merge_round` (``csrc/merge_round.cu``) replaces
  ``merge_round_pallas`` (``opendht_tpu/ops/pallas_kernels.py``): the
  per-round dedup + rank merge + quorum/exhaustion check.
* K2 :func:`fused_round` (``csrc/fused_round.cu``) replaces
  ``fused_round_pallas``: a whole round — window gather, member decode,
  queried/evict update and K1's merge — in one kernel.  K1 and K2 share
  the merge tail ``csrc/merge_core.cuh``, which holds a row's entries in
  the registers of a group of lanes (16 lanes — two rows a warp — for
  rows of at most 80 entries and, in K2, at most 16 solicitations; else
  a whole warp: the C launcher picks it from the shape) and takes rows
  of at most :data:`MERGE_MAX_W` = 128 entries.
* K3 :func:`nearest_k_ids` (``csrc/nearest_k.cu``) replaces the
  streaming k-best Pallas kernel of the same name: the exact k
  XOR-nearest valid rows per target, the recall ground truth; K3′
  :func:`nearest_ids` (``nearest_ids`` there) is its k=1 call, clipped.

A wrapper given CPU tensors runs the plain version (``*_plain``), which
the tests hold against the JAX package.  Given CUDA tensors it launches
the kernel, or raises: there is no fallback.  Each launch adds one to
its entry in :data:`LAUNCHES`.  A call made while a CUDA graph is being
captured launches nothing and adds one to :data:`CAPTURED` instead;
whoever replays the graph adds the graph's counts to :data:`LAUNCHES`
a replay (:func:`count_replay`).

The kernels are compiled at first use by ``nvcc`` for ``sm_90a`` into
plain C-interface shared libraries under ``opendht_tpu_torch/build/``
(one ``nvcc`` per source, all started together) and bound with
``ctypes``; each C entry point launches on the caller's stream and
returns ``cudaGetLastError()``.  A library is named after a hash of its
source and every ``csrc/*.cuh`` header, so an edited source or header
never loads a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

from .round_parts import (fold_solicitations, gather_pair_windows,
                          unpack_pair_window)
from .u32 import lexsort
from .xor_metric import N_LIMBS, rank_merge_round_d0

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = {"merge_round": "merge_round.cu", "fused_round": "fused_round.cu",
           "nearest_k": "nearest_k.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches per wrapper since the last reset_launches().
LAUNCHES = {"merge_round": 0, "fused_round": 0, "nearest_k_ids": 0,
            "nearest_ids": 0}
# Launches recorded into CUDA graphs under capture (never reset: a
# capturer reads the difference across its capture).
CAPTURED = dict.fromkeys(LAUNCHES, 0)
# Libraries loaded by this process, by source (never reset: graftlint's
# budget plane holds each to one).
BUILDS = dict.fromkeys(SOURCES, 0)

# K1 and K2 take rows of at most this many entries (S + C): four per lane
# of a warp (kMaxW in csrc/merge_core.cuh).
MERGE_MAX_W = 128
# K2 loads a row's solicitations one per lane of its row group.
FUSED_MAX_ALPHA = 32
# K3 supports k up to this (a private sorted list per thread, in registers).
# Its grid, chunking and scratch layout live in csrc/nearest_k.cu alone:
# the wrapper asks the library how much scratch a call needs.
NEAREST_MAX_K = 16

_libs: dict = {}
build_logs: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count(name: str) -> None:
    """One launch of ``name``'s kernel, or one recorded into the graph
    being captured on the current stream."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


def count_replay(counts: dict) -> None:
    """A replay of a captured graph launched ``counts[name]`` kernels of
    each wrapper (the :data:`CAPTURED` difference across its capture)."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to "
                           "build the opendht_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def source_digest(src: str) -> str:
    """Hash of the source ``csrc/<src>`` and of every ``csrc/*.cuh``
    header (names and bytes): the key a library is built under."""
    h = hashlib.sha1()
    for path in [CSRC / src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:12]


def build_kernels() -> float:
    """Compile (if needed) and load every kernel library; returns the
    wall seconds spent.  Each source builds into
    ``build/<name>-<source_digest>.so``, written under a temporary name
    and renamed, so an edited source or header never loads a stale
    library."""
    # graftlint: disable=host-call-in-jit (the build's own wall clock; every engine that captures builds the libraries before its capture (ResidentServeEngine._graph), so under a capture _lib finds them loaded and never calls this)
    t0 = time.perf_counter()
    pending = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, src in SOURCES.items():
        if name in _libs:
            continue
        path = CSRC / src
        digest = source_digest(src)
        so = BUILD_DIR / f"{name}-{digest}.so"
        if so.exists():
            pending[name] = (so, None)
            continue
        tmp = BUILD_DIR / f"{name}-{digest}.{os.getpid()}.tmp.so"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[name] = (so, (proc, tmp))
    errors = []
    for name, (so, job) in pending.items():      # wait for every build
        if job is not None:
            proc, tmp = job
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {SOURCES[name]}:\n{out}")
                continue
            os.replace(tmp, so)
        _libs[name] = _bind(name, ctypes.CDLL(str(so)))
        BUILDS[name] += 1
    if errors:
        raise RuntimeError("\n".join(errors))
    # graftlint: disable=host-call-in-jit (the build's own wall clock; never reached under a capture (see the build before each capture))
    return time.perf_counter() - t0


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "merge_round":
        fn = lib.merge_round_launch
        fn.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, i, i, p]
    elif name == "fused_round":
        fn = lib.fused_round_launch
        fn.argtypes = [p, ll, i, p, p, p, p, p, p, p, p, p, p, p, p, p, p,
                       ll, i, i, i, i, i, p]
    else:
        fn = lib.nearest_k_launch
        fn.argtypes = [p, p, p, ll, ll, i, p, ll, p, p]
        lib.nearest_k_scratch_words.argtypes = [ll, ll, i]
        lib.nearest_k_scratch_words.restype = ll
    fn.restype = ctypes.c_int
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_kernels()
    return _libs[name]


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# K1: round merge
# ---------------------------------------------------------------------------

def round_done(idx: torch.Tensor, queried: torch.Tensor,
               quorum: int) -> torch.Tensor:
    """A row is done when its ``quorum`` closest known nodes are all
    queried (and at least one is known), or when nothing known is left
    unqueried — ``_sync_done`` plus the exhaustion exit."""
    head_v = idx[:, :quorum] >= 0
    synced = (torch.all(queried[:, :quorum] | ~head_v, dim=1)
              & torch.any(head_v, dim=1))
    exhausted = ~torch.any((idx >= 0) & ~queried, dim=1)
    return synced | exhausted


def merge_round_plain(fr_idx, fr_d0, fr_q, resp_idx, resp_d0, *,
                      quorum: int, keep: int):
    """Plain version of K1: the rank merge plus the done rule."""
    o_idx, o_d0, o_q = rank_merge_round_d0(fr_idx, fr_d0, fr_q, resp_idx,
                                           resp_d0, keep)
    return o_idx, o_d0, o_q, round_done(o_idx, o_q, quorum)


def merge_round(fr_idx: torch.Tensor, fr_d0: torch.Tensor,
                fr_q: torch.Tensor, resp_idx: torch.Tensor,
                resp_d0: torch.Tensor, *, quorum: int, keep: int):
    """One lookup round's merge: join the frontier ``[L,S]`` (idx int32,
    d0 int64, queried bool) with the responses ``[L,C]`` (idx int32,
    d0 int64), drop duplicates (first copy wins) and empties, keep the
    ``min(keep, S+C)`` best under ``(d0, idx_u, ordinal)``, and emit the
    ``[L]`` done bit.  Returns ``(idx, d0, queried, done)``."""
    if fr_idx.device.type == "cpu":
        return merge_round_plain(fr_idx, fr_d0, fr_q, resp_idx, resp_d0,
                                 quorum=quorum, keep=keep)
    if fr_idx.device.type != "cuda":
        raise ValueError(f"merge_round: unsupported device {fr_idx.device}")
    dev = fr_idx.device
    l, s = fr_idx.shape
    c = resp_idx.shape[1]
    _check(fr_idx, "fr_idx", torch.int32, (l, s), dev)
    _check(fr_d0, "fr_d0", torch.int64, (l, s), dev)
    _check(fr_q, "fr_q", torch.bool, (l, s), dev)
    _check(resp_idx, "resp_idx", torch.int32, (l, c), dev)
    _check(resp_d0, "resp_d0", torch.int64, (l, c), dev)
    if not 0 < s + c <= MERGE_MAX_W:
        raise ValueError(f"merge_round kernel takes 0 < S+C <= "
                         f"{MERGE_MAX_W}, got {s + c}")
    if keep < 1 or quorum < 1:
        raise ValueError("merge_round needs keep >= 1 and quorum >= 1")
    out_w = min(keep, s + c)
    o_idx = torch.empty((l, out_w), dtype=torch.int32, device=dev)
    o_d0 = torch.empty((l, out_w), dtype=torch.int64, device=dev)
    o_q = torch.empty((l, out_w), dtype=torch.bool, device=dev)
    done = torch.empty((l,), dtype=torch.bool, device=dev)
    if l == 0:
        return o_idx, o_d0, o_q, done
    lib = _lib("merge_round")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.merge_round_launch(
            fr_idx.data_ptr(), fr_d0.data_ptr(), fr_q.data_ptr(),
            resp_idx.data_ptr(), resp_d0.data_ptr(), o_idx.data_ptr(),
            o_d0.data_ptr(), o_q.data_ptr(), done.data_ptr(), l, s, c,
            out_w, min(quorum, out_w), stream)
    _raise_on(rc, "merge_round")
    _count("merge_round")
    return o_idx, o_d0, o_q, done


# ---------------------------------------------------------------------------
# K2: the whole round
# ---------------------------------------------------------------------------

def fused_round_plain(tables, targets0, fr_idx, fr_d0, fr_q, safe_sel,
                      sel_d0, sel_pos, w0, q_hit, e_hit, *, bucket_k: int,
                      quorum: int, keep: int):
    """Plain version of K2, from the engine's own pieces: the bucket-pair
    window gather (window 0 where ``w0`` lies outside ``[1, b_total-2]``,
    the Pallas select chain's fall-through, while the decode keeps the
    raw ``w0``), the member decode, the queried/evict fold and K1's
    plain version.  ``b_total`` comes from the padded row width."""
    n, row_w = tables.shape
    l, a = safe_sel.shape
    k = bucket_k
    b_total = row_w // (3 * k)
    rows = safe_sel.to(torch.int64).clamp(0, n - 1)
    w0 = w0.to(torch.int64)
    start = torch.where((w0 >= 1) & (w0 <= b_total - 2), w0, 0)
    win = gather_pair_windows(tables, rows, start, k)           # [L,A,6K]
    idx, d0 = unpack_pair_window(win.view(l, a, 2, 3 * k), w0, targets0,
                                 sel_d0, q_hit, k)
    f_idx, f_d0, f_q = fold_solicitations(fr_idx, fr_d0, fr_q, sel_pos,
                                          q_hit, e_hit)
    return merge_round_plain(f_idx, f_d0, f_q, idx.reshape(l, -1),
                             d0.reshape(l, -1), quorum=quorum, keep=keep)


def fused_round(tables: torch.Tensor, targets0: torch.Tensor,
                fr_idx: torch.Tensor, fr_d0: torch.Tensor,
                fr_q: torch.Tensor, safe_sel: torch.Tensor,
                sel_d0: torch.Tensor, sel_pos: torch.Tensor,
                w0: torch.Tensor, q_hit: torch.Tensor, e_hit: torch.Tensor,
                *, bucket_k: int, quorum: int, keep: int):
    """One whole lookup round (``fused_round_pallas``'s arguments):
    ``tables [N,row_w]`` uint16 augmented rows, ``targets0 [L]`` int64
    (the targets' first limbs), the frontier ``fr_idx/fr_d0/fr_q [L,S]``
    (int32, int64, bool) and the prelude ``[L,A]``: ``safe_sel`` int32
    (solicited rows, clipped to ``[0, N-1]``), ``sel_d0`` int64,
    ``sel_pos`` int32 (-1 = no slot), ``w0`` int32 (bucket-pair start),
    ``q_hit``/``e_hit`` bool.  Returns ``(idx, d0, queried, done)`` as
    :func:`merge_round` does, at ``out_w = min(keep, S + 2·K·A)``."""
    if tables.device.type == "cpu":
        return fused_round_plain(
            tables, targets0, fr_idx, fr_d0, fr_q, safe_sel, sel_d0,
            sel_pos, w0, q_hit, e_hit, bucket_k=bucket_k, quorum=quorum,
            keep=keep)
    if tables.device.type != "cuda":
        raise ValueError(f"fused_round: unsupported device {tables.device}")
    dev = tables.device
    if tables.dim() != 2:
        raise ValueError("tables must be [N, row_w]")
    n, row_w = tables.shape
    l, s = fr_idx.shape
    a = safe_sel.shape[1] if safe_sel.dim() == 2 else -1
    k = bucket_k
    _check(tables, "tables", torch.uint16, (n, row_w), dev)
    _check(targets0, "targets0", torch.int64, (l,), dev)
    _check(fr_idx, "fr_idx", torch.int32, (l, s), dev)
    _check(fr_d0, "fr_d0", torch.int64, (l, s), dev)
    _check(fr_q, "fr_q", torch.bool, (l, s), dev)
    _check(safe_sel, "safe_sel", torch.int32, (l, a), dev)
    _check(sel_d0, "sel_d0", torch.int64, (l, a), dev)
    _check(sel_pos, "sel_pos", torch.int32, (l, a), dev)
    _check(w0, "w0", torch.int32, (l, a), dev)
    _check(q_hit, "q_hit", torch.bool, (l, a), dev)
    _check(e_hit, "e_hit", torch.bool, (l, a), dev)
    if not 1 <= a <= FUSED_MAX_ALPHA:
        raise ValueError(f"fused_round kernel takes 1 <= A <= "
                         f"{FUSED_MAX_ALPHA}, got {a}")
    if k < 1 or row_w // (3 * k) < 2 or n < 1:
        raise ValueError("fused_round needs K >= 1, a row of at least two "
                         "buckets and at least one node")
    c = 2 * k * a
    if not 0 < s + c <= MERGE_MAX_W:
        raise ValueError(f"fused_round kernel takes 0 < S+2KA <= "
                         f"{MERGE_MAX_W}, got {s + c}")
    if keep < 1 or quorum < 1:
        raise ValueError("fused_round needs keep >= 1 and quorum >= 1")
    out_w = min(keep, s + c)
    o_idx = torch.empty((l, out_w), dtype=torch.int32, device=dev)
    o_d0 = torch.empty((l, out_w), dtype=torch.int64, device=dev)
    o_q = torch.empty((l, out_w), dtype=torch.bool, device=dev)
    done = torch.empty((l,), dtype=torch.bool, device=dev)
    if l == 0:
        return o_idx, o_d0, o_q, done
    lib = _lib("fused_round")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_round_launch(
            tables.data_ptr(), n, row_w, targets0.data_ptr(),
            fr_idx.data_ptr(), fr_d0.data_ptr(), fr_q.data_ptr(),
            safe_sel.data_ptr(), sel_d0.data_ptr(), sel_pos.data_ptr(),
            w0.data_ptr(), q_hit.data_ptr(), e_hit.data_ptr(),
            o_idx.data_ptr(), o_d0.data_ptr(), o_q.data_ptr(),
            done.data_ptr(), l, s, a, k, out_w, min(quorum, out_w), stream)
    _raise_on(rc, "fused_round")
    _count("fused_round")
    return o_idx, o_d0, o_q, done


# ---------------------------------------------------------------------------
# K3: exact k-nearest
# ---------------------------------------------------------------------------

def _dist_sort_keys(d: torch.Tensor):
    """Three int64 order keys of 160-bit distances ``[..., 5]``:
    ``d0‖d1`` and ``d2‖d3`` sign-flipped (signed order = unsigned
    order), then ``d4``."""
    flip = -(2**63)
    k01 = ((d[..., 0] << 32) | d[..., 1]) ^ flip
    k23 = ((d[..., 2] << 32) | d[..., 3]) ^ flip
    return k01, k23, d[..., 4]


def nearest_k_ids_plain(ids: torch.Tensor, targets: torch.Tensor, k: int,
                        *, valid: torch.Tensor | None = None,
                        chunk: int = 1 << 16) -> torch.Tensor:
    """Plain version of K3: exact, streamed over ``chunk``-row slices of
    ``ids``.  Each slice's candidates join the running best ``k`` and
    are re-ranked by a stable sort on ``(invalid, distance, index)``;
    the running list holds lower indices than the slice, so stability
    gives the index tiebreak.  ``-1`` marks places past the valid
    rows."""
    n, l = ids.shape[0], targets.shape[0]
    dev = ids.device
    best_i = torch.full((l, 0), -1, dtype=torch.int64, device=dev)
    best_keys = [torch.empty((l, 0), dtype=torch.int64, device=dev)
                 for _ in range(4)]
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        d = ids[None, lo:hi, :] ^ targets[:, None, :]          # [L,c,5]
        inval = torch.zeros((l, hi - lo), dtype=torch.int64, device=dev)
        if valid is not None:
            inval = inval + (~valid[lo:hi]).to(torch.int64)[None, :]
        keys = [inval, *_dist_sort_keys(d)]
        cand_i = torch.arange(lo, hi, device=dev).expand(l, -1)
        keys = [torch.cat([b, c], dim=1) for b, c in zip(best_keys, keys)]
        cand_i = torch.cat([best_i, cand_i], dim=1)
        perm = lexsort(keys, dim=1)[:, :k]
        best_keys = [torch.gather(x, 1, perm) for x in keys]
        best_i = torch.gather(cand_i, 1, perm)
    out = torch.where(best_keys[0] == 0, best_i, -1)
    if out.shape[1] < k:
        out = torch.cat([out, out.new_full((l, k - out.shape[1]), -1)], 1)
    return out.to(torch.int32)


def nearest_k_ids(ids: torch.Tensor, targets: torch.Tensor, k: int = 8, *,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact k XOR-closest valid rows of ``ids [N,5]`` (int64 limbs) per
    target ``[L,5]`` → ``[L,k]`` int32, closest first, ties by index,
    ``-1`` where fewer than ``k`` valid rows exist."""
    if ids.device.type == "cpu":
        return nearest_k_ids_plain(ids, targets, k, valid=valid)
    return _nearest_k_launch(ids, targets, k, valid, "nearest_k_ids")


def nearest_ids_plain(ids: torch.Tensor, targets: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of K3′: the k=1 plain K3, clipped to ``[0, N-1]``."""
    res = nearest_k_ids_plain(ids, targets, 1)
    return res[:, 0].clamp(0, max(ids.shape[0] - 1, 0))


def nearest_ids(ids: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Index of the exact XOR-nearest row of ``ids [N,5]`` per target
    ``[L,5]`` → ``[L]`` int32: the K3 kernel at k=1, clipped to
    ``[0, N-1]`` (``nearest_ids`` of the Pallas kernels)."""
    if ids.device.type == "cpu":
        return nearest_ids_plain(ids, targets)
    out = _nearest_k_launch(ids, targets, 1, None, "nearest_ids")
    return out[:, 0].clamp(0, max(ids.shape[0] - 1, 0))


def _nearest_k_launch(ids: torch.Tensor, targets: torch.Tensor, k: int,
                      valid: torch.Tensor | None, name: str) -> torch.Tensor:
    """Check the arguments and launch the K3 kernels on CUDA tensors,
    counting the launch under ``LAUNCHES[name]``."""
    if ids.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ids.device}")
    dev = ids.device
    n, l = ids.shape[0], targets.shape[0]
    _check(ids, "ids", torch.int64, (n, N_LIMBS), dev)
    _check(targets, "targets", torch.int64, (l, N_LIMBS), dev)
    if valid is not None:
        _check(valid, "valid", torch.bool, (n,), dev)
    if not 1 <= k <= NEAREST_MAX_K:
        raise ValueError(f"nearest_k_ids kernel takes 1 <= k <= "
                         f"{NEAREST_MAX_K}, got {k}")
    if n >= 2**31:
        raise ValueError(f"nearest_k_ids kernel takes fewer than 2^31 rows, "
                         f"got {n}")
    out = torch.empty((l, k), dtype=torch.int32, device=dev)
    if l == 0:
        return out
    if n == 0:
        return out.fill_(-1)
    lib = _lib("nearest_k")
    with torch.cuda.device(dev):
        words = lib.nearest_k_scratch_words(n, l, k)
        scratch = torch.empty((words,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nearest_k_launch(
            ids.data_ptr(), targets.data_ptr(),
            None if valid is None else valid.data_ptr(), n, l, k,
            scratch.data_ptr(), words, out.data_ptr(), stream)
    _raise_on(rc, name)
    _count(name)
    return out
