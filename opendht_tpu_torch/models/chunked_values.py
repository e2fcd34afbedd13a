"""Variable-size values on the device store: one value across several
fixed-width slots of the same replica.

Counterpart of ``opendht_tpu/models/chunked_values.py``.  A value of
any byte length up to ``parts·4·W`` (``W = StoreConfig.payload_words``)
is stored as ``ceil(words / W)`` parts:

* **part keys** — part ``j`` is stored under ``key XOR j`` in limb 4
  (:func:`part_key`).  Routing reads limb 0, so every part has the same
  closest nodes: one lookup a value, the parts side by side on each
  replica;
* **length** — part 0's ``size`` records the value's byte length;
  parts 1.. carry size 1.  A reader recovers the part count from part
  0 alone;
* **consistency** — a read needs every part the length asks for to
  carry part 0's ``(val, seq)``: a torn multi-part write reads as
  MISSING, never as garbled bytes.

Integrity (``StoreConfig.verify``) is a hash list: the base key is
``SHA-1(SHA-1(part_0) ‖ … ‖ SHA-1(part_{parts-1}) ‖ len)`` over the
canonical form (:func:`mask_chunk_payloads`: inactive parts and words
past the value's end zeroed).  Parts insert and are probed with the
per-slot digest check off (a part key is derived from the base key,
not from the part's bytes); the reader re-derives the root from the
reassembled parts (:func:`_chunked_root_ok`), so one forged part makes
the value read as missing.

Layout: the listener delivery planes are the port's shaped ones
(``nseqs``/``nvals``/``nsizes [max_listeners]``, ``npayload
[max_listeners, W]``), indexed at ``rid·parts + j`` as the JAX store's
are.  Every entry point that runs a lookup takes ``generator`` (origins
drawn from alive nodes) or ``origins=`` and a ``device``, as
:mod:`opendht_tpu_torch.models.storage` does.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.sha1 import sha1_words
from .storage import (
    AnnounceReport,
    StoreConfig,
    SwarmStore,
    _announce_insert,
    _listen_insert,
    _now,
    _sliced_probe,
    _wrap_i32,
    ack_listeners,
    cancel_listen,
)
from .swarm import Swarm, SwarmConfig, lookup


class ChunkedGetResult(NamedTuple):
    hit: torch.Tensor      # [P] bool — value completely reassembled
    val: torch.Tensor      # [P] value token
    seq: torch.Tensor      # [P]
    length: torch.Tensor   # [P] true byte length
    payload: torch.Tensor  # [P, parts*W] reassembled words
    hops: torch.Tensor     # [P]
    done: torch.Tensor     # [P]


class ChunkedCollectResult(NamedTuple):
    """One collected listener delivery, reassembled from its per-part
    delivery slots."""
    ready: torch.Tensor    # [P] bool — a complete value was delivered
    val: torch.Tensor      # [P]
    seq: torch.Tensor      # [P]
    length: torch.Tensor   # [P] true byte length
    payload: torch.Tensor  # [P, parts*W]


def mask_chunk_payloads(payloads: torch.Tensor, lengths: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical chunk form: ``lengths [P]`` clamped to what ``payloads
    [P, parts, W]`` can hold, every word at or past a value's end
    zeroed."""
    p, parts, w = payloads.shape
    lengths = lengths.to(payloads.device).clamp(max=parts * w * 4)
    words = -(-_wrap_i32(lengths) // 4)                          # [P]
    idx = torch.arange(parts * w, device=payloads.device).reshape(parts, w)
    masked = torch.where(idx[None] < words[:, None, None], payloads, 0)
    return masked, lengths


def _root_ids(payloads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Hash-list root: per-part SHA-1 over the canonical form, then SHA-1
    over the digest list and the byte length."""
    p, parts, w = payloads.shape
    masked, lengths = mask_chunk_payloads(payloads, lengths)
    digests = sha1_words(masked)                                 # [P,parts,5]
    msg = torch.cat([digests.reshape(p, parts * 5), lengths[:, None]], dim=1)
    return sha1_words(msg)


def chunked_content_ids(payloads: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Content-addressed base keys ``[P, 5]`` of chunked values
    ``payloads [P, parts, W]`` / ``lengths [P]`` (the hash-list root)."""
    return _root_ids(payloads, lengths)


def _chunked_root_ok(keys: torch.Tensor, payloads: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Reader-side check: does the reassembled value hash back to its
    claimed base key?"""
    return (_root_ids(payloads, lengths) == keys).all(dim=-1)


def chunked_content_ids_host(payloads, lengths) -> np.ndarray:
    """The ``hashlib`` twin of :func:`chunked_content_ids` for ``[P,
    parts, W]`` uint32 payloads (numpy or tensors)."""
    if isinstance(payloads, torch.Tensor):
        payloads = payloads.cpu().numpy()
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu().numpy()
    pl = np.ascontiguousarray(np.asarray(payloads).astype(np.uint32))
    if pl.ndim == 2:
        pl = pl[None]
    p, parts, w = pl.shape
    lengths = np.minimum(np.asarray(lengths).astype(np.uint32).reshape(p),
                         np.uint32(parts * w * 4))
    words = -(-lengths.astype(np.int64) // 4)
    idx = np.arange(parts * w).reshape(parts, w)
    masked = np.where(idx[None] < words[:, None, None], pl, 0).astype(">u4")
    out = np.zeros((p, 5), np.uint32)
    for i in range(p):
        msg = b"".join(hashlib.sha1(masked[i, j].tobytes()).digest()
                       for j in range(parts))
        msg += np.array([lengths[i]], dtype=">u4").tobytes()
        d = hashlib.sha1(msg).digest()
        out[i] = np.frombuffer(d, dtype=">u4").astype(np.uint32)
    return out


def part_key(keys: torch.Tensor, j: int) -> torch.Tensor:
    """Storage key of part ``j``: the base key with ``j`` XORed into
    limb 4 (the low 32 id bits) — the same routing prefix."""
    if j == 0:
        return keys
    out = keys.clone()
    out[:, 4] ^= j
    return out


def announce_chunked(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                     scfg: StoreConfig, keys: torch.Tensor,
                     vals: torch.Tensor, seqs: torch.Tensor, now,
                     generator: torch.Generator | None,
                     payloads: torch.Tensor, lengths: torch.Tensor, *,
                     origins: torch.Tensor | None = None,
                     part_drop_mask: torch.Tensor | None = None,
                     part_range: Tuple[int, int] | None = None,
                     device=None) -> Tuple[SwarmStore, AnnounceReport]:
    """Batched put of variable-size values ``payloads [P, parts, W]``
    with byte ``lengths [P]``: one lookup a value, then one storage
    insert a part at its part key on the same replicas.  Part 0 is
    stored for every announce, so a zero-length value reads back as a
    hit with an empty payload.  ``replicas`` counts the replicas that
    accepted part 0; the trace is the sum of the parts' traces.

    Two fault knobs for torn writes (the single-device form of the
    sharded JAX twin's): ``part_drop_mask [P, parts]`` (True: that part
    of that value is not announced) and ``part_range=(lo, hi)`` (only
    parts ``lo <= j < hi`` are announced: a writer killed between
    parts; ``replicas`` is 0 when part 0 is outside).  With neither,
    the store, report and trace equal the JAX function's."""
    p, parts, w = payloads.shape
    if w != scfg.payload_words:
        raise ValueError(f"payloads have {w} words a part, the store "
                         f"{scfg.payload_words}")
    lo, hi = part_range if part_range is not None else (0, parts)
    if not 0 <= lo < hi <= parts:
        raise ValueError(f"part_range {(lo, hi)} outside 0..{parts}")
    res = lookup(swarm, cfg, keys, generator, origins=origins, device=device)
    payloads, lengths = mask_chunk_payloads(payloads, lengths)
    words = -(-_wrap_i32(lengths) // 4)                          # [P]
    part_scfg = scfg._replace(verify=False)
    rep0 = torch.zeros((p,), dtype=torch.int32, device=keys.device)
    trace = None
    for j in range(lo, hi):
        active = (words > j * w) | (j == 0)
        if part_drop_mask is not None:
            active = active & ~part_drop_mask[:, j].to(active.device)
        found_j = torch.where(active[:, None], res.found, -1)
        sizes_j = lengths if j == 0 else torch.ones_like(lengths)
        store, rep, tr = _announce_insert(
            swarm.alive, cfg, store, part_scfg, found_j, part_key(keys, j),
            vals, seqs, now, sizes_j, None, payloads[:, j])
        trace = tr if trace is None else trace + tr
        if j == 0:
            rep0 = rep
    return store, AnnounceReport(replicas=rep0, hops=res.hops,
                                 done=res.done, trace=trace)


def get_chunked(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                scfg: StoreConfig, keys: torch.Tensor,
                generator: torch.Generator | None, parts: int, *,
                origins: torch.Tensor | None = None,
                device=None) -> ChunkedGetResult:
    """Batched get of variable-size values: one lookup, a quorum probe
    a part, exact reassembly.  A value is a hit iff part 0 is found and
    every part its length needs is found with part 0's ``(val, seq)``;
    with ``scfg.verify`` it must also hash back to its key.  Anything
    else reads as missing (zeros), never as garbled bytes."""
    p = keys.shape[0]
    w = scfg.payload_words
    part_scfg = scfg._replace(verify=False)
    res = lookup(swarm, cfg, keys, generator, origins=origins, device=device)
    h0, val, seq, pl0, sz = _sliced_probe(swarm.alive, cfg, store,
                                          part_scfg, res.found, keys)
    need_words = -(-_wrap_i32(sz) // 4)                          # [P]
    n_parts = (-(-need_words // max(w, 1))).clamp(1, parts)
    # A value longer than ``parts`` parts reads as missing, never
    # truncated.
    ok = h0 & (need_words <= parts * w)
    pls = [pl0]
    for j in range(1, parts):
        hj, vj, sj, plj, _ = _sliced_probe(swarm.alive, cfg, store,
                                           part_scfg, res.found,
                                           part_key(keys, j))
        needed = n_parts > j
        ok = ok & (~needed | (hj & (vj == val) & (sj == seq)))
        pls.append(torch.where(needed[:, None], plj, 0))
    payload = torch.cat(pls, dim=1)                              # [P,parts*W]
    idx = torch.arange(parts * w, device=payload.device)[None, :]
    payload = torch.where(idx < need_words[:, None], payload, 0)
    if scfg.verify:
        ok = ok & _chunked_root_ok(keys, payload.reshape(p, parts, w), sz)
    payload = torch.where(ok[:, None], payload, 0)
    return ChunkedGetResult(
        hit=ok, val=torch.where(ok, val, 0), seq=torch.where(ok, seq, 0),
        length=torch.where(ok, sz, 0), payload=payload,
        hops=res.hops, done=res.done)


# ---------------------------------------------------------------------------
# chunked listeners
# ---------------------------------------------------------------------------

def chunked_reg_ids(reg_ids: torch.Tensor, parts: int) -> torch.Tensor:
    """The per-part registration ids of chunked listeners: logical id
    ``r`` owns delivery slots ``r·parts … r·parts + parts - 1``; negative
    ids stay -1.  Returns the flat ``[P·parts]`` int32 vector."""
    rid = reg_ids.to(torch.int32)
    block = rid[:, None] * parts + torch.arange(parts, dtype=torch.int32,
                                                device=rid.device)
    return torch.where(rid[:, None] >= 0, block, -1).reshape(-1)


def listen_chunked(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                   scfg: StoreConfig, keys: torch.Tensor,
                   reg_ids: torch.Tensor, generator: torch.Generator | None,
                   parts: int, now=0, *, origins: torch.Tensor | None = None,
                   device=None) -> Tuple[SwarmStore, torch.Tensor]:
    """Register chunked listeners: one lookup a base key, then one
    listener insert covering every part key, so a node holds a chunked
    registration whole or not at all (one key's part keys sort side by
    side).  Returns ``(store, done [P])``; the store is updated in
    place."""
    res = lookup(swarm, cfg, keys, generator, origins=origins, device=device)
    rid = reg_ids.to(torch.int32).to(keys.device)
    found_b = res.found.repeat(parts, 1)
    keys_b = torch.cat([part_key(keys, j) for j in range(parts)])
    rid_b = torch.cat([torch.where(rid >= 0, rid * parts + j, -1)
                       for j in range(parts)])
    store = _listen_insert(swarm.alive, cfg, store, scfg, found_b, keys_b,
                           rid_b, _now(now))
    return store, res.done


def collect_chunked(store: SwarmStore, scfg: StoreConfig,
                    reg_ids: torch.Tensor, parts: int,
                    keys: Optional[torch.Tensor] = None
                    ) -> ChunkedCollectResult:
    """Reassemble delivered chunked values from the listener slots
    ``rid·parts + j``: ready iff part 0 was delivered and every needed
    part was delivered with part 0's ``(val, seq)``; with
    ``scfg.verify`` and the base ``keys [P, 5]`` given, the value must
    also hash back to its key.  A torn delivery is not ready, never
    garbled.  Pair with :func:`ack_chunked`."""
    w = scfg.payload_words
    ml = scfg.max_listeners
    rid = reg_ids.to(store.nseqs.device).to(torch.int32)
    p = rid.shape[0]
    slot0 = rid * parts
    valid = (rid >= 0) & (slot0 + parts <= ml)
    s0 = slot0.clamp(0, ml - 1).long()
    nseq0 = store.nseqs[s0]                  # delivered seq + 1, 0 = none
    val0 = store.nvals[s0]
    sz = store.nsizes[s0]
    need_words = -(-_wrap_i32(sz) // 4)
    n_parts = (-(-need_words // max(w, 1))).clamp(1, parts)
    ready = valid & (nseq0 > 0) & (need_words <= parts * w)
    pls = [store.npayload[s0]]
    for j in range(1, parts):
        sj = (slot0 + j).clamp(0, ml - 1).long()
        needed = n_parts > j
        same = (store.nseqs[sj] == nseq0) & (store.nvals[sj] == val0)
        ready = ready & (~needed | same)
        pls.append(torch.where(needed[:, None], store.npayload[sj], 0))
    payload = torch.cat(pls, dim=1)
    idx = torch.arange(parts * w, device=payload.device)[None, :]
    payload = torch.where(idx < need_words[:, None], payload, 0)
    if scfg.verify and keys is not None:
        ready = ready & _chunked_root_ok(keys, payload.reshape(p, parts, w),
                                         sz)
    payload = torch.where(ready[:, None], payload, 0)
    return ChunkedCollectResult(
        ready=ready, val=torch.where(ready, val0, 0),
        seq=torch.where(ready, nseq0 - 1, 0),
        length=torch.where(ready, sz, 0), payload=payload)


def ack_chunked(store: SwarmStore, reg_ids: torch.Tensor,
                parts: int) -> SwarmStore:
    """Consume whole chunked listeners' delivery slots (all parts)."""
    return ack_listeners(store, chunked_reg_ids(reg_ids, parts))


def cancel_chunked(store: SwarmStore, scfg: StoreConfig,
                   reg_ids: torch.Tensor, parts: int) -> SwarmStore:
    """Cancel whole chunked listeners everywhere: every part's table
    rows die and the per-part delivery slots clear."""
    return cancel_listen(store, scfg, chunked_reg_ids(reg_ids, parts))
