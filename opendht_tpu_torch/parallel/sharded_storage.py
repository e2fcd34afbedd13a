"""Mesh-sharded value storage: announce / get / republish / listen over a
node-sharded store, over ``torch.distributed``.

Counterpart of ``opendht_tpu/parallel/sharded_storage.py``.  The
single-device store (:mod:`opendht_tpu_torch.models.storage`) keeps
every node's value slots in ``[N, S]`` tensors; here each rank holds
its node rows ``[r·N/D, (r+1)·N/D)`` of those leaves (``keys``,
``vals``, ``seqs``, ``created``, ``used``, ``cursor``, the listener
table ``lkeys`` / ``lids`` / ``lexps`` / ``lcursor``, ``sizes``,
``ttls``, ``payload``), and the listener delivery tables
(``notified``, ``nseqs``, ``nvals``, ``npayload``, ``nsizes``) whole,
the same on every rank (:func:`shard_store`).

Every op has the sharded lookup's two-phase shape:

1. the routed lock-step lookup finds each key's ``quorum`` closest nodes
   (:func:`~opendht_tpu_torch.parallel.sharded.sharded_lookup`);
2. storage requests — ``(owner-local row, key, value, seq, size, ttl,
   bytes)`` for announce, ``(row, key)`` probes for get, ``(row, key,
   id)`` for listen — ship to the owning rank in the fixed-capacity
   buckets of the routed lookup (:func:`_route_out`, one
   ``all_to_all``), are applied to or answered from the local store
   shard, and the per-request outcome ships back (:func:`_route_back`).

Requests past an owner's capacity are dropped for the round, costing a
replica or a probe.  The wire is int32, u32 values bitcast as the JAX
package's ``_u2i`` does, so a bucket holds the same request at the same
position as JAX's and drops the same ones.  Listener delivery tables
diverge on the ranks during an insert and merge right after it
(:func:`_merge_listener_state`).

Keys, values, origins and every per-put result are this rank's rows of
the batch (JAX's ``P(AXIS)``); the sweep counters of a
:class:`~opendht_tpu_torch.models.storage.StoreTrace` are mesh-global.
Randomness is an argument, as in the local store: ``origins`` (or a
``generator``), and ``drop_keep`` (or a ``drop_generator``) for the
storage-RPC loss.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from ..models.chunked_values import (
    ChunkedGetResult,
    _chunked_root_ok,
    ack_chunked,
    cancel_chunked,
    collect_chunked,
    mask_chunk_payloads,
    part_key,
)
from ..models.storage import (
    NODE_LEAVES,
    PROBE_CHUNK,
    AnnounceReport,
    GetResult,
    StoreConfig,
    StoreTrace,
    SwarmStore,
    _key_match,
    _listen_apply,
    _now,
    _payload_digest,
    _pick_payload,
    _store_insert,
    _wrap_i32,
    ack_listeners,
    cancel_listen,
    drop_exchanges,
    empty_store,
    expire,
    expire_listeners,
    refresh_listeners,
    validate_store_geometry,
)
from ..models.swarm import Swarm, SwarmConfig
from ..ops.sha1 import sha1_words
from ..ops.u32 import as_i32, as_u32
from ..ops.xor_metric import N_LIMBS
from .mesh import Mesh
from .sharded import _bucketize, _fill_buckets, _origins, sharded_lookup

# Probes an owner answers at once: bounds the verified probe's
# [rows, S, W] planes (a local get's PROBE_CHUNK rows of a quorum each).
OWNER_PROBE_ROWS = PROBE_CHUNK * 8


# ---------------------------------------------------------------------------
# the store's layout
# ---------------------------------------------------------------------------

def shard_store(store: SwarmStore, mesh: Mesh) -> SwarmStore:
    """This rank's shard of a whole store (copies): its node rows of
    every node leaf, the delivery tables whole."""
    n = store.vals.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} nodes do not divide the {mesh.size}-rank "
                         f"mesh")
    m = n // mesh.size
    lo = mesh.rank * m
    return SwarmStore(**{
        f: (x[lo:lo + m] if f in NODE_LEAVES else x).to(mesh.device).clone()
        for f, x in zip(SwarmStore._fields, store)})


def sharded_empty_store(n_nodes: int, scfg: StoreConfig,
                        mesh: Mesh) -> SwarmStore:
    """This rank's shard of an empty ``n_nodes`` store (the geometry is
    checked against the whole store, as the JAX package checks it)."""
    validate_store_geometry(n_nodes, scfg)
    if n_nodes % mesh.size:
        raise ValueError(f"{n_nodes} nodes do not divide the {mesh.size}-"
                         f"rank mesh")
    return empty_store(n_nodes // mesh.size, scfg, device=mesh.device)


def _check_store(store: SwarmStore, cfg: SwarmConfig, mesh: Mesh) -> None:
    want = cfg.n_nodes // mesh.size
    if cfg.n_nodes % mesh.size or store.vals.shape[0] != want:
        raise ValueError(
            f"rank {mesh.rank} holds {store.vals.shape[0]} store rows; its "
            f"shard of {cfg.n_nodes} nodes over {mesh.size} ranks is "
            f"{want} (shard_store)")


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _cap_for(q: int, n_shards: int, capacity_factor: float) -> int:
    """Per-owner bucket capacity of a storage exchange of ``q``
    requests: ``min(q, max(1, ceil(q/D · cf)))``, or ``q`` uncapped."""
    if math.isfinite(capacity_factor):
        return min(q, max(1, int(math.ceil(q / n_shards
                                           * capacity_factor))))
    return q


def _route_out(mesh: Mesh, payload: torch.Tensor, owner: torch.Tensor,
               ok: torch.Tensor, cap: int):
    """Ship ``payload [Q, W]`` int32 rows to their owners in capacity-
    ``cap`` buckets (the routed lookup's sort-based bucketing).  Returns
    ``(rbuf [D, cap, W] — the requests this rank owns, by source rank —,
    pos, sent)``; rows past capacity have ``sent`` false."""
    src, pos, sent = _bucketize(owner, ok, mesh.size, cap)
    rbuf = mesh.all_to_all(_fill_buckets(payload, src, mesh.size, cap, -1))
    return rbuf, pos, sent


def _route_back(mesh: Mesh, resp: torch.Tensor, owner: torch.Tensor,
                pos: torch.Tensor, sent: torch.Tensor,
                cap: int) -> torch.Tensor:
    """The owners' answers ``resp [D, cap, W]`` back to the requests'
    rows ``[Q, W]``; unsent rows read -1."""
    back = mesh.all_to_all(resp)
    slot = owner * cap + pos.clamp(0, cap - 1)
    mine = back.reshape(mesh.size * cap, -1)[slot]
    return torch.where(sent[:, None], mine, -1)


def _targets(cfg: SwarmConfig, mesh: Mesh, alive: torch.Tensor,
             found: torch.Tensor):
    """Each replica request's ``(owner, owner-local row, ok)``: dead or
    empty replicas are not ok (their local row is -1)."""
    shard_n = cfg.n_nodes // mesh.size
    flat = found.reshape(-1).long()
    safe = flat.clamp(0, cfg.n_nodes - 1)
    ok = (flat >= 0) & alive[safe]
    owner = (safe // shard_n).clamp(0, mesh.size - 1)
    return owner, torch.where(ok, safe - owner * shard_n, -1), ok


def _col(x: torch.Tensor) -> torch.Tensor:
    """A u32 column (int64) as its int32 wire form."""
    return as_i32(x)[:, None] if x.dim() == 1 else as_i32(x)


def storage_wire_words(cfg: SwarmConfig, scfg: StoreConfig, p_per_shard: int,
                       n_shards: int, capacity_factor: float,
                       probe: bool = False,
                       full_capacity_factor: float | None = None) -> int:
    """Per-rank ``all_to_all`` words of one storage-insert exchange
    (:func:`_insert_routed`): the request buckets plus the one-word
    answer a slot.  Static: the buckets ship whole however full they
    are.  With ``probe`` a 10-word probe phase (9 request words with the
    payload digest, + 1 answer) is added and the full-value phase is
    provisioned at ``full_capacity_factor``."""
    q = p_per_shard * cfg.quorum
    w_full = 10 + scfg.payload_words + 1  # row+key5+val+seq+size+ttl+W, +ack
    if not probe:
        return _cap_for(q, n_shards, capacity_factor) * n_shards * w_full
    fcf = (capacity_factor if full_capacity_factor is None
           else full_capacity_factor)
    return (_cap_for(q, n_shards, capacity_factor) * n_shards * (9 + 1)
            + _cap_for(q, n_shards, fcf) * n_shards * w_full)


# ---------------------------------------------------------------------------
# the insert: probe / refresh, the routed store insert, listener merge
# ---------------------------------------------------------------------------

def _probe_refresh(store: SwarmStore, scfg: StoreConfig, r_node, r_key,
                   r_seq, r_val, r_dig, now: int):
    """Owner side of the two-phase announce: classify each probe against
    the local store and refresh matching replicas in place.  Status 0 —
    missing or stale (send the value), 1 — a fresh replica with the same
    token, seq and bytes (its ``created`` reset to ``now``), 2 — fresher
    or an equal-seq conflict (skip); -1 for an empty bucket slot.  ``r_dig``
    is the announcer's payload digest: a same-seq replica with other
    bytes is a conflict, never a completed replica."""
    rows = store.used.shape[0]
    n_safe = r_node.clamp(0, rows - 1)
    valid = r_node >= 0
    km = store.used[n_safe] & _key_match(store.keys, n_safe, r_key)
    has = km.any(dim=-1)
    mslot = torch.argmax(km.to(torch.uint8), dim=-1)        # first match
    cur_seq = store.seqs[n_safe, mslot]
    fresh = (valid & has & (cur_seq == r_seq)
             & (store.vals[n_safe, mslot] == r_val))
    if scfg.payload_words:
        fresh = fresh & (_payload_digest(store.payload[n_safe, mslot])
                         == r_dig)
    need_full = valid & (~has | (cur_seq < r_seq))
    status = torch.where(fresh, 1, torch.where(need_full, 0, 2))
    status = torch.where(valid, status, -1).to(torch.int32)
    # Refresh: duplicate probes of one slot all write max(old, now),
    # the same value, so the order of the writes does not matter.
    u = fresh.nonzero().squeeze(1)
    un, us = n_safe[u], mslot[u]
    store.created[un, us] = torch.clamp(store.created[un, us], min=now)
    return status, store


def _merge_listener_state(mesh: Mesh, store: SwarmStore) -> SwarmStore:
    """Merge the ranks' delivery tables after an insert (three
    ``all_reduce`` MAX).  ``notified`` ORs; a delivery slot takes the
    mesh's freshest ``nseqs`` (slots hold delivered seq + 1), and of the
    ranks holding it the highest contributes token, size and bytes
    together, so slots never blend across ranks."""
    top = mesh.all_reduce(torch.stack([store.notified.to(torch.int64),
                                       store.nseqs]), "max")
    gseq = top[1]
    is_win = store.nseqs == gseq
    win_r = mesh.all_reduce(torch.where(is_win, mesh.rank, -1), "max")
    mine = is_win & (win_r == mesh.rank)
    body = mesh.all_reduce(torch.where(
        mine[:, None], torch.cat([store.nvals[:, None], store.nsizes[:, None],
                                  store.npayload], dim=1), 0), "max")
    return store._replace(notified=top[0] != 0, nseqs=gseq, nvals=body[:, 0],
                          nsizes=body[:, 1], npayload=body[:, 2:])


def _trace_sum(mesh: Mesh, trace: StoreTrace) -> StoreTrace:
    tv = mesh.all_reduce(torch.stack(list(trace)), "sum")
    return StoreTrace(*tv.unbind(0))


def _insert_routed(mesh: Mesh, cfg: SwarmConfig, scfg: StoreConfig,
                   capacity_factor: float, alive: torch.Tensor,
                   store: SwarmStore, found: torch.Tensor, keys, vals, seqs,
                   sizes, ttls, now: int, payloads=None, probe: bool = False,
                   full_capacity_factor: float | None = None):
    """The routed store insert shared by announce and republish: each
    (replica, key, value, seq, size, ttl, bytes) request goes to its
    owner, is applied to the owner's shard with ``_store_insert``'s edit
    policy, budget and listener delivery, and its accept bit comes back.

    ``probe`` runs the two-phase announce first (:func:`_probe_refresh`:
    a 9-word probe exchange and a 1-word answer); only missing or stale
    replicas then take the full value, in buckets provisioned at
    ``full_capacity_factor``; a refreshed replica counts as holding the
    value.  Returns ``(store, replicas [ll] int32, mesh-global
    StoreTrace)``; the store is updated in place and its delivery
    tables merged."""
    ll, quorum = found.shape
    d = mesh.size
    q = ll * quorum
    owner, local_row, ok = _targets(cfg, mesh, alive, found)
    w = scfg.payload_words
    with_pl = bool(w) and payloads is not None

    def rep(x):
        return x.repeat_interleave(quorum, dim=0)

    refreshed = torch.zeros((q,), dtype=torch.bool, device=found.device)
    row = local_row.to(torch.int32)[:, None]
    if probe:
        dig = (_payload_digest(rep(payloads)) if with_pl
               else torch.zeros((q,), dtype=torch.int64, device=found.device))
        pcols = torch.cat([row, _col(rep(keys)), _col(rep(seqs)),
                           _col(rep(vals)), _col(dig)], dim=1)     # [Q, 9]
        cap1 = _cap_for(q, d, capacity_factor)
        rbuf, pos1, sent1 = _route_out(mesh, pcols, owner, ok, cap1)
        rb = rbuf.reshape(d * cap1, -1)
        status, store = _probe_refresh(
            store, scfg, rb[:, 0].long(), as_u32(rb[:, 1:1 + N_LIMBS]),
            as_u32(rb[:, 1 + N_LIMBS]), as_u32(rb[:, 2 + N_LIMBS]),
            as_u32(rb[:, 3 + N_LIMBS]), now)
        st = _route_back(mesh, status.reshape(d, cap1, 1), owner, pos1,
                         sent1, cap1)[:, 0]
        refreshed = sent1 & (st == 1)
        ok = sent1 & (st == 0)          # only missing / stale go on
        if full_capacity_factor is None:
            full_capacity_factor = capacity_factor

    cols = [row, _col(rep(keys)), _col(rep(vals)), _col(rep(seqs)),
            _col(rep(sizes)), _col(rep(ttls))]
    if with_pl:
        cols.append(_col(rep(payloads)))
    cap = _cap_for(q, d, full_capacity_factor if probe else capacity_factor)
    rbuf, pos, sent = _route_out(mesh, torch.cat(cols, dim=1), owner, ok,
                                 cap)
    m = d * cap
    rb = rbuf.reshape(m, -1)
    # Sizes ride verbatim (a zero-length chunked part 0 stores 0);
    # empty bucket slots are dropped by their row, -1.
    store, acc, trace = _store_insert(
        store, scfg, rb[:, 0].long(), as_u32(rb[:, 1:1 + N_LIMBS]),
        as_u32(rb[:, 1 + N_LIMBS]), as_u32(rb[:, 2 + N_LIMBS]),
        torch.arange(m, device=rb.device), now, as_u32(rb[:, 3 + N_LIMBS]),
        as_u32(rb[:, 4 + N_LIMBS]),
        as_u32(rb[:, 5 + N_LIMBS:]) if with_pl else None)
    back = _route_back(mesh, acc.reshape(d, cap, 1), owner, pos, sent, cap)
    acc_mine = back[:, 0].clamp(0, 1).reshape(ll, quorum)
    replicas = (acc_mine + refreshed.reshape(ll, quorum).to(torch.int32)
                ).sum(dim=1).to(torch.int32)
    store = _merge_listener_state(mesh, store)
    return store, replicas, _trace_sum(mesh, trace)


# ---------------------------------------------------------------------------
# the get probe
# ---------------------------------------------------------------------------

def _owner_probe(store: SwarmStore, scfg: StoreConfig, r_node: torch.Tensor,
                 r_key: torch.Tensor) -> torch.Tensor:
    """The owner's answer to ``[M]`` probes: ``[M, 4 + W]`` int32 rows
    ``(hit, val, seq, size, bytes)`` of the freshest replica (then the
    largest token, then the first slot).  With ``verify`` a slot whose
    bytes do not hash to the key is discarded first."""
    rows = store.used.shape[0]
    n_safe = r_node.clamp(0, rows - 1)
    valid = r_node >= 0
    hit = (store.used[n_safe] & valid[:, None]
           & _key_match(store.keys, n_safe, r_key))              # [M, S]
    if scfg.verify:
        hit = hit & (sha1_words(store.payload[n_safe])
                     == r_key[:, None, :]).all(dim=-1)
    vals = store.vals[n_safe]
    seq = torch.where(hit, store.seqs[n_safe], 0)
    best = seq.amax(dim=1)
    is_b = hit & (seq == best[:, None])
    val = torch.where(is_b, vals, 0).amax(dim=1)
    anyhit = hit.any(dim=1)
    wslot = torch.argmax((is_b & (vals == val[:, None])).to(torch.uint8),
                         dim=1)
    szv = torch.where(anyhit, store.sizes[n_safe, wslot], 0)
    pl = torch.where(anyhit[:, None], store.payload[n_safe, wslot], 0)
    return torch.cat([anyhit.to(torch.int32)[:, None], _col(val), _col(best),
                      _col(szv), _col(pl)], dim=1)


def _probe_phase(mesh: Mesh, cfg: SwarmConfig, scfg: StoreConfig,
                 capacity_factor: float, alive: torch.Tensor,
                 store: SwarmStore, found: torch.Tensor, keys: torch.Tensor):
    """Get probes at the replicas a lookup ``found``: ``(row, key)`` to
    each owner, the owner's freshest matching replica back, then the
    freshest over the quorum (one replica's token, size and bytes,
    never a blend).  Returns ``(hit, val, seq, payload, size)`` for this
    rank's rows."""
    ll, quorum = found.shape
    d = mesh.size
    q = ll * quorum
    owner, local_row, ok = _targets(cfg, mesh, alive, found)
    payload = torch.cat([local_row.to(torch.int32)[:, None],
                         _col(keys.repeat_interleave(quorum, dim=0))], dim=1)
    cap = _cap_for(q, d, capacity_factor)
    rbuf, pos, sent = _route_out(mesh, payload, owner, ok, cap)
    rb = rbuf.reshape(d * cap, -1)
    r_node, r_key = rb[:, 0].long(), as_u32(rb[:, 1:])
    resp = torch.cat([_owner_probe(store, scfg, r_node[i:i + OWNER_PROBE_ROWS],
                                   r_key[i:i + OWNER_PROBE_ROWS])
                      for i in range(0, r_node.shape[0], OWNER_PROBE_ROWS)])
    back = _route_back(mesh, resp.reshape(d, cap, -1), owner, pos, sent, cap)
    w = scfg.payload_words
    h = (back[:, 0] > 0).reshape(ll, quorum)
    v = as_u32(torch.where(sent, back[:, 1], 0)).reshape(ll, quorum)
    s = as_u32(torch.where(sent, back[:, 2], 0)).reshape(ll, quorum)
    szpl = as_u32(torch.where(sent[:, None], back[:, 3:], 0)).reshape(
        ll, quorum, 1 + w)
    s = torch.where(h, s, 0)
    best_seq = s.amax(dim=1)
    win = h & (s == best_seq[:, None])
    best_val = torch.where(win, v, 0).amax(dim=1)
    any_h = h.any(dim=1)
    out = _pick_payload(win & (v == best_val[:, None]), szpl, any_h)
    return any_h, best_val, best_seq, out[:, 1:], out[:, 0]


# ---------------------------------------------------------------------------
# the public ops
# ---------------------------------------------------------------------------

def _lookup(swarm, cfg, keys, mesh, generator, origins, capacity_factor):
    keys = keys.to(mesh.device)
    return sharded_lookup(swarm, cfg, keys, mesh,
                          origins=_origins(mesh, swarm.alive, keys.shape[0],
                                           generator, origins),
                          capacity_factor=capacity_factor)


def sharded_announce(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                     scfg: StoreConfig, keys: torch.Tensor,
                     vals: torch.Tensor, seqs: torch.Tensor, now, mesh: Mesh,
                     generator: torch.Generator | None = None,
                     capacity_factor: float = 4.0,
                     sizes: torch.Tensor | None = None,
                     ttls: torch.Tensor | None = None,
                     payloads: torch.Tensor | None = None,
                     probe: bool = False,
                     full_capacity_factor: float | None = None,
                     drop_frac: float = 0.0,
                     drop_generator: torch.Generator | None = None, *,
                     drop_keep: torch.Tensor | None = None,
                     origins: torch.Tensor | None = None
                     ) -> Tuple[SwarmStore, AnnounceReport]:
    """Batched put over the sharded swarm and store: this rank's rows of
    ``keys [P,5]`` / ``vals`` / ``seqs`` (and optional ``sizes`` /
    ``ttls [P]``, ``payloads [P,W]``).  The routed lookup, then the
    routed insert (:func:`_insert_routed`; ``probe`` for the two-phase
    announce).  ``drop_frac`` with ``drop_keep`` (this rank's rows of
    ``[P, quorum]``) or ``drop_generator`` loses storage exchanges: a
    dropped replica gets neither probe nor value.  Returns ``(store,
    AnnounceReport)``: this rank's rows, the trace mesh-global."""
    _check_store(store, cfg, mesh)
    dev = mesh.device
    p = keys.shape[0]
    if sizes is None:
        sizes = torch.ones((p,), dtype=torch.int64, device=dev)
    if ttls is None:
        ttls = torch.zeros((p,), dtype=torch.int64, device=dev)
    if payloads is None:
        payloads = torch.zeros((p, scfg.payload_words), dtype=torch.int64,
                               device=dev)
    res = _lookup(swarm, cfg, keys, mesh, generator, origins,
                  capacity_factor)
    found = drop_exchanges(res.found, drop_frac, drop_generator,
                           keep=drop_keep)
    store, replicas, trace = _insert_routed(
        mesh, cfg, scfg, capacity_factor, swarm.alive, store, found,
        keys.to(dev), vals.to(dev), seqs.to(dev), sizes.to(dev),
        ttls.to(dev), _now(now), payloads.to(dev), probe,
        full_capacity_factor)
    return store, AnnounceReport(replicas=replicas, hops=res.hops,
                                 done=res.done, trace=trace)


def sharded_get(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                scfg: StoreConfig, keys: torch.Tensor, mesh: Mesh,
                generator: torch.Generator | None = None,
                capacity_factor: float = 4.0, *,
                origins: torch.Tensor | None = None) -> GetResult:
    """Batched get over the sharded swarm and store (freshest seq wins;
    with ``verify`` forged replicas are discarded at their owner).  This
    rank's rows of ``keys`` and of the result."""
    _check_store(store, cfg, mesh)
    res = _lookup(swarm, cfg, keys, mesh, generator, origins,
                  capacity_factor)
    hit, val, seq, pl, _ = _probe_phase(mesh, cfg, scfg, capacity_factor,
                                        swarm.alive, store, res.found,
                                        keys.to(mesh.device))
    return GetResult(hit=hit, val=val, seq=seq, hops=res.hops, done=res.done,
                     payload=pl)


def _chunk_rows(mesh: Mesh, store: SwarmStore, nlo: int, cn: int):
    """Node rows ``[nlo + r·cn/D, nlo + (r+1)·cn/D)`` of the store for rank
    ``r`` — the rows JAX's row split of a republish chunk hands it —
    moved from the ranks holding them (one ``all_to_all``: rank ``s``
    sends rank ``r`` the rows of that range it owns, in place, and ``r``
    keeps each row from its owner).  Returns ``(node [m], keys [m,S,5],
    vals, seqs, sizes, ttls, used [m,S], payload [m,S,W])``."""
    d, me = mesh.size, mesh.rank
    rows = store.vals.shape[0]
    m = cn // d
    s = store.vals.shape[1]
    dev = store.vals.device
    nodes = nlo + torch.arange(d * m, device=dev).reshape(d, m)  # [dest, m]
    mine = (nodes >= me * rows) & (nodes < (me + 1) * rows)
    loc = (nodes - me * rows).clamp(0, rows - 1).reshape(-1)
    parts = [x.reshape(rows, -1)[loc].to(torch.int64) for x in (
        store.keys, store.vals, store.seqs, store.sizes, store.ttls,
        store.used, store.payload)]
    buf = torch.where(mine.reshape(-1, 1), torch.cat(parts, dim=1), 0)
    back = mesh.all_to_all(buf.reshape(d, m, -1))               # [src, m, X]
    node = nlo + me * m + torch.arange(m, device=dev)
    got = back[(node // rows).clamp(0, d - 1), torch.arange(m, device=dev)]
    widths = [x.shape[1] for x in parts]
    keys, vals, seqs, sizes, ttls, used, pl = torch.split(got, widths, dim=1)
    return (node, keys.reshape(m, s, N_LIMBS), vals, seqs, sizes, ttls,
            used != 0, pl.reshape(m, s, -1))


def sharded_republish(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                      scfg: StoreConfig, now, mesh: Mesh,
                      generator: torch.Generator | None = None,
                      capacity_factor: float = 4.0, probe: bool = False,
                      full_capacity_factor: float | None = None,
                      chunk: int = 262_144,
                      node_range: Tuple[int, int] | None = None,
                      drop_frac: float = 0.0,
                      drop_generator: torch.Generator | None = None, *,
                      origins_of: Callable[[int], torch.Tensor] | None = None,
                      drop_keep_of: Callable[[int], torch.Tensor] | None = None
                      ) -> Tuple[SwarmStore, AnnounceReport]:
    """Mesh-wide maintenance: every alive node re-announces every value
    it holds to the keys' current quorum closest, restoring replication
    after churn.  The batch is every slot of the nodes in ``node_range``
    (both ends multiples of the mesh size; default all nodes), swept in
    chunks of whole nodes (at most ``chunk`` slot rows, dividing the
    range and the mesh); a chunk sees the earlier chunks' inserts.

    JAX splits a chunk's rows over the mesh by position, so rank ``r``
    republishes nodes ``[lo + r·cn/D, lo + (r+1)·cn/D)`` of chunk ``[lo,
    lo + cn)``: those rows are first moved to it from the ranks holding
    them (:func:`_chunk_rows`).  Chunk ``i``'s lookup takes this rank's
    origins ``origins_of(i)`` (else a draw from ``generator``); with
    ``drop_frac`` the storage exchanges are lost by ``drop_keep_of(i)``
    (else a ``drop_generator`` draw).  ``probe`` /
    ``full_capacity_factor`` as in :func:`_insert_routed`.  Returns
    ``(store, AnnounceReport)``: the report's rows are this rank's rows
    of each chunk, chunk after chunk; the trace is the sweep's sum."""
    _check_store(store, cfg, mesh)
    d, s = mesh.size, scfg.slots
    lo0, hi0 = node_range if node_range is not None else (0, cfg.n_nodes)
    n = hi0 - lo0
    if not (0 <= lo0 < hi0 <= cfg.n_nodes and lo0 % d == 0 and n % d == 0):
        raise ValueError(f"node_range {(lo0, hi0)} must lie in 0..{cfg.n_nodes}"
                         f" with both ends multiples of the {d}-rank mesh")
    cn = min(n, max(d, (chunk // s) // d * d))
    while n % cn:
        cn -= d
    reps, hops, done = [], [], []
    trace = None
    now = _now(now)
    for i, nlo in enumerate(range(lo0, hi0, cn)):
        node, keys, vals, seqs, sizes, ttls, used, pl = _chunk_rows(
            mesh, store, nlo, cn)
        # A dead republisher or an empty slot announces to no one.
        okf = (swarm.alive[node][:, None] & used).reshape(-1)
        keys = keys.reshape(-1, N_LIMBS)
        # graftlint: disable=sync-in-loop (the routed republish walks the store in node chunks: one routed lookup (with its per-burst readbacks) a chunk)
        res = _lookup(swarm, cfg, keys, mesh, generator,
                      origins_of(i) if origins_of is not None else None,
                      capacity_factor)
        found = torch.where(okf[:, None], res.found, -1)
        found = drop_exchanges(
            found, drop_frac, drop_generator,
            keep=drop_keep_of(i) if drop_keep_of is not None else None)
        store, replicas, tr = _insert_routed(
            mesh, cfg, scfg, capacity_factor, swarm.alive, store, found, keys,
            vals.reshape(-1), seqs.reshape(-1), sizes.reshape(-1),
            ttls.reshape(-1), now, pl.reshape(keys.shape[0], -1), probe,
            full_capacity_factor)
        trace = tr if trace is None else trace + tr
        reps.append(replicas)
        hops.append(res.hops)
        done.append(res.done)
    return store, AnnounceReport(replicas=torch.cat(reps),
                                 hops=torch.cat(hops), done=torch.cat(done),
                                 trace=trace)


def sharded_expire(store: SwarmStore, scfg: StoreConfig, now) -> SwarmStore:
    """The TTL sweep on this rank's shard: elementwise on every node row,
    so the local :func:`~opendht_tpu_torch.models.storage.expire` is the
    sharded one (no collective)."""
    return expire(store, scfg, now)


# ---------------------------------------------------------------------------
# listeners
# ---------------------------------------------------------------------------

def _listen_phase(mesh: Mesh, cfg: SwarmConfig, scfg: StoreConfig,
                  capacity_factor: float, alive: torch.Tensor,
                  store: SwarmStore, found: torch.Tensor, keys: torch.Tensor,
                  reg_ids: torch.Tensor, now: int) -> SwarmStore:
    """Routed listener inserts: ``(row, key, id)`` to the owner of each
    live replica, written into its listener ring
    (:func:`~opendht_tpu_torch.models.storage._listen_apply`)."""
    ll, quorum = found.shape
    q = ll * quorum
    rid = reg_ids.to(torch.int32).repeat_interleave(quorum)
    owner, local_row, ok = _targets(cfg, mesh, alive, found)
    ok = ok & (rid >= 0) & (rid < scfg.max_listeners)
    local_row = torch.where(ok, local_row, -1)
    payload = torch.cat([local_row.to(torch.int32)[:, None],
                         _col(keys.repeat_interleave(quorum, dim=0)),
                         rid[:, None]], dim=1)
    cap = _cap_for(q, mesh.size, capacity_factor)
    rbuf, _, _ = _route_out(mesh, payload, owner, ok, cap)
    rb = rbuf.reshape(mesh.size * cap, -1)
    return _listen_apply(store, scfg, rb[:, 0].long(),
                         as_u32(rb[:, 1:1 + N_LIMBS]), rb[:, 1 + N_LIMBS], now)


def sharded_listen_at(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                      scfg: StoreConfig, keys: torch.Tensor,
                      reg_ids: torch.Tensor, mesh: Mesh,
                      generator: torch.Generator | None = None,
                      capacity_factor: float = 4.0, now=0, *,
                      origins: torch.Tensor | None = None
                      ) -> Tuple[SwarmStore, torch.Tensor]:
    """Batched listen over the mesh: register ``reg_ids`` (this rank's
    rows) for ``keys`` at each key's quorum closest nodes; later
    announces of a key deliver into the (mesh-merged) delivery slots.
    With ``listen_ttl`` a registration lapses at ``now + listen_ttl``
    unless refreshed.  Returns ``(store, done)``."""
    _check_store(store, cfg, mesh)
    res = _lookup(swarm, cfg, keys, mesh, generator, origins,
                  capacity_factor)
    store = _listen_phase(mesh, cfg, scfg, capacity_factor, swarm.alive,
                          store, res.found, keys.to(mesh.device),
                          reg_ids.to(mesh.device), _now(now))
    return store, res.done


# The listener sweeps act on this rank's table rows with id masks and
# delivery tables that every rank holds alike: the local ops are the
# sharded ones, with no collective.

def sharded_cancel_listen(store: SwarmStore, scfg: StoreConfig,
                          reg_ids: torch.Tensor) -> SwarmStore:
    """Cancel listeners mesh-wide: their rows die on every rank and their
    delivery slots clear."""
    return cancel_listen(store, scfg, reg_ids.to(store.lids.device))


def sharded_refresh_listeners(store: SwarmStore, scfg: StoreConfig,
                              active: torch.Tensor, now) -> SwarmStore:
    """Re-register sweep: rows of ``active`` ids expire at ``now +
    listen_ttl`` again."""
    return refresh_listeners(store, scfg, active.to(store.lids.device), now)


def sharded_expire_listeners(store: SwarmStore, scfg: StoreConfig,
                             now) -> SwarmStore:
    """Free the lapsed listener rows of this rank's shard."""
    return expire_listeners(store, scfg, now)


def sharded_ack_listeners(store: SwarmStore,
                          reg_ids: torch.Tensor) -> SwarmStore:
    """The reader's ack: consume the delivery slots of ``reg_ids``."""
    return ack_listeners(store, reg_ids.to(store.lids.device))


# ---------------------------------------------------------------------------
# chunked values on the mesh
# ---------------------------------------------------------------------------

def sharded_announce_chunked(swarm: Swarm, cfg: SwarmConfig,
                             store: SwarmStore, scfg: StoreConfig,
                             keys: torch.Tensor, vals: torch.Tensor,
                             seqs: torch.Tensor, now, mesh: Mesh,
                             payloads: torch.Tensor, lengths: torch.Tensor,
                             generator: torch.Generator | None = None,
                             capacity_factor: float = 4.0,
                             drop_frac: float = 0.0,
                             drop_generator: torch.Generator | None = None,
                             part_drop_mask: torch.Tensor | None = None,
                             part_range: Tuple[int, int] | None = None, *,
                             origins: torch.Tensor | None = None,
                             drop_keep_of: Callable[[int], torch.Tensor]
                             | None = None
                             ) -> Tuple[SwarmStore, AnnounceReport]:
    """Batched put of variable-size values over the mesh: one routed
    lookup a base key, then one routed insert a part at its part key
    (unverified: part keys derive from the base key; the read checks
    the whole value).  ``payloads [P, parts, W]`` / ``lengths [P]`` are
    this rank's rows.  Torn-write knobs: ``drop_frac`` with
    ``drop_keep_of(j)`` (or a ``drop_generator`` draw) a part,
    ``part_drop_mask [P, parts]`` and ``part_range`` (as the local
    twin's).  ``replicas`` counts part 0's; the trace sums the parts'."""
    _check_store(store, cfg, mesh)
    dev = mesh.device
    p, parts, w = payloads.shape
    if w != scfg.payload_words:
        raise ValueError(f"payloads have {w} words a part, the store "
                         f"{scfg.payload_words}")
    lo, hi = part_range if part_range is not None else (0, parts)
    if not 0 <= lo < hi <= parts:
        raise ValueError(f"part_range {(lo, hi)} outside 0..{parts}")
    payloads, lengths = mask_chunk_payloads(payloads.to(dev), lengths.to(dev))
    words = -(-_wrap_i32(lengths) // 4)
    part_scfg = scfg._replace(verify=False)
    res = _lookup(swarm, cfg, keys, mesh, generator, origins,
                  capacity_factor)
    keys, vals, seqs = keys.to(dev), vals.to(dev), seqs.to(dev)
    ttls = torch.zeros((p,), dtype=torch.int64, device=dev)
    rep0 = torch.zeros((p,), dtype=torch.int32, device=dev)
    trace = None
    for j in range(lo, hi):
        active = (words > j * w) | (j == 0)
        if part_drop_mask is not None:
            active = active & ~part_drop_mask[:, j].to(dev)
        found_j = torch.where(active[:, None], res.found, -1)
        found_j = drop_exchanges(
            found_j, drop_frac, drop_generator,
            keep=drop_keep_of(j) if drop_keep_of is not None else None)
        sizes_j = lengths if j == 0 else torch.ones_like(lengths)
        store, rep, tr = _insert_routed(
            mesh, cfg, part_scfg, capacity_factor, swarm.alive, store,
            found_j, part_key(keys, j), vals, seqs, sizes_j, ttls, _now(now),
            payloads[:, j])
        trace = tr if trace is None else trace + tr
        if j == 0:
            rep0 = rep
    return store, AnnounceReport(replicas=rep0, hops=res.hops,
                                 done=res.done, trace=trace)


def sharded_get_chunked(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                        scfg: StoreConfig, keys: torch.Tensor, mesh: Mesh,
                        parts: int, generator: torch.Generator | None = None,
                        capacity_factor: float = 4.0, *,
                        origins: torch.Tensor | None = None
                        ) -> ChunkedGetResult:
    """Batched get of variable-size values over the mesh: a hit iff part
    0 is found and every part its length needs carries part 0's ``(val,
    seq)`` (and, with ``verify``, the bytes hash back to the key); a
    torn or over-long value reads as missing, never garbled."""
    _check_store(store, cfg, mesh)
    p = keys.shape[0]
    w = scfg.payload_words
    keys = keys.to(mesh.device)
    part_scfg = scfg._replace(verify=False)
    res = _lookup(swarm, cfg, keys, mesh, generator, origins,
                  capacity_factor)

    def probe(j):
        return _probe_phase(mesh, cfg, part_scfg, capacity_factor,
                            swarm.alive, store, res.found, part_key(keys, j))

    h0, val, seq, pl0, sz = probe(0)
    need_words = -(-_wrap_i32(sz) // 4)
    n_parts = (-(-need_words // max(w, 1))).clamp(1, parts)
    ok = h0 & (need_words <= parts * w)
    pls = [pl0]
    for j in range(1, parts):
        hj, vj, sj, plj, _ = probe(j)
        needed = n_parts > j
        ok = ok & (~needed | (hj & (vj == val) & (sj == seq)))
        pls.append(torch.where(needed[:, None], plj, 0))
    payload = torch.cat(pls, dim=1)
    idx = torch.arange(parts * w, device=payload.device)[None, :]
    payload = torch.where(idx < need_words[:, None], payload, 0)
    if scfg.verify:
        ok = ok & _chunked_root_ok(keys, payload.reshape(p, parts, w), sz)
    payload = torch.where(ok[:, None], payload, 0)
    return ChunkedGetResult(
        hit=ok, val=torch.where(ok, val, 0), seq=torch.where(ok, seq, 0),
        length=torch.where(ok, sz, 0), payload=payload, hops=res.hops,
        done=res.done)


def sharded_listen_chunked(swarm: Swarm, cfg: SwarmConfig,
                           store: SwarmStore, scfg: StoreConfig,
                           keys: torch.Tensor, reg_ids: torch.Tensor,
                           mesh: Mesh, parts: int,
                           generator: torch.Generator | None = None,
                           capacity_factor: float = 4.0, now=0, *,
                           origins: torch.Tensor | None = None
                           ) -> Tuple[SwarmStore, torch.Tensor]:
    """Register chunked listeners over the mesh: one routed lookup a base
    key, then one routed listener insert covering every part key (a node
    holds a registration whole or not at all).  The insert batch is the
    whole batch's lookups tiled ``parts`` times, split by row over the
    mesh as JAX splits it, so found heads, keys and ids are gathered
    first (one ``all_gather``) and each rank takes its rows of the
    tiled batch.  Needs ``listen_slots >= parts``.  Returns ``(store,
    done)``."""
    _check_store(store, cfg, mesh)
    dev = mesh.device
    q = cfg.quorum
    res = _lookup(swarm, cfg, keys, mesh, generator, origins,
                  capacity_factor)
    rows = torch.cat([res.found.to(torch.int64), keys.to(dev),
                      reg_ids.to(dev).to(torch.int64)[:, None]], dim=1)
    whole = mesh.all_gather(rows).reshape(-1, rows.shape[1])
    found, wkeys, rid = (whole[:, :q], whole[:, q:q + N_LIMBS],
                         whole[:, q + N_LIMBS].to(torch.int32))
    found_b = found.repeat(parts, 1)
    keys_b = torch.cat([part_key(wkeys, j) for j in range(parts)])
    rid_b = torch.cat([torch.where(rid >= 0, rid * parts + j, -1)
                       for j in range(parts)])
    m = found_b.shape[0] // mesh.size
    sl = slice(mesh.rank * m, (mesh.rank + 1) * m)
    store = _listen_phase(mesh, cfg, scfg, capacity_factor, swarm.alive,
                          store, found_b[sl], keys_b[sl], rid_b[sl], _now(now))
    return store, res.done


def sharded_collect_chunked(store: SwarmStore, scfg: StoreConfig,
                            reg_ids: torch.Tensor, parts: int,
                            keys: torch.Tensor | None = None):
    """Reassemble delivered chunked values (the delivery tables are the
    same on every rank: the local collect is the sharded one)."""
    return collect_chunked(store, scfg, reg_ids, parts, keys)


def sharded_ack_chunked(store: SwarmStore, reg_ids: torch.Tensor,
                        parts: int) -> SwarmStore:
    """Consume whole chunked listeners' delivery slots, mesh-wide."""
    return ack_chunked(store, reg_ids.to(store.lids.device), parts)


def sharded_cancel_chunked(store: SwarmStore, scfg: StoreConfig,
                           reg_ids: torch.Tensor, parts: int) -> SwarmStore:
    """Cancel whole chunked listeners mesh-wide."""
    return cancel_chunked(store, scfg, reg_ids.to(store.lids.device), parts)
