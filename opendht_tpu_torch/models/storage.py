"""Per-node value storage for the PyTorch swarm engine.

Counterpart of ``opendht_tpu/models/storage.py``: every simulated node
carries a small value store and a listener table as tensors, and the
DHT's storage RPCs become batched gathers and scatters —

* :func:`announce` — a batch of puts runs the lookup to find each key's
  ``quorum`` closest nodes, then stores (key, value, seq) at the live
  ones with the edit policy (a higher seq replaces, an equal seq only
  refreshes the same bytes), a ring of ``slots`` values per node and an
  optional byte budget; accepted values notify matching listeners and
  fill their delivery slots;
* :func:`get_values` — a batch of gets runs the lookup and returns the
  freshest (highest seq) stored value among the closest queried nodes;
* :func:`listen_at`, :func:`refresh_listeners`,
  :func:`expire_listeners`, :func:`cancel_listen`,
  :func:`ack_listeners` — listener registration, re-registration,
  expiry, cancellation and the reader's ack (a consumed delivery slot
  re-fires on the next accepted announce);
* :func:`expire` — the per-value TTL sweep;
* :func:`republish_from` — chosen nodes re-announce what they hold, the
  maintenance that restores replication after churn.

With ``StoreConfig.verify`` values are content-addressed (``key =
SHA-1(payload bytes)``, :mod:`opendht_tpu_torch.ops.sha1`): the insert
drops rows whose payload contradicts their key
(``StoreTrace.integrity_rejects``) and the get probe discards forged
replicas before the freshest-seq merge.

Layout: where the JAX store keeps flat ``[N·S·5]`` / ``[N·S·W]`` /
``[N·LS]`` arrays for the TPU's tiling, this store keeps them shaped
``[N,S,5]``, ``[N,S,W]``, ``[N,LS]`` (the same elements in the same
order; :func:`opendht_tpu_torch.convert.store_from_numpy` carries a JAX
store across).  u32 quantities are int64 in ``0 .. 2**32 - 1``
(:mod:`opendht_tpu_torch.ops.u32`) and every u32 sum, difference or
cursor advance is masked back to 32 bits, as the JAX uint32 arithmetic
wraps.

The inserts (:func:`announce`, :func:`listen_at`,
:func:`republish_from`) update the store's tensors in place and return
the store — the JAX functions donate theirs, so neither package lets a
caller keep using the store it passed in.  Every scatter writes each
target once: after the in-batch dedup and the per-node ranks, no two
accepted rows aim at one slot, and the listener winner is picked
explicitly (a max of seq, then of row), so results do not depend on the
order in which the card applies a scatter.  Masked rows are selected
out before a scatter, where JAX aims them out of bounds and drops them.

The lookups run on the card unless ``device="cpu"`` is passed; every
entry point that runs one takes ``generator=`` (origins drawn from
alive nodes, as :func:`~opendht_tpu_torch.models.swarm.lookup` does) or
``origins=``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..ops.sha1 import sha1_words
from ..ops.u32 import MASK32, lexsort, mul32
from ..ops.xor_metric import N_LIMBS
from .swarm import LookupResult, Swarm, SwarmConfig, lookup, resolve_device

# Rows a get probes at once: bounds the probe's [rows, Q, S, W] planes.
PROBE_CHUNK = 32768

INT32_MAX = 0x7FFFFFFF


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's range modulo 2**32 — JAX's int32
    arithmetic, which wraps."""
    return ((x + 2**31) & MASK32) - 2**31


def _payload_digest(pl: torch.Tensor) -> torch.Tensor:
    """Order-sensitive 32-bit digest of payload rows ``[..., W]``:
    ``sum_j pl[..., j] · C^(j+1) mod 2**32`` with odd ``C`` (a word swap
    or a single-word change moves it; not cryptographic)."""
    w = pl.shape[-1]
    out = torch.zeros(pl.shape[:-1], dtype=torch.int64, device=pl.device)
    c, x = 0x9E3779B1, 1
    for j in range(w):
        x = (x * c) & MASK32
        out = out + mul32(pl[..., j], x)
    return out & MASK32


def _key_match(keys: torch.Tensor, node: torch.Tensor,
               key: torch.Tensor) -> torch.Tensor:
    """``[..., S]`` bool: does slot j of ``node`` hold ``key``?  ``keys
    [N,S,5]``, ``node [...]`` (in range), ``key`` broadcasting against
    ``node`` with a trailing limb axis.  One limb at a time, so no
    ``[..., S, 5]`` plane is formed."""
    m = None
    for limb in range(N_LIMBS):
        g = keys[:, :, limb][node] == key[..., limb].unsqueeze(-1)
        m = g if m is None else m & g
    return m


def _mask_dead_idx(alive: torch.Tensor, cfg: SwarmConfig,
                   req_node: torch.Tensor) -> torch.Tensor:
    """-1 out requests aimed at dead or invalid nodes (dead replicas
    never acknowledge)."""
    ok = (req_node >= 0) & alive[req_node.clamp(0, cfg.n_nodes - 1).long()]
    return torch.where(ok, req_node, -1)


class StoreConfig(NamedTuple):
    """Storage geometry: ``slots`` values per node, a default per-value
    ``ttl`` (0 = none), ``max_listeners`` registration ids, a per-node
    byte ``budget`` (0 = none), ``payload_words`` u32 words of value
    bytes per value (0 = value tokens only), a listener lifetime
    ``listen_ttl`` (0 = none) and the ``verify`` integrity gate (needs
    ``payload_words > 0``)."""
    slots: int = 16
    listen_slots: int = 4
    ttl: int = 0
    max_listeners: int = 1 << 16
    budget: int = 0
    payload_words: int = 0
    listen_ttl: int = 0
    verify: bool = False


class SwarmStore(NamedTuple):
    """Per-node value store and listener table (u32 fields int64)."""
    keys: torch.Tensor      # [N,S,5] stored key hashes
    vals: torch.Tensor      # [N,S] value tokens
    seqs: torch.Tensor      # [N,S] sequence numbers
    created: torch.Tensor   # [N,S] time of storage
    used: torch.Tensor      # [N,S] bool
    cursor: torch.Tensor    # [N] ring write position
    lkeys: torch.Tensor     # [N,LS,5] listened-for keys
    lids: torch.Tensor      # [N,LS] int32 registration id, -1 = free
    lexps: torch.Tensor     # [N,LS] listener expiry (0 = never)
    lcursor: torch.Tensor   # [N]
    notified: torch.Tensor  # [max_listeners] bool — listener got a push
    sizes: torch.Tensor     # [N,S] stored value sizes
    ttls: torch.Tensor      # [N,S] per-value ttl (0 = StoreConfig.ttl)
    payload: torch.Tensor   # [N,S,W] value bytes
    nseqs: torch.Tensor     # [max_listeners] delivered seq + 1 (0 = none)
    nvals: torch.Tensor     # [max_listeners] delivered value token
    npayload: torch.Tensor  # [max_listeners,W] delivered bytes
    nsizes: torch.Tensor    # [max_listeners] delivered value size


# The leaves holding a row per node; the rest (``notified``, ``nseqs``,
# ``nvals``, ``npayload``, ``nsizes``) hold a row per listener id.  The
# sharded store splits the former over the ranks and keeps the latter
# whole on every rank.
NODE_LEAVES = ("keys", "vals", "seqs", "created", "used", "cursor", "lkeys",
               "lids", "lexps", "lcursor", "sizes", "ttls", "payload")


class StoreTrace(NamedTuple):
    """Counters of one storage sweep, ``[]`` int32 tensors left on the
    device until :meth:`to_dict` reads them in one transfer:
    ``requests`` that reached a live store, ``accepts_update``,
    ``accepts_new``, ``rejects`` (stale seq, equal-seq conflict, byte
    budget, ring overflow), listener ``notified`` matches, and
    ``integrity_rejects`` (payloads that contradict their key; 0 unless
    ``StoreConfig.verify``).  On a batch without duplicates,
    ``requests == accepts_update + accepts_new + rejects +
    integrity_rejects``."""
    requests: torch.Tensor
    accepts_update: torch.Tensor
    accepts_new: torch.Tensor
    rejects: torch.Tensor
    notified: torch.Tensor
    integrity_rejects: torch.Tensor

    @staticmethod
    def zeros() -> "StoreTrace":
        return StoreTrace(*[torch.zeros((), dtype=torch.int32)
                            for _ in range(6)])

    def __add__(self, other: "StoreTrace") -> "StoreTrace":
        return StoreTrace(*[a + b for a, b in zip(self, other)])

    def to_dict(self) -> dict:
        return _read_counters(self)


class StoreStats(NamedTuple):
    """Point-in-time storage gauges: live ``values``, their summed
    ``stored_bytes`` (u32, wrapping), live ``listeners`` and
    ``pending_notifies``."""
    values: torch.Tensor
    stored_bytes: torch.Tensor
    listeners: torch.Tensor
    pending_notifies: torch.Tensor

    def to_dict(self) -> dict:
        return _read_counters(self)


def _read_counters(t: NamedTuple) -> dict:
    dev = next(x.device for x in t if isinstance(x, torch.Tensor))
    host = torch.stack([torch.as_tensor(x, device=dev).to(torch.int64)
                        for x in t]).tolist()
    return dict(zip(t._fields, host))


def store_stats(store: SwarmStore) -> StoreStats:
    """The :class:`StoreStats` gauges of a store (reductions only)."""
    return StoreStats(
        values=store.used.sum().to(torch.int32),
        stored_bytes=torch.where(store.used, store.sizes, 0).sum() & MASK32,
        listeners=(store.lids >= 0).sum().to(torch.int32),
        pending_notifies=store.notified.sum().to(torch.int32))


class AnnounceReport(NamedTuple):
    replicas: torch.Tensor  # [P] int32 — copies stored per put
    hops: torch.Tensor      # [P] int32 — lookup rounds
    done: torch.Tensor      # [P] bool — lookup converged
    trace: StoreTrace | None = None


class GetResult(NamedTuple):
    hit: torch.Tensor   # [P] bool — value retrieved
    val: torch.Tensor   # [P] freshest value token (0 on a miss)
    seq: torch.Tensor   # [P]
    hops: torch.Tensor  # [P]
    done: torch.Tensor  # [P]
    payload: torch.Tensor | None = None  # [P,W] bytes (W = 0: tokens)


def validate_store_geometry(n_nodes: int, scfg: StoreConfig) -> None:
    """Reject the store geometries the JAX package refuses: those whose
    flat element indices overflow int32 (its masked rows scatter to the
    out-of-bounds node ``n_nodes``, so ``(n_nodes+1)·width`` must stay
    below ``2**31``), and ``verify`` without payload bytes.  This store
    indexes in int64 and holds shaped planes, but it accepts exactly the
    configurations the JAX store accepts, so the two stay
    interchangeable."""
    if scfg.verify and not scfg.payload_words:
        raise ValueError(
            "StoreConfig.verify needs payload_words > 0: content-"
            "addressed ids are digests of the value BYTES, and a "
            "token-only store has no bytes to verify")
    lim = 2 ** 31
    rows = (n_nodes + 1) * scfg.slots
    lrows = (n_nodes + 1) * scfg.listen_slots
    checks = (
        ("keys", rows * N_LIMBS),
        ("payload", rows * scfg.payload_words),
        ("listener keys", lrows * N_LIMBS),
        ("listener ids", lrows),
        ("listener table", scfg.max_listeners),
    )
    for name, n_elems in checks:
        if n_elems >= lim:
            raise ValueError(
                f"StoreConfig overflows int32 flat indexing: the {name} "
                f"store needs {n_elems:,} elements "
                f"(≥ 2^31 = {lim:,}) at n_nodes={n_nodes:,}, "
                f"slots={scfg.slots}, listen_slots={scfg.listen_slots}, "
                f"payload_words={scfg.payload_words}, "
                f"max_listeners={scfg.max_listeners} — gathers/scatters "
                f"would wrap and silently corrupt stored values; shrink "
                f"slots or payload_words (sharding does not help: the "
                f"flat index space is global, not per-shard)")


def empty_store(n_nodes: int, scfg: StoreConfig, device=None) -> SwarmStore:
    """An empty store on ``device`` (default the card)."""
    validate_store_geometry(n_nodes, scfg)
    dev = resolve_device(device)
    n, s, ls, ml = n_nodes, scfg.slots, scfg.listen_slots, scfg.max_listeners
    w = scfg.payload_words

    def z(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SwarmStore(
        keys=z(n, s, N_LIMBS), vals=z(n, s), seqs=z(n, s), created=z(n, s),
        used=z(n, s, dtype=torch.bool), cursor=z(n),
        lkeys=z(n, ls, N_LIMBS),
        lids=torch.full((n, ls), -1, dtype=torch.int32, device=dev),
        lexps=z(n, ls), lcursor=z(n), notified=z(ml, dtype=torch.bool),
        sizes=z(n, s), ttls=z(n, s), payload=z(n, s, w), nseqs=z(ml),
        nvals=z(ml), npayload=z(ml, w), nsizes=z(ml))


# ---------------------------------------------------------------------------
# the vectorized insert (the onAnnounce storage path)
# ---------------------------------------------------------------------------

def _segment_excl_sum(weights: torch.Tensor,
                      first: torch.Tensor) -> torch.Tensor:
    """Per-row exclusive prefix sum within each segment; ``first[i]`` is
    the index of the first row of row i's segment."""
    c = torch.cumsum(weights, 0) - weights
    return c - c[first]


def _segment_rank(sorted_node: torch.Tensor, flag: torch.Tensor,
                  first: torch.Tensor | None = None) -> torch.Tensor:
    """Rank of each flagged row among the flagged rows before it in its
    node segment (``sorted_node`` ascending)."""
    if first is None:
        first = torch.searchsorted(sorted_node, sorted_node, side="left")
    return _segment_excl_sum(flag.to(torch.int64), first)


def _store_insert(store: SwarmStore, scfg: StoreConfig,
                  req_node: torch.Tensor, req_key: torch.Tensor,
                  req_val: torch.Tensor, req_seq: torch.Tensor,
                  req_put: torch.Tensor, now: int,
                  req_size: torch.Tensor | None = None,
                  req_ttl: torch.Tensor | None = None,
                  put_payloads: torch.Tensor | None = None):
    """Insert a flat batch of storage requests into ``store``, in place.

    ``req_node [M]`` (-1 = skip), ``req_key [M,5]``, ``req_val``,
    ``req_seq``, ``req_put [M]`` (the put row each request came from),
    optional ``req_size`` / ``req_ttl`` ``[M]`` (default 1 and 0), and
    ``put_payloads [P,W]`` indexed by ``req_put``.  Per request: a key
    already stored on the node is overwritten when ``seq`` is higher, or
    equal with the same token and bytes (a refresh); a new key takes the
    node's next ring slot (at most ``slots`` new keys a node a batch,
    none onto a slot this batch refreshed) while the node's bytes stay
    within ``budget``; with ``verify`` a payload whose SHA-1 is not its
    key is dropped first.  Accepted values notify the node's matching
    unexpired listeners and fill their delivery slots (highest seq wins,
    then the last request row).  Returns ``(store, replicas [M] int32 by
    put row, StoreTrace)``."""
    s = scfg.slots
    m = req_node.shape[0]
    dev = req_node.device
    n_nodes = store.used.shape[0]
    valid = req_node >= 0
    if req_size is None:
        req_size = torch.ones((m,), dtype=torch.int64, device=dev)
    if req_ttl is None:
        req_ttl = torch.zeros((m,), dtype=torch.int64, device=dev)

    # Sort by (node, key, seq), stably: per-node work is contiguous.
    node_sk = torch.where(valid, req_node.to(torch.int64), INT32_MAX)
    perm = lexsort([node_sk] + [req_key[:, i] for i in range(N_LIMBS)]
                   + [req_seq], dim=0)
    s_node_sk = node_sk[perm]
    s_key = req_key[perm]
    s_seq, s_val, s_put = req_seq[perm], req_val[perm], req_put[perm]
    s_node = req_node[perm].to(torch.int64)
    s_size, s_ttl = req_size[perm], req_ttl[perm]
    s_valid = s_node >= 0

    # In-batch dedup: of the rows for one (node, key), the last (the
    # highest seq) survives.
    nxt_same = torch.zeros((m,), dtype=torch.bool, device=dev)
    nxt_same[:-1] = ((s_node_sk[:-1] == s_node_sk[1:])
                     & (s_key[:-1] == s_key[1:]).all(dim=-1))
    live = s_valid & ~nxt_same

    n_safe = s_node.clamp(0, n_nodes - 1)
    km = store.used[n_safe] & _key_match(store.keys, n_safe, s_key)  # [M,S]
    has_match = km.any(dim=-1)
    mslot = torch.argmax(km.to(torch.uint8), dim=-1)            # first match
    first = torch.searchsorted(s_node_sk, s_node_sk, side="left")

    # Edit policy: a higher seq, or an equal seq with the same token and
    # bytes; new keys are candidates for a ring slot.
    w = scfg.payload_words
    if put_payloads is None:
        s_pl = torch.zeros((m, w), dtype=torch.int64, device=dev)
    else:
        s_pl = put_payloads[s_put.clamp(0, put_payloads.shape[0] - 1).long()]
    cur_seq = store.seqs[n_safe, mslot]
    same = s_val == store.vals[n_safe, mslot]
    if w:
        same = same & (s_pl == store.payload[n_safe, mslot]).all(dim=-1)
    if scfg.verify:
        integ_ok = (sha1_words(s_pl) == s_key).all(dim=-1)
        live_ok = live & integ_ok
    else:
        live_ok = live
    upd = live_ok & has_match & ((s_seq > cur_seq)
                                 | ((s_seq == cur_seq) & same))
    new = live_ok & ~has_match
    if scfg.budget:
        # The node's stored bytes plus the batch's earlier-ranked growth
        # (new-key bytes and growing refreshes, one prefix sum) must stay
        # within the budget; sizes clamp to budget + 1 first.  int32
        # arithmetic as the JAX engine's, wrapping included.
        budget = min(scfg.budget, INT32_MAX - 1)
        s_sz = s_size.clamp(max=budget + 1)
        node_bytes = torch.where(store.used, store.sizes, 0).sum(dim=1)
        base = _wrap_i32(node_bytes[n_safe])
        old_size = _wrap_i32(torch.where(has_match,
                                         store.sizes[n_safe, mslot], 0))
        delta = _wrap_i32(s_sz - old_size)
        growth = _wrap_i32(torch.where(upd & (delta > 0), delta, 0)
                           + torch.where(new, s_sz, 0))
        cum = _wrap_i32(_segment_excl_sum(growth, first))
        upd = upd & (_wrap_i32(base + cum + delta.clamp(min=0)) <= budget)
        new = new & (_wrap_i32(base + cum + s_sz) <= budget)

    # Refreshes: distinct (node, slot) pairs — dedup leaves one row per
    # (node, key) and a stored key holds one slot.
    u = upd.nonzero().squeeze(1)
    un, us = s_node[u], mslot[u]
    _write_slots(store, un, us, s_val[u], s_seq[u], now, s_size[u],
                 s_ttl[u], s_pl[u] if w else None)

    # New keys: ring slots, at most `slots` a node a batch, and never a
    # slot a refresh of this batch just wrote.
    rank = _segment_rank(s_node_sk, new, first)
    slot = ((store.cursor[n_safe] + rank) & MASK32) % s
    upd_map = torch.zeros_like(store.used)
    upd_map[un, us] = True
    conflict = upd_map[n_safe, slot]
    accept_new = new & (rank < s) & ~conflict
    a = accept_new.nonzero().squeeze(1)
    nn, ns = s_node[a], slot[a]
    store.keys[nn, ns] = s_key[a]
    _write_slots(store, nn, ns, s_val[a], s_seq[a], now, s_size[a],
                 s_ttl[a], s_pl[a] if w else None)
    store.used[nn, ns] = True
    n_new = torch.zeros_like(store.cursor).index_add_(
        0, torch.where(accept_new, s_node, 0), accept_new.to(torch.int64))
    store.cursor.add_(n_new).bitwise_and_(MASK32)

    # Listener notification and value delivery.
    accepted = upd | accept_new
    ml = store.notified.shape[0]
    ls_n = store.lids.shape[1]
    lid = store.lids[n_safe]                                    # [M,LS]
    lexp = store.lexps[n_safe]
    lmatch = ((lid >= 0) & ((lexp == 0) | (now <= lexp))
              & _key_match(store.lkeys, n_safe, s_key) & accepted[:, None])
    lid_safe = lid.clamp(0, ml - 1).long()
    store.notified[lid_safe[lmatch]] = True
    # The winner per listener, explicitly: the highest seq (against the
    # one already delivered), then the highest request row among those.
    lidf = torch.where(lmatch, lid_safe, 0).reshape(-1)
    matchf = lmatch.reshape(-1)
    rowf = torch.arange(m, device=dev).repeat_interleave(ls_n)
    seq1f = s_seq.clamp(max=0xFFFFFFFE).repeat_interleave(ls_n) + 1
    nseqs = store.nseqs.scatter_reduce(
        0, lidf, torch.where(matchf, seq1f, 0), "amax")
    win1 = matchf & (seq1f == nseqs[lidf])
    rmax = torch.full((ml,), -1, dtype=torch.int64, device=dev
                      ).scatter_reduce(0, lidf, torch.where(win1, rowf, -1),
                                       "amax")
    deliver = rmax >= 0
    r_safe = rmax.clamp(0, max(m - 1, 0))
    if m:
        store.nvals.copy_(torch.where(deliver, s_val[r_safe], store.nvals))
        store.nseqs.copy_(torch.where(
            deliver, s_seq[r_safe].clamp(max=0xFFFFFFFE) + 1, store.nseqs))
        if w:
            store.npayload.copy_(torch.where(deliver[:, None], s_pl[r_safe],
                                             store.npayload))
        store.nsizes.copy_(torch.where(deliver, s_size[r_safe],
                                       store.nsizes))

    replicas = torch.zeros((m,), dtype=torch.int32, device=dev).index_add_(
        0, s_put.clamp(min=0).long(), accepted.to(torch.int32))

    def count(x):
        return x.sum().to(torch.int32)

    trace = StoreTrace(
        requests=count(valid), accepts_update=count(upd),
        accepts_new=count(accept_new),
        rejects=count(live_ok & ~upd & ~accept_new),
        notified=count(lmatch),
        integrity_rejects=(count(live & ~integ_ok) if scfg.verify
                           else torch.zeros((), dtype=torch.int32,
                                            device=dev)))
    return store, replicas, trace


def _write_slots(store: SwarmStore, node, slot, val, seq, now: int, size,
                 ttl, payload) -> None:
    """Write accepted values at distinct (node, slot) pairs, in place.
    The payload is written whenever the store has one (zeros for an
    announce without bytes), so a slot's bytes never outlive its value."""
    store.vals[node, slot] = val
    store.seqs[node, slot] = seq
    store.created[node, slot] = now
    store.sizes[node, slot] = size
    store.ttls[node, slot] = ttl
    if payload is not None:
        store.payload[node, slot] = payload


# ---------------------------------------------------------------------------
# public batched DHT operations
# ---------------------------------------------------------------------------

def _now(now) -> int:
    """A time stamp as the u32 the JAX engine uploads (``dev_u32``)."""
    return int(now) & MASK32


def _announce_targets(swarm: Swarm, cfg: SwarmConfig, keys: torch.Tensor,
                      generator=None, origins=None,
                      device=None) -> LookupResult:
    """The lookup phase of a put: each key's quorum closest nodes."""
    return lookup(swarm, cfg, keys, generator, origins=origins,
                  device=device)


def _announce_insert(alive: torch.Tensor, cfg: SwarmConfig,
                     store: SwarmStore, scfg: StoreConfig,
                     res_found: torch.Tensor, keys: torch.Tensor,
                     vals: torch.Tensor, seqs: torch.Tensor, now: int,
                     sizes: torch.Tensor | None = None,
                     ttls: torch.Tensor | None = None,
                     payloads: torch.Tensor | None = None):
    """One storage request per (put, found replica); dead replicas are
    masked.  Returns ``(store, replicas [P], StoreTrace)``."""
    p, q = res_found.shape
    req_node = _mask_dead_idx(alive, cfg, res_found.reshape(-1))

    def rep(x):
        return None if x is None else x.repeat_interleave(q, dim=0)

    put = torch.arange(p, dtype=torch.int32, device=res_found.device)
    store, rep_m, trace = _store_insert(
        store, scfg, req_node, rep(keys), rep(vals), rep(seqs), rep(put),
        _now(now), rep(sizes), rep(ttls), payloads)
    return store, rep_m[:p], trace


def drop_exchanges(found: torch.Tensor, drop_frac: float,
                   generator: torch.Generator | None = None, *,
                   keep: torch.Tensor | None = None) -> torch.Tensor:
    """Lose a ``drop_frac`` share of per-replica storage exchanges (each
    dropped entry becomes -1).  ``keep`` (``found``'s shape, bool — a
    test hands in the JAX package's draw) is taken as it is; otherwise
    ``generator`` draws it; with neither, or ``drop_frac`` 0, nothing is
    lost."""
    if not drop_frac:
        return found
    if keep is None:
        if generator is None:
            return found
        keep = torch.rand(found.shape, generator=generator,
                          device=found.device) >= drop_frac
    return torch.where(keep.to(found.device), found, -1)


def announce(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
             scfg: StoreConfig, keys: torch.Tensor, vals: torch.Tensor,
             seqs: torch.Tensor, now,
             generator: torch.Generator | None = None,
             sizes: torch.Tensor | None = None,
             ttls: torch.Tensor | None = None,
             payloads: torch.Tensor | None = None,
             drop_frac: float = 0.0,
             drop_generator: torch.Generator | None = None, *,
             drop_keep: torch.Tensor | None = None,
             origins: torch.Tensor | None = None,
             device=None):
    """Batched put: look up each key, store it at its quorum closest
    alive nodes.  ``keys [P,5]``, ``vals`` / ``seqs [P]`` (u32 in
    int64); optional ``sizes`` / ``ttls [P]`` and ``payloads [P,W]``;
    ``drop_frac`` with ``drop_generator`` or ``drop_keep`` loses storage
    exchanges (:func:`drop_exchanges`).  Returns ``(store,
    AnnounceReport)``; the store is updated in place."""
    res = _announce_targets(swarm, cfg, keys, generator, origins, device)
    found = drop_exchanges(res.found, drop_frac, drop_generator,
                           keep=drop_keep)
    store, replicas, trace = _announce_insert(
        swarm.alive, cfg, store, scfg, found, keys, vals, seqs, now, sizes,
        ttls, payloads)
    return store, AnnounceReport(replicas=replicas, hops=res.hops,
                                 done=res.done, trace=trace)


def _get_probe(alive: torch.Tensor, cfg: SwarmConfig, store: SwarmStore,
               scfg: StoreConfig, found: torch.Tensor, keys: torch.Tensor):
    """Probe the stores of each get's closest queried nodes; the
    freshest seq wins, then the largest token, then the first replica
    holding it.  With ``verify`` a replica whose bytes do not hash to
    the key is discarded before the merge.  Returns ``(hit, val, seq,
    payload, size)``."""
    n_safe = found.clamp(0, cfg.n_nodes - 1).long()
    ok = (found >= 0) & alive[n_safe]
    hit = (store.used[n_safe] & ok[..., None]
           & _key_match(store.keys, n_safe, keys[:, None, :]))   # [P,Q,S]
    if scfg.verify:
        cand_pl = store.payload[n_safe]                        # [P,Q,S,W]
        hit = hit & (sha1_words(cand_pl) == keys[:, None, None, :]).all(-1)
        del cand_pl
    seqs = store.seqs[n_safe]
    sseq = torch.where(hit, seqs, 0)
    best_seq = sseq.amax(dim=(1, 2))
    is_best = hit & (sseq == best_seq[:, None, None])
    vals = store.vals[n_safe]
    val = torch.where(is_best, vals, 0).amax(dim=(1, 2))
    any_hit = hit.any(dim=2).any(dim=1)
    p = found.shape[0]
    is_win = (is_best & (vals == val[:, None, None])).reshape(p, -1)
    widx = torch.argmax(is_win.to(torch.uint8), dim=1)
    sslots = scfg.slots
    node_w = torch.gather(n_safe, 1, (widx // sslots)[:, None])[:, 0]
    slot_w = widx % sslots
    if scfg.payload_words:
        pl = torch.where(any_hit[:, None], store.payload[node_w, slot_w], 0)
    else:
        pl = torch.zeros((p, 0), dtype=torch.int64, device=found.device)
    sz = torch.where(any_hit, store.sizes[node_w, slot_w], 0)
    return any_hit, val, best_seq, pl, sz


def _pick_payload(win: torch.Tensor, pls: torch.Tensor,
                  any_hit: torch.Tensor) -> torch.Tensor:
    """One winning replica's payload, picked by index (never a blend of
    replicas): ``win [M,K]`` winner mask, ``pls [M,K,W]``, ``any_hit
    [M]``; zeros on a miss."""
    widx = torch.argmax(win.to(torch.uint8), dim=1)
    pl = pls[torch.arange(pls.shape[0], device=pls.device), widx]
    return torch.where(any_hit[:, None], pl, 0)


def _sliced_probe(alive: torch.Tensor, cfg: SwarmConfig, store: SwarmStore,
                  scfg: StoreConfig, found: torch.Tensor, keys: torch.Tensor,
                  chunk: int = PROBE_CHUNK):
    """:func:`_get_probe` in ``chunk``-row slices (each row is probed on
    its own, so the slices give the same rows), bounding its
    ``[chunk, Q, S, W]`` planes."""
    parts = [_get_probe(alive, cfg, store, scfg, found[lo:lo + chunk],
                        keys[lo:lo + chunk])
             for lo in range(0, keys.shape[0], chunk)]
    return [torch.cat(x) for x in zip(*parts)]


def get_values(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
               scfg: StoreConfig, keys: torch.Tensor,
               generator: torch.Generator | None = None,
               chunk: int = PROBE_CHUNK, *,
               origins: torch.Tensor | None = None,
               device=None) -> GetResult:
    """Batched get: look up each key ``[P,5]``, return the freshest
    stored value among its closest queried nodes.  The probe runs in
    ``chunk``-row slices."""
    res = lookup(swarm, cfg, keys, generator, origins=origins, device=device)
    hit, val, seq, pl, _ = _sliced_probe(swarm.alive, cfg, store, scfg,
                                         res.found, keys, chunk)
    return GetResult(hit=hit, val=val, seq=seq, hops=res.hops, done=res.done,
                     payload=pl)


def _listen_insert(alive: torch.Tensor, cfg: SwarmConfig, store: SwarmStore,
                   scfg: StoreConfig, found: torch.Tensor, keys: torch.Tensor,
                   reg_ids: torch.Tensor, now: int) -> SwarmStore:
    """Register ``reg_ids`` for ``keys`` at the found live nodes, in
    place: each node's listener ring takes at most ``listen_slots`` a
    batch; out-of-range ids are dropped."""
    p, q = found.shape
    req_node = _mask_dead_idx(alive, cfg, found.reshape(-1)).to(torch.int64)
    req_key = keys.repeat_interleave(q, dim=0)
    req_id = reg_ids.repeat_interleave(q, dim=0)
    req_node = torch.where((req_id >= 0) & (req_id < scfg.max_listeners),
                           req_node, -1)
    return _listen_apply(store, scfg, req_node, req_key, req_id, now)


def _listen_apply(store: SwarmStore, scfg: StoreConfig,
                  req_node: torch.Tensor, req_key: torch.Tensor,
                  req_id: torch.Tensor, now: int) -> SwarmStore:
    """Write listener requests into ``store``'s tables, in place:
    ``req_node [M]`` rows of ``store`` (-1 = skip), ``req_key [M,5]``,
    ``req_id [M]``.  Rows sort by node, stably; each node's ring takes
    at most ``listen_slots`` of them, from its cursor on."""
    ls = scfg.listen_slots
    node_sk = torch.where(req_node >= 0, req_node, INT32_MAX)
    perm = torch.sort(node_sk, stable=True).indices
    s_node_sk, s_key = node_sk[perm], req_key[perm]
    s_id, s_node = req_id[perm], req_node[perm]
    live = s_node >= 0
    rank = _segment_rank(s_node_sk, live)
    accept = live & (rank < ls)
    n_safe = s_node.clamp(0, store.lcursor.shape[0] - 1)
    slot = ((store.lcursor[n_safe] + rank) & MASK32) % ls
    a = accept.nonzero().squeeze(1)
    nn, ns = s_node[a], slot[a]         # distinct: ranks < ls per node
    store.lkeys[nn, ns] = s_key[a]
    # graftlint: disable=narrow-cast-unproven (accepted rows have 0 <= req_id < max_listeners (the req_node mask above), which the interval of reg_ids cannot see)
    store.lids[nn, ns] = s_id[a].to(torch.int32)
    store.lexps[nn, ns] = ((now + scfg.listen_ttl) & MASK32
                           if scfg.listen_ttl else 0)
    n_new = torch.zeros_like(store.lcursor).index_add_(
        0, torch.where(accept, s_node, 0), accept.to(torch.int64))
    store.lcursor.add_(n_new).bitwise_and_(MASK32)
    return store


def listen_at(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
              scfg: StoreConfig, keys: torch.Tensor, reg_ids: torch.Tensor,
              generator: torch.Generator | None = None, now=0, *,
              origins: torch.Tensor | None = None, device=None):
    """Batched listen: register ``reg_ids [P]`` (int32) for ``keys
    [P,5]`` at each key's quorum closest nodes; later accepted announces
    of a key notify its listeners and fill their delivery slots.  With
    ``listen_ttl`` a registration lapses at ``now + listen_ttl`` unless
    refreshed.  Returns ``(store, LookupResult)``; the store is updated
    in place."""
    res = lookup(swarm, cfg, keys, generator, origins=origins, device=device)
    store = _listen_insert(swarm.alive, cfg, store, scfg, res.found, keys,
                           reg_ids, _now(now))
    return store, res


def refresh_listeners(store: SwarmStore, scfg: StoreConfig,
                      active: torch.Tensor, now) -> SwarmStore:
    """Re-register sweep: every table row whose id is ``active``
    (``[max_listeners]`` bool) expires at ``now + listen_ttl`` again;
    others keep their deadline.  No-op without ``listen_ttl``."""
    if not scfg.listen_ttl:
        return store
    lid_safe = store.lids.clamp(0, scfg.max_listeners - 1).long()
    hit = (store.lids >= 0) & active[lid_safe]
    exp = (_now(now) + scfg.listen_ttl) & MASK32
    return store._replace(lexps=torch.where(hit, exp, store.lexps))


def expire_listeners(store: SwarmStore, scfg: StoreConfig,
                     now) -> SwarmStore:
    """Free the listener rows whose expiry passed (they already stop
    matching; this frees their ring slots)."""
    dead = (store.lids >= 0) & (store.lexps > 0) & (store.lexps < _now(now))
    return store._replace(lids=torch.where(dead, -1, store.lids))


def _id_mask(reg_ids: torch.Tensor, ml: int) -> torch.Tensor:
    """``[ml]`` bool: the in-range ids of ``reg_ids``."""
    safe = torch.where((reg_ids >= 0) & (reg_ids < ml), reg_ids, ml)
    out = torch.zeros((ml + 1,), dtype=torch.bool, device=reg_ids.device)
    out[safe.long()] = True
    return out[:ml]


def _clear_delivery(store: SwarmStore, ids: torch.Tensor, **extra):
    return store._replace(
        notified=store.notified & ~ids,
        nseqs=torch.where(ids, 0, store.nseqs),
        nvals=torch.where(ids, 0, store.nvals),
        npayload=torch.where(ids[:, None], 0, store.npayload),
        nsizes=torch.where(ids, 0, store.nsizes), **extra)


def cancel_listen(store: SwarmStore, scfg: StoreConfig,
                  reg_ids: torch.Tensor) -> SwarmStore:
    """Cancel listeners everywhere: every table row of a cancelled id
    dies and its delivery slot clears; out-of-range ids are ignored."""
    ml = scfg.max_listeners
    cancel = _id_mask(reg_ids, ml)
    dead = (store.lids >= 0) & cancel[store.lids.clamp(0, ml - 1).long()]
    return _clear_delivery(store, cancel,
                           lids=torch.where(dead, -1, store.lids))


def ack_listeners(store: SwarmStore, reg_ids: torch.Tensor) -> SwarmStore:
    """The reader's ack: consume the delivery slots of ``reg_ids``, so
    the next accepted announce of a listened-for key delivers again."""
    return _clear_delivery(store, _id_mask(reg_ids,
                                           store.notified.shape[0]))


def expire(store: SwarmStore, scfg: StoreConfig, now) -> SwarmStore:
    """TTL sweep: a value's own ttl, else ``StoreConfig.ttl``, else
    none; the age ``now - created`` wraps as a u32."""
    age = (_now(now) - store.created) & MASK32
    eff = torch.where(store.ttls > 0, store.ttls, scfg.ttl)
    return store._replace(used=store.used & ((eff == 0) | (age <= eff)))


# ---------------------------------------------------------------------------
# republish
# ---------------------------------------------------------------------------

def _repub_extract(alive: torch.Tensor, store: SwarmStore,
                   node_idx: torch.Tensor, cfg: SwarmConfig,
                   scfg: StoreConfig):
    """Every (node, slot) row of ``node_idx`` as an announce batch:
    ``(keys, vals, seqs, sizes, ttls, payloads, ok)``, ``M·slots``
    rows, ``ok`` marking used slots of alive republishers."""
    n_safe = node_idx.clamp(0, cfg.n_nodes - 1).long()
    ok = ((node_idx >= 0)[:, None] & alive[n_safe][:, None]
          & store.used[n_safe]).reshape(-1)
    rows = n_safe.shape[0] * scfg.slots

    def flat(x):
        return x[n_safe].reshape(rows, *x.shape[2:])

    return (flat(store.keys), flat(store.vals), flat(store.seqs),
            flat(store.sizes), flat(store.ttls), flat(store.payload), ok)


def _mask_unowned(okf: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """Blank the lookup heads of rows whose slot is empty or dead."""
    return torch.where(okf[:, None], found, -1)


def pow2_width(m: int, floor: int) -> int:
    """Smallest power of two >= ``max(m, floor)``."""
    return max(floor, 1 << max(0, (m - 1)).bit_length())


# Smallest compacted maintenance width.
_REPUB_COMPACT_FLOOR = 256


def _repub_live(alive: torch.Tensor, store: SwarmStore,
                node_idx: torch.Tensor, cfg: SwarmConfig,
                scfg: StoreConfig):
    """Live-first order of a maintenance batch: ``(order [M·S] int64, a
    stable permutation with the live rows first, n_live [])``."""
    n_safe = node_idx.clamp(0, cfg.n_nodes - 1).long()
    ok = ((node_idx >= 0)[:, None] & alive[n_safe][:, None]
          & store.used[n_safe]).reshape(-1)
    order = torch.argsort((~ok).to(torch.uint8), stable=True)
    return order, ok.sum()


def _repub_extract_rows(alive: torch.Tensor, store: SwarmStore,
                        node_idx: torch.Tensor, rows: torch.Tensor,
                        cfg: SwarmConfig, scfg: StoreConfig):
    """:func:`_repub_extract` for the rows ``rows`` of the flat
    ``[M·slots]`` batch only."""
    s = scfg.slots
    node = node_idx[(rows // s).clamp(0, node_idx.shape[0] - 1)]
    n_safe = node.clamp(0, cfg.n_nodes - 1).long()
    slot = rows % s
    ok = (node >= 0) & alive[n_safe] & store.used[n_safe, slot]
    return (store.keys[n_safe, slot], store.vals[n_safe, slot],
            store.seqs[n_safe, slot], store.sizes[n_safe, slot],
            store.ttls[n_safe, slot], store.payload[n_safe, slot], ok)


def _repub_writeback(rows: torch.Tensor, replicas: torch.Tensor,
                     hops: torch.Tensor, done: torch.Tensor, m: int):
    """A compacted sweep's per-row report back at the full ``[M·slots]``
    shape (``rows`` distinct); rows not swept report 0 replicas, 0 hops,
    done."""
    rep = torch.zeros((m,), dtype=replicas.dtype, device=rows.device)
    hp = torch.zeros((m,), dtype=hops.dtype, device=rows.device)
    dn = torch.ones((m,), dtype=torch.bool, device=rows.device)
    rep[rows], hp[rows], dn[rows] = replicas, hops, done
    return rep, hp, dn


class _PhaseClock:
    """The phase boundaries of one call.  On the card each mark is a
    CUDA event on the current stream, so the split puts no barrier
    between phases: a barrier would drain the queue and lay each phase's
    host work end to end with the last one's device tail, and in eager
    torch that makes the phases of a republish sweep sum to more than
    the sweep takes unsplit (PERF.md §6).  On the CPU every operation
    has ended when it returns, and a mark is the host clock."""

    def __init__(self, dev: torch.device):
        self.stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                       else None)
        self.marks: list = []

    def mark(self) -> None:
        if self.stream is None:
            self.marks.append(time.perf_counter())
        else:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            self.marks.append(ev)

    def spans(self) -> list[float]:
        """Seconds between consecutive marks (on the card, after the
        last mark has been reached)."""
        m = self.marks
        if self.stream is None:
            return [b - a for a, b in zip(m, m[1:])]
        m[-1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]


def republish_from(swarm: Swarm, cfg: SwarmConfig, store: SwarmStore,
                   scfg: StoreConfig, node_idx: torch.Tensor, now,
                   generator: torch.Generator | None = None,
                   drop_frac: float = 0.0,
                   drop_generator: torch.Generator | None = None,
                   stats: dict | None = None, compact: bool = True, *,
                   drop_keep: torch.Tensor | None = None,
                   origins: torch.Tensor | None = None, device=None):
    """Chosen nodes ``node_idx [M]`` re-announce every value they hold,
    the maintenance that restores replication after churn.

    With ``compact`` (default) the live rows (used slots of alive
    republishers) are gathered first into a power-of-two batch of at
    least 256 rows, so the lookup prices about the live values instead
    of all ``M·slots`` rows (one readback of the live count); the report
    is scattered back to the full ``[M·slots]`` shape either way.
    ``origins``, where given, holds one origin per lookup row:
    ``stats["lookup_rows"]`` of the sweep.  ``stats`` with
    ``time_phases`` set receives ``extract_s``, ``lookup_s``,
    ``insert_s`` and ``sweep_total_s`` (their sum), split on the card by
    CUDA events at the phase boundaries, with no barrier between phases
    (:class:`_PhaseClock`); the call then waits for its last phase.
    Returns ``(store, AnnounceReport)``; the store is updated in
    place."""
    dev = resolve_device(device)
    timing = bool(stats) and stats.get("time_phases")
    clock = _PhaseClock(dev) if timing else None
    if timing:
        clock.mark()
    m = node_idx.shape[0] * scfg.slots
    rows = None
    if compact:
        order, n_live = _repub_live(swarm.alive, store, node_idx, cfg, scfg)
        wdt = min(m, pow2_width(int(n_live), _REPUB_COMPACT_FLOOR))
        if wdt < m:
            rows = order[:wdt]
    if rows is not None:
        keys, vals, seqs, sizes, ttls, payloads, okf = _repub_extract_rows(
            swarm.alive, store, node_idx, rows, cfg, scfg)
    else:
        keys, vals, seqs, sizes, ttls, payloads, okf = _repub_extract(
            swarm.alive, store, node_idx, cfg, scfg)
    if timing:
        clock.mark()
    res = lookup(swarm, cfg, keys, generator, origins=origins, device=dev)
    if timing:
        clock.mark()
    found = drop_exchanges(_mask_unowned(okf, res.found), drop_frac,
                           drop_generator, keep=drop_keep)
    store, replicas, trace = _announce_insert(
        swarm.alive, cfg, store, scfg, found, keys, vals, seqs, now, sizes,
        ttls, payloads if scfg.payload_words else None)
    hops, done = res.hops, res.done
    if rows is not None:
        replicas, hops, done = _repub_writeback(rows, replicas, hops, done,
                                                m)
    if timing:
        clock.mark()
        spans = clock.spans()
        stats["extract_s"], stats["lookup_s"], stats["insert_s"] = spans
        stats["sweep_total_s"] = sum(spans)
    if stats is not None:
        stats["lookup_rows"] = int(keys.shape[0])
        stats["batch_rows"] = m
    return store, AnnounceReport(replicas=replicas, hops=hops, done=done,
                                 trace=trace)
