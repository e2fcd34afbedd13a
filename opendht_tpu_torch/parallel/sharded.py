"""Mesh-sharded batched lookups over ``torch.distributed``.

Counterpart of ``opendht_tpu/parallel/sharded.py``.  Every function here
runs on each rank of a :class:`~opendht_tpu_torch.parallel.mesh.Mesh` —
the body JAX's ``shard_map`` runs per device — and every host decision
(loop exit, burst length, the ladder's row width, the rebalance width,
the merge-width rung) is taken from a collective's result, so all ranks
take it together.

Placement (JAX's partition specs): the swarm handed in is the rank's
shard — ``ids``, ``alive`` and ``byzantine`` whole on every rank, the
``tables`` rows ``[r·N/D, (r+1)·N/D)`` — and ``targets``, ``origins``
and every result are the rank's rows of the lookup batch.  Origins are
an argument, or drawn from an explicit per-rank ``torch.Generator``
(default seeded with the rank): JAX folds the shard index into its key,
which the port does not reproduce.

``data_parallel_lookup``
    The swarm replicated, the batch split: each rank runs the local
    engine on its rows, uncompacted, with no collective.

``sharded_lookup``
    The tables split over the ranks.  Each round every rank routes its
    α solicitations to the shard owning the solicited node in
    fixed-capacity buckets (one ``all_to_all``), owners answer from
    their local rows, and a second ``all_to_all`` brings the answers
    home; the round's merge is K1 on the card.  Two formulations — the
    while loop (one pending-count ``all_reduce`` a round) and the burst
    loop with its compaction ladder, optionally rebalancing pending rows
    across ranks — chosen as JAX chooses them.

Also the traced and chaos forms of the routed engine, and
``contended_lookup``, which emulates the capacity rule on one device.
"""

from __future__ import annotations

import math

import torch

from ..models.swarm import (
    LOOKUP_HEADROOM_BYTES,
    LookupFaults,
    LookupResult,
    LookupState,
    LookupTrace,
    Swarm,
    SwarmConfig,
    _censor_convicted,
    _finalize,
    _gather_span,
    _ladder_width,
    _local_respond,
    _permute_state,
    _prefix,
    _sample_origins,
    _scatter_rows,
    _select_alpha,
    _stable_done_perm,
    _writeback_prefix,
    burst_schedule,
    byz_colluder_pool,
    chaos_step_impl,
    device_memory_bytes,
    empty_lookup_trace,
    init_impl,
    init_lifecycle,
    lookup,
    resolve_device,
    resolve_merge_impl,
    run_burst_loop,
    step_impl,
    table_bytes,
)
from ..ops.round_parts import unpack_pair_window
from ..ops.u32 import U32_MAX, as_i32, prefix_len32, shl32
from ..ops.xor_metric import merge_ladder_widths, pick_merge_width
from .mesh import Mesh, gather_many, shard_rows


def _check_shard(swarm: Swarm, cfg: SwarmConfig, mesh: Mesh) -> None:
    d = mesh.size
    if cfg.n_nodes % d:
        raise ValueError(f"{cfg.n_nodes} nodes do not divide the {d}-rank "
                         f"mesh")
    if swarm.tables.shape[0] != cfg.n_nodes // d:
        raise ValueError(
            f"rank {mesh.rank} holds {swarm.tables.shape[0]} table rows; "
            f"its shard of {cfg.n_nodes} nodes over {d} ranks is "
            f"{cfg.n_nodes // d} (shard_rows)")
    if swarm.ids.device != mesh.device:
        raise ValueError(f"the swarm lives on {swarm.ids.device}, but the "
                         f"mesh computes on {mesh.device}")


def _origins(mesh: Mesh, alive: torch.Tensor, ll: int, generator,
             origins) -> torch.Tensor:
    """The rank's origins: given, or ``ll`` alive nodes drawn from
    ``generator`` (default seeded with the rank)."""
    if origins is not None:
        return origins.to(mesh.device)
    if generator is None:
        generator = torch.Generator(device=mesh.device).manual_seed(
            mesh.rank)
    return _sample_origins(generator, alive, ll)


def data_parallel_lookup(swarm: Swarm, cfg: SwarmConfig,
                         targets: torch.Tensor, mesh: Mesh,
                         generator: torch.Generator | None = None, *,
                         origins: torch.Tensor | None = None
                         ) -> LookupResult:
    """The swarm replicated (whole tables on every rank), this rank's
    rows of the batch: the local engine, UNCOMPACTED (JAX's repack is a
    global row permutation; the compacted form of this mode is the
    table-sharded engine's per-shard ladder).  No collective."""
    return lookup(swarm, cfg, targets,
                  origins=_origins(mesh, swarm.alive, targets.shape[0],
                                   generator, origins),
                  compact=False, device=mesh.device)


# ---------------------------------------------------------------------------
# the routed exchange
# ---------------------------------------------------------------------------

def _shard_positions(owner: torch.Tensor, ok: torch.Tensor,
                     n_shards: int) -> torch.Tensor:
    """Position of each query within its owner shard's capacity bucket,
    counting real queries only (masked rows would inflate shard 0)."""
    onehot = (owner[:, None] == torch.arange(n_shards, device=owner.device)
              ) & ok[:, None]
    pos = torch.cumsum(onehot.to(torch.int64), dim=0) - 1
    return torch.gather(pos, 1, owner.long()[:, None])[:, 0]


def _bucketize(owner: torch.Tensor, ok: torch.Tensor, n_shards: int,
               cap: int):
    """Sort-based capacity bucketing: one stable sort groups the
    requests by owner (arrival order kept, so positions equal
    :func:`_shard_positions`), a ``[D+1]`` ``searchsorted`` bounds each
    owner's run, slots fill by row gather from the sorted order.
    Returns ``(src [D, cap], pos [Q], sent [Q])``: the request filling
    each bucket slot (-1 empty), each request's position in its bucket,
    and whether it fits."""
    q = owner.shape[0]
    dev = owner.device
    okey = torch.where(ok, owner.long(), n_shards)
    s_okey, s_req = torch.sort(okey, stable=True)
    bounds = torch.searchsorted(
        s_okey, torch.arange(n_shards + 1, device=dev), side="left")
    start, end = bounds[:-1], bounds[1:]
    grid = start[:, None] + torch.arange(cap, device=dev)[None, :]
    valid = grid < torch.minimum(end, start + cap)[:, None]
    src = torch.where(valid, s_req[grid.clamp(0, max(q - 1, 0))], -1)
    rank_sorted = (torch.arange(q, device=dev)
                   - start[s_okey.clamp(0, n_shards - 1)])
    pos = torch.empty_like(rank_sorted)
    pos[s_req] = rank_sorted
    return src, pos, ok & (pos < cap)


def _fill_buckets(payload: torch.Tensor, src: torch.Tensor, n_shards: int,
                  cap: int, fill) -> torch.Tensor:
    """The ``[D, cap, W]`` shuffle buffer: ``payload`` rows by slot source
    (empty slots read ``fill``)."""
    q = payload.shape[0]
    srcf = src.reshape(-1).clamp(0, max(q - 1, 0))
    rows = torch.where((src >= 0).reshape(-1, 1), payload[srcf], fill)
    return rows.reshape(n_shards, cap, payload.shape[1])


def _capacity(nq: int, a: int, n_shards: int, capacity_factor: float) -> int:
    """Per-shard bucket capacity: ``min(nq, max(a, ceil(nq/D · cf)))``,
    or ``nq`` uncapped."""
    if math.isfinite(capacity_factor):
        return min(nq, max(a, int(math.ceil(nq / n_shards
                                            * capacity_factor))))
    return nq


def _route_respond(mesh: Mesh, tables_local: torch.Tensor,
                   ids: torch.Tensor, alive: torch.Tensor,
                   targets: torch.Tensor, nid: torch.Tensor,
                   nid_d0: torch.Tensor, cfg: SwarmConfig,
                   capacity_factor: float, cap_nq: int | None = None,
                   exchange: dict | None = None):
    """Answer solicitations whose tables live on other ranks.

    ``nid [Ll, A]`` global node indices (-1 none), ``nid_d0`` their
    first-limb distances to the target.  Queries ship ``(local_row,
    bucket)`` to the owner in buckets of ``cap`` slots (provisioned for
    ``cap_nq`` queries, default this call's ``Ll·A``); the owner reads
    its rows and ships the answers back — two ``all_to_all`` a round.
    Queries past an owner's capacity are dropped this round
    (``answered`` False) and retried next round.  Augmented tables ship
    the ``[lo K | hi K]`` halves of the bucket-pair window (u16 bytes);
    the origin rebuilds the s16 thirds from the replicated ids
    (:func:`_rebuild_pair_window`).  Plain tables ship member indices.
    Returns ``(resp [Ll, A·2K], resp_d0, answered [Ll, A])`` as the local
    respond does.  ``exchange`` (a dict) accumulates the solicitations
    shipped (``attempted``) and dropped past capacity (``dropped``) as
    device scalars (no readback)."""
    n, b_total, k = cfg.n_nodes, cfg.n_buckets, cfg.bucket_k
    d = mesh.size
    shard_n = n // d
    ll, a = nid.shape
    q = ll * a
    cap = _capacity(q if cap_nq is None else cap_nq, a, d, capacity_factor)
    flat = nid.reshape(-1)
    safe = flat.clamp(0, n - 1).long()
    ok = (flat >= 0) & alive[safe]
    c = prefix_len32(nid_d0.reshape(-1))
    c0 = c.clamp(0, b_total - 1)
    owner = (safe // shard_n).clamp(0, d - 1)
    local_row = torch.where(ok, safe - owner * shard_n, -1)
    src, pos, sent = _bucketize(owner, ok, d, cap)
    if exchange is not None:
        exchange["attempted"] = exchange.get("attempted", 0) + ok.sum()
        exchange["dropped"] = exchange.get("dropped", 0) + (ok & ~sent).sum()
    pay = torch.stack([local_row, c0], dim=-1).to(torch.int32)   # [Q,2]
    rbuf = mesh.all_to_all(_fill_buckets(pay, src, d, cap, -1))
    slot = owner * cap + pos.clamp(0, cap - 1)
    r_row = rbuf[..., 0]
    r_c0 = rbuf[..., 1].clamp(0, b_total - 1).long()
    safe_row = r_row.clamp(0, shard_n - 1).long()
    if tables_local.dtype == torch.uint16:                      # augmented
        w3 = 3 * k
        win = tables_local.view(torch.int16).unfold(1, 2 * w3, w3)[
            safe_row.reshape(-1), r_c0.clamp(0, b_total - 2).reshape(-1)]
        resp = torch.cat([win[:, :2 * k], win[:, w3:w3 + 2 * k]], dim=-1)
        resp = torch.where((r_row >= 0).reshape(-1, 1), resp, -1)
        back = mesh.all_to_all(resp.reshape(d, cap, 4 * k))
        mine = back.reshape(d * cap, -1)[slot].to(torch.int64) & 0xFFFF
        w0 = c0.clamp(0, b_total - 2)
        win6 = _rebuild_pair_window(mine, w0, ids, n, k)
        idx, d0 = unpack_pair_window(
            win6.view(ll, a, 2, w3), w0.view(ll, a), targets[:, 0],
            nid_d0, sent.view(ll, a), k)
        return idx.reshape(ll, -1), d0.reshape(ll, -1), sent.view(ll, a)
    r_c1 = (r_c0 + 1).clamp(0, b_total - 1)
    resp = torch.cat([_gather_span(tables_local, safe_row, r_c0, k),
                      _gather_span(tables_local, safe_row, r_c1, k)], dim=-1)
    resp = torch.where((r_row >= 0)[..., None], resp, -1)       # [D,C,2K]
    back = mesh.all_to_all(resp)
    mine = back.reshape(d * cap, -1)[slot]
    mine = torch.where(sent[:, None], mine, -1)
    r_idx = mine.reshape(ll, a * 2 * k)
    r_d0 = (ids[:, 0][mine.clamp(0, n - 1).long()].reshape(ll, a * 2 * k)
            ^ targets[:, 0][:, None])
    return (r_idx, torch.where(r_idx < 0, U32_MAX, r_d0),
            sent.view(ll, a))


def _rebuild_pair_window(mine: torch.Tensor, w0: torch.Tensor,
                         ids: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The ``[Q, 6K]`` augmented pair window from its ``[Q, 4K]`` wire
    form ``[lo0 K | hi0 K | lo1 K | hi1 K]`` (u16 values): each half's
    s16 third recomputed with the table builder's formula ``(m0 << b)
    >> 16`` at bucket ``b = w0 + r`` from the replicated ids — for an
    occupied slot the builder's own gather, for an empty one the same
    index-0 clip, so the window equals the stored one."""
    halves = []
    for r in range(2):
        part = mine[:, r * 2 * k:(r + 1) * 2 * k]
        idx = as_i32(part[:, :k] | (part[:, k:] << 16))
        m0 = ids[:, 0][idx.clamp(0, n - 1).long()]
        s16 = shl32(m0, (w0 + r)[:, None]) >> 16
        halves.append(torch.cat([part, s16], dim=-1))
    return torch.cat(halves, dim=-1)


def _make_responders(mesh: Mesh, cfg: SwarmConfig, capacity_factor: float,
                     local_respond: bool, swarm: Swarm,
                     cap_nq: int | None = None, exchange: dict | None = None,
                     init_exchange: dict | None = None):
    """``(respond_init, respond)``, one copy of the respond contract for
    every formulation.  The init exchange runs uncapped (a dropped seed
    would leave an empty shortlist).  ``local_respond`` — the 1-rank
    decomposition aid — answers with the local engine's reads.
    ``exchange`` counts the rounds' solicitations, ``init_exchange`` the
    init's (:func:`_route_respond`)."""
    if local_respond:
        if mesh.size != 1:
            raise ValueError("local_respond is a 1-rank measurement aid")
        r = _local_respond(swarm, cfg)
        return r, r
    args = (mesh, swarm.tables, swarm.ids, swarm.alive)

    def respond(tg, nid, d0):
        return _route_respond(*args, tg, nid, d0, cfg, capacity_factor,
                              cap_nq=cap_nq, exchange=exchange)

    def respond_init(tg, nid, d0):
        return _route_respond(*args, tg, nid, d0, cfg, float("inf"),
                              exchange=init_exchange)

    return respond_init, respond


def _pending(mesh: Mesh, st: LookupState) -> int:
    """The mesh's pending row count (one ``all_reduce``)."""
    return int(mesh.all_reduce((~st.done).sum().to(torch.int64), "sum"))


def _done_everywhere(mesh: Mesh):
    """``done_of`` for :func:`run_burst_loop`: a 0-dim tensor true where
    no rank has a pending row."""
    return lambda s: mesh.all_reduce((~s.done).sum(), "sum") == 0


# ---------------------------------------------------------------------------
# the two formulations
# ---------------------------------------------------------------------------

def sharded_lookup_init(swarm: Swarm, cfg: SwarmConfig,
                        targets: torch.Tensor, mesh: Mesh,
                        origins: torch.Tensor,
                        skip: torch.Tensor | None = None,
                        exchange: dict | None = None, *,
                        local_respond: bool = False) -> LookupState:
    """The routed seed exchange (uncapped) for this rank's rows.  Rows
    marked ``skip`` have their origin blanked to -1, so they never ride
    the ``all_to_all`` (how a cache hit stays off it); the other rows
    equal the unmasked init.  ``exchange`` accumulates the solicitations
    that rode it (:func:`_route_respond`)."""
    if skip is not None:
        origins = torch.where(skip, -1, origins)
    respond_init, _ = _make_responders(mesh, cfg, float("inf"),
                                       local_respond, swarm,
                                       init_exchange=exchange)
    return init_impl(swarm.ids, respond_init, cfg, targets, origins)


def sharded_lookup_step(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                        mesh: Mesh, capacity_factor: float = 2.0, *,
                        local_respond: bool = False,
                        cap_nq: int | None = None, rnd=None,
                        merge_w: int | None = None,
                        exchange: dict | None = None) -> LookupState:
    """One routed round on this rank's rows (``rnd`` for the lifecycle
    plane; ``cap_nq`` pins the capacity provisioning of a truncated
    dispatch to the full batch; ``exchange`` accumulates the
    solicitations that rode the round's ``all_to_all``).  Every
    formulation's round goes through here, so the cost ledger's
    ``sharded.sharded_lookup_step`` row sees each routed round."""
    _, respond = _make_responders(mesh, cfg, capacity_factor,
                                  local_respond, swarm, cap_nq,
                                  exchange=exchange)
    return step_impl(swarm.ids, swarm.alive, respond, cfg, st, rnd=rnd,
                     merge_w=merge_w)


def _lookup_while(mesh, swarm, cfg, targets, origins, capacity_factor,
                  local_respond, exchange=None):
    """The while formulation: after the init, one round per loop trip
    while the mesh's pending count (an ``all_reduce`` a round) is
    positive, up to ``max_steps`` rounds."""
    st = sharded_lookup_init(swarm, cfg, targets, mesh, origins,
                             local_respond=local_respond)
    it = 0
    while it < cfg.max_steps and _pending(mesh, st) > 0:
        st = sharded_lookup_step(swarm, cfg, st, mesh, capacity_factor,
                                 local_respond=local_respond,
                                 exchange=exchange)
        it += 1
    return LookupResult(found=_finalize(swarm.ids, st, cfg), hops=st.hops,
                        done=st.done)


def _table_bytes_per_device(cfg: SwarmConfig, n_shards: int) -> int:
    return table_bytes(cfg) // max(1, n_shards)


def _shard_pending_and_wneed(mesh: Mesh, st: LookupState, cfg: SwarmConfig):
    """The per-burst readback of the sharded ladder, every rank getting
    the same answer: each rank's pending count (one ``all_gather``) and
    the mesh-wide live-slot watermark (its maximum)."""
    pending = (~st.done).sum()
    unq = ((st.idx >= 0) & ~st.queried).sum(dim=1)
    blocks = torch.where(st.done, 0, unq.clamp(max=cfg.alpha))
    wneed = blocks.max() * (2 * cfg.bucket_k)
    g = mesh.all_gather(torch.stack([pending, wneed]).to(torch.int64))
    host = g.tolist()
    return [p for p, _ in host], max(w for _, w in host)


# ---------------------------------------------------------------------------
# compaction and rebalance
# ---------------------------------------------------------------------------

def _compact(full: LookupState, order: torch.Tensor, w: int):
    """Stable pending-first repack of this rank's rows; ``(full, order,
    prefix of width w)``."""
    perm = _stable_done_perm(full.done)
    full = _permute_state(full, perm)
    return full, order[perm], _prefix(full, w)


def _pack_rows(st: LookupState, order: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """State rows for the rebalance shuffle, ``[Ll, 10+3S]`` int64:
    [valid | dest position | original row | hops | done | targets 5 |
    idx S | dist S | queried S]."""
    c = lambda x: x.to(torch.int64)[:, None]  # noqa: E731
    return torch.cat(
        [c(torch.ones_like(pos)), c(pos), c(order), c(st.hops), c(st.done),
         st.targets, st.idx.to(torch.int64), st.dist,
         st.queried.to(torch.int64)], dim=1)


def _unpack_rows(rows: torch.Tensor, s: int):
    st = LookupState(
        # graftlint: disable=narrow-cast-unproven (idx was int32 columns packed by _pack_rows (exact widening); the packed matrix's interval joins every column)
        targets=rows[:, 5:10], idx=rows[:, 10:10 + s].to(torch.int32),
        dist=rows[:, 10 + s:10 + 2 * s],
        queried=rows[:, 10 + 2 * s:10 + 3 * s] != 0,
        # graftlint: disable=narrow-cast-unproven (hops was an int32 column packed by _pack_rows (exact widening); the packed matrix's interval joins every column)
        done=rows[:, 4] != 0, hops=rows[:, 3].to(torch.int32))
    return st, rows[:, 2]


def _rebalance(mesh: Mesh, cfg: SwarmConfig, w: int, st: LookupState,
               order: torch.Tensor):
    """Lossless cross-rank repack: every row gets a global stable rank
    (pending first, by rank then position) and moves to rank ``g % D``,
    position ``g // D`` — one ``all_to_all`` at capacity ``Ll`` (a rank
    holds at most ``Ll`` rows, so nothing overflows).  Returns ``(full,
    order, prefix of width w)``."""
    ll = st.done.shape[0]
    d, me = mesh.size, mesh.rank
    dev = st.done.device
    pending = ~st.done
    counts = mesh.all_gather(pending.sum().reshape(1)).reshape(d)
    start = counts[:me].sum()
    total = counts.sum()
    lp = torch.cumsum(pending.to(torch.int64), 0) - 1
    ld = torch.cumsum((~pending).to(torch.int64), 0) - 1
    g = torch.where(pending, start + lp, total + me * ll - start + ld)
    dest, pos = g % d, g // d
    pay = _pack_rows(st, order, pos)
    src, _, _ = _bucketize(dest, torch.ones((ll,), dtype=torch.bool,
                                            device=dev), d, ll)
    back = mesh.all_to_all(_fill_buckets(pay, src, d, ll, 0)).reshape(
        d * ll, -1)
    rpos = torch.where(back[:, 0] == 1, back[:, 1], ll)
    got = torch.zeros((ll + 1, pay.shape[1]), dtype=pay.dtype, device=dev)
    got[rpos] = back            # every position once; the rest → spare row
    full, order = _unpack_rows(got[:ll], cfg.search_width)
    return full, order, _prefix(full, w)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

def sharded_lookup(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
                   mesh: Mesh, generator: torch.Generator | None = None, *,
                   origins: torch.Tensor | None = None,
                   capacity_factor: float = 2.0,
                   local_respond: bool = False,
                   compact: bool | None = None, rebalance: bool = False,
                   stats: dict | None = None,
                   track_lifecycle: bool = False,
                   exchange: dict | None = None) -> LookupResult:
    """This rank's rows of a lookup batch with the routing tables split
    over ``mesh`` (``swarm`` is the rank's shard; ``targets``/``origins``
    its rows; the result its rows).  ``capacity_factor`` sizes each
    owner's buckets against the uniform load; queries past it retry next
    round.  ``local_respond`` is the 1-rank decomposition aid.

    Formulations, chosen as JAX chooses them: the while loop where the
    table fits twice in device memory beside the headroom and neither
    ``compact=True``, ``rebalance`` nor ``track_lifecycle`` is asked;
    else the burst loop — uncompacted with ``compact=False``, otherwise
    with the per-rank compaction ladder (capacity provisioned at the
    full batch width, so the result equals the uncompacted one), and
    with ``rebalance`` the lossless cross-rank repack between bursts
    (equal to the uncompacted result at ``capacity_factor=inf`` only).
    ``stats`` receives ``formulation`` and, for the compacted loops,
    ``rounds_dispatched``, ``dispatched_row_rounds``,
    ``mean_active_frac``, ``widths`` and (with the plain rank merge)
    ``merge_widths``; with ``track_lifecycle``, the rank's
    ``admitted_round`` / ``completed_round`` rows.  ``exchange`` receives
    this rank's shipped and capacity-dropped solicitation counts
    (:func:`_route_respond`)."""
    if rebalance and compact is False:
        raise ValueError("rebalance=True requires the compacted burst "
                         "formulation (compact must not be False)")
    if track_lifecycle and rebalance:
        raise ValueError("track_lifecycle is not supported with "
                         "rebalance=True")
    _check_shard(swarm, cfg, mesh)
    d = mesh.size
    targets = targets.to(mesh.device)
    ll = targets.shape[0]
    origins = _origins(mesh, swarm.alive, ll, generator, origins)
    fits_while = (2 * _table_bytes_per_device(cfg, d)
                  + LOOKUP_HEADROOM_BYTES
                  <= device_memory_bytes(mesh.device))
    if compact is not True and not rebalance and not track_lifecycle \
            and fits_while:
        if stats is not None:
            stats["formulation"] = "while"
        return _lookup_while(mesh, swarm, cfg, targets, origins,
                             capacity_factor, local_respond, exchange)
    st = sharded_lookup_init(swarm, cfg, targets, mesh, origins,
                             local_respond=local_respond)
    if track_lifecycle:
        st = init_lifecycle(st)
    rnd_of = (lambda r: r) if track_lifecycle else (lambda r: None)
    if compact is False:
        if stats is not None:
            stats["formulation"] = "burst"
        st = run_burst_loop(
            lambda s, r: sharded_lookup_step(
                swarm, cfg, s, mesh, capacity_factor,
                local_respond=local_respond, rnd=rnd_of(r),
                exchange=exchange),
            st, cfg, done_of=_done_everywhere(mesh))
        if track_lifecycle and stats is not None:
            stats["admitted_round"] = st.admitted_round
            stats["completed_round"] = st.completed_round
        return LookupResult(found=_finalize(swarm.ids, st, cfg),
                            hops=st.hops, done=st.done)

    l = ll * d
    order = torch.arange(mesh.rank * ll, (mesh.rank + 1) * ll,
                         device=mesh.device)
    full, sub, w = st, st, ll
    burst = max(2, burst_schedule(cfg) - 2)
    rounds = row_rounds = 0
    widths: list = []
    resp_w = cfg.alpha * 2 * cfg.bucket_k
    width_ladder = (resolve_merge_impl(cfg, mesh.device) == "rank"
                    and len(merge_ladder_widths(resp_w,
                                                2 * cfg.bucket_k)) > 1)
    merge_w = None
    merge_widths: list = []
    while rounds < cfg.max_steps:
        n = min(burst, cfg.max_steps - rounds)
        for _ in range(n):
            sub = sharded_lookup_step(
                swarm, cfg, sub, mesh, capacity_factor,
                local_respond=local_respond, cap_nq=ll * cfg.alpha,
                rnd=rnd_of(rounds), merge_w=merge_w, exchange=exchange)
            rounds += 1
            row_rounds += w * d
        if w not in widths:
            widths.append(w)
        if merge_w not in merge_widths:
            merge_widths.append(merge_w)
        # graftlint: disable=sync-in-loop (per-burst pending + watermark readback across the mesh, one all_gather and one transfer a burst: it steers the ladder (_sharded_resident_step is the zero-poll alternative))
        pend, wneed = _shard_pending_and_wneed(mesh, sub, cfg)
        total = sum(pend)
        if total == 0:
            break
        burst = 2
        if width_ladder:
            merge_w = pick_merge_width(wneed, resp_w, 2 * cfg.bucket_k)
        w_new = _ladder_width(-(-total // d) if rebalance else max(pend), ll)
        if w_new < w:
            full = sub if w == ll else _writeback_prefix(full, sub)
            if rebalance:
                full, order, sub = _rebalance(mesh, cfg, w_new, full, order)
            else:
                full, order, sub = _compact(full, order, w_new)
            w = w_new
    full = _writeback_prefix(full, sub) if w < ll else sub
    if stats is not None:
        stats["formulation"] = ("burst-rebalanced" if rebalance
                                else "burst-compacted")
        stats["rounds_dispatched"] = rounds
        stats["dispatched_row_rounds"] = row_rounds
        stats["mean_active_frac"] = (
            round(row_rounds / (rounds * l), 4) if rounds else 0.0)
        stats["widths"] = widths
        if width_ladder:
            stats["merge_widths"] = [resp_w if mw is None else mw
                                     for mw in merge_widths]
    found = _finalize(swarm.ids, full, cfg)
    if rebalance:
        # Rows crossed ranks: put every row back at its global position,
        # then keep this rank's rows.
        cols = torch.cat([order[:, None], found.to(torch.int64),
                          full.hops.to(torch.int64)[:, None],
                          full.done.to(torch.int64)[:, None]], dim=1)
        allc = mesh.all_gather(cols).reshape(l, -1)
        back = _scatter_rows(allc[:, 1:], allc[:, 0])
        mine = shard_rows(mesh, back)
        q = cfg.quorum
        return LookupResult(found=mine[:, :q].to(torch.int32),
                            hops=mine[:, q].to(torch.int32),
                            done=mine[:, q + 1] != 0)
    local = order - mesh.rank * ll
    if track_lifecycle and stats is not None:
        stats["admitted_round"] = _scatter_rows(full.admitted_round, local)
        stats["completed_round"] = _scatter_rows(full.completed_round, local)
    return LookupResult(found=_scatter_rows(found, local),
                        hops=_scatter_rows(full.hops, local),
                        done=_scatter_rows(full.done, local))


# ---------------------------------------------------------------------------
# the mesh resident macro step
# ---------------------------------------------------------------------------

def gather_seeded(mesh: Mesh, new: LookupState) -> LookupState:
    """Every rank's rows of a routed init (``targets``, ``idx``, ``dist``,
    ``queried``), whole on every rank: one ``all_gather``."""
    return new._replace(**dict(zip(LookupState._fields,
                                   gather_many(mesh, new[:4]))))


def _resident_rounds_routed(mesh: Mesh, swarm: Swarm, cfg: SwarmConfig,
                            st: LookupState, rnd0, rounds: int,
                            capacity_factor: float, gated: bool):
    """Up to ``rounds`` routed rounds (round ``rnd0 + it``) on this rank's
    rows, stopping once no rank has a pending row — JAX's
    psum-synchronised ``while_loop``.  Each trip's mesh pending count is
    an ``all_reduce``: read on the host in the early-exit form
    (``gated=False``), kept on the device in the gated form, which runs
    every trip and keeps the old state where the trip is inactive (the
    form a CUDA graph captures).  The capacity is provisioned for this
    call's rows (the burst engine's, so the replay equals
    ``sharded_lookup(compact=False)``).  Returns ``(state, rounds_run,
    xchg_round_rows)``: the trips run, and the mesh's pending rows × α
    summed over them (the exchange's provisioned solicitation rows)."""
    dev = st.done.device
    alpha = cfg.alpha

    def pending(s):
        return mesh.all_reduce((~s.done).sum().to(torch.int32), "sum")

    if not gated:
        it = xr = 0
        while it < rounds:
            # graftlint: disable=sync-in-loop,tracer-coercion,host-callback (the early-exit form (gated=False) runs eagerly only, one psum'd poll a round as JAX's while_loop cond; a capture takes the gated form)
            n_pend = int(pending(st))
            if n_pend == 0:
                break
            st = sharded_lookup_step(swarm, cfg, st, mesh, capacity_factor,
                                     rnd=rnd0 + it)
            xr += n_pend * alpha
            it += 1
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        return st, i32(it), i32(xr)
    run = torch.zeros((), dtype=torch.int32, device=dev)
    xr = torch.zeros((), dtype=torch.int32, device=dev)
    for it in range(rounds):
        n_pend = pending(st)
        active = n_pend > 0
        new = sharded_lookup_step(swarm, cfg, st, mesh, capacity_factor,
                                  rnd=rnd0 + it)
        st = LookupState(*[o if n is o else torch.where(active, n, o)
                           for n, o in zip(new, st)])
        run = run + active.to(torch.int32)
        xr = xr + n_pend * alpha
    return st, run, xr


def _sharded_resident_step(mesh: Mesh, swarm: Swarm, cfg: SwarmConfig,
                           st: LookupState, rings, cache, keys: torch.Tensor,
                           reqs: torch.Tensor, cls: torch.Tensor,
                           origins: torch.Tensor, n_new, rnd0,
                           capacity_factor: float, rounds: int,
                           expire: bool = True, gated: bool = False,
                           exchange: dict | None = None):
    """The mesh resident macro step: enqueue → pop → the replicated cache
    probe → the MASKED routed init → the slot scatter → the routed round
    loop → the shared harvest tail.

    Layout: every rank holds the ``[C]`` serve state, the rings and the
    cache whole, the same on every rank (JAX treats them as global
    outside its ``shard_map``: the pop reads every slot's free mask, the
    scatter takes global slots, the tail fills the replicated cache).
    The routed init seeds this rank's rows ``[r·A/D, (r+1)·A/D)`` of the
    popped batch from ``origins`` (the whole ``[A]`` batch's, JAX's
    per-shard draws concatenated) — hit and padding rows never ride the
    ``all_to_all`` — and one ``all_gather`` makes the seeded rows whole;
    the round loop runs on this rank's slots ``[r·C/D, (r+1)·C/D)``
    (:func:`_resident_rounds_routed`) and one ``all_gather`` makes the
    state whole again.  Every round is the burst path's routed round at
    the same round index, so the replay equals
    ``sharded_lookup(compact=False)``.  Returns ``(st, rings, cache,
    ResidentOut)`` with ``rung_counts = [0]`` and the exchange counters
    ``xchg_init_rows`` (rows admitted) and ``xchg_round_rows``.
    ``exchange`` receives the solicitations this rank's rows shipped on
    the init ``all_to_all`` (``attempted``, a device scalar), counted
    in the exchange itself."""
    from ..models import serve as sv
    c = st.done.shape[0]
    a = keys.shape[0]
    dev = st.done.device
    rings = sv._ring_enqueue(rings, keys, reqs, cls, n_new)
    rings, pkeys, preq, pcls, cand, valid = sv._ring_pop(st, rings, a)
    if cache is not None:
        hit_raw, h_found, h_hops = sv._probe_impl(cache, pkeys)
        hit = hit_raw & valid
    else:
        hit = torch.zeros((a,), dtype=torch.bool, device=dev)
        h_found = torch.full((a, cfg.quorum), -1, dtype=torch.int32,
                             device=dev)
        h_hops = torch.zeros((a,), dtype=torch.int32, device=dev)
    take = valid & ~hit
    new = gather_seeded(mesh, sharded_lookup_init(
        swarm, cfg, shard_rows(mesh, pkeys), mesh, shard_rows(mesh, origins),
        skip=shard_rows(mesh, ~take), exchange=exchange))
    eff = torch.where(take, cand, c)
    st = sv._scatter_rows_into(st, new, eff, rnd0)
    rings = rings._replace(slot_req=sv._set_rows(rings.slot_req, eff, preq),
                           slot_cls=sv._set_rows(rings.slot_cls, eff, pcls))
    mine = LookupState(*[shard_rows(mesh, x) for x in st])
    mine, rounds_run, xchg_round = _resident_rounds_routed(
        mesh, swarm, cfg, mine, rnd0, rounds, capacity_factor, gated)
    st = LookupState(*gather_many(mesh, mine))
    st, cache, comp, fin = sv._resident_tail(swarm.ids, cfg, st, cache,
                                             rnd0 + rounds, expire)
    adm = take.sum().to(torch.int32)
    out = sv.ResidentOut(
        adm=adm, hits=hit.sum().to(torch.int32),
        queued=rings.tail - rings.head, head=rings.head, tail=rings.tail,
        shed=rings.shed, rounds_run=rounds_run, hit=hit,
        hit_req=torch.where(hit, preq, -1), hit_found=h_found,
        hit_hops=h_hops, comp=comp,
        comp_req=torch.where(comp, rings.slot_req, -1),
        comp_cls=torch.where(comp, rings.slot_cls, -1),
        comp_hops=st.hops, comp_adm=st.admitted_round,
        comp_com=st.completed_round, comp_found=fin,
        rung_counts=torch.zeros((1,), dtype=torch.int32, device=dev),
        xchg_init_rows=adm, xchg_round_rows=xchg_round)
    st = st._replace(admitted_round=torch.where(comp, -1, st.admitted_round))
    rings = rings._replace(
        slot_req=torch.where(comp, -1, rings.slot_req),
        slot_cls=torch.where(comp, -1, rings.slot_cls))
    return st, rings, cache, out


# ---------------------------------------------------------------------------
# the flight recorder on the routed path
# ---------------------------------------------------------------------------

# Trace rows computed from state every rank holds the same (the strike
# counters are merged every round; ``rounds`` is lock-step) reduce with
# MAX; the per-rank partial counts reduce with SUM.
_TRACE_MAX_FIELDS = ("strikes", "convictions", "rounds")


def _trace_allreduce(mesh: Mesh, trace: LookupTrace) -> LookupTrace:
    """The whole trace reduced over the mesh once, at loop exit: two
    ``all_reduce`` s (the SUM rows stacked, the MAX rows stacked); the
    result is the same on every rank."""
    f = LookupTrace._fields
    sums = [n for n in f if n not in _TRACE_MAX_FIELDS]
    maxs = [n for n in f if n in _TRACE_MAX_FIELDS and n != "rounds"]
    d = dict(zip(f, trace))
    s = mesh.all_reduce(torch.stack([d[n] for n in sums]), "sum")
    m = mesh.all_reduce(torch.cat([torch.stack([d[n] for n in maxs]
                                               ).reshape(-1),
                                   d["rounds"].reshape(1)]), "max")
    out = dict(zip(sums, s.unbind(0)))
    steps = trace.requests.shape[0]
    for i, n in enumerate(maxs):
        out[n] = m[i * steps:(i + 1) * steps]
    out["rounds"] = m[-1]
    return LookupTrace(**out)


def traced_sharded_lookup(swarm: Swarm, cfg: SwarmConfig,
                          targets: torch.Tensor, mesh: Mesh,
                          generator: torch.Generator | None = None, *,
                          origins: torch.Tensor | None = None,
                          capacity_factor: float = 2.0
                          ) -> tuple[LookupResult, LookupTrace]:
    """Routed lookups with the flight recorder on (the while
    formulation): ``(this rank's result, the mesh-reduced trace)``.
    Counters accumulate per rank and reduce once at exit."""
    _check_shard(swarm, cfg, mesh)
    targets = targets.to(mesh.device)
    origins = _origins(mesh, swarm.alive, targets.shape[0], generator,
                       origins)
    respond_init, respond = _make_responders(mesh, cfg, capacity_factor,
                                             False, swarm)
    st = init_impl(swarm.ids, respond_init, cfg, targets, origins)
    trace = empty_lookup_trace(cfg, mesh.device)
    it = 0
    while it < cfg.max_steps and _pending(mesh, st) > 0:
        st, trace = step_impl(swarm.ids, swarm.alive, respond, cfg, st,
                              trace=trace, rnd=it)
        it += 1
    res = LookupResult(found=_finalize(swarm.ids, st, cfg), hops=st.hops,
                       done=st.done)
    return res, _trace_allreduce(mesh, trace)


# ---------------------------------------------------------------------------
# adversarial lookups on the routed path
# ---------------------------------------------------------------------------

def chaos_sharded_lookup(swarm: Swarm, cfg: SwarmConfig,
                         targets: torch.Tensor, mesh: Mesh,
                         generator: torch.Generator | None = None,
                         faults: LookupFaults = LookupFaults(), *,
                         origins: torch.Tensor | None = None,
                         capacity_factor: float = 2.0,
                         collect_trace: bool = False):
    """Routed adversarial lookups (the while formulation): the shared
    chaos round over the routed respond, the strike events merged over
    the mesh every round (one stacked ``[3, N]`` ``all_reduce``), so a
    node convicted by one rank's lookups leaves every rank's shortlists
    the same round.  Capacity drops never strike.  Origins default to
    honest alive nodes.  Returns ``(this rank's result, strikes [N])``,
    plus the mesh-reduced trace with ``collect_trace``."""
    _check_shard(swarm, cfg, mesh)
    targets = targets.to(mesh.device)
    byz = (swarm.byzantine if swarm.byzantine is not None
           else torch.zeros_like(swarm.alive))
    swarm = swarm._replace(byzantine=byz)
    origins = _origins(mesh, swarm.alive & ~byz, targets.shape[0],
                       generator, origins)
    respond_init, respond = _make_responders(mesh, cfg, capacity_factor,
                                             False, swarm)
    st = init_impl(swarm.ids, respond_init, cfg, targets, origins)
    strikes = torch.zeros((cfg.n_nodes,), dtype=torch.int32,
                          device=mesh.device)
    byz_aux = byz_colluder_pool(byz) if faults.eclipse else None
    trace = empty_lookup_trace(cfg, mesh.device) if collect_trace else None
    it = 0
    while it < cfg.max_steps and _pending(mesh, st) > 0:
        out = chaos_step_impl(
            swarm, cfg, faults, st, strikes, it, byz_aux, trace=trace,
            respond=respond,
            allreduce=lambda x: mesh.all_reduce(x, "sum"))
        st, strikes = out[0], out[1]
        it += 1
    found = _censor_convicted(_finalize(swarm.ids, st, cfg), strikes, cfg,
                              faults)
    res = LookupResult(found=found, hops=st.hops, done=st.done)
    if collect_trace:
        return res, strikes, _trace_allreduce(mesh, trace)
    return res, strikes


# ---------------------------------------------------------------------------
# the capacity rule emulated on one device
# ---------------------------------------------------------------------------

def contended_lookup(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
                     n_shards: int, capacity_factor: float,
                     generator: torch.Generator | None = None, *,
                     origins: torch.Tensor | None = None, device=None
                     ) -> tuple[LookupResult, torch.Tensor, torch.Tensor]:
    """A lookup batch under the sharded transport's capacity rule with
    ``n_shards`` *logical* owner ranges on one device, no collective:
    each round a solicitation past its owner's ``C = cf · Q/S`` slots is
    dropped (retried next round), with :func:`_shard_positions`'
    arithmetic.  Returns ``(result, dropped, attempted)`` — query counts
    summed over the rounds (0-dim int64 tensors)."""
    dev = resolve_device(device)
    targets = targets.to(dev)
    n = cfg.n_nodes
    shard_n = n // n_shards
    cap = _capacity(targets.shape[0] * cfg.alpha, cfg.alpha, n_shards,
                    capacity_factor)
    base = _local_respond(swarm, cfg)

    def sent_mask(nid):
        flat = nid.reshape(-1)
        safe = flat.clamp(0, n - 1).long()
        ok = (flat >= 0) & swarm.alive[safe]
        owner = (safe // shard_n).clamp(0, n_shards - 1)
        pos = _shard_positions(owner, ok, n_shards)
        return (ok & (pos < cap)).view(nid.shape), ok

    def respond(tg, nid, nid_d0):
        resp, d0, ans = base(tg, nid, nid_d0)
        sent, _ = sent_mask(nid)
        m = sent.repeat_interleave(resp.shape[1] // nid.shape[1], dim=1)
        return (torch.where(m, resp, -1), torch.where(m, d0, U32_MAX),
                ans & sent)

    if origins is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        origins = _sample_origins(generator, swarm.alive, targets.shape[0])
    st = init_impl(swarm.ids, base, cfg, targets, origins.to(dev))
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    attempted = torch.zeros((), dtype=torch.int64, device=dev)
    # graftlint: disable=sync-in-loop (the eager form of JAX's jitted while_loop: one done / hop-bound poll a round, the capacity study's path, never a serving one)
    while not bool(st.done.all()) and int(st.hops.max()) < cfg.max_steps:
        sel, _, _ = _select_alpha(st, cfg)
        sel = torch.where(st.done[:, None], -1, sel)
        sent, ok = sent_mask(sel)
        dropped += (ok.view(sel.shape) & ~sent).sum()
        attempted += ok.sum()
        st = step_impl(swarm.ids, swarm.alive, respond, cfg, st)
    res = LookupResult(found=_finalize(swarm.ids, st, cfg), hops=st.hops,
                       done=st.done)
    return res, dropped, attempted

