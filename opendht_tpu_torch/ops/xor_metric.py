"""Batched 160-bit XOR metric ops over packed id matrices (PyTorch).

Counterpart of ``opendht_tpu/ops/xor_metric.py``.  Ids are ``[..., 5]`` int64 tensors holding
big-endian u32 limbs (limb 0 = id bytes 0-3); first-limb distances
``d0 = limb0(id ^ target)`` are int64 in u32 range (see
:mod:`opendht_tpu_torch.ops.u32`).  Node indices are int32, ``-1`` for
an empty slot.

The round merge's plain version (:func:`rank_merge_round_d0`) and the
two-pass sorted merge it is pinned to (:func:`merge_shortlists_d0`)
live here; the CUDA kernel that replaces the rank merge on the card is
:func:`opendht_tpu_torch.ops.kernels.merge_round`.  Off the engine's
path, kept for parity with the JAX module: :func:`xor_ids`,
:func:`common_bits32`, :func:`common_bits`, the plane k-closest
(:func:`closest_nodes_batched_plane`), :func:`lex_searchsorted` and the
exact 5-limb :func:`merge_shortlists`.
"""

from __future__ import annotations

import torch

from .u32 import U32_MAX, as_i32, as_u32, lexsort
from .u32 import prefix_len32 as prefix_len32  # noqa: F401 (re-export)

N_LIMBS = 5
HASH_BITS = 160

# Sentinel id limb: an invalid candidate's id reads all-ones (and its
# index -1, so equal-distance dedup never confuses it with a node).
SENTINEL_LIMB = U32_MAX


def xor_ids(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise XOR of packed ids, broadcasting."""
    return a ^ b


def common_bits32(a0: torch.Tensor, b0: torch.Tensor) -> torch.Tensor:
    """Common-prefix length from the first limbs only, capped at 32."""
    return prefix_len32(a0 ^ b0)


def common_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Length of the common bit-prefix of two packed ids ``[..., 5]``
    (``InfoHash::commonBits``); 160 for equal ids.  int32."""
    x = a ^ b
    nz = x != 0
    first = torch.argmax(nz.to(torch.int8), dim=-1)     # first nonzero
    limb = torch.gather(x, -1, first[..., None])[..., 0]
    return torch.where(nz.any(dim=-1), first * 32 + prefix_len32(limb),
                       HASH_BITS).to(torch.int32)


def xor_less(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``da < db`` over distance limb tensors ``[..., 5]``
    (5-limb big-endian order = 160-bit integer order)."""
    lt = torch.zeros(da.shape[:-1], dtype=torch.bool, device=da.device)
    eq = torch.ones_like(lt)
    for i in range(N_LIMBS):
        ai, bi = da[..., i], db[..., i]
        lt = lt | (eq & (ai < bi))
        eq = eq & (ai == bi)
    return lt


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``a < b`` over packed ids — the same comparator as
    :func:`xor_less`, named for ids rather than distances."""
    return xor_less(a, b)


def _dist_keys(ids: torch.Tensor, target: torch.Tensor):
    d = ids ^ target.unsqueeze(-2)
    return [d[..., i] for i in range(N_LIMBS)]


def sort_by_distance(ids: torch.Tensor, target: torch.Tensor,
                     *payloads: torch.Tensor):
    """Stable sort of candidate ids ``[..., C, 5]`` by exact XOR
    distance to ``target [..., 5]``; payloads ``[..., C]`` ride along.
    Returns ``(sorted_ids, *sorted_payloads)``."""
    perm = lexsort(_dist_keys(ids, target), dim=-1)
    s_ids = torch.gather(ids, -2, perm.unsqueeze(-1).expand_as(ids))
    return (s_ids,) + tuple(torch.gather(p, -1, perm) for p in payloads)


def closest_nodes(ids: torch.Tensor, target: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Exact k XOR-closest rows of ``ids [N,5]`` to ``target [5]``
    (full sort; ties by index).  Returns ``[k]`` int32, closest first."""
    perm = lexsort(_dist_keys(ids, target), dim=-1)
    return perm[:k].to(torch.int32)


def closest_nodes_batched(ids: torch.Tensor, targets: torch.Tensor,
                          k: int, valid: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """k XOR-closest node indices for a batch of targets.

    ``ids [N,5]``, ``targets [L,5]`` → ``[L,k]`` int32, closest first,
    ``-1`` where fewer than ``k`` valid rows exist.  ``valid``: optional
    ``[N]`` bool.  Exact: dispatches by device to the K3 kernel
    (:func:`opendht_tpu_torch.ops.kernels.nearest_k_ids`) on the card
    or its plain version on the CPU."""
    from .kernels import nearest_k_ids
    return nearest_k_ids(ids, targets, k, valid=valid)


def closest_nodes_batched_plane(ids: torch.Tensor, targets: torch.Tensor,
                                k: int, prefilter: int = 32,
                                valid: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Plane-based k-closest (the JAX package's CPU path): the best
    ``prefilter`` rows by first-limb distance over an explicit ``[L,N]``
    plane (ties to the lower index, as ``lax.top_k``), then an exact
    5-limb sort of that shortlist.  Excluded rows (``valid`` false) that
    reach the shortlist read the all-ones sentinel id and index -1, so
    they sort at the sentinel's distance, not last: the result agrees
    with :func:`closest_nodes_batched` wherever at least ``prefilter``
    rows are valid.  ``[L,k]`` int32."""
    d0 = ids[None, :, 0] ^ targets[:, 0:1]                       # [L,N]
    # ~d0 shifted into int32 range (the JAX package's sign-bit flip):
    # nearer = larger; an excluded row takes int32's minimum, which the
    # farthest valid row (d0 all-ones) shares.
    surro = (d0 ^ U32_MAX) - 2**31
    if valid is not None:
        surro = torch.where(valid[None, :], surro, -2**31)
    _, order = torch.sort(surro, dim=1, descending=True, stable=True)
    short = order[:, :prefilter]                                 # [L,P]
    cand = ids[short]                                            # [L,P,5]
    short = short.to(torch.int32)
    if valid is not None:
        inval = ~valid[short.long()]
        cand = torch.where(inval[..., None], SENTINEL_LIMB, cand)
        short = torch.where(inval, -1, short)
    _, sidx = sort_by_distance(cand, targets, short)
    return sidx[:, :k]


def lex_searchsorted(sorted_ids: torch.Tensor, queries: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """Binary search over lexicographically sorted packed ids
    ``[N,5]`` for queries ``[...,5]`` → insertion positions (int32),
    like ``np.searchsorted`` with the 160-bit comparator."""
    n = sorted_ids.shape[0]
    steps = max(1, (n - 1).bit_length() + 1) if n > 1 else 1
    batch = queries.shape[:-1]
    lo = torch.zeros(batch, dtype=torch.int64, device=queries.device)
    hi = torch.full(batch, n, dtype=torch.int64, device=queries.device)
    for _ in range(steps):
        mid = (lo + hi) // 2
        mid_ids = sorted_ids[mid.clamp(0, n - 1)]
        if side == "left":
            go_right = lex_less(mid_ids, queries)
        else:
            go_right = ~lex_less(queries, mid_ids)
        go_right = go_right & (lo < hi)
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(go_right, hi, torch.where(lo < hi, mid, hi)))
    return lo.to(torch.int32)


# ---------------------------------------------------------------------------
# two-pass sorted merge (the semantic pin)
# ---------------------------------------------------------------------------

def _group_queried_first(group_keys, queried, payloads):
    """Pass 1: stable sort by ``(group_keys..., ~queried)`` along dim 1
    so same-id copies are adjacent with queried copies first, then mark
    every non-first member of an equal-key run as a duplicate.

    Returns ``(sorted_group_keys, sorted_queried, sorted_payloads,
    dup)``."""
    perm = lexsort(list(group_keys) + [~queried], dim=1)
    g = [torch.gather(k, 1, perm) for k in group_keys]
    s_pay = [torch.gather(p, 1, perm) for p in payloads]
    s_q = torch.gather(queried, 1, perm)
    dup = torch.ones_like(s_q)
    for k in g:
        dup = dup & (k == torch.roll(k, 1, dims=1))
    dup[:, 0] = False
    return g, s_q, s_pay, dup


def _dedup_pushback_sort(mask_keys, dup, extra_keys, payloads):
    """Pass 2: force duplicates' order keys to all-ones and stable-sort
    by ``mask_keys + extra_keys``; returns the sorted keys and
    payloads in that order."""
    masked = [torch.where(dup, U32_MAX, k) for k in mask_keys]
    keys = masked + list(extra_keys)
    perm = lexsort(keys, dim=1)
    return [torch.gather(x, 1, perm) for x in keys + list(payloads)]


def merge_shortlists_d0(cand_d0: torch.Tensor, cand_idx: torch.Tensor,
                        cand_queried: torch.Tensor, keep: int):
    """Surrogate-distance merge + dedup (two stable sorts): group by
    node index with queried copies first, drop duplicates and empties,
    then order the survivors by ``d0``.  See the JAX docstring for the
    tie and sentinel analysis.  Returns ``(idx [L,keep] int32,
    d0 [L,keep] int64, queried [L,keep] bool)``."""
    d0 = torch.where(cand_idx < 0, U32_MAX, cand_d0)
    idx_u = as_u32(cand_idx)
    (s_idx_u,), s_q, (s_d0,), dup = _group_queried_first(
        (idx_u,), cand_queried, (d0,))
    dup = dup | (s_idx_u >= 2**31)            # a negative int32 index
    f_d0, f_idx_u, f_q = _dedup_pushback_sort(
        (s_d0,), dup, (), (torch.where(dup, U32_MAX, s_idx_u), s_q))
    f_idx = as_i32(f_idx_u)
    f_q = f_q & (f_idx >= 0)
    return f_idx[:, :keep], f_d0[:, :keep], f_q[:, :keep]


def merge_shortlists(target: torch.Tensor, cand_ids: torch.Tensor,
                     cand_idx: torch.Tensor, cand_queried: torch.Tensor,
                     keep: int):
    """Merge + dedup shortlists by exact 160-bit XOR distance
    (``Search::insertNode``'s sorted insert and trim): ``target [L,5]``,
    ``cand_ids [L,C,5]``, ``cand_idx [L,C]`` int32 (-1 = empty),
    ``cand_queried [L,C]``.  Queried copies of an id win its dedup.
    Returns ``(idx [L,keep], ids [L,keep,5], queried [L,keep])``."""
    invalid = cand_idx < 0
    ids_m = torch.where(invalid[..., None], SENTINEL_LIMB, cand_ids)
    keys = _dist_keys(ids_m, target)
    limbs = [ids_m[..., i] for i in range(N_LIMBS)]
    s_keys, s_q, s_pay, dup = _group_queried_first(
        keys, cand_queried, limbs + [cand_idx])
    s_idx = s_pay[N_LIMBS]
    dup = dup | (s_idx < 0)
    s_idx = torch.where(dup, -1, s_idx)
    limbs2 = [torch.where(dup, SENTINEL_LIMB, s_pay[i])
              for i in range(N_LIMBS)]
    out2 = _dedup_pushback_sort(s_keys, dup, (dup.to(torch.int64),),
                                limbs2 + [s_idx, s_q])
    f_ids = torch.stack(out2[N_LIMBS + 1:2 * N_LIMBS + 1], dim=-1)
    f_idx, f_q = out2[2 * N_LIMBS + 1], out2[2 * N_LIMBS + 2]
    f_q = f_q & (f_idx >= 0)
    return f_idx[:, :keep], f_ids[:, :keep], f_q[:, :keep]


# ---------------------------------------------------------------------------
# sort-free round merge: rank arithmetic over the standing frontier order
# ---------------------------------------------------------------------------

def rank_merge_round_d0(fr_idx: torch.Tensor, fr_d0: torch.Tensor,
                        fr_q: torch.Tensor, resp_idx: torch.Tensor,
                        resp_d0: torch.Tensor, keep: int):
    """Sort-free round merge, bit-equal to :func:`merge_shortlists_d0`
    over ``concat([frontier, responses])`` on the lookup round's input
    domain (a frontier whose valid entries are ``(d0, idx_u)``-sorted
    and duplicate-free; arbitrary unqueried responses).

    Every survivor's output slot is its rank under the total order
    ``(effective d0, idx_u, input ordinal)``, duplicates' and empties'
    d0 forced to all-ones, computed by counting planes.  The JAX
    version narrows the count accumulators to u8/u16; here they are
    int64, so the frontier's exclusive rank ``cumsum - 1`` is ``-1``
    (not a wrapped 255) in the invalid lanes — which the ``where``
    below discards exactly as the JAX version discards its wrap.

    Returns ``(idx, d0, queried)``, each ``[L, min(keep, S+C)]``.
    """
    l, s = fr_idx.shape
    c = resp_idx.shape[1]
    out_w = min(keep, s + c)
    dev = fr_idx.device

    fv = fr_idx >= 0
    a_idxu = as_u32(fr_idx)
    a_d0 = torch.where(fv, fr_d0, U32_MAX)
    rank_a = torch.cumsum(fv.to(torch.int64), dim=1) - 1

    rv = resp_idx >= 0
    r_idxu = as_u32(resp_idx)
    r_d0 = torch.where(rv, resp_d0, U32_MAX)
    in_frontier = torch.any(
        (r_idxu[:, :, None] == a_idxu[:, None, :]) & fv[:, None, :], dim=2)
    ar = torch.arange(c, device=dev)
    earlier = (ar[None, :] < ar[:, None])[None]
    dup_within = torch.any(
        (r_idxu[:, :, None] == r_idxu[:, None, :]) & earlier
        & rv[:, None, :], dim=2)
    dup = in_frontier | dup_within | ~rv
    b_d0 = torch.where(dup, U32_MAX, r_d0)
    bj_d0, bk_d0 = b_d0[:, :, None], b_d0[:, None, :]
    bj_ix, bk_ix = r_idxu[:, :, None], r_idxu[:, None, :]
    ltb = (bk_d0 < bj_d0) | ((bk_d0 == bj_d0)
                             & ((bk_ix < bj_ix)
                                | ((bk_ix == bj_ix) & earlier)))
    rank_b = ltb.sum(dim=2)

    lt_a = (b_d0[:, None, :] < a_d0[:, :, None]) | (
        (b_d0[:, None, :] == a_d0[:, :, None])
        & (r_idxu[:, None, :] < a_idxu[:, :, None]))
    pos_a = torch.where(fv, rank_a + lt_a.sum(dim=2), out_w)
    ge_b = ~((b_d0[:, :, None] < a_d0[:, None, :]) | (
        (b_d0[:, :, None] == a_d0[:, None, :])
        & (r_idxu[:, :, None] < a_idxu[:, None, :])))
    pos_b = torch.where(dup, out_w, rank_b + ge_b.sum(dim=2))

    iota_k = torch.arange(out_w, device=dev)[None, None, :]
    ha = pos_a[:, :, None] == iota_k                     # [L,S,out_w]
    hb = pos_b[:, :, None] == iota_k                     # [L,C,out_w]
    o_idx = torch.maximum(
        torch.where(ha, fr_idx[:, :, None], -1).amax(dim=1),
        torch.where(hb, resp_idx[:, :, None], -1).amax(dim=1))
    o_d0 = torch.minimum(
        torch.where(ha, a_d0[:, :, None], U32_MAX).amin(dim=1),
        torch.where(hb, b_d0[:, :, None], U32_MAX).amin(dim=1))
    o_q = torch.any(ha & fr_q[:, :, None], dim=1)
    return o_idx.to(torch.int32), o_d0, o_q


def merge_ladder_widths(c: int, block: int) -> list[int]:
    """Ascending response-width ladder ``block · 2^j`` capped at (and
    always including) ``c``."""
    if c <= 0 or block <= 0:
        return [max(c, 0)]
    widths = set()
    w = min(block, c)
    while w < c:
        widths.add(w)
        w *= 2
    widths.add(c)
    return sorted(widths)


def pick_merge_width(wneed: int, c: int, block: int) -> int | None:
    """Smallest ladder rung covering ``wneed`` live response columns;
    ``None`` for the full width."""
    for w in merge_ladder_widths(c, block):
        if w >= wneed:
            return None if w >= c else w
    return None


def rank_merge_round_d0_w(fr_idx: torch.Tensor, fr_d0: torch.Tensor,
                          fr_q: torch.Tensor, resp_idx: torch.Tensor,
                          resp_d0: torch.Tensor, keep: int,
                          merge_w: int | None):
    """:func:`rank_merge_round_d0` priced at ``merge_w <= C`` response
    columns, guarded so any width is sound: if a column at or past
    ``merge_w`` is live, the full-width merge runs instead.  The JAX
    version guards in-jit with ``lax.cond``; here it is a Python branch
    on one readback, so this path is for the CPU only (the card runs
    the merge kernel at full width)."""
    l, s = fr_idx.shape
    c = resp_idx.shape[1]
    if (merge_w is None or merge_w >= c
            # graftlint: disable=tracer-coercion,host-callback (the merge-width ladder runs on the CPU only: on the card, and so in every capture, the merge is the K1 kernel at full width and merge_w never reaches here)
            or bool((resp_idx[:, merge_w:] >= 0).any())):
        return rank_merge_round_d0(fr_idx, fr_d0, fr_q, resp_idx,
                                   resp_d0, keep)
    out_w = min(keep, s + c)
    o_idx, o_d0, o_q = rank_merge_round_d0(
        fr_idx, fr_d0, fr_q, resp_idx[:, :merge_w], resp_d0[:, :merge_w],
        keep)
    padw = out_w - o_idx.shape[1]
    if padw <= 0:
        return o_idx, o_d0, o_q
    return (torch.cat([o_idx, o_idx.new_full((l, padw), -1)], dim=1),
            torch.cat([o_d0, o_d0.new_full((l, padw), U32_MAX)], dim=1),
            torch.cat([o_q, o_q.new_zeros((l, padw))], dim=1))
