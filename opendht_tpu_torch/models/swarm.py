"""SimSwarm in PyTorch — the batched Kademlia lookup engine.

Counterpart of ``opendht_tpu/models/swarm.py`` for the single-device
lookup path: build a swarm of N simulated nodes (sorted ``[N,5]`` ids
and per-node bucket tables), then advance a batch of iterative lookups
in lock-step — each round solicits the α best unqueried shortlist nodes,
decodes what they answer from their bucket rows, and merges the answers
into the shortlist — until every lookup's ``quorum`` closest known nodes
are queried.  The results are bit-identical to the JAX engine's on the
same swarm, targets and origins (``tests/test_torch_swarm.py``,
``tests/test_torch_fused_round.py``, ``tests/test_torch_trace.py``).

Device placement is explicit: entry points take ``device`` (default
``"cuda"``) and raise where there is no card, unless ``device="cpu"``.
On the card the round merge is the K1 kernel (or, with
``merge_impl="fused-round"``, the whole round is the K2 kernel) and the
recall ground truth the K3 kernel
(:mod:`opendht_tpu_torch.ops.kernels`); on the CPU each is its plain
PyTorch version.

Beside the engine: the flight recorder (:class:`LookupTrace`,
:func:`traced_lookup`), the per-request lifecycle plane
(:func:`init_lifecycle`, ``lookup(track_lifecycle=True)``), routing
table maintenance after churn (:func:`heal_swarm`), and the adversarial
engine (:func:`chaos_lookup`: Byzantine responders marked by
:func:`corrupt_swarm`, reply loss, and the strike/blacklist defence,
sharing the plain engine's round tail and so K1).

The round loop runs on the host and reads the device back once per
burst of rounds (the fused pending/watermark pair), never per round.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import kernels
from ..ops.round_parts import (fold_solicitations, gather_pair_windows,
                               unpack_pair_window)
from ..ops.u32 import MASK32, U32_MAX, lexsort, mul32, prefix_len32, shl32
from ..ops.xor_metric import (
    N_LIMBS,
    closest_nodes_batched,
    lex_searchsorted,
    merge_ladder_widths,
    merge_shortlists_d0,
    pick_merge_width,
    rank_merge_round_d0_w,
)

# Device memory assumed where no card is queried: the JAX package's
# fallback, so CPU configurations equal the JAX ones.
FALLBACK_DEVICE_BYTES = 16_000_000_000
# Room kept beside the augmented table for ids and per-round transients
# (the JAX package's figure, shared by the table cutoff).
LOOKUP_HEADROOM_BYTES = 4_500_000_000


def _pad128(x: int) -> int:
    """Round up to a multiple of 128 elements (the table row width)."""
    return -(-x // 128) * 128


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless asked
    otherwise; raises where a card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run "
                "the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_memory_bytes(device=None) -> int:
    """Total memory of the card (``torch.cuda.mem_get_info``), or
    :data:`FALLBACK_DEVICE_BYTES` for the CPU or where there is no
    card.  ``device=None`` means the current card if one exists."""
    if device is None:
        if not torch.cuda.is_available():
            return FALLBACK_DEVICE_BYTES
        device = "cuda"
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return FALLBACK_DEVICE_BYTES
    return int(torch.cuda.mem_get_info(dev)[1])


def _aug_table_budget(device=None) -> int:
    """Device bytes available to the augmented table."""
    return device_memory_bytes(device) - LOOKUP_HEADROOM_BYTES


def table_bytes(cfg: "SwarmConfig") -> int:
    """Exact bytes of a swarm's routing table (padded rows)."""
    if cfg.aug_tables:
        return cfg.n_nodes * _pad128(cfg.n_buckets * 3 * cfg.bucket_k) * 2
    return cfg.n_nodes * cfg.n_buckets * cfg.bucket_k * 4


MERGE_IMPLS = ("auto", "sort", "fused-round")


class SwarmConfig(NamedTuple):
    """Static swarm geometry: K=8 per bucket, 14-node search sets,
    α=4, sync quorum 8 (the reference's constants).

    ``aug_tables`` stores, beside each bucket member's index, a 16-bit
    window of its first id limb (``[N, pad128(B·3K)] uint16`` rows), so
    a responder's answer carries its own distance surrogates.

    ``merge_impl`` picks the round merge: ``"auto"`` is the K1 kernel
    on the card and the plain sort-free rank merge on the CPU;
    ``"sort"`` (the two-pass sorted reference the tests pin it to) runs
    on the CPU only; ``"fused-round"`` (opt-in, the JAX package's
    ``"pallas-round"``) runs each plain round as one K2 launch on the
    card and as K2's plain version on the CPU — augmented tables only.
    """
    n_nodes: int
    n_buckets: int
    bucket_k: int = 8
    search_width: int = 14
    alpha: int = 4
    quorum: int = 8
    max_steps: int = 48
    aug_tables: bool = True
    merge_impl: str = "auto"

    @classmethod
    def for_nodes(cls, n_nodes: int, device=None, **kw) -> "SwarmConfig":
        """Geometry for ``n_nodes``: enough buckets that the deepest
        holds about 2·K nodes (capped at 26), augmented tables while
        the padded table fits the device beside the lookup headroom."""
        b = min(26, max(4, int(math.ceil(math.log2(max(16, n_nodes)))) - 3))
        k = kw.get("bucket_k", 8)
        kw.setdefault("aug_tables", n_nodes * _pad128(b * 3 * k) * 2
                      <= _aug_table_budget(device))
        return cls(n_nodes=n_nodes, n_buckets=b, **kw)


_swarmconfig_new = SwarmConfig.__new__


def _swarmconfig_checked_new(cls, *args, **kw):
    cfg = _swarmconfig_new(cls, *args, **kw)
    if cfg.quorum + 2 > cfg.search_width:
        raise ValueError(
            f"SwarmConfig requires quorum + 2 <= search_width (the "
            f"exact re-sort at finalize covers the top quorum+2 surrogate "
            f"ranks); got quorum={cfg.quorum}, "
            f"search_width={cfg.search_width}")
    if cfg.merge_impl not in MERGE_IMPLS:
        raise ValueError(
            f"SwarmConfig.merge_impl must be one of {MERGE_IMPLS}; "
            f"got {cfg.merge_impl!r}")
    return cfg


SwarmConfig.__new__ = _swarmconfig_checked_new


def resolve_merge_impl(cfg: SwarmConfig, device: torch.device) -> str:
    """The round for tensors on ``device``: ``"fused-round"`` (K2, or its
    plain version on the CPU) where asked; otherwise ``"kernel"`` (K1)
    on the card, where ``"sort"`` is refused, and ``"rank"`` (the plain
    rank merge) or ``"sort"`` on the CPU."""
    if cfg.merge_impl == "fused-round":
        return "fused-round"
    if device.type == "cuda":
        if cfg.merge_impl != "auto":
            raise ValueError(
                f"merge_impl={cfg.merge_impl!r} is a plain CPU merge; on "
                f"the card the round merge is the K1 kernel ('auto')")
        return "kernel"
    return "rank" if cfg.merge_impl == "auto" else cfg.merge_impl


class Swarm(NamedTuple):
    """Swarm state.  ``tables``: augmented ``[N, pad128(B·3K)] uint16``
    rows — per bucket ``b`` at ``[b·3K, (b+1)·3K)``: the K members'
    index low halves, high halves, then their 16-bit windows (bits
    ``[b, b+16)`` of limb 0; empty = 0xFFFF halves) — or plain
    ``[N, B·K] int32`` member indices (-1 = empty).  ``byzantine``
    (``None`` unless :func:`corrupt_swarm` set it) marks the nodes whose
    answers the chaos engine poisons; the plain engine ignores it."""
    ids: torch.Tensor     # [N,5] int64 u32 limbs, lexicographically sorted
    tables: torch.Tensor  # see above
    alive: torch.Tensor   # [N] bool
    byzantine: torch.Tensor | None = None   # [N] bool

    def to(self, device) -> "Swarm":
        """The same swarm with every tensor on ``device``."""
        return Swarm(*[x if x is None else x.to(device) for x in self])


class LookupState(NamedTuple):
    """Lock-step lookup state, all ``[L, ...]``.  The shortlist carries
    only the first 32 distance bits; the result is re-sorted on all 160
    bits once per lookup (:func:`_finalize`).

    The lifecycle plane (``None`` unless :func:`init_lifecycle` attached
    it) records the round each row was admitted at and the round its
    ``done`` bit first went True.  It is a pure observer: no round
    decision reads it, so results are the same with it on or off."""
    targets: torch.Tensor  # [L,5] int64
    idx: torch.Tensor      # [L,S] int32 shortlist node indices
    dist: torch.Tensor     # [L,S] int64 first-limb distance (all-ones = empty)
    queried: torch.Tensor  # [L,S] bool
    done: torch.Tensor     # [L] bool
    hops: torch.Tensor     # [L] int32 solicitation rounds until done
    admitted_round: torch.Tensor | None = None   # [L] int32 (-1 = free)
    completed_round: torch.Tensor | None = None  # [L] int32 (-1 = inflight)


class LookupResult(NamedTuple):
    found: torch.Tensor  # [L,quorum] int32 closest queried nodes (-1 pad)
    hops: torch.Tensor   # [L] int32
    done: torch.Tensor   # [L] bool


def init_lifecycle(st: LookupState, rnd: int = 0) -> LookupState:
    """Attach the lifecycle plane to a fresh state: every row admitted at
    round ``rnd``, completion pending (or ``rnd`` where already done).
    Steps must then receive their round index (``rnd=``), which the
    loops pass."""
    l = st.done.shape[0]
    r = torch.full((l,), rnd, dtype=torch.int32, device=st.done.device)
    return st._replace(admitted_round=r,
                       completed_round=torch.where(st.done, r, -1))


def _advance(st: LookupState, sel: torch.Tensor, merged,
             rnd: int | torch.Tensor | None) -> LookupState:
    """The state after a round from its merge ``merged = (idx, d0,
    queried, done)``: the done bit, a hop for every pending row that
    solicited, and the lifecycle stamp — ``completed_round`` set to
    ``rnd`` where the done bit went True (the plane needs ``rnd``).
    ``rnd`` is an int or a 0-dim int32 tensor on the state's device (a
    captured CUDA graph reads its round from a buffer)."""
    f_idx, f_dist, f_q, done_merge = merged
    active = ~st.done & (sel >= 0).any(dim=1)
    done = st.done | done_merge
    completed = st.completed_round
    if completed is not None:
        if rnd is None:
            raise ValueError(
                "lifecycle tracking needs the round index: pass rnd= to "
                "the step (the loops do when the fields are present)")
        completed = torch.where(done & ~st.done, rnd, completed)
    return LookupState(
        targets=st.targets, idx=f_idx, dist=f_dist, queried=f_q,
        done=done, hops=st.hops + active.to(torch.int32),
        admitted_round=st.admitted_round, completed_round=completed)


class LookupTrace(NamedTuple):
    """Flight recorder: per-round lookup telemetry, each counter a
    ``[max_steps]`` int32 row indexed by solicitation round, updated on
    the device by the round itself (no host sync); read once with
    :func:`trace_to_dict`.

    * ``requests`` — solicitations issued (α-slots holding a node);
    * ``replies`` — candidate entries that reached the merge;
    * ``drops`` — solicitations that returned nothing (dead nodes);
    * ``poison``, ``strikes``, ``convictions`` — the chaos engine's
      (0 here);
    * ``churn`` — shortlist slots whose occupant changed;
    * ``done`` — lookups done at round end (gauge, monotone);
    * ``active_rows`` — lookups pending at round entry (gauge, monotone
      non-increasing);
    * ``rounds`` — ``[]`` int32: rounds executed."""
    requests: torch.Tensor
    replies: torch.Tensor
    drops: torch.Tensor
    poison: torch.Tensor
    strikes: torch.Tensor
    convictions: torch.Tensor
    churn: torch.Tensor
    done: torch.Tensor
    active_rows: torch.Tensor
    rounds: torch.Tensor


def empty_lookup_trace(cfg: SwarmConfig, device=None) -> LookupTrace:
    """A zero trace on ``device`` (default ``"cuda"``); each field owns
    its tensor, since the traced round adds into it in place."""
    dev = resolve_device(device)
    rows = [torch.zeros((cfg.max_steps,), dtype=torch.int32, device=dev)
            for _ in LookupTrace._fields[:-1]]
    return LookupTrace(*rows, rounds=torch.zeros((), dtype=torch.int32,
                                                 device=dev))


def merge_traces(traces) -> LookupTrace:
    """Combine the traces of disjoint lookup batches: counters sum and
    ``rounds`` takes the max.  The gauges ``done`` and ``convictions``
    are first forward-filled past each trace's own exit round (a batch
    that finished early still holds all its lookups done), and
    ``active_rows`` is filled with 0 there (nothing of it is pending),
    so the merged gauges stay monotone."""
    def fill_forward(t: LookupTrace) -> LookupTrace:
        r = t.rounds.clamp(min=1)
        idx = torch.arange(t.done.shape[0], device=t.done.device)
        ff = lambda row: torch.where(idx < r, row, row[r - 1])  # noqa: E731
        return t._replace(done=ff(t.done), convictions=ff(t.convictions),
                          active_rows=torch.where(idx < r, t.active_rows, 0))

    out = fill_forward(traces[0])
    for t in traces[1:]:
        t = fill_forward(t)
        out = LookupTrace(*[
            torch.maximum(a, b) if name == "rounds" else a + b
            for name, a, b in zip(LookupTrace._fields, out, t)])
    return out


def trace_to_dict(trace: LookupTrace, n_lookups: int | None = None) -> dict:
    """The whole trace read back in one transfer → a JSON-able dict with
    the counters cut to the executed rounds (the JAX package's schema,
    ``done_frac`` and ``wasted_row_rounds`` where ``n_lookups`` is
    given)."""
    rows = torch.stack(list(trace[:-1]))
    host = torch.cat([rows.flatten(), trace.rounds.reshape(1).to(rows.dtype)]
                     ).tolist()
    n_steps = rows.shape[1]
    rounds = int(host[-1])
    r = max(1, rounds)
    counters = {name: [int(v) for v in host[i * n_steps:i * n_steps + r]]
                for i, name in enumerate(LookupTrace._fields[:-1])}
    out = {"rounds": rounds, "max_steps": n_steps, "counters": counters}
    if n_lookups:
        out["n_lookups"] = int(n_lookups)
        out["done_frac"] = [round(d / n_lookups, 6)
                            for d in counters["done"]]
        out["wasted_row_rounds"] = int(sum(
            max(0, n_lookups - a) for a in counters["active_rows"]))
    return out


def _require_on(swarm: Swarm, dev: torch.device) -> None:
    if swarm.ids.device != dev:
        raise ValueError(f"the swarm lives on {swarm.ids.device}, but the "
                         f"call runs on {dev}")


# ---------------------------------------------------------------------------
# bit helpers on packed ids (bit positions may be tensors)
# ---------------------------------------------------------------------------

def _prefix_mask(nbits) -> torch.Tensor:
    """``[..., 5]`` u32 mask keeping the first ``nbits`` bits of an id."""
    nbits = torch.as_tensor(nbits, dtype=torch.int64)
    limbs = []
    for j in range(N_LIMBS):
        rem = (nbits - 32 * j).clamp(0, 32)
        m = shl32(torch.full_like(rem, MASK32), (32 - rem).clamp(0, 31))
        limbs.append(torch.where(rem == 0, 0, m))
    return torch.stack(limbs, dim=-1)


def _bit_mask(bit) -> torch.Tensor:
    """``[..., 5]`` u32 with only ``bit`` (0 = MSB of limb 0) set."""
    bit = torch.as_tensor(bit, dtype=torch.int64)
    limbs = []
    for j in range(N_LIMBS):
        off = bit - 32 * j
        in_limb = (off >= 0) & (off < 32)
        limbs.append(torch.where(in_limb, shl32(torch.ones_like(off),
                                                (31 - off).clamp(0, 31)), 0))
    return torch.stack(limbs, dim=-1)


def bucket_range(sorted_ids: torch.Tensor, node_ids: torch.Tensor, b,
                 inclusive=False):
    """Sorted-range ``[lo, hi)`` of a node's bucket-``b`` key-space.

    Exclusive (normal) bucket: ids sharing exactly ``b`` prefix bits
    (first ``b`` bits equal, bit ``b`` flipped), a dyadic interval and so
    contiguous in the sorted matrix.  Inclusive (deepest) bucket: ids
    sharing at least ``b`` bits (``RoutingTable::split``).  Off the
    engine's path (the port builds buckets from limb 0 alone); kept
    for parity with the JAX package."""
    pm1 = _prefix_mask(torch.as_tensor(b) + 1).to(node_ids.device)
    pmb = _prefix_mask(b).to(node_ids.device)
    bm = _bit_mask(b).to(node_ids.device)
    lo_ex = (node_ids & pm1) ^ bm
    hi_ex = lo_ex | (~pm1 & MASK32)
    lo_in = node_ids & pmb
    hi_in = lo_in | (~pmb & MASK32)
    inc = torch.as_tensor(inclusive, device=node_ids.device)
    lo = lex_searchsorted(sorted_ids, torch.where(inc, lo_in, lo_ex),
                          side="left")
    hi = lex_searchsorted(sorted_ids, torch.where(inc, hi_in, hi_ex),
                          side="right")
    return lo, hi


# ---------------------------------------------------------------------------
# swarm construction
# ---------------------------------------------------------------------------

def _build_ids(generator: torch.Generator, cfg: SwarmConfig,
               device: torch.device) -> torch.Tensor:
    """``[N,5]`` uniform random ids, sorted lexicographically."""
    raw = torch.randint(0, 2**32, (cfg.n_nodes, N_LIMBS),
                        generator=generator, dtype=torch.int64,
                        device=device)
    perm = lexsort([raw[:, i] for i in range(N_LIMBS)], dim=0)
    return raw[perm]


def _build_bucket(tables: torch.Tensor, ids0: torch.Tensor, b: int,
                  u: torch.Tensor, cfg: SwarmConfig,
                  alive: torch.Tensor | None = None,
                  rows: slice | None = None) -> torch.Tensor:
    """Fill bucket ``b`` of every node's table in place from the uniform
    draws ``u [N,K]`` (float32) and return ``tables``.  With ``rows`` only those nodes' rows
    are computed (``tables`` then holds just them, as a rank's shard
    does, and ``u`` is still ``[N,K]``).

    Bucket ranges come from a prefix histogram of the sorted ids: a
    bucket's key-space is a dyadic interval fixed by the first
    ``d <= 32`` bits, so its ``[lo, hi)`` is a pair of adjacent
    histogram cumsums.  Members are stratified uniform samples of that
    range.  The float32 sampler keeps the JAX package's operation order
    as separate ops — fusing them could let a contraction move a
    ``floor`` across an integer and change the table.

    With ``alive`` (``[N]`` bool), members are sampled among alive
    nodes only: the histogram weighs alive nodes, so samples are alive
    ranks, and a ``searchsorted`` over the alive cumsum maps each rank
    back to its node (ids are sorted, so alive-rank order is id order
    in every dyadic range) — :func:`heal_swarm`'s maintenance."""
    n, b_total, k = cfg.n_nodes, cfg.n_buckets, cfg.bucket_k
    if b_total > 26:
        raise ValueError("prefix histogram capped at 2^26 bins")
    inclusive = b == b_total - 1
    d = b if inclusive else b + 1          # prefix depth of the interval
    pref = ids0 >> (32 - d)
    if alive is None:
        counts = torch.bincount(pref, minlength=1 << b_total)
    else:      # an exact integer count of the alive nodes a prefix
        counts = torch.zeros(1 << b_total, dtype=torch.int64,
                             device=pref.device).index_add_(
            0, pref, alive.to(torch.int64))
    bounds = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    if rows is not None:
        pref, u = pref[rows], u[rows]
    p = pref if inclusive else pref ^ 1    # own vs sibling interval
    lo, hi = bounds[p], bounds[p + 1]
    size = (hi - lo).to(torch.float32)
    strat = torch.arange(k, dtype=torch.float32, device=u.device)[None, :]
    strat = strat + u
    strat = strat / k
    scaled = strat * size[:, None]
    scaled = torch.floor(scaled)
    scaled = torch.clamp(scaled, 0.0, float(n - 1))
    samp = lo[:, None] + scaled.to(torch.int64)
    samp = torch.clamp(samp, lo[:, None], (hi - 1)[:, None])
    if alive is not None:  # the (r+1)-th alive node: first cumsum > r
        acum = torch.cumsum(alive.to(torch.int64), 0)
        samp = torch.searchsorted(acum, samp, right=True).clamp(0, n - 1)
    samp = torch.where((hi > lo)[:, None], samp, -1)          # [N,K]
    if cfg.aug_tables:
        m0 = ids0[samp.clamp(0, n - 1)]
        s16 = shl32(m0, b) >> 16
        su = samp & MASK32
        row = torch.cat([su & 0xFFFF, su >> 16, s16], dim=-1)   # [N,3K]
        tables[:, b * 3 * k:(b + 1) * 3 * k] = row.to(torch.uint16)
    else:
        tables[:, b * k:(b + 1) * k] = samp.to(torch.int32)
    return tables


def build_tables(ids0: torch.Tensor, cfg: SwarmConfig,
                 draws) -> torch.Tensor:
    """Routing tables for sorted first limbs ``ids0 [N]``.  ``draws(b)``
    returns bucket ``b``'s uniforms ``[N,K]`` float32 — a test hands in
    the JAX package's draws here."""
    n, b_total, k = cfg.n_nodes, cfg.n_buckets, cfg.bucket_k
    dev = ids0.device
    if cfg.aug_tables:
        tables = torch.full((n, _pad128(b_total * 3 * k)), 0xFFFF,
                            dtype=torch.uint16, device=dev)
    else:
        tables = torch.full((n, b_total * k), -1, dtype=torch.int32,
                            device=dev)
    for b in range(b_total):
        tables = _build_bucket(tables, ids0, b, draws(b), cfg)
    return tables


def build_swarm(cfg: SwarmConfig, generator: torch.Generator | None = None,
                *, device=None) -> Swarm:
    """A random swarm with steady-state routing tables, O(N·B).
    ``generator`` (a ``torch.Generator`` on ``device``; seeded 0 if
    omitted) draws the ids and every bucket's samples."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    n, k = cfg.n_nodes, cfg.bucket_k
    ids = _build_ids(generator, cfg, dev)
    tables = build_tables(
        ids[:, 0], cfg,
        lambda b: torch.rand((n, k), generator=generator,
                             dtype=torch.float32, device=dev))
    return Swarm(ids=ids, tables=tables,
                 alive=torch.ones((n,), dtype=torch.bool, device=dev))


def heal_swarm(swarm: Swarm, cfg: SwarmConfig, draws, *,
               rows: slice | None = None) -> Swarm:
    """Routing-table maintenance after churn: refill every bucket in
    place with members sampled among the alive nodes (the steady state
    of the reference's bucket expiry and refill).  ``draws`` is a
    ``torch.Generator`` on the swarm's device, or a function ``b ->``
    bucket ``b``'s uniforms ``[N,K]`` float32 (a test hands in the JAX
    package's ``fold_in(key, b)`` draws).  The swarm's table is updated
    in place; the swarm is returned.  ``rows`` heals a shard: the table
    holds those nodes' rows only (every rank of a mesh draws the whole
    ``[N,K]`` and keeps its rows, so the shards equal a whole heal)."""
    n, k = cfg.n_nodes, cfg.bucket_k
    if isinstance(draws, torch.Generator):
        gen = draws
        draws = lambda b: torch.rand(  # noqa: E731
            (n, k), generator=gen, dtype=torch.float32,
            device=swarm.ids.device)
    ids0 = swarm.ids[:, 0]
    for b in range(cfg.n_buckets):
        _build_bucket(swarm.tables, ids0, b, draws(b), cfg,
                      alive=swarm.alive, rows=rows)
    return swarm


def churn(swarm: Swarm, generator: torch.Generator, kill_frac: float,
          cfg: SwarmConfig) -> Swarm:
    """Kill a uniform fraction of nodes: dead nodes stop answering."""
    keep = torch.rand((cfg.n_nodes,), generator=generator,
                      device=swarm.alive.device) >= kill_frac
    return swarm._replace(alive=swarm.alive & keep)


def corrupt_swarm(swarm: Swarm, generator: torch.Generator | None,
                  byzantine_frac: float, cfg: SwarmConfig, *,
                  mask: torch.Tensor | None = None) -> Swarm:
    """Mark a uniform fraction of nodes Byzantine — the adversarial twin
    of :func:`churn`.  Byzantine nodes stay alive and keep answering,
    but the chaos engine (:func:`chaos_lookup`) poisons their answers.
    ``mask`` (``[N]`` bool, e.g. the JAX package's draw) is taken as it
    is; otherwise ``generator`` draws it."""
    if mask is None:
        mask = torch.rand((cfg.n_nodes,), generator=generator,
                          device=swarm.alive.device) < byzantine_frac
    return swarm._replace(byzantine=mask.to(swarm.alive.device))


# ---------------------------------------------------------------------------
# respond
# ---------------------------------------------------------------------------

def _respond(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
             nid: torch.Tensor, nid_d0: torch.Tensor):
    """What each solicited node answers: its bucket ``c = clz(d0)``
    (every member closer to the target than itself) and bucket ``c+1``.

    ``nid [L,A]`` (-1 = none), ``nid_d0 [L,A]`` the solicited nodes'
    own first-limb distances.  Returns ``(resp [L,A·2K] int32, resp_d0
    [L,A·2K] int64, answered [L,A] bool)``; dead or empty slots answer
    -1 / all-ones.  Augmented tables: the bucket-pair window
    ``[c0·3K, c0·3K + 6K)`` (``c0`` clipped to ``[0, B-2]``) is
    gathered straight from the row and decoded as ``[L,A,2,K]``; plain
    tables gather the two member spans and each member's id limb."""
    n, b_total, k = cfg.n_nodes, cfg.n_buckets, cfg.bucket_k
    l, a = nid.shape
    safe = nid.clamp(0, n - 1).long()
    c = prefix_len32(nid_d0)                                    # [L,A]
    ok = (nid >= 0) & swarm.alive[safe]
    if swarm.tables.dtype == torch.uint16:
        c0 = c.clamp(0, b_total - 2)
        win = gather_pair_windows(swarm.tables, safe, c0, k)   # [L,A,6K]
        idx, d0 = unpack_pair_window(win.view(l, a, 2, 3 * k), c0,
                                     targets[:, 0], nid_d0, ok, k)
        resp, resp_d0 = idx.reshape(l, -1), d0.reshape(l, -1)
    else:
        c0 = c.clamp(0, b_total - 1)
        c1 = (c + 1).clamp(0, b_total - 1)
        resp = torch.cat([_gather_span(swarm.tables, safe, c0, k),
                          _gather_span(swarm.tables, safe, c1, k)], dim=-1)
        resp = torch.where(ok[..., None], resp, -1).reshape(l, -1)
        resp_d0 = _resp_dist(swarm.ids, cfg, targets, resp)
    return resp, resp_d0, ok


def _gather_span(tables: torch.Tensor, node: torch.Tensor,
                 bucket: torch.Tensor, k: int) -> torch.Tensor:
    """Plain-table bucket rows ``tables[node, bucket·K : bucket·K + K]``
    → ``[..., K]`` (indices already in range)."""
    return tables.view(tables.shape[0], -1, k)[node, bucket]


def _resp_dist(ids: torch.Tensor, cfg: SwarmConfig, targets: torch.Tensor,
               cand_idx: torch.Tensor) -> torch.Tensor:
    """First-limb XOR distance for candidate indices (all-ones at -1)."""
    cand0 = ids[:, 0][cand_idx.clamp(0, cfg.n_nodes - 1).long()]
    d0 = cand0 ^ targets[:, 0][:, None]
    return torch.where(cand_idx < 0, U32_MAX, d0)


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def _select_alpha(st: LookupState, cfg: SwarmConfig):
    """The α best unqueried shortlist nodes per lookup (the first α
    unqueried slots — the shortlist is distance-sorted), with their d0
    and slot: ``(sel [L,A] int32, sel_d0 [L,A], sel_pos [L,A])``."""
    unq = (st.idx >= 0) & ~st.queried
    order = torch.cumsum(unq.to(torch.int64), dim=1)
    ranks = torch.arange(1, cfg.alpha + 1, device=unq.device)
    oh = unq[:, :, None] & (order[:, :, None] == ranks[None, None, :])
    sel = torch.where(oh, st.idx[:, :, None], -1).amax(dim=1)
    sel_d0 = torch.where(oh, st.dist[:, :, None], 0).amax(dim=1)
    slots = torch.arange(st.idx.shape[1], device=unq.device)[None, :, None]
    sel_pos = torch.where(oh, slots, -1).amax(dim=1)
    return sel, sel_d0, sel_pos


def _local_respond(swarm: Swarm, cfg: SwarmConfig):
    """The single-device respond: the solicited nodes' own table rows
    (:func:`_respond`).  The sharded engines hand the same round a
    routed respond instead (:mod:`opendht_tpu_torch.parallel.sharded`)."""
    return lambda tg, nid, nid_d0: _respond(swarm, cfg, tg, nid, nid_d0)


def init_impl(ids: torch.Tensor, respond, cfg: SwarmConfig,
              targets: torch.Tensor, origins: torch.Tensor) -> LookupState:
    """Seed each lookup from its origin node's own routing table.
    ``respond(targets, nid, nid_d0)`` says where the tables live: local
    rows (:func:`_local_respond`) or the routed exchange of the sharded
    engines."""
    l = targets.shape[0]
    s = cfg.search_width
    o_d0 = ids[:, 0][origins.long()] ^ targets[:, 0]
    resp, resp_d0, _ = respond(targets, origins[:, None], o_d0[:, None])
    pad = max(0, s - resp.shape[1])
    if pad:
        resp = torch.cat([resp, resp.new_full((l, pad), -1)], dim=1)
        resp_d0 = torch.cat([resp_d0, resp_d0.new_full((l, pad), U32_MAX)],
                            dim=1)
    f_idx, f_dist, f_q = merge_shortlists_d0(
        resp_d0, resp, torch.zeros_like(resp, dtype=torch.bool), keep=s)
    dev = targets.device
    return LookupState(
        targets=targets, idx=f_idx, dist=f_dist, queried=f_q,
        done=torch.zeros((l,), dtype=torch.bool, device=dev),
        hops=torch.zeros((l,), dtype=torch.int32, device=dev))


def lookup_init(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
                origins: torch.Tensor) -> LookupState:
    """Seed each lookup from its origin node's own routing table."""
    return init_impl(swarm.ids, _local_respond(swarm, cfg), cfg, targets,
                     origins)


def round_inputs(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                 respond=None):
    """The first half of a round: select α, solicit, and fold the
    solicitations' outcomes into the frontier (answered → queried, dead
    → evicted).  ``respond`` defaults to the local one
    (:func:`_local_respond`).  Returns ``(sel, q_hit, merge_args)``:
    ``q_hit [L,A]`` marks the solicitations that answered, and
    ``merge_args`` = ``(fr_idx, fr_d0, fr_q, resp_idx, resp_d0)`` are
    exactly the round merge's inputs."""
    n = cfg.n_nodes
    if respond is None:
        respond = _local_respond(swarm, cfg)
    sel, sel_d0, sel_pos = _select_alpha(st, cfg)
    sel = torch.where(st.done[:, None], -1, sel)       # done rows rest
    sel_alive = (sel >= 0) & swarm.alive[sel.clamp(0, n - 1).long()]
    resp, resp_d0, answered = respond(st.targets, sel, sel_d0)
    valid_sel = sel >= 0
    q_hit = valid_sel & sel_alive & answered
    e_hit = valid_sel & ~sel_alive
    fr_idx, fr_d0, queried = fold_solicitations(st.idx, st.dist, st.queried,
                                                sel_pos, q_hit, e_hit)
    return sel, q_hit, (fr_idx, fr_d0, queried, resp, resp_d0)


def _merge_round(st: LookupState, cfg: SwarmConfig, sel: torch.Tensor,
                 q_hit: torch.Tensor, merge_args,
                 merge_w: int | None = None, *,
                 trace: LookupTrace | None = None, rnd: int | None = None,
                 done_base: int = 0):
    """The second half of a round: merge, check the sync quorum, count
    the hop, stamp the lifecycle plane.  Dispatches on
    :func:`resolve_merge_impl` (``"fused-round"`` reaching here — the
    traced engine — takes K1, as the JAX engine degrades to its
    merge-only kernel); the done rule (the JAX engine's ``_sync_done``
    plus the exhaustion exit) is
    :func:`opendht_tpu_torch.ops.kernels.round_done`, which the kernel
    computes in place.

    With a ``trace`` (and the round index ``rnd``) the round's counters
    are added into it in place and ``(state, trace)`` is returned;
    ``done_base`` counts finished rows the compaction ladder keeps out
    of this dispatch, for the done gauge."""
    fr_idx, fr_d0, fr_q, resp, resp_d0 = merge_args
    impl = resolve_merge_impl(cfg, fr_idx.device)
    if impl in ("kernel", "fused-round"):
        f_idx, f_dist, f_q, done_merge = kernels.merge_round(
            fr_idx, fr_d0, fr_q, resp, resp_d0, quorum=cfg.quorum,
            keep=cfg.search_width)
    else:
        if impl == "rank":
            f_idx, f_dist, f_q = rank_merge_round_d0_w(
                fr_idx, fr_d0, fr_q, resp, resp_d0,
                keep=cfg.search_width, merge_w=merge_w)
        else:                                               # "sort"
            f_idx, f_dist, f_q = merge_shortlists_d0(
                torch.cat([fr_d0, resp_d0], dim=1),
                torch.cat([fr_idx, resp], dim=1),
                torch.cat([fr_q, torch.zeros_like(resp, dtype=torch.bool)],
                          dim=1),
                keep=cfg.search_width)
        done_merge = kernels.round_done(f_idx, f_q, cfg.quorum)
    new_st = _advance(st, sel, (f_idx, f_dist, f_q, done_merge), rnd)
    if trace is None:
        return new_st
    if rnd is None:
        raise ValueError("a traced round needs its round index rnd")
    if rnd < trace.requests.shape[0]:          # JAX's mode="drop"
        valid_sel = sel >= 0
        trace.requests[rnd] += valid_sel.sum().to(torch.int32)
        trace.replies[rnd] += (resp >= 0).sum().to(torch.int32)
        trace.drops[rnd] += (valid_sel & ~q_hit).sum().to(torch.int32)
        trace.churn[rnd] += (f_idx != st.idx).sum().to(torch.int32)
        trace.done[rnd] = new_st.done.sum().to(torch.int32) + done_base
        trace.active_rows[rnd] += (~st.done).sum().to(torch.int32)
        trace.rounds.clamp_(min=rnd + 1)
    return new_st, trace


def step_impl(ids: torch.Tensor, alive: torch.Tensor, respond,
              cfg: SwarmConfig, st: LookupState, *,
              rnd: int | torch.Tensor | None = None,
              merge_w: int | None = None, trace: LookupTrace | None = None,
              done_base: int = 0):
    """One composed lock-step round with any ``respond``: select α,
    solicit through ``respond``, fold, merge (K1 on the card, whatever
    ``merge_impl`` says: only the local round fuses into K2), check the
    quorum.  With a ``trace`` returns ``(state, trace)``
    (:func:`_merge_round`).  ``ids`` is unused by the round itself and
    kept for the JAX signature."""
    sw = Swarm(ids=ids, tables=None, alive=alive)
    sel, q_hit, merge_args = round_inputs(sw, cfg, st, respond)
    return _merge_round(st, cfg, sel, q_hit, merge_args, merge_w=merge_w,
                        trace=trace, rnd=rnd, done_base=done_base)


def lookup_step(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                merge_w: int | None = None, *,
                rnd: int | torch.Tensor | None = None) -> LookupState:
    """One lock-step round.  ``merge_w`` prices the plain rank merge at
    a narrower response width (guarded, bit-identical); the kernels
    always merge the full width.  ``rnd`` (the loop's round index) is
    needed only when the state carries the lifecycle plane."""
    if resolve_merge_impl(cfg, st.idx.device) == "fused-round":
        return _fused_round_step(swarm, cfg, st, rnd=rnd)
    return step_impl(swarm.ids, swarm.alive, _local_respond(swarm, cfg), cfg,
                     st, merge_w=merge_w, rnd=rnd)


def fused_round_inputs(swarm: Swarm, cfg: SwarmConfig, st: LookupState):
    """The fused round's prelude (the JAX engine's ``_fused_round_step``
    before its kernel call): select α, clip the solicited rows, look up
    who is alive (the local respond answers every live node, so
    ``q_hit`` is alive and ``e_hit`` dead), and the bucket-pair start
    ``w0 = clip(clz(sel_d0), 0, B-2)``.  Returns ``(sel, args)`` with
    ``args`` exactly :func:`opendht_tpu_torch.ops.kernels.fused_round`'s
    positional arguments."""
    if swarm.tables.dtype != torch.uint16:
        raise ValueError(
            "merge_impl='fused-round' requires augmented tables "
            "(SwarmConfig.aug_tables=True): the fused round kernel "
            "gathers and decodes the u16 bucket-row layout in-kernel")
    n, b_total = cfg.n_nodes, cfg.n_buckets
    sel, sel_d0, sel_pos = _select_alpha(st, cfg)
    sel = torch.where(st.done[:, None], -1, sel)
    safe = sel.clamp(0, n - 1)
    valid_sel = sel >= 0
    sel_alive = valid_sel & swarm.alive[safe.long()]
    w0 = prefix_len32(sel_d0).clamp(0, b_total - 2)
    frontier = [x.contiguous() for x in (st.targets[:, 0], st.idx, st.dist,
                                         st.queried)]
    return sel, (swarm.tables, *frontier, safe, sel_d0,
                 sel_pos.to(torch.int32), w0.to(torch.int32), sel_alive,
                 valid_sel & ~sel_alive)


def _fused_round_step(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                      rnd: int | None = None) -> LookupState:
    """One plain round as one K2 launch (``merge_impl="fused-round"``):
    the prelude :func:`fused_round_inputs`, then
    :func:`opendht_tpu_torch.ops.kernels.fused_round` — window gather,
    decode, queried/evict update, merge and quorum check — then the hop
    count and the lifecycle stamp.  Bit-identical to the composed round
    (``tests/test_torch_fused_round.py``)."""
    sel, args = fused_round_inputs(swarm, cfg, st)
    return _advance(st, sel, kernels.fused_round(
        *args, bucket_k=cfg.bucket_k, quorum=cfg.quorum,
        keep=cfg.search_width), rnd)


def traced_lookup_step(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                       trace: LookupTrace, rnd: int, done_base: int = 0,
                       merge_w: int | None = None):
    """One round with the flight recorder on → ``(state, trace)``.  The
    composed round with K1 under every ``merge_impl`` (the JAX traced
    engine's fallback for ``"pallas-round"``)."""
    return step_impl(swarm.ids, swarm.alive, _local_respond(swarm, cfg), cfg,
                     st, merge_w=merge_w, trace=trace, rnd=rnd,
                     done_base=done_base)


def _sample_origins(generator: torch.Generator, alive: torch.Tensor,
                    l: int) -> torch.Tensor:
    """A uniform random alive origin per lookup (inverse CDF over the
    alive mask)."""
    return _draw_alive(generator, *_alive_cdf(alive), l)


def _alive_cdf(alive: torch.Tensor):
    """The alive mask's prefix sum and its total (read back once)."""
    cum = torch.cumsum(alive.to(torch.int64), dim=0)
    return cum, int(cum[-1])


def _draw_alive(generator: torch.Generator, cum: torch.Tensor, total: int,
                l: int) -> torch.Tensor:
    """``l`` uniform alive nodes from :func:`_alive_cdf`'s ``(cum,
    total)``: no readback, so a loop that draws often reads the alive
    count once."""
    n = cum.shape[0]
    u = torch.randint(0, max(total, 1), (l,), generator=generator,
                      device=cum.device)
    if total == n:
        return u.to(torch.int32)
    return torch.searchsorted(cum, u, right=True).clamp(0, n - 1).to(
        torch.int32)


def _start(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
           generator, origins, track_lifecycle: bool, device):
    """Shared entry of :func:`lookup` and :func:`traced_lookup`: the
    device, the origins (random alive nodes drawn with ``generator``,
    seeded 0 if omitted, unless given) and the initial state."""
    dev = resolve_device(device)
    _require_on(swarm, dev)
    targets = targets.to(dev)
    if origins is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        origins = _sample_origins(generator, swarm.alive, targets.shape[0])
    else:
        origins = origins.to(dev)
    st = lookup_init(swarm, cfg, targets, origins)
    return dev, init_lifecycle(st) if track_lifecycle else st


def _lifecycle_stats(st: LookupState, order, stats, track: bool) -> None:
    """The per-row lifecycle rounds into ``stats``, in batch order."""
    if track and stats is not None:
        back = (lambda x: x) if order is None else (  # noqa: E731
            lambda x: _scatter_rows(x, order))
        stats["admitted_round"] = back(st.admitted_round)
        stats["completed_round"] = back(st.completed_round)


def lookup(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
           generator: torch.Generator | None = None, *,
           origins: torch.Tensor | None = None, compact: bool = True,
           stats: dict | None = None, track_lifecycle: bool = False,
           device=None) -> LookupResult:
    """Run a batch of iterative lookups to completion.

    ``targets [L,5]`` int64.  Each lookup starts from ``origins [L]``
    if given, else from a random alive node drawn with ``generator``
    (seeded 0 if omitted).  ``compact`` (default) repacks pending rows
    to the front after each burst and runs later rounds on a shrinking
    power-of-two prefix — bit-identical results.  ``stats`` receives
    the loop's dispatch counts and, with ``track_lifecycle`` (the
    lifecycle plane, a pure observer), the per-row ``admitted_round``
    and ``completed_round`` in batch order."""
    dev, st = _start(swarm, cfg, targets, generator, origins,
                     track_lifecycle, device)
    if not compact:
        st = run_burst_loop(
            lambda s, r: lookup_step(swarm, cfg, s, rnd=r), st, cfg)
        _lifecycle_stats(st, None, stats, track_lifecycle)
        return LookupResult(found=_finalize(swarm.ids, st, cfg),
                            hops=st.hops, done=st.done)
    st, _, order = run_compacted_burst_loop(
        lambda s, ex, r, hidden, mw: (
            lookup_step(swarm, cfg, s, merge_w=mw, rnd=r), ex),
        st, cfg, stats=stats,
        width_ladder=resolve_merge_impl(cfg, dev) == "rank")
    _lifecycle_stats(st, order, stats, track_lifecycle)
    found, hops, done = _finalize_scattered(swarm.ids, st, order, cfg)
    return LookupResult(found=found, hops=hops, done=done)


def traced_lookup(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
                  generator: torch.Generator | None = None, *,
                  origins: torch.Tensor | None = None, compact: bool = True,
                  stats: dict | None = None, track_lifecycle: bool = False,
                  device=None) -> tuple[LookupResult, LookupTrace]:
    """:func:`lookup` with the flight recorder on: the same origins, the
    same rounds and results (the counters are pure observers), plus the
    :class:`LookupTrace`.  Capture adds no host sync: the counters stay
    on the device until :func:`trace_to_dict`.  Compaction hides
    finished rows from later dispatches; they fold into the done gauge
    through ``done_base``, so a compacted run records the same trace as
    an uncompacted one."""
    dev, st = _start(swarm, cfg, targets, generator, origins,
                     track_lifecycle, device)
    trace = empty_lookup_trace(cfg, dev)
    if not compact:
        st, trace = run_burst_loop(
            lambda c, r: traced_lookup_step(swarm, cfg, c[0], c[1], r),
            (st, trace), cfg, done_of=lambda c: c[0].done)
        _lifecycle_stats(st, None, stats, track_lifecycle)
        return (LookupResult(found=_finalize(swarm.ids, st, cfg),
                             hops=st.hops, done=st.done), trace)

    def step(s, ex, r, hidden, mw):
        s, tr = traced_lookup_step(swarm, cfg, s, ex[0], r, hidden,
                                   merge_w=mw)
        return s, (tr,)

    st, (trace,), order = run_compacted_burst_loop(
        step, st, cfg, extras=(trace,), stats=stats,
        width_ladder=resolve_merge_impl(cfg, dev) == "rank")
    _lifecycle_stats(st, order, stats, track_lifecycle)
    found, hops, done = _finalize_scattered(swarm.ids, st, order, cfg)
    return LookupResult(found=found, hops=hops, done=done), trace


def lookup_steps(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                 n_steps: int) -> LookupState:
    """Run a fixed number of lock-step rounds (no early exit)."""
    for _ in range(n_steps):
        st = lookup_step(swarm, cfg, st)
    return st


# ---------------------------------------------------------------------------
# round loops
# ---------------------------------------------------------------------------

def burst_schedule(cfg: SwarmConfig) -> int:
    """First-burst round count: the convergence depth
    ``ceil(log2 N / 2.65)`` (at least 6), the JAX engine's calibration."""
    return min(cfg.max_steps,
               max(6, math.ceil(math.log2(max(2, cfg.n_nodes)) / 2.65)))


def run_burst_loop(step_fn, state, cfg: SwarmConfig,
                   done_of=lambda s: s.done):
    """Dispatch ``burst_schedule`` rounds back to back, then check
    done-ness with one readback, topping up 2 rounds at a time.  Done
    lookups are frozen inside the step, so overshoot never changes a
    result.  ``step_fn(state, rnd)`` advances an opaque carry one round;
    ``done_of`` gives its ``[L]`` done mask."""
    burst = burst_schedule(cfg)
    rounds = 0
    while rounds < cfg.max_steps:
        n = min(burst, cfg.max_steps - rounds)
        for _ in range(n):
            state = step_fn(state, rounds)
            rounds += 1
        # graftlint: disable=sync-in-loop (per-burst done-check readback, amortized over >=2 device rounds: the burst loop's contract; the resident serve loop is the zero-per-burst-poll alternative)
        if bool(done_of(state).all()):      # the one readback per burst
            break
        burst = 2
    return state


def _ladder_width(pending: int, l: int, floor: int = 128) -> int:
    """Dispatch width covering ``pending`` rows: the smallest power of
    two >= pending (and >= ``floor``), capped at the batch width."""
    if pending >= l:
        return l
    p = max(1, pending, min(floor, l))
    return min(l, 1 << (p - 1).bit_length())


def _stable_done_perm(done: torch.Tensor) -> torch.Tensor:
    """Stable pending-first row permutation (stability keeps the
    compacted loop bit-identical to the uncompacted one)."""
    return torch.argsort(done.to(torch.uint8), stable=True)


# The per-field helpers skip the lifecycle fields when they are None.

def _permute_state(st: LookupState, perm: torch.Tensor) -> LookupState:
    return LookupState(*[x if x is None else x[perm] for x in st])


def _prefix(st: LookupState, w: int) -> LookupState:
    return LookupState(*[x if x is None else x[:w] for x in st])


def _writeback_prefix(full: LookupState, sub: LookupState) -> LookupState:
    """``full`` with its first rows replaced by the advanced ``sub``."""
    wo = sub.done.shape[0]
    return LookupState(*[f if f is None else torch.cat([s, f[wo:]])
                         for f, s in zip(full, sub)])


def _compact_slice(st: LookupState, order: torch.Tensor, w: int):
    """First compaction: repack pending-first → ``(full, order, sub)``,
    the repacked full state, the row provenance and the ``[:w]``
    dispatch view."""
    perm = _stable_done_perm(st.done)
    full = _permute_state(st, perm)
    return full, order[perm], _prefix(full, w)


def _compact_resize(full: LookupState, order: torch.Tensor,
                    sub: LookupState, w: int):
    """Later compactions: fold the advanced prefix back into the full
    state, repack, and re-slice at the smaller width ``w``."""
    wo = sub.done.shape[0]
    full = LookupState(*[f if f is None else torch.cat([s, f[wo:]])
                         for f, s in zip(full, sub)])
    return _compact_slice(full, order, w)


def _pending_and_wneed(st: LookupState, cfg: SwarmConfig):
    """The per-burst readback, as one transfer: the pending row count
    (steers the row ladder) and the live-slot watermark — the widest
    pending row's next-round solicitation count times 2K (steers the
    merge-width ladder)."""
    pending = (~st.done).sum()
    unq = ((st.idx >= 0) & ~st.queried).sum(dim=1)
    blocks = torch.where(st.done, 0, unq.clamp(max=cfg.alpha))
    wneed = blocks.max() * (2 * cfg.bucket_k)
    p, w = torch.stack([pending, wneed]).tolist()
    return int(p), int(w)


def _scatter_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows back to their pre-compaction positions (``order[i]`` is row
    ``i``'s original index)."""
    out = torch.zeros_like(x)
    out[order] = x
    return out


def run_compacted_burst_loop(step_fn, st: LookupState, cfg: SwarmConfig,
                             extras=(), stats: dict | None = None,
                             width_ladder: bool = False):
    """:func:`run_burst_loop` with active-set compaction: after each
    burst, pending rows are stably repacked to the front and the next
    rounds run on a power-of-two prefix covering them.  With
    ``width_ladder`` (the plain rank merge), the same readback's
    watermark picks the merge's response width.  ``step_fn(st, extras,
    rnd, hidden, merge_w)`` advances one round and returns ``(st,
    extras)``: ``hidden`` counts the finished rows outside the
    dispatched prefix, ``extras`` (a trace) rides the loop uncompacted.
    Returns ``(full_state, extras, order)``, ``order[i]`` being row
    ``i``'s original position."""
    l = st.done.shape[0]
    order = torch.arange(l, dtype=torch.int64, device=st.done.device)
    full, sub, w = st, st, l
    resp_w = cfg.alpha * 2 * cfg.bucket_k
    ladder = (merge_ladder_widths(resp_w, 2 * cfg.bucket_k)
              if width_ladder else [resp_w])
    merge_w = None
    burst = max(2, burst_schedule(cfg) - 2)
    rounds = 0
    widths = []
    while rounds < cfg.max_steps:
        n = min(burst, cfg.max_steps - rounds)
        for _ in range(n):
            sub, extras = step_fn(sub, extras, rounds, l - w, merge_w)
            rounds += 1
        if w not in widths:
            widths.append(w)
        # graftlint: disable=sync-in-loop (per-burst pending + watermark readback, one transfer a burst amortized over >=2 device rounds: it steers the row and merge-width ladders)
        pending, wneed = _pending_and_wneed(sub, cfg)
        if pending == 0:
            break
        burst = 2
        if len(ladder) > 1:
            merge_w = pick_merge_width(wneed, resp_w, 2 * cfg.bucket_k)
        w_new = _ladder_width(pending, l)
        if w_new < w:
            if w == l:
                full, order, sub = _compact_slice(sub, order, w_new)
            else:
                full, order, sub = _compact_resize(full, order, sub, w_new)
            w = w_new
    full = _writeback_prefix(full, sub) if w < l else sub
    if stats is not None:
        stats["rounds_dispatched"] = rounds
        stats["widths"] = widths
    return full, extras, order


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

def _finalize(ids: torch.Tensor, st: LookupState,
              cfg: SwarmConfig) -> torch.Tensor:
    """The reported top-``quorum``: the shortlist head (``quorum + 2``
    surrogate ranks) re-sorted by the exact 160-bit distance, unqueried
    places -1."""
    n = ids.shape[0]
    f = min(cfg.search_width, cfg.quorum + 2)
    idx, queried = st.idx[:, :f], st.queried[:, :f]
    cand = ids[idx.clamp(0, n - 1).long()]                      # [L,F,5]
    d = cand ^ st.targets[:, None, :]
    d = torch.where((idx < 0)[..., None], U32_MAX, d)
    perm = lexsort([d[..., i] for i in range(N_LIMBS)], dim=1)
    f_idx = torch.gather(idx, 1, perm)
    f_q = torch.gather(queried, 1, perm)
    q = cfg.quorum
    return torch.where(f_q[:, :q], f_idx[:, :q], -1)


def _finalize_scattered(ids: torch.Tensor, st: LookupState,
                        order: torch.Tensor, cfg: SwarmConfig):
    found = _finalize(ids, st, cfg)
    return (_scatter_rows(found, order), _scatter_rows(st.hops, order),
            _scatter_rows(st.done, order))


def true_closest(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
                 k: int = 8, *, device=None) -> torch.Tensor:
    """Exact alive k-closest ``[L,k]`` int32 (the recall ground truth):
    the K3 kernel on the card, its plain version on the CPU."""
    dev = resolve_device(device)
    _require_on(swarm, dev)
    return closest_nodes_batched(swarm.ids, targets.to(dev), k,
                                 valid=swarm.alive)


def key_owners(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor, *,
               device=None) -> torch.Tensor:
    """The node each key belongs to: the XOR-nearest id of the whole
    swarm (alive or not) per target, ``[L]`` int32 — the K3′ kernel
    (K3 at k=1) on the card, its plain version on the CPU.  On a healthy
    swarm a lookup that found it reports it first."""
    dev = resolve_device(device)
    _require_on(swarm, dev)
    return kernels.nearest_ids(swarm.ids, targets.to(dev).contiguous())


def lookup_recall(swarm: Swarm, cfg: SwarmConfig, result: LookupResult,
                  targets: torch.Tensor, k: int = 8,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lookup fraction of the true k closest alive nodes found.
    ``valid`` overrides the ground-truth membership (default alive)."""
    sw = swarm if valid is None else swarm._replace(alive=valid)
    truth = true_closest(sw, cfg, targets, k, device=swarm.ids.device)
    found = result.found
    match = (truth[:, :, None] == found[:, None, :]) & (
        truth[:, :, None] >= 0)
    return match.any(dim=2).to(torch.float32).mean(dim=1)


def honest_recall(swarm: Swarm, cfg: SwarmConfig, result: LookupResult,
                  targets: torch.Tensor, k: int = 8) -> torch.Tensor:
    """:func:`lookup_recall` against the honest alive ground truth
    (``alive & ~byzantine``) — the chaos engine's survival metric."""
    return lookup_recall(swarm, cfg, result, targets, k,
                         valid=_honest_alive(swarm))


def _honest_alive(swarm: Swarm) -> torch.Tensor:
    return (swarm.alive if swarm.byzantine is None
            else swarm.alive & ~swarm.byzantine)


def hop_histogram(hops: torch.Tensor, max_steps: int) -> torch.Tensor:
    """``[max_steps + 1]`` int32 counts of lookups by rounds taken, the
    last bin absorbing ``>= max_steps``."""
    h = hops.clamp(0, max_steps).long()
    return torch.bincount(h, minlength=max_steps + 1).to(torch.int32)


# ---------------------------------------------------------------------------
# adversarial lookups: Byzantine responders, reply loss, and the
# strike/blacklist defence
# ---------------------------------------------------------------------------

class LookupFaults(NamedTuple):
    """The fault and defence model of :func:`chaos_lookup`.

    * ``drop_frac`` — fraction of delivered replies lost in transit (a
      hash-drawn Bernoulli per (node, target, round)); the entry stays
      unqueried and is solicited again next round;
    * ``eclipse`` — how Byzantine responders (``Swarm.byzantine``) lie:
      False names random nodes at a near-zero claimed distance, True
      names fellow Byzantine nodes (colluder promotion);
    * ``seed`` — the stateless fault stream's seed;
    * ``strike_limit`` — strikes before a node is blacklisted;
    * ``defend`` — False turns off the claim check and the strike
      accounting, to measure the undefended damage."""
    drop_frac: float = 0.0
    eclipse: bool = False
    seed: int = 0
    strike_limit: int = 3
    defend: bool = True


def _fault_hash(x: torch.Tensor, y: torch.Tensor, rnd,
                seed: int) -> torch.Tensor:
    """Stateless per-exchange u32 hash (a murmur-style finaliser), the
    chaos engine's counter-based random stream: deterministic per
    (x, y, round, seed), so fault schedules replay exactly with no
    generator threaded through the round loop.  ``x``, ``y``: int64
    tensors read as u32 (broadcasting); ``rnd``: an int or a tensor.
    Every product is :func:`~opendht_tpu_torch.ops.u32.mul32`, so no
    int64 multiply overflows and no right shift sees a negative."""
    if isinstance(rnd, torch.Tensor):
        r = mul32((rnd.to(torch.int64) + (seed & MASK32)) & MASK32,
                  0xC2B2AE35)
    else:
        r = (((int(rnd) + seed) & MASK32) * 0xC2B2AE35) & MASK32
    h = (mul32(x.to(torch.int64) & MASK32, 0x9E3779B1)
         ^ mul32(y.to(torch.int64) & MASK32, 0x85EBCA6B) ^ r)
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def byz_colluder_pool(byzantine: torch.Tensor):
    """The eclipse poison's colluder pool, computed once a run: a stable
    argsort puts the Byzantine indices first (``[N]`` int32), and their
    count, at least 1 (``[]`` int64, unused when no responder lies)."""
    pool = torch.argsort((~byzantine).to(torch.uint8), stable=True)
    return pool.to(torch.int32), byzantine.sum().clamp(min=1)


def _count_at(node: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """``[n]`` int32 count of the ``mask``ed entries of ``node`` per
    node (JAX's ``.at[where(mask, node, n)].add(1, mode="drop")``: the
    masked entries land in a spare bin that is cut off)."""
    idx = torch.where(mask, node.to(torch.int64), n).flatten()
    out = torch.zeros((n + 1,), dtype=torch.int32, device=node.device)
    return out.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))[:n]


def chaos_round_inputs(swarm: Swarm, cfg: SwarmConfig, faults: LookupFaults,
                       st: LookupState, strikes: torch.Tensor, rnd: int,
                       byz_aux=None, respond=None):
    """The first half of an adversarial round, in this order:

    1. blacklist eviction: nodes at ``strikes >= strike_limit`` leave
       every shortlist (defended runs);
    2. α select; the solicitations of live nodes are answered;
    3. the poison: a Byzantine responder's every candidate slot becomes
       a hash-drawn node id (random, or a colluder under ``eclipse``)
       claimed at a near-zero distance (top 17 bits clear);
    4. the drop: a ``drop_frac`` share of delivered replies is lost;
    5. the defence's check: each candidate's claimed distance is
       compared with the exact first limb on its top 16 bits (honest
       windows are exact there, so a mismatch proves a lie), and
       contradicted or blacklisted candidates become -1 / all-ones in
       place, mid-row;

    then the fold of the solicitations' outcomes into the frontier
    (answered after the drop → queried, dead → evicted).  Returns
    ``(st, sel, q_hit, merge_args, outcome)``: the state after the
    eviction, the round merge's inputs ``merge_args`` exactly as
    :func:`round_inputs` gives them, and ``outcome = (succ, dropm,
    malformed, poison_ct)`` for the strike accounting.  ``respond``
    defaults to the local one; the sharded chaos engine routes it."""
    n = cfg.n_nodes
    t0 = st.targets[:, 0]
    if faults.defend:
        blk = strikes >= faults.strike_limit
        conv = (st.idx >= 0) & blk[st.idx.clamp(0, n - 1).long()]
        st = st._replace(idx=torch.where(conv, -1, st.idx),
                         dist=torch.where(conv, U32_MAX, st.dist),
                         queried=st.queried & ~conv)

    sel, sel_d0, sel_pos = _select_alpha(st, cfg)
    sel = torch.where(st.done[:, None], -1, sel)
    safe = sel.clamp(0, n - 1).long()
    valid = sel >= 0
    sel_alive = valid & swarm.alive[safe]
    solicit = torch.where(sel_alive, sel, -1)
    if respond is None:
        respond = _local_respond(swarm, cfg)
    resp, resp_d0, answered = respond(st.targets, solicit, sel_d0)
    a = sel.shape[1]
    k2 = resp.shape[1] // a
    if swarm.byzantine is not None:
        byz_rep = (sel_alive & swarm.byzantine[safe] & answered
                   ).repeat_interleave(k2, dim=1)              # [L, A·2K]
        slot = torch.arange(a * k2, device=sel.device)[None, :]
        h = _fault_hash((safe.repeat_interleave(k2, dim=1) + slot * 7919)
                        & MASK32, t0[:, None], rnd, faults.seed ^ 0x517CC1B7)
        if faults.eclipse:
            pool, n_byz = (byz_aux if byz_aux is not None
                           else byz_colluder_pool(swarm.byzantine))
            p_idx = pool[h % n_byz]
        else:
            p_idx = (h % n).to(torch.int32)
        p_d0 = _fault_hash(h, t0[:, None], rnd,
                           faults.seed ^ 0x27220A95) >> 17
        resp = torch.where(byz_rep, p_idx, resp)
        resp_d0 = torch.where(byz_rep, p_d0, resp_d0)

    if faults.drop_frac:
        # Only delivered replies can be lost; u32(f · (2^32 - 1)),
        # truncated, as the JAX engine's threshold.
        thresh = int(min(1.0, faults.drop_frac) * 4294967295.0)
        dropm = sel_alive & answered & (
            _fault_hash(safe, t0[:, None], rnd, faults.seed) <= thresh)
        answered = answered & ~dropm
        drop_rep = dropm.repeat_interleave(k2, dim=1)
        resp = torch.where(drop_rep, -1, resp)
        resp_d0 = torch.where(drop_rep, U32_MAX, resp_d0)
    else:
        dropm = torch.zeros_like(valid)

    if faults.defend:
        c_safe = resp.clamp(0, n - 1).long()
        exact_d0 = swarm.ids[:, 0][c_safe] ^ t0[:, None]
        contradicted = (resp >= 0) & ((resp_d0 >> 16) != (exact_d0 >> 16))
        bad = contradicted | ((resp >= 0) & blk[c_safe])
        resp = torch.where(bad, -1, resp)
        resp_d0 = torch.where(bad, U32_MAX, resp_d0)
        malformed = contradicted.view(-1, a, k2).any(dim=2)
        poison_ct = contradicted.sum().to(torch.int32)
    else:
        malformed = torch.zeros_like(valid)
        poison_ct = 0

    q_hit = valid & sel_alive & answered
    merge_args = (*fold_solicitations(st.idx, st.dist, st.queried, sel_pos,
                                      q_hit, valid & ~sel_alive),
                  resp, resp_d0)
    return st, sel, q_hit, merge_args, (q_hit & ~malformed, dropm,
                                        malformed, poison_ct)


def chaos_step_impl(swarm: Swarm, cfg: SwarmConfig, faults: LookupFaults,
                    st: LookupState, strikes: torch.Tensor, rnd: int,
                    byz_aux=None, trace: LookupTrace | None = None,
                    done_base: int = 0, *, respond=None, allreduce=None):
    """One adversarial round: :func:`chaos_round_inputs`, the shared
    round tail (:func:`_merge_round`, K1 on the card), then the strike
    accounting — a clean answer clears the responder's strikes, an
    all-silent round adds one, and every poisoned reply adds one (so
    one round's events merge in any order).  ``respond`` routes the
    solicitations (default local); ``allreduce`` (the sharded engine's
    sum over its ranks) merges the round's ``[3, N]`` strike events
    mesh-wide before they apply, so every rank holds the same strikes.
    Returns ``(state, strikes)``, or ``(state, strikes, trace)`` with a
    trace (its ``poison``, ``strikes`` and ``convictions`` rows filled
    here)."""
    st, sel, q_hit, merge_args, outcome = chaos_round_inputs(
        swarm, cfg, faults, st, strikes, rnd, byz_aux, respond)
    succ, dropm, malformed, poison_ct = outcome
    new_st = _merge_round(st, cfg, sel, q_hit, merge_args, trace=trace,
                          rnd=rnd, done_base=done_base)
    traced = trace is not None and rnd < trace.poison.shape[0]
    if trace is not None:
        new_st, trace = new_st
        if traced:
            trace.poison[rnd] += poison_ct
    if not faults.defend:
        return (new_st, strikes) if trace is None else (new_st, strikes,
                                                        trace)
    n = cfg.n_nodes
    succ_ct = _count_at(sel, succ, n)
    drop_ct = _count_at(sel, dropm, n)
    lie_ct = _count_at(sel, malformed, n)
    if allreduce is not None:
        succ_ct, drop_ct, lie_ct = allreduce(
            torch.stack([succ_ct, drop_ct, lie_ct])).unbind(0)
    new_strikes = torch.where(succ_ct > 0, 0,
                              strikes + drop_ct.clamp(max=1)) + lie_ct
    if trace is None:
        return new_st, new_strikes
    if traced:
        trace.strikes[rnd] += (new_strikes - strikes).clamp(min=0).sum(
            ).to(torch.int32)
        trace.convictions[rnd] = (new_strikes >= faults.strike_limit).sum(
            ).to(torch.int32)
    return new_st, new_strikes, trace


def chaos_lookup_init(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
                      origins: torch.Tensor) -> LookupState:
    """The chaos engine's seed exchange: the origin's own routing table,
    trusted, so no fault touches it — :func:`lookup_init`."""
    return lookup_init(swarm, cfg, targets, origins)


def chaos_lookup_step(swarm: Swarm, cfg: SwarmConfig, faults: LookupFaults,
                      st: LookupState, strikes: torch.Tensor, rnd: int,
                      byz_aux=None, trace: LookupTrace | None = None,
                      done_base: int = 0):
    """One adversarial round (:func:`chaos_step_impl`); the chaos
    engine's loops run every round through here."""
    return chaos_step_impl(swarm, cfg, faults, st, strikes, rnd,
                           byz_aux=byz_aux, trace=trace, done_base=done_base)


def chaos_lookup(swarm: Swarm, cfg: SwarmConfig, targets: torch.Tensor,
                 generator: torch.Generator | None = None,
                 faults: LookupFaults = LookupFaults(), *,
                 origins: torch.Tensor | None = None,
                 collect_trace: bool = False, compact: bool = True,
                 stats: dict | None = None, track_lifecycle: bool = False,
                 device=None):
    """Run a batch of lookups to completion under the adversarial fault
    model (Byzantine responders, reply loss) with the strike/blacklist
    defence.

    The round index is the fault stream's round coordinate.  Origins
    are ``origins`` if given, else honest alive nodes drawn with
    ``generator`` (seeded 0 if omitted).  Returns ``(LookupResult,
    strikes [N] int32)`` — ``strikes >= faults.strike_limit`` is the
    conviction mask — or, with ``collect_trace``, ``(result, strikes,
    LookupTrace)``.  ``compact`` (default) runs later rounds on the
    pending rows only: every fault decision keys on (node, target,
    round), never on a row's position, so the results are the same; rows
    frozen outside the dispatched prefix miss the per-round blacklist
    scrubs, which one deferred pass (:func:`_evict_blacklisted`, with the
    strikes as of the last round's start) applies before the result is
    read.  There is no merge-width ladder."""
    dev = resolve_device(device)
    _require_on(swarm, dev)
    targets = targets.to(dev)
    if origins is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        origins = _sample_origins(generator, _honest_alive(swarm),
                                  targets.shape[0])
    else:
        origins = origins.to(dev)
    st = chaos_lookup_init(swarm, cfg, targets, origins)
    if track_lifecycle:
        st = init_lifecycle(st)
    strikes = torch.zeros((cfg.n_nodes,), dtype=torch.int32, device=dev)
    byz_aux = (byz_colluder_pool(swarm.byzantine)
               if faults.eclipse and swarm.byzantine is not None else None)
    trace = empty_lookup_trace(cfg, dev) if collect_trace else None
    if compact:
        prev = {"strikes": strikes}

        def step(s, ex, r, hidden, mw):
            prev["strikes"] = ex[0]
            out = chaos_lookup_step(swarm, cfg, faults, s, ex[0], r, byz_aux,
                                    trace=trace, done_base=hidden)
            return out[0], tuple(out[1:])

        st, extras, order = run_compacted_burst_loop(
            step, st, cfg, extras=(strikes,), stats=stats)
        strikes = extras[0]
        _lifecycle_stats(st, order, stats, track_lifecycle)
        if faults.defend:
            st = _evict_blacklisted(
                st, prev["strikes"] >= faults.strike_limit, cfg)
        found, hops, done = _finalize_scattered(swarm.ids, st, order, cfg)
    else:
        st, strikes = run_burst_loop(
            lambda c, r: chaos_lookup_step(swarm, cfg, faults, c[0], c[1],
                                           r, byz_aux, trace=trace)[:2],
            (st, strikes), cfg, done_of=lambda c: c[0].done)
        _lifecycle_stats(st, None, stats, track_lifecycle)
        found, hops, done = _finalize(swarm.ids, st, cfg), st.hops, st.done
    res = LookupResult(found=_censor_convicted(found, strikes, cfg, faults),
                       hops=hops, done=done)
    return (res, strikes, trace) if collect_trace else (res, strikes)


def _evict_blacklisted(st: LookupState, blk: torch.Tensor,
                       cfg: SwarmConfig) -> LookupState:
    """One deferred blacklist eviction and re-sort over every row: the
    scrubs that rows frozen by compaction missed.  Convictions are
    permanent and the merge is deterministic on the surviving set, so
    evicting once with the final blacklist and re-sorting once lands
    the state the full-width engine reaches; rows dispatched through the
    last round are unchanged."""
    n = cfg.n_nodes
    conv = (st.idx >= 0) & blk[st.idx.clamp(0, n - 1).long()]
    f_idx, f_dist, f_q = merge_shortlists_d0(
        torch.where(conv, U32_MAX, st.dist), torch.where(conv, -1, st.idx),
        st.queried & ~conv, keep=cfg.search_width)
    return st._replace(idx=f_idx, dist=f_dist, queried=f_q)


def _censor_convicted(found: torch.Tensor, strikes: torch.Tensor,
                      cfg: SwarmConfig, faults: LookupFaults) -> torch.Tensor:
    """Convicted nodes out of the reported results (a conviction in the
    last round would otherwise survive in a done lookup's head)."""
    if not faults.defend:
        return found
    blk = strikes >= faults.strike_limit
    hole = (found >= 0) & blk[found.clamp(0, cfg.n_nodes - 1).long()]
    return torch.where(hole, -1, found)
