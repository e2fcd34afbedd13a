"""Open-loop serving engine: slot-recycled continuous lookups.

Counterpart of the burst engine of ``opendht_tpu/models/serve.py``.
The engine keeps a fixed ``[C]``-slot :class:`LookupState` on the
device.  A free slot is ``done=True`` with an empty shortlist — inert in
the shared round step (done rows solicit nobody) — so occupancy is a
cost knob, not a semantics one.  Each host-loop iteration:

* **admit** — queued requests (arrived by their open-loop timestamps)
  are scattered into free slots as one fixed-width micro-batch
  (``admit_cap``, padded with the sentinel slot ``C``, which lands in a
  spare row that is sliced off); the seed exchange is
  :func:`~opendht_tpu_torch.models.swarm.lookup_init`, the batch
  engine's, and ``admitted_round`` is stamped with the round index;
* **burst** — a few rounds of the shared step
  (:func:`~opendht_tpu_torch.models.swarm.lookup_step`: K1 on the card
  under ``merge_impl="auto"``, K2 under ``"fused-round"``) advance
  every occupied slot; finished rows freeze and the lifecycle plane
  stamps ``completed_round``;
* **harvest** — one readback a burst (:meth:`ServeEngine.snapshot`, a
  single device-to-host transfer) returns done/hops/lifecycle/found;
  newly done slots are recorded and recycled.

Latency is reconstructed: ``arrival→completion = round-end wall
(completed_round) − arrival``, with round-end walls interpolated inside
each burst and floored at the admission wall.

Overlays, each off by default: the device hot-key result cache
(:class:`ResultCache`: a hit completes in zero rounds without a slot;
misses run exactly the cache-off programs), per-class token-bucket
admission (:class:`AdmissionControl`: ``shed`` / ``queue`` /
``degrade``), and a signed request class checked by a
:class:`~opendht_tpu_torch.models.integrity.SignatureStage`.

Host syncs.  The loop reads the device back where the JAX loop does:
once a burst (the snapshot) and, with the cache on, once a probed
admission (the hit rows) or a ``degrade`` probe.  Uploads of the host's
admission batches go through pinned memory without blocking, and the
origin sampler reads the alive count once, when the engine is built.

The resident engine (:class:`ResidentServeEngine`,
:func:`serve_resident`, :func:`resident_closed_loop_replay`) runs a
whole iteration — enqueue into a device admission ring, pop / probe /
admit, a budget of rounds, harvest — as one program a macro step: on
the card a captured CUDA graph, read back once a step, one step late.

Randomness is an argument: admissions take their origins as a tensor;
:func:`serve_open_loop` and :func:`closed_loop_replay` draw them from an
explicit ``torch.Generator`` unless given (``origins_of`` / ``origins``);
:func:`poisson_zipf_events` draws its arrivals and Zipf keys with numpy
(as the JAX function does) and its key pool from a seeded
``torch.Generator`` unless ``pool`` is given.
"""

from __future__ import annotations

import itertools
import math
import time
from collections import Counter, OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernels
from ..ops.u32 import MASK32, U32_MAX, mul32
from ..ops.xor_metric import N_LIMBS, merge_ladder_widths
from ..parallel.mesh import gather_many, shard_rows
from ..parallel.sharded import (
    _sharded_resident_step,
    gather_seeded,
    sharded_lookup_init,
    sharded_lookup_step,
)
from ..utils.rate_limiter import TokenBucket
from .swarm import (
    LookupResult,
    LookupState,
    Swarm,
    SwarmConfig,
    _alive_cdf,
    _draw_alive,
    _finalize,
    _require_on,
    burst_schedule,
    lookup_init,
    lookup_step,
    resolve_device,
)


class ServeOverloadError(RuntimeError):
    """The open-loop arrival stream exceeds what the slot capacity can
    drain: the admission queue grew past the overload bound.  With an
    :class:`AdmissionControl` of policy ``shed`` (or ``degrade``) the
    engine sheds the excess instead and never raises this."""


# ---------------------------------------------------------------------------
# transfers
# ---------------------------------------------------------------------------

def _upload(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A host array (numpy, uint32 widened to int64) or a tensor as a
    ``dtype`` tensor on ``dev``.  To the card it goes through pinned
    memory without blocking, so an upload never waits for the device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _fetch(*ts: torch.Tensor):
    """Read several ``[R, ...]`` tensors back in one transfer → numpy
    arrays of their own dtypes (bool, int32, int64)."""
    r = ts[0].shape[0]
    flat = [t.reshape(r, -1).to(torch.int64) for t in ts]
    host = torch.cat(flat, dim=1).cpu().numpy()
    out, c = [], 0
    for t, f in zip(ts, flat):
        w = f.shape[1]
        a = host[:, c:c + w].reshape(t.shape)
        out.append(a.astype(np.bool_) if t.dtype == torch.bool
                   else a.astype(np.int32) if t.dtype == torch.int32 else a)
        c += w
    return out


def _set_rows(plane: torch.Tensor, rows: torch.Tensor,
              vals) -> torch.Tensor:
    """``plane`` with ``rows`` set to ``vals``; a row index equal to the
    plane's length (the sentinel) lands in a spare row that is sliced
    off — JAX's ``mode="drop"``, with no row clamped onto a live one."""
    ext = torch.cat([plane, plane[:1]])
    ext[rows.long()] = vals
    return ext[:-1]


# ---------------------------------------------------------------------------
# device hot-key result cache
# ---------------------------------------------------------------------------

class ResultCache(NamedTuple):
    """Direct-mapped result cache over ``K = keys.shape[0]`` slots: a
    key's slot is a mix of its five limbs mod K (:func:`_cache_slot_of`),
    so a probe is one gather and a fill one scatter.  A colliding fill
    evicts.  An entry is live iff its ``fill_epoch`` equals ``epoch``;
    :func:`_cache_invalidate` bumps the epoch and every entry goes
    stale at once."""
    keys: torch.Tensor        # [K,5] int64 u32 key limbs
    found: torch.Tensor       # [K,quorum] int32 result heads (-1 pad)
    hops: torch.Tensor        # [K] int32 hops the fill paid
    fill_round: torch.Tensor  # [K] int32 engine round at fill
    fill_epoch: torch.Tensor  # [K] int64 u32 epoch at fill (0 = never)
    epoch: torch.Tensor       # [] int64 u32 current epoch (starts at 1)


def empty_result_cache(cfg: SwarmConfig, k_slots: int,
                       device=None) -> ResultCache:
    """All-stale ``[k_slots]`` cache: fill epochs 0, epoch 1."""
    dev = resolve_device(device)
    return ResultCache(
        keys=torch.zeros((k_slots, N_LIMBS), dtype=torch.int64, device=dev),
        found=torch.full((k_slots, cfg.quorum), -1, dtype=torch.int32,
                         device=dev),
        hops=torch.zeros((k_slots,), dtype=torch.int32, device=dev),
        fill_round=torch.zeros((k_slots,), dtype=torch.int32, device=dev),
        fill_epoch=torch.zeros((k_slots,), dtype=torch.int64, device=dev),
        epoch=torch.ones((), dtype=torch.int64, device=dev))


def _cache_slot_of(keys: torch.Tensor, k_slots: int) -> torch.Tensor:
    """``[A,5] -> [A]`` int32 direct-map slot: a murmur-style limb mix
    mod ``k_slots``, in u32 arithmetic (products through ``mul32``)."""
    h = keys[:, 0]
    for j in range(1, N_LIMBS):
        h = mul32(h, 0x9E3779B1) ^ keys[:, j]
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    return (h % k_slots).to(torch.int32)


def _cache_slot_np(keys: np.ndarray, k_slots: int) -> np.ndarray:
    """Numpy uint32 twin of :func:`_cache_slot_of`: the host dedupes a
    fill batch by slot before the scatter, since the scatter writes its
    five fields separately and a repeated index would leave each
    field's winner to the device."""
    with np.errstate(over="ignore"):
        k = keys.astype(np.uint32)
        h = k[:, 0]
        for j in range(1, N_LIMBS):
            h = (h * np.uint32(0x9E3779B1)) ^ k[:, j]
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x7FEB352D)
        h = h ^ (h >> np.uint32(15))
        return (h % np.uint32(k_slots)).astype(np.int64)


def _probe_impl(cache: ResultCache, keys: torch.Tensor):
    """One slot gather, a 5-limb compare and the epoch check →
    ``(hit [A] bool, found [A,q] int32, hops [A] int32)``."""
    sl = _cache_slot_of(keys, cache.keys.shape[0]).long()
    hit = ((cache.keys[sl] == keys).all(dim=1)
           & (cache.fill_epoch[sl] == cache.epoch))
    return hit, cache.found[sl], cache.hops[sl]


def _cache_probe(cache: ResultCache, keys: torch.Tensor):
    """Standalone probe (the ``degrade`` policy's read); the cache is
    untouched."""
    return _probe_impl(cache, keys)


def _cache_fill(cache: ResultCache, keys: torch.Tensor, found: torch.Tensor,
                hops: torch.Tensor, mask: torch.Tensor, rnd) -> ResultCache:
    """Fill harvested results: ``keys [M,5]`` / ``found [M,q]`` / ``hops
    [M]`` with ``mask [M]`` selecting the real rows (the rest go to the
    sentinel slot and vanish).  The caller passes slot-unique real rows
    (:meth:`ServeEngine.fill_cache` dedupes on the host)."""
    k_slots = cache.keys.shape[0]
    sl = torch.where(mask, _cache_slot_of(keys, k_slots), k_slots)
    r32 = torch.full(sl.shape, int(rnd), dtype=torch.int32, device=sl.device)
    return cache._replace(
        keys=_set_rows(cache.keys, sl, keys),
        found=_set_rows(cache.found, sl, found),
        hops=_set_rows(cache.hops, sl, hops),
        fill_round=_set_rows(cache.fill_round, sl, r32),
        fill_epoch=_set_rows(cache.fill_epoch, sl,
                             cache.epoch.expand(sl.shape)))


def _cache_invalidate(cache: ResultCache) -> ResultCache:
    """Bump the epoch: every entry goes stale at once (the announce
    paths' invalidation)."""
    return cache._replace(epoch=(cache.epoch + 1) & MASK32)


# ---------------------------------------------------------------------------
# the serve state
# ---------------------------------------------------------------------------

def empty_serve_state(cfg: SwarmConfig, slots: int,
                      device=None) -> LookupState:
    """All-free ``[slots]`` serve state: every row done with an empty
    shortlist and lifecycle ``-1``/``-1`` (never admitted)."""
    dev = resolve_device(device)
    s = cfg.search_width

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return LookupState(
        targets=full((slots, N_LIMBS), 0, torch.int64),
        idx=full((slots, s), -1, torch.int32),
        dist=full((slots, s), U32_MAX, torch.int64),
        queried=full((slots, s), False, torch.bool),
        done=full((slots,), True, torch.bool),
        hops=full((slots,), 0, torch.int32),
        admitted_round=full((slots,), -1, torch.int32),
        completed_round=full((slots,), -1, torch.int32))


def _admit(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
           keys: torch.Tensor, slots: torch.Tensor, origins: torch.Tensor,
           rnd: int) -> LookupState:
    """Scatter a padded admission micro-batch into free slots: ``keys
    [A,5]``, ``slots [A]`` (pad sentinel ``C``), ``origins [A]``.  The
    seed exchange is the batch engine's ``lookup_init``, so a
    closed-loop replay through here equals ``lookup``."""
    new = lookup_init(swarm, cfg, keys, origins)
    return _scatter_rows_into(st, new, slots, rnd)


def _scatter_rows_into(st: LookupState, new: LookupState,
                       slots: torch.Tensor, rnd) -> LookupState:
    """The admission scatter (sentinel = the slot count, dropped): the
    new rows, not done, zero hops, admitted at ``rnd`` (an int or a
    0-dim tensor on the device), not complete."""
    a = slots.shape[0]
    dev = slots.device

    def const(v, dtype):
        if isinstance(v, torch.Tensor):
            return v.to(dtype).expand(a)
        return torch.full((a,), v, dtype=dtype, device=dev)

    return LookupState(
        targets=_set_rows(st.targets, slots, new.targets),
        idx=_set_rows(st.idx, slots, new.idx),
        dist=_set_rows(st.dist, slots, new.dist),
        queried=_set_rows(st.queried, slots, new.queried),
        done=_set_rows(st.done, slots, const(False, torch.bool)),
        hops=_set_rows(st.hops, slots, const(0, torch.int32)),
        admitted_round=_set_rows(st.admitted_round, slots,
                                 const(rnd, torch.int32)),
        completed_round=_set_rows(st.completed_round, slots,
                                  const(-1, torch.int32)))


def _admit_cached(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                  cache: ResultCache, keys: torch.Tensor,
                  slots: torch.Tensor, origins: torch.Tensor, rnd: int):
    """:func:`_admit` with the result cache consulted first: rows that
    hit a live entry go to the sentinel (no slot, zero rounds); misses
    scatter exactly as :func:`_admit`.  Returns ``(state, cache, hit,
    hit_found, hit_hops)``; the cache passes through unchanged."""
    c = st.done.shape[0]
    hit, h_found, h_hops = _probe_impl(cache, keys)
    new = lookup_init(swarm, cfg, keys, origins)
    eff = torch.where(hit, c, slots)
    st = _scatter_rows_into(st, new, eff, rnd)
    return st, cache, hit, h_found, h_hops


def _snapshot(swarm: Swarm, cfg: SwarmConfig, st: LookupState):
    """The harvest: done, hops, lifecycle rows and the finalized result
    heads (on the device; :meth:`ServeEngine.snapshot` reads them back
    in one transfer)."""
    return (st.done, st.hops, st.admitted_round, st.completed_round,
            _finalize(swarm.ids, st, cfg))


def _expire_slots(st: LookupState, slots: torch.Tensor) -> LookupState:
    """Retire rows past their round budget: mark them done (sentinel
    slots dropped).  ``completed_round`` stays -1, so the host books
    them as expired, not as latency samples."""
    done = _set_rows(st.done, slots, torch.ones(slots.shape, dtype=torch.bool,
                                                device=slots.device))
    return st._replace(done=done)


class ServeEngine:
    """Single-device serve engine: admit / step / snapshot over one
    resident ``[slots]`` state; ``admit_cap`` fixes the admission
    micro-batch width.  ``cache_slots > 0`` attaches the result cache:
    admissions go through :meth:`admit_probed`, completions fill it
    through :meth:`fill_cache`, announces invalidate it through
    :meth:`invalidate_cache`.  The swarm must live on ``device`` (the
    card unless ``"cpu"`` is asked for)."""

    def __init__(self, swarm: Swarm, cfg: SwarmConfig, slots: int,
                 admit_cap: int | None = None, cache_slots: int = 0,
                 device=None):
        self.device = resolve_device(device)
        _require_on(swarm, self.device)
        self.swarm, self.cfg, self.slots = swarm, cfg, slots
        self.admit_cap = min(slots, admit_cap or min(slots, 512))
        if cache_slots < 0:
            raise ValueError(f"cache_slots must be >= 0, got "
                             f"{cache_slots}")
        self.cache_slots = cache_slots
        self.cache = (empty_result_cache(cfg, cache_slots, self.device)
                      if cache_slots else None)
        # Test hook: False keeps the cache cold (every probe misses).
        self.cache_fill_enabled = True
        # The origin sampler's alive prefix sum, read once here so that
        # drawing origins costs no readback inside the serve loop.
        self._alive_cdf = _alive_cdf(swarm.alive)

    def draw_origins(self, generator: torch.Generator, l: int
                     ) -> torch.Tensor:
        """``l`` uniform alive origins: the draw of
        :func:`opendht_tpu_torch.models.swarm._sample_origins` (same
        generator, same result) with the alive count read once."""
        return _draw_alive(generator, *self._alive_cdf, l)

    def empty(self) -> LookupState:
        return empty_serve_state(self.cfg, self.slots, self.device)

    def _batch(self, keys, slots, origins):
        d = self.device
        return (_upload(keys, torch.int64, d), _upload(slots, torch.int64, d),
                _upload(origins, torch.int32, d))

    def admit(self, st, keys, slots, origins, rnd):
        """Admit ``keys [A,5]`` into ``slots [A]`` (sentinel ``C``) from
        ``origins [A]`` at round ``rnd``."""
        keys, slots, origins = self._batch(keys, slots, origins)
        return _admit(self.swarm, self.cfg, st, keys, slots, origins, rnd)

    def step(self, st, rnd):
        return lookup_step(self.swarm, self.cfg, st, rnd=rnd)

    def admit_probed(self, st, keys, slots, origins, rnd):
        """Cache-consulted admission → ``(state, hit, hit_found,
        hit_hops)`` with the hit rows read back (one transfer: the
        cache-on loop's extra sync)."""
        keys, slots, origins = self._batch(keys, slots, origins)
        st, self.cache, hit, found, hops = _admit_cached(
            self.swarm, self.cfg, st, self.cache, keys, slots, origins, rnd)
        h, f, hp = _fetch(hit, found, hops)
        return st, h, f, hp

    def probe_cache(self, keys):
        """``(hit, found, hops)`` numpy rows for ``keys [A,5]`` (the
        ``degrade`` policy's read)."""
        return _fetch(*_cache_probe(self.cache,
                                    _upload(keys, torch.int64, self.device)))

    def fill_cache(self, keys_np, found_np, hops_np, rnd) -> int:
        """Fill harvested completions, padded to ``admit_cap`` rows.
        Negative results (an empty found head) are never cached; rows
        colliding on a slot are deduped on the host (the last one
        wins); rows past the cap are dropped.  Returns the rows
        filled."""
        if self.cache is None or not self.cache_fill_enabled:
            return 0
        keys_np = np.asarray(keys_np, np.uint32).reshape(-1, N_LIMBS)
        found_np = np.asarray(found_np)
        if len(keys_np):
            ok = found_np[:, 0] >= 0
            keys_np = keys_np[ok]
            found_np = found_np[ok]
            hops_np = np.asarray(hops_np)[ok]
        if len(keys_np):
            sl = _cache_slot_np(keys_np, self.cache_slots)
            _, last = np.unique(sl[::-1], return_index=True)
            pick = np.sort(len(sl) - 1 - last)
            keys_np = keys_np[pick]
            found_np = found_np[pick]
            hops_np = np.asarray(hops_np)[pick]
        a = self.admit_cap
        m = min(len(keys_np), a)
        keys = np.zeros((a, N_LIMBS), np.uint32)
        found = np.full((a, self.cfg.quorum), -1, np.int32)
        hops = np.zeros((a,), np.int32)
        mask = np.zeros((a,), bool)
        keys[:m] = keys_np[:m]
        found[:m] = found_np[:m]
        hops[:m] = hops_np[:m]
        mask[:m] = True
        d = self.device
        self.cache = _cache_fill(
            self.cache, _upload(keys, torch.int64, d),
            _upload(found, torch.int32, d), _upload(hops, torch.int32, d),
            _upload(mask, torch.bool, d), rnd)
        return m

    def invalidate_cache(self) -> None:
        """Bump the cache epoch (a no-op without a cache)."""
        if self.cache is not None:
            self.cache = _cache_invalidate(self.cache)

    def expire(self, st, slots):
        return _expire_slots(st, _upload(slots, torch.int64, self.device))

    def snapshot(self, st):
        """``(done, hops, admitted_round, completed_round, found)`` as
        numpy arrays, read back in one transfer."""
        return _fetch(*_snapshot(self.swarm, self.cfg, st))

    def all_done(self, st) -> bool:
        """Whether no slot is pending (one readback)."""
        return bool(st.done.all())

    def clock(self) -> float:
        """The serve loop's default time source."""
        return time.perf_counter()


class ShardedServeEngine(ServeEngine):
    """The serve engine over a mesh of ranks: each rank holds its rows of
    the ``[slots]`` state (``P(AXIS)``) and its shard of the tables, and
    advances its rows with the routed round
    (:func:`~opendht_tpu_torch.parallel.sharded.sharded_lookup_step`).
    The host loop runs on every rank alike: admissions, expiries and
    cache fills take the whole batch as host arrays (the same on every
    rank); each rank seeds its rows of an admission through the routed
    init, and the seeded rows are gathered and scattered into the
    global slot axis.  :meth:`snapshot` gathers every rank's rows, and
    :meth:`clock` / :meth:`all_done` are collective, so every rank takes
    the loop's decisions together.  The result cache is replicated and
    probed before the routed init: a hit row's origin is blanked, so it
    never rides the ``all_to_all``; :attr:`xchg_init_rows` counts the
    admitted rows that were no hit (JAX's count), and
    :attr:`init_exchange` accumulates what this rank's rows shipped on
    the init ``all_to_all`` (``attempted`` / ``dropped``, device scalars,
    :func:`~opendht_tpu_torch.parallel.sharded._route_respond`).
    ``slots`` and ``admit_cap`` must divide the mesh."""

    def __init__(self, swarm: Swarm, cfg: SwarmConfig, slots: int, mesh,
                 capacity_factor: float = 2.0, admit_cap: int | None = None,
                 cache_slots: int = 0):
        super().__init__(swarm, cfg, slots, admit_cap,
                         cache_slots=cache_slots, device=mesh.device)
        self.mesh, self.capacity_factor = mesh, capacity_factor
        d = mesh.size
        if slots % d or self.admit_cap % d:
            raise ValueError(f"serve slots {slots} and admit_cap "
                             f"{self.admit_cap} must divide the "
                             f"{d}-device mesh")
        self.local_slots = slots // d
        self.lo = mesh.rank * self.local_slots
        self.xchg_init_rows = 0
        self.init_exchange: dict = {}

    def empty(self) -> LookupState:
        return empty_serve_state(self.cfg, self.local_slots, self.device)

    def _local_slots(self, slots: torch.Tensor) -> torch.Tensor:
        """Global slots → this rank's rows (others → the sentinel)."""
        mine = (slots >= self.lo) & (slots < self.lo + self.local_slots)
        return torch.where(mine, slots - self.lo, self.local_slots)

    def _routed_admit(self, st, keys, slots, origins, rnd, skip=None):
        """Seed this rank's rows of the batch through the routed init,
        gather every rank's seeded rows (one ``all_gather``) and scatter
        those whose slot is this rank's."""
        m = self.mesh
        new = gather_seeded(m, sharded_lookup_init(
            self.swarm, self.cfg, shard_rows(m, keys), m,
            shard_rows(m, origins),
            skip=None if skip is None else shard_rows(m, skip),
            exchange=self.init_exchange))
        if skip is not None:
            slots = torch.where(skip, self.slots, slots)
        return _scatter_rows_into(st, new, self._local_slots(slots), rnd)

    def admit(self, st, keys, slots, origins, rnd):
        """Admit the whole micro-batch ``keys [A,5]`` into global
        ``slots [A]`` (sentinel ``C``) from ``origins [A]``: this rank
        seeds rows ``[r·A/D, (r+1)·A/D)``."""
        keys, slots, origins = self._batch(keys, slots, origins)
        return self._routed_admit(st, keys, slots, origins, rnd)

    def admit_probed(self, st, keys, slots, origins, rnd):
        keys, slots, origins = self._batch(keys, slots, origins)
        hit, found, hops = _cache_probe(self.cache, keys)
        st = self._routed_admit(st, keys, slots, origins, rnd, skip=hit)
        h, f, hp = _fetch(hit, found, hops)
        self.xchg_init_rows += int(keys.shape[0] - h.sum())
        return st, h, f, hp

    def step(self, st, rnd):
        return sharded_lookup_step(self.swarm, self.cfg, st, self.mesh,
                                   self.capacity_factor, rnd=rnd)

    def expire(self, st, slots):
        slots = _upload(slots, torch.int64, self.device)
        return _expire_slots(st, self._local_slots(slots))

    def snapshot(self, st):
        """Every rank's rows, gathered (one ``all_gather``) and read back
        in one transfer."""
        return _fetch(*gather_many(self.mesh,
                                   _snapshot(self.swarm, self.cfg, st)))

    def all_done(self, st) -> bool:
        return int(self.mesh.all_reduce(
            (~st.done).sum().to(torch.int64), "sum")) == 0

    def clock(self) -> float:
        """The latest of the ranks' ``perf_counter`` readings
        (:meth:`~opendht_tpu_torch.parallel.mesh.Mesh.host_max`), the
        same on every rank."""
        return self.mesh.host_max(time.perf_counter())


# ---------------------------------------------------------------------------
# schedule and admission policy
# ---------------------------------------------------------------------------

def poisson_zipf_events(rate: float, duration: float, key_pool: int,
                        zipf_s: float, seed: int = 0,
                        hot_frac: float = 0.01,
                        return_draw: bool = False, *,
                        pool: np.ndarray | None = None):
    """Open-loop schedule: Poisson(``rate``) arrival times over ``[0,
    duration)`` and Zipf(``zipf_s``)-popular keys from a ``key_pool``-key
    universe (``zipf_s = 0``: uniform).  Returns ``(arrival_ts [R]
    float64, keys [R,5] uint32 numpy, klass [R] "hot"/"cold")`` — a key
    is hot when its popularity rank is in the top ``hot_frac`` — and,
    with ``return_draw``, the ranks.  The arrivals and ranks come from
    ``numpy.random.default_rng(seed)`` in the JAX function's order; the
    pool ``[key_pool, 5]`` is ``pool`` if given, else drawn from a
    ``torch.Generator`` seeded ``seed ^ 0x5EED``."""
    if rate <= 0 or duration <= 0:
        raise ValueError("rate and duration must be > 0")
    rng = np.random.default_rng(seed)
    n_est = int(rate * duration * 1.5) + 64
    while True:
        gaps = rng.exponential(1.0 / rate, size=n_est)
        ts = np.cumsum(gaps)
        if ts[-1] >= duration:
            break
        n_est *= 2
    ts = ts[ts < duration]
    r = len(ts)
    if pool is None:
        g = torch.Generator().manual_seed(seed ^ 0x5EED)
        pool = torch.randint(0, 2**32, (key_pool, N_LIMBS), generator=g,
                             dtype=torch.int64).numpy().astype(np.uint32)
    pool = np.asarray(pool, np.uint32)
    if zipf_s > 0:
        rnk = np.arange(1, key_pool + 1, dtype=np.float64)
        prob = rnk ** -zipf_s
        prob /= prob.sum()
        draw = rng.choice(key_pool, size=r, p=prob)
    else:
        draw = rng.integers(0, key_pool, size=r)
    hot_cut = max(1, int(key_pool * hot_frac))
    klass = np.where(draw < hot_cut, "hot", "cold")
    if return_draw:
        return ts, pool[draw], klass, draw
    return ts, pool[draw], klass


class AdmissionControl:
    """Per-class token-bucket admission at the slot plane's admission
    step.  One :class:`~opendht_tpu_torch.utils.rate_limiter.TokenBucket`
    per request class accrues ``rate`` tokens/s up to ``burst``;
    ``per_key_rate`` adds a bucket per request key, checked first (at
    most ``max_keys`` live, evicted LRU), and both are peeked before
    either is charged.  A request whose bucket is dry is handled per
    ``policy``: ``shed`` (dropped and counted; queue overflow sheds too
    instead of raising), ``queue`` (waits, head of line; incompatible
    with per-key buckets) or ``degrade`` (answered from the result cache
    only: a hit completes, a miss is shed)."""

    POLICIES = ("shed", "queue", "degrade")

    def __init__(self, rate: float, burst: float | None = None,
                 policy: str = "shed",
                 per_key_rate: float | None = None,
                 per_key_burst: float | None = None,
                 max_keys: int = 4096):
        if policy not in self.POLICIES:
            raise ValueError(f"admission policy must be one of "
                             f"{self.POLICIES}, got {policy!r}")
        if rate <= 0:
            raise ValueError(f"admission rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None \
            else max(1.0, self.rate)
        if self.burst < 1.0:
            raise ValueError(f"admission burst must be >= 1, got "
                             f"{self.burst}")
        self.policy = policy
        if per_key_rate is not None and per_key_rate <= 0:
            raise ValueError(f"per-key admission rate must be > 0, "
                             f"got {per_key_rate}")
        if per_key_rate is not None and policy == "queue":
            raise ValueError(
                "per-key buckets are incompatible with the 'queue' "
                "policy: queue is head-of-line, so a key-dry head "
                "request would block every request behind it — the "
                "exact starvation per-key fairness exists to remove; "
                "use policy 'shed' or 'degrade'")
        self.per_key_rate = (float(per_key_rate)
                             if per_key_rate is not None else None)
        self.per_key_burst = (float(per_key_burst)
                              if per_key_burst is not None
                              else (max(1.0, self.per_key_rate)
                                    if self.per_key_rate else None))
        if self.per_key_burst is not None and self.per_key_burst < 1.0:
            raise ValueError(f"per-key admission burst must be >= 1, "
                             f"got {self.per_key_burst}")
        if max_keys < 1:
            raise ValueError(f"max_keys must be >= 1, got {max_keys}")
        self.max_keys = int(max_keys)
        self.key_evictions = 0
        self._buckets: dict = {}
        self._key_buckets: OrderedDict = OrderedDict()

    def allow(self, klass, now: float, key=None) -> bool:
        """Admit one request of ``klass`` (and ``key``) at the loop's
        ``now``?  A refusal by either bucket charges neither."""
        kb = None
        if self.per_key_rate is not None and key is not None:
            kb = self._key_buckets.get(key)
            if kb is None:
                if len(self._key_buckets) >= self.max_keys:
                    self._key_buckets.popitem(last=False)
                    self.key_evictions += 1
                kb = self._key_buckets[key] = TokenBucket(
                    self.per_key_rate, self.per_key_burst)
            else:
                self._key_buckets.move_to_end(key)
            if not kb.peek(now):
                return False
        b = self._buckets.get(klass)
        if b is None:
            b = self._buckets[klass] = TokenBucket(self.rate, self.burst)
        if not b.peek(now):
            return False
        if kb is not None:
            kb.limit(now)
        return b.limit(now)


# ---------------------------------------------------------------------------
# sizing and warm-up
# ---------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_round_wall(swarm: Swarm, cfg: SwarmConfig, slots: int = 1024,
                       rounds: int = 6) -> float:
    """Seconds a round of a fully occupied ``[slots]`` serve state takes
    (after a warm pass), the slot autotuner's input.  The keys come from
    a ``torch.Generator`` seeded 17, the origins from one seeded 18."""
    dev = swarm.ids.device
    eng = ServeEngine(swarm, cfg, slots=slots, admit_cap=slots, device=dev)
    warm_serve_engine(eng)
    st = eng.empty()
    keys = torch.randint(0, 2**32, (slots, N_LIMBS),
                         generator=torch.Generator().manual_seed(17),
                         dtype=torch.int64)
    origins = eng.draw_origins(torch.Generator(device=dev).manual_seed(18),
                               slots)
    st = eng.admit(st, keys, torch.arange(slots), origins, 0)
    _sync(dev)
    t0 = time.perf_counter()
    for r in range(rounds):
        st = eng.step(st, r)
    _sync(dev)
    return (time.perf_counter() - t0) / rounds


def autotune_serve_slots(cfg: SwarmConfig, arrival_rate: float,
                         round_wall_s: float,
                         target_occupancy: float = 0.5,
                         floor: int = 128,
                         ceil: int = 65536) -> int:
    """Slots from Little's law: ``rate × (burst_schedule + 1) × round
    wall / target_occupancy``, rounded up to a power of two and clamped
    to ``[floor, ceil]``."""
    if arrival_rate <= 0 or round_wall_s <= 0:
        raise ValueError("arrival_rate and round_wall_s must be > 0")
    if not 0.0 < target_occupancy <= 1.0:
        raise ValueError(f"target_occupancy must be in (0, 1], got "
                         f"{target_occupancy}")
    service_s = (burst_schedule(cfg) + 1) * round_wall_s
    demand = arrival_rate * service_s / target_occupancy
    slots = 1 << max(0, math.ceil(math.log2(max(1.0, demand))))
    return int(min(ceil, max(floor, slots)))


def warm_serve_engine(engine: ServeEngine) -> None:
    """Run admit / step / snapshot / expire once off the serve clock
    (and, with a cache, the probed admit, an all-masked fill and a
    probe), so building the card's kernels or the first launches never
    read as queueing delay; the snapshot's readback waits for them.  The
    warm state is dropped and the cache stays cold."""
    c, a_cap = engine.slots, engine.admit_cap
    st = engine.empty()
    warm_keys = np.zeros((a_cap, N_LIMBS), np.uint32)
    warm_slots = np.full((a_cap,), c, np.int64)
    warm_slots[0] = 0
    warm_origins = np.zeros((a_cap,), np.int32)
    st = engine.admit(st, warm_keys, warm_slots, warm_origins, 0)
    st = engine.step(st, 0)
    engine.snapshot(st)
    engine.expire(st, np.full((a_cap,), c, np.int64))
    if engine.cache is not None:
        st2 = engine.empty()
        engine.admit_probed(st2, warm_keys, warm_slots, warm_origins, 0)
        fills_on = engine.cache_fill_enabled
        engine.cache_fill_enabled = True
        engine.fill_cache(np.zeros((0, N_LIMBS), np.uint32),
                          np.zeros((0, engine.cfg.quorum), np.int32),
                          np.zeros((0,), np.int32), 0)
        engine.cache_fill_enabled = fills_on
        engine.probe_cache(warm_keys)


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------

def serve_open_loop(engine: ServeEngine, arrival_ts, keys,
                    generator: torch.Generator | None = None,
                    klass=None, burst: int = 2,
                    duration: float | None = None,
                    overload_queue_factor: int = 8,
                    drain_round_cap: int | None = None,
                    clock=None, sleep=None,
                    admission: AdmissionControl | None = None,
                    sig_stage=None, signed=None,
                    signed_value_of=None, *, origins_of=None) -> dict:
    """Drive the serve engine against an open-loop arrival schedule.

    ``arrival_ts`` / ``keys`` (/ ``klass``) come from
    :func:`poisson_zipf_events` or any sorted schedule.  The clock starts
    after a warm pass; requests arrive strictly by their timestamps.
    Past ``overload_queue_factor × slots`` queued requests (or a hard
    wall of 5 × the horizon + 30 s) the run raises
    :class:`ServeOverloadError`, unless the admission policy sheds.  A
    request that has not converged within ``cfg.max_steps`` rounds of
    its admission is expired (slot recycled, booked as ``expired``).
    After the schedule the loop drains in-flight work, at most
    ``drain_round_cap`` rounds; leftovers are reported ``in_flight``.

    Admission ``i`` draws its ``admit_cap`` origins as
    ``origins_of(i)`` if given, else from ``generator`` (default: seeded
    0).  ``clock`` / ``sleep`` inject the time source (defaults
    ``engine.clock`` — ``time.perf_counter``, or over a mesh the ranks'
    shared reading — and ``time.sleep``); the loop reads the clock at
    exactly the points the JAX loop does, so under a deterministic
    virtual clock the whole report is a pure function of the schedule
    and equals the JAX report.

    With ``engine.cache``, admissions are probed: hits complete at the
    admission wall with zero rounds and zero hops, misses fall through
    unchanged, and harvested completions fill the cache.  ``admission``
    applies :class:`AdmissionControl`.  ``sig_stage`` + ``signed`` (an
    ``[R]`` bool mask) submit each harvest's completed signed requests
    as one batch (``signed_value_of(ri)`` maps a request to the value
    the stage checks; default the index).

    Returns the serve report dict: the JAX package's keys, plus two of
    the port's own.  ``found`` ``[completed, quorum]`` int32 holds each
    completion's found head (cache hits included), beside ``request``,
    for recall checks.  ``layer_walls_s`` holds the host seconds spent
    admitting, stepping, taking snapshots and harvesting (measured
    outside the clock's reads, so not a function of the schedule; on the
    card a layer's dispatches may finish inside a later one's wall).
    Per-request arrays are in completion-observation order.
    """
    clock = clock or engine.clock
    sleep = sleep or time.sleep
    cfg, c = engine.cfg, engine.slots
    a_cap = engine.admit_cap
    use_cache = getattr(engine, "cache", None) is not None
    if admission is not None and admission.policy == "degrade" \
            and not use_cache:
        raise ValueError("admission policy 'degrade' answers from the "
                         "result cache — build the engine with "
                         "cache_slots > 0")
    if origins_of is None:
        gen = generator or torch.Generator(device=engine.device).manual_seed(0)
        origins_of = lambda i: engine.draw_origins(gen, a_cap)  # noqa: E731
    walls = {"admit": 0.0, "step": 0.0, "snapshot": 0.0, "harvest": 0.0}
    pc = time.perf_counter
    keys = np.asarray(keys, np.uint32)
    r_total = len(arrival_ts)
    if klass is None:
        klass = np.full(r_total, "all")
    drain_cap = drain_round_cap or 4 * cfg.max_steps
    if duration is None:
        duration = float(arrival_ts[-1]) if r_total else 0.0
    hard_wall = duration * 5.0 + 30.0

    warm_serve_engine(engine)
    st = engine.empty()

    free = list(range(c - 1, -1, -1))     # pop() → lowest slot first
    occupied: dict[int, int] = {}         # slot -> request index
    queue: list[int] = []
    next_ev = 0
    rnd = 0
    adm_i = 0
    marks_r = [0]
    marks_w = [0.0]
    rec_req, rec_lat, rec_hops, rec_rounds, rec_found = [], [], [], [], []
    rec_answer = []
    admit_wall = {}
    queue_depths = []
    occ_samples = []
    admitted = completed = expired = 0
    shed = cache_hits = cache_misses = degraded_hits = 0
    drain_rounds = 0
    overload = overload_queue_factor * c
    sig_submitted = 0
    sig_pending: list[int] = []

    t0 = clock()
    while True:
        now = clock() - t0
        while next_ev < r_total and arrival_ts[next_ev] <= now:
            queue.append(next_ev)
            next_ev += 1
        if len(queue) > overload:
            if admission is not None \
                    and admission.policy in ("shed", "degrade"):
                over = len(queue) - overload
                del queue[-over:]
                shed += over
            else:
                raise ServeOverloadError(
                    f"serve overload: admission queue reached "
                    f"{len(queue)} requests (> {overload_queue_factor}"
                    f" x {c} slots) at t={now:.2f}s — the arrival "
                    f"rate exceeds what this slot capacity sustains "
                    f"on this machine; lower --arrival-rate, raise "
                    f"--serve-slots, or shed with --admission shed")
        if now > hard_wall:
            if admission is not None \
                    and admission.policy in ("shed", "degrade"):
                shed += len(queue) + (r_total - next_ev)
                queue.clear()
                next_ev = r_total
            else:
                raise ServeOverloadError(
                    f"serve overload: run exceeded the "
                    f"{hard_wall:.0f}s hard wall "
                    f"({r_total - next_ev + len(queue)} requests not "
                    f"yet admitted, {len(occupied)} in flight) — the "
                    f"arrival rate exceeds serve capacity on this "
                    f"machine")
        queue_depths.append(len(queue))

        # --- admission control
        cap = min(len(free), a_cap)
        degr: list[int] = []
        if admission is None:
            m = min(len(queue), cap)
            take = queue[:m]
            del queue[:m]
        else:
            take = []
            qi = 0
            per_key = admission.per_key_rate is not None
            while qi < len(queue) and len(take) < cap \
                    and len(degr) < a_cap:
                ri = queue[qi]
                if admission.allow(str(klass[ri]), now,
                                   key=(keys[ri].tobytes()
                                        if per_key else None)):
                    take.append(ri)
                elif admission.policy == "shed":
                    shed += 1
                elif admission.policy == "degrade":
                    degr.append(ri)
                else:           # queue: head-of-line waits for tokens
                    break
                qi += 1
            del queue[:qi]
            m = len(take)

        # --- admit one micro-batch into recycled slots
        if m:
            t_a = pc()
            slots_np = np.full(a_cap, c, np.int64)
            keys_np = np.zeros((a_cap, N_LIMBS), np.uint32)
            for j, ri in enumerate(take):
                slot = free.pop()
                slots_np[j] = slot
                occupied[slot] = ri
                admit_wall[ri] = now
            keys_np[:m] = keys[np.asarray(take)]
            origins = origins_of(adm_i)
            if use_cache:
                # graftlint: disable=sync-in-loop (the cache-probed admission reads its hit mask back once a burst: hits are answered on the host without taking a slot)
                st, hit, h_found, h_hops = engine.admit_probed(
                    st, keys_np, slots_np, origins, rnd)
                for j, ri in enumerate(take):
                    if not hit[j]:
                        cache_misses += 1
                        continue
                    slot = int(slots_np[j])
                    occupied.pop(slot)
                    free.append(slot)
                    rec_req.append(ri)
                    rec_lat.append(max(0.0,
                                       now - float(arrival_ts[ri])))
                    rec_hops.append(0)
                    rec_rounds.append(0)
                    rec_found.append(int(h_found[j, 0]) >= 0)
                    rec_answer.append(h_found[j])
                    completed += 1
                    cache_hits += 1
                    if sig_stage is not None and signed is not None \
                            and signed[ri]:
                        sig_pending.append(ri)
            else:
                st = engine.admit(st, keys_np, slots_np, origins, rnd)
            adm_i += 1
            admitted += m
            walls["admit"] += pc() - t_a

        # --- degrade policy: one cache probe for over-quota requests
        if degr:
            dk = np.zeros((a_cap, N_LIMBS), np.uint32)
            dk[:len(degr)] = keys[np.asarray(degr)]
            # graftlint: disable=sync-in-loop (the degrade policy's one cache probe a burst for the over-quota requests, answered on the host)
            d_hit, d_found, _d_hops = engine.probe_cache(dk)
            for j, ri in enumerate(degr):
                if d_hit[j]:
                    rec_req.append(ri)
                    rec_lat.append(max(0.0,
                                       now - float(arrival_ts[ri])))
                    rec_hops.append(0)
                    rec_rounds.append(0)
                    rec_found.append(int(d_found[j, 0]) >= 0)
                    rec_answer.append(d_found[j])
                    admitted += 1
                    completed += 1
                    cache_hits += 1
                    degraded_hits += 1
                    if sig_stage is not None and signed is not None \
                            and signed[ri]:
                        sig_pending.append(ri)
                else:
                    shed += 1

        draining = next_ev >= r_total and not queue
        if draining and not occupied:
            break
        if not occupied and not queue:
            if next_ev < r_total:
                gap = arrival_ts[next_ev] - (clock() - t0)
                if gap > 0:
                    sleep(min(gap, 0.05))
                continue
            break

        # --- burst + harvest (the one sync an iteration)
        t_s = pc()
        for _ in range(burst):
            st = engine.step(st, rnd)
            rnd += 1
        t_n = pc()
        done, hops, adm_r, com_r, found = engine.snapshot(st)
        walls["step"] += t_n - t_s
        walls["snapshot"] += pc() - t_n
        w = clock() - t0
        t_h = pc()
        marks_r.append(rnd)
        marks_w.append(w)
        occ_samples.append(len(occupied) / c)

        fill_k, fill_f, fill_h = [], [], []
        for slot in [s for s, _ in occupied.items() if done[s]]:
            ri = occupied.pop(slot)
            free.append(slot)
            cr = int(com_r[slot])
            if cr < 0:
                expired += 1        # forced retirement, not a completion
                continue
            cw = float(np.interp(cr + 1, marks_r[-2:], marks_w[-2:]))
            cw = max(cw, admit_wall[ri])
            rec_req.append(ri)
            rec_lat.append(cw - float(arrival_ts[ri]))
            rec_hops.append(int(hops[slot]))
            rec_rounds.append(cr - int(adm_r[slot]) + 1)
            rec_found.append(int(found[slot, 0]) >= 0)
            rec_answer.append(found[slot])
            completed += 1
            if sig_stage is not None and signed is not None \
                    and signed[ri]:
                sig_pending.append(ri)
            if use_cache:
                fill_k.append(keys[ri])
                fill_f.append(found[slot])
                fill_h.append(int(hops[slot]))
        if use_cache and fill_k:
            engine.fill_cache(np.asarray(fill_k), np.asarray(fill_f),
                              np.asarray(fill_h), rnd)
        if sig_stage is not None and sig_pending:
            sig_stage.submit([signed_value_of(ri) if signed_value_of
                              else ri for ri in sig_pending])
            sig_submitted += len(sig_pending)
            sig_pending = []

        # --- expiry: rows past their round budget retire
        stale = [s for s in occupied
                 if not done[s] and rnd - int(adm_r[s]) >= cfg.max_steps]
        if stale:
            batch = stale[:a_cap]
            sl = np.full(a_cap, c, np.int64)
            sl[:len(batch)] = batch
            st = engine.expire(st, sl)
            for slot in batch:
                ri = occupied.pop(slot)
                free.append(slot)
                expired += 1
        walls["harvest"] += pc() - t_h
        if draining:
            drain_rounds += burst
            if drain_rounds > drain_cap:
                break

    elapsed = clock() - t0
    if sig_stage is not None and sig_pending:
        sig_stage.submit([signed_value_of(ri) if signed_value_of
                          else ri for ri in sig_pending])
        sig_submitted += len(sig_pending)
        sig_pending = []
    return {
        "slots": c,
        "admit_cap": a_cap,
        "burst": burst,
        "admitted": admitted,
        "completed": completed,
        "expired": expired,
        "in_flight": len(occupied),
        "never_admitted": len(queue) + (r_total - next_ev),
        "shed": shed,
        "cache_hits": cache_hits,
        "cache_misses": cache_misses,
        "degraded_hits": degraded_hits,
        "cache_slots": getattr(engine, "cache_slots", 0),
        "admission_policy": admission.policy if admission else None,
        "sig_submitted": sig_submitted,
        "rounds": rnd,
        "elapsed_s": elapsed,
        "sustained_rps": completed / elapsed if elapsed > 0 else 0.0,
        "request": np.asarray(rec_req, np.int64),
        "latency_s": np.asarray(rec_lat, np.float64),
        "hops": np.asarray(rec_hops, np.int64),
        "service_rounds": np.asarray(rec_rounds, np.int64),
        "found_nonempty": np.asarray(rec_found, bool),
        "klass": np.asarray(klass)[np.asarray(rec_req, np.int64)]
        if completed else np.asarray([], dtype="<U4"),
        "queue_depth_mean": float(np.mean(queue_depths))
        if queue_depths else 0.0,
        "queue_depth_max": int(np.max(queue_depths))
        if queue_depths else 0,
        "slot_occupancy_frac": float(np.mean(occ_samples))
        if occ_samples else 0.0,
        "burst_marks": list(zip(marks_r, marks_w)),
        "found": np.asarray(rec_answer, np.int32).reshape(-1, cfg.quorum),
        "layer_walls_s": walls,
    }


def closed_loop_replay(swarm: Swarm, cfg: SwarmConfig,
                       targets: torch.Tensor,
                       generator: torch.Generator | None = None,
                       engine: ServeEngine | None = None, *,
                       origins: torch.Tensor | None = None,
                       device=None) -> tuple[LookupResult, LookupState]:
    """Feed a fixed batch through the serve engine's admit/step path
    (slots = L, all admitted at round 0) and run it to completion: the
    serve twin of ``lookup(swarm, cfg, targets, generator)``, with the
    same found/hops/done for the same origins — ``origins [L]`` if
    given, else drawn with ``generator`` (default seeded 0) as
    ``lookup`` draws them.  Returns ``(LookupResult, final state)``.
    Through a :class:`ShardedServeEngine` the batch and origins are the
    whole batch on every rank, and the result and state are this rank's
    rows (``P(AXIS)``)."""
    l = targets.shape[0]
    eng = engine if engine is not None \
        else ServeEngine(swarm, cfg, slots=l, admit_cap=l, device=device)
    if eng.slots != l or eng.admit_cap < l:
        raise ValueError(f"closed-loop replay needs slots == L == "
                         f"admit_cap; engine has slots={eng.slots}, "
                         f"admit_cap={eng.admit_cap} for L={l}")
    if origins is None:
        if generator is None:
            generator = torch.Generator(device=eng.device).manual_seed(0)
        origins = eng.draw_origins(generator, l)
    st = eng.empty()
    st = eng.admit(st, targets, torch.arange(l), origins, 0)
    rnd = 0
    burst = burst_schedule(cfg)
    while rnd < cfg.max_steps:
        n = min(burst, cfg.max_steps - rnd)
        for _ in range(n):
            st = eng.step(st, rnd)
            rnd += 1
        # graftlint: disable=sync-in-loop (per-burst done-check readback, amortized over >=2 device rounds: the burst replay's contract; resident_closed_loop_replay runs the same workload with zero in-loop polls)
        if eng.all_done(st):            # the one readback a burst
            break
        burst = 2
    res = LookupResult(found=_finalize(swarm.ids, st, cfg),
                       hops=st.hops, done=st.done)
    return res, st


# ---------------------------------------------------------------------------
# the resident serve engine: one macro step, one CUDA graph
# ---------------------------------------------------------------------------
#
# The burst engine above pays one host round trip a burst and, on the
# card, every one of its eager launches.  The resident engine runs a
# whole iteration — enqueue into a device admission ring → pop, probe
# and admit into the lowest free slots → a budget of lock-step rounds →
# expiry, finalize, cache fill and slot freeing — as one program, and
# the host drains its bulk output (:class:`ResidentOut`) one macro step
# later.  On the card that program is a CUDA graph captured once per
# (cache on/off, round budget, expiry) from the *gated* round loop: it
# runs exactly ``rounds`` trips and keeps the old state wherever
# ``any(~done)`` has gone false, which equals JAX's ``lax.while_loop``
# bit for bit because the condition never turns true again.  On the CPU
# the same body runs with a host-side early exit.
#
# Ring contract (as in the JAX package): ``rq_*[R]`` is a circular
# queue with monotonic int32 ``head`` / ``tail`` counters (positions mod
# R); rows past the free space are shed and counted; admission pops
# ``min(backlog, free slots, admit_cap)`` rows into the lowest free
# slots (a stable argsort of the free mask: on an all-free state slot j
# serves popped row j, which the closed-loop replay identity needs); a
# completed slot is reported once and freed by the program that reports
# it.

class ServeRings(NamedTuple):
    """The device admission ring and slot attribution.  ``rq_keys
    [R,5]`` / ``rq_req [R]`` / ``rq_cls [R]``: the circular request queue
    (key limbs, host request index, work class; ``rq_req = -1`` means
    never written); ``head`` / ``tail`` / ``shed``: monotonic pop /
    accept / overflow counters; ``slot_req [C]`` / ``slot_cls [C]``: the
    request owning each lookup slot (-1 free)."""
    rq_keys: torch.Tensor     # [R,5] int64 u32 key limbs
    rq_req: torch.Tensor      # [R] int32
    rq_cls: torch.Tensor      # [R] int32
    head: torch.Tensor        # [] int32
    tail: torch.Tensor        # [] int32
    shed: torch.Tensor        # [] int32
    slot_req: torch.Tensor    # [C] int32
    slot_cls: torch.Tensor    # [C] int32


class ResidentOut(NamedTuple):
    """The bulk output of one macro step, the one read the host makes.

    Scalars (int32): ``adm`` / ``hits`` rows admitted / answered from the
    cache, ``queued`` the ring backlog after admission, ``head`` /
    ``tail`` / ``shed`` the ring counters, ``rounds_run`` the round trips
    that ran.  ``hit*`` rows are ``[A]`` (cache hits answered at pop
    time, never holding a slot); ``comp*`` rows are ``[C]``: the slots
    that finished (or expired: ``comp_com = -1``) this step.
    ``rung_counts`` counts the rounds by merge-width rung (``[1]`` with
    the ladder off); ``xchg_*_rows`` count routed-exchange rows (0 on
    one device)."""
    adm: torch.Tensor
    hits: torch.Tensor
    queued: torch.Tensor
    head: torch.Tensor
    tail: torch.Tensor
    shed: torch.Tensor
    rounds_run: torch.Tensor
    hit: torch.Tensor          # [A] bool
    hit_req: torch.Tensor      # [A] int32
    hit_found: torch.Tensor    # [A,q] int32
    hit_hops: torch.Tensor     # [A] int32
    comp: torch.Tensor         # [C] bool
    comp_req: torch.Tensor     # [C] int32
    comp_cls: torch.Tensor
    comp_hops: torch.Tensor
    comp_adm: torch.Tensor
    comp_com: torch.Tensor
    comp_found: torch.Tensor   # [C,q] int32
    rung_counts: torch.Tensor  # [n_rungs] int32
    xchg_init_rows: torch.Tensor
    xchg_round_rows: torch.Tensor


def empty_serve_rings(slots: int, ring_slots: int,
                      device=None) -> ServeRings:
    """All-empty rings: zero backlog, every slot unattributed."""
    dev = resolve_device(device)

    def full(shape, v, dtype=torch.int32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return ServeRings(
        rq_keys=full((ring_slots, N_LIMBS), 0, torch.int64),
        rq_req=full((ring_slots,), -1), rq_cls=full((ring_slots,), -1),
        head=full((), 0), tail=full((), 0), shed=full((), 0),
        slot_req=full((slots,), -1), slot_cls=full((slots,), -1))


def _ring_enqueue(rings: ServeRings, keys: torch.Tensor, reqs: torch.Tensor,
                  cls: torch.Tensor, n_new) -> ServeRings:
    """Accept ``n_new`` (clipped to ``[0, A]``) of the ``[A]`` rows into
    the ring; rows past its free space are shed (counted, dropped),
    never written over queued work."""
    a = keys.shape[0]
    r = rings.rq_keys.shape[0]
    dev = keys.device
    # graftlint: disable=host-call-in-jit (under a capture n_new is the packed input's 0-d int32 tensor on the card (ResidentServeEngine._graph), so as_tensor copies nothing; a Python int comes only from the eager path)
    n_new = torch.as_tensor(n_new, dtype=torch.int32, device=dev).clamp(0, a)
    space = r - (rings.tail - rings.head)
    n_in = torch.minimum(n_new, space)
    j = torch.arange(a, dtype=torch.int32, device=dev)
    qpos = torch.where(j < n_in, (rings.tail + j) % r, r)
    return rings._replace(
        rq_keys=_set_rows(rings.rq_keys, qpos, keys),
        rq_req=_set_rows(rings.rq_req, qpos, reqs),
        rq_cls=_set_rows(rings.rq_cls, qpos, cls),
        tail=rings.tail + n_in, shed=rings.shed + (n_new - n_in))


def _ring_pop(st: LookupState, rings: ServeRings, a: int):
    """Pop up to ``a`` queued rows and pair them with the lowest free
    slots (free = ``done & admitted_round < 0``).  Returns ``(rings,
    pkeys [a,5], preq [a], pcls [a], cand [a], valid [a])`` with the
    head advanced; rows ``j >= p`` are padding (``valid`` false, ``preq``
    -1)."""
    c = st.done.shape[0]
    r = rings.rq_keys.shape[0]
    dev = st.done.device
    free = st.done & (st.admitted_round < 0)
    n_free = free.sum().to(torch.int32)
    p = torch.minimum(rings.tail - rings.head, n_free).clamp(max=a)
    j = torch.arange(a, dtype=torch.int32, device=dev)
    valid = j < p
    rpos = ((rings.head + j) % r).long()
    preq = torch.where(valid, rings.rq_req[rpos], -1)
    pcls = torch.where(valid, rings.rq_cls[rpos], -1)
    order = torch.argsort((~free).to(torch.int32), stable=True)
    cand = order[j.clamp(0, c - 1).long()].to(torch.int32)
    return (rings._replace(head=rings.head + p), rings.rq_keys[rpos], preq,
            pcls, cand, valid)


def _cache_fill_sorted(cache: ResultCache, keys: torch.Tensor,
                       found: torch.Tensor, hops: torch.Tensor,
                       mask: torch.Tensor, rnd) -> ResultCache:
    """The cache fill with the slot dedup on the device (the twin of
    :meth:`ServeEngine.fill_cache`'s host dedup): one stable sort groups
    the rows by cache slot and the last row of each group wins, so each
    field's scatter writes every slot at most once.  Masked rows go to
    the spare row."""
    k_slots = cache.keys.shape[0]
    m = keys.shape[0]
    cs = torch.where(mask, _cache_slot_of(keys, k_slots), k_slots)
    cs_s, row_s = torch.sort(cs, stable=True)
    last = torch.cat([cs_s[1:] != cs_s[:-1],
                      torch.ones((1,), dtype=torch.bool, device=cs.device)])
    eff = torch.where(last & (cs_s < k_slots), cs_s, k_slots)
    # graftlint: disable=host-call-in-jit (under a capture rnd is the packed input's 0-d int32 tensor on the card (ResidentServeEngine._graph), so as_tensor copies nothing; a Python int comes only from the eager path)
    r32 = torch.as_tensor(rnd, dtype=torch.int32, device=cs.device).expand(m)
    return cache._replace(
        keys=_set_rows(cache.keys, eff, keys[row_s]),
        found=_set_rows(cache.found, eff, found[row_s]),
        hops=_set_rows(cache.hops, eff, hops[row_s]),
        fill_round=_set_rows(cache.fill_round, eff, r32),
        fill_epoch=_set_rows(cache.fill_epoch, eff, cache.epoch.expand(m)))


def _rung_ladder(cfg: SwarmConfig, rung_block: int | None):
    """The merge-width rungs of ``rung_block`` (``None``: no ladder).
    ``merge_impl="fused-round"`` merges at its own fixed width, so it
    takes no ladder."""
    if rung_block is None:
        return None
    if cfg.merge_impl == "fused-round":
        raise ValueError(
            "rung_block width selection needs the rank merge's width "
            "ladder; merge_impl='fused-round' fuses its own fixed-width "
            "merge — drop one of the two")
    return merge_ladder_widths(cfg.alpha * 2 * cfg.bucket_k, rung_block)


def _rung_of(st: LookupState, cfg: SwarmConfig, rungs) -> torch.Tensor:
    """The rung a round at ``st`` selects: the first rung covering the
    widest pending row's solicitation width (``_pending_and_wneed``'s
    watermark), computed on the device — a count of the rungs below it,
    which is ``searchsorted(rungs, wneed)``."""
    unq = ((st.idx >= 0) & ~st.queried).sum(dim=1)
    blocks = torch.where(st.done, 0, unq.clamp(max=cfg.alpha))
    wneed = blocks.max() * (2 * cfg.bucket_k)
    bi = sum((wneed > t).to(torch.int32) for t in rungs)
    return bi.clamp(max=len(rungs) - 1)


def _resident_rounds(swarm: Swarm, cfg: SwarmConfig, st: LookupState, rnd0,
                     rounds: int, rung_block: int | None, gated: bool):
    """Up to ``rounds`` lock-step rounds (round ``rnd0 + it``), stopping
    once every row is done.  The early-exit form (``gated=False``) reads
    ``any(~done)`` on the host before each trip; the gated form runs all
    ``rounds`` trips with no host read and keeps the old state where the
    trip is inactive — the form a CUDA graph captures.  Both equal JAX's
    ``lax.while_loop``.  With ``rung_block`` each active round counts
    the merge-width rung it selects; the merge itself always runs at
    full width (every rung is bit-identical to it).  Returns ``(state,
    rounds_run [] int32, rung_counts [n_rungs] int32)``."""
    rungs = _rung_ladder(cfg, rung_block)
    dev = st.done.device
    lanes = torch.arange(len(rungs) if rungs else 1, device=dev)
    counts = torch.zeros(lanes.shape, dtype=torch.int32, device=dev)

    def rung(s):
        return _rung_of(s, cfg, rungs) if rungs else 0

    if not gated:
        it = 0
        # graftlint: disable=sync-in-loop,tracer-coercion,host-callback (the early-exit form (gated=False) runs eagerly only, one poll a round as JAX's while_loop cond; a capture takes the gated form, which reads nothing back)
        while it < rounds and bool((~st.done).any()):
            counts = counts + (lanes == rung(st)).to(torch.int32)
            st = lookup_step(swarm, cfg, st, rnd=rnd0 + it)
            it += 1
        # graftlint: disable=host-call-in-jit (the eager early-exit form only; the gated form a capture records makes no tensor from host data)
        return st, torch.tensor(it, dtype=torch.int32, device=dev), counts
    run = torch.zeros((), dtype=torch.int32, device=dev)
    for it in range(rounds):
        active = (~st.done).any()
        counts = counts + ((lanes == rung(st)) & active).to(torch.int32)
        new = lookup_step(swarm, cfg, st, rnd=rnd0 + it)
        st = LookupState(*[o if n is o else torch.where(active, n, o)
                           for n, o in zip(new, st)])
        run = run + active.to(torch.int32)
    return st, run, counts


def _resident_tail(ids: torch.Tensor, cfg: SwarmConfig, st: LookupState,
                   cache: ResultCache | None, rnd_end, expire: bool):
    """The harvest: expiry (pending rows ``max_steps`` rounds past their
    admission become done with no completion stamp), completion
    detection, finalize and the cache fill (true completions with a
    non-empty head only).  Returns ``(st, cache, comp, fin)``."""
    if expire:
        stale = (~st.done & (st.admitted_round >= 0)
                 & (rnd_end - st.admitted_round >= cfg.max_steps))
        st = st._replace(done=st.done | stale)
    comp = st.done & (st.admitted_round >= 0)
    fin = _finalize(ids, st, cfg)
    if cache is not None:
        fmask = comp & (st.completed_round >= 0) & (fin[:, 0] >= 0)
        cache = _cache_fill_sorted(cache, st.targets, fin, st.hops, fmask,
                                   rnd_end)
    return st, cache, comp, fin


def _resident_core(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                   rings: ServeRings, cache: ResultCache | None,
                   keys: torch.Tensor, reqs: torch.Tensor, cls: torch.Tensor,
                   origins: torch.Tensor, n_new, rnd0, rounds: int,
                   expire: bool, rung_block: int | None, gated: bool):
    """One macro step: enqueue → pop / probe / admit → rounds → harvest /
    fill / free.  ``keys [A,5]`` / ``reqs [A]`` / ``cls [A]`` are the
    padded enqueue batch (``n_new`` real rows), ``origins [A]`` the
    admission origins (the batch engine's full-width draw, so the replay
    equals ``lookup``), ``rnd0`` the first round's index (an int, or a
    0-dim int32 tensor in a graph).  Returns ``(st, rings, cache,
    ResidentOut)``."""
    c = st.done.shape[0]
    a = keys.shape[0]
    dev = st.done.device
    rings = _ring_enqueue(rings, keys, reqs, cls, n_new)
    rings, pkeys, preq, pcls, cand, valid = _ring_pop(st, rings, a)
    if cache is not None:
        hit_raw, h_found, h_hops = _probe_impl(cache, pkeys)
        hit = hit_raw & valid
    else:
        hit = torch.zeros((a,), dtype=torch.bool, device=dev)
        h_found = torch.full((a, cfg.quorum), -1, dtype=torch.int32,
                             device=dev)
        h_hops = torch.zeros((a,), dtype=torch.int32, device=dev)
    take = valid & ~hit
    eff = torch.where(take, cand, c)
    st = _scatter_rows_into(st, lookup_init(swarm, cfg, pkeys, origins), eff,
                            rnd0)
    rings = rings._replace(slot_req=_set_rows(rings.slot_req, eff, preq),
                           slot_cls=_set_rows(rings.slot_cls, eff, pcls))
    st, rounds_run, rung_counts = _resident_rounds(
        swarm, cfg, st, rnd0, rounds, rung_block, gated)
    st, cache, comp, fin = _resident_tail(swarm.ids, cfg, st, cache,
                                          rnd0 + rounds, expire)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    out = ResidentOut(
        adm=take.sum().to(torch.int32), hits=hit.sum().to(torch.int32),
        queued=rings.tail - rings.head, head=rings.head, tail=rings.tail,
        shed=rings.shed, rounds_run=rounds_run, hit=hit,
        hit_req=torch.where(hit, preq, -1), hit_found=h_found,
        hit_hops=h_hops, comp=comp,
        comp_req=torch.where(comp, rings.slot_req, -1),
        comp_cls=torch.where(comp, rings.slot_cls, -1),
        comp_hops=st.hops, comp_adm=st.admitted_round,
        comp_com=st.completed_round, comp_found=fin,
        rung_counts=rung_counts, xchg_init_rows=zero, xchg_round_rows=zero)
    # Free the reported slots: done stays true, the lifecycle clears.
    st = st._replace(admitted_round=torch.where(comp, -1, st.admitted_round))
    rings = rings._replace(
        slot_req=torch.where(comp, -1, rings.slot_req),
        slot_cls=torch.where(comp, -1, rings.slot_cls))
    return st, rings, cache, out


def _resident_step(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                   rings: ServeRings, keys, reqs, cls, origins, n_new, rnd0,
                   *, rounds: int, expire: bool = True,
                   rung_block: int | None = None, gated: bool = False):
    """The cache-off macro step run eagerly → ``(st, rings, out)``."""
    st, rings, _cache, out = _resident_core(
        swarm, cfg, st, rings, None, keys, reqs, cls, origins, n_new, rnd0,
        rounds, expire, rung_block, gated)
    return st, rings, out


def _resident_step_cached(swarm: Swarm, cfg: SwarmConfig, st: LookupState,
                          rings: ServeRings, cache: ResultCache, keys, reqs,
                          cls, origins, n_new, rnd0, *, rounds: int,
                          expire: bool = True, rung_block: int | None = None,
                          gated: bool = False):
    """The macro step with the result cache inside it, run eagerly →
    ``(st, rings, cache, out)``: a pop-time probe (a hit never holds a
    slot) and a harvest-time fill deduplicated on the device."""
    return _resident_core(swarm, cfg, st, rings, cache, keys, reqs, cls,
                          origins, n_new, rnd0, rounds, expire, rung_block,
                          gated)


# CUDA graphs captured by the resident engines in this process (what the
# cost ledger's compile count reads: a capture inside a clocked pass is
# the counterpart of a compile), and captures by (engine, graph key) —
# graftlint's budget plane holds each key to one capture an engine.
GRAPH_CAPTURES = 0
GRAPH_KEYS: Counter = Counter()
_ENGINE_SERIALS = itertools.count()


def _resident_replay(graph: "torch.cuda.CUDAGraph") -> None:
    """One replay of a captured macro step — on the card the resident
    engines' counterpart of one compiled macro-step call, and the cost
    ledger's ``serve._resident_replay`` row."""
    graph.replay()


def _out_layout(a: int, c: int, q: int, n_rungs: int):
    """``(name, shape)`` of each :class:`ResidentOut` field, in order."""
    shapes = {"hit": (a,), "hit_req": (a,), "hit_found": (a, q),
              "hit_hops": (a,), "comp_found": (c, q), "rung_counts": (n_rungs,)}
    for f in ("comp", "comp_req", "comp_cls", "comp_hops", "comp_adm",
              "comp_com"):
        shapes[f] = (c,)
    return [(f, shapes.get(f, ())) for f in ResidentOut._fields]


_BOOL_FIELDS = ("hit", "comp")


def _unpack_out(flat: np.ndarray, layout) -> ResidentOut:
    """A packed int32 output row → :class:`ResidentOut` of numpy arrays
    (copies: the pinned buffer is written again two steps later)."""
    fields, at = [], 0
    for name, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        x = flat[at:at + n].reshape(shape)
        fields.append(x.astype(np.bool_) if name in _BOOL_FIELDS
                      else x.copy())
        at += n
    return ResidentOut(*fields)


class PendingOut(NamedTuple):
    """A macro step's output on its way to the host: which of the two
    pinned buffers it lands in and the step's sequence number.  Read it
    with :meth:`ResidentServeEngine.read_out` before two more steps
    reuse the buffer."""
    buffer: int
    seq: int


class ResidentServeEngine(ServeEngine):
    """Serve engine whose whole iteration is one device program: the
    host fills the admission ring and drains the bulk output one macro
    step late.

    ``ring_slots`` (default ``4 × admit_cap``, at least ``2 ×
    admit_cap``: :func:`serve_resident`'s hand-off throttle keeps one
    in-flight batch of headroom) sizes the ring; ``rounds_per_iter`` is
    a macro step's round budget; ``rung_block`` counts each round's
    merge-width rung (not with ``merge_impl="fused-round"``).

    On the card, :meth:`macro_step` replays a ``torch.cuda.CUDAGraph``
    captured once per (cache on/off, rounds, expiry) from the gated
    round loop.  The state, rings and cache are the graphs' static
    tensors, updated in place; a state or rings handed in that are not
    those tensors are copied into them first, and the state and rings
    returned are those tensors.  The inputs reach the graph's input
    buffer through two alternating pinned host buffers, and each replay
    ends with one asynchronous copy of the output into one of two
    pinned host buffers (:class:`PendingOut`).  A capture or replay that
    fails raises: there is no eager fallback.  On the CPU
    :meth:`macro_step` runs the early-exit form and returns the
    :class:`ResidentOut` tensors."""

    def __init__(self, swarm: Swarm, cfg: SwarmConfig, slots: int,
                 admit_cap: int | None = None, cache_slots: int = 0,
                 ring_slots: int | None = None, rounds_per_iter: int = 2,
                 rung_block: int | None = None, device=None):
        super().__init__(swarm, cfg, slots, admit_cap,
                         cache_slots=cache_slots, device=device)
        self.ring_slots = ring_slots or 4 * self.admit_cap
        if self.ring_slots < 2 * self.admit_cap:
            raise ValueError(
                f"ring_slots {self.ring_slots} must be >= 2 x admit_cap "
                f"{self.admit_cap}: the host throttle reserves one "
                f"in-flight enqueue batch of headroom")
        if rounds_per_iter < 1:
            raise ValueError("rounds_per_iter must be >= 1")
        self.rounds_per_iter = rounds_per_iter
        rungs = _rung_ladder(cfg, rung_block)
        self.rung_block = rung_block
        self.n_rungs = len(rungs) if rungs else 1
        self.readbacks = 0      # host waits for a macro step's output
        self.replays = 0        # graph replays (card)
        self.graphs: dict = {}  # (use_cache, rounds, expire) -> graph
        self._io = None
        self.graph = self.device.type == "cuda"   # the runner: graph or eager

    def empty_rings(self) -> ServeRings:
        return empty_serve_rings(self.slots, self.ring_slots, self.device)

    def macro_step(self, st, rings, keys, reqs, cls, origins, n_new, rnd0,
                   rounds: int | None = None, expire: bool = True,
                   use_cache: bool | None = None):
        """One macro step.  ``keys [A,5]`` / ``reqs [A]`` / ``cls [A]`` /
        ``origins [A]`` (numpy arrays or tensors) are the padded
        enqueue batch with ``n_new`` real rows, ``rnd0`` the first round.
        Returns ``(st, rings, out)`` with nothing read back: ``out`` is
        a :class:`ResidentOut` of tensors on the CPU and a
        :class:`PendingOut` on the card (:meth:`read_out` reads
        either)."""
        rounds = self.rounds_per_iter if rounds is None else rounds
        if use_cache is None:
            use_cache = self.cache is not None
        if use_cache and self.cache is None:
            raise ValueError("use_cache=True needs cache_slots>0")
        if self.graph:
            return self._replay(st, rings, keys, reqs, cls, origins, n_new,
                                rnd0, rounds, expire, use_cache)
        d = self.device
        st, rings, cache, out = self._body(
            st, rings, self.cache if use_cache else None,
            _upload(keys, torch.int64, d), _upload(reqs, torch.int32, d),
            _upload(cls, torch.int32, d), _upload(origins, torch.int32, d),
            int(n_new), int(rnd0), rounds, expire, gated=False)
        if use_cache:
            self.cache = cache
        return st, rings, out

    def _body(self, st, rings, cache, keys, reqs, cls, origins, n_new, rnd0,
              rounds: int, expire: bool, gated: bool):
        """The macro step's program → ``(st, rings, cache, out)``."""
        return _resident_core(self.swarm, self.cfg, st, rings, cache, keys,
                              reqs, cls, origins, n_new, rnd0, rounds, expire,
                              self.rung_block, gated)

    def read_out(self, out) -> ResidentOut:
        """A macro step's output as numpy arrays.  On the card this waits
        for the step's copy to land — the loop's one read a macro step."""
        self.readbacks += 1
        if isinstance(out, ResidentOut):
            return ResidentOut(*[x.cpu().numpy() for x in out])
        io = self._io
        if io["out_seq"][out.buffer] != out.seq:
            raise RuntimeError(
                "a macro step's output was read after two later steps "
                "reused its buffer")
        io["out_ev"][out.buffer].synchronize()
        return _unpack_out(io["host_out"][out.buffer].numpy(), io["layout"])

    def warm_resident(self, rounds: int | None = None) -> None:
        """Off the clock: on the card, capture the macro-step graph that
        :func:`serve_resident` replays (after one eager pass, which
        builds the kernels); on the CPU, run one macro step on throwaway
        carries (nothing queued)."""
        rounds = self.rounds_per_iter if rounds is None else rounds
        if self.graph:
            self._graph(self.cache is not None, rounds, True)
            return
        a = self.admit_cap
        self.macro_step(self.empty(), self.empty_rings(),
                        np.zeros((a, N_LIMBS), np.uint32),
                        np.full((a,), -1, np.int32),
                        np.full((a,), -1, np.int32), np.zeros((a,), np.int32),
                        0, 0, rounds=rounds)

    # -- the card: graph capture and replay -------------------------------

    def _setup_io(self) -> None:
        """The graphs' static carries, the input buffer and the pinned
        host buffers (two for inputs, two for outputs)."""
        a, dev = self.admit_cap, self.device
        layout = _out_layout(a, self.slots, self.cfg.quorum, self.n_rungs)
        n_out = sum(int(np.prod(s, dtype=np.int64)) for _, s in layout)
        n_in = 8 * a + 2          # keys 5A, reqs, cls, origins, n_new, rnd0
        packed_in = torch.zeros((n_in,), dtype=torch.int64, device=dev)
        packed_in[5 * a:7 * a] = -1
        self._io = {
            "st": self.empty(), "rings": self.empty_rings(),
            "cache": self.cache,
            "packed_in": packed_in, "layout": layout,
            "host_in": [torch.empty((n_in,), dtype=torch.int64,
                                    pin_memory=True) for _ in range(2)],
            "host_out": [torch.empty((n_out,), dtype=torch.int32,
                                     pin_memory=True) for _ in range(2)],
            "in_ev": [torch.cuda.Event() for _ in range(2)],
            "out_ev": [torch.cuda.Event() for _ in range(2)],
            "out_seq": [0, 0], "turn_in": 0, "turn_out": 0, "seq": 0}

    def _graph(self, use_cache: bool, rounds: int, expire: bool):
        """The macro-step graph for this key, captured at first use."""
        key = (use_cache, rounds, expire)
        if key in self.graphs:
            return self.graphs[key]
        if self._io is None:
            self._setup_io()
        io, a = self._io, self.admit_cap
        kernels.build_kernels()

        def body():
            p = io["packed_in"]
            return self._body(
                io["st"], io["rings"], io["cache"] if use_cache else None,
                p[:5 * a].view(a, N_LIMBS), p[5 * a:6 * a].to(torch.int32),
                p[6 * a:7 * a].to(torch.int32), p[7 * a:8 * a].to(torch.int32),
                p[8 * a].to(torch.int32), p[8 * a + 1].to(torch.int32), rounds,
                expire, gated=True)

        # One eager pass on a side stream (the body is pure: the static
        # carries are untouched) loads the kernel libraries and their
        # runtime before the capture.
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)
        before = dict(kernels.CAPTURED)
        mesh = getattr(self, "mesh", None)
        if mesh is not None:
            calls0, bytes0 = (dict(mesh.captured),
                              dict(mesh.captured_bytes))
        global GRAPH_CAPTURES
        GRAPH_CAPTURES += 1
        serial = self.__dict__.setdefault("_serial", next(_ENGINE_SERIALS))
        GRAPH_KEYS[(serial, key)] += 1
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):       # the default (global) capture mode
            st, rings, cache, out = body()
            pairs = [(io["st"], st), (io["rings"], rings)]
            if use_cache:
                pairs.append((io["cache"], cache))
            for static, new in pairs:
                for s, n in zip(static, new):
                    s.copy_(n)
            packed = torch.cat([x.reshape(-1).to(torch.int32) for x in out])
        self.graphs[key] = g = {
            "graph": graph, "out": packed,
            "launches": {k: kernels.CAPTURED[k] - before[k] for k in before}}
        if mesh is not None:
            g["collectives"] = {k: v - calls0.get(k, 0)
                                for k, v in mesh.captured.items()}
            g["collective_bytes"] = {k: v - bytes0.get(k, 0)
                                     for k, v in mesh.captured_bytes.items()}
        return g

    def _replay(self, st, rings, keys, reqs, cls, origins, n_new, rnd0,
                rounds, expire, use_cache):
        g = self._graph(use_cache, rounds, expire)
        io, a = self._io, self.admit_cap
        pairs = [(io["st"], st), (io["rings"], rings)]
        if use_cache:           # e.g. an invalidation replaced the epoch
            pairs.append((io["cache"], self.cache))
            self.cache = io["cache"]
        for static, given in pairs:
            for s, x in zip(static, given):
                if s is not x:
                    s.copy_(x)
        # Inputs: host arrays through a pinned buffer (the one whose last
        # copy has finished), tensors on the card copied on the device.
        b = io["turn_in"]
        io["turn_in"] ^= 1
        io["in_ev"][b].synchronize()
        host = io["host_in"][b].numpy()
        on_card = []
        for lo, hi, x in ((0, 5 * a, keys), (5 * a, 6 * a, reqs),
                          (6 * a, 7 * a, cls), (7 * a, 8 * a, origins)):
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                on_card.append((lo, hi, x))
            else:
                host[lo:hi] = np.asarray(
                    # graftlint: disable=sync-in-loop (x lies on the CPU on this branch (card tensors take the on_card list): .cpu() copies and waits for nothing)
                    x.cpu() if isinstance(x, torch.Tensor) else x).reshape(-1)
        host[8 * a] = int(n_new)
        host[8 * a + 1] = int(rnd0)
        p = io["packed_in"]
        p.copy_(io["host_in"][b], non_blocking=True)
        io["in_ev"][b].record()
        for lo, hi, x in on_card:
            p[lo:hi].copy_(x.reshape(-1))
        _resident_replay(g["graph"])
        kernels.count_replay(g["launches"])
        if "collectives" in g:
            self.mesh.count_replay(g["collectives"], g["collective_bytes"])
        self.replays += 1
        b = io["turn_out"]
        io["turn_out"] ^= 1
        io["seq"] += 1
        io["host_out"][b].copy_(g["out"], non_blocking=True)
        io["out_ev"][b].record()
        io["out_seq"][b] = io["seq"]
        return io["st"], io["rings"], PendingOut(b, io["seq"])


class ShardedResidentServeEngine(ResidentServeEngine):
    """The resident engine over a mesh of ranks: the macro step is
    :func:`~opendht_tpu_torch.parallel.sharded._sharded_resident_step` —
    the state, rings and cache whole on every rank, the routed init
    seeding each rank's rows of the popped batch (the cache probed
    first, so a hit never rides the ``all_to_all``: ``xchg_init_rows``
    counts the admitted rows), the routed round loop on each rank's
    slots.  ``swarm`` is the rank's shard; ``slots`` and ``admit_cap``
    must divide the mesh; no ``rung_block`` (the routed round prices its
    own exchange).  The macro step's ``origins [A]`` are the whole
    batch's, the same on every rank.

    The runner follows the mesh's backend and is recorded in
    :attr:`graph`: over NCCL on the card the whole macro step,
    collectives included, is one captured CUDA graph (the gated round
    loop, its pending count an ``all_reduce`` on the device); over gloo
    (host collectives, which no graph captures) or on the CPU it runs
    eagerly in the early-exit form, one host ``all_reduce`` of the
    pending count a trip.  ``graph=True`` on a mesh that cannot capture
    raises; there is no fallback.  :meth:`clock` is the ranks' latest
    reading (:meth:`~opendht_tpu_torch.parallel.mesh.Mesh.host_max`), so
    every rank takes the serve loop's decisions together.
    :attr:`init_shipped` (a device scalar)
    accumulates the solicitations this rank shipped on the init
    ``all_to_all`` over the macro steps run (a graph replay adds its
    own; the eager pass before a capture adds nothing), counted in the
    exchange itself: with the cache on, the mesh's sum is the admitted
    rows, never a hit."""

    def __init__(self, swarm: Swarm, cfg: SwarmConfig, slots: int, mesh,
                 capacity_factor: float = 2.0, admit_cap: int | None = None,
                 cache_slots: int = 0, ring_slots: int | None = None,
                 rounds_per_iter: int = 2, graph: bool | None = None):
        super().__init__(swarm, cfg, slots, admit_cap,
                         cache_slots=cache_slots, ring_slots=ring_slots,
                         rounds_per_iter=rounds_per_iter, device=mesh.device)
        self.mesh, self.capacity_factor = mesh, capacity_factor
        d = mesh.size
        if slots % d or self.admit_cap % d:
            raise ValueError(f"serve slots {slots} and admit_cap "
                             f"{self.admit_cap} must divide the {d}-device "
                             f"mesh")
        can = mesh.backend == "nccl" and self.device.type == "cuda"
        if graph and not can:
            raise ValueError(
                f"a CUDA graph needs an NCCL mesh on the card; this mesh "
                f"is {mesh.transport}, whose collectives no graph can "
                f"capture: use graph=False (the eager runner)")
        self.graph = can if graph is None else bool(graph)
        self.init_shipped = torch.zeros((), dtype=torch.int64,
                                        device=self.device)

    @property
    def exchange_row_bytes(self) -> int:
        """Bytes one admission or solicitation row pays on the routed
        exchange: an 8-byte query row plus a ``2K``-candidate answer row
        (``8·K`` bytes, u16 pair windows and i32 index rows alike)."""
        return 8 + 8 * self.cfg.bucket_k

    def _body(self, st, rings, cache, keys, reqs, cls, origins, n_new, rnd0,
              rounds: int, expire: bool, gated: bool):
        ex: dict = {}
        out = _sharded_resident_step(
            self.mesh, self.swarm, self.cfg, st, rings, cache, keys, reqs,
            cls, origins, n_new, rnd0, self.capacity_factor, rounds, expire,
            gated, exchange=ex)
        self.init_shipped.add_(ex["attempted"])
        return out

    def _graph(self, use_cache: bool, rounds: int, expire: bool):
        if (use_cache, rounds, expire) in self.graphs:
            return self.graphs[(use_cache, rounds, expire)]
        # The eager pass before a capture ships rows that no macro step
        # admitted: take its count back (the capture's add is a replay's).
        shipped = self.init_shipped.clone()
        g = super()._graph(use_cache, rounds, expire)
        self.init_shipped.copy_(shipped)
        return g

    def clock(self) -> float:
        return self.mesh.host_max(time.perf_counter())


def resident_closed_loop_replay(swarm: Swarm, cfg: SwarmConfig,
                                targets: torch.Tensor,
                                generator: torch.Generator | None = None,
                                engine: ResidentServeEngine | None = None, *,
                                origins: torch.Tensor | None = None,
                                device=None):
    """A closed-loop replay through the resident program: enqueue the
    whole batch, run one macro step of ``cfg.max_steps`` rounds (cache
    off, no expiry: the batch engines report stragglers as not done) and
    read its output once.  Equals ``lookup(swarm, cfg, targets,
    origins=...)`` in found, hops and done: an all-free state pops row j
    into slot j, the origins are the batch draw (``origins [L]``, or
    drawn with ``generator`` as ``lookup`` draws them), the seed
    exchange is ``lookup_init`` and every trip is the shared round at
    the same index.  On the card the step is the engine's graph (48
    gated trips at the default ``max_steps``).  Returns ``(LookupResult,
    final state, ResidentOut)``: the result on the engine's device, the
    output as numpy arrays; on the card the state is the graph's static
    state.  Through a :class:`ShardedResidentServeEngine` the targets and
    origins are the whole batch's on every rank (the origins JAX's
    per-shard draws, concatenated), and the result equals
    ``sharded_lookup(compact=False)`` from those origins."""
    l = targets.shape[0]
    eng = engine if engine is not None \
        else ResidentServeEngine(swarm, cfg, slots=l, admit_cap=l,
                                 ring_slots=2 * l, device=device)
    if eng.slots != l or eng.admit_cap < l:
        raise ValueError(f"resident replay needs slots == L == admit_cap; "
                         f"engine has slots={eng.slots}, admit_cap="
                         f"{eng.admit_cap} for L={l}")
    if origins is None:
        if generator is None:
            generator = torch.Generator(device=eng.device).manual_seed(0)
        origins = eng.draw_origins(generator, l)
    dev = eng.device
    st, _rings, out = eng.macro_step(
        eng.empty(), eng.empty_rings(), targets.to(dev),
        torch.arange(l, dtype=torch.int32, device=dev),
        torch.zeros((l,), dtype=torch.int32, device=dev), origins.to(dev), l,
        0, rounds=cfg.max_steps, expire=False, use_cache=False)
    o = eng.read_out(out)
    res = LookupResult(*[torch.from_numpy(x).to(dev)
                         for x in (o.comp_found, o.comp_hops, o.comp)])
    return res, st, o


def serve_resident(engine: ResidentServeEngine, arrival_ts, keys,
                   generator: torch.Generator | None = None, klass=None,
                   duration: float | None = None,
                   overload_queue_factor: int = 8,
                   drain_round_cap: int | None = None, clock=None, sleep=None,
                   admission: AdmissionControl | None = None,
                   host_orchestration_budget: float = 0.05, *,
                   origins_of=None) -> dict:
    """Drive the resident engine against an open-loop schedule,
    double-buffered: each host iteration pulls due arrivals into the host
    queue, hands at most one padded batch to the device ring (throttled
    to ``ring − backlog − admit_cap`` rows, so the ring never sheds: the
    excess waits in the host queue under the burst loop's overload
    guard), dispatches macro step k+1, and only then reads macro step
    k's output — the one read a macro step, made while step k+1 runs.

    Latency is reconstructed as in the burst loop: round-end walls
    interpolated between macro marks (stamped when the dispatch
    returns), floored at the request's hand-off wall.  ``admission``
    takes the policies ``shed`` and ``queue``; ``degrade`` needs the
    burst engine's host-side probe and raises.  Macro step ``i`` admits
    from ``origins_of(i)`` if given, else from ``generator`` (default
    seeded 0).  The clock defaults to ``engine.clock`` (over a mesh the
    ranks' shared reading, so every rank takes the same decisions); it
    is read at exactly the points the JAX loop
    reads it, so under a deterministic virtual clock the whole report
    (the ``resident`` block included) equals JAX's.

    Returns the JAX package's report (the burst loop's keys plus the
    ``resident`` block), plus ``found`` (each completion's found head,
    beside ``request``) and ``layer_walls_s`` (host seconds dispatching,
    blocked in the drain, asleep, and the rest: the host's own work;
    measured outside the clock's reads)."""
    clock = clock or engine.clock
    sleep = sleep or time.sleep
    pc = time.perf_counter
    cfg, c = engine.cfg, engine.slots
    a_cap = engine.admit_cap
    rounds = engine.rounds_per_iter
    use_cache = engine.cache is not None
    if admission is not None and admission.policy == "degrade":
        raise ValueError(
            "admission policy 'degrade' needs the burst engine's host-side "
            "cache probe; the resident loop supports 'shed' and 'queue'")
    if origins_of is None:
        gen = generator or torch.Generator(device=engine.device).manual_seed(0)
        origins_of = lambda i: engine.draw_origins(gen, a_cap)  # noqa: E731
    keys = np.asarray(keys)
    arrival_np = np.asarray(arrival_ts, np.float64)
    r_total = len(arrival_np)
    if klass is None:
        klass = np.full(r_total, "all")
    drain_cap = drain_round_cap or 4 * cfg.max_steps
    if duration is None:
        duration = float(arrival_ts[-1]) if r_total else 0.0
    hard_wall = duration * 5.0 + 30.0
    walls = {"dispatch": 0.0, "drain_blocked": 0.0, "sleep": 0.0,
             "host": 0.0}

    engine.warm_resident()
    st = engine.empty()
    rings = engine.empty_rings()

    queue: list[int] = []
    enq_wall = np.zeros(r_total, np.float64)
    next_ev = 0
    rnd = 0
    it_i = 0
    marks_r = [0]
    marks_w = [0.0]
    # A completion's round is >= rnd_end - max_steps (expiry retires
    # older rows), so this many trailing marks bracket every cr + 1.
    tw = cfg.max_steps // max(1, rounds) + 4
    rec_req, rec_lat, rec_hops, rec_rounds, rec_found, rec_answer = \
        [], [], [], [], [], []
    queue_depths: list[int] = []
    occ_samples: list[float] = []
    completed = expired = 0
    shed = cache_hits = 0
    handed = 0            # rows handed to the device ring
    ring_backlog = 0      # proven upper bound on the device backlog
    in_flight = 0
    drain_rounds = 0
    dev_shed = 0
    dev_rounds = 0
    macro_n = 0
    ring_depths: list[int] = []
    rung_counts = None
    xchg_init = xchg_round = 0
    blocked_s = 0.0
    sleep_s = 0.0
    dispatch_s = 0.0
    overload = overload_queue_factor * c
    pend = None           # (pending output, rnd0) of macro k

    def _drain(o: ResidentOut, r0: int) -> None:
        nonlocal completed, expired, cache_hits, in_flight, ring_backlog, \
            dev_shed, dev_rounds, macro_n, rung_counts, xchg_init, \
            xchg_round
        macro_n += 1
        dev_rounds += int(o.rounds_run)
        dev_shed = int(o.shed)
        ring_depths.append(int(o.queued))
        rc = np.asarray(o.rung_counts, np.int64)
        rung_counts = rc if rung_counts is None else rung_counts + rc
        xchg_init += int(o.xchg_init_rows)
        xchg_round += int(o.xchg_round_rows)
        mr = marks_r[-tw:]
        mw = marks_w[-tw:]
        # Cache hits: answered at pop time (the macro's start), zero
        # rounds and hops; the latency is the queueing delay.
        hit = o.hit
        n_hit = int(hit.sum())
        if n_hit:
            w0 = float(np.interp(r0, mr, mw))
            hreq = o.hit_req[hit].astype(np.int64)
            cw = np.maximum(w0, enq_wall[hreq])
            rec_req.append(hreq)
            rec_lat.append(np.maximum(0.0, cw - arrival_np[hreq]))
            rec_hops.append(np.zeros(n_hit, np.int64))
            rec_rounds.append(np.zeros(n_hit, np.int64))
            rec_found.append(o.hit_found[hit][:, 0] >= 0)
            rec_answer.append(o.hit_found[hit])
        cache_hits += n_hit
        completed += n_hit
        if o.comp.any():
            sl = np.nonzero(o.comp)[0]
            req = o.comp_req[sl].astype(np.int64)
            cr = o.comp_com[sl]
            # Done with no completion stamp: expired in the program.
            live = cr >= 0
            expired += int((~live).sum())
            if live.any():
                req, cr = req[live], cr[live]
                adm = o.comp_adm[sl][live]
                w = np.maximum(np.interp(cr + 1, mr, mw), enq_wall[req])
                rec_req.append(req)
                rec_lat.append(np.maximum(0.0, w - arrival_np[req]))
                rec_hops.append(o.comp_hops[sl][live].astype(np.int64))
                rec_rounds.append((cr - adm + 1).astype(np.int64))
                rec_found.append(o.comp_found[sl][live][:, 0] >= 0)
                rec_answer.append(o.comp_found[sl][live])
                completed += int(live.sum())
        in_flight = int(o.head) - completed - expired
        ring_backlog = int(o.queued)
        occ_samples.append(in_flight / c)

    t_run = pc()
    t0 = clock()
    while True:
        now = clock() - t0
        new_ev = int(np.searchsorted(arrival_np, now, side="right"))
        if new_ev > next_ev:
            queue.extend(range(next_ev, new_ev))
            next_ev = new_ev
        if len(queue) > overload:
            if admission is not None and admission.policy == "shed":
                over = len(queue) - overload
                del queue[-over:]
                shed += over
            else:
                raise ServeOverloadError(
                    f"serve overload: admission queue reached {len(queue)} "
                    f"requests (> {overload_queue_factor} x {c} slots) at "
                    f"t={now:.2f}s — the arrival rate exceeds what this "
                    f"slot capacity sustains on this machine; lower "
                    f"--arrival-rate, raise --serve-slots, or shed with "
                    f"--admission shed")
        if now > hard_wall:
            if admission is not None and admission.policy == "shed":
                shed += len(queue) + (r_total - next_ev)
                queue.clear()
                next_ev = r_total
            else:
                raise ServeOverloadError(
                    f"serve overload: run exceeded the {hard_wall:.0f}s "
                    f"hard wall ({r_total - next_ev + len(queue)} requests "
                    f"not yet admitted, {in_flight} in flight) — the "
                    f"arrival rate exceeds serve capacity on this machine")
        queue_depths.append(len(queue))

        # Hand-off throttle: the backlog bound is the last drained
        # snapshot plus at most one batch handed since (the pending
        # macro); one admit_cap of headroom keeps the ring from shedding.
        safe = engine.ring_slots - ring_backlog - a_cap
        if pend is not None:
            safe -= a_cap
        m = min(len(queue), a_cap, max(0, safe))
        if admission is not None and m:
            take = []
            qi = 0
            while qi < len(queue) and len(take) < m:
                ri = queue[qi]
                if admission.allow(str(klass[ri]), now):
                    take.append(ri)
                elif admission.policy == "shed":
                    shed += 1
                else:          # queue: head-of-line waits for tokens
                    break
                qi += 1
            del queue[:qi]
            m = len(take)
        else:
            take = queue[:m]
            del queue[:m]

        # Work may exist: rows handed now, device work known at the last
        # drain, or a pending macro that may have admitted some.
        busy = m > 0 or in_flight > 0 or ring_backlog > 0
        new_pend = None
        if busy:
            keys_np = np.zeros((a_cap, N_LIMBS), np.uint32)
            reqs_np = np.full((a_cap,), -1, np.int32)
            if m:
                take_np = np.asarray(take, np.int64)
                keys_np[:m] = keys[take_np]
                reqs_np[:m] = take_np
                enq_wall[take_np] = now
            td = clock()
            t_d = pc()
            # graftlint: disable=sync-in-loop (macro_step reads nothing back: on the card it waits only for its own pinned input buffer's copy from two steps back (double-buffered) and .numpy() views that host buffer; the step's one readback is read_out below)
            st, rings, out = engine.macro_step(
                st, rings, keys_np, reqs_np, np.zeros((a_cap,), np.int32),
                origins_of(it_i), m, rnd)
            walls["dispatch"] += pc() - t_d
            dispatch_s += clock() - td
            marks_r.append(rnd + rounds)
            marks_w.append(clock() - t0)
            handed += m
            new_pend = (out, rnd)
            rnd += rounds
            it_i += 1

        if pend is not None:
            o, r0 = pend
            tb = clock()
            t_b = pc()
            # graftlint: disable=sync-in-loop (double-buffered drain: reads macro k's output while macro k+1 computes: the resident loop's one readback a macro step)
            o = engine.read_out(o)     # macro k's output, while k+1 runs
            walls["drain_blocked"] += pc() - t_b
            blocked_s += clock() - tb
            _drain(o, r0)

        pend = new_pend
        draining = next_ev >= r_total and not queue
        if draining and pend is None and in_flight == 0 \
                and ring_backlog == 0:
            break
        if not busy and pend is None:
            if next_ev < r_total:
                gap = arrival_ts[next_ev] - (clock() - t0)
                if gap > 0:
                    sg = min(gap, 0.05)
                    t_s = pc()
                    sleep(sg)
                    walls["sleep"] += pc() - t_s
                    sleep_s += sg
                continue
        if draining and busy and m == 0:
            drain_rounds += rounds
            if drain_rounds > drain_cap:
                break

    if pend is not None:
        # Drain-cap exit with a macro still in flight.
        o, r0 = pend
        _drain(engine.read_out(o), r0)
        pend = None

    elapsed = clock() - t0
    walls["host"] = max(0.0, pc() - t_run - walls["dispatch"]
                        - walls["drain_blocked"] - walls["sleep"])
    admitted = completed + expired + in_flight
    shed += dev_shed
    orch = max(0.0, elapsed - dispatch_s - blocked_s - sleep_s)
    req_arr = (np.concatenate(rec_req) if rec_req
               else np.asarray([], np.int64))
    return {
        "slots": c,
        "admit_cap": a_cap,
        "burst": rounds,
        "admitted": admitted,
        "completed": completed,
        "expired": expired,
        "in_flight": in_flight,
        "never_admitted": len(queue) + (r_total - next_ev) + ring_backlog,
        "shed": shed,
        "cache_hits": cache_hits,
        "cache_misses": (admitted - cache_hits) if use_cache else 0,
        "degraded_hits": 0,
        "cache_slots": engine.cache_slots,
        "admission_policy": admission.policy if admission else None,
        "sig_submitted": 0,
        "rounds": rnd,
        "elapsed_s": elapsed,
        "sustained_rps": completed / elapsed if elapsed > 0 else 0.0,
        "request": req_arr,
        "latency_s": np.concatenate(rec_lat) if rec_lat
        else np.asarray([], np.float64),
        "hops": np.concatenate(rec_hops) if rec_hops
        else np.asarray([], np.int64),
        "service_rounds": np.concatenate(rec_rounds) if rec_rounds
        else np.asarray([], np.int64),
        "found_nonempty": np.concatenate(rec_found) if rec_found
        else np.asarray([], bool),
        "klass": np.asarray(klass)[req_arr]
        if len(req_arr) else np.asarray([], dtype="<U4"),
        "queue_depth_mean": float(np.mean(queue_depths))
        if queue_depths else 0.0,
        "queue_depth_max": int(np.max(queue_depths))
        if queue_depths else 0,
        "slot_occupancy_frac": float(np.mean(occ_samples))
        if occ_samples else 0.0,
        "burst_marks": list(zip(marks_r, marks_w)),
        "resident": {
            "ring_slots": engine.ring_slots,
            "rounds_per_iter": rounds,
            "iterations": macro_n,
            "device_rounds": dev_rounds,
            "ring_enqueued": handed,
            "ring_shed": dev_shed,
            "ring_backlog_final": ring_backlog,
            "ring_depth_mean": float(np.mean(ring_depths))
            if ring_depths else 0.0,
            "ring_depth_max": int(np.max(ring_depths))
            if ring_depths else 0,
            "host_orchestration_s": orch,
            "host_orchestration_frac": orch / elapsed
            if elapsed > 0 else 0.0,
            "host_orchestration_budget": host_orchestration_budget,
            "device_dispatch_s": dispatch_s,
            "blocked_get_s": blocked_s,
            "sleep_s": sleep_s,
            "rung_select": engine.rung_block,
            "in_jit_rung_counts": [int(x) for x in rung_counts]
            if rung_counts is not None else [],
            "exchange": {"rows_init": xchg_init, "rows_round": xchg_round,
                         "row_bytes": getattr(engine, "exchange_row_bytes",
                                              0)},
        },
        "found": (np.concatenate(rec_answer) if rec_answer
                  else np.zeros((0, cfg.quorum), np.int32)).astype(np.int32),
        "layer_walls_s": walls,
    }


# ---------------------------------------------------------------------------
# chunked-value request station
# ---------------------------------------------------------------------------

class ChunkedStation:
    """Host-side station serving chunked-value requests as a request
    class of the soak loop (counterpart of JAX's ``ChunkedStation``).

    Holds a pool of content-addressed multi-part values (random bytes
    from ``numpy.random.default_rng(seed ^ 0xC4)``; row 0 is the
    zero-length value).  Reads reassemble through
    :func:`~opendht_tpu_torch.models.chunked_values.get_chunked` and are
    byte-checked against the host copy: a hit is exact or counts as
    ``garbled`` (the counter the soak holds at 0; missing is the only
    legal degradation).  Writes are same-bytes seq-bump refreshes (the
    key is the content).  Batches pad to ``batch`` rows with pool row 0
    at its current seq and bytes, so padding changes nothing and its
    results are discarded.  Each call's lookup origins are ``origins``
    (one a batch row; the pool announce, one a pool value) or drawn
    with ``generator``."""

    def __init__(self, cfg: SwarmConfig, scfg, parts: int,
                 pool: int = 32, batch: int = 16, seed: int = 0,
                 device=None):
        from .chunked_values import chunked_content_ids, mask_chunk_payloads
        if parts < 1:
            raise ValueError(f"parts must be >= 1, got {parts}")
        if pool < 1 or batch < 1:
            raise ValueError(f"pool/batch must be >= 1, got "
                             f"pool={pool} batch={batch}")
        self.device = resolve_device(device)
        self.cfg, self.scfg = cfg, scfg
        self.parts, self.pool, self.batch = parts, pool, batch
        w = scfg.payload_words
        rng = np.random.default_rng(seed ^ 0xC4)
        pls = rng.integers(0, 2 ** 32, (pool, parts, w),
                           dtype=np.uint64).astype(np.uint32)
        lens = rng.integers(1, parts * w * 4 + 1, (pool,),
                            dtype=np.int64).astype(np.uint32)
        lens[0] = 0
        d = self.device
        self.payloads = _upload(pls, torch.int64, d)
        self.lengths = _upload(lens, torch.int64, d)
        self.keys = chunked_content_ids(self.payloads, self.lengths)
        masked, _ = mask_chunk_payloads(self.payloads, self.lengths)
        self.oracle = masked.reshape(pool, parts * w).cpu().numpy()
        self.oracle_len = lens.astype(np.int64)
        self.vals = torch.arange(1, pool + 1, dtype=torch.int64, device=d)
        self.seqs = np.full((pool,), 2, np.uint64)     # host seq ledger
        self.reads = self.writes = 0
        self.garbled = self.missing = 0

    def _seqs(self, rows) -> torch.Tensor:
        return _upload(self.seqs[rows].astype(np.uint32), torch.int64,
                       self.device)

    def announce_pool(self, swarm: Swarm, store, now, *, generator=None,
                      origins=None):
        """The initial announce of the whole pool (the values chunked
        requests read); returns the store."""
        from .chunked_values import announce_chunked
        store, _rep = announce_chunked(
            swarm, self.cfg, store, self.scfg, self.keys, self.vals,
            self._seqs(np.arange(self.pool)), now, generator, self.payloads,
            self.lengths, origins=origins, device=self.device)
        return store

    def _pad(self, ranks):
        ranks = np.asarray(ranks, np.int64) % self.pool
        n = len(ranks)
        if n > self.batch:
            raise ValueError(f"batch of {n} exceeds the station width "
                             f"{self.batch}")
        out = np.zeros((self.batch,), np.int64)
        out[:n] = ranks
        return out, n

    def read(self, swarm: Swarm, store, ranks, *, generator=None,
             origins=None):
        """Serve one padded batch of chunked reads; counts hits, garbled
        and missing over the real rows → ``(hits, garbled)``."""
        from .chunked_values import get_chunked
        rows, n = self._pad(ranks)
        idx = torch.from_numpy(rows).to(self.device)
        res = get_chunked(swarm, self.cfg, store, self.scfg, self.keys[idx],
                          generator, self.parts, origins=origins,
                          device=self.device)
        hit, length, payload = _fetch(res.hit, res.length, res.payload)
        hit, rows = hit[:n], rows[:n]
        ok = hit & (length[:n] == self.oracle_len[rows]) \
            & np.all(payload[:n] == self.oracle[rows], axis=1)
        garbled = int((hit & ~ok).sum())
        self.reads += n
        self.garbled += garbled
        self.missing += int(n - hit.sum())
        return int(hit.sum()), garbled

    def refresh(self, swarm: Swarm, store, ranks, now, *, generator=None,
                origins=None):
        """Serve one padded batch of chunked writes (same-bytes seq-bump
        refreshes); returns the store."""
        from .chunked_values import announce_chunked
        rows, n = self._pad(ranks)
        self.seqs[rows[:n]] += 1
        idx = torch.from_numpy(rows).to(self.device)
        store, _rep = announce_chunked(
            swarm, self.cfg, store, self.scfg, self.keys[idx],
            self.vals[idx], self._seqs(rows), now, generator,
            self.payloads[idx], self.lengths[idx], origins=origins,
            device=self.device)
        self.writes += n
        return store
