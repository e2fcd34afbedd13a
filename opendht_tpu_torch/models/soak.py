"""Always-on node soak: one engine serving, maintaining and monitoring.

Counterpart of ``opendht_tpu/models/soak.py``, the device form of the
reference's scheduler loop (include/opendht/scheduler.h:38-123): one
host loop interleaves open-loop serving, republish sweeps, monitor
crawls, listener refresh and expiry, index range scans and chunked
values, under churn and a keyspace outage.

:class:`SoakEngine` wraps the burst :class:`~.serve.ServeEngine` and
adds:

* **a per-slot work-class plane** — a resident ``[C]`` int32 tensor
  tagging each slot's occupant (read / write / republish / monitor),
  set at admission (:func:`_scatter_wclass`, :func:`_admit_maintenance`)
  and counted once a burst (:func:`_soak_snapshot`, one readback with
  the serve harvest); the host's slot bookkeeping is held against it
  (``wclass_mismatches``);
* **maintenance micro-batching** — a republish sweep's live rows are
  extracted once (the storage plane's compacted ``_repub_live`` /
  ``_repub_extract_rows``) and admitted into free serve slots a
  micro-batch at a time, after queued serve requests; completed rows
  insert at their harvest (:func:`_repub_insert_completed`).  Monitor
  sweeps ride the same admission with a device-side sighting buffer
  (:func:`_fold_completed`) that ``MonitorEngine.finish_sweep`` folds.
  Listener refresh and TTL expiry are slot-free store sweeps
  (:meth:`SoakEngine.run_store_sweeps`);
* **a scenario engine** — churn, a routing heal and a contiguous
  keyspace outage injected during serving (:class:`ScenarioEvent`).

Every scatter aims a dropped row (sentinel slot ``C``, sweep position
``W``) at a spare row that is sliced off, as the serve engine's
``_set_rows`` does; the snapshot's per-class counts are an
``index_add_`` with a spare bin for free slots.  The lookups run on the
card unless ``"cpu"`` is asked for: K1 or K2 by ``cfg.merge_impl`` in
every serve step, monitor probe and republish row.

Randomness has one source.  The JAX engine folds ``maint_key`` for
maintenance origins, the kill and heal draws of scenario events and the
chunked station; here each such draw is ``draws(kind, path, alive,
n)`` if given — ``kind`` in ``"origins"`` (``n`` origins), ``"kill"``
(``[N]`` uniforms) or ``"heal"`` (a function ``b -> [N, K]``
uniforms), ``path`` the tuple of ``fold_in`` constants JAX applies to
``maint_key`` — else a ``torch.Generator`` seeded ``seed``.  Serve
admissions draw as :func:`~.serve.serve_open_loop` does (``origins_of``
or ``generator``).  JAX's throwaway warm passes (its compiles, run
before the clock) have no counterpart: eager PyTorch has nothing to
warm.

The loop is clock-injectable (``clock`` / ``sleep``) and reads the clock
where the JAX loop does, so under a virtual clock a report is a pure
function of the schedule and the draws, equal to JAX's.  With
maintenance off it equals :func:`~.serve.serve_open_loop` on the same
schedule.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.xor_metric import N_LIMBS
from . import storage as _storage
from .monitor import MonitorEngine, kill_node_range
from .serve import (
    ServeEngine,
    ServeOverloadError,
    _probe_impl,
    _ring_enqueue,
    _scatter_rows_into,
    _set_rows,
    _sync,
    _upload,
)
from .swarm import (
    Swarm,
    SwarmConfig,
    _alive_cdf,
    _finalize,
    churn,
    heal_swarm,
    lookup_init,
)

# Work classes of the per-slot plane: READ / WRITE are serve requests,
# REPUB / MONITOR maintenance rows admitted into free slots.  Index
# range scans and chunked requests run through their stations, not
# through slots.
WC_READ = 0
WC_WRITE = 1
WC_REPUB = 2
WC_MONITOR = 3
N_WORK_CLASSES = 4
WORK_CLASS_NAMES = ("read", "write", "repub", "monitor")
SERVE_CLASSES = (WC_READ, WC_WRITE)
MAINT_CLASSES = (WC_REPUB, WC_MONITOR)

_ACC_EMPTY = (0, 0, 2 ** 30)     # republish replicas: count, sum, min


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

def _scatter_wclass(wc: torch.Tensor, slots: torch.Tensor,
                    cls) -> torch.Tensor:
    """Tag admitted slots with their work class (``cls`` ``[A]`` or a
    scalar); the sentinel slot ``C`` lands in the spare row."""
    cls = torch.as_tensor(cls, dtype=torch.int32, device=wc.device)
    return _set_rows(wc, slots, cls.expand(slots.shape))


def _admit_serve_cached(swarm: Swarm, cfg: SwarmConfig, st, wc, cache,
                        keys: torch.Tensor, slots: torch.Tensor,
                        cls: torch.Tensor, probe_ok: torch.Tensor,
                        origins: torch.Tensor, rnd):
    """Serve admission with the result-cache probe fused in: rows with
    ``probe_ok`` (reads) that hit go to the sentinel in both scatters
    (no slot, no tag); misses scatter as the plain admission.  Returns
    ``(st, wc, cache, hit, hit_found, hit_hops)``; the cache passes
    through."""
    c = st.done.shape[0]
    hit_raw, h_found, h_hops = _probe_impl(cache, keys)
    hit = hit_raw & probe_ok
    new = lookup_init(swarm, cfg, keys, origins)
    eff = torch.where(hit, c, slots)
    st = _scatter_rows_into(st, new, eff, rnd)
    wc = _scatter_wclass(wc, eff, cls)
    return st, wc, cache, hit, h_found, h_hops


def _admit_maintenance(swarm: Swarm, cfg: SwarmConfig, st, wc,
                       pool_keys: torch.Tensor, pool_idx: torch.Tensor,
                       slots: torch.Tensor, origins: torch.Tensor, rnd,
                       cls):
    """Admit one maintenance micro-batch into free slots: ``pool_idx
    [A]`` rows of the sweep's device key pool (pad ``-1``, clipped for
    the gather and dropped by the slot sentinel), ``slots [A]`` (pad
    ``C``), work class ``cls``.  The keys never leave the device."""
    pkeys = pool_keys[pool_idx.clamp(0, pool_keys.shape[0] - 1).long()]
    new = lookup_init(swarm, cfg, pkeys, origins)
    st = _scatter_rows_into(st, new, slots, rnd)
    return st, _scatter_wclass(wc, slots, cls)


def _ring_enqueue_maintenance(rings, pool_keys: torch.Tensor,
                              pool_idx: torch.Tensor, n_new, cls):
    """Enqueue one maintenance micro-batch into a resident engine's
    request ring: keys gathered on the device from the sweep's pool, the
    request index encoded ``-2 - pool_idx`` (client requests use ``>=
    0``, ``-1`` is the never-written sentinel)."""
    pkeys = pool_keys[pool_idx.clamp(0, pool_keys.shape[0] - 1).long()]
    # graftlint: disable=narrow-cast-unproven (pool_idx indexes the sweep's key pool, -1 padding: -2 - pool_idx lies in [-1 - pool, -1], far inside int32; its int64 host upload carries no bound)
    reqs = (-2 - pool_idx).to(torch.int32)
    cls_a = torch.full(pool_idx.shape, int(cls), dtype=torch.int32,
                       device=pool_idx.device)
    return _ring_enqueue(rings, pkeys, reqs, cls_a, n_new)


def _fold_completed(buf: torch.Tensor, ids: torch.Tensor, st,
                    cfg: SwarmConfig, sl: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Scatter harvested slots' finalized heads into a sweep's
    accumulation buffer ``buf [W, quorum]``: ``sl [A]`` slots (pad 0,
    clipped), ``pos [A]`` their sweep rows (pad sentinel ``W``, the
    spare row).  The heads come from the live state."""
    fin = _finalize(ids, st, cfg)
    heads = fin[sl.clamp(0, st.done.shape[0] - 1).long()]
    return _set_rows(buf, pos, heads)


def _repub_insert_completed(ids: torch.Tensor, alive: torch.Tensor,
                            cfg: SwarmConfig, scfg, store, st,
                            sl: torch.Tensor, pos: torch.Tensor,
                            pool_keys: torch.Tensor, vals: torch.Tensor,
                            seqs: torch.Tensor, sizes: torch.Tensor,
                            ttls: torch.Tensor, payloads: torch.Tensor,
                            okf: torch.Tensor, acc: torch.Tensor, now):
    """Insert a harvested micro-batch of completed republish rows into
    the store: heads from the live state, each row's key / value / seq
    / size / ttl / payload gathered from the sweep's pools; rows at the
    pad sentinel ``W`` or whose slot was empty or dead announce to
    nobody.  ``acc`` (int32 ``[3]``: count, replica sum, replica min
    with a ``2**30`` sentinel) accumulates over the live rows.  Returns
    ``(store, acc)``."""
    w = pool_keys.shape[0]
    fin = _finalize(ids, st, cfg)
    heads = fin[sl.clamp(0, st.done.shape[0] - 1).long()]       # [A,q]
    p_safe = pos.clamp(0, w - 1).long()
    ok = (pos >= 0) & (pos < w) & okf[p_safe]
    found = torch.where(ok[:, None], heads, -1)
    store, rep, _trace = _storage._announce_insert(
        alive, cfg, store, scfg, found, pool_keys[p_safe], vals[p_safe],
        seqs[p_safe], now, sizes[p_safe], ttls[p_safe],
        payloads[p_safe] if scfg.payload_words else None)
    rep = rep.to(torch.int32)
    acc = torch.stack([
        acc[0] + ok.sum().to(torch.int32),
        acc[1] + torch.where(ok, rep, 0).sum().to(torch.int32),
        torch.minimum(acc[2], torch.where(ok, rep, 2 ** 30).min()),
    ])
    return store, acc


def _soak_snapshot(swarm: Swarm, cfg: SwarmConfig, st, wc: torch.Tensor):
    """The soak harvest: the serve snapshot plus the work-class plane's
    per-class counts of active (not done) slots — free slots go to a
    spare bin."""
    cls_idx = torch.where(~st.done, wc, N_WORK_CLASSES).long()
    counts = torch.zeros((N_WORK_CLASSES + 1,), dtype=torch.int32,
                         device=wc.device)
    counts.index_add_(0, cls_idx, torch.ones_like(wc))
    return (st.done, st.hops, st.admitted_round, st.completed_round,
            _finalize(swarm.ids, st, cfg), counts[:N_WORK_CLASSES])


def _fetch_flat(*ts: torch.Tensor):
    """Read tensors of any shapes back in one transfer → numpy arrays
    of their shapes (bool, int32 or int64)."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in ts])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in ts:
        a = host[at:at + t.numel()].reshape(tuple(t.shape))
        out.append(a.astype(np.bool_) if t.dtype == torch.bool
                   else a.astype(np.int32) if t.dtype == torch.int32 else a)
        at += t.numel()
    return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class SoakConfig(NamedTuple):
    """Host-side soak policy (wall-clock cadences in seconds):
    ``interval_s`` the timeline row width; ``repub_period_s`` /
    ``monitor_gap_s`` the gap between the end of one republish / monitor
    sweep and the next; ``listen_period_s`` the cadence of the slot-free
    store sweeps; ``maint_cap`` maintenance rows admitted an iteration
    at most; ``maint_slot_frac`` the share of slots maintenance may hold
    at once (serve requests admit first); ``write_flush`` completed
    writes batched a store insert; ``scan_batch`` / ``scan_max_wait_s``
    and ``chunk_max_wait_s`` the scan and chunked stations' flush
    triggers."""
    interval_s: float = 0.5
    repub_period_s: float = 1.0
    monitor_gap_s: float = 0.0
    listen_period_s: float = 1.0
    maint_cap: int = 256
    maint_slot_frac: float = 0.25
    write_flush: int = 256
    scan_batch: int = 16
    scan_max_wait_s: float = 0.25
    chunk_max_wait_s: float = 0.25


class _Sweep:
    """One in-flight maintenance sweep: its rows ``keys_dev [total, 5]``
    on the device, the admission cursor, a head buffer ``buf [total,
    quorum]`` (monitor sweeps; republish sweeps insert at harvest),
    counters and the completed rows.  It closes once every row was
    admitted and retired."""

    __slots__ = ("cls", "keys_dev", "total", "cursor", "buf",
                 "completed", "expired", "admitted", "began_t",
                 "meta", "hops", "done_rows")

    def __init__(self, cls: int, keys_dev, buf, began_t: float,
                 meta=None):
        self.cls = cls
        self.keys_dev = keys_dev
        self.total = int(keys_dev.shape[0])
        self.cursor = 0
        self.buf = buf
        self.completed = 0
        self.expired = 0
        self.admitted = 0
        self.began_t = began_t
        self.meta = meta or {}
        self.hops: list[int] = []
        self.done_rows: list[int] = []

    @property
    def retired(self) -> int:
        return self.completed + self.expired

    @property
    def drained(self) -> bool:
        return self.cursor >= self.total \
            and self.retired >= self.admitted


class SoakEngine:
    """The always-on node: one resident serve state, a work-class plane,
    a store under maintenance and a monitor, advanced by
    :func:`soak_open_loop`.

    ``store`` / ``scfg`` arm republish, listener maintenance and the
    write flush; ``monitor`` (a :class:`MonitorEngine` on the same swarm)
    the interleaved crawl; ``index`` (a ``DeviceIndex``) with
    ``scan_key_fn`` (rank → key dict) the scan station; ``chunk_station``
    (a :class:`~.serve.ChunkedStation`) the chunked requests.  With none
    of them the engine is the burst serve engine.  ``cache_slots`` arms
    the result cache and the probe-fused admission.  The engine owns
    its swarm: scenario events replace its alive mask and heal its
    tables in place, and the serve and monitor halves are re-pointed
    after each (:meth:`_sync_swarm`)."""

    def __init__(self, swarm: Swarm, cfg: SwarmConfig, slots: int,
                 scfg=None, store=None,
                 monitor: Optional[MonitorEngine] = None,
                 index=None, scan_key_fn=None,
                 admit_cap: int | None = None,
                 soak_cfg: SoakConfig | None = None,
                 seed: int = 0x50AC, cache_slots: int = 0,
                 chunk_station=None, *,
                 draws: Callable | None = None, device=None):
        self.serve = ServeEngine(swarm, cfg, slots, admit_cap=admit_cap,
                                 cache_slots=cache_slots, device=device)
        self.device = self.serve.device
        self.swarm, self.cfg = swarm, cfg
        self.scfg, self.store = scfg, store
        self.mon = monitor
        self.index = index
        self.scan_key_fn = scan_key_fn
        self.chunk = chunk_station
        self.soak_cfg = soak_cfg or SoakConfig()
        self._draws = draws
        self._gen = (torch.Generator(device=self.device).manual_seed(seed)
                     if draws is None else None)
        self.wc = torch.zeros((slots,), dtype=torch.int32,
                              device=self.device)
        self._madm_i = 0
        self.repub_records: list[dict] = []
        self.maint_ops: list[dict] = []
        self.store_now = 1        # u32 store clock (announce epochs)
        self._listen_active = None

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    def draw(self, kind: str, path: tuple, n: int = 0):
        """One draw of the engine's source (see the module docstring).
        Without ``draws`` every draw comes from one generator: origins
        through the serve engine's alive prefix sum (read once a scenario
        event, not once a draw), kills and heals as the generator."""
        if self._draws is not None:
            return self._draws(kind, path, self.swarm.alive, n)
        if kind == "origins":
            return self.serve.draw_origins(self._gen, n)
        if kind in ("kill", "heal"):
            return self._gen
        raise ValueError(f"unknown draw kind {kind!r}")

    def _sync_swarm(self, swarm: Swarm) -> None:
        self.swarm = swarm
        self.serve.swarm = swarm
        self.serve._alive_cdf = _alive_cdf(swarm.alive)
        if self.mon is not None:
            self.mon.swarm = swarm

    def snapshot(self, st):
        """``(done, hops, admitted_round, completed_round, found,
        counts)`` as numpy arrays, read back in one transfer."""
        return _fetch_flat(*_soak_snapshot(self.swarm, self.cfg, st,
                                           self.wc))

    def admit_serve(self, st, keys, slots, cls_np, origins, rnd):
        """Serve-side admission.  Cache off: the serve engine's admit
        plus one work-class scatter; the hit info is ``None``.  Cache
        on: :func:`_admit_serve_cached`, with ``(hit, hit_found,
        hit_hops)`` read back in one transfer."""
        cls_t = _upload(cls_np, torch.int32, self.device)
        if self.serve.cache is None:
            st = self.serve.admit(st, keys, slots, origins, rnd)
            self.wc = _scatter_wclass(
                self.wc, _upload(slots, torch.int64, self.device), cls_t)
            return st, None, None, None
        keys_t, slots_t, origins_t = self.serve._batch(keys, slots, origins)
        probe_ok = cls_t == WC_READ
        st, self.wc, self.serve.cache, hit, h_found, h_hops = \
            _admit_serve_cached(self.swarm, self.cfg, st, self.wc,
                                self.serve.cache, keys_t, slots_t, cls_t,
                                probe_ok, origins_t, rnd)
        h, f, hp = _fetch_flat(hit, h_found, h_hops)
        return st, h, f, hp

    def admit_maintenance(self, st, sweep: _Sweep, pool_idx_np, slots_np,
                          rnd):
        origins = self.draw("origins", (self._madm_i,),
                            self.serve.admit_cap)
        self._madm_i += 1
        d = self.device
        st, self.wc = _admit_maintenance(
            self.swarm, self.cfg, st, self.wc, sweep.keys_dev,
            _upload(pool_idx_np, torch.int64, d),
            _upload(slots_np, torch.int64, d), origins.to(d), rnd,
            sweep.cls)
        return st

    def enqueue_maintenance(self, rings, sweep: _Sweep, pool_idx_np,
                            n: int):
        """Offer ``n`` sweep rows (``pool_idx_np``, padded to the
        admission width with ``-1``) to a resident engine's request
        ring; completions decode as ``pool_idx = -2 - comp_req``."""
        return _ring_enqueue_maintenance(
            rings, sweep.keys_dev,
            _upload(pool_idx_np, torch.int64, self.device), n, sweep.cls)

    def fold_completed(self, sweep: _Sweep, st, sl_np, pos_np):
        d = self.device
        sweep.buf = _fold_completed(
            sweep.buf, self.swarm.ids, st, self.cfg,
            _upload(sl_np, torch.int64, d), _upload(pos_np, torch.int64, d))

    def insert_completed(self, sweep: _Sweep, st, sl_np, pos_np):
        """Micro-batch republish insert at harvest."""
        meta, d = sweep.meta, self.device
        self.store, meta["acc"] = _repub_insert_completed(
            self.swarm.ids, self.swarm.alive, self.cfg, self.scfg,
            self.store, st, _upload(sl_np, torch.int64, d),
            _upload(pos_np, torch.int64, d), sweep.keys_dev, meta["vals"],
            meta["seqs"], meta["sizes"], meta["ttls"], meta["payloads"],
            meta["okf"], meta["acc"], meta["now_u"])

    # ------------------------------------------------------------------
    # republish sweeps
    # ------------------------------------------------------------------

    def begin_repub_sweep(self, t: float) -> Optional[_Sweep]:
        """Open a republish sweep: the storage plane's compacted extract
        (one readback of the live count), kept on the device as the
        sweep's admission pool.  ``None`` when no row is live."""
        cfg, scfg, d = self.cfg, self.scfg, self.device
        node_idx = torch.arange(cfg.n_nodes, dtype=torch.int32, device=d)
        m = cfg.n_nodes * scfg.slots
        order, nlive_d = _storage._repub_live(
            self.swarm.alive, self.store, node_idx, cfg, scfg)
        n_live = int(nlive_d)
        if n_live == 0:
            return None
        wdt = min(m, _storage.pow2_width(
            n_live, _storage._REPUB_COMPACT_FLOOR))
        if wdt < m:
            keys, vals, seqs, sizes, ttls, payloads, okf = \
                _storage._repub_extract_rows(
                    self.swarm.alive, self.store, node_idx, order[:wdt],
                    cfg, scfg)
        else:
            keys, vals, seqs, sizes, ttls, payloads, okf = \
                _storage._repub_extract(
                    self.swarm.alive, self.store, node_idx, cfg, scfg)
        now_u = self.store_now
        self.store_now += 1
        return _Sweep(WC_REPUB, keys, None, t,
                      meta={"vals": vals, "seqs": seqs, "sizes": sizes,
                            "ttls": ttls, "payloads": payloads,
                            "okf": okf, "n_live": n_live,
                            "batch_rows": m, "now_u": now_u,
                            "acc": torch.tensor(_ACC_EMPTY,
                                                dtype=torch.int32,
                                                device=d)})

    def finish_repub_sweep(self, sw: _Sweep, t: float) -> dict:
        """Close a republish sweep (every completed row already
        inserted): one readback of the replica accumulator."""
        meta = sw.meta
        n_rep, rep_sum, rep_min = (int(v) for v in meta["acc"].tolist())
        rec = {
            "began_t": round(sw.began_t, 4),
            "finished_t": round(t, 4),
            "rows": sw.total,
            "live_rows": meta["n_live"],
            "batch_rows": meta["batch_rows"],
            "admitted": sw.admitted,
            "completed": sw.completed,
            "expired": sw.expired,
            "in_flight": sw.admitted - sw.completed - sw.expired,
            "replicas_mean": round(float(rep_sum) / max(1, n_rep), 3),
            "replicas_min": rep_min if n_rep else None,
        }
        self.repub_records.append(rec)
        return rec

    # ------------------------------------------------------------------
    # monitor sweeps
    # ------------------------------------------------------------------

    def begin_monitor_sweep(self, t: float) -> _Sweep:
        buckets, targets = self.mon.begin_sweep()
        w = int(targets.shape[0])
        return _Sweep(WC_MONITOR, targets,
                      torch.full((w, self.cfg.quorum), -1,
                                 dtype=torch.int32, device=self.device),
                      t, meta={"buckets": np.asarray(buckets)})

    def finish_monitor_sweep(self, sw: _Sweep, t: float) -> dict:
        """Close a monitor sweep: fold the sighting buffer.  Only
        completed probes' buckets count as probed (an expired probe
        strikes nobody)."""
        buckets = sw.meta["buckets"]
        probed = buckets[np.asarray(sorted(sw.done_rows), np.int64)] \
            if sw.done_rows else np.zeros((0,), np.int64)
        hops = (torch.as_tensor(np.asarray(sw.hops, np.int64),
                                device=self.device) if sw.hops else None)
        rec = self.mon.finish_sweep(
            sw.buf, probed, done_frac=sw.completed / max(1, sw.total),
            hops=hops)
        rec["began_t"] = round(sw.began_t, 4)
        rec["finished_t"] = round(t, 4)
        rec["probes"] = sw.total
        rec["admitted_probes"] = sw.admitted
        rec["expired_probes"] = sw.expired
        rec["in_flight_probes"] = sw.admitted - sw.completed - sw.expired
        return rec

    # ------------------------------------------------------------------
    # slot-free maintenance (listener refresh / TTL expiry)
    # ------------------------------------------------------------------

    def run_store_sweeps(self, t: float, clock, book: bool = True) -> dict:
        """Listener refresh and expiry and value TTL expiry, one
        store-wide pass each, booked with their wall as a maintenance op
        (``book=False``: the pre-clock pass)."""
        t0 = clock()
        if self._listen_active is None:
            # The soak node keeps every registration alive.
            self._listen_active = torch.ones(
                (self.scfg.max_listeners,), dtype=torch.bool,
                device=self.device)
        self.store = _storage.refresh_listeners(
            self.store, self.scfg, self._listen_active, self.store_now)
        self.store = _storage.expire_listeners(self.store, self.scfg,
                                               self.store_now)
        self.store = _storage.expire(self.store, self.scfg, self.store_now)
        _sync(self.device)
        rec = {"op": "listen-refresh+expire", "t": round(t, 4),
               "wall_s": round(clock() - t0, 6)}
        if book:
            self.maint_ops.append(rec)
        return rec


def mixed_events(rate: float, duration: float, key_pool: int,
                 zipf_s: float, seed: int = 0, hot_frac: float = 0.01,
                 write_frac: float = 0.0, scan_frac: float = 0.0,
                 scan_span: int = 64, chunk_frac: float = 0.0,
                 chunk_write_frac: float = 0.25, *,
                 pool: np.ndarray | None = None):
    """The soak arrival schedule: :func:`~.serve.poisson_zipf_events`
    plus an op per request (read / write / scan / chunk / chunkw) from
    ``numpy.random.default_rng(seed ^ 0x50AC)`` and Zipf rank windows
    for the scans (the chunked station maps ``scan_lo`` onto its pool).
    Returns ``(arrival_ts, keys, klass, ops, scan_lo, scan_hi)``;
    ``pool`` is passed to ``poisson_zipf_events``."""
    from .serve import poisson_zipf_events
    if not 0.0 <= write_frac <= 1.0 or not 0.0 <= scan_frac <= 1.0 \
            or not 0.0 <= chunk_frac <= 1.0 \
            or write_frac + scan_frac + chunk_frac > 1.0:
        raise ValueError(
            f"scenario-mix fractions must be in [0, 1] with "
            f"write + scan + chunk <= 1, got write={write_frac} "
            f"scan={scan_frac} chunk={chunk_frac}")
    if not 0.0 <= chunk_write_frac <= 1.0:
        raise ValueError(f"chunk_write_frac must be in [0, 1], got "
                         f"{chunk_write_frac}")
    ts, keys, klass, draw = poisson_zipf_events(
        rate, duration, key_pool, zipf_s, seed=seed, hot_frac=hot_frac,
        return_draw=True, pool=pool)
    r = len(ts)
    rng = np.random.default_rng(seed ^ 0x50AC)
    u = rng.random(r)
    cw = scan_frac + chunk_frac * chunk_write_frac
    cr = scan_frac + chunk_frac
    ops = np.where(
        u < scan_frac, "scan",
        np.where(u < cw, "chunkw",
                 np.where(u < cr, "chunk",
                          np.where(u < cr + write_frac, "write",
                                   "read"))))
    scan_lo = np.minimum(draw, key_pool - 1).astype(np.int64)
    scan_hi = np.minimum(scan_lo + scan_span - 1, key_pool - 1)
    return ts, keys, klass, ops, scan_lo, scan_hi


class ScenarioEvent(NamedTuple):
    """A scheduled fault: at soak-clock second ``t``, ``kind``
    ``"churn"`` kills a uniform ``frac`` of the nodes, ``"outage"`` the
    contiguous sorted-id range ``[N/2, N/2 + frac·N)``.  A routing heal
    follows every event; kills land in the monitor's kill ledger."""
    t: float
    kind: str
    frac: float


def _apply_event(soak: SoakEngine, ev: ScenarioEvent, ev_i: int) -> None:
    cfg = soak.cfg
    if ev.kind == "churn":
        kill = soak.draw("kill", (7000 + ev_i,), cfg.n_nodes)
        if soak.mon is not None:
            soak.mon.kill(ev.frac, kill)
            soak._sync_swarm(soak.mon.swarm)
        elif isinstance(kill, torch.Generator):
            soak._sync_swarm(churn(soak.swarm, kill, ev.frac, cfg))
        else:
            keep = kill.to(soak.device) >= ev.frac
            soak._sync_swarm(soak.swarm._replace(
                alive=soak.swarm.alive & keep))
    elif ev.kind == "outage":
        n0 = cfg.n_nodes // 2
        hi_n = n0 + int(cfg.n_nodes * ev.frac)
        if soak.mon is not None:
            soak.mon.kill_range(n0, hi_n)
            soak._sync_swarm(soak.mon.swarm)
        else:
            soak._sync_swarm(kill_node_range(soak.swarm, n0, hi_n, cfg))
    else:
        raise ValueError(f"unknown scenario event kind {ev.kind!r}")
    heal = soak.draw("heal", (8000 + ev_i,))
    if soak.mon is not None:
        soak.mon.heal(heal)
        soak._sync_swarm(soak.mon.swarm)
    else:
        soak._sync_swarm(heal_swarm(soak.swarm, cfg, heal))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def soak_open_loop(soak: SoakEngine, arrival_ts, keys,
                   generator: torch.Generator | None = None,
                   klass=None, ops=None, scan_lo=None, scan_hi=None,
                   burst: int = 2, duration: float | None = None,
                   overload_queue_factor: int = 8,
                   drain_round_cap: int | None = None,
                   maintenance: bool = True,
                   scenario: tuple = (),
                   timeline=None,
                   latency_plane=None,
                   clock=None, sleep=None, *, origins_of=None,
                   on_event=None) -> dict:
    """Drive the soak engine against an open-loop arrival schedule.

    The serve half is :func:`~.serve.serve_open_loop`'s body (the same
    admission, burst / harvest cadence, latency arithmetic, expiry,
    overload error and hard wall), so with ``maintenance=False``, no
    monitor, no scans and no scenario it gives the serve loop's results.
    On top of it: queued serve requests admit first and free slots then
    take maintenance micro-batches (monitor probes before republish rows,
    at most ``soak_cfg.maint_cap`` an iteration and
    ``maint_slot_frac`` of the slots); ``scenario`` events fire by clock
    time; writes, scans and chunked requests flush through their
    stations; ``timeline`` (a
    :class:`~opendht_tpu_torch.obs.timeline.SoakTimeline`) books every
    burst, admission, completion and op.  ``maintenance=False`` withholds
    only republish, monitor and listener maintenance (the interference
    A/B's off arm).  After the schedule drains, in-flight sweeps drain
    and close with what completed.

    Serve admission ``i`` takes its ``admit_cap`` origins from
    ``origins_of(i)`` if given, else from ``generator`` (seeded 0 if
    omitted).  ``on_event(ev, now)``, if given, is called after each
    scenario event has changed the swarm, with the loop second it fired.

    Returns the JAX report's keys plus ``found`` ``[completed, quorum]``
    (each completion's found head, beside ``request``).
    ``latency_plane`` (an :class:`~opendht_tpu_torch.obs.latency.LatencyPlane`
    labelled by ``op``), if given, observes every serve, scan and chunk
    completion's latency at the JAX loop's four sites; one without an
    ``observe`` method is refused before the clock starts."""
    if latency_plane is not None and \
            not callable(getattr(latency_plane, "observe", None)):
        raise ValueError("latency_plane needs observe(seconds, op=...) "
                         "(a LatencyPlane labelled by 'op')")
    clock = clock or time.perf_counter
    sleep = sleep or time.sleep
    engine = soak.serve
    scfg_soak = soak.soak_cfg
    cfg, c = engine.cfg, engine.slots
    a_cap = engine.admit_cap
    dev = soak.device
    if origins_of is None:
        gen = generator or torch.Generator(device=dev).manual_seed(0)
        origins_of = lambda i: engine.draw_origins(gen, a_cap)  # noqa: E731
    keys = np.asarray(keys, np.uint32)
    r_total = len(arrival_ts)
    if klass is None:
        klass = np.full(r_total, "all")
    if ops is None:
        ops = np.full(r_total, "read")
    ops = np.asarray(ops)
    if "write" in ops and soak.store is None:
        raise ValueError("write requests need a store (scfg/store on "
                         "the SoakEngine)")
    if "scan" in ops and (soak.index is None or soak.scan_key_fn is None):
        raise ValueError("scan requests need an index + scan_key_fn "
                         "on the SoakEngine")
    has_chunk = ("chunk" in ops) or ("chunkw" in ops)
    if has_chunk and (soak.chunk is None or soak.store is None):
        raise ValueError("chunked requests need a ChunkedStation + "
                         "store (chunk_station/scfg/store on the "
                         "SoakEngine)")
    drain_cap = drain_round_cap or 4 * cfg.max_steps
    if duration is None:
        duration = float(arrival_ts[-1]) if r_total else 0.0
    hard_wall = duration * 5.0 + 30.0
    events = sorted(scenario, key=lambda e: e.t)
    ev_i = 0
    do_maint = maintenance and soak.store is not None
    do_mon = maintenance and soak.mon is not None
    if (do_maint or do_mon) and int(scfg_soak.maint_slot_frac * c) < 1:
        raise ValueError(
            f"maint_slot_frac {scfg_soak.maint_slot_frac} of {c} "
            f"slots reserves no whole slot — maintenance could never "
            f"admit a row; raise the fraction or the slot count")
    do_scan = soak.index is not None and "scan" in ops
    do_chunk = soak.chunk is not None and has_chunk
    has_writes = "write" in ops
    n_scan_sched = int(np.sum(ops == "scan")) if do_scan else 0
    n_chunk_sched = int(np.sum((ops == "chunk")
                               | (ops == "chunkw"))) if do_chunk else 0

    # --- pre-clock set-up, as JAX runs it after its warms (the empty
    # scan draws origins; the chunk pool announce, the first sweeps and
    # the empty scenario events change state).
    st = engine.empty()
    # The write fold buffer holds at least one admit-width chunk.
    wf = max(scfg_soak.write_flush, a_cap)
    if do_scan:
        pw = soak.index.spec.prefix_words
        soak.index.range_query(np.zeros((1, pw), np.uint32),
                               np.zeros((1, pw), np.uint32))
    if do_chunk:
        # The pool announce seeds the values chunked requests serve;
        # one empty read and one empty refresh follow, as in JAX.
        soak.store = soak.chunk.announce_pool(
            soak.swarm, soak.store, soak.store_now,
            origins=soak.draw("origins", (0xC400,), soak.chunk.pool))
        soak.store_now += 1
        soak.chunk.read(soak.swarm, soak.store, [],
                        origins=soak.draw("origins", (0xC401,),
                                          soak.chunk.batch))
        soak.store = soak.chunk.refresh(
            soak.swarm, soak.store, [], soak.store_now,
            origins=soak.draw("origins", (0xC402,), soak.chunk.batch))
        soak.store_now += 1
        soak.chunk.reads = soak.chunk.writes = 0
        soak.chunk.garbled = soak.chunk.missing = 0
    repub_sweep: Optional[_Sweep] = None
    mon_sweep: Optional[_Sweep] = None
    if do_maint:
        soak.run_store_sweeps(0.0, clock, book=False)
        repub_sweep = soak.begin_repub_sweep(0.0)
    if do_mon:
        mon_sweep = soak.begin_monitor_sweep(0.0)
    if events:
        _apply_event(soak, ScenarioEvent(-1.0, "churn", 0.0), -1)
        _apply_event(soak, ScenarioEvent(-1.0, "outage", 0.0), -2)
    _sync(dev)

    free = list(range(c - 1, -1, -1))     # pop() → lowest slot first
    # slot -> (work class, ref): the request index for serve slots,
    # (sweep, row position) for maintenance slots.
    occupied: dict[int, tuple] = {}
    queue: list[int] = []
    scan_queue: list[int] = []
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
    adm_c = [0] * N_WORK_CLASSES
    com_c = [0] * N_WORK_CLASSES
    exp_c = [0] * N_WORK_CLASSES
    use_cache = soak.serve.cache is not None
    cache_hits = cache_misses = 0
    drain_rounds = 0
    overload = overload_queue_factor * c
    wclass_mismatches = 0
    maint_occupied = 0
    next_repub_t = 0.0
    next_mon_t = 0.0
    next_listen_t = scfg_soak.listen_period_s if do_maint else None
    repub_done_records: list[dict] = []
    mon_sweep_records: list[dict] = []
    # Write-flush station.
    wbuf = torch.full((wf, cfg.quorum), -1, dtype=torch.int32,
                      device=dev) if has_writes else None
    wpend: list[int] = []     # request indices folded into wbuf rows
    write_seq: dict = {}
    write_flushes = 0
    write_flush_wall = 0.0
    # Scan station.
    scan_done, scan_lat, scan_entries = 0, [], 0
    scan_flushes = 0
    scan_flush_wall = 0.0
    # Chunked station.
    chunk_queue: list[int] = []
    chunk_done, chunk_lat = 0, []
    chunk_reads_done = chunk_writes_done = 0
    chunk_flushes = 0
    chunk_flush_wall = 0.0

    def flush_writes(now_w):
        nonlocal wbuf, wpend, write_flushes, write_flush_wall
        if not wpend:
            return
        t0f = clock()
        wk = np.zeros((wf, N_LIMBS), np.uint32)
        wv = np.zeros((wf,), np.uint32)
        ws = np.zeros((wf,), np.uint32)
        for j, ri in enumerate(wpend):
            kb = keys[ri].tobytes()
            wk[j] = keys[ri]
            wv[j] = (ri + 1) & 0x7FFFFFFF
            ws[j] = 2 + write_seq.get(kb, 0)
            write_seq[kb] = write_seq.get(kb, 0) + 1
        soak.store, _reps, _tr = _storage._announce_insert(
            soak.swarm.alive, cfg, soak.store, soak.scfg, wbuf,
            _upload(wk, torch.int64, dev), _upload(wv, torch.int64, dev),
            _upload(ws, torch.int64, dev), soak.store_now)
        soak.store_now += 1
        # A store insert bumps the result-cache epoch (a no-op without
        # a cache).
        soak.serve.invalidate_cache()
        wbuf = torch.full((wf, cfg.quorum), -1, dtype=torch.int32,
                          device=dev)
        wpend = []
        write_flushes += 1
        wall = clock() - t0f
        write_flush_wall += wall
        if timeline is not None:
            timeline.note_op("write-flush", now_w, wall, maint=False)

    def flush_scans():
        nonlocal scan_queue, scan_done, scan_entries, scan_flushes, \
            scan_flush_wall
        if not scan_queue:
            return
        take, scan_queue = scan_queue, []
        t0f = clock()
        lo = soak.index.linearize(
            [soak.scan_key_fn(int(scan_lo[ri])) for ri in take])
        hi = soak.index.linearize(
            [soak.scan_key_fn(int(scan_hi[ri])) for ri in take])
        res, _leaves = soak.index.range_query(lo, hi)
        t1f = clock()
        for j, ri in enumerate(take):
            lat = max(0.0, (t1f - t0) - float(arrival_ts[ri]))
            scan_lat.append(lat)
            scan_entries += len(res[j])
            if latency_plane is not None:
                latency_plane.observe(lat, op="scan")
            if timeline is not None:
                timeline.note_complete("scan", lat, t1f - t0)
        scan_done += len(take)
        scan_flushes += 1
        scan_flush_wall += t1f - t0f

    def flush_chunks():
        nonlocal chunk_queue, chunk_done, chunk_flushes, \
            chunk_flush_wall, chunk_reads_done, chunk_writes_done
        cb = soak.chunk.batch
        while chunk_queue:
            take, chunk_queue = chunk_queue[:cb], chunk_queue[cb:]
            t0f = clock()
            f_i = 0xC500 + chunk_flushes
            w_rows = [ri for ri in take if ops[ri] == "chunkw"]
            r_rows = [ri for ri in take if ops[ri] != "chunkw"]
            if w_rows:
                # A chunked write is a store insert: bump the cache
                # epoch, as the write flush does.
                soak.store = soak.chunk.refresh(
                    soak.swarm, soak.store,
                    [int(scan_lo[ri]) for ri in w_rows], soak.store_now,
                    origins=soak.draw("origins", (f_i, 1), cb))
                soak.store_now += 1
                soak.serve.invalidate_cache()
            if r_rows:
                # graftlint: disable=sync-in-loop (a chunked read batch is verified on the host: one readback a flushed batch, not a round)
                soak.chunk.read(
                    soak.swarm, soak.store,
                    [int(scan_lo[ri]) for ri in r_rows],
                    origins=soak.draw("origins", (f_i, 2), cb))
            t1f = clock()
            for ri in take:
                lat = max(0.0, (t1f - t0) - float(arrival_ts[ri]))
                chunk_lat.append(lat)
                if latency_plane is not None:
                    latency_plane.observe(lat, op="chunk")
                if timeline is not None:
                    timeline.note_complete("chunk", lat, t1f - t0)
            chunk_done += len(take)
            chunk_reads_done += len(r_rows)
            chunk_writes_done += len(w_rows)
            chunk_flushes += 1
            chunk_flush_wall += t1f - t0f

    t0 = clock()
    while True:
        now = clock() - t0
        # --- scenario events (strictly by clock time)
        while ev_i < len(events) and events[ev_i].t <= now:
            ev = events[ev_i]
            ev_i += 1
            t_ev = clock()
            # graftlint: disable=sync-in-loop (a churn event rebuilds the alive plane and reads the alive count once an event (events are seconds apart))
            _apply_event(soak, ev, ev_i)
            if timeline is not None:
                timeline.note_op(f"scenario-{ev.kind}", now,
                                 clock() - t_ev, maint=False)
            if on_event is not None:
                on_event(ev, now)

        while next_ev < r_total and arrival_ts[next_ev] <= now:
            if ops[next_ev] == "scan" and do_scan:
                scan_queue.append(next_ev)
                if timeline is not None:
                    timeline.note_arrival("scan", now)
            elif ops[next_ev] in ("chunk", "chunkw") and do_chunk:
                chunk_queue.append(next_ev)
                if timeline is not None:
                    timeline.note_arrival("chunk", now)
            else:
                queue.append(next_ev)
                if timeline is not None:
                    timeline.note_arrival(
                        "write" if ops[next_ev] == "write" else "read",
                        now)
            next_ev += 1
        if len(queue) > overload:
            raise ServeOverloadError(
                f"serve overload: admission queue reached {len(queue)} "
                f"requests (> {overload_queue_factor} x {c} slots) at "
                f"t={now:.2f}s — the arrival rate exceeds what this "
                f"slot capacity sustains on this machine; lower "
                f"--arrival-rate or raise --serve-slots")
        in_drain = next_ev >= r_total and not queue
        if now > hard_wall and not (in_drain and (do_maint or do_mon)):
            # The hard wall bounds the schedule phase; once arrivals are
            # served and only maintenance drains, the drain cap governs.
            raise ServeOverloadError(
                f"serve overload: run exceeded the {hard_wall:.0f}s "
                f"hard wall ({r_total - next_ev + len(queue)} requests "
                f"not yet admitted, {len(occupied)} in flight) — the "
                f"arrival rate exceeds serve capacity on this machine")
        queue_depths.append(len(queue))
        if timeline is not None:
            timeline.note_queue(len(queue), now)

        # --- serve admission (first; the serve loop's)
        m = min(len(queue), len(free), a_cap)
        if m:
            take = queue[:m]
            del queue[:m]
            slots_np = np.full(a_cap, c, np.int64)
            keys_np = np.zeros((a_cap, N_LIMBS), np.uint32)
            cls_np = np.zeros(a_cap, np.int32)
            for j, ri in enumerate(take):
                slot = free.pop()
                slots_np[j] = slot
                wcls = WC_WRITE if ops[ri] == "write" else WC_READ
                cls_np[j] = wcls
                occupied[slot] = (wcls, ri)
                admit_wall[ri] = now
                adm_c[wcls] += 1
            keys_np[:m] = keys[np.asarray(take)]
            # graftlint: disable=sync-in-loop (the soak's cache-probed admission reads its hit mask back once a burst, as serve_open_loop's does)
            st, hit, h_found, _h_hops = soak.admit_serve(
                st, keys_np, slots_np, cls_np, origins_of(adm_i), rnd)
            adm_i += 1
            admitted += m
            if timeline is not None:
                timeline.note_admit(
                    {"read": int(np.sum(cls_np[:m] == WC_READ)),
                     "write": int(np.sum(cls_np[:m] == WC_WRITE))},
                    now)
            if hit is not None:
                # Reads that hit complete at the admission wall: zero
                # rounds, no slot, no tag.
                for j, ri in enumerate(take):
                    if cls_np[j] != WC_READ:
                        continue
                    if not hit[j]:
                        cache_misses += 1
                        continue
                    slot = int(slots_np[j])
                    occupied.pop(slot)
                    free.append(slot)
                    lat = max(0.0, now - float(arrival_ts[ri]))
                    rec_req.append(ri)
                    rec_lat.append(lat)
                    rec_hops.append(0)
                    rec_rounds.append(0)
                    rec_found.append(int(h_found[j, 0]) >= 0)
                    rec_answer.append(h_found[j])
                    completed += 1
                    com_c[WC_READ] += 1
                    cache_hits += 1
                    if latency_plane is not None:
                        latency_plane.observe(
                            lat, op=WORK_CLASS_NAMES[WC_READ])
                    if timeline is not None:
                        timeline.note_complete(
                            WORK_CLASS_NAMES[WC_READ], lat, now)

        sched_done = next_ev >= r_total and not queue

        # --- maintenance cadence: arm new sweeps (never once the
        # schedule drained; in-flight sweeps still finish)
        if do_mon and mon_sweep is None and not sched_done \
                and now >= next_mon_t:
            mon_sweep = soak.begin_monitor_sweep(now)
        if do_maint and repub_sweep is None and not sched_done \
                and now >= next_repub_t:
            # graftlint: disable=sync-in-loop (a republish sweep starts with one live-row count readback a sweep period)
            repub_sweep = soak.begin_repub_sweep(now)
            if repub_sweep is None:       # empty store: re-arm later
                next_repub_t = now + scfg_soak.repub_period_s
        if next_listen_t is not None and now >= next_listen_t:
            # graftlint: disable=sync-in-loop (the listen / expiry sweeps run once a sweep period, timed to a barrier)
            rec = soak.run_store_sweeps(now, clock)
            next_listen_t = now + scfg_soak.listen_period_s
            if timeline is not None:
                timeline.note_op(rec["op"], now, rec["wall_s"])

        # --- maintenance admission into leftover free slots (monitor
        # probes first), never past maint_slot_frac of the slots
        maint_budget = min(
            len(free), scfg_soak.maint_cap,
            max(0, int(scfg_soak.maint_slot_frac * c) - maint_occupied))
        for sw in (mon_sweep, repub_sweep):
            while sw is not None and maint_budget > 0 \
                    and sw.cursor < sw.total:
                take_n = min(maint_budget, sw.total - sw.cursor, a_cap)
                slots_np = np.full(a_cap, c, np.int64)
                idx_np = np.full(a_cap, -1, np.int64)
                for j in range(take_n):
                    slot = free.pop()
                    slots_np[j] = slot
                    occupied[slot] = (sw.cls, (sw, sw.cursor))
                    idx_np[j] = sw.cursor
                    sw.cursor += 1
                st = soak.admit_maintenance(st, sw, idx_np, slots_np, rnd)
                sw.admitted += take_n
                adm_c[sw.cls] += take_n
                maint_budget -= take_n
                maint_occupied += take_n
                if timeline is not None:
                    timeline.note_admit(
                        {WORK_CLASS_NAMES[sw.cls]: take_n}, now)

        # --- scan station (batched, between bursts)
        if do_scan and scan_queue and (
                len(scan_queue) >= scfg_soak.scan_batch or sched_done
                or now - float(arrival_ts[scan_queue[0]])
                >= scfg_soak.scan_max_wait_s):
            flush_scans()

        # --- chunked station (batched, between bursts)
        if do_chunk and chunk_queue and (
                len(chunk_queue) >= soak.chunk.batch or sched_done
                or now - float(arrival_ts[chunk_queue[0]])
                >= scfg_soak.chunk_max_wait_s):
            flush_chunks()

        draining = sched_done and not scan_queue and not chunk_queue
        if draining and not occupied:
            break
        if not occupied and not queue:
            if next_ev < r_total:
                gap = arrival_ts[next_ev] - (clock() - t0)
                if gap > 0:
                    sleep(min(gap, 0.05))
                continue
            break

        # --- burst + harvest (the one read an iteration)
        entry_occ = [0] * N_WORK_CLASSES
        for (wcls, _ref) in occupied.values():
            entry_occ[wcls] += 1
        for _ in range(burst):
            st = engine.step(st, rnd)
            rnd += 1
        done, hops, adm_r, com_r, found, dev_active = soak.snapshot(st)
        w = clock() - t0
        marks_r.append(rnd)
        marks_w.append(w)
        occ_samples.append(len(occupied) / c)

        # Slots retired this burst, per class: entry_occ == retired +
        # the device plane's active counts after the harvest.
        retired_b = [0] * N_WORK_CLASSES
        fold_groups: dict = {}
        fill_k, fill_f, fill_h = [], [], []
        for slot in [s for s, _ in occupied.items() if done[s]]:
            wcls, ref = occupied.pop(slot)
            free.append(slot)
            retired_b[wcls] += 1
            if wcls in MAINT_CLASSES:
                maint_occupied -= 1
            cr = int(com_r[slot])
            if wcls in SERVE_CLASSES:
                ri = ref
                if cr < 0:
                    # Done without a completion stamp: a forced
                    # retirement, booked expired.
                    expired += 1
                    exp_c[wcls] += 1
                    if timeline is not None:
                        timeline.note_expire(WORK_CLASS_NAMES[wcls], w)
                    continue
                cw = float(np.interp(cr + 1, marks_r[-2:], marks_w[-2:]))
                cw = max(cw, admit_wall[ri])
                lat = cw - float(arrival_ts[ri])
                rec_req.append(ri)
                rec_lat.append(lat)
                rec_hops.append(int(hops[slot]))
                rec_rounds.append(cr - int(adm_r[slot]) + 1)
                rec_found.append(int(found[slot, 0]) >= 0)
                rec_answer.append(found[slot])
                completed += 1
                com_c[wcls] += 1
                if use_cache and wcls == WC_READ:
                    fill_k.append(keys[ri])
                    fill_f.append(found[slot])
                    fill_h.append(int(hops[slot]))
                if wcls == WC_WRITE:
                    fold_groups.setdefault("write", []).append((slot, ri))
                if latency_plane is not None:
                    latency_plane.observe(lat, op=WORK_CLASS_NAMES[wcls])
                if timeline is not None:
                    timeline.note_complete(WORK_CLASS_NAMES[wcls], lat, w)
            else:
                sw, pos = ref
                if cr < 0:
                    # Never resolved: expired, neither folded nor
                    # inserted, and its bucket is not marked probed.
                    sw.expired += 1
                    exp_c[wcls] += 1
                    if timeline is not None:
                        timeline.note_expire(WORK_CLASS_NAMES[wcls], w)
                    continue
                sw.completed += 1
                sw.done_rows.append(pos)
                sw.hops.append(int(hops[slot]))
                com_c[wcls] += 1
                fold_groups.setdefault(sw, []).append((slot, pos))
                if timeline is not None:
                    timeline.note_complete(WORK_CLASS_NAMES[wcls], None, w)

        if use_cache and fill_k:
            soak.serve.fill_cache(np.asarray(fill_k), np.asarray(fill_f),
                                  np.asarray(fill_h), rnd)

        # The host's per-class occupancy must equal the plane's counts.
        post_occ = [0] * N_WORK_CLASSES
        for (wcls, _ref) in occupied.values():
            post_occ[wcls] += 1
        if any(post_occ[x] != int(dev_active[x])
               for x in range(N_WORK_CLASSES)):
            wclass_mismatches += 1

        # --- interleaved sweep folds (before the slots recycle), in
        # admit-width chunks
        for gkey, pairs in fold_groups.items():
            for lo in range(0, len(pairs), a_cap):
                chunk = pairs[lo:lo + a_cap]
                sl_np = np.zeros(a_cap, np.int64)
                if gkey == "write":
                    if len(wpend) + len(chunk) > wf:
                        # Flush before a fold position would pass wf.
                        flush_writes(w)
                    pos_np = np.full(a_cap, wf, np.int64)
                    for j, (slot, ri) in enumerate(chunk):
                        sl_np[j] = slot
                        pos_np[j] = len(wpend)
                        wpend.append(ri)
                    wbuf = _fold_completed(
                        wbuf, soak.swarm.ids, st, cfg,
                        _upload(sl_np, torch.int64, dev),
                        _upload(pos_np, torch.int64, dev))
                else:
                    sw = gkey
                    pos_np = np.full(a_cap, sw.total, np.int64)
                    for j, (slot, pos) in enumerate(chunk):
                        sl_np[j] = slot
                        pos_np[j] = pos
                    if sw.cls == WC_REPUB:
                        soak.insert_completed(sw, st, sl_np, pos_np)
                    else:
                        soak.fold_completed(sw, st, sl_np, pos_np)

        # --- expiry: rows past their round budget retire
        stale = [s for s in occupied
                 if not done[s] and rnd - int(adm_r[s]) >= cfg.max_steps]
        if stale:
            batch = stale[:a_cap]
            sl = np.full(a_cap, c, np.int64)
            sl[:len(batch)] = batch
            st = engine.expire(st, sl)
            for slot in batch:
                wcls, ref = occupied.pop(slot)
                free.append(slot)
                exp_c[wcls] += 1
                if wcls in SERVE_CLASSES:
                    expired += 1
                else:
                    ref[0].expired += 1
                    maint_occupied -= 1
                if timeline is not None:
                    timeline.note_expire(WORK_CLASS_NAMES[wcls], w)

        # --- timeline burst and lifecycle bookkeeping
        if timeline is not None:
            life_occ = [0] * N_WORK_CLASSES
            for (wcls, _ref) in occupied.values():
                life_occ[wcls] += 1
            timeline.note_burst(
                burst, list(entry_occ), list(retired_b),
                [int(dev_active[x]) for x in range(N_WORK_CLASSES)], w)
            timeline.note_lifecycle(
                {WORK_CLASS_NAMES[x]: {
                    "admitted": adm_c[x], "completed": com_c[x],
                    "expired": exp_c[x], "in_flight": life_occ[x]}
                 for x in range(N_WORK_CLASSES)}, w)

        # --- close drained sweeps, re-arm their cadence
        if mon_sweep is not None and mon_sweep.drained:
            # graftlint: disable=sync-in-loop (a drained monitor sweep is closed with one readback of its fold, once a sweep)
            mon_sweep_records.append(soak.finish_monitor_sweep(mon_sweep, w))
            if timeline is not None:
                timeline.note_sweep("monitor", mon_sweep_records[-1], w)
            mon_sweep = None
            next_mon_t = w + scfg_soak.monitor_gap_s
        if repub_sweep is not None and repub_sweep.drained:
            repub_done_records.append(
                # graftlint: disable=sync-in-loop (a drained republish sweep is closed with one readback of its replica accumulator, once a sweep)
                soak.finish_repub_sweep(repub_sweep, w))
            if timeline is not None:
                timeline.note_sweep("repub", repub_done_records[-1], w)
            repub_sweep = None
            next_repub_t = w + scfg_soak.repub_period_s

        if draining:
            drain_rounds += burst
            if drain_rounds > drain_cap:
                break

    elapsed = clock() - t0
    # Final flush and partial sweep closes (unadmitted rows were never
    # dispatched, so every conservation identity holds).
    if wpend:
        flush_writes(elapsed)
    if mon_sweep is not None and mon_sweep.admitted:
        mon_sweep_records.append(
            soak.finish_monitor_sweep(mon_sweep, elapsed))
    if repub_sweep is not None and repub_sweep.admitted:
        repub_done_records.append(
            soak.finish_repub_sweep(repub_sweep, elapsed))
    if timeline is not None:
        timeline.close(elapsed)

    in_flight_c = [0] * N_WORK_CLASSES
    for (wcls, _ref) in occupied.values():
        in_flight_c[wcls] += 1
    serve_in_flight = sum(in_flight_c[x] for x in SERVE_CLASSES)
    scan_arrived = scan_done + len(scan_queue)
    chunk_arrived = chunk_done + len(chunk_queue)
    return {
        "slots": c,
        "admit_cap": a_cap,
        "burst": burst,
        "admitted": admitted,
        "completed": completed,
        "expired": expired,
        "in_flight": serve_in_flight,
        # Slot-served, never admitted: queued and not yet arrived,
        # minus the stations' scheduled ops.
        "never_admitted": len(queue) + (r_total - next_ev)
        - (n_scan_sched - scan_arrived)
        - (n_chunk_sched - chunk_arrived),
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
        "op": np.asarray(ops)[np.asarray(rec_req, np.int64)]
        if completed else np.asarray([], dtype="<U5"),
        "queue_depth_mean": float(np.mean(queue_depths))
        if queue_depths else 0.0,
        "queue_depth_max": int(np.max(queue_depths))
        if queue_depths else 0,
        "slot_occupancy_frac": float(np.mean(occ_samples))
        if occ_samples else 0.0,
        "burst_marks": list(zip(marks_r, marks_w)),
        "maintenance": bool(do_maint or do_mon),
        "cache_slots": soak.serve.cache_slots,
        "cache_hits": cache_hits,
        "cache_misses": cache_misses,
        "lifecycle_by_class": {
            WORK_CLASS_NAMES[x]: {
                "admitted": adm_c[x], "completed": com_c[x],
                "expired": exp_c[x], "in_flight": in_flight_c[x]}
            for x in range(N_WORK_CLASSES)},
        "wclass_mismatches": wclass_mismatches,
        "repub_sweeps": repub_done_records,
        "monitor_sweeps": mon_sweep_records,
        "maint_ops": soak.maint_ops,
        "write_flushes": write_flushes,
        "write_flush_wall_s": round(write_flush_wall, 6),
        "scan": {
            "arrived": scan_arrived,
            "completed": scan_done,
            "pending": len(scan_queue),
            "flushes": scan_flushes,
            "flush_wall_s": round(scan_flush_wall, 6),
            "entries_returned": scan_entries,
            "latency_mean_s": round(float(np.mean(scan_lat)), 6)
            if scan_lat else None,
            "latency_max_s": round(float(np.max(scan_lat)), 6)
            if scan_lat else None,
        },
        "chunked": {
            "arrived": chunk_arrived,
            "completed": chunk_done,
            "pending": len(chunk_queue),
            "reads": chunk_reads_done,
            "writes": chunk_writes_done,
            "garbled": soak.chunk.garbled if do_chunk else 0,
            "missing": soak.chunk.missing if do_chunk else 0,
            "flushes": chunk_flushes,
            "flush_wall_s": round(chunk_flush_wall, 6),
            "latency_mean_s": round(float(np.mean(chunk_lat)), 6)
            if chunk_lat else None,
            "latency_max_s": round(float(np.max(chunk_lat)), 6)
            if chunk_lat else None,
        },
        "found": (np.stack(rec_answer) if rec_answer
                  else np.zeros((0, cfg.quorum), np.int32)
                  ).astype(np.int32).reshape(-1, cfg.quorum),
    }
