"""Resident swarm-health monitor: a continuous incremental crawl under
churn.

Counterpart of ``opendht_tpu/models/monitor.py`` (the monitoring
workload of "Efficient Indexing of the BitTorrent DHT",
arXiv:1009.3681): a monitor that keeps per-node freshness state,
re-crawls only the keyspace regions whose freshness has decayed, and
detects departures under live churn, reporting per-sweep coverage,
freshness percentiles and churn-detection lag.

* **freshness plane** — a ``[N]`` :class:`FreshnessState` (sweep indices
  ``last_seen`` / ``discovered`` / ``dead_since`` and the consecutive
  ``missed`` count) updated once a sweep by :func:`fold_sweep` from the
  sweep's lookup results.  The fold only reads ``LookupResult.found``,
  so sweep results are the same with the plane on or off.
* **incremental sweeps** — the keyspace is cut into ``G = 2^depth``
  prefix buckets (about four nodes each, one 8-closest lookup a
  bucket).  A sweep probes the stale buckets: every bucket at least once
  a ``period`` (phase-jittered due dates), any bucket whose fraction of
  nodes older than ``fresh_ttl`` sweeps passed ``stale_threshold``, and
  any bucket holding a node awaiting death confirmation.  The probes
  run through the compacted lookup engine (K1 on the card, or K2 with
  ``merge_impl="fused-round"``) or the defended chaos engine.
* **departure detection** — a tracked node in a probed bucket that the
  probe did not return takes a strike; at ``miss_limit`` consecutive
  strikes it is presumed dead, and a later sighting resurrects it.  A
  node killed at sweep ``k`` is detected by sweep ``k + period +
  miss_limit - 1`` (:attr:`MonitorConfig.detection_lag_bound`).  The
  ground-truth kill ledger (:func:`record_kills`) feeds the measurement
  only.

Randomness is handed in: :meth:`MonitorEngine.kill` and
:meth:`MonitorEngine.heal` take a ``torch.Generator`` or the draws
themselves, and :meth:`MonitorEngine.sweep` a generator or the lookup
origins.  One sweep reads the device back once (the fold's statistics,
counts and hop histogram in one transfer).  The sharded path (``mesh``)
is not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.u32 import shl32
from ..ops.xor_metric import N_LIMBS
from ..parallel.mesh import gather_rows, shard_rows
from ..parallel.sharded import sharded_lookup
from .swarm import (
    LookupFaults,
    LookupResult,
    Swarm,
    SwarmConfig,
    _count_at,
    _require_on,
    chaos_lookup,
    churn,
    heal_swarm,
    hop_histogram,
    lookup,
    resolve_device,
)


class MonitorConfig(NamedTuple):
    """Monitor geometry and policy: ``depth`` of the crawl grid (``G =
    2^depth`` buckets), the hard refresh ``period`` in sweeps, the
    staleness age ``fresh_ttl``, the deficit ``stale_threshold`` that
    re-probes a bucket early, ``miss_limit`` consecutive missed probes
    before a node is presumed dead, and the freshness histogram's
    ``age_cap``."""
    depth: int
    period: int = 4
    fresh_ttl: int = 2
    stale_threshold: float = 0.25
    miss_limit: int = 2
    age_cap: int = 64

    @classmethod
    def for_nodes(cls, n_nodes: int, **kw) -> "MonitorConfig":
        """About four nodes a bucket: ``depth = ceil(log2(N/4))``."""
        d = max(1, int(math.ceil(math.log2(max(16, n_nodes // 4)))))
        return cls(depth=d, **kw)

    @property
    def detection_lag_bound(self) -> int:
        """Worst-case churn-detection lag in sweeps: the first probe after
        a kill within ``period`` sweeps, confirmation within
        ``miss_limit - 1`` more."""
        return self.period + self.miss_limit - 1


class FreshnessState(NamedTuple):
    """Per-node liveness bookkeeping, all ``[N]`` int32: sweep indices
    ``last_seen`` / ``discovered`` (-1 never seen) and ``dead_since``
    (-1 presumed alive or never seen), and ``missed``, the consecutive
    missed probes.  Built from probe observations only."""
    last_seen: torch.Tensor
    discovered: torch.Tensor
    missed: torch.Tensor
    dead_since: torch.Tensor


def empty_freshness(n: int, device=None) -> FreshnessState:
    dev = resolve_device(device)

    def full(v):
        return torch.full((n,), v, dtype=torch.int32, device=dev)

    return FreshnessState(last_seen=full(-1), discovered=full(-1),
                          missed=full(0), dead_since=full(-1))


def bucket_targets(buckets, depth: int, device=None) -> torch.Tensor:
    """``[S,5]`` int64 (u32) lookup targets for prefix buckets: limb 0 the
    bucket prefix, the lower limbs mid-range (the one-shot crawl's grid
    points)."""
    dev = resolve_device(device)
    b = torch.as_tensor(np.asarray(buckets, np.int64), device=dev)
    mid = torch.full((b.shape[0], N_LIMBS - 1), 0x80000000,
                     dtype=torch.int64, device=dev)
    return torch.cat([shl32(b, 32 - depth)[:, None], mid], dim=1)


def record_kills(kill_sweep: torch.Tensor, prev_alive: torch.Tensor,
                 new_alive: torch.Tensor, sweep) -> torch.Tensor:
    """The ground-truth kill ledger: stamp ``sweep`` on every node that
    just died (for the lag measurement only)."""
    return torch.where(prev_alive & ~new_alive, sweep, kill_sweep)


def fold_sweep(fr: FreshnessState, found: torch.Tensor, probed: torch.Tensor,
               ids0: torch.Tensor, sweep, alive: torch.Tensor,
               kill_sweep: torch.Tensor, mcfg: MonitorConfig):
    """Fold one sweep's lookup results into the freshness plane.

    ``found [S, quorum]`` int32 discovered nodes (-1 pad), ``probed [G]``
    bool buckets probed this sweep, ``ids0`` the ids' first limbs (node →
    bucket); ``alive`` / ``kill_sweep`` (ground truth) feed the
    statistics only.  Returns ``(state, stats, age_hist, (cnt_tracked,
    cnt_stale, cnt_pending))``: every stat a 0-dim int32 tensor, the
    histogram ``[age_cap + 1]`` and the counts ``[G]`` int32.

    Exact identities: ``tracked_alive' = tracked_alive +
    newly_discovered + resurrected - newly_dead``, ``probed_tracked =
    probed_seen + probed_missed`` and ``age_hist[0] = nodes_seen``."""
    n = ids0.shape[0]
    g = 1 << mcfg.depth
    dev = ids0.device
    flat = found.reshape(-1).to(torch.int64)
    seen = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    seen[torch.where(flat >= 0, flat, n)] = True
    seen = seen[:n]
    bucket = (ids0 >> (32 - mcfg.depth)).to(torch.int32)
    probed_node = probed[bucket.long()]

    tracked0 = fr.discovered >= 0
    palive0 = tracked0 & (fr.dead_since < 0)            # presumed alive
    miss_hit = probed_node & palive0 & ~seen
    newly_dead_m = miss_hit & (fr.missed + 1 >= mcfg.miss_limit)
    resurrected_m = seen & tracked0 & (fr.dead_since >= 0)

    sweep_t = torch.as_tensor(sweep, dtype=torch.int32, device=dev)
    last_seen = torch.where(seen, sweep_t, fr.last_seen)
    discovered = torch.where(seen & ~tracked0, sweep_t, fr.discovered)
    missed = torch.where(seen, 0, torch.where(miss_hit, fr.missed + 1,
                                              fr.missed))
    dead_since = torch.where(seen, -1, torch.where(newly_dead_m, sweep_t,
                                                   fr.dead_since))
    new = FreshnessState(last_seen=last_seen, discovered=discovered,
                         missed=missed, dead_since=dead_since)

    # --- statistics (ground truth allowed from here on)
    def cnt(m):
        return m.sum().to(torch.int32)

    tracked1 = discovered >= 0
    palive1 = tracked1 & (dead_since < 0)
    age = (sweep_t - last_seen).clamp(0, mcfg.age_cap)
    age_hist = _count_at(age, palive1, mcfg.age_cap + 1)
    lag = sweep_t - kill_sweep
    detect = newly_dead_m & (kill_sweep >= 0)
    stats = {
        "nodes_seen": cnt(seen),
        "newly_discovered": cnt(seen & ~tracked0),
        "resurrected": cnt(resurrected_m),
        "newly_dead": cnt(newly_dead_m),
        "tracked_alive": cnt(palive1),
        "tracked_alive_before": cnt(palive0),
        "covered": cnt(palive1 & alive),
        "actual_alive": cnt(alive),
        "false_alive": cnt(palive1 & ~alive),
        "false_dead": cnt(tracked1 & (dead_since >= 0) & alive),
        "probed_tracked": cnt(probed_node & palive0),
        "probed_seen": cnt(probed_node & palive0 & seen),
        "probed_missed": cnt(miss_hit),
        # graftlint: disable=narrow-cast-unproven (the lag sum equals JAX's int32 reduction bit for bit, wrap included; the prover cannot bound a lag by the sweep count)
        "lag_sum": torch.where(detect, lag, 0).sum().to(torch.int32),
        "lag_count": cnt(detect),
        "lag_max": torch.where(detect, lag, -1).max().to(torch.int32),
        "false_detect": cnt(newly_dead_m & (kill_sweep < 0)),
    }
    cnt_tracked = _count_at(bucket, palive1, g)
    cnt_stale = _count_at(bucket, palive1 & (age > mcfg.fresh_ttl), g)
    cnt_pending = _count_at(bucket, palive1 & (missed >= 1), g)
    return new, stats, age_hist, (cnt_tracked, cnt_stale, cnt_pending)


def kill_node_range(swarm: Swarm, lo: int, hi: int,
                    cfg: SwarmConfig) -> Swarm:
    """Kill the contiguous sorted-id range ``[lo, hi)``: a localized
    keyspace outage, which the deficit trigger must catch before the
    periodic refresh."""
    idx = torch.arange(cfg.n_nodes, device=swarm.alive.device)
    return swarm._replace(alive=swarm.alive & ~((idx >= lo) & (idx < hi)))


def _percentile_from_hist(hist: np.ndarray, q: float) -> int:
    """Smallest bin whose cumulative count reaches the q-quantile."""
    total = int(hist.sum())
    if total == 0:
        return 0
    c = np.cumsum(hist)
    return int(np.searchsorted(c, q * total, side="left"))


class MonitorEngine:
    """The host side of the monitoring loop: owns the swarm (updated in
    place by :meth:`heal`), the freshness plane and the host-side probe
    scheduler.  One sweep = select the stale buckets → one batch of
    lookups (the plain engine, or with ``faults`` the defended chaos
    engine) → one fold → one read of its statistics.
    ``track_freshness=False`` turns the plane off (the sweeps still
    run).  ``mesh`` routes the sweeps through the table-sharded engine
    (:func:`~opendht_tpu_torch.parallel.sharded.sharded_lookup`, taking
    precedence over ``faults`` as in JAX): ``swarm`` is then the rank's
    shard, every rank runs the same sweeps, each probes its rows of the
    sweep's targets, and the results are gathered so that the
    (replicated) freshness plane folds the whole sweep on every rank."""

    def __init__(self, swarm: Swarm, cfg: SwarmConfig,
                 mcfg: MonitorConfig | None = None, mesh=None,
                 faults: LookupFaults | None = None,
                 track_freshness: bool = True, device=None,
                 capacity_factor: float = 2.0):
        if mesh is not None:
            device = mesh.device
        self.capacity_factor = capacity_factor
        self.device = resolve_device(device)
        _require_on(swarm, self.device)
        self.swarm, self.cfg = swarm, cfg
        self.mcfg = mcfg or MonitorConfig.for_nodes(cfg.n_nodes)
        self.mesh, self.faults = mesh, faults
        n, g = cfg.n_nodes, 1 << self.mcfg.depth
        self.n_buckets = g
        self.fresh = (empty_freshness(n, self.device) if track_freshness
                      else None)
        self.kill_sweep = torch.full((n,), -1, dtype=torch.int32,
                                     device=self.device)
        self.sweep_idx = 0
        # Host scheduler state: the last probe sweep of each bucket
        # (phase-jittered after the first full sweep) and the fold's
        # latest per-bucket counts.
        self.last_probed = np.full((g,), np.iinfo(np.int32).min // 2,
                                   np.int64)
        self.phase = np.random.default_rng(0xD47).integers(
            0, self.mcfg.period, size=g)
        self.bucket_counts = None
        self.hop_hist = np.zeros(cfg.max_steps + 1, np.int64)
        self.hop_hist_initial = None
        self.initial_alive = None
        self.records: list[dict] = []

    # -- churn (the ground truth is recorded for the lag measurement)

    def _record(self, prev: torch.Tensor) -> None:
        self.kill_sweep = record_kills(self.kill_sweep, prev,
                                       self.swarm.alive, self.sweep_idx)

    def kill(self, frac: float, draws) -> None:
        """Kill a uniform ``frac`` of the nodes: ``draws`` is a
        ``torch.Generator`` (as :func:`churn` takes) or the ``[N]``
        uniforms themselves (a node survives where its draw is >=
        ``frac``)."""
        prev = self.swarm.alive
        if isinstance(draws, torch.Generator):
            self.swarm = churn(self.swarm, draws, frac, self.cfg)
        else:
            keep = draws.to(self.device) >= frac
            self.swarm = self.swarm._replace(alive=prev & keep)
        self._record(prev)

    def kill_range(self, lo: int, hi: int) -> None:
        prev = self.swarm.alive
        self.swarm = kill_node_range(self.swarm, lo, hi, self.cfg)
        self._record(prev)

    def heal(self, draws) -> None:
        """Routing-table maintenance between sweeps (:func:`heal_swarm`,
        in place; ``draws`` as it takes them; over a mesh each rank
        heals its shard's rows)."""
        rows = None
        if self.mesh is not None:
            m = self.cfg.n_nodes // self.mesh.size
            rows = slice(self.mesh.rank * m, (self.mesh.rank + 1) * m)
        self.swarm = heal_swarm(self.swarm, self.cfg, draws, rows=rows)

    # -- probe scheduling

    def select_buckets(self) -> np.ndarray:
        """The next sweep's bucket set (host, numpy): the due, deficit and
        pending triggers, topped up with the longest-unprobed buckets to
        ``ceil(G / period)`` (and, over a mesh, to at least its size) and
        rounded up to a power-of-two width."""
        m, g, s = self.mcfg, self.n_buckets, self.sweep_idx
        age_p = s - self.last_probed
        due = age_p >= m.period
        if self.bucket_counts is not None:
            tracked, stale, pending = self.bucket_counts
            deficit = stale / np.maximum(tracked, 1)
            due = due | (pending > 0) | (
                (tracked > 0) & (deficit > m.stale_threshold))
        sel = np.flatnonzero(due)
        budget = -(-g // m.period)
        width = max(len(sel), budget, 1)
        if self.mesh is not None:
            width = max(width, self.mesh.size)
        width = min(g, 1 << (width - 1).bit_length())
        if len(sel) < width:
            rest = np.flatnonzero(~due)
            top = rest[np.argsort(-age_p[rest], kind="stable")]
            sel = np.concatenate([sel, top[:width - len(sel)]])
        return np.sort(sel).astype(np.int64)

    # -- the sweep

    def _run_lookup(self, targets: torch.Tensor, generator, origins
                    ) -> LookupResult:
        if self.mesh is not None:
            m = self.mesh
            res = sharded_lookup(
                self.swarm, self.cfg, shard_rows(m, targets), m, generator,
                origins=None if origins is None else shard_rows(m, origins),
                capacity_factor=self.capacity_factor)
            return LookupResult(*[gather_rows(m, x) for x in res])
        if self.faults is not None:
            res, _ = chaos_lookup(self.swarm, self.cfg, targets, generator,
                                  self.faults, origins=origins,
                                  device=self.device)
            return res
        return lookup(self.swarm, self.cfg, targets, generator,
                      origins=origins, device=self.device)

    def begin_sweep(self, buckets=None) -> tuple[np.ndarray, torch.Tensor]:
        """Open sweep ``sweep_idx``: the bucket set and its lookup targets,
        without running the probes (``sweep_idx`` is not bumped)."""
        if buckets is None:
            buckets = self.select_buckets()
        buckets = np.asarray(buckets)
        return buckets, bucket_targets(buckets, self.mcfg.depth, self.device)

    def finish_sweep(self, found: torch.Tensor, buckets, done_frac=1.0,
                     hops: torch.Tensor | None = None) -> dict:
        """Fold one sweep's probe results and close the sweep.  ``found
        [S, quorum]`` in :meth:`begin_sweep`'s bucket order; ``done_frac``
        a float or the probes' ``[S]`` done mask; ``hops`` (optional) the
        probes' rounds, folded into the hop histogram.  The statistics,
        counts, histogram and done count come back in one transfer.
        Returns the sweep record and bumps ``sweep_idx``."""
        s = self.sweep_idx
        buckets = np.asarray(buckets)
        parts, names = [], []
        if isinstance(done_frac, torch.Tensor):
            parts.append(done_frac.sum().reshape(1))
            names.append("done")
        if self.fresh is not None:
            probed = torch.zeros((self.n_buckets,), dtype=torch.bool,
                                 device=self.device)
            probed[torch.as_tensor(buckets, device=self.device)] = True
            self.fresh, stats, age_hist, bcounts = fold_sweep(
                self.fresh, found.to(self.device), probed,
                self.swarm.ids[:, 0], s, self.swarm.alive, self.kill_sweep,
                self.mcfg)
            parts += [torch.stack(list(stats.values())), age_hist, *bcounts]
            names += ["stats", "age_hist", "tracked", "stale", "pending"]
        initial = hops is not None and self.hop_hist_initial is None
        if hops is not None:
            parts.append(hop_histogram(hops.to(self.device),
                                       self.cfg.max_steps))
            names.append("hops")
        if initial:
            parts.append(self.swarm.alive.sum().reshape(1))
            names.append("alive")
        host = {}
        if parts:
            flat = torch.cat([p.to(torch.int64) for p in parts]).cpu().numpy()
            at = 0
            for name, p in zip(names, parts):
                host[name] = flat[at:at + p.numel()]
                at += p.numel()
        if "done" in host:
            done_frac = float(host["done"][0] / done_frac.numel())
        record = {"sweep": s, "buckets_probed": int(len(buckets)),
                  "lookups": int(len(buckets)), "done_frac": float(done_frac)}
        if self.fresh is not None:
            # In sorted key order, as JAX's read of the stats dict gives.
            record.update({k: int(v) for k, v in
                           sorted(zip(stats, host["stats"]))})
            age_hist = host["age_hist"]
            self.bucket_counts = tuple(host[k].astype(np.int32) for k in
                                       ("tracked", "stale", "pending"))
            aa = max(1, record["actual_alive"])
            record["coverage"] = round(record["covered"] / aa, 6)
            record["age_p50"] = _percentile_from_hist(age_hist, 0.50)
            record["age_p99"] = _percentile_from_hist(age_hist, 0.99)
            record["nodes_fresh"] = int(age_hist[0])
        if hops is not None:
            hist = host["hops"]
            self.hop_hist += hist
            if initial:
                self.hop_hist_initial = hist
                self.initial_alive = int(host["alive"][0])
        if s == 0:
            # Phase-jitter the due dates off the initial full crawl, so
            # later sweeps probe about G / period buckets each.
            self.last_probed[buckets] = -self.phase[buckets]
        else:
            self.last_probed[buckets] = s
        self.sweep_idx = s + 1
        self.records.append(record)
        return record

    def sweep(self, generator: torch.Generator | None = None, buckets=None,
              *, origins: torch.Tensor | None = None
              ) -> tuple[dict, LookupResult]:
        """One monitoring sweep → ``(record, result)``.  The probes start
        from ``origins`` if given, else from nodes drawn with
        ``generator`` (as ``lookup`` and ``chaos_lookup`` draw them);
        ``buckets`` overrides the scheduler."""
        buckets, targets = self.begin_sweep(buckets)
        res = self._run_lookup(targets, generator, origins)
        record = self.finish_sweep(res.found, buckets, done_frac=res.done,
                                   hops=res.hops)
        return record, res
