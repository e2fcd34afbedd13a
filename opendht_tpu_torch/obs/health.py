"""Swarm-health analytics on the host: the analytic hop-distribution
model, the Poisson keyspace-density profile and the sweep summary.

The port's own copy of the numpy half of ``opendht_tpu/obs/health.py``
(the port imports nothing of the JAX package):

* :func:`analytic_hop_pmf` — a pure-numpy dynamic program over XOR
  prefix lengths predicting the engine's hop-count distribution
  (arXiv:1309.5866 / 1402.1191 / 1307.7000, specialised to this
  engine's geometry); :func:`hop_fidelity` holds a measured histogram
  against it;
* :func:`poisson_density_profile` — distinct-node counts per crawl
  bucket against the Poisson(N/G) law of uniform random ids;
* :func:`summarize_sweeps` — the steady-state reduction of a monitor's
  sweep records;
* :class:`SwarmHealthPlane` — publishes the monitor's per-sweep records
  (:class:`~opendht_tpu_torch.models.monitor.MonitorEngine`) through the
  Prometheus registry (:mod:`opendht_tpu_torch.utils.metrics`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.metrics import MetricsRegistry


# ---------------------------------------------------------------------------
# analytic hop-count distribution
# ---------------------------------------------------------------------------
#
# The engine's per-lookup ``hops`` counts solicitation ROUNDS until the
# sync quorum (8 closest all queried).  The model tracks the best-known
# common-prefix length p between shortlist head and target:
#
# * init: the origin shares c ~ Geometric(1/2) prefix bits with the
#   target; its bucket-c row returns K members that agree with the
#   target on >= c+1 bits (members differ from the origin exactly at
#   bit c, as does the target), each extending by an independent
#   Geometric(1/2) tail -> p0 = c + 1 + max(G_1..G_K).
# * per round: the alpha=4 solicited windows contribute the closer
#   bucket (K members each) of the leading responders; the trailing
#   window of the round's frontier sits one bucket shallower, so the
#   effective sample pool for the round's best extension is
#   (alpha-1)*K draws -> p' = p + 1 + max of (alpha-1)*K geometrics.
#   (The +1-per-round drift this yields, ~5.8 bits/round at K=8, is
#   what the measured 100k/1M/10M convergence depths imply.)
# * completion: the target's quorum-th closest node sits at prefix
#   p_q, where P(p_q >= j) = P(Poisson(N * 2^-j) >= quorum) — the
#   Poisson random-ID law.  The neighbourhood is REVEALED when the
#   frontier reaches p_q - reveal_margin (the revealing responder is
#   reached one query indirection early, and its two-bucket window
#   spans one extra depth), and syncing the quorum then costs
#   ceil(quorum/alpha) admission rounds plus the reveal round itself.
#
# Structural constants only — nothing is fitted to a measured
# histogram at run time.  Validated against measured histograms at
# 2^11..2^20 nodes: total variation <= 0.10 at every size
# (the JAX package's tests pin the small sizes), against the default
# gate band of HOP_TV_BAND.

HOP_TV_BAND = 0.20       # default artifact band (checker caps at 0.25)
HOP_MEDIAN_TOL = 1       # rounds of allowed median disagreement


def _poisson_tail_ge(lam: float, q: int) -> float:
    """P(Poisson(lam) >= q), stable for the small q used here."""
    if lam > 80.0:
        return 1.0
    term = math.exp(-lam)
    cdf = term
    for i in range(1, q):
        term *= lam / i
        cdf += term
    return max(0.0, 1.0 - cdf)


def analytic_hop_pmf(n_nodes: int, bucket_k: int = 8, alpha: int = 4,
                     quorum: int = 8, max_steps: int = 48) -> np.ndarray:
    """``[max_steps + 1]`` pmf over solicitation rounds predicted by
    the prefix-length dynamic program above — the analytic twin of
    ``models.swarm.hop_histogram`` (last bin = never converged)."""
    if n_nodes < 2:
        raise ValueError(f"analytic model needs n_nodes >= 2, got "
                         f"{n_nodes}")
    pmax = 96
    reveal_margin = 2
    sync_rounds = -(-quorum // alpha) + 1
    gain_samples = max(1, (alpha - 1) * bucket_k)

    def maxgeom_pmf(e: int) -> np.ndarray:
        cdf = (1.0 - 2.0 ** -(np.arange(pmax) + 1.0)) ** e
        return np.diff(np.concatenate([[0.0], cdf]))

    def shift1(p: np.ndarray) -> np.ndarray:   # p := p + 1
        out = np.roll(p, 1)
        out[0] = 0.0
        return out

    c_pmf = 2.0 ** -(np.arange(pmax) + 1.0)
    c_pmf /= c_pmf.sum()
    p0 = shift1(np.convolve(c_pmf, maxgeom_pmf(bucket_k))[:pmax])
    m_round = maxgeom_pmf(gain_samples)
    dists = [p0]
    for _ in range(max_steps):
        dists.append(shift1(np.convolve(dists[-1], m_round)[:pmax]))
    # P(p_r >= j): prefix growth is strictly monotone (+>=1 per
    # round), so first-passage pmfs are plain CDF differences.
    cdf_ge = [np.concatenate([np.cumsum(d[::-1])[::-1], [0.0]])
              for d in dists]

    tail = np.array([_poisson_tail_ge(n_nodes * 2.0 ** -j, quorum)
                     for j in range(pmax)])
    pq = tail.copy()
    pq[:-1] -= tail[1:]                       # P(p_q = j)

    h = np.zeros(max_steps + 1)
    for j in range(pmax):
        if pq[j] <= 0.0:
            continue
        thr = max(0, j - reveal_margin)
        for r in range(sync_rounds, max_steps):
            rr = r - sync_rounds
            prev = cdf_ge[rr - 1][thr] if rr >= 1 else 0.0
            cross = cdf_ge[rr][thr] - prev
            if cross > 0.0:
                h[r] += pq[j] * cross
    h[max_steps] += max(0.0, 1.0 - h.sum())
    return h


def _pmf_median(pmf: np.ndarray) -> int:
    c = np.cumsum(pmf)
    return int(np.searchsorted(c, 0.5 * c[-1], side="left"))


def hop_fidelity(measured_counts: Sequence[int], n_nodes: int,
                 bucket_k: int = 8, alpha: int = 4, quorum: int = 8,
                 band_tv: float = HOP_TV_BAND) -> Dict[str, object]:
    """Compare a measured hop histogram against the analytic model.

    Returns the comparison record the monitor artifact embeds and
    ``check_trace`` recomputes: total-variation distance, the two
    medians, the band, and the verdict (``tv <= band_tv`` AND medians
    within :data:`HOP_MEDIAN_TOL` rounds).
    """
    meas = np.asarray(measured_counts, float)
    total = meas.sum()
    if total <= 0:
        raise ValueError("measured hop histogram is empty")
    meas = meas / total
    model = analytic_hop_pmf(n_nodes, bucket_k=bucket_k, alpha=alpha,
                             quorum=quorum,
                             max_steps=len(meas) - 1)
    tv = 0.5 * float(np.abs(meas - model).sum())
    med_m, med_a = _pmf_median(meas), _pmf_median(model)
    return {
        "n_nodes": int(n_nodes),
        "bucket_k": int(bucket_k),
        "alpha": int(alpha),
        "quorum": int(quorum),
        "tv": round(tv, 6),
        "band_tv": float(band_tv),
        "median_measured": med_m,
        "median_model": med_a,
        "median_tolerance": HOP_MEDIAN_TOL,
        "ok": bool(tv <= band_tv
                   and abs(med_m - med_a) <= HOP_MEDIAN_TOL),
    }


# ---------------------------------------------------------------------------
# keyspace density vs the Poisson random-ID law
# ---------------------------------------------------------------------------

def poisson_density_profile(bucket_counts: Sequence[int],
                            max_count: int = 16) -> Dict[str, object]:
    """Distinct-node counts per crawl bucket vs Poisson(mean).

    ``bucket_counts``: the monitor fold's tracked-alive count per
    prefix bucket.  Uniform random IDs make these iid
    ~Binomial(N, 1/G) ≈ Poisson(N/G) (arXiv:1402.1191); the profile
    compares the observed count-of-counts pmf against that law
    (total variation + the two pmfs, counts clamped into a
    ``>= max_count`` tail bin).
    """
    counts = np.asarray(bucket_counts, np.int64)
    g = counts.shape[0]
    if g == 0:
        raise ValueError("no buckets")
    lam = float(counts.sum()) / g
    clamped = np.minimum(counts, max_count)
    observed = np.bincount(clamped, minlength=max_count + 1
                           ).astype(float) / g
    pois = np.zeros(max_count + 1)
    term = math.exp(-lam)
    for i in range(max_count):
        pois[i] = term
        term *= lam / (i + 1)
    pois[max_count] = max(0.0, 1.0 - pois[:max_count].sum())
    tv = 0.5 * float(np.abs(observed - pois).sum())
    return {
        "buckets": int(g),
        "tracked_nodes": int(counts.sum()),
        "mean_per_bucket": round(lam, 4),
        "max_count_bin": int(max_count),
        "observed_pmf": [round(float(v), 6) for v in observed],
        "poisson_pmf": [round(float(v), 6) for v in pois],
        "tv": round(tv, 6),
    }


def summarize_sweeps(records: Sequence[Dict[str, object]]
                     ) -> Dict[str, object]:
    """Steady-state summary of a monitor sweep-record list.

    The one reduction of per-sweep records every consumer needs — the
    monitor bench row, the soak artifact's monitor block, and
    ``tools/check_trace.py``'s soak checker (which RECOMPUTES it from
    the embedded records, so a summary diverging from its own sweeps
    cannot gate green).  Steady state = post-initial sweeps (sweep 0 is
    the full crawl); lag fields are ``None`` when no death was
    confirmed.  Records without the freshness plane (``coverage``
    absent) summarize to counts only.
    """
    recs = list(records)
    if not recs:
        raise ValueError("no sweep records to summarize")
    out: Dict[str, object] = {
        "sweeps": len(recs),
        "lookups_total": int(sum(r["lookups"] for r in recs)),
    }
    if "coverage" not in recs[0]:
        return out
    post = recs[1:] or recs
    lag_cnt = int(sum(r["lag_count"] for r in recs))
    out.update({
        "coverage_mean": round(
            float(np.mean([r["coverage"] for r in post])), 6),
        "coverage_min": round(min(r["coverage"] for r in post), 6),
        "coverage_final": recs[-1]["coverage"],
        "deaths_detected": lag_cnt,
        "detection_lag_mean": (round(
            sum(r["lag_sum"] for r in recs) / lag_cnt, 3)
            if lag_cnt else None),
        "detection_lag_max": (max(
            r["lag_max"] for r in recs if r["lag_count"])
            if lag_cnt else None),
        "false_dead_final": recs[-1]["false_dead"],
        "false_alive_final": recs[-1]["false_alive"],
        "freshness_p50_final": recs[-1]["age_p50"],
        "freshness_p99_final": recs[-1]["age_p99"],
    })
    return out


# ---------------------------------------------------------------------------
# the gauge surface
# ---------------------------------------------------------------------------

class SwarmHealthPlane:
    """Publishes the monitor's sweep records through the registry.

    Gauge catalogue (``prefix`` defaults to ``dht_swarm``):

    * ``<p>_coverage_ratio`` — tracked∩alive / alive;
    * ``<p>_tracked_alive`` / ``<p>_actual_alive`` — populations;
    * ``<p>_false_alive`` / ``<p>_false_dead`` — undetected
      departures / wrongly-presumed deaths;
    * ``<p>_freshness_age_sweeps{q="p50"|"p99"}`` — age percentiles;
    * ``<p>_detection_lag_sweeps{stat="mean"|"max"}`` — churn-
      detection lag of deaths confirmed this sweep;
    * ``<p>_sweep_index`` / ``<p>_buckets_probed`` — sweep geometry;
    * counters ``<p>_sweeps_total``, ``<p>_lookups_total``,
      ``<p>_nodes_seen_total``, ``<p>_deaths_detected_total``;
    * ``<p>_density_nodes{prefix}`` — tracked nodes per coarse
      keyspace region (top ``density_depth`` bits, 16 regions by
      default) and ``<p>_density_poisson_tv`` — the density profile's
      distance from the Poisson law.
    """

    def __init__(self, registry: MetricsRegistry,
                 prefix: str = "dht_swarm", density_depth: int = 4):
        self.registry = registry
        self.density_depth = density_depth
        g = registry.gauge
        self._coverage = g(f"{prefix}_coverage_ratio",
                           "Tracked-alive over actually-alive nodes")
        self._tracked = g(f"{prefix}_tracked_alive",
                          "Nodes the monitor presumes alive")
        self._actual = g(f"{prefix}_actual_alive",
                         "Ground-truth alive nodes")
        self._false_alive = g(f"{prefix}_false_alive",
                              "Departed nodes not yet detected")
        self._false_dead = g(f"{prefix}_false_dead",
                             "Alive nodes wrongly presumed dead")
        self._age = g(f"{prefix}_freshness_age_sweeps",
                      "Freshness age percentile over tracked nodes",
                      ("q",))
        self._lag = g(f"{prefix}_detection_lag_sweeps",
                      "Churn-detection lag of deaths confirmed this "
                      "sweep", ("stat",))
        self._sweep = g(f"{prefix}_sweep_index", "Last completed sweep")
        self._probed = g(f"{prefix}_buckets_probed",
                         "Buckets probed in the last sweep")
        c = registry.counter
        self._sweeps = c(f"{prefix}_sweeps_total", "Sweeps completed")
        self._lookups = c(f"{prefix}_lookups_total",
                          "Probe lookups dispatched")
        self._seen = c(f"{prefix}_nodes_seen_total",
                       "Node sightings folded")
        self._deaths = c(f"{prefix}_deaths_detected_total",
                         "Departures confirmed")
        self._density = g(f"{prefix}_density_nodes",
                          "Tracked nodes per coarse keyspace region",
                          ("prefix",))
        self._density_tv = g(f"{prefix}_density_poisson_tv",
                             "Total variation of the per-bucket "
                             "density profile vs the Poisson "
                             "random-ID law")

    def publish_sweep(self, record: Dict[str, object]) -> None:
        r = record
        self._sweep.set(r["sweep"])
        self._probed.set(r["buckets_probed"])
        self._sweeps.inc()
        self._lookups.inc(r["lookups"])
        if "coverage" not in r:        # freshness plane off
            return
        self._coverage.set(r["coverage"])
        self._tracked.set(r["tracked_alive"])
        self._actual.set(r["actual_alive"])
        self._false_alive.set(r["false_alive"])
        self._false_dead.set(r["false_dead"])
        self._age.set(r["age_p50"], q="p50")
        self._age.set(r["age_p99"], q="p99")
        self._seen.inc(r["nodes_seen"])
        self._deaths.inc(r["lag_count"])
        if r["lag_count"]:
            self._lag.set(r["lag_sum"] / r["lag_count"], stat="mean")
            self._lag.set(r["lag_max"], stat="max")

    def publish_density(self, bucket_counts: Sequence[int],
                        profile: Optional[Dict[str, object]] = None
                        ) -> Dict[str, object]:
        """Fold per-bucket tracked counts into the coarse density
        gauges; returns (and publishes the tv of) the Poisson
        profile."""
        counts = np.asarray(bucket_counts, np.int64)
        g = counts.shape[0]
        coarse = min(self.density_depth, max(0, g.bit_length() - 1))
        per = g >> coarse
        for i in range(1 << coarse):
            self._density.set(
                int(counts[i * per:(i + 1) * per].sum()),
                prefix=format(i, f"0{max(1, (coarse + 3) // 4)}x"))
        if profile is None:
            profile = poisson_density_profile(counts)
        self._density_tv.set(profile["tv"])
        return profile
