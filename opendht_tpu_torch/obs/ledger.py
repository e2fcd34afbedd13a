"""Cost ledger: from per-round counters to per-function cost.

The port's counterpart of ``opendht_tpu/obs/ledger.py``.  Three planes,
one artifact in the JAX package's schema (``kind: cost_ledger``), so
``tools/check_trace.py`` (``check_ledger_obj``) and ``tools/roofline.py``
judge it unchanged, the port's own copies as JAX's:

* **kernel plane** — :meth:`CostLedger.instrument` wraps the port's
  device entry points (:data:`ENTRY_POINTS`) in place: every
  invocation is counted and walled (with ``barrier=True`` the wall ends
  at a ``torch.cuda.synchronize``, so it is execution, not dispatch).
  The wrappers are pure observers: they call the original function with
  untouched arguments, so results, strikes and traces are bit-identical
  with the ledger on or off (``tests/test_torch_ledger.py``).
* **memory plane** — :func:`hbm_watermark`: on the card
  ``torch.cuda.memory_stats()``'s current and peak allocated bytes
  (``source: "memory_stats"``); on the CPU the bytes of every distinct
  tensor storage reachable from the garbage collector's tracked objects
  (``source: "live_tensors"``, the counterpart of JAX's
  ``jax.live_arrays()`` sum), its peak the largest sample taken.
* **phase plane** — :func:`measure_round_phases` splits one lookup
  round into JAX's named sub-phases (``alpha-select``, ``gather``,
  ``window-decode``, ``merge``, ``scatter-writeback``; plain tables:
  ``respond`` for the middle two) by timing semantically true prefixes
  of the round, so the rows telescope to the whole round by
  construction; the full prefix is asserted bit-equal to
  :func:`~opendht_tpu_torch.models.swarm.lookup_step`.

**What differs from JAX, and why.**

* *Row table.*  :data:`ENTRY_POINTS` lists the port's own functions,
  each row named ``module.attr`` as JAX names its rows.  JAX rows
  without a port function of their own: ``swarm._lookup_step_d``,
  ``_traced_lookup_step_d`` and ``_chaos_step_d`` (the donating
  specialisations; the port's ``lookup_step``, ``traced_lookup_step``
  and ``chaos_lookup_step`` carry that work); ``serve._scatter_admission``
  and ``_scatter_admission_masked`` (inside the port's ``_admit`` /
  ``_admit_cached``); ``serve._resident_step`` / ``_resident_step_cached``
  (the port's eager macro step is ``serve._resident_core``, and a CUDA
  graph replay of it is one ``serve._resident_replay`` row — the
  counterpart of JAX's one compiled program call);
  ``sharded._sharded_lookup_while`` (the port's while formulation calls
  ``sharded.sharded_lookup_init`` and ``sharded.sharded_lookup_step``
  a round, so the routed round has rows of its own);
  ``_sharded_compact_slice`` / ``_sharded_compact_resize`` /
  ``_sharded_writeback`` (``sharded._compact`` and, through its import,
  ``swarm._writeback_prefix``); ``_sharded_rebalance_slice`` /
  ``_resize`` (``sharded._rebalance``); ``sharded_storage._sharded_insert``
  (``sharded_storage._insert_routed``).
* *Donation.*  torch has no buffer donation.  The third column of a
  row names the arguments the port's function overwrites in place
  (``_store_insert`` writes the store it is given; ``traced_lookup_step``
  adds into its trace), so an artifact's ``donated`` / ``donate_argnums``
  mean "this call consumes those arguments' old contents", which is what
  a donating jit means for its caller.
* *FLOPs and bytes.*  There is no ``cost_analysis`` for eager torch:
  ``flops`` and ``bytes_accessed`` are ``null`` in every kernel and
  phase row (the checker allows it); no count is invented here.
* *Compile count.*  :func:`step_cache_size` counts what the port builds
  or captures: kernel libraries loaded by
  :mod:`opendht_tpu_torch.ops.kernels` and CUDA graphs captured by the
  resident engines.  Its change across a clocked pass is
  ``attr_compile_count`` and must be 0.
* *Nesting.*  JAX forwards a wrapped jit untouched while another is
  being traced; in eager torch the inner call really runs, so a depth
  guard forwards a wrapped call made inside another wrapped call
  without recording it, and the rows match JAX's.
* *Graph capture.*  While the current stream captures a CUDA graph the
  wrappers forward untouched: a barrier or a host timer there would
  break the capture.
* *Aliases.*  A port module that imported an entry point by name
  (``from .swarm import _finalize``) holds its own reference; the
  ledger patches every loaded port module's attribute that is the
  registered function, not only the defining module's.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import sys
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

import torch

from ..models.swarm import resolve_device

_PKG = "opendht_tpu_torch"

# ---------------------------------------------------------------------------
# entry-point registry
# ---------------------------------------------------------------------------

# (module, attribute, arguments overwritten in place[, budget]).  The
# budget of a row that launches kernels bounds how often each kernel
# source is built a process; that of ``serve._resident_replay`` how
# often one resident engine captures one graph key (graftlint's
# ``budget`` plane, ``tools/graftlint_ranges.py``).
ENTRY_POINTS: tuple = (
    (f"{_PKG}.models.swarm", "_build_bucket", (0,)),
    (f"{_PKG}.models.swarm", "lookup_init", ()),
    (f"{_PKG}.models.swarm", "lookup_step", (), 1),
    (f"{_PKG}.models.swarm", "traced_lookup_step", (3,), 1),
    (f"{_PKG}.models.swarm", "chaos_lookup_init", ()),
    (f"{_PKG}.models.swarm", "chaos_lookup_step", (7,), 1),
    (f"{_PKG}.models.swarm", "_compact_slice", ()),
    (f"{_PKG}.models.swarm", "_compact_resize", ()),
    (f"{_PKG}.models.swarm", "_writeback_prefix", ()),
    (f"{_PKG}.models.swarm", "_evict_blacklisted", ()),
    (f"{_PKG}.models.swarm", "_finalize", ()),
    (f"{_PKG}.models.swarm", "_finalize_scattered", ()),
    (f"{_PKG}.models.serve", "_admit", ()),
    (f"{_PKG}.models.serve", "_admit_cached", ()),
    (f"{_PKG}.models.serve", "_cache_probe", ()),
    (f"{_PKG}.models.serve", "_cache_fill", ()),
    (f"{_PKG}.models.serve", "_cache_invalidate", ()),
    (f"{_PKG}.models.serve", "_snapshot", ()),
    (f"{_PKG}.models.serve", "_expire_slots", ()),
    (f"{_PKG}.models.serve", "_resident_core", ()),
    (f"{_PKG}.models.serve", "_resident_replay", (), 1),
    (f"{_PKG}.models.soak", "_scatter_wclass", ()),
    (f"{_PKG}.models.soak", "_admit_serve_cached", ()),
    (f"{_PKG}.models.soak", "_admit_maintenance", ()),
    (f"{_PKG}.models.soak", "_ring_enqueue_maintenance", ()),
    (f"{_PKG}.models.soak", "_fold_completed", ()),
    (f"{_PKG}.models.soak", "_repub_insert_completed", (4,)),
    (f"{_PKG}.models.soak", "_soak_snapshot", ()),
    (f"{_PKG}.models.storage", "_store_insert", (0,)),
    (f"{_PKG}.models.storage", "_announce_insert", (2,)),
    (f"{_PKG}.models.storage", "_get_probe", ()),
    (f"{_PKG}.models.storage", "_listen_insert", (2,)),
    (f"{_PKG}.models.index", "_linearize_batch", ()),
    (f"{_PKG}.models.index", "_trie_node_hash", ()),
    (f"{_PKG}.models.index", "_pack_entry_payloads", ()),
    (f"{_PKG}.ops.sha1", "sha1_one_block", ()),
    (f"{_PKG}.ops.sha1", "sha1_blocks", ()),
    (f"{_PKG}.models.integrity", "content_ids", ()),
    (f"{_PKG}.models.chunked_values", "chunked_content_ids", ()),
    (f"{_PKG}.models.chunked_values", "_chunked_root_ok", ()),
    (f"{_PKG}.models.monitor", "fold_sweep", ()),
    (f"{_PKG}.parallel.sharded", "sharded_lookup_init", ()),
    (f"{_PKG}.parallel.sharded", "sharded_lookup_step", (), 1),
    (f"{_PKG}.parallel.sharded", "_compact", ()),
    (f"{_PKG}.parallel.sharded", "_rebalance", ()),
    (f"{_PKG}.parallel.sharded", "_sharded_resident_step", ()),
    (f"{_PKG}.parallel.sharded_storage", "_insert_routed", (5,)),
)


def entry_row(row) -> tuple:
    """Normalize an :data:`ENTRY_POINTS` row to ``(module, attr,
    overwritten_argnums, budget-or-None)`` — JAX's four-field shape."""
    return row[0], row[1], tuple(row[2]), row[3] if len(row) > 3 else None


def step_cache_size() -> int:
    """What the port has built or captured so far: kernel libraries
    loaded by :mod:`opendht_tpu_torch.ops.kernels` plus CUDA graphs
    captured by the resident engines.  A change of 0 across a timed
    region proves nothing was built or captured inside it."""
    from ..models import serve
    from ..ops import kernels
    return len(kernels._libs) + serve.GRAPH_CAPTURES


# ---------------------------------------------------------------------------
# memory plane
# ---------------------------------------------------------------------------

def _live_tensor_bytes() -> int:
    """Bytes of every distinct CPU tensor storage the garbage collector
    tracks (views share their base's storage, counted once)."""
    seen, total = set(), 0
    with warnings.catch_warnings():     # isinstance on deprecated proxies
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        if obj.device.type != "cpu":
            continue
        try:
            st = obj.untyped_storage()
            key = st.data_ptr()
            if key in seen:
                continue
            seen.add(key)
            total += int(st.nbytes())
        except Exception:               # a tensor without storage
            pass
    return total


def hbm_watermark(device=None) -> dict:
    """Live and peak device bytes: on the card
    ``torch.cuda.memory_stats()``'s ``allocated_bytes.all.current`` /
    ``.peak`` (``source: "memory_stats"``; the peak is
    ``torch.cuda.max_memory_allocated()``); elsewhere the live CPU
    tensor bytes (``source: "live_tensors"``), whose peak callers track
    as the largest sample (:meth:`CostLedger.sample_hbm`).  ``device``
    resolves as the entry points' does: the card unless ``"cpu"`` is
    asked for, raising where there is no card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        live = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", 0))
        return {"live_bytes": live, "peak_bytes": max(peak, live),
                "source": "memory_stats"}
    live = _live_tensor_bytes()
    return {"live_bytes": live, "peak_bytes": live,
            "source": "live_tensors"}


# ---------------------------------------------------------------------------
# kernel plane
# ---------------------------------------------------------------------------

def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class CostLedger:
    """Cost-attribution recorder: function walls and calls, device
    memory watermarks, phase tables — one artifact (:meth:`to_dict`),
    exportable as Prometheus gauges (:meth:`export_metrics`).
    ``device`` (default: the card; raises where there is none unless
    ``"cpu"`` is asked for) is the device the memory plane samples and
    the barriers wait on."""

    # Bounded per-function wall samples.
    MAX_WALL_SAMPLES = 4096

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.kernels: Dict[str, dict] = {}
        self.spans: List[dict] = []
        self.round_phases: Optional[dict] = None
        self.round_phases_laddered: Optional[dict] = None
        self.repub_profile: Optional[dict] = None
        self.attr_compile_count: Optional[int] = None
        self._depth = threading.local()
        self._hbm_peak_live = 0
        self._hbm_last: Optional[dict] = None
        self.sample_hbm()

    # -- memory ------------------------------------------------------
    def sample_hbm(self) -> dict:
        wm = hbm_watermark(self.device)
        self._hbm_peak_live = max(self._hbm_peak_live, wm["live_bytes"])
        self._hbm_last = wm
        return wm

    def hbm(self) -> dict:
        wm = dict(self._hbm_last or hbm_watermark(self.device))
        if wm["source"] != "memory_stats":
            # No allocator peak: the peak is the largest live sample.
            wm["peak_bytes"] = max(wm["peak_bytes"], self._hbm_peak_live)
        return wm

    # -- kernels -----------------------------------------------------
    def _kernel(self, name: str, fn, donate) -> dict:
        rec = self.kernels.get(name)
        if rec is None:
            rec = {"name": name, "calls": 0, "wall_s": 0.0, "walls": [],
                   "donate_argnums": tuple(donate), "flops": None,
                   "bytes_accessed": None, "fn": fn,
                   "compile_count": None}
            self.kernels[name] = rec
        return rec

    def record_call(self, name: str, wall_s: float, donate=()) -> None:
        rec = self._kernel(name, None, donate)
        rec["calls"] += 1
        rec["wall_s"] += wall_s
        if len(rec["walls"]) < self.MAX_WALL_SAMPLES:
            rec["walls"].append(wall_s)

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-level timed span (whole sweeps, orchestration gaps)."""
        t0 = time.perf_counter()
        yield
        self.spans.append({"name": name,
                           "wall_s": time.perf_counter() - t0})

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap(self, name: str, fn: Callable, donate,
              barrier: bool) -> Callable:
        rec = self._kernel(name, fn, donate)
        rec["fn"] = fn
        depth = self._depth

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # A wrapped call inside another one is part of the outer
            # row (JAX inlines it into the outer program), and a call
            # under graph capture is recorded by its replays: forward.
            if getattr(depth, "n", 0) or _capturing():
                return fn(*args, **kwargs)
            depth.n = 1
            try:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if barrier:
                    self._barrier()
                dt = time.perf_counter() - t0
            finally:
                depth.n = 0
            rec["calls"] += 1
            rec["wall_s"] += dt
            if len(rec["walls"]) < self.MAX_WALL_SAMPLES:
                rec["walls"].append(dt)
            return out

        wrapper.__wrapped__ = fn
        wrapper._ledger_wrapper = True
        return wrapper

    def instrument(self, barrier: bool = False):
        """Context manager: patch the :data:`ENTRY_POINTS` with
        recording wrappers, restore on exit.  A pure observer.
        ``barrier=True`` synchronizes the card after each wrapped call
        so the recorded wall is execution time — it serializes the
        device queue, so use it only in dedicated ledger passes."""
        return instrumented_entry_points(self, barrier=barrier)

    def finalize_costs(self) -> None:
        """JAX fills FLOPs, bytes and compile counts here from compiled
        executables; eager torch has none, so the rows keep ``None``
        (see the module docstring)."""

    # -- artifact ----------------------------------------------------
    def to_dict(self, bench_row: dict | None = None) -> dict:
        self.finalize_costs()
        kernels = []
        for rec in sorted(self.kernels.values(),
                          key=lambda r: -r["wall_s"]):
            if rec["calls"] == 0:
                continue
            kernels.append({
                "name": rec["name"], "calls": rec["calls"],
                "wall_s": round(rec["wall_s"], 6),
                "wall_mean_s": round(rec["wall_s"] / rec["calls"], 6),
                "flops": rec["flops"],
                "bytes_accessed": rec["bytes_accessed"],
                "donated": bool(rec["donate_argnums"]),
                "donate_argnums": list(rec["donate_argnums"]),
                "compile_count": rec["compile_count"],
                "compiles_in_window": rec.get("compiles_in_window"),
            })
        out = {
            "kind": "cost_ledger",
            "platform": "gpu" if self.device.type == "cuda" else "cpu",
            "hbm": self.hbm(),
            "kernels": kernels,
        }
        if bench_row is not None:
            out["bench"] = bench_row
        if self.spans:
            out["spans"] = [
                {"name": s["name"], "wall_s": round(s["wall_s"], 6)}
                for s in self.spans]
        if self.round_phases is not None:
            out["round_phases"] = self.round_phases
        if self.round_phases_laddered is not None:
            out["round_phases_laddered"] = self.round_phases_laddered
        if self.repub_profile is not None:
            out["repub_profile"] = self.repub_profile
        if self.attr_compile_count is not None:
            out["attr_compile_count"] = self.attr_compile_count
        return out

    # -- Prometheus export -------------------------------------------
    def export_metrics(self, registry) -> None:
        """Publish the ledger into a
        :class:`~opendht_tpu_torch.utils.metrics.MetricsRegistry` (JAX's
        gauge names; the FLOPs and bytes gauges are registered but stay
        empty, as no row carries a count)."""
        from ..utils.metrics import Histogram

        self.finalize_costs()
        wall = registry.gauge(
            "dht_ledger_kernel_wall_seconds",
            "Cumulative wall per instrumented device kernel",
            ("kernel",))
        calls = registry.gauge(
            "dht_ledger_kernel_calls", "Invocations per kernel",
            ("kernel",))
        flops = registry.gauge(
            "dht_ledger_kernel_flops",
            "XLA cost_analysis FLOPs per compiled kernel", ("kernel",))
        byts = registry.gauge(
            "dht_ledger_kernel_bytes_accessed",
            "XLA cost_analysis bytes accessed per compiled kernel",
            ("kernel",))
        hist = registry.histogram(
            "dht_ledger_invocation_seconds",
            "Per-invocation wall distribution", ("kernel",),
            buckets=Histogram.LATENCY_BUCKETS_S)
        for rec in self.kernels.values():
            if rec["calls"] == 0:
                continue
            wall.set(rec["wall_s"], kernel=rec["name"])
            calls.set(rec["calls"], kernel=rec["name"])
            if rec["flops"] is not None:
                flops.set(rec["flops"], kernel=rec["name"])
            if rec["bytes_accessed"] is not None:
                byts.set(rec["bytes_accessed"], kernel=rec["name"])
            # Only walls not yet exported (a registry may be refreshed
            # at every scrape).
            start = rec.get("_exported_walls", 0)
            for w in rec["walls"][start:]:
                hist.observe(w, kernel=rec["name"])
            rec["_exported_walls"] = len(rec["walls"])
        wm = self.hbm()
        registry.gauge("dht_ledger_hbm_live_bytes",
                       "Live accelerator bytes at last sample"
                       ).set(wm["live_bytes"])
        registry.gauge("dht_ledger_hbm_peak_bytes",
                       "Peak accelerator bytes observed"
                       ).set(wm["peak_bytes"])
        for table, metric in ((self.round_phases,
                               "dht_ledger_round_phase_wall_seconds"),
                              (self.repub_profile,
                               "dht_ledger_repub_phase_wall_seconds")):
            if table:
                g = registry.gauge(
                    metric, "Attributed wall per sub-phase", ("phase",))
                for row in table["rows"]:
                    g.set(row["wall_s"], phase=row["phase"])


def _port_modules():
    return [m for name, m in list(sys.modules.items())
            if m is not None and (name == _PKG or
                                  name.startswith(_PKG + "."))]


@contextlib.contextmanager
def instrumented_entry_points(ledger: CostLedger, barrier: bool = False):
    """Patch every registered entry point — in its defining module and
    in every loaded port module that imported it by name — with
    ``ledger`` wrappers for the duration of the block (see
    :meth:`CostLedger.instrument`)."""
    patched = []
    try:
        for row in ENTRY_POINTS:
            mod_name, attr, donate, _budget = entry_row(row)
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None or getattr(fn, "_ledger_wrapper", False):
                continue
            wrapped = ledger._wrap(f"{mod_name.rsplit('.', 1)[-1]}.{attr}",
                                   fn, donate, barrier)
            for m in _port_modules():
                for name, val in list(vars(m).items()):
                    if val is fn:
                        setattr(m, name, wrapped)
                        patched.append((m, name, fn))
        yield ledger
    finally:
        for m, name, fn in reversed(patched):
            setattr(m, name, fn)


# ---------------------------------------------------------------------------
# phase plane: the round sub-phase A/B pass
# ---------------------------------------------------------------------------

def _round_prefix_fn(upto: str, merge_w: int | None = None):
    """The prefix of one round that runs its phases up to and including
    ``upto`` → ``prefix(swarm, cfg, st)``.

    The prefixes are semantically true: prefix k computes phases 1..k
    with the helpers :func:`~opendht_tpu_torch.models.swarm.lookup_step`
    composes (``_select_alpha``, ``ops.round_parts``'s pair-window
    gather and decode, ``fold_solicitations``, the round merge — K1 on
    the card — and the done rule), and the final prefix's state is
    asserted bit-equal to ``lookup_step``'s by
    :func:`measure_round_phases`.  Every intermediate a later phase
    consumes is returned, so no phase's work is dead code.  A
    ``merge_impl="fused-round"`` config attributes through the unfused
    composition (K2's phases do not exist apart); its full prefix still
    equals ``lookup_step`` bit for bit, since K2 equals the composition.
    ``merge_w`` prices the plain rank merge at a narrower width."""
    from ..models import swarm as sw
    from ..ops import kernels
    from ..ops.round_parts import (fold_solicitations, gather_pair_windows,
                                   unpack_pair_window)
    from ..ops.u32 import prefix_len32
    from ..ops.xor_metric import merge_shortlists_d0, rank_merge_round_d0_w

    def prefix(swarm, cfg, st):
        n, b_total, k = cfg.n_nodes, cfg.n_buckets, cfg.bucket_k
        l = st.targets.shape[0]
        # -- phase 1: alpha-select (+ the done / alive masking the round
        # does before soliciting)
        sel, sel_d0, sel_pos = sw._select_alpha(st, cfg)
        sel = torch.where(st.done[:, None], -1, sel)
        safe = sel.clamp(0, n - 1).long()
        sel_alive = (sel >= 0) & swarm.alive[safe]
        if upto == "alpha-select":
            return sel, sel_d0, sel_pos, sel_alive
        if swarm.tables.dtype == torch.uint16:              # augmented
            # -- phase 2: the table gather (bucket-pair windows)
            c0 = prefix_len32(sel_d0).clamp(0, b_total - 2)
            win = gather_pair_windows(swarm.tables, safe, c0, k)
            if upto == "gather":
                return sel, sel_d0, sel_pos, sel_alive, win
            # -- phase 3: per-member window decode
            a = sel.shape[1]
            idx, d0 = unpack_pair_window(win.view(l, a, 2, 3 * k), c0,
                                         st.targets[:, 0], sel_d0,
                                         sel_alive, k)
            resp, resp_d0 = idx.reshape(l, -1), d0.reshape(l, -1)
            if upto == "window-decode":
                return sel, sel_d0, sel_pos, sel_alive, resp, resp_d0
        else:
            # Plain tables: gather and decode are one span gather,
            # reported as a single "respond" phase.
            resp, resp_d0, _ = sw._respond(swarm, cfg, st.targets, sel,
                                           sel_d0)
            if upto == "respond":
                return sel, sel_d0, sel_pos, sel_alive, resp, resp_d0
        # -- phase 4: the queried / evict fold and the rank merge
        valid_sel = sel >= 0
        q_hit = valid_sel & sel_alive       # the local respond answers
        e_hit = valid_sel & ~sel_alive      # every live node
        fr_idx, fr_d0, fr_q = fold_solicitations(st.idx, st.dist, st.queried,
                                                 sel_pos, q_hit, e_hit)
        impl = sw.resolve_merge_impl(cfg, st.idx.device)
        done_merge = None
        if impl in ("kernel", "fused-round"):
            f_idx, f_dist, f_q, done_merge = kernels.merge_round(
                fr_idx, fr_d0, fr_q, resp, resp_d0, quorum=cfg.quorum,
                keep=cfg.search_width)
        elif impl == "rank":
            f_idx, f_dist, f_q = rank_merge_round_d0_w(
                fr_idx, fr_d0, fr_q, resp, resp_d0, keep=cfg.search_width,
                merge_w=merge_w)
        else:                                               # "sort"
            f_idx, f_dist, f_q = merge_shortlists_d0(
                torch.cat([fr_d0, resp_d0], dim=1),
                torch.cat([fr_idx, resp], dim=1),
                torch.cat([fr_q, torch.zeros_like(resp, dtype=torch.bool)],
                          dim=1),
                keep=cfg.search_width)
        if upto == "merge":
            return f_idx, f_dist, f_q, done_merge
        # -- phase 5: scatter-writeback — the done rule and the state
        # after the round
        if done_merge is None:
            done_merge = kernels.round_done(f_idx, f_q, cfg.quorum)
        return sw._advance(st, sel, (f_idx, f_dist, f_q, done_merge), None)

    return prefix


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_round_phases(swarm, cfg, targets, generator=None,
                         repeats: int = 3, merge_w: int | None = None,
                         advance_rounds: int = 0, *,
                         origins: torch.Tensor | None = None) -> dict:
    """One instrumented A/B pass: time each round sub-phase as a prefix
    of the round and return the attribution table (JAX's schema).

    Each prefix is warmed once and timed ``repeats`` times, each ending
    at a full ``torch.cuda.synchronize`` barrier; the best is the
    figure.  Rows are telescoping prefix differences (clamped to the
    running maximum, so timing noise cannot push a row negative), so
    they sum exactly to ``fused_round_wall_s``; ``lookup_step_wall_s``
    is :func:`~opendht_tpu_torch.models.swarm.lookup_step` timed the
    same way, the cross-check target (``check_trace``: ±10 %).

    Runs at the full width of ``targets`` on a first-round state
    (``lookup_init`` from ``origins``, else from alive origins drawn
    with ``generator``), advanced ``advance_rounds`` plain rounds first
    if asked.  ``merge_w`` prices the merge at a width-ladder rung; only
    the plain rank merge honours it (K1 and K2 merge the full width), so
    it is refused where the round runs a kernel."""
    from ..models import swarm as sw

    dev = swarm.ids.device
    if merge_w is not None and \
            sw.resolve_merge_impl(cfg, dev) != "rank":
        raise ValueError(
            "merge_w prices the plain rank merge; the kernels merge the "
            "full width, so a laddered table would price nothing")
    phase_names = (["alpha-select", "gather", "window-decode", "merge",
                    "scatter-writeback"]
                   if swarm.tables.dtype == torch.uint16 else
                   ["alpha-select", "respond", "merge",
                    "scatter-writeback"])
    upto_of = {"scatter-writeback": "full"}
    targets = targets.to(dev)
    if origins is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        origins = sw._sample_origins(generator, swarm.alive,
                                     targets.shape[0])
    st = sw.lookup_init(swarm, cfg, targets, origins.to(dev))
    for _ in range(max(0, advance_rounds)):
        st = sw.lookup_step(swarm, cfg, st)
    _sync(dev)

    walls = []
    full_out = None
    for name in phase_names:
        upto = upto_of.get(name, name)
        fn = _round_prefix_fn(upto, merge_w=merge_w)
        fn(swarm, cfg, st)                              # warm
        # graftlint: disable=sync-in-loop (dedicated timing pass: warm-up barrier before the clocked repeats, never on a serving path)
        _sync(dev)
        best = float("inf")
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            out = fn(swarm, cfg, st)
            # graftlint: disable=sync-in-loop (dedicated timing pass: the barrier IS the measurement, never on a serving path)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        walls.append(best)
        if upto == "full":
            full_out = out

    # The decomposition must be the round: full prefix == lookup_step.
    ref = sw.lookup_step(swarm, cfg, st, merge_w=merge_w)
    _sync(dev)
    step_best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        sw.lookup_step(swarm, cfg, st, merge_w=merge_w)
        # graftlint: disable=sync-in-loop (dedicated timing pass: the barrier IS the measurement, never on a serving path)
        _sync(dev)
        step_best = min(step_best, time.perf_counter() - t0)
    for name, a, b in zip(sw.LookupState._fields, full_out, ref):
        if (a is None) != (b is None) or (
                a is not None and not torch.equal(a, b)):
            raise RuntimeError(
                f"round-phase decomposition diverged from lookup_step on "
                f"field {name!r} — the attribution would lie; fix "
                f"_round_prefix_fn to match the round")

    # Prefix k+1 contains prefix k's work, so the true walls are
    # monotone; clamp noise inversions to the running maximum.
    for i in range(1, len(walls)):
        walls[i] = max(walls[i], walls[i - 1])

    rows = []
    prev_w = 0.0
    for name, w in zip(phase_names, walls):
        rows.append({"phase": name, "wall_s": round(w - prev_w, 6),
                     "flops": None, "bytes_accessed": None})
        prev_w = w
    out = {
        "width": int(targets.shape[0]),
        "repeats": int(repeats),
        "rows": rows,
        "fused_round_wall_s": round(walls[-1], 6),
        "lookup_step_wall_s": round(step_best, 6),
        "prefix_equivalent": True,
    }
    if merge_w is not None:
        out["merge_w"] = int(merge_w)
    if advance_rounds:
        out["advance_rounds"] = int(advance_rounds)
    return out
