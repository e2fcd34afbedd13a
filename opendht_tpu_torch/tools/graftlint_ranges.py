"""graftlint planes ``ranges`` (an aten interval prover) and ``budget``.

The port's counterpart of ``opendht_tpu/tools/graftlint_ranges.py``.

**Plane ``ranges``.**  JAX traces each registered jit to a jaxpr and
interprets it with integer intervals.  Eager torch has no program to
trace (``make_fx`` here keeps no source lines), so the port interprets
the aten ops that each ``ENTRY_POINTS`` function's first call of the
canonical workload dispatches, on the CPU (where the kernel wrappers
run their plain versions, which a dispatch mode sees), through the
``TorchDispatchMode`` observer of :mod:`.graftlint`.  At the call, every
tensor argument is seeded from its domain: the fields that hold a u32 in
int64 (:data:`U32_FIELDS`, :data:`U32_PARAMS` — a dtype cannot say so)
from ``[0, 2^32 - 1]``, the rest from their dtype; a tensor made before
the call and met inside it (a constant of the call, as a jaxpr's consts
are) from its values.  The rules are JAX's:

* ``narrow-cast-unproven`` — a ``_to_copy`` / ``copy_`` to a narrower
  integer dtype (fewer bytes, or a float source) whose operand interval
  is not proven inside the target domain;
* ``narrow-overflow`` — an ``add`` / ``mul`` / ``sum`` / ``cumsum`` /
  ``index_add_`` / ``scatter_add`` / accumulating ``index_put_`` whose
  output is uint8 / int16 / uint16 and whose exact result interval
  escapes the dtype domain.

Index-producing ops (``arange``, ``argsort``, ``sort`` / ``topk``
indices, ``nonzero``, ``bincount``, ``searchsorted``) give intervals
bounded by their shapes, as JAX's iota sizes do.  A finding anchors at
the innermost port frame that dispatched the op, so the pragma grammar
suppresses it.

**Plane ``budget``.**  JAX counts the compiled specialisations of each
budgeted jit.  What the port builds or captures is kernel libraries and
CUDA graphs, so a row's fourth field bounds (1) how often each kernel
source is built in a process (``kernels.BUILDS``; the rows that launch
kernels) and (2) how often one resident engine captures one
``(use_cache, rounds, expire)`` key (``serve.GRAPH_KEYS``; the
``serve._resident_replay`` row).  The counts are the process's own: on
the CPU nothing is built or captured; ``chip_smoke.py`` checks them
over its whole run.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

from .graftlint import (LEDGER_PATH, Finding, _Hook, _port_frame,
                        parse_entry_points, suppress_by_source)

NEG_INF = float("-inf")
POS_INF = float("inf")
U32 = (0, 2**32 - 1)

# The int64 fields that hold a u32 (uint32 in the JAX counterpart that
# convert.py carries across), by NamedTuple and field.
U32_FIELDS: Dict[str, Tuple[str, ...]] = {
    "Swarm": ("ids",),
    "LookupState": ("targets", "dist"),
    "SwarmStore": ("keys", "vals", "seqs", "created", "cursor", "lkeys",
                   "lexps", "lcursor", "sizes", "ttls", "payload",
                   "nseqs", "nvals", "npayload", "nsizes"),
    "ResultCache": ("keys", "fill_epoch", "epoch"),
    "ServeRings": ("rq_keys",),
}

# Plain tensor parameters of entry points that hold a u32 (key limbs,
# value tokens, sequence numbers, payload words).
U32_PARAMS: Dict[str, Tuple[str, ...]] = {
    "storage._store_insert": ("req_key", "req_val", "req_seq", "req_size",
                              "req_ttl", "put_payloads"),
    "storage._announce_insert": ("keys", "vals", "seqs", "sizes", "ttls",
                                 "payloads"),
    "storage._get_probe": ("keys",),
    "storage._listen_insert": ("keys",),
    "swarm.lookup_init": ("targets",),
    "swarm.chaos_lookup_init": ("targets",),
    "serve._admit": ("keys",),
    "serve._admit_cached": ("keys",),
    "serve._cache_probe": ("keys",),
    "serve._cache_fill": ("keys",),
    "serve._resident_core": ("keys",),
    "soak._admit_serve_cached": ("keys",),
    "soak._admit_maintenance": ("pool_keys",),
    "soak._ring_enqueue_maintenance": ("pool_keys",),
    "soak._repub_insert_completed": ("pool_keys", "vals", "seqs", "sizes",
                                     "ttls", "payloads"),
    "sha1.sha1_one_block": ("msg",),
    "sha1.sha1_blocks": ("blocks",),
    "integrity.content_ids": ("payloads",),
    "chunked_values.chunked_content_ids": ("payloads",),
    "chunked_values._chunked_root_ok": ("keys", "payloads"),
    "index._pack_entry_payloads": ("ehash", "vid"),
    "monitor.fold_sweep": ("ids0",),
    "sharded.sharded_lookup_init": ("targets",),
    "sharded._sharded_resident_step": ("keys",),
    "sharded_storage._insert_routed": ("keys", "vals", "seqs", "sizes",
                                       "ttls", "payloads"),
}

# Output dtypes whose accumulations must prove no wraparound.
_CHECKED_NARROW = ("uint8", "int16", "uint16")


class IV(NamedTuple):
    """Closed interval [lo, hi]; +-inf = unbounded."""
    lo: float
    hi: float

    def known(self) -> bool:
        return self.lo > NEG_INF and self.hi < POS_INF

    def within(self, other: "IV") -> bool:
        return self.lo >= other.lo and self.hi <= other.hi


TOP = IV(NEG_INF, POS_INF)
BOOL = IV(0, 1)


def _dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def dtype_domain(dtype) -> IV:
    import torch
    if dtype == torch.bool:
        return BOOL
    if dtype.is_floating_point or dtype.is_complex:
        return TOP
    info = torch.iinfo(dtype)
    return IV(int(info.min), int(info.max))


def _is_int(dtype) -> bool:
    import torch
    return not (dtype.is_floating_point or dtype.is_complex) and \
        dtype != torch.bool


def _itemsize(dtype) -> int:
    import torch
    return torch.empty((), dtype=dtype).element_size()


def _join(*ivs: IV) -> IV:
    return IV(min(i.lo for i in ivs), max(i.hi for i in ivs))


def _mul1(x, y):
    if x == 0 or y == 0:
        return 0
    return x * y


def _mul(a: IV, b: IV) -> IV:
    ps = (_mul1(a.lo, b.lo), _mul1(a.lo, b.hi), _mul1(a.hi, b.lo),
          _mul1(a.hi, b.hi))
    return IV(min(ps), max(ps))


def _bitlen_bound(a: IV, b: IV) -> IV:
    if a.lo < 0 or b.lo < 0 or not (a.known() and b.known()):
        return TOP
    bits = max(int(a.hi).bit_length(), int(b.hi).bit_length())
    return IV(0, (1 << bits) - 1)


def _shift(a: IV, s: IV, left: bool) -> IV:
    if not (a.known() and s.known()) or s.lo < 0 or s.hi > 64:
        return TOP
    xs = (int(a.lo), int(a.hi))
    ss = (int(s.lo), int(s.hi))
    vals = [(x << k) if left else (x >> k) for x in xs for k in ss]
    return IV(min(vals), max(vals))


def iv_of_tensor(t) -> IV:
    """The interval of a tensor's values (a constant of the call)."""
    import torch
    if t.numel() == 0:
        return IV(0, 0)
    if t.dtype == torch.bool:
        return IV(int(t.min()), int(t.max()))
    if t.is_floating_point():
        lo, hi = float(t.min()), float(t.max())
        if math.isfinite(lo) and math.isfinite(hi):
            return IV(lo, hi)
        return TOP
    if t.is_complex():
        return TOP
    return IV(int(t.min()), int(t.max()))


def _settle(iv: IV, dtype) -> IV:
    """An integer result outside its dtype's domain wraps: the sound
    interval is then the whole domain."""
    dom = dtype_domain(dtype)
    if dom is TOP or iv.within(dom):
        return iv
    return dom


class RangeHook(_Hook):
    """The interval prover, as a dispatch hook of the lint observer.
    Interprets the ops of each entry point's first call (and of every
    entry call nested inside it)."""

    def __init__(self, root: str, lint):
        from torch.utils.weak import WeakTensorKeyDictionary
        self.root = root
        self.ivs = WeakTensorKeyDictionary()
        self.findings: List[Finding] = []
        self._seen_sites: set = set()
        self._done_entries: set = set()
        self._stack: List[Tuple[bool, str]] = []
        self.entries_checked = 0
        self.casts_proven = 0
        self.accums_proven = 0
        lint.on_enter.append(self._enter)
        lint.on_exit.append(self._exit)

    def stats(self) -> dict:
        return {"entries": self.entries_checked,
                "casts_proven": self.casts_proven,
                "accums_proven": self.accums_proven}

    # -- entry calls ---------------------------------------------------
    @property
    def _on(self) -> bool:
        return bool(self._stack) and self._stack[-1][0]

    def _enter(self, name, fn, args, kwargs):
        if self._on:
            self._stack.append((True, self._stack[-1][1]))
            return
        if name in self._done_entries:
            self._stack.append((False, name))
            return
        self._done_entries.add(name)
        self.entries_checked += 1
        self._seed(name, fn, args, kwargs)
        self._stack.append((True, name))

    def _exit(self, name):
        self._stack.pop()

    def _seed(self, name, fn, args, kwargs):
        import inspect

        import torch
        try:
            params = list(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            params = []
        u32p = set(U32_PARAMS.get(name, ()))
        named = list(zip(params, args)) + list(kwargs.items())

        def seed(x, u32: bool, depth: int = 0):
            if isinstance(x, torch.Tensor):
                self.ivs[x] = IV(*U32) if u32 else dtype_domain(x.dtype)
            elif isinstance(x, tuple) and hasattr(x, "_fields") and \
                    depth < 4:
                fields = set(U32_FIELDS.get(type(x).__name__, ()))
                for f, v in zip(x._fields, x):
                    seed(v, f in fields, depth + 1)
            elif isinstance(x, (list, tuple)) and depth < 4:
                for v in x:
                    seed(v, u32, depth + 1)

        for pname, v in named:
            seed(v, pname in u32p)

    # -- intervals -----------------------------------------------------
    def _iv(self, x) -> IV:
        import torch
        if isinstance(x, torch.Tensor):
            got = self.ivs.get(x)
            if got is None:
                got = iv_of_tensor(x)
                self.ivs[x] = got
            return got
        if isinstance(x, bool):
            return IV(int(x), int(x))
        if isinstance(x, (int, float)):
            if isinstance(x, float) and not math.isfinite(x):
                return TOP
            return IV(x, x)
        return TOP

    def _emit(self, rule, msg):
        where = _port_frame(self.root) or (LEDGER_PATH, 1)
        key = (where, rule)
        if key in self._seen_sites:
            return
        self._seen_sites.add(key)
        self.findings.append(Finding(where[0], where[1], 0, rule, msg))

    def _check_accum(self, op, r: IV, dtype) -> IV:
        if _dname(dtype) not in _CHECKED_NARROW:
            return r
        dom = dtype_domain(dtype)
        if not r.known() or not r.within(dom):
            lo = "-inf" if r.lo == NEG_INF else int(r.lo)
            hi = "+inf" if r.hi == POS_INF else int(r.hi)
            self._emit("narrow-overflow",
                       f"'{op}' on {_dname(dtype)} may wrap in "
                       f"{self._stack[-1][1]}: result interval [{lo}, "
                       f"{hi}] escapes [{int(dom.lo)}, {int(dom.hi)}] — "
                       f"widen the accumulator or bound the operands")
            return dom
        self.accums_proven += 1
        return r

    def _check_cast(self, iv: IV, src, dst) -> IV:
        import torch
        if dst == torch.bool:
            return BOOL
        if not _is_int(dst):
            return iv
        if src == torch.bool:
            return iv
        dom = dtype_domain(dst)
        narrowing = not _is_int(src) or _itemsize(dst) < _itemsize(src)
        if narrowing:
            if iv.known() and iv.within(dom):
                self.casts_proven += 1
                return iv
            lo = "-inf" if iv.lo == NEG_INF else f"{iv.lo:g}"
            hi = "+inf" if iv.hi == POS_INF else f"{iv.hi:g}"
            self._emit("narrow-cast-unproven",
                       f"cast {_dname(src)}->{_dname(dst)} in "
                       f"{self._stack[-1][1]} not proven in range: operand "
                       f"interval [{lo}, {hi}] vs domain [{int(dom.lo)}, "
                       f"{int(dom.hi)}] — clamp the operand to a static "
                       f"bound or widen the target dtype")
            return dom
        return iv if iv.within(dom) else dom

    def post(self, func, args, kwargs, out):
        if not self._on:
            return
        import torch
        outs = [o for o in (out if isinstance(out, (tuple, list))
                            else (out,)) if isinstance(o, torch.Tensor)]
        if not outs:
            return
        try:
            ivs = self._eval(func, args, kwargs, outs)
        except Exception:
            ivs = None
        if ivs is None:
            ivs = [dtype_domain(o.dtype) for o in outs]
        for o, iv in zip(outs, ivs):
            iv = _settle(iv, o.dtype)
            self.ivs[o] = iv
            base = o._base
            if base is not None and func.overloadpacket.__name__.endswith(
                    "_"):
                old = self.ivs.get(base)
                self.ivs[base] = _settle(iv if old is None else
                                         _join(old, iv), base.dtype)

    def _eval(self, func, args, kwargs, outs) -> Optional[List[IV]]:
        import torch
        name = func.overloadpacket.__name__
        inplace = name.endswith("_") and not name.endswith("__")
        op = name.rstrip("_") if inplace else name
        odt = outs[0].dtype
        a = [self._iv(x) for x in args]
        n_out = len(outs)

        def numel(t):
            return t.numel() if isinstance(t, torch.Tensor) else 1

        # ---- arithmetic -----------------------------------------------
        if op in ("add", "sub", "rsub"):
            alpha = kwargs.get("alpha", 1)
            b = _mul(a[1], IV(alpha, alpha))
            if op == "add":
                r = IV(a[0].lo + b.lo, a[0].hi + b.hi)
                return [self._check_accum(name, r, odt)]
            if op == "rsub":
                return [IV(b.lo - a[0].hi, b.hi - a[0].lo)]
            return [IV(a[0].lo - b.hi, a[0].hi - b.lo)]
        if op == "mul":
            return [self._check_accum(name, _mul(a[0], a[1]), odt)]
        if op == "neg":
            return [IV(-a[0].hi, -a[0].lo)]
        if op == "abs":
            x = a[0]
            lo = 0 if x.lo <= 0 <= x.hi else min(abs(x.lo), abs(x.hi))
            return [IV(lo, max(abs(x.lo), abs(x.hi)))]
        if op in ("remainder", "fmod"):
            x, m = a[0], a[1]
            if m.known() and m.lo > 0:
                if op == "remainder" or x.lo >= 0:
                    return [IV(0, m.hi - 1) if _is_int(odt)
                            else IV(0, m.hi)]
            return None
        if op in ("floor_divide", "div") and (
                op == "floor_divide" or kwargs.get("rounding_mode")):
            x, m = a[0], a[1]
            if m.known() and m.lo > 0 and x.known() and x.lo >= 0:
                return [IV(int(x.lo // m.hi), int(x.hi // m.lo))]
            return None
        if op == "div":
            x, m = a[0], a[1]
            if m.known() and m.lo > 0 and x.known():
                ps = [x.lo / m.lo, x.lo / m.hi, x.hi / m.lo, x.hi / m.hi]
                return [IV(min(ps), max(ps))]
            return None
        if op in ("maximum", "fmax") or (op == "max" and len(args) == 2
                                          and isinstance(args[1],
                                                         torch.Tensor)):
            return [IV(max(a[0].lo, a[1].lo), max(a[0].hi, a[1].hi))]
        if op in ("minimum", "fmin") or (op == "min" and len(args) == 2
                                          and isinstance(args[1],
                                                         torch.Tensor)):
            return [IV(min(a[0].lo, a[1].lo), min(a[0].hi, a[1].hi))]
        if op in ("clamp", "clip", "clamp_min", "clamp_max"):
            x = a[0]
            lo_b = hi_b = None
            if op == "clamp_min":
                lo_b = a[1]
            elif op == "clamp_max":
                hi_b = a[1]
            else:
                lo_a = args[1] if len(args) > 1 else kwargs.get("min")
                hi_a = args[2] if len(args) > 2 else kwargs.get("max")
                lo_b = None if lo_a is None else self._iv(lo_a)
                hi_b = None if hi_a is None else self._iv(hi_a)
            if lo_b is not None:
                x = IV(max(x.lo, lo_b.lo), max(x.hi, lo_b.hi))
            if hi_b is not None:
                x = IV(min(x.lo, hi_b.lo), min(x.hi, hi_b.hi))
            return [x]
        # ---- bitwise --------------------------------------------------
        if op in ("bitwise_and", "__and__", "logical_and"):
            if odt == torch.bool:
                return [BOOL]
            x, y = a[0], a[1]
            nonneg = [v for v in (x, y) if v.lo >= 0]
            if nonneg:
                return [IV(0, min(v.hi for v in nonneg))]
            return None
        if op in ("bitwise_or", "bitwise_xor", "__or__", "__xor__",
                  "logical_or", "logical_xor"):
            if odt == torch.bool:
                return [BOOL]
            return [_bitlen_bound(a[0], a[1])]
        if op in ("bitwise_not", "logical_not"):
            if odt == torch.bool:
                return [BOOL]
            return [IV(-a[0].hi - 1, -a[0].lo - 1)]
        if op in ("bitwise_right_shift", "__rshift__"):
            return [_shift(a[0], a[1], left=False)]
        if op in ("bitwise_left_shift", "__lshift__"):
            return [_shift(a[0], a[1], left=True)]
        # ---- predicates -----------------------------------------------
        if odt == torch.bool and op in (
                "eq", "ne", "lt", "le", "gt", "ge", "any", "all", "isnan",
                "isinf", "isfinite", "isin", "equal", "signbit"):
            return [BOOL] * n_out
        # ---- casts ----------------------------------------------------
        if op in ("_to_copy", "to", "_to_copy_out"):
            src = args[0].dtype
            return [self._check_cast(a[0], src, odt)]
        if op == "copy":
            src = args[1]
            iv = self._check_cast(a[1], src.dtype, odt) \
                if isinstance(src, torch.Tensor) else a[1]
            return [iv]
        if op == "view" and len(args) > 1 and \
                isinstance(args[1], torch.dtype):
            return [dtype_domain(odt)]
        # ---- reductions -----------------------------------------------
        if op in ("sum", "nansum"):
            n = max(1, numel(args[0]) // max(1, outs[0].numel()))
            x = a[0]
            r = IV(_mul1(n, x.lo) if x.lo < 0 else min(x.lo, _mul1(n, x.lo)),
                   _mul1(n, x.hi) if x.hi > 0 else max(x.hi, _mul1(n, x.hi)))
            return [self._check_accum(name, r, odt)]
        if op == "cumsum":
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            n = args[0].shape[dim] if args[0].dim() else 1
            x = a[0]
            r = IV(min(x.lo, _mul1(n, x.lo)), max(x.hi, _mul1(n, x.hi)))
            return [self._check_accum(name, r, odt)]
        if op in ("amax", "amin", "max", "min", "cummax", "cummin",
                  "median", "mode", "kthvalue"):
            x = a[0]
            if n_out == 2:
                dim = args[1] if len(args) > 1 and isinstance(
                    args[1], int) else kwargs.get("dim", -1)
                n = args[0].shape[dim] if args[0].dim() else 1
                return [x, IV(0, max(0, n - 1))]
            return [x] * n_out
        if op in ("argmax", "argmin"):
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            n = args[0].numel() if dim is None else args[0].shape[dim]
            return [IV(0, max(0, n - 1))]
        if op == "count_nonzero":
            return [IV(0, numel(args[0]))]
        if op in ("mean", "nanmean"):
            return [a[0]]
        if op == "prod":
            return None
        # ---- creation -------------------------------------------------
        if op == "arange":
            vals = [x for x in args if isinstance(x, (int, float))]
            start, end = (0, vals[0]) if len(vals) == 1 else vals[:2]
            step = vals[2] if len(vals) > 2 else 1
            n = outs[0].numel()
            if n == 0:
                return [IV(0, 0)]
            last = start + step * (n - 1)
            return [IV(min(start, last), max(start, last))]
        if op in ("zeros", "zeros_like", "new_zeros", "zero"):
            return [IV(0, 0)]
        if op in ("ones", "ones_like", "new_ones"):
            return [IV(1, 1)]
        if op in ("full", "full_like", "new_full", "fill", "scalar_tensor"):
            v = args[1] if op in ("full", "full_like", "new_full",
                                  "fill") else args[0]
            return [self._iv(v)]
        if op in ("randint",):
            ints = [x for x in args if isinstance(x, int)]
            lo, hi = (0, ints[0]) if len(ints) == 1 else (ints[0], ints[1])
            return [IV(lo, hi - 1)]
        if op == "randperm":
            return [IV(0, max(0, args[0] - 1))]
        if op in ("rand", "uniform", "rand_like"):
            return [IV(0.0, 1.0)]
        if op in ("empty", "empty_like", "new_empty", "empty_strided"):
            return [dtype_domain(odt)]
        # ---- index producers ------------------------------------------
        if op in ("sort", "topk"):
            x = args[0]
            dim = -1
            for k, v in kwargs.items():
                if k == "dim":
                    dim = v
            if op == "sort" and len(args) > 1 and isinstance(args[1], int):
                dim = args[1]
            if op == "topk" and len(args) > 2:
                dim = args[2]
            n = x.shape[dim] if x.dim() else 1
            return [a[0], IV(0, max(0, n - 1))]
        if op == "argsort":
            x = args[0]
            dim = args[1] if len(args) > 1 and isinstance(
                args[1], int) else kwargs.get("dim", -1)
            n = x.shape[dim] if x.dim() else 1
            return [IV(0, max(0, n - 1))]
        if op == "nonzero":
            m = max(args[0].shape) if args[0].dim() else 1
            return [IV(0, max(0, m - 1))]
        if op == "bincount":
            w = args[1] if len(args) > 1 else kwargs.get("weights")
            if w is None:
                return [IV(0, numel(args[0]))]
            wv = self._iv(w)
            n = numel(args[0])
            return [IV(min(0, _mul1(n, wv.lo)), max(0, _mul1(n, wv.hi)))]
        if op == "searchsorted":
            return [IV(0, numel(args[0]) if args[0].dim() <= 1
                       else args[0].shape[-1])]
        if op in ("unique", "_unique2", "unique_consecutive",
                  "unique_dim"):
            n = numel(args[0])
            return [a[0]] + [IV(0, max(0, n))] * (n_out - 1)
        # ---- writes ---------------------------------------------------
        if op == "index_put":
            vals = a[2]
            acc = (args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                            False))
            if acc:
                n = max(1, max((numel(i) for i in args[1]
                                if i is not None), default=1))
                r = IV(a[0].lo + _mul1(n, min(0, vals.lo)),
                       a[0].hi + _mul1(n, max(0, vals.hi)))
                return [self._check_accum(name, r, odt)]
            return [_join(a[0], vals)]
        if op in ("index_add", "scatter_add"):
            src = args[3] if len(args) > 3 else kwargs.get("source",
                                                           kwargs.get("src"))
            s_iv = self._iv(src)
            alpha = kwargs.get("alpha", 1)
            s_iv = _mul(s_iv, IV(alpha, alpha))
            n = numel(args[2]) if op == "index_add" else numel(src)
            r = IV(a[0].lo + _mul1(n, min(0, s_iv.lo)),
                   a[0].hi + _mul1(n, max(0, s_iv.hi)))
            return [self._check_accum(name, r, odt)]
        if op in ("scatter", "masked_fill", "index_fill",
                  "masked_scatter", "index_copy", "scatter_reduce"):
            if op == "scatter_reduce":
                return None
            v = args[-1] if args else None
            return [_join(a[0], self._iv(v))]
        if op == "where":
            if len(args) == 3:
                return [_join(a[1], a[2])]
            return [IV(0, max(0, max(args[0].shape) - 1))] * n_out
        # ---- structure-preserving -------------------------------------
        if op in ("cat", "stack", "concat", "hstack", "vstack"):
            parts = [self._iv(t) for t in args[0]]
            return [_join(*parts)] if parts else None
        if op in ("view", "_unsafe_view", "reshape", "expand", "permute",
                  "transpose", "t", "squeeze", "unsqueeze", "slice",
                  "select", "alias", "clone", "contiguous", "detach",
                  "flip", "roll", "repeat", "lift_fresh", "as_strided",
                  "unbind", "split", "split_with_sizes", "narrow",
                  "diagonal", "unfold", "index_select", "gather", "index",
                  "take", "take_along_dim", "masked_select",
                  "_unsafe_index", "expand_as", "view_as", "movedim",
                  "flatten", "unflatten", "tile", "chunk", "tensor_split",
                  "_reshape_alias", "lift_fresh_copy", "resolve_conj",
                  "resolve_neg", "pin_memory", "_pin_memory", "set",
                  "repeat_interleave", "tril", "triu", "constant_pad_nd",
                  "pad"):
            if op == "repeat_interleave" and len(args) == 1:
                return [IV(0, max(0, numel(args[0]) - 1))]
            if op in ("constant_pad_nd", "pad"):
                v = args[2] if len(args) > 2 else 0
                return [_join(a[0], self._iv(v))] * n_out
            return [a[0]] * n_out
        return None


# ---------------------------------------------------------------------------
# plane drivers
# ---------------------------------------------------------------------------

def run_plane_ranges(root: str, raw_sink: Optional[List[Finding]] = None
                     ) -> Tuple[List[Finding], dict]:
    """The interval prover over the canonical workload's first call of
    every entry point, on the CPU.  Returns (post-pragma findings,
    stats)."""
    from .graftlint import recorded_run
    run = recorded_run(root, "cpu", ranges=True)
    findings = suppress_by_source(root, run.ranges, raw_sink=raw_sink)
    return findings, run.range_stats


def check_budgets(measured: Dict[str, Optional[int]],
                  budgets: Dict[str, int],
                  ep_line: int = 1) -> List[Finding]:
    """Every budgeted row's measured count must not exceed its budget
    (and must have been measured)."""
    findings: List[Finding] = []
    for name, budget in sorted(budgets.items()):
        got = measured.get(name)
        if got is None:
            findings.append(Finding(
                LEDGER_PATH, ep_line, 0, "specialization-budget",
                f"{name}: declared budget {budget} but nothing measured "
                f"its count (entry renamed?)"))
        elif got > budget:
            findings.append(Finding(
                LEDGER_PATH, ep_line, 0, "specialization-budget",
                f"{name}: {got} builds or captures of one key exceed the "
                f"declared budget {budget} — something rebuilds a kernel "
                f"library or recaptures a graph the process already has"))
    return findings


def measure_budgets(rows) -> Dict[str, dict]:
    """``{row: {"budget", "measured", "what"}}`` from this process's
    kernel builds and graph captures."""
    from ..models import serve
    from ..ops import kernels
    builds = max(kernels.BUILDS.values(), default=0)
    captures = max(serve.GRAPH_KEYS.values(), default=0)
    out = {}
    for mod, attr, _donate, budget in rows:
        if budget is None:
            continue
        name = f"{mod.rsplit('.', 1)[-1]}.{attr}"
        if attr == "_resident_replay":
            out[name] = {"budget": int(budget), "measured": captures,
                         "what": "captures of one graph key by one "
                                 "engine"}
        else:
            out[name] = {"budget": int(budget), "measured": builds,
                         "what": "builds of each kernel source"}
    return out


def run_plane_budget(root: str, device="cuda") -> Tuple[List[Finding],
                                                        dict]:
    """Kernel builds and graph captures against the rows' budgets, over
    everything this process has run (the CLI runs the canonical workload
    on ``device`` first)."""
    from .graftlint import _entry_points_line, recorded_run
    with open(os.path.join(root, LEDGER_PATH), encoding="utf-8") as f:
        src = f.read()
    rows = parse_entry_points(src)
    if not _ran_any():
        recorded_run(root, device, ranges=False)
    table = measure_budgets(rows)
    findings = check_budgets({k: v["measured"] for k, v in table.items()},
                             {k: v["budget"] for k, v in table.items()},
                             _entry_points_line(src))
    return findings, table


def _ran_any() -> bool:
    from .graftlint import _RUNS
    return bool(_RUNS)
